"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--layers N]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the kernels from src/repro_torch/csrc with nvcc for
   sm_90a (one process per source, in parallel, into build/kernels/) and
   prints the build time, each source's, and ptxas's registers and spills
   per kernel;
   then counts the HGMMA (wgmma) and UTMALDG (TMA load) instructions in
   the SASS of the Hopper kernels (the forward's B1 and B2 in bf16 on
   dense, int8 and int4 weights, the backward's B7 and B1^T, the bf16 MLA
   decode-attention kernel; ``cuobjdump -sass`` on the built library, run
   in the background beside phase 3 and read at its end) and fails if
   either count of any of them is 0;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   bf16 and fp32.  The five MoE kernels at moonshot-v1-16b-a3b's full width
   (decode T=2 and T=4, prefill T=64) and at mixtral-8x7b's (T=512), on
   the ``fixed`` schedule and on the ``dynamic`` schedule's 8-row blocks:
   router indices and permute exactly equal, GEMMs and unpermute within
   fp32 1e-4 / bf16 2e-2, rows of inactive blocks exactly zero and no NaN
   (the allocator is poisoned with NaN just before each call), the two
   GEMMs bitwise equal across two calls.  The paged
   decode-attention kernel (GQA: split over the block pool, then merged in
   split order) at moonshot's attention shape (16 KV heads of 128, blocks
   of 16) at decode (B=2), at a prefill-chunk step (B=64), at long context
   (B=2 at kv_limit 8191 and 6143, tables of 512 blocks) and batched (32
   rows at kv_limit 2047), at mixtral's GQA decode (8 KV heads x 4), and
   at the dense family's attention (``DENSE_ATTN``: gemma2-9b's 8 KV heads
   x 2 of 256 with its softcap of 50, qwen2-7b's 4 x 7, starcoder2-3b's 2
   x 12, smollm-360m's 5 x 3 of 64) at decode and at the chunk step,
   with vector and scalar kv_limit, causal + window against q_pos,
   softcap, each bitwise equal across two calls, and whole blocks past
   kv_limit poisoned (1e4 against the plain version; NaN against the
   kernel's own clean output, bitwise; blocks that later splits would
   take).  Then times each kernel, its plain
   version and a one-call PyTorch yardstick where one exists, at the
   serving shapes: device time from CUDA-graph replays between CUDA events,
   and the eager per-call time beside it; and prints the dynamic
   schedule's padding beside the fixed one's.  The int8 and int4 weight
   formats of fused_gate_up and grouped_gemm (schemes int8_expert,
   int8_channel, int4_packed) at moonshot's width at decode T=2 and
   prefill T=64 (fixed and dynamic), bf16 and fp32, with the same
   tolerances, NaN poisoning, zero and two-call checks, each timed in bf16
   against its compressed-byte bound (payload + scales + activations in +
   output written), in turns with the dense bf16 kernel of the same GEMM,
   beside ``torch._grouped_mm`` over the dequantized bf16 stack (B1; B2's
   gate and up stacks side by side, no SiLU; timed only, as the dense
   library time).  The five MoE
   kernels again at deepseek-v2-236b's MoE layer (E=160, k=6, d=5120,
   f=1536, softmax, no renorm, routed_scale 16) at decode T=2 and prefill
   T=64 on both policies, bf16 and fp32, timed in bf16, with its padding,
   and its int8_expert GEMMs on ``dynamic`` (held in bf16 and fp32, timed
   in bf16 as moonshot's); and
   at its training shape T=4096 on both policies in bf16, held and timed
   (B1 and B2 beside their bounds, B1 beside ``torch._grouped_mm``).
   Everywhere the router must also be bitwise equal across two calls, and
   unpermute bitwise equal to its plain version (folded, and weighted with
   the router's weights) and across two calls.  The router alone
   (``ROUTERS``: moonshot's, deepseek-v2's, mixtral's E=8 and
   deepseek-v3's E=256 k=8 sigmoid) at T=1, 2, 3, 64 and 4096 on rows of
   ties at the k-th place, equal scores and -inf logits; mixtral's and
   deepseek-v3's timed at T=2, 64 and 4096 (random rows, and rows whose
   top k lanes hold all their experts above tau, the ranking's most
   candidates), beside an empty kernel's time, the launch floor, timed
   the same way.  The
   MLA form of the paged decode-attention kernel (second score operand q2
   against the rope-key pool, the latent pool as key and value; bf16 the
   Hopper kernel, fp32 the CUDA-core one) at deepseek's shape (128 heads,
   latent 512, rope key 64, blocks of 16) at each of ``MLA_SHAPES``
   (decode B=2, the 64-row chunk step, long context B=2 at 8,191 and 6,143
   in tables of 512 blocks, 32 rows of 2,047), and at decode with 120
   heads (not a multiple of the 64-head tile), bf16 and fp32, vector and
   scalar kv_limit, a row at kv_limit -1 (exact zeros), blocks past
   kv_limit poisoned as above (later splits' blocks among them), bitwise
   across two calls; timed at each of ``MLA_SHAPES`` beside its split plan,
   its bound (bytes and tensor-core operations, each named), its plain
   version and scaled_dot_product_attention over the contiguous
   concatenated view.
   The five MoE kernels at moonshot's training shape (T = 8 x 512 = 4096
   tokens, capacity 32,768 rows on ``fixed``), bf16, both policies, held
   and timed (B1 and B2 beside their bounds and B1 beside
   ``torch._grouped_mm``).  The backward's two kernels at that shape for
   moonshot's MoE layer and deepseek-v2's (E=160), on both policies, bf16
   and fp32, in both orientations the layer's backward runs (gate/up: x
   (capacity, d), dy (capacity, f), W (E, d, f); down: x = h (capacity,
   f), dy the scaled output gradient (capacity, d), W_down (E, f, d)): the
   grouped weight gradient B7 (x, dy -> dW) with fp32 output (within 1e-4;
   moonshot's layer, deepseek's in bf16 only)
   and with bf16 output (the form training launches; within the bf16
   tolerance), exact zeros for experts with no tokens, every element
   written after NaN poisoning, bitwise equal across two calls; and B1 with
   its weight read transposed (the dX product: within the GEMM
   tolerances, inactive rows zero); timed in bf16 beside their bounds
   (bytes and tensor-core operations), their plain versions and
   ``torch._grouped_mm`` (2-D x 2-D for B7, 2-D x 3-D for B1^T; timed
   only).  [capacity]: the five MoE kernels on ``capacity_factor``
   schedules (headroom 1.25 and 0.5, bf16 and fp32) at moonshot's T=2, 64
   and 4096, deepseek-v2's T=2 and 64 and the four paper layers
   (configs/paper.py) at T=512, with every check above and, after NaN
   poisoning, exact zeros on every row that holds no token (bucket tails,
   empty buckets, the sentinel block of dropped assignments); the int8
   and int4 GEMMs at moonshot's T=2 and 64; B7 and B1^T at moonshot's
   T=4096 in both orientations (timed in bf16); each schedule's
   drop_fraction printed; B2 and B1 timed in turns on capacity_factor,
   fixed and dynamic at moonshot's T=2, 64, 4096 and deepseek-v2's T=2;
4. MoE layer: ``moe_ffn`` on the ``cuda`` executor under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the
   layer), with the ``fixed`` and the ``dynamic`` policy: at moonshot width
   on bf16 experts and on int8_expert and int4_packed ones, and at
   deepseek's on bf16 experts;
5. serving, paged (the engine's default): moonshot-v1-16b-a3b at full
   width, depth cut to 4 layers (1 dense + 3 MoE; ``--layers 48`` serves
   the whole depth), random bf16 weights from a seeded generator, the
   ``dynamic`` policy, blocks of 16, prefill chunks of 32, the fused paged
   read; 4 requests of 16-64 prompt tokens, three of them sharing a
   40-token prefix, 16 new tokens each, on 2 slots, after one warm-up
   request.  The paged-attention kernel's launches must equal layers x
   forwards, the five MoE kernels' MoE layers x forwards, and the prefix
   cache must hit.  The first paged step's logits through the fused read
   and the kernels must match the gather read through the plain versions:
   in fp32 through the first 4 layers (rtol = atol = 1e-3), and in bf16
   through the dense layer 0 and the head (rtol = atol = 5e-2).  Then a
   prefill window (two chunk steps) and five decode steps run under
   torch.profiler.  [tune]: B1 and B2 swept over every tile shape they
   take (``repro_torch.tuning.tune_moe_layer``; CUDA-graph replays, three
   rounds in turns) at moonshot's and deepseek-v2's T=2 (``dynamic``, with
   the sub-block floor) and T=4096 (``fixed``) in dense bf16, and at
   moonshot's T=2 on int8 weights: every key's records printed, the winner
   at or below the default on the same measurement, every tile's output
   bitwise the default's; then [serve paged]'s requests on two fresh
   engines, ``RunConfig(autotune=False)`` and ``True`` (the swept cache in
   a temporary ``$REPRO_TORCH_TUNE_CACHE`` over the packaged defaults):
   greedy tokens and per-kernel launches equal, tune cache hits nonzero,
   two tuned decode steps' forwards under ``set_sync_debug_mode("error")``,
   host ms per decode step of each printed; the kernel report's B1 and B2
   carry the tiles held and each swept key's winner (``tile``).  [serve
   obs] on the same model and prompts: the
   memory observability bundle against the null one and ``moe_stats`` on
   against off (tokens and launches equal; the trace validated with the
   reference's span names; counters; TTFT/TPOT/queue/E2E p50/p99; decode
   ms per step with the arms switched step by step on one engine), an
   explicit preemption on the paged and the contiguous engine and the
   ``slo`` policy on a stepped clock (tokens bitwise the uninterrupted
   run's in fp32; the resumed admission timed in bf16), and a
   ``torch.profiler`` device trace of two decode steps that must name B1,
   B2 and B6 (``serve_obs``).  [serve sample] on the same model and
   traffic under ``temperature`` 0.8, ``top_k`` 50 and ``top_p`` 0.9
   (seed 0): threefry keys, bits and uniforms on the card bitwise the
   CPU's and the reference's (literals taken from ``jax.random``), every
   sampled token equal to ``sample_rows`` on the CPU over the step's
   logits, a request alone sampling the tokens it samples in the batch
   (fp32 copy), decode ms per step of each method against greedy in turns
   and the device activities each adds (``serve_sample``).  [serve spec]
   (k = 4): smollm-360m at full width with moonshot's vocabulary (random
   bf16, seed 1) and the target itself as drafts: acceptance, the launches
   of a round (one plan a MoE layer for the verify's 10 rows), the draft
   steps and the verify forward under ``set_sync_debug_mode("error")``,
   greedy tokens equal to the plain engine's in fp32 for both drafts, and
   decode tokens/s against plain in turns (``serve_spec``).  [serve
   loadgen]: seeded poisson and burst traces (16 requests at 8 req/s of
   virtual time) replayed through ``ServingFrontend`` with the clock
   moved by the measured step EWMA: completions, TTFT/TPOT p50/p99,
   goodput, streamed tokens equal to each request's (``serve_loadgen``).  [ep]:
   the same model's first 4 layers and requests on 2 ranks sharing the
   card (gloo, ``spawn_ranks``), 32 of 64 experts each: fp32 greedy
   tokens equal to the single rank's under the decode layouts
   ``replicated``, ``sharded`` and ``sharded`` with 2 microbatches;
   ``apply_moe_ep`` in bf16 at T=2 and 64 in every layout against
   ``apply_moe`` within 2e-2; ``serve/ep_dropped_tokens`` under
   ``capacity_factor`` 0.5 (block_m 8) equal to the single rank's summed
   ``sched/dropped_rows`` and above 0; ``int8_expert`` tokens equal; each
   rank's launches; decode ms per step against the single rank's, the
   exchange's rows and bytes a step and each collective's host ms
   (``serve_ep``); [ep grad]: the first MoE layer in fp32 under autograd
   on the cuda executor in each layout (x (2, 64, d)) and the ragged
   fallback (x (3, 5, d): replicated), forward and backward of
   ``sum(y * dy)``: dx, the router's, the shared experts' and each
   rank's own experts' gradients within 1e-3 of their largest magnitude
   of the single rank's (``sharded_static``, which drops by its own
   buckets, of the plain executor's in the same layout), dx bitwise alike
   on the ranks, B1ᵀ and B7 launched in every arm, fwd + bwd ms (median
   of 3) beside the single rank's (``ep_grad_arms``,
   ``report_ep_grads``).  [executors]: the port's three executors (``cuda``, the
   kernels; ``blocks``, the block schedule in plain PyTorch products;
   ``dense``, every expert on every token): the paper's four MoE layers
   (``configs/paper.py``) at full width in bf16, fixed schedule, at
   ``EXEC_TS`` tokens, on the arms of its Tables 2-4 (``cuda`` fused,
   ``cuda`` unfused with the combine in ``unpermute``, ``blocks``,
   ``dense`` where E <= 64), each under ``set_sync_debug_mode("error")``
   and held against a dense fp32 oracle on the same routing (the largest
   difference within the bf16 tolerance of the oracle's largest
   magnitude), eager ms (median of ``EXEC_ITERS`` calls between CUDA
   events), device ms (a CUDA graph of one call, replayed) and peak bytes
   each, B1-B6 launched only by the ``cuda`` arms;
   the serve launcher with ``--executor blocks``, ``dense`` and ``cuda`` at
   the served depth in fp32 on the ``fixed`` schedule (greedy tokens
   identical, no kernel launched but by ``cuda``, which launches what
   [serve paged] does), then [serve paged]'s traffic in bf16 on each
   executor on ``fixed`` (decode ms per step); one
   fp32 forward + backward of moonshot at 2 layers on ``blocks`` and
   ``dense`` against ``cuda`` (the loss within 1e-5 relative, every
   gradient within 1e-4 of its largest magnitude; no kernel launched off
   ``cuda``) (``executors_phase``);
6. serving, contiguous + fixed (``kv_block_size=0``): 3 requests as before
   the paged engine existed, with the same launch, logits and profile
   checks;
7. serving, paged, quantized experts: the served model's routed experts
   quantized in place under ``int8_expert`` by the engine (``rc.quant``),
   and a copy of its first 4 layers under ``int4_packed``; the same 4
   requests each.  The int8 (int4) GEMM kernels' launches must equal MoE
   layers x forwards and the dense GEMMs' 0; five decode steps under
   torch.profiler (the busy share beside the bf16 engine's); the first
   paged step's fp32 logits through the fused read and the kernels against
   the gather read and the plain versions within rtol = atol = 1e-3;
   prints the routed experts' stored bytes and the peak device memory;
8. serving deepseek-v2-236b (MLA), built once moonshot's models are
   freed: full width, depth cut 60 -> 4 (1 dense + 3 MoE, 13.3 B
   parameters, random bf16 weights; ``--layers`` does not change it).  The
   paged engine as in 5 (4 requests, three sharing a 40-token prefix): the
   MLA kernel's launches must equal layers x forwards, the GQA kernel's 0,
   the MoE kernels' MoE layers x forwards; peak memory, prefix hits,
   prefill and decode times, a profile of 2 chunk steps and 5 decode
   steps.  The first paged step's logits through the MLA and MoE kernels
   against the gather read and the plain versions, and the first prompt's
   prefill logits against the plain versions, in fp32 through the first 2
   layers (rtol = atol = 1e-3).  Then the contiguous engine (``fixed``, 3
   requests, neither attention kernel); [prefill long] deepseek-v2: the
   chunked prefill (chunks of 512) against one chunk on 1,024 tokens (the
   first layer's MLA attention output within ``FLASH_TOL``, the logits
   through 2 fp32 layers within 1e-3 and 1 bf16 layer within 5e-2), then
   one prompt of 8,192 tokens through the contiguous prefill and 16 greedy
   decode steps (ms, peak); then the paged engine again with
   the routed experts quantized in place under ``int8_expert``, printing
   their stored bytes and the peak memory;
9. training, built once deepseek's model is freed: ``moe_ffn`` forward
   and backward at moonshot's training shape (T=4096, bf16) under
   ``set_sync_debug_mode("error")`` on both policies; one step's loss and
   every gradient of moonshot at full width cut to 2 layers, fp32
   parameters, on the kernels against autograd through the plain versions,
   in fp32 compute (loss within 1e-5, each gradient within 1e-3 of its
   largest plain magnitude) and in bf16 compute (``TRAIN_CHECK_TOL``); then
   the trainer on moonshot at full width cut to 4 layers (2.521 B
   parameters, fp32 with fp32 AdamW moments, bf16 compute, ``fixed``;
   ``--layers`` does not change it): 5 steps of batch 8 x seq 512 on the
   reference's Markov tokens, each step's loss, grad_norm, time, peak
   memory and launches printed (per step and MoE layer: B7 and B1^T 3
   each, B7 writing the bf16 expert copy's gradient directly, permute and
   unpermute 2 each; every loss finite), one step under
   the profiler, then 4 steps on the first batch again at a constant rate
   from fresh moments, whose loss must fall.  The MoE layer's sync-debug
   forward and backward runs on ``capacity_factor`` too.  [train capacity
   remat]: the same model, batch and steps on ``capacity_factor`` (1.25)
   with remat, each step's launches checked (remat adds the forward's
   router, permute, fused_gate_up, down grouped_gemm and unpermute once per
   MoE layer), its step time, tokens/s, peak memory, busy share and
   ``sched/drop_fraction`` beside the ``fixed`` run without remat, and the
   peak of one forward and backward alone with and without remat.  [train
   resume]: moonshot cut to 2 layers (1.345 B parameters) on
   ``capacity_factor`` with remat, 4 steps: two uninterrupted runs bitwise
   equal, then a run checkpointing every 2 steps (keeping 1) with a
   failure injected at step 3, restarted by ``supervise``: it resumes from
   step 2 and ends bitwise where the uninterrupted runs end; the
   directory's free space (too little fails the phase), the checkpoint's
   bytes and the host copy, write and restore times printed; the
   supervised runs carry a memory observability bundle, whose
   ``train/step`` and ``train/checkpoint`` spans must be there.  [serve
   ckpt]: that checkpoint, before it is removed, served by the serve
   launcher (``repro_torch.launch.serve.main`` with ``--ckpt-dir``, its
   ``params/*`` read and cast, 4 requests of 16 new tokens on 2 slots of
   the paged ``dynamic`` engine) in fp32, in bf16 and in bf16 with
   ``--quant int8_expert``: greedy tokens identical to an engine over the
   uninterrupted run's final parameters (cast to bf16, then quantized by
   ``quantize_model``) on the same requests, B1-B6 each launched by the
   launcher's runs (the int8 GEMMs by the last); the bytes read, the
   restore seconds, the bf16 engine's decode ms a step, and the int8
   model's bytes on the card (held in [analysis]).  [train
   sharded]: moonshot at full width cut to 2 layers on 2 gloo ranks
   sharing the card, on
   grids (data x model) 2x1 (FSDP + DP) and 1x2 (EP + SP): one fp32 step of
   batch 2 x seq 128 against the single rank's on the same weights and
   batch (the loss within 1e-4, grad_norm within 1e-5 relative, every
   parameter after the step within 1e-6; the
   single rank's parameters written to ``build/ckpt_sharded`` and read back
   by each rank as its blocks, then removed), each rank's launches (per MoE
   layer as one rank's step); on 1x2, before that step, its loss and
   gradient blocks with ``ep_overlap`` (2 microbatches) within
   ``TRAIN_CHECK_TOL["float32"]`` of those without (``overlap_check``);
   then bf16 with remat, batch 8 x seq 512, one
   warm step through ``train(grid=)`` and 1 timed: step
   ms beside the single rank's at the same depth, peak
   memory a rank, the bytes of a rank's parameter and moment blocks, and
   the collectives a step with the bytes they gather, reduce-scatter,
   all-reduce and exchange.  Then the same ranks hold the late families'
   fp32 step on both grids against the single rank's, as moonshot's
   check (loss, grad_norm, every parameter; no kernel launched): rwkv6-1.6b
   at 2 layers and zamba2-7b at 9 (one group and the suffix), whose rules
   split the heads over 'model', llama-3.2-vision-11b's first group and
   hubert-xlarge at 2 layers, under sequence parallelism.  [train mla]:
   deepseek-v2-236b at full width
   cut to 2 layers (1 dense + 1 MoE, 5.36 B fp32 parameters), bf16
   compute, ``fixed``, batch 4 x seq 512: one forward and backward on the
   kernels (launches per MoE layer B5 1, B3 2, B2 1, B1 3, B4 2, B1^T 3,
   B7 3) against the plain executor (loss and every gradient within
   ``TRAIN_CHECK_TOL["bfloat16"]``; the kernels' gradients on the host
   meanwhile), then 3 timed forward and backward passes (ms, tokens/s,
   peak), one under the profiler, and B7 and B1^T held and timed at its
   T=2048 beside their bounds and ``torch._grouped_mm``; no AdamW step,
   whose 16 bytes a parameter (85.7 GB) the card cannot hold (printed);
10. the dense family, once training's models are freed.  [serve gemma2]:
   gemma2-9b at full width and all 42 layers (9.24 B parameters, random
   bf16 weights, seed 0) on [serve paged]'s traffic, through the paged
   engine (blocks of 16, chunks of 32, the fused read: the GQA kernel's
   launches must equal layers x forwards and no MoE kernel runs; the
   prefix cache must hit; a profile of 2 chunk steps and 5 decode steps)
   and the contiguous engine, then the first paged step's logits of a
   4-layer fp32 copy through the fused read against the gather read (rtol
   = atol = 1e-3).  [prefill long]: one prompt of 8,192 tokens (gemma2's
   published context) through contiguous prefill at full depth, then 16
   greedy decode steps (logits finite, tokens in the vocabulary; prefill
   ms, tokens/s, peak memory); (a) the chunked ``flash_attention`` (chunks
   of 512) against the whole-score ``attention`` at gemma2's local (window
   4096) and global layers at 8,192 positions, fp32 within 1e-5 and bf16
   within 2e-2, with the peak memory of each.  [serve dense]: qwen2-7b,
   starcoder2-3b and smollm-360m at full width, depth cut to 2, two
   requests each through the paged engine with the same launch checks.
   Then qwen2-7b at full width and 14 of its 28 layers (since PR 31)
   prefills one prompt of 32,768 tokens (the reference's prefill_32k
   shape, batch 1), as gemma2's above.  [train dense]: smollm-360m at full width and all 32 layers
   (fp32 parameters and moments, bf16 compute, remat) trains 4 steps of
   batch 8 x seq 2,048 through ``train()`` (each loss finite, no kernel
   launched; step ms, tokens/s, peak) and one step of its first 4 layers
   under the profiler;
   then without remat at the largest
   batch whose peak, extrapolated from batches 1 and 2, stays within 0.8
   of the card (two steps: ms and peak); then one fp32 forward and
   backward of its first 2 layers on the card against the port on the CPU
   on the same weights and batch (loss within 1e-5, every gradient within
   1e-4);
11. the recurrent families, once the dense family's models are freed, each
   at full width and depth with random bf16 weights (seed 0).  [serve
   rwkv6]: rwkv6-1.6b (24 layers, 1.584 B parameters); [serve zamba2]:
   zamba2-7b (81 Mamba2 layers and 14 attention applications in 95
   blocks, 7.162 B parameters: the two shared blocks once, the last
   attention block its own, none of the reference's unread ``body.b0``
   blocks).  Each through ``ServeEngine`` as the launcher builds it (the
   engine picks the contiguous cache: every slot carries its recurrent
   state), 4 prompts of 512 tokens on 2 slots, 16 new tokens each: every
   request completes with tokens in the vocabulary, no kernel of the port
   launches (every launch counter stays 0: these models have no expert
   and no paged read), a full-depth prefill and decode step give finite
   logits; prefill ms a request, decode ms a step, tokens/s, peak memory,
   and a profile of 5 decode steps (busy share, device activities a step).
   Then an fp32 copy of its first layers (rwkv6: 2; zamba2: its least
   depth, an attention block and 3 Mamba layers) on the card against the
   same copy on the CPU, two of the prompts: prefill logits within 1e-4,
   8 greedy tokens equal; and one slot serving two requests in turn, each
   getting the tokens it gets alone.  For zamba2 also the prefill of a
   2,039-token prompt (prime) against a 2,048-token one, within 1.5x of
   each other (the SSD scan's fixed chunks: 16 a layer at either length).
   [prefill long]: zamba2-7b prefills one prompt of 32,768 tokens (the
   reference's prefill_32k shape, batch 1) and rwkv6-1.6b one of 8,192
   at 12 of its 24 layers (since PR 31), then 16 greedy decode steps each
   (ms, tokens/s, peak);
12. the vlm and audio families, no kernel of the port on their paths
   (every launch counter stays 0).  [serve vlm]: llama-3.2-vision-11b at
   full width and all 40 layers (8 groups of 5, a cross-attention block
   4th in each; 9.775 B parameters, random bf16, seed 0) through
   ``ServeEngine`` as the launcher builds it (the engine picks the
   contiguous cache: the cross blocks hold each slot's image K/V), 4
   prompts of 512 tokens on 2 slots, 16 new tokens each, with the zero
   image embeddings the engine feeds: every request completes with tokens
   in the vocabulary; prefill ms a request, decode ms a step, tokens/s,
   peak memory and a profile of 5 decode steps.  Then a full-depth prefill
   and decode step with random non-zero image embeddings against the same
   with zero ones: finite logits that differ, a non-zero cross cache.  Then
   an fp32 copy of its first group (5 layers, the cross block 4th) on the
   card against the same copy on the CPU: two prompts of 128 tokens with
   the same random image embeddings, prefill logits within 1e-4 and 8
   greedy tokens equal.  [train hubert]: hubert-xlarge at full width and
   all 48 layers (945.1 M fp32 parameters and AdamW moments, bf16 compute,
   remat) trains 3 steps of ``make_batch``'s 8 x 1,024 masked frames
   through ``train()`` (finite loss, step ms, peak), one step of its first
   4 layers under the profiler, then a 2-layer fp32 forward and backward
   on the card against the CPU (loss within 1e-5, every gradient within
   1e-4).  [train vlm]: llama-3.2-vision-11b cut to its first group (5
   layers, 2.141 B fp32 parameters) trains 2 steps of 4 x 512 tokens with
   ``make_batch``'s image embeddings (bf16, remat): finite loss, step ms,
   peak;
13. the recurrent families' training, no kernel of the port on the path
   (every launch counter stays 0).  [train rwkv6]: rwkv6-1.6b at full
   width and all 24 layers (1.584 B fp32 parameters and AdamW moments,
   bf16 compute, remat) trains 2 steps of 4 x 512 tokens through
   ``train()`` (finite loss, step ms, tokens/s, peak), one step of its
   first 2 layers under the profiler (busy share, device activities a
   layer and position), one forward + backward of its first 4 layers with
   and without remat at the training batch (ms, peak above the state),
   and a 2-layer fp32 forward + backward on the card against the CPU (loss
   within 1e-5, every gradient within 1e-4).  [train zamba2]: zamba2-7b at
   full width cut to 15 Mamba2 layers (both shared blocks and the suffix's
   own; 2.016 B) trains 3 steps of 4 x 512, then the whole depth's (7.162
   B, 28.6 GB of fp32 weights) forward + backward with remat and no
   optimizer step at 2 x 512 (its AdamW state, 114.6 GB, waits for
   several cards): ms and peak, or the depth it cut to; the fp32 check at
   its least depth (3).
14. analysis: the dry run (``repro_torch.launch.dryrun``: one step on fake
   tensors, FLOPs and bytes reckoned on the host, each case in a process
   of its own started after the last timed phase, ``analysis_prediction``)
   of [train mla] (deepseek-v2, 2 layers, forward + backward), [train
   zamba2]'s full depth (forward + backward), [train rwkv6] (24 layers
   with AdamW), [serve paged]'s model (moonshot, 4 layers, a decode
   step) and [serve ckpt]'s int8 model (moonshot, 2 layers, a decode step
   with ``quant="int8_expert"``) beside the bytes those phases measured:
   parameters (and
   gradients, and rwkv6's AdamW moments, made here) equal to the
   allocator's count (as many tensors, each rounded to 512 B, at most an
   unsplit 1 MiB remainder each past 1 MiB), the predicted peak beside the
   measured one with their ratio; the fit verdicts against 80 GB
   (deepseek-v2's 2 layers with AdamW and zamba2's full depth with AdamW
   do not fit, zamba2's full-depth forward + backward fits); the roofline
   share of every timed decode and training step (``analysis.flops.
   step_work`` on one card over the H100's 989 TFLOP/s and 3.35 TB/s: a
   decode step's routed experts and row contexts as the timed steps had
   them, quantized experts at their stored bytes, no capacity padding)
   beside the card's name and power limit; ``examples/torch/
   quickstart.py`` on the card in a subprocess, exit 0.

``[elapsed]`` lines give the seconds since the start at the end of each
phase.  The last lines are the kernel report ``{"kernels": [...]}``, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import copy
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
# the H100 data sheet's rates, kept once, in the port's roofline
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS as BF16_FLOP_PER_S  # noqa: E402
from repro_torch.analysis.roofline import bound_ms  # noqa: E402
MOONSHOT = dict(E=64, k=6, d=2048, f=1408, M=128, gating="sigmoid",
                norm_topk=True, routed_scale=2.446)
MIXTRAL = dict(E=8, k=2, d=4096, f=14336, M=128, gating="softmax",
               norm_topk=False, routed_scale=1.0)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_NEW = 2, 4, 16
# [serve obs]: rounds of (NOOP, memory, stats off, stats off, memory,
# NOOP) decode steps, switched step by step on one engine
OBS_ROUNDS = 15
CONTIG_REQUESTS = 3
# [serve sample]: the sampling configs (seed 0 each), and the rounds of
# (greedy, temperature, top_k, top_p, top_p, top_k, temperature, greedy)
# decode steps switched step by step on one engine
SAMPLE_METHODS = {
    "temperature": dict(method="temperature", temperature=0.8, seed=0),
    "top_k": dict(method="top_k", temperature=0.8, top_k=50, seed=0),
    "top_p": dict(method="top_p", temperature=0.8, top_p=0.9, seed=0)}
SAMPLE_ROUNDS = 6
# the reference's threefry words (jax.random on the CPU, threefry2x32 with
# partitionable counters; JAX 0.9.0) for (seed, counter, role): the row
# key, bits 0, 1, 2 and 163,839 of a (163840,) draw, the scalar uniform
THREEFRY_VECTORS = (
    (0, 0, 0, (4165894930, 804218099),
     (1214273199, 3384852239, 1707608394, 3025140783), 0.2827199697494507),
    (7, 3, 1, (4073741833, 2748900490),
     (429855279, 897732436, 215886965, 637752223), 0.10008347034454346),
    (123456, 16, 2, (1050066568, 1862183662),
     (1083057526, 330649040, 1464979654, 20279065), 0.2521688938140869),
    (-5, 70000, 3, (1124436665, 802648950),
     (648655163, 1328871060, 2846055782, 2262432228), 0.15102672576904297))
# [serve spec]: proposals a round, the verify's rows on SERVE_SLOTS slots,
# the requests and new tokens of the fp32 identity check and of the
# tokens/s turns
SPEC_K = 4
VERIFY_ROWS = SERVE_SLOTS * (SPEC_K + 1)
SPEC_CHECK_NEW, SPEC_RATE_NEW = 12, 24
# [serve loadgen]: requests a trace and their offered rate (virtual req/s),
# as the reference's launcher replays them
LOADGEN_REQUESTS, LOADGEN_RATE = 16, 8.0
KV_BLOCK, PREFILL_CHUNK, SHARED_PREFIX = 16, 32, 40
ATTN = dict(Hkv=16, G=1, D=128, bs=16,          # moonshot's attention
            arch="moonshot-v1-16b-a3b")
ATTN_GQA = dict(Hkv=8, G=4, D=128, bs=16,       # mixtral-8x7b's
                arch="mixtral-8x7b")
# the dense family's attention (GQA over blocks of 16), each at decode and
# at the 64-row chunk step: gemma2-9b with its softcap of 50, qwen2-7b,
# starcoder2-3b, smollm-360m
DENSE_ATTN = {"gemma2-9b": dict(Hkv=8, G=2, D=256, bs=16, softcap=50.0),
              "qwen2-7b": dict(Hkv=4, G=7, D=128, bs=16),
              "starcoder2-3b": dict(Hkv=2, G=12, D=128, bs=16),
              "smollm-360m": dict(Hkv=5, G=3, D=64, bs=16)}
# [serve dense]: the other three dense configs at full width, depth cut to
# DENSE_LAYERS, DENSE_REQUESTS requests through the paged engine.  [prefill
# long]: one prompt of each config's length through contiguous prefill at
# full depth (gemma2-9b: its published context; qwen2-7b: the reference's
# prefill_32k shape with its batch cut from 32 to 1), then LONG_DECODE
# greedy tokens; the chunked attention against the whole-score one at
# gemma2's local and global layers at FLASH_CHECK_S positions
DENSE_LAYERS, DENSE_REQUESTS = 2, 2
LONG_PROMPTS = {"gemma2-9b": 8192, "qwen2-7b": 32768,
                "deepseek-v2-236b": 8192, "zamba2-7b": 32768,
                "rwkv6-1.6b": 8192}
# the recurrent families at full width and depth, random bf16 weights from
# seed 0: RECURRENT_REQUESTS prompts of RECURRENT_PROMPT tokens, SERVE_SLOTS
# slots, RECURRENT_MAX_NEW new tokens each, on the contiguous engine the
# launcher's default picks.  The fp32 copy held on the card against the
# port on the CPU: rwkv6's first 2 layers; zamba2's first 4 blocks, its
# least depth (n_layers 3: an attention block and 3 Mamba layers), 2 of
# the prompts, RECURRENT_CHECK_NEW greedy tokens.  zamba2 also prefills a
# prime-length prompt against an even one (ROADMAP C12).  16 new tokens
# since the recurrent families' training joined the run (32 before, whose
# decode steps took 3.7 s of rwkv6's phase and 13.6 s of zamba2's): a
# decode step's ms is the mean over the decode-only steps either way
RECURRENT_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
RECURRENT_REQUESTS, RECURRENT_PROMPT, RECURRENT_MAX_NEW = 4, 512, 16
RECURRENT_CHECK_LAYERS = {"rwkv6-1.6b": 2, "zamba2-7b": 3}
RECURRENT_CHECK_NEW = 8
RECURRENT_CHECK_TOL = dict(rtol=1e-4, atol=1e-4)
RECURRENT_PROFILE_STEPS = 5
ZAMBA2_LIVE_PARAMS = 7_162_186_960       # C11: no unread body.b0 blocks
PRIME_PROMPT, EVEN_PROMPT, PRIME_RATIO = 2039, 2048, 1.5
# [serve vlm]: llama-3.2-vision-11b at full width and depth, random bf16
# weights from seed 0, VLM_REQUESTS prompts of VLM_PROMPT tokens on
# SERVE_SLOTS slots, VLM_MAX_NEW new tokens each, on the contiguous engine
# the launcher's default picks; the engine feeds zero image embeddings (and
# the model has no QKV bias, so every cross block adds exactly 0 there):
# the direct prefill and decode and the fp32 check take random ones,
# make_batch's N(0, 1) * IMAGE_SCALE.  The fp32 check: the first group
# (cross_attn_every layers), VLM_CHECK_PROMPT tokens of two prompts,
# VLM_CHECK_NEW greedy tokens
VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-11b", "hubert-xlarge"
VLM_PARAMS, VLM_GROUP_PARAMS = 9_775_157_248, 2_141_237_248
AUDIO_PARAMS = 945_104_640
VLM_REQUESTS, VLM_PROMPT, VLM_MAX_NEW = 4, 512, 16     # as the recurrent
VLM_CHECK_PROMPT, VLM_CHECK_NEW = 128, 8
VLM_CHECK_TOL = dict(rtol=1e-4, atol=1e-4)
VLM_PROFILE_STEPS = 5
IMAGE_SCALE = 0.3
# [train hubert]: full width and depth through train(); the profiled step
# runs its first AUDIO_PROFILE_LAYERS layers (as [train dense]); the fp32
# check as [train dense]'s (DENSE_CHECK_TOL).  [train vlm]: the first
# group only, VLM_TRAIN_STEPS steps
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_STEPS = 8, 1024, 3
AUDIO_PROFILE_LAYERS = 4
AUDIO_CHECK_LAYERS, AUDIO_CHECK_BATCH, AUDIO_CHECK_SEQ = 2, 2, 256
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, VLM_TRAIN_STEPS = 4, 512, 2
# [train rwkv6]: full width and depth through train() (bf16 compute on fp32
# parameters and AdamW moments, remat); one step of its first
# RWKV_PROFILE_LAYERS layers under the profiler; one forward + backward of
# its first RWKV_PEAK_LAYERS layers at the training batch with and without
# remat (the WKV loop keeps three (B, H, 64, 64) fp32 tensors a position
# for the backward: at the training batch 3.2 GB a layer, about 77 GB for
# 24 layers without remat; the step is launch bound, so the whole depth's
# pair at one row took 37.6 s where 4 layers take a sixth); the fp32 check
# of RWKV_CHECK_LAYERS layers card vs CPU (DENSE_CHECK_TOL).  2 steps: each
# took 16.8-17.2 s on an H100, and one timed step after the first is
# enough for a launch-bound loop
RWKV_ARCH, ZAMBA_ARCH = "rwkv6-1.6b", "zamba2-7b"
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 4, 512, 2
RWKV_PROFILE_LAYERS, RWKV_PEAK_LAYERS = 2, 4
RWKV_CHECK_LAYERS, RWKV_CHECK_BATCH, RWKV_CHECK_SEQ = 2, 2, 128
# [train zamba2]: ZAMBA_TRAIN_LAYERS Mamba2 layers (two groups and the
# suffix: all three attention blocks applied, 2.02 B parameters, 32 GB of
# fp32 training state) through train(); then the whole depth's forward +
# backward with remat and no optimizer step (7.162 B parameters: 28.6 GB of
# fp32 weights and as many of gradients; its AdamW state, 114.6 GB, waits
# for several cards) at ZAMBA_FULL_BATCH rows, cut to the depths of
# ZAMBA_FULL_FALLBACK where it does not fit; the fp32 check at its least
# depth (an attention block and 3 Mamba layers)
ZAMBA_TRAIN_LAYERS = 15
ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, ZAMBA_TRAIN_STEPS = 4, 512, 3
ZAMBA_FULL_BATCH, ZAMBA_FULL_FALLBACK = 2, (45, 27)
ZAMBA_CHECK_LAYERS, ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ = 3, 2, 128
# [train sharded] of the late families: (arch, depth) at full width, one
# fp32 step on each grid of SHARDED_GRIDS against the single rank's, as
# [train sharded]'s check (the batch, optimizer and tolerances)
FAMILY_SHARDED = (("rwkv6-1.6b", 2), ("zamba2-7b", 9),
                  ("llama-3.2-vision-11b", 5), ("hubert-xlarge", 2))
# [prefill long]'s depth where it is cut: every layer repeats the same
# loop (qwen2-7b's chunk pairs, rwkv6's WKV recurrence over the prompt), so
# half the depth halves the time and keeps the prefill's own memory; whole,
# the two took 20-31 s and 22-25 s of runs of 515-622 s (PR 31)
LONG_LAYERS = {"qwen2-7b": 14, "rwkv6-1.6b": 12}
LONG_DECODE, FLASH_CHECK_S, FLASH_CHUNK = 16, 8192, 512
FLASH_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# deepseek-v2-236b's absorbed MLA decode: one latent KV head of 512 and a
# rope key of 64 for 128 query heads; and its MoE layer
MLA_ATTN = dict(Hkv=1, G=128, D=512, D2=64, bs=16)
DEEPSEEK = dict(E=160, k=6, d=5120, f=1536, M=128, gating="softmax",
                norm_topk=False, routed_scale=16.0)
DEEPSEEK_LAYERS, DEEPSEEK_CHECK_LAYERS = 4, 2
# [prefill long] deepseek-v2: the chunked prefill (chunks of FLASH_CHUNK)
# against one chunk (q_chunk = kv_chunk = 0) on a prompt of
# MLA_CHUNK_CHECK_S tokens, in fp32 through DEEPSEEK_CHECK_LAYERS layers
# and in bf16 through the first (dense) layer: in bf16 the two orders of
# summation round the attention's output apart by an ulp here and there,
# which can flip a near-tied top-k pick of a random-weight router and
# change that row wholesale, as in [serve paged]'s bf16 check
MLA_CHUNK_CHECK_S = 1024
# [tune]: the tile sweeps of B1 and B2 (arch, shape, T, policy; dense bf16,
# and int8 at TUNE_INT8), recorded into a temporary tune cache
TUNE_SWEEPS = (("moonshot-v1-16b-a3b", MOONSHOT, SERVE_SLOTS, "dynamic"),
               ("moonshot-v1-16b-a3b", MOONSHOT, 4096, "fixed"),
               ("deepseek-v2-236b", DEEPSEEK, SERVE_SLOTS, "dynamic"),
               ("deepseek-v2-236b", DEEPSEEK, 4096, "fixed"))
TUNE_INT8 = ("moonshot-v1-16b-a3b", MOONSHOT, SERVE_SLOTS, "dynamic")
# the routers held and timed alone, beside moonshot's and deepseek-v2's
# (which run in every Case): mixtral-8x7b's E=8, and deepseek-v3's
# (configs/paper.py: E=256, k=8, sigmoid) with DeepSeek-V3's
# renormalisation and routed_scaling_factor 2.5, without its group-limited
# selection (the reference's router has none); held at ROUTE_CHECK_TS,
# timed at ROUTE_TIME_TS
ROUTERS = {"moonshot-v1-16b-a3b": MOONSHOT, "deepseek-v2-236b": DEEPSEEK,
           "mixtral-8x7b": MIXTRAL,
           "deepseek-v3": dict(E=256, k=8, gating="sigmoid", norm_topk=True,
                               routed_scale=2.5)}
ROUTE_CHECK_TS, ROUTE_TIME_TS = (1, 2, 3, 64, 4096), (2, 64, 4096)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)   # bf16 through CHECK_LAYERS layers
LOGIT_TOL_FP32 = dict(rtol=1e-3, atol=1e-3)
CHECK_LAYERS = 4
# B7's fp32 output: both sides sum exact products of the inputs in fp32
WGRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# training: moonshot's full-width step (T = 4096 tokens), and the fp32
# check of one step's gradients against the plain versions
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 8, 512, 5, 4
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
# one step on the kernels against the plain versions: the loss (relative)
# and each gradient (relative to its largest plain magnitude).  Measured on
# an H100: fp32 0 and 1.7e-6; bf16 2.5e-5 and 1.3e-2 (embed; the expert
# stacks 3.5e-3 to 6.0e-3)
TRAIN_CHECK_TOL = {"float32": dict(loss=1e-5, grad=1e-3),
                   "bfloat16": dict(loss=1e-3, grad=5e-2)}
# [train mla]: deepseek-v2 at full width cut to its shallowest depth with
# an MoE layer (1 dense + 1 MoE: 5.36 B parameters), fp32 parameters, bf16
# compute, fixed, one batch: the forward and backward on the kernels
# against the plain executor (TRAIN_CHECK_TOL["bfloat16"]), then timed
# MLA_TRAIN_REPS times.  No AdamW step: fp32 parameters, gradients and two
# moments take 16 bytes a parameter, 85.7 GB, past the card's 80 GB
MLA_TRAIN_LAYERS, MLA_TRAIN_BATCH, MLA_TRAIN_SEQ, MLA_TRAIN_REPS = \
    2, 4, 512, 3
# [train dense]: smollm-360m at full width and all 32 layers through
# train(), fp32 parameters, bf16 compute, remat; then steps without remat
# at the largest batch whose peak, extrapolated from batches 1 and 2, stays
# within DENSE_NOREMAT_SHARE of the card; then one fp32 forward and
# backward of its first DENSE_CHECK_LAYERS layers on the card against the
# port on the CPU (same weights and batch): the loss within 1e-5, every
# gradient within 1e-4 (rtol = atol)
DENSE_TRAIN_ARCH = "smollm-360m"
DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS = 8, 2048, 4
# the profiled step runs the model cut to its first DENSE_PROFILE_LAYERS
# layers: every layer runs the same kernels, and the profiler's host
# post-processing of all 32 layers' 46,324 activities took about 40 s of
# host time beside an H100
DENSE_PROFILE_LAYERS = 4
DENSE_NOREMAT_SHARE = 0.8
DENSE_CHECK_LAYERS, DENSE_CHECK_BATCH, DENSE_CHECK_SEQ = 2, 2, 256
DENSE_CHECK_TOL = {"loss": dict(rtol=1e-5, atol=1e-5),
                   "grad": dict(rtol=1e-4, atol=1e-4)}
# the full-width model then fits one batch: TRAIN_FIT_STEPS steps on it at
# a constant learning rate, from fresh AdamW moments; its loss must fall
TRAIN_FIT_STEPS, TRAIN_FIT_LR = 4, 1e-5
# the plain GEMMs' eager timing, (calls, warm-up calls): at the serving
# shapes, and at training's T=4096, where one plain call walks thousands of
# blocks from Python and is a yardstick only
PLAIN_ITERS = {False: (5, 3), True: (1, 1)}
# [capacity]: the capacity_factor policy's headroom at each check (the
# reference's sweep value, and one that fills every bucket and drops), the
# one its timing and training run at, and the 2-layer model checkpointed
# by [train resume] (1 dense + 1 MoE), its steps, failure and saves
CAPACITY_FACTORS, CAPACITY_FACTOR = (1.25, 0.5), 1.25
RESUME_LAYERS, RESUME_STEPS, RESUME_FAIL_AT, RESUME_SAVE_EVERY = 2, 4, 3, 2
RESUME_CKPT = ROOT / "build" / "ckpt_smoke"     # [serve ckpt] reads it
# [train sharded]: the grids (data, model) of the 2 ranks on the card, each
# with its timed bf16 steps after the warm one (a grid's steps are set by
# gloo's host transport, so one is enough: 1x2's 3 took 11-15 s of a run
# that must stay near half the limit, PR 31); the fp32 check's batch and
# optimizer (eps 1e-3: each update a smooth function of its gradient, slope
# at most lr / eps, so the gradients' agreement bounds the parameters'; at
# 1e-8 a gradient within rounding of zero can flip its element's whole
# update); its tolerances: the loss, every parameter after the step, and the
# gradient norm, relative (the clip to norm 1 and Adam's first step divide
# out a gradient's scale, so a gradient wrong by a uniform factor shows in
# the norm alone)
SHARDED_RANKS, SHARDED_GRIDS = 2, ((2, 1, 1), (1, 2, 1))
# its depth: moonshot cut to 2 layers (1 dense + 1 MoE); its bf16 steps are
# gloo's host transport (96-98 % of a step on an H100), so bytes set the
# time, and at 4 layers the phase took 117.6-184.0 s of a run that must
# stay near half the limit; the single rank's bf16 step at this depth is
# timed beside it
SHARDED_LAYERS = 2
SHARDED_CHECK_BATCH, SHARDED_CHECK_SEQ = 2, 128
SHARDED_CHECK_OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10,
                         weight_decay=0.0)
SHARDED_LOSS_TOL, SHARDED_PARAM_TOL, SHARDED_GNORM_RTOL = 1e-4, 1e-6, 1e-5
SOURCES = {
    "router_topk": ("src/repro_torch/csrc/router_topk.cu",
                    "src/repro/kernels/router_topk.py:60"),
    "permute": ("src/repro_torch/csrc/permute.cu",
                "src/repro/kernels/permute.py:30"),
    "fused_gate_up": ("src/repro_torch/csrc/fused_gate_up.cu",
                      "src/repro/kernels/fused_gate_up.py:73"),
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:83"),
    "unpermute": ("src/repro_torch/csrc/unpermute.cu",
                  "src/repro/kernels/unpermute.py:45"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:100"),
    "paged_attention_mla": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:100"),
}
SOURCES["grouped_gemm_t"] = ("src/repro_torch/csrc/grouped_gemm_t.cu",
                             "src/repro/kernels/grouped_gemm.py:83")
SOURCES["grouped_wgrad"] = ("src/repro_torch/csrc/grouped_wgrad.cu",
                            "src/repro/kernels/grouped_wgrad.py:62")
for _k, _fmt in (("fused_gate_up", "int8"), ("fused_gate_up", "int4"),
                 ("grouped_gemm", "int8"), ("grouped_gemm", "int4")):
    SOURCES[f"{_k}_{_fmt}"] = SOURCES[_k]
MOE_KERNELS = ("router_topk", "permute", "fused_gate_up", "grouped_gemm",
               "unpermute")
QUANT_SCHEMES = ("int8_expert", "int8_channel", "int4_packed")
# the (policy, T) shapes the quantized GEMMs are held and timed at
QUANT_SHAPES = (("fixed", 2), ("dynamic", 2), ("fixed", 64), ("dynamic", 64))
# the scheme that stands for each format in the kernel report
REPORT_SCHEME = {"int8": "int8_expert", "int4": "int4_packed"}
# [ep]: ranks sharing the card (gloo); the fp32 token arms' RunConfig
# overrides (every paged step is a decode step, so the decode layout is the
# layout of every MoE layer); the MoE layer held in bf16 at these T; the
# drop check's capacity_factor headroom, requests (prompt tokens, max_new),
# prefill chunk and dispatch block.  Its buckets are rounded up to block_m,
# so at moonshot's 128 no serving step of a few dozen rows ever fills one:
# the check runs the dispatch at the dynamic policy's 8-row blocks, and
# request 0 retires in the step that carries request 1's second chunk of
# 64 prompt rows, whose buckets of 8 rows overflow
EP_RANKS = 2
EP_ARMS = {"replicated": dict(ep_decode_layout="replicated"),
           "sharded": dict(ep_decode_layout="sharded"),
           "overlap2": dict(ep_decode_layout="sharded", ep_overlap=True,
                            ep_microbatches=2)}
EP_TIMED_ARMS = ("replicated", "sharded")
EP_LAYER_TS = (2, 64)
EP_LAYER_LAYOUTS = {"sharded": 0, "sharded_static": 0, "replicated": 0,
                    "overlap2": 2}
EP_COLLECTIVE_ITERS = 50
# [ep] under autograd: the first MoE layer in fp32 on the cuda executor,
# forward and backward of sum(y * dy) in each of EP_LAYER_LAYOUTS on a
# sequence-split x and in the ragged fallback (neither B nor S divides over
# EP_RANKS: replicated); every gradient against the single rank's
# apply_moe backward on the card (sharded_static, whose buckets drop,
# against the same layout on the plain executor) within
# TRAIN_CHECK_TOL["float32"]["grad"] of its largest magnitude; then
# EP_GRAD_REPS timed passes (host clock, median)
EP_GRAD_SHAPES = {"seq": (2, 64), "ragged": (3, 5)}
EP_GRAD_ARMS = {**{lay: ("seq", lay.replace("overlap2", "sharded"), ov)
                   for lay, ov in EP_LAYER_LAYOUTS.items()},
                "ragged": ("ragged", "sharded", 0)}
EP_GRAD_POLICY, EP_GRAD_REPS = "dynamic", 3
EP_CF, EP_DROP_REQUESTS, EP_DROP_CHUNK, EP_DROP_BLOCK_M = \
    0.5, ((8, 2), (200, 2)), 64, 8
# [executors]: tokens of each paper layer (configs/paper.py; T=32 and 512
# at least, mixtral-8x7b at 512 being Table 4's cell), the largest E of
# the dense arm (the reference's benchmarks/e2e_latency.py leaves
# deepseek-v3 out of it), each arm's MoEDispatchConfig overrides, the timed
# calls an arm (median), the weights' seed, the fp32 weight bytes a chunk
# of the oracle; the trained check's depth, batch and sequence
EXEC_TS = {"mixtral-8x7b": (32, 128, 512, 2048),
           "mixtral-8x22b": (32, 512), "qwen2-moe-57b": (32, 128, 512),
           "deepseek-v3": (32, 512)}
EXEC_DENSE_MAX_E = 64
EXEC_ARMS = {"cuda fused": dict(executor="cuda"),
             "cuda unfused": dict(executor="cuda", fuse_gate_up=False,
                                  fold_combine=False),
             "blocks": dict(executor="blocks"),
             "dense": dict(executor="dense")}
EXEC_ITERS, EXEC_SEED, EXEC_ORACLE_BYTES = 5, 7, 4e9
# an arm's output against the fp32 oracle: max|y - oracle| within the bf16
# tolerance (tests/test_kernels.py:31-33) of max|oracle|, the form of the
# reference's whole-layer check against its dense oracle
# (tests/test_differential.py:118-124).  Elementwise it cannot hold: each
# grouped arm rounds h and every expert's weighted contribution to bf16
# before B4 sums them (the reference's executors too), and at deepseek-v3's
# k=8 unnormalised sigmoid weights a cancelling sum of such contributions
# missed rtol=atol=2e-2 by 0.0027 (3 of 229,376 elements; its max 0.0227
# at an element of 0.0037, an H100 run)
EXEC_REL_TOL = TOL["bfloat16"]["rtol"]
EXEC_TRAIN_LAYERS, EXEC_TRAIN_BATCH, EXEC_TRAIN_SEQ = 2, 2, 128
# the served runs' schedule: blocks loops over every block of it, and the
# dynamic policy's 8-row sub-blocks over moonshot's 128-row envelope give
# 1,040 blocks a GEMM at decode (1,575.1 ms a bf16 step against 25.1 on
# cuda, an H100 run); the fixed policy's 128-row blocks give 65
EXEC_SERVE_POLICY = "fixed"
EXEC_TRAIN_TOL = dict(loss=1e-5, grad=1e-4)
# the Hopper kernels (wgmma + TMA): report name -> the mangled name's stem
# of each instantiation in the built library (the forward's kernels are
# templates: FUSED false is B1, true B2; the quantized one's FMT 1 is int8,
# 2 int4; the bf16 MLA kernel's TP 64 and 32 positions a tile)
HOPPER_KERNELS = {"grouped_gemm": "fwd_hopper_kernelILb0E",
                  "fused_gate_up": "fwd_hopper_kernelILb1E",
                  "grouped_gemm_int8": "fwd_quant_kernelILb0ELi1E",
                  "grouped_gemm_int4": "fwd_quant_kernelILb0ELi2E",
                  "fused_gate_up_int8": "fwd_quant_kernelILb1ELi1E",
                  "fused_gate_up_int4": "fwd_quant_kernelILb1ELi2E",
                  "grouped_wgrad": "wgrad_hopper_kernel",
                  "grouped_gemm_t": "gemm_t_hopper_kernel",
                  "paged_attention_mla": "mla_hopper_kernel"}


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def start_sass(lib_path):
    """``cuobjdump -sass`` of the built library, started in the background
    (it runs beside the kernel checks; ``sass_counts`` collects it); killed
    at exit if it is still running."""
    import atexit
    import shutil
    import tempfile
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([tool, "-sass", str(lib_path)], stdout=out,
                            stderr=subprocess.DEVNULL, text=True)
    atexit.register(proc.kill)
    return proc, out


def sass_counts(job) -> dict:
    """Per instantiation of the Hopper kernels in the built library: its
    count of HGMMA (wgmma) and UTMALDG (TMA load) instructions, from the
    ``cuobjdump -sass`` that ``start_sass`` started."""
    proc, out = job
    if proc.wait(timeout=300) != 0:
        fail(f"cuobjdump -sass exited with {proc.returncode}")
    out.seek(0)
    sass = out.read()
    out.close()
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if any(stem in name for stem in
                             HOPPER_KERNELS.values()) else None
            if fn is not None:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                if op in line:
                    counts[fn][op] += 1
    return counts


def kernel_name(mangled: str, width: int = 72) -> str:
    """A kernel's mangled name without the anonymous namespace's prefix
    (``_ZN..._GLOBAL__N__<hash>_<file>_cu_<hash>``), cut to ``width``."""
    import re
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                  mangled)[:width]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` eager calls (CUDA events, after
    ``warm`` warm-up calls).  Where the device finishes before the host has
    issued the next call, this is the host's time per call."""
    import torch
    for _ in range(warm):
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


def device_ms(fn, per_graph: int, replays: int = 10) -> float:
    """Mean device time of ``fn``: ``per_graph`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call cost drops out."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def poisoned(fn, numel: int, dtype):
    """Run ``fn`` right after filling and freeing a buffer of the output's
    size with NaN, so that an output the kernel fails to write shows up."""
    import torch
    junk = torch.empty(numel, dtype=dtype, device="cuda")
    junk.fill_(float("nan"))
    del junk
    return fn()


def profile_window(fn, top: int = 8) -> dict:
    """Host wall time of ``fn`` (ending in a synchronise) under
    torch.profiler, the device's busy time in it, and the top kernels by
    device time and host entries by self time.  Busy time is the union of
    the device-side activity intervals (kernels, copies, sets): summing the
    per-op averages would count each kernel twice, once under its own name
    and once under the aten op that launched it.  "Command Buffer Full" is
    a launch-queue stall on the host, not device work.  The rows come from
    the profiler's raw events (``window_stats``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return window_stats(prof.profiler.kineto_results.events(), wall, top)


def window_stats(events, wall: float, top: int) -> dict:
    """``profile_window``'s figures from raw profiler events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``start_thread_id()``).  A host entry's self time is its duration less
    its direct children's: the events of one thread nest by their
    intervals.  Building the profiler's own event tree (``events()``,
    ``key_averages()``) costs seconds of host a window of a few thousand
    device activities; these loops cost a fraction of one."""
    import collections
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.name() != "Command Buffer Full":
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.start_thread_id(), e.start_ns(), e.duration_ns(),
                         e.name()))
    busy, end = 0, float("-inf")
    per_kernel = collections.defaultdict(lambda: [0, 0])
    for start, stop, name in sorted(dev):
        busy += max(0, stop - max(start, end))
        end = max(end, stop)
        per_kernel[name][0] += 1
        per_kernel[name][1] += stop - start
    by_dev = sorted(per_kernel.items(), key=lambda kv: kv[1][1],
                    reverse=True)[:top]
    per_host = collections.defaultdict(lambda: [0, 0])
    stack = []                     # open entries: [thread, end, name, self]

    def close(entry):
        per_host[entry[2]][0] += 1
        per_host[entry[2]][1] += entry[3]
    for tid, start, dur, name in sorted(host, key=lambda h: (h[0], h[1],
                                                             -h[2])):
        while stack and (stack[-1][0] != tid or stack[-1][1] <= start):
            close(stack.pop())
        if stack:
            stack[-1][3] -= dur
        stack.append([tid, start + dur, name, dur])
    while stack:
        close(stack.pop())
    by_cpu = sorted(per_host.items(), key=lambda kv: kv[1][1],
                    reverse=True)[:top]
    return {"wall_ms": wall * 1e3, "device_ms": busy / 1e6,
            "busy_share": busy / 1e6 / (wall * 1e3),
            "kernel_ms": sum(v[1] for v in per_kernel.values()) / 1e6,
            "device_events": len(dev),
            "top_device": [(k[:90], n, ns / 1e6) for k, (n, ns) in by_dev],
            "top_cpu": [(k[:90], n, ns / 1e6) for k, (n, ns) in by_cpu]}


def router_work(T: int, E: int, k: int):
    """B5's (bytes, flops): the logits read once, weights and indices
    written once."""
    return T * E * 4 + T * k * 8, T * E * (k + 4)


class Case:
    """One layer's inputs at one shape and dtype, and its schedule."""

    def __init__(self, shape: dict, T: int, dtype, seed: int,
                 policy: str = "fixed", **policy_kw):
        import torch
        from repro_torch.kernels import ref
        from repro_torch.scheduling import build_schedule
        from repro_torch.execution import combine_scale_rows
        g = torch.Generator(device="cuda").manual_seed(seed)
        E, d, f = shape["E"], shape["d"], shape["f"]
        self.shape, self.T, self.dtype, self.policy = shape, T, dtype, policy
        self.policy_kw = policy_kw
        self.route_kw = dict(gating=shape["gating"],
                             norm_topk=shape["norm_topk"],
                             routed_scale=shape["routed_scale"])

        def randn(*s, scale=1.0):
            return (torch.randn(s, generator=g, device="cuda") * scale
                    ).to(dtype)
        self.logits = torch.randn((T, E), generator=g, device="cuda")
        self.x = randn(T, d)
        self.wg = randn(E, d, f, scale=d ** -0.5)
        self.wu = randn(E, d, f, scale=d ** -0.5)
        self.wd = randn(E, f, d, scale=f ** -0.5)
        self.w, self.idx = ref.router_ref(self.logits, shape["k"],
                                          **self.route_kw)
        self.sched = build_schedule(self.idx, E, shape["M"], policy=policy,
                                    **policy_kw)
        self.scale = combine_scale_rows(self.sched, self.w)
        self.xp = ref.permute_ref(self.x, self.sched)
        self.h = ref.fused_gate_up_ref(self.xp, self.wg, self.wu, self.sched)
        self.y = ref.grouped_gemm_ref(self.h, self.wd, self.sched,
                                      self.scale)
        active = self.sched.block_active.bool().cpu()
        self.inactive_rows = (~active).repeat_interleave(
            self.sched.block_m).cuda()
        # rows that hold no token: padding, and on capacity_factor the
        # bucket tails, the empty buckets and the sentinel block
        self.tokenless_rows = self.sched.src_tok < 0
        self.n_active_blocks = int(active.sum())
        self.n_experts_used = int((self.sched.counts > 0).sum())

    def label(self) -> str:
        dt = str(self.dtype).replace("torch.", "")
        cf = self.policy_kw.get("capacity_factor")
        return (f"E={self.shape['E']} d={self.shape['d']} T={self.T} {dt} "
                f"{self.policy}" + (f" cf={cf}" if cf is not None else ""))

    # -- work each function must do (data-dependent: this routing) --------
    def work(self, name: str):
        """(bytes, flops): each input read once, each output written once;
        the GEMMs read only the experts this routing uses and compute only
        the active blocks' rows."""
        s, T = self.shape, self.T
        E, k, d, f, M = s["E"], s["k"], s["d"], s["f"], self.sched.block_m
        es = self.x.element_size()
        cap = self.sched.capacity
        rows = self.n_active_blocks * M
        used = self.n_experts_used
        nb = cap // M
        if name == "router_topk":
            return router_work(T, E, k)
        if name == "permute":
            return T * d * es + cap * 4 + cap * d * es, 0
        if name == "fused_gate_up":
            return (rows * d * es + 2 * used * d * f * es + nb * 8
                    + cap * f * es, 2 * 2 * rows * d * f)
        if name == "grouped_gemm":
            return (rows * f * es + used * f * d * es + nb * 8 + cap * 4
                    + cap * d * es, 2 * rows * f * d)
        if name == "unpermute":
            return T * k * d * es + T * k * 4 + T * d * es, T * k * d
        raise KeyError(name)


def kernel_calls(c: Case):
    """name -> (kernel call, plain call, output numel, output dtype)."""
    import torch
    from repro_torch.kernels import ops, ref
    s, sched = c.shape, c.sched
    return {
        "router_topk": (
            lambda: ops.router_topk(c.logits, top_k=s["k"], **c.route_kw),
            lambda: ref.router_ref(c.logits, s["k"], **c.route_kw),
            c.T * s["k"], torch.float32),
        "permute": (lambda: ops.permute(c.x, sched),
                    lambda: ref.permute_ref(c.x, sched),
                    sched.capacity * s["d"], c.dtype),
        "fused_gate_up": (
            lambda: ops.fused_gate_up(c.xp, c.wg, c.wu, sched),
            lambda: ref.fused_gate_up_ref(c.xp, c.wg, c.wu, sched),
            sched.capacity * s["f"], c.dtype),
        "grouped_gemm": (
            lambda: ops.grouped_gemm(c.h, c.wd, sched, row_scale=c.scale),
            lambda: ref.grouped_gemm_ref(c.h, c.wd, sched, c.scale),
            sched.capacity * s["d"], c.dtype),
        "unpermute": (lambda: ops.unpermute(c.y, sched, None),
                      lambda: ref.unpermute_ref(c.y, sched, None),
                      c.T * s["d"], c.dtype),
    }


def grouped_mm_call(c: Case, x, w, want):
    """``torch._grouped_mm(x, w)`` over the schedule's row groups, checked
    against ``want`` (B1's output, which carries row_scale; None: not
    checked), or (None, reason).  Row groups in the schedule's packing
    order (group_offsets): expert order for fixed; decreasing load for
    dynamic, whose weights are put in that order once, outside the timed
    call."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent"
    offs = c.sched.group_offsets[1:].contiguous()
    note = "no row_scale epilogue"
    if c.policy == "dynamic":
        w = w[torch.argsort(-c.sched.counts, stable=True)].contiguous()
        note += "; weights permuted to the packing order outside it"

    def call():
        return torch._grouped_mm(x, w, offs=offs)
    try:
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"torch._grouped_mm refused: {str(e)[:80]}"
    n = int(c.sched.group_offsets[-1])   # the same products, scaled
    if want is not None:
        torch.testing.assert_close(out[:n].float() * c.scale[:n, None],
                                   want[:n].float(), **TOL["bfloat16"])
    return call, f"torch._grouped_mm ({note})"


def library_call(name: str, c: Case):
    """One PyTorch call computing the same function, or (None, reason)."""
    import torch
    if name == "unpermute":
        # scatter-add of the padded rows back to their tokens; padding rows
        # are zero, so clamping their -1 source to row 0 adds nothing
        src = torch.clamp(c.sched.src_tok, min=0).long()
        out = torch.zeros((c.T, c.shape["d"]), dtype=c.dtype, device="cuda")
        return (lambda: out.index_add_(0, src, c.y)), "index_add_"
    if name == "grouped_gemm" and c.dtype == torch.bfloat16:
        return grouped_mm_call(c, c.h, c.wd, c.y)
    reasons = {
        "router_topk": "no single PyTorch call gates, selects by iterative "
                       "argmax and renormalises",
        "permute": "no single PyTorch call gathers rows and zero-fills -1",
        "fused_gate_up": "no single PyTorch call fuses two grouped products "
                         "with a SiLU product",
        "grouped_gemm": "torch._grouped_mm absent or not bf16",
    }
    return None, reasons[name]


def check_case(c: Case, errs: dict) -> None:
    """Every kernel against its plain version on this case's inputs; the
    two GEMMs also bitwise equal across two calls (one fixed order of
    summation)."""
    import torch
    tol = TOL[str(c.dtype).replace("torch.", "")]
    for name, (kern, plain, numel, odt) in kernel_calls(c).items():
        got = poisoned(kern, numel, odt)
        want = plain()
        torch.cuda.synchronize()
        if name == "router_topk":
            (w, i), (w_p, i_p) = got, want
            if not torch.equal(i, i_p):
                raise AssertionError(f"router indices differ ({c.label()})")
            torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
            w2, i2 = kern()
            if not (torch.equal(w, w2) and torch.equal(i, i2)):
                raise AssertionError(f"router: two calls differ "
                                     f"({c.label()})")
            err = (w - w_p).abs().max().item()
        else:
            if torch.isnan(got).any():
                raise AssertionError(f"{name}: NaN in output ({c.label()})")
            if name in ("permute", "unpermute") \
                    and not torch.equal(got, want):
                raise AssertionError(f"{name} not bitwise ({c.label()})")
            if name == "unpermute":
                check_unpermute_weighted(c)
            if name in ("fused_gate_up", "grouped_gemm", "unpermute") \
                    and not torch.equal(got, kern()):
                raise AssertionError(f"{name}: two calls differ "
                                     f"({c.label()})")
            if name in ("permute", "fused_gate_up", "grouped_gemm"):
                for rows, what in ((c.inactive_rows, "inactive rows"),
                                   (c.tokenless_rows, "rows without a "
                                    "token")):
                    dead = got[rows]
                    if dead.numel() and not torch.equal(
                            dead, torch.zeros_like(dead)):
                        raise AssertionError(
                            f"{name}: {what} not zero ({c.label()})")
            torch.testing.assert_close(got.float(), want.float(), **tol)
            err = (got.float() - want.float()).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name:14s} {c.label():36s} max_abs_err {err:.3e}")


def check_unpermute_weighted(c: Case) -> None:
    """B4 with the combine weights not folded (the reference's unfolded
    path): bitwise the plain version, and across two calls."""
    import torch
    from repro_torch.kernels import unpermute as unperm
    got = unperm.unpermute(c.y, c.sched.pos, c.w)
    if not torch.equal(got, unperm.unpermute_plain(c.y, c.sched.pos, c.w)) \
            or not torch.equal(got, unperm.unpermute(c.y, c.sched.pos, c.w)):
        raise AssertionError(f"unpermute weighted not bitwise ({c.label()})")


def router_logits(T: int, E: int, k: int, seed: int, special: bool):
    """(T, E) fp32 logits on the card.  ``special``: the first rows are an
    all-equal row, a row whose k-th place is a tie of three, -inf on every
    third expert, -inf but for a quarter of the experts (tied at 1.0),
    coarse values with many ties, and the row of most candidates
    (``most_candidates``)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((max(T, 6), E), generator=g)
    if special:
        top = torch.randperm(E, generator=g)
        x[0] = 0.25
        x[1] = torch.randn(E, generator=g) * 0.1 - 5.0
        x[1, top[:k - 1]] = 3.0 + torch.arange(k - 1, dtype=torch.float32)
        x[1, top[k - 1:k + 2]] = 2.0
        x[2, 1::3] = float("-inf")
        x[3] = float("-inf")
        x[3, top[:max(1, E // 4)]] = 1.0
        x[4] = torch.round(x[4] * 2) / 2
        x[5] = most_candidates(1, E)[0]
    return x[:T].contiguous().cuda()


def most_candidates(T: int, E: int):
    """(T, E) logits ordered by (e % 32, e // 32): every key of the k - 1
    lanes that hold the largest is a candidate of B5's ranking, (k-1) *
    E/32 + 1 of them past 32 experts (about k + 1 on random rows)."""
    import torch
    e = torch.arange(E)
    return (3.0 - 0.1 * (e % 32) - 0.001 * (e // 32)).expand(T, -1) \
        .contiguous()


def check_router(arch: str, T: int, errs: dict) -> None:
    """B5 on rows of ties, equal scores, -inf and the most candidates
    against its plain version: indices equal, weights within 1e-5 / 1e-6,
    two calls bitwise equal."""
    import torch
    from repro_torch.kernels import ops, ref
    s = ROUTERS[arch]
    kw = dict(gating=s["gating"], norm_topk=s["norm_topk"],
              routed_scale=s["routed_scale"])
    logits = router_logits(T, s["E"], s["k"], seed=T, special=True)
    w, i = ops.router_topk(logits, top_k=s["k"], **kw)
    w_p, i_p = ref.router_ref(logits, s["k"], **kw)
    w2, i2 = ops.router_topk(logits, top_k=s["k"], **kw)
    torch.cuda.synchronize()
    if not torch.equal(i, i_p):
        raise AssertionError(f"router indices differ ({arch} T={T})")
    torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
    if not (torch.equal(w, w2) and torch.equal(i, i2)):
        raise AssertionError(f"router: two calls differ ({arch} T={T})")
    err = (w - w_p).abs().max().item()
    errs["router_topk"] = max(errs.get("router_topk", 0.0), err)
    print(f"  router_topk    {arch} E={s['E']} k={s['k']} T={T} ties, "
          f"equal rows, -inf: max_abs_err {err:.3e}")


def time_router(arch: str, T: int) -> dict:
    """B5 alone on random logits, beside its bound and its plain version;
    and on rows ordered so that every expert of the k lanes whose maxima
    lead is a candidate ((k-1) * E/32 + 1 of them past 32 experts, about
    k + 1 on random rows), the ranking's most work."""
    import torch
    from repro_torch.kernels import ops, ref
    s = ROUTERS[arch]
    kw = dict(gating=s["gating"], norm_topk=s["norm_topk"],
              routed_scale=s["routed_scale"])
    logits = router_logits(T, s["E"], s["k"], seed=1000 + T, special=False)
    worst = most_candidates(T, s["E"]).cuda()
    w, i = ops.router_topk(worst, top_k=s["k"], **kw)
    w_p, i_p = ref.router_ref(worst, s["k"], **kw)
    if not torch.equal(i, i_p):
        raise AssertionError(f"router indices differ on the most "
                             f"candidates ({arch} T={T})")
    torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)

    def kern():
        return ops.router_topk(logits, top_k=s["k"], **kw)
    n_bytes, flops = router_work(T, s["E"], s["k"])
    b_ms, b_by = bound_ms(n_bytes, flops)
    return {"ms": device_ms(kern, 50), "eager_ms": time_ms(kern, 250),
            "plain_ms": device_ms(lambda: ref.router_ref(
                logits, s["k"], **kw), 10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": None,
            "library_null_reason": "no single PyTorch call gates, selects "
                                   "by iterative argmax and renormalises",
            "most_candidates_ms": device_ms(lambda: ops.router_topk(
                worst, top_k=s["k"], **kw), 50),
            "bytes": n_bytes}


def time_launch_floor() -> dict:
    """The empty kernel (csrc/launch_floor.cu), timed as the kernels are:
    CUDA-graph replays, and eager calls through ctypes."""
    import torch
    from repro_torch.kernels import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    return {"ms": device_ms(lambda: _build.launch_floor(dev), 50),
            "eager_ms": time_ms(lambda: _build.launch_floor(dev), 250)}


def time_case(c: Case) -> dict:
    """Kernel, plain and library times with the bound, per kernel.  The
    plain GEMMs read ``block_active`` on the host (they compute the active
    blocks only), which a CUDA graph cannot capture: they are timed eagerly,
    where their milliseconds dwarf the host's per-call cost."""
    import torch
    out = {}
    for name, (kern, plain, _, _) in kernel_calls(c).items():
        gemm = name in ("fused_gate_up", "grouped_gemm")
        n = 10 if gemm else 50
        n_bytes, flops = c.work(name)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib, lib_name = library_call(name, c)
        out[name] = {
            "ms": device_ms(kern, n),
            "eager_ms": time_ms(kern, 5 * n),
            "plain_ms": (time_ms(plain, *PLAIN_ITERS[c.T >= 4096]) if gemm
                         else device_ms(plain, 10)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib, n) if lib is not None else None,
            "library": lib_name if lib is not None else None,
            "library_null_reason": None if lib is not None else lib_name,
            "bytes": n_bytes, "flops": flops,
        }
        torch.cuda.synchronize()
    return out


def padding_share(c: Case) -> dict:
    """Bytes the schedule makes permute / fused_gate_up / grouped_gemm
    write per layer-step and how many are padding rows; the rows the GEMMs
    compute (active blocks x block rows) and how many of them are
    padding."""
    s, es = c.shape, c.x.element_size()
    cap, useful = c.sched.capacity, c.T * s["k"]
    M = c.sched.block_m
    computed = c.n_active_blocks * M
    written = {"permute": cap * s["d"] * es, "fused_gate_up": cap * s["f"] * es,
               "grouped_gemm": cap * s["d"] * es}
    pad = {k: v * (cap - useful) / cap for k, v in written.items()}
    return {"E": s["E"], "T": c.T, "policy": c.policy, "block_m": M,
            "capacity": cap,
            "blocks": cap // M, "active_blocks": c.n_active_blocks,
            "computed_rows": computed,
            "computed_padding_share": (computed - useful) / computed,
            "written_MB": {k: v / 1e6 for k, v in written.items()},
            "padding_MB": {k: v / 1e6 for k, v in pad.items()},
            "padding_share": (cap - useful) / cap,
            "expert_weight_MB_read": c.n_experts_used * 3 * s["d"] * s["f"]
            * es / 1e6,
            "weights_read_by_blocks_MB": c.n_active_blocks * 3 * s["d"]
            * s["f"] * es / 1e6}


class QuantCase:
    """A ``Case``'s expert stacks quantized under ``scheme`` (payloads and
    scales on the card), and the gate+up output of its plain version on
    them, which feeds the down projection."""

    def __init__(self, c: Case, scheme: str):
        from repro_torch.kernels import ref
        from repro_torch.quantization import get_scheme
        sch = get_scheme(scheme)
        self.c, self.scheme, self.fmt = c, scheme, sch.kernel_format
        self.qg, self.qu, self.qd = (sch.quantize(w)
                                     for w in (c.wg, c.wu, c.wd))
        self.h = ref.fused_gate_up_ref(c.xp, self.qg, self.qu, c.sched)
        self.y = ref.grouped_gemm_ref(self.h, self.qd, c.sched, c.scale)

    def label(self) -> str:
        return f"{self.c.label()} {self.scheme}"

    def work(self, name: str):
        """(bytes, flops) as ``Case.work``, with the compressed weights: the
        payload and the scales of the experts this routing uses."""
        c = self.c
        s, es = c.shape, c.x.element_size()
        d, f, M = s["d"], s["f"], c.sched.block_m
        cap, nb, used = c.sched.capacity, c.sched.capacity // M, \
            c.n_experts_used
        rows = c.n_active_blocks * M

        def expert_bytes(qt):        # one expert's payload and scales
            return (qt.q[0].numel() * qt.q.element_size()
                    + qt.s[0].numel() * qt.s.element_size())
        if name == "fused_gate_up":
            return (rows * d * es + used * (expert_bytes(self.qg)
                                            + expert_bytes(self.qu))
                    + nb * 8 + cap * f * es, 2 * 2 * rows * d * f)
        if name == "grouped_gemm":
            return (rows * f * es + used * expert_bytes(self.qd) + nb * 8
                    + cap * 4 + cap * d * es, 2 * rows * f * d)
        raise KeyError(name)

    def calls(self):
        """name -> (kernel call, plain call, output numel, output dtype)."""
        from repro_torch.kernels import ops, ref
        c, sched = self.c, self.c.sched
        return {
            "fused_gate_up": (
                lambda: ops.fused_gate_up(c.xp, self.qg, self.qu, sched),
                lambda: ref.fused_gate_up_ref(c.xp, self.qg, self.qu, sched),
                sched.capacity * c.shape["f"], c.dtype),
            "grouped_gemm": (
                lambda: ops.grouped_gemm(self.h, self.qd, sched,
                                         row_scale=c.scale),
                lambda: ref.grouped_gemm_ref(self.h, self.qd, sched,
                                             c.scale),
                sched.capacity * c.shape["d"], c.dtype),
        }


def check_quant_case(qc: QuantCase, errs: dict) -> None:
    """The quantized GEMM kernels against their plain versions: no NaN after
    poisoning the allocator, inactive rows exactly zero, bitwise equal
    across two calls, within TOL."""
    import torch
    tol = TOL[str(qc.c.dtype).replace("torch.", "")]
    for name, (kern, plain, numel, odt) in qc.calls().items():
        got = poisoned(kern, numel, odt)
        want = plain()
        torch.cuda.synchronize()
        if torch.isnan(got).any():
            raise AssertionError(f"{name}: NaN in output ({qc.label()})")
        if not torch.equal(got, kern()):
            raise AssertionError(f"{name}: two calls differ ({qc.label()})")
        for rows in (qc.c.inactive_rows, qc.c.tokenless_rows):
            dead = got[rows]
            if dead.numel() and not torch.equal(dead,
                                                torch.zeros_like(dead)):
                raise AssertionError(f"{name}: inactive or tokenless rows "
                                     f"not zero ({qc.label()})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = (got.float() - want.float()).abs().max().item()
        key = f"{name}_{qc.fmt}"
        errs[key] = max(errs.get(key, 0.0), err)
        print(f"  {key:18s} {qc.label():49s} max_abs_err {err:.3e}")


def time_quant_case(qc: QuantCase) -> dict:
    """Kernel and plain times of the quantized GEMMs beside their
    compressed-byte bounds, as ``time_case`` does for the dense ones, and
    beside the dense bf16 kernel of the same GEMM on the case's bf16 stacks
    (the time the format has to beat), timed in turns with it.  No one
    PyTorch call takes the compressed weights (library_ms null);
    ``torch._grouped_mm`` over the dequantized bf16 stack (B1; B2's gate
    and up stacks side by side, two products without the SiLU) is timed
    beside them as the dense library time."""
    import torch
    c = qc.c
    dense = {name: calls[0] for name, calls in kernel_calls(c).items()}
    reason = ("no single PyTorch call computes a grouped product on "
              f"{qc.fmt} weights with per-channel dequantization "
              "(_weight_int8pack_mm is one matrix, not grouped)")
    out = {}
    for name, (kern, plain, _, _) in qc.calls().items():
        n_bytes, flops = qc.work(name)
        b_ms, b_by = bound_ms(n_bytes, flops)
        t = [device_ms(f, 10) for f in (kern, dense[name], dense[name],
                                        kern)]
        if name == "grouped_gemm":
            gmm, _ = grouped_mm_call(c, qc.h, qc.qd.materialize(), qc.y)
        else:
            wgu = torch.cat([qc.qg.materialize(), qc.qu.materialize()], -1)
            gmm, _ = grouped_mm_call(c, c.xp, wgu, None)
        out[name] = {
            "ms": (t[0] + t[3]) / 2, "eager_ms": time_ms(kern, 50),
            "dense_ms": (t[1] + t[2]) / 2, "turns_ms": t,
            "plain_ms": time_ms(plain, 5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library": None,
            "library_null_reason": reason,
            "grouped_mm_dequantized_ms":
                device_ms(gmm, 10) if gmm is not None else None,
            "bytes": n_bytes, "flops": flops}
        del gmm
        torch.cuda.synchronize()
    return out


# ------------------------------------------------------- backward kernels
class TrainCase:
    """One MoE layer's backward operands at a training shape (``T``
    tokens), in the schedule's padded layout (padding rows zero, as permute
    writes them), in one of the two orientations the layer's backward runs:

    * ``gate_up`` (dWg, dWu and their dX): x the routed rows (capacity, d),
      dy the gate's or up's gradient (capacity, f), W (E, d, f);
    * ``down``: x the activation h (capacity, f), B7's dy the output
      gradient times the combine scale of its row (capacity, d), W_down
      (E, f, d), and B1^T's input the unscaled output gradient.

    B7 takes (x, dy) -> dW (E, K, N) f32; B1 with the weight read transposed
    takes (dy, W) -> (capacity, K), the dX product."""

    def __init__(self, shape: dict, T: int, dtype, seed: int, policy: str,
                 orient: str = "gate_up", **policy_kw):
        import torch
        from repro_torch.kernels import ref
        from repro_torch.scheduling import build_schedule, combine_scale_rows
        g = torch.Generator(device="cuda").manual_seed(seed)
        E, d, f = shape["E"], shape["d"], shape["f"]
        self.shape, self.T, self.dtype, self.policy = shape, T, dtype, policy
        self.orient = orient
        self.K, self.N = (d, f) if orient == "gate_up" else (f, d)

        def randn(*s, scale=1.0):
            return (torch.randn(s, generator=g, device="cuda") * scale
                    ).to(dtype)
        logits = torch.randn((T, E), generator=g, device="cuda")
        wts, idx = ref.router_ref(logits, shape["k"], gating=shape["gating"],
                                  norm_topk=shape["norm_topk"],
                                  routed_scale=shape["routed_scale"])
        self.sched = build_schedule(idx, E, shape["M"], policy=policy,
                                    **policy_kw)
        self.policy_kw = policy_kw
        self.x = ref.permute_ref(randn(T, self.K), self.sched)
        self.dout = ref.permute_ref(randn(T, self.N), self.sched)
        if orient == "gate_up":
            self.dy = self.dout
        else:
            scale = combine_scale_rows(self.sched, wts)
            self.dy = (self.dout.float() * scale[:, None]).to(dtype)
        self.w = randn(E, self.K, self.N, scale=self.K ** -0.5)
        active = self.sched.block_active.bool().cpu()
        self.inactive_rows = (~active).repeat_interleave(
            self.sched.block_m).cuda()
        self.tokenless_rows = self.sched.src_tok < 0
        self.n_active_blocks = int(active.sum())
        self.empty_experts = (self.sched.counts == 0)
        self.n_experts_used = int((~self.empty_experts).sum())

    def label(self) -> str:
        dt = str(self.dtype).replace("torch.", "")
        cf = self.policy_kw.get("capacity_factor")
        return (f"E={self.shape['E']} K={self.K} N={self.N} T={self.T} {dt} "
                f"{self.policy}" + (f" cf={cf}" if cf is not None else "")
                + f" {self.orient}")

    def work(self, name: str):
        """(bytes, flops) of this routing: the active blocks' rows read
        once, B7's fp32 (E, K, N) written once, B1^T's used experts'
        weights read once and its whole (capacity, K) output written."""
        s, M = self.shape, self.sched.block_m
        E, K, N = s["E"], self.K, self.N
        es = self.x.element_size()
        cap = self.sched.capacity
        rows, nb = self.n_active_blocks * M, cap // M
        if name.startswith("grouped_wgrad"):
            out_es = 2 if name == "grouped_wgrad_bf16" else 4
            return (rows * (K + N) * es + E * K * N * out_es + nb * 8 + E * 4,
                    2 * rows * K * N)
        if name == "grouped_gemm_t":
            return (rows * N * es + self.n_experts_used * K * N * es + nb * 8
                    + cap * K * es, 2 * rows * K * N)
        raise KeyError(name)

    def calls(self):
        """name -> (kernel call, plain call, output numel, output dtype);
        ``grouped_wgrad_bf16`` is B7 writing bf16, as training runs it."""
        import torch
        from repro_torch.kernels import ops, ref
        E, cap = self.shape["E"], self.sched.capacity
        bf16 = torch.bfloat16
        return {
            "grouped_wgrad": (
                lambda: ops.grouped_wgrad(self.x, self.dy, self.sched, E),
                lambda: ref.grouped_wgrad_ref(self.x, self.dy, self.sched, E),
                E * self.K * self.N, torch.float32),
            "grouped_wgrad_bf16": (
                lambda: ops.grouped_wgrad(self.x, self.dy, self.sched, E,
                                          out_dtype=bf16),
                lambda: ref.grouped_wgrad_ref(self.x, self.dy, self.sched, E,
                                              out_dtype=bf16),
                E * self.K * self.N, bf16),
            "grouped_gemm_t": (
                lambda: ops.grouped_gemm_t(self.dout, self.w, self.sched),
                lambda: ref.grouped_gemm_t_ref(self.dout, self.w, self.sched),
                cap * self.K, self.dtype),
        }


def check_train_case(c: TrainCase, errs: dict) -> None:
    """B7 and B1^T against their plain versions: no NaN after poisoning the
    allocator; B7 exactly zero for experts with no tokens and within
    WGRAD_TOL with fp32 output (both sides sum exact products in fp32),
    within the bf16 TOL with bf16 output (both round that sum once); B1^T
    zero on inactive rows and within TOL; each bitwise equal across two
    calls (one fixed order of summation, no atomics)."""
    import torch
    for name, (kern, plain, numel, odt) in c.calls().items():
        got = poisoned(kern, numel, odt)
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        if torch.isnan(got).any():
            raise AssertionError(f"{name}: NaN in output ({c.label()})")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two calls differ ({c.label()})")
        del again
        wgrad = name.startswith("grouped_wgrad")
        for dead in ((got[c.empty_experts],) if wgrad else
                     (got[c.inactive_rows], got[c.tokenless_rows])):
            if dead.numel() and not torch.equal(dead,
                                                torch.zeros_like(dead)):
                raise AssertionError(f"{name}: rows with no tokens not zero "
                                     f"({c.label()})")
        tol = WGRAD_TOL if name == "grouped_wgrad" \
            else TOL[str(odt).replace("torch.", "")]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name:14s} {c.label():50s} max_abs_err {err:.3e} "
              f"(|max| {want.abs().max().item():.2f})")
        del got, want
        torch.cuda.empty_cache()


def train_library_call(name: str, c: TrainCase):
    """``torch._grouped_mm`` computing the same function, bf16, timed only
    (its groups follow the schedule's packing order; in ``dynamic`` that is
    decreasing load, and the weights are put in that order once, outside
    the timed call), or (None, reason)."""
    import torch
    if c.dtype != torch.bfloat16 or not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent or not bf16"
    offs = c.sched.group_offsets[1:].contiguous()
    if name.startswith("grouped_wgrad"):
        # 2-D x 2-D: x^T (d, capacity) and dy (capacity, f), split along
        # the rows by offs -> (E, d, f)
        xt = c.x.t()
        call = lambda: torch._grouped_mm(xt, c.dy, offs=offs)   # noqa: E731
        note = "2-D x 2-D, x^T a transposed view"
    else:
        w = c.w
        if c.policy == "dynamic":
            order = torch.argsort(-c.sched.counts, stable=True)
            w = c.w[order].contiguous()
        wt = w.transpose(1, 2)
        call = lambda: torch._grouped_mm(c.dout, wt, offs=offs)  # noqa: E731
        note = "2-D x 3-D, W^T a transposed view"
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"torch._grouped_mm refused: {str(e)[:120]}"
    return call, f"torch._grouped_mm ({note}; timed only)"


def time_train_case(c: TrainCase) -> dict:
    """Kernel (CUDA-graph replays), eager, plain and library times with the
    bound, per kernel.  The plain versions read ``block_active`` on the
    host and are timed eagerly."""
    import torch
    out = {}
    for name, (kern, plain, _, _) in c.calls().items():
        n_bytes, flops = c.work(name)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib, lib_name = train_library_call(name, c)
        out[name] = {
            "ms": device_ms(kern, 5), "eager_ms": time_ms(kern, 10),
            "plain_ms": time_ms(plain, *PLAIN_ITERS[True]), "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ops_ms": flops / BF16_FLOP_PER_S * 1e3,
            "library_ms": device_ms(lib, 5) if lib is not None else None,
            "library": lib_name if lib is not None else None,
            "library_null_reason": None if lib is not None else lib_name,
            "bytes": n_bytes, "flops": flops,
            "active_blocks": c.n_active_blocks,
            "block_m": c.sched.block_m}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def paper_shape(pc) -> dict:
    """One of the paper's four MoE layers (configs/paper.py) as a Case
    shape, with the dispatch defaults (no renormalisation, scale 1)."""
    return dict(E=pc.n_experts, k=pc.top_k, d=pc.d_model, f=pc.d_ffn, M=128,
                gating=pc.gating, norm_topk=False, routed_scale=1.0)


def check_capacity(errs: dict) -> dict:
    """[capacity]: the five kernels on ``capacity_factor`` schedules (every
    check of check_case, rows without a token exactly 0 after NaN
    poisoning among them: bucket tails, empty buckets, the sentinel block)
    at moonshot's T=2, 64, 4096, deepseek-v2's T=2, 64 and the four paper
    layers at T=512, headroom 1.25 and 0.5, bf16 and fp32; the int8 and
    int4 GEMMs at moonshot's T=2 and 64; B7 and B1^T at moonshot's T=4096
    (both orientations; timed in bf16).  Returns the drop fractions and
    the backward's times."""
    import torch
    from repro_torch.configs import PAPER_CONFIGS
    from repro_torch.scheduling import schedule_stats
    shapes = ([("moonshot", MOONSHOT, T) for T in (2, 64, 4096)]
              + [("deepseek", DEEPSEEK, T) for T in (2, 64)]
              + [(name, paper_shape(pc), 512)
                 for name, pc in sorted(PAPER_CONFIGS.items())])
    drops = []
    for arch, shape, T in shapes:
        for cf in CAPACITY_FACTORS:
            for dtype in (torch.bfloat16, torch.float32):
                c = Case(shape, T, dtype, seed=700 + T,
                         policy="capacity_factor", capacity_factor=cf)
                check_case(c, errs)
                if dtype == torch.bfloat16:
                    st = schedule_stats(c.sched)
                    drops.append({
                        "arch": arch, "T": T, "capacity_factor": cf,
                        "capacity": c.sched.capacity,
                        "bucket": int(c.sched.group_offsets[1]),
                        "drop_fraction": float(st.drop_fraction),
                        "active_blocks": c.n_active_blocks,
                        "rows_without_token": int(c.tokenless_rows.sum())})
                if arch == "moonshot" and T in (2, 64):
                    for scheme in REPORT_SCHEME.values():
                        qc = QuantCase(c, scheme)
                        check_quant_case(qc, errs)
                        del qc
                del c
                torch.cuda.empty_cache()
    for d in drops:
        print(f"[capacity] {d['arch']} T={d['T']} capacity_factor "
              f"{d['capacity_factor']}: bucket {d['bucket']} rows, capacity "
              f"{d['capacity']} rows ({d['active_blocks']} active blocks), "
              f"{d['rows_without_token']} rows without a token, "
              f"drop_fraction {d['drop_fraction']:.4f}")
    train_t = {}
    for orient in ("gate_up", "down"):
        for dtype in (torch.bfloat16, torch.float32):
            c = TrainCase(MOONSHOT, TRAIN_BATCH * TRAIN_SEQ, dtype, seed=500,
                          policy="capacity_factor", orient=orient,
                          capacity_factor=CAPACITY_FACTOR)
            check_train_case(c, errs)
            if dtype == torch.bfloat16:
                train_t[orient] = time_train_case(c)
            del c
            torch.cuda.empty_cache()
    return {"drops": drops, "train": train_t}


def time_capacity(shape: dict, T: int, seed: int) -> dict:
    """B2 and B1 (bf16) on ``capacity_factor`` (headroom CAPACITY_FACTOR)
    beside ``fixed`` and ``dynamic`` on the same routing and weights:
    device µs from CUDA-graph replays, in turns (capacity, fixed, dynamic,
    dynamic, fixed, capacity), each beside its own bound."""
    import torch
    cases = {p: Case(shape, T, torch.bfloat16, seed=seed, policy=p, **kw)
             for p, kw in (("capacity_factor",
                            {"capacity_factor": CAPACITY_FACTOR}),
                           ("fixed", {}), ("dynamic", {}))}
    order = ("capacity_factor", "fixed", "dynamic", "dynamic", "fixed",
             "capacity_factor")
    out = {}
    for name in ("fused_gate_up", "grouped_gemm"):
        calls = {p: kernel_calls(c)[name][0] for p, c in cases.items()}
        turns = {p: [] for p in cases}
        for p in order:
            turns[p].append(device_ms(calls[p], 10))
        out[name] = {}
        for p, c in cases.items():
            n_bytes, flops = c.work(name)
            b_ms, b_by = bound_ms(n_bytes, flops)
            out[name][p] = {"ms": sum(turns[p]) / len(turns[p]),
                            "turns_ms": turns[p], "bound_ms": b_ms,
                            "bound_by": b_by, "capacity": c.sched.capacity,
                            "active_blocks": c.n_active_blocks,
                            "block_m": c.sched.block_m}
        torch.cuda.synchronize()
    del cases
    torch.cuda.empty_cache()
    return out


class PagedCase:
    """Paged decode-attention inputs: ``slots`` slots of ``nb`` blocks in a
    pool of slots * nb blocks (tables a seeded permutation), and one query
    row per (slot, position) in ``rows``."""

    def __init__(self, attn: dict, rows, dtype, seed: int, nb: int = 8,
                 slots: int = 2):
        import torch
        g = torch.Generator(device="cuda").manual_seed(seed)
        Hkv, G, D, bs = attn["Hkv"], attn["G"], attn["D"], attn["bs"]
        self.attn, self.dtype, self.nb = attn, dtype, nb
        n_blocks = slots * nb
        self.k = torch.randn((n_blocks, bs, Hkv, D), generator=g,
                             device="cuda").to(dtype)
        self.v = torch.randn((n_blocks, bs, Hkv, D), generator=g,
                             device="cuda").to(dtype)
        perm = torch.randperm(n_blocks, generator=g, device="cuda")
        slot_tables = perm.reshape(slots, nb).to(torch.int32)
        slot_ids = torch.tensor([s for s, _ in rows], device="cuda")
        self.tables = slot_tables[slot_ids].contiguous()
        self.lim = torch.tensor([p for _, p in rows], dtype=torch.int32,
                                device="cuda")
        self.q = torch.randn((len(rows), Hkv, G, D), generator=g,
                             device="cuda").to(dtype)
        self.lims = [p for _, p in rows]

    def label(self) -> str:
        a = self.attn
        return (f"B={self.q.shape[0]} Hkv={a['Hkv']} G={a['G']} "
                f"{str(self.dtype).replace('torch.', '')}")

    def run(self, fn, lim=None, **kw):
        return fn(self.q, self.k, self.v, self.tables,
                  self.lim if lim is None else lim, **kw)

    def pools(self):
        return (self.k, self.v)

    def kv_positions_read(self) -> int:
        """Distinct pool positions the rows' tables reach up to each row's
        kv_limit: a block that several rows of one slot reach counts once,
        up to the furthest of their limits."""
        bs = self.attn["bs"]
        need: dict = {}
        for table, lim in zip(self.tables.cpu().tolist(), self.lims):
            for j in range(lim // bs + 1):
                need[table[j]] = max(need.get(table[j], 0),
                                     min(bs, lim + 1 - j * bs))
        return sum(need.values())

    def work(self):
        """(bytes, flops): the K and V positions the tables reach, each read
        once however many rows reach it; the table entries up to each
        kv_limit, the limits and q read once; out written once.  The scores
        and PV are per row, over each row's own positions."""
        a, es, bs = self.attn, self.q.element_size(), self.attn["bs"]
        B = self.q.shape[0]
        kv = self.kv_positions_read() * a["Hkv"] * 2 * a["D"] * es
        qo = 2 * B * a["Hkv"] * a["G"] * a["D"] * es
        meta = 4 * sum(p // bs + 2 for p in self.lims)
        row_positions = sum(p + 1 for p in self.lims)
        return kv + qo + meta, row_positions * a["Hkv"] * a["G"] * 4 * a["D"]


def paged_rows(kind: str):
    """(slot, position) rows: decode = one row per slot at positions 100
    and 77; verify = the speculative verify's SPEC_K + 1 rows a slot from
    those positions on; chunk = 2 slots x 32 prompt rows at positions
    32-63."""
    if kind == "decode":
        return [(0, 100), (1, 77)]
    if kind == "verify":
        return [(s, p + j) for s, p in ((0, 100), (1, 77))
                for j in range(SPEC_K + 1)]
    return [(s, p) for s in range(2) for p in range(32, 64)]


# the GQA kernel's held and timed shapes: name -> (attention, (slot,
# position) rows, table width nb, slots).  long: two rows of 8,192 and
# 6,144 positions in tables of 512 blocks; batched: 32 rows of 2,048
PAGED_SHAPES = {
    "decode": (ATTN, paged_rows("decode"), 8, 2),
    "chunk": (ATTN, paged_rows("chunk"), 8, 2),
    "long": (ATTN, [(0, 8191), (1, 6143)], 512, 2),
    "batched": (ATTN, [(s, 2047) for s in range(32)], 128, 32),
    "gqa_decode": (ATTN_GQA, paged_rows("decode"), 8, 2),
    "verify": (ATTN, paged_rows("verify"), 8, 2),
}
for _arch, _attn in DENSE_ATTN.items():
    for _kind in ("decode", "chunk"):
        PAGED_SHAPES[f"{_arch}_{_kind}"] = (dict(_attn, arch=_arch),
                                            paged_rows(_kind), 8, 2)
# the MLA kernel's held and timed shapes (deepseek-v2's absorbed decode),
# as PAGED_SHAPES: decode, the 64-row chunk step, long context (two rows of
# 8,192 and 6,144 positions, tables of 512 blocks) and batched (32 rows of
# 2,048, tables of 128)
MLA_SHAPES = {
    "decode": (MLA_ATTN, paged_rows("decode"), 8, 2),
    "chunk": (MLA_ATTN, paged_rows("chunk"), 8, 2),
    "long": (MLA_ATTN, [(0, 8191), (1, 6143)], 512, 2),
    "batched": (MLA_ATTN, [(s, 2047) for s in range(32)], 128, 32),
}
# decode over 64-position pool blocks (an engine's kv_block_size=64), held
# and timed beside MLA_SHAPES
MLA_DECODE_BS64 = (dict(MLA_ATTN, bs=64), paged_rows("decode"), 4, 2)


def check_attention(name: str, c, label: str, errs: dict, variants) -> None:
    """Kernel ``name`` (``paged_attention`` or ``paged_attention_mla``)
    against its plain version on case ``c``: each (label, kw) of
    ``variants``, each bitwise equal across two calls, then whole blocks
    past kv_limit poisoned (blocks 2 on: with the GQA kernel's plans they
    include later splits' ranges), with 1e4 against the plain version and
    with NaN against the kernel's own clean output, bitwise (the kernel
    never reads them)."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_plain as plain)

    def compare(tag, lim=None, **kw):
        got = poisoned(lambda: c.run(kern, lim, **kw), c.q.numel(), c.dtype)
        want = c.run(plain, lim, **kw)
        again = c.run(kern, lim, **kw)
        torch.cuda.synchronize()
        if torch.isnan(got).any():
            raise AssertionError(f"{name}: NaN ({label} {tag})")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two calls differ ({label} {tag})")
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[str(c.dtype).replace("torch.", "")])
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name} {label + ' ' + tag:50s} max_abs_err {err:.3e}")
        return got

    for tag, kw in variants:
        compare(tag, **kw)
    short = torch.full_like(c.lim, 2 * c.attn["bs"] - 1)
    clean = compare("blocks 0-1 only", lim=short)
    past = c.tables[:, 2:].reshape(-1).long()
    for pool in c.pools():
        pool[past] = 1e4
    compare("poisoned 1e4 past kv_limit", lim=short)
    for pool in c.pools():
        pool[past] = float("nan")
    got = c.run(kern, short)
    torch.cuda.synchronize()
    if not torch.equal(got, clean):
        raise AssertionError(f"{name}: blocks past kv_limit reach the output "
                             f"({label})")


def check_paged(errs: dict) -> None:
    """The GQA paged-attention kernel at each of PAGED_SHAPES (moonshot's
    decode, chunk, long-context and batched rows; mixtral's GQA decode; the
    dense family's decode and chunk rows), over its masks; the softcap
    variant at the model's own cap where it has one (gemma2's 50), else
    30."""
    import torch
    for dtype in (torch.bfloat16, torch.float32):
        for kind, (attn, rows, nb, slots) in PAGED_SHAPES.items():
            c = PagedCase(attn, rows, dtype, seed=7, nb=nb, slots=slots)
            qpos = torch.clamp(c.lim - 3, min=0)
            cap = attn.get("softcap", 30.0)
            check_attention("paged_attention", c, f"{c.label()} {kind}", errs,
                            (("", {}), ("scalar kv_limit", dict(lim=60)),
                             ("causal+window", dict(q_pos=qpos, causal=True,
                                                    window=40)),
                             (f"softcap {cap:g}", dict(logit_softcap=cap))))
            del c
            torch.cuda.empty_cache()


def time_paged(kind: str) -> dict:
    """Kernel, plain and SDPA-yardstick times of paged attention at
    PAGED_SHAPES[kind] (bf16).  The yardstick is
    scaled_dot_product_attention over a contiguous cache of each row's
    length (a boolean mask per row; ``enable_gqa`` for a group of several
    query heads): it excludes the gather that a paged cache would need
    first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_plain as plain,
        split_plan)
    attn, rows, nb, slots = PAGED_SHAPES[kind]
    c = PagedCase(attn, rows, torch.bfloat16, seed=11, nb=nb, slots=slots)
    B, Hkv, G, D = c.q.shape
    S = max(c.lims) + 1
    big = B * S > 4096                 # long rows: fewer calls a graph
    g = torch.Generator(device="cuda").manual_seed(12)
    qs = torch.randn((B, Hkv * G, 1, D), generator=g,
                     device="cuda").to(c.dtype)
    ks = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(c.dtype)
    vs = torch.randn((B, Hkv, S, D), generator=g, device="cuda").to(c.dtype)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= c.lim[:, None])[:, None, None, :]
    n_bytes, flops = c.work()
    b_ms, b_by = bound_ms(n_bytes, flops)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, per = split_plan(B, Hkv, nb, sms)
    out = {
        "ms": device_ms(lambda: c.run(kern), 20 if big else 50),
        "eager_ms": time_ms(lambda: c.run(kern), 50 if big else 200),
        "plain_ms": device_ms(lambda: c.run(plain), 3 if big else 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=G > 1),
            20 if big else 50),
        "library": "scaled_dot_product_attention over a contiguous cache of "
                   "each row's length (excludes the gather)"
                   + (", enable_gqa" if G > 1 else ""),
        "library_null_reason": None, "bytes": n_bytes, "flops": flops,
        "arch": attn["arch"], "rows": B, "Hkv": Hkv, "G": G, "D": D,
        "nb": nb, "kv_positions_read": c.kv_positions_read(),
        "row_kv_positions": sum(p + 1 for p in c.lims),
        "n_split": n_split, "per_split": per,
    }
    del c, qs, ks, vs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


class MLACase(PagedCase):
    """MLA paged decode inputs (deepseek-v2's absorbed decode): a latent pool
    (n_blocks, bs, 1, D) that is both key and value, a rope-key pool
    (n_blocks, bs, 1, D2), and per row q (1, G, D) and q2 (1, G, D2);
    tables and limits as ``PagedCase``."""

    def __init__(self, attn: dict, rows, dtype, seed: int, nb: int = 8,
                 slots: int = 2):
        import torch
        g = torch.Generator(device="cuda").manual_seed(seed)
        G, D, D2, bs = attn["G"], attn["D"], attn["D2"], attn["bs"]
        self.attn, self.dtype, self.nb = attn, dtype, nb
        n_blocks = slots * nb

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        self.k = randn(n_blocks, bs, 1, D)
        self.k2 = randn(n_blocks, bs, 1, D2)
        perm = torch.randperm(n_blocks, generator=g, device="cuda")
        slot_tables = perm.reshape(slots, nb).to(torch.int32)
        slot_ids = torch.tensor([s for s, _ in rows], device="cuda")
        self.tables = slot_tables[slot_ids].contiguous()
        self.lim = torch.tensor([p for _, p in rows], dtype=torch.int32,
                                device="cuda")
        self.lims = [p for _, p in rows]
        self.q = randn(len(rows), 1, G, D)
        self.q2 = randn(len(rows), 1, G, D2)
        self.scale = (D + D2) ** -0.5            # the model's (r + dr)^-0.5

    def label(self) -> str:
        return (f"B={self.q.shape[0]} G={self.attn['G']} "
                f"{str(self.dtype).replace('torch.', '')}")

    def run(self, fn, lim=None, **kw):
        return fn(self.q, self.k, self.k, self.tables,
                  self.lim if lim is None else lim, scale=self.scale,
                  q2=self.q2, k2_pool=self.k2, **kw)

    def pools(self):
        return (self.k, self.k2)

    def work(self):
        """(bytes, flops): the latent and rope-key positions the tables
        reach, each read once; q, q2 and the table entries read once; out
        written once.  Scores (D + D2) and PV (D) per row position and
        head, two operations per multiply-add."""
        a, es, bs = self.attn, self.q.element_size(), self.attn["bs"]
        B, G, D, D2 = self.q.shape[0], a["G"], a["D"], a["D2"]
        kv = self.kv_positions_read() * (D + D2) * es
        qo = B * G * (D + D2 + D) * es
        meta = 4 * sum(p // bs + 2 for p in self.lims)
        row_positions = sum(p + 1 for p in self.lims)
        return kv + qo + meta, row_positions * G * 2 * (D + D2 + D)


def check_mla(errs: dict) -> None:
    """The MLA kernels (bf16: the Hopper kernel; fp32: the CUDA-core one) at
    each of MLA_SHAPES, at decode with 120 heads (not a multiple of the
    64-head tile) and at decode over 64-position pool blocks (a pool block
    a tile; the fp32 kernel walks it in two chunks), vector and scalar
    kv_limit, blocks past kv_limit
    poisoned as in ``check_attention``, and the last row at kv_limit -1,
    which must come out as exact zeros."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_plain as plain)
    shapes = [(kind, attn, rows, nb, slots)
              for kind, (attn, rows, nb, slots) in MLA_SHAPES.items()]
    shapes.append(("decode", dict(MLA_ATTN, G=120), paged_rows("decode"), 8,
                   2))
    shapes.append(("decode bs64", *MLA_DECODE_BS64))
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).replace("torch.", "")]
        for kind, attn, rows, nb, slots in shapes:
            c = MLACase(attn, rows, dtype, seed=17 + attn["G"], nb=nb,
                        slots=slots)
            dead = c.lim.clone()
            dead[-1] = -1
            got, want = c.run(kern, dead), c.run(plain, dead)
            torch.cuda.synchronize()
            if not torch.equal(got[-1], torch.zeros_like(got[-1])):
                raise AssertionError(f"paged_attention_mla: a row at kv_limit"
                                     f" -1 is not zeros ({c.label()} {kind})")
            torch.testing.assert_close(got.float(), want.float(), **tol)
            check_attention("paged_attention_mla", c, f"{c.label()} {kind}",
                            errs, (("", {}),
                                   ("scalar kv_limit", dict(lim=60))))
            del c, got, want
            torch.cuda.empty_cache()


def mla_library_call(c: MLACase):
    """scaled_dot_product_attention over the contiguous concatenated view
    (q 576 = [q | q2], k 576 = [ckv | kr], v 512 = ckv, one KV head for the
    128 query heads through ``enable_gqa``, a boolean mask per row); the
    gather a paged cache needs first is excluded.  -> (call, name) or
    (None, reason)."""
    import torch
    import torch.nn.functional as F
    B, G = c.q.shape[0], c.attn["G"]
    S = max(c.lims) + 1
    g = torch.Generator(device="cuda").manual_seed(21)
    Dq = c.attn["D"] + c.attn["D2"]
    qs = torch.randn((B, G, 1, Dq), generator=g, device="cuda").to(c.dtype)
    ks = torch.randn((B, 1, S, Dq), generator=g, device="cuda").to(c.dtype)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= c.lim[:, None])[:, None, None, :]

    def call():
        return F.scaled_dot_product_attention(
            qs, ks, ks[..., :c.attn["D"]], attn_mask=mask, scale=c.scale,
            enable_gqa=True)
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"SDPA refused Dv != D with one KV head: {str(e)[:80]}"
    return call, ("scaled_dot_product_attention over a contiguous [ckv | kr] "
                  "view, one KV head (enable_gqa), excludes the gather")


def time_mla(kind: str, shape=None) -> dict:
    """Kernel, plain and SDPA-yardstick times of the MLA kernel at
    MLA_SHAPES[kind] or ``shape`` (bf16, deepseek's shape), with both
    halves of the bound and the kernel's split plan."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention as kern, paged_decode_attention_plain as plain,
        mla_split_plan)
    attn, rows, nb, slots = shape or MLA_SHAPES[kind]
    c = MLACase(attn, rows, torch.bfloat16, seed=19, nb=nb, slots=slots)
    B = c.q.shape[0]
    big = B * (max(c.lims) + 1) > 4096             # long rows: fewer calls
    n_bytes, flops = c.work()
    b_ms, b_by = bound_ms(n_bytes, flops)
    lib, lib_name = mla_library_call(c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, per = mla_split_plan(B, 1, attn["G"], nb, attn["bs"], attn["D"],
                                  attn["D2"], sms)
    out = {
        "ms": device_ms(lambda: c.run(kern), 20 if big else 50),
        "eager_ms": time_ms(lambda: c.run(kern), 50 if big else 200),
        "plain_ms": device_ms(lambda: c.run(plain), 3 if big else 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_ops_ms": flops / BF16_FLOP_PER_S * 1e3,
        "library_ms": (device_ms(lib, 20 if big else 50) if lib is not None
                       else None),
        "library": lib_name if lib is not None else None,
        "library_null_reason": None if lib is not None else lib_name,
        "bytes": n_bytes, "flops": flops, "rows": B, "nb": nb,
        "kv_positions_read": c.kv_positions_read(),
        "row_kv_positions": sum(p + 1 for p in c.lims),
        "n_split": n_split, "per_split": per,
    }
    del c, lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def register_plain_executor():
    """An executor made of the plain versions, for holding the served
    forward against them on the card (this script's own; the port's main
    path never routes to it)."""
    from repro_torch.execution import Executor, register_executor
    from repro_torch.kernels import ref

    class PlainExecutor(Executor):
        def prepare_weights(self, w, cfg):
            return w        # the plain GEMMs dequantize gathered blocks

        # route: the base Executor's, the plain router

        def permute(self, x, sched, cfg):
            return ref.permute_ref(x, sched)

        def expert_ffn(self, xp, w, sched, cfg, row_scale=None):
            h = ref.fused_gate_up_ref(xp, w["w_gate"], w["w_up"], sched)
            return ref.grouped_gemm_ref(h, w["w_down"], sched, row_scale)

        def unpermute(self, y, sched, weights, cfg):
            return ref.unpermute_ref(y, sched, weights)

    register_executor("plain")(PlainExecutor)


def truncated(model, n: int):
    """``model`` cut to its first ``n`` layers, sharing their weights."""
    import torch
    head = copy.copy(model)
    head._modules = dict(model._modules)          # not shared with model
    head.layers = torch.nn.ModuleList(model.layers[:n])
    return head


def first_step_logits(model, cfg, rc, prompts, capacity, paged_kw):
    """The first paged step of a fresh engine serving ``prompts[:slots]``
    (its prompt-chunk rows), run once with ``rc`` (the kernels and the
    fused read) and once with the plain executor and the gather read, each
    on its own copy of the pool.  Returns (logits, plain logits, rows)."""
    import torch
    from repro_torch.models.lm import forward
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                      rc=rc, **paged_kw)
    for i in range(SERVE_SLOTS):
        eng.admit(Request(rid=i, prompt=prompts[i], max_new=1))
    batch = eng.assemble()
    pools_p = [{k: t.clone() for k, t in layer.items()}
               for layer in eng.kv.pools]
    step_in = dict(mode="decode", pos=batch.pos, block_tables=batch.tables)
    logits, _, _ = forward(model, cfg, rc, {"tokens": batch.tokens},
                           cache=eng.kv.pools, **step_in)
    logits_p, _, _ = forward(model, cfg,
                             rc._replace(executor="plain",
                                         paged_attn="gather"),
                             {"tokens": batch.tokens}, cache=pools_p,
                             **step_in)
    torch.cuda.synchronize()
    return logits, logits_p, len(batch.rows)


def drive(engine, reqs) -> dict:
    """Serve ``reqs`` first-come first-served with the launch counters set
    to 0 just before and read just after; host-clock times of each
    admission and of each step (each step ends in its host transfer),
    split into steps that carried prompt rows and decode-only steps.

    For [analysis]'s bounds it also keeps, of each decode-only step, the
    positions each row attends over (host values) and, of a MoE model, the
    experts its router chose in each MoE layer: a wrapper around
    ``plan_dispatch`` keeps each plan's top-k indices (a reference to a
    device tensor: one Python call and one append a MoE layer, no device
    work, no host read), counted after the run."""
    import torch
    import repro_torch.core.dispatch as dispatch
    from repro_torch.kernels import ops
    pending = list(reqs)
    forwards0 = engine.n_forwards
    admit_s, prompt_steps, decode_steps = [], [], []
    decode_tokens = 0
    context, plans, step_plans = [], [], []
    plan_dispatch = dispatch.plan_dispatch

    def logged(*a, **kw):
        plan = plan_dispatch(*a, **kw)
        plans.append(plan.indices)
        return plan
    if engine.cfg.is_moe:
        dispatch.plan_dispatch = logged
    torch.cuda.synchronize()
    ops.reset_launches()
    t_run = time.perf_counter()
    try:
        while pending or engine.n_active:
            while pending and engine.n_active < engine.slots:
                t0 = time.perf_counter()
                engine.admit(pending.pop(0))
                admit_s.append(time.perf_counter() - t0)
            ctx = [len(r.prompt) + len(r.out) for r in engine.active
                   if r is not None]
            n_plans = len(plans)
            t0 = time.perf_counter()
            engine.step()
            dt = time.perf_counter() - t0
            n_decode, n_prompt = engine.last_step
            if n_prompt:
                prompt_steps.append(dt)
            else:
                decode_steps.append(dt)
                decode_tokens += n_decode
                context.append(ctx)
                step_plans.append(plans[n_plans:])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        dispatch.plan_dispatch = plan_dispatch
    # the distinct experts each decode step's router chose, over its layers
    routed = [sum(int(torch.unique(i).numel()) for i in step)
              for step in step_plans] if engine.cfg.is_moe else None
    return {"launches": dict(ops.LAUNCHES),
            "forwards": engine.n_forwards - forwards0,
            "run_s": run_s, "admit_s": admit_s,
            "prompt_steps": prompt_steps, "decode_steps": decode_steps,
            "decode_tokens": decode_tokens, "decode_context": context,
            "decode_routed_experts": routed}


def check_launches(launches: dict, moe: int, attn: int, fmt: str,
                   attn_kernel: str = "paged_attention") -> None:
    """The MoE kernels ran ``moe`` times each, the GEMMs in format ``fmt``
    only, the backward's kernels never, the paged-attention kernel
    ``attn_kernel`` (the GQA or the MLA one) ``attn`` times and the other
    one never."""
    from repro_torch.kernels._build import BACKWARD_KERNELS
    for name, n in launches.items():
        if name in ("paged_attention", "paged_attention_mla"):
            want = attn if name == attn_kernel else 0
        elif name in BACKWARD_KERNELS:
            want = 0                      # training's backward only
        elif name.startswith(("fused_gate_up", "grouped_gemm")):
            gemm_fmt = name.rsplit("_", 1)[1] if name.endswith(
                ("_int8", "_int4")) else "dense"
            want = moe if gemm_fmt == fmt else 0
        else:
            want = moe
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")


def check_requests(reqs, vocab: int, max_new: int = SERVE_MAX_NEW) -> None:
    for r in reqs:
        if not r.done or len(r.out) != max_new \
                or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"request {r.rid} incomplete: {r.out}")
        print(f"  req {r.rid}: {len(r.prompt)} prompt tokens -> {r.out}")


def serve_and_check(tag: str, engine, reqs, rng, fmt: str = "dense",
                    attn_kernel: str = "paged_attention") -> dict:
    """One warm-up request, then ``reqs`` through ``drive``; checks that the
    MoE kernels ran once per MoE layer per forward (their GEMMs in format
    ``fmt``), that on the paged engine ``attn_kernel`` ran once per layer
    per forward and the other attention kernel never, and that every
    request completed."""
    import numpy as np
    from repro_torch.models.lm import n_moe_layers
    from repro_torch.serve.engine import Request
    cfg, V = engine.cfg, engine.cfg.vocab_size
    engine.run([Request(rid=-1, prompt=rng.integers(0, V, 32).astype(
        np.int32), max_new=3)])
    res = drive(engine, reqs)
    n = res["forwards"]
    moe, attn = n_moe_layers(cfg) * n, (cfg.n_layers * n if engine.paged
                                        else 0)
    print(f"[{tag}] {n} forwards ({len(res['prompt_steps'])} with prompt "
          f"rows, {len(res['admit_s'])} admissions, "
          f"{len(res['decode_steps'])} decode-only) in {res['run_s']:.3f} s;"
          f" launches {json.dumps(res['launches'])}; expected {moe} per MoE "
          f"kernel ({fmt} GEMMs), {attn} {attn_kernel}, 0 of the other "
          f"attention kernel")
    check_launches(res["launches"], moe, attn, fmt, attn_kernel)
    check_requests(reqs, V)
    return res


def summarize(tag: str, res: dict, reqs, layers: int) -> dict:
    """Prefill cost per request (the contiguous engine's admission
    prefills; the paged engine's steps that carried prompt rows, which
    also decode the other slots), decode ms per decode-only step and
    decode tokens/s over those steps, and generated tokens/s over the
    whole run."""
    import numpy as np
    n = len(reqs)
    prefill_s = res["admit_s"] if not res["prompt_steps"] \
        else res["prompt_steps"]
    dec = res["decode_steps"]
    out = {"layers": layers, "slots": SERVE_SLOTS, "requests": n,
           "max_new": SERVE_MAX_NEW, "forwards": res["forwards"],
           "prefill_ms_per_request": 1e3 * sum(prefill_s) / n,
           "prompt_steps": len(res["prompt_steps"]),
           "prompt_step_ms": (1e3 * float(np.mean(res["prompt_steps"]))
                              if res["prompt_steps"] else None),
           "decode_ms_per_step": 1e3 * float(np.mean(dec)),
           "decode_ms_per_step_p50": 1e3 * float(np.median(dec)),
           "decode_steps": len(dec),
           "decode_context": res.get("decode_context"),
           "decode_routed_experts": res.get("decode_routed_experts"),
           "decode_tokens_per_s": res["decode_tokens"] / sum(dec),
           "generated_tokens_per_s": sum(len(r.out) for r in reqs)
           / res["run_s"]}
    print(f"[{tag}] prefill {out['prefill_ms_per_request']:.2f} ms per "
          f"request; decode {out['decode_ms_per_step']:.2f} ms per step "
          f"(mean of {len(dec)} decode-only steps, median "
          f"{out['decode_ms_per_step_p50']:.2f}, <= {SERVE_SLOTS} slots); "
          f"{out['decode_tokens_per_s']:.1f} decode tokens/s; "
          f"{out['generated_tokens_per_s']:.1f} generated tokens/s over the "
          f"run (host clock, each step ends in its host transfer)")
    return out


def print_profile(tag: str, prefill_label: str, prof: dict) -> None:
    for label, p in ((prefill_label, prof["prefill"]),
                     ("decode x5, 2 slots", prof["decode"])):
        print(f"[profile {tag}] {label}: wall {p['wall_ms']:.2f} ms, device "
              f"busy {p['device_ms']:.2f} ms (share {p['busy_share']:.3f})")
        for name, calls, ms in p["top_device"]:
            print(f"    device {ms:9.3f} ms {calls:5d}x  {name[:70]}")
        for name, calls, ms in p["top_cpu"]:
            print(f"    host   {ms:9.3f} ms {calls:5d}x  {name[:70]}")


class SteppedClock:
    """A clock that only its owner moves (the [serve obs] slo run)."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def drive_scheduled(engine, reqs) -> dict:
    """Serve ``reqs`` through ``enqueue`` and ``schedule`` (the engine's
    admission policy and its preemptions), with the launch counters set to
    0 just before and read just after; host-clock times of each step
    (each ends in its host transfer), split into steps that carried prompt
    rows and decode-only steps."""
    import torch
    from repro_torch.kernels import ops
    pending = engine.enqueue(list(reqs))
    forwards0 = engine.n_forwards
    prompt_steps, decode_steps = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    t_run = time.perf_counter()
    while pending or engine.n_active:
        engine.schedule(pending)
        t0 = time.perf_counter()
        engine.step()
        dt = time.perf_counter() - t0
        (prompt_steps if engine.last_step[1] else decode_steps).append(dt)
    torch.cuda.synchronize()
    return {"launches": dict(ops.LAUNCHES),
            "forwards": engine.n_forwards - forwards0,
            "run_s": time.perf_counter() - t_run,
            "prompt_steps": prompt_steps, "decode_steps": decode_steps}


def timed_admissions(engine) -> dict:
    """Wrap ``engine.admit`` (the scheduling pass calls it) so that each
    admission's host time, synchronised at both ends, is kept by rid."""
    import torch
    admit, times = engine.admit, {}

    def timed(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = admit(req)
        torch.cuda.synchronize()
        times.setdefault(req.rid, []).append(time.perf_counter() - t0)
        return ok
    engine.admit = timed
    return times


def serve_obs(cfg, model, prompts, capacity, paged_kw) -> dict:
    """[serve obs]: the paged engine's observability, admission policies
    and preemption on the served model (the engine's default ``dynamic``
    with ``moe_stats``), on the [serve paged] prompts (4 requests, 16 new
    tokens each, 2 slots, submitted together).

    (a) bf16: the memory bundle against ``NOOP``, and ``moe_stats`` on
    against off, each arm a fresh engine on the same requests (after one
    untimed NOOP run): greedy tokens bitwise equal and launches equal (and
    as ``check_launches`` expects); 5 decode steps of two fresh requests
    profiled in each (device activities and busy share).  The memory
    run's trace is saved under build/ and validated with the reference's
    span names; its counters and TTFT/TPOT/queue/E2E p50/p99 are printed.
    Then the decode step's cost of each arm: one engine, two requests
    decoding, the arm switched step by step in OBS_ROUNDS palindromic
    rounds (NOOP, memory, stats off, stats off, memory, NOOP), each step
    timed alone (host clock; each ends in its host transfer), so that a
    drift of the host's speed falls on every arm alike.
    (b) ``preempt(0)`` after 2 steps, paged (the table parks) and
    contiguous (the resume re-prefills prompt + out[:-1]): one preemption
    and one resumption, no parked table left.  In bf16 the resumed
    admission is timed and the tokens compared with the uninterrupted
    run's (printed, not required: see below); in fp32 (an fp32 copy of
    the first CHECK_LAYERS layers) the tokens must be bitwise the
    uninterrupted fp32 run's.  A preemption changes the rows the other
    requests' later steps share, and in bf16 cuBLAS's choice of algorithm
    by row count and the GQA kernel's split plan by batch round some
    logits differently, which can flip a greedy pick; in fp32 such
    differences sit far below the logits' gaps.
    (c) ``slo`` admission, fp32 copy, on a stepped clock moved by (a)'s
    median NOOP decode step after each step (``step_time_hint`` the same):
    request 0 (41-64 prompt tokens, two chunks) with a TTFT deadline of
    half a step is preempted before its second step when request 2
    arrives with a deadline it can meet (10 steps), and resumes last;
    every request completes with the uninterrupted fp32 run's tokens.
    (d) bf16: ``device_trace`` around two decode steps: the profiler's
    trace must name B1, B2 and the GQA kernel (B6)."""
    import numpy as np
    import torch
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.obs import (NOOP, Observability, device_trace,
                                 latency_summary, validate_chrome_trace)
    from repro_torch.serve.engine import Request, ServeEngine
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic",
                   moe_stats=True)
    moe_layers, V = n_moe_layers(cfg), cfg.vocab_size
    # the tails' two 16-token prompts (one chunk each)
    tail = np.random.default_rng(1).integers(0, V, (SERVE_SLOTS, 16)).astype(
        np.int32)

    def fresh(**kw):
        return [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW, **kw)
                for i, p in enumerate(prompts)]

    def decode_ready(engine, max_new=SERVE_MAX_NEW):
        """Admit the two tail prompts, run their chunk step and a first
        decode step."""
        for i in range(SERVE_SLOTS):
            engine.admit(Request(rid=100 + i, prompt=tail[i],
                                 max_new=max_new))
        for _ in range(2):
            engine.step()

    # (a) -----------------------------------------------------------------
    arms = {"noop": (NOOP, True), "memory": (None, True),
            "stats_off": (NOOP, False)}
    runs = {}
    for name in ("noop", "noop", "memory", "stats_off"):
        obs, stats = arms[name]
        obs = obs or Observability.memory()
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                             rc=rc._replace(moe_stats=stats), obs=obs,
                             **paged_kw)
        reqs = fresh()
        res = drive_scheduled(engine, reqs)
        check_launches(res["launches"], moe_layers * res["forwards"],
                       cfg.n_layers * res["forwards"], "dense")
        check_requests(reqs, V)
        counters = {(c["name"] + (json.dumps(c["labels"], sort_keys=True)
                                  if c["labels"] else "")): c["value"]
                    for c in obs.metrics.snapshot()["counters"]}
        decode_ready(engine)
        prof = profile_window(lambda: [engine.step() for _ in range(5)])
        set_plan_hook(None)
        runs[name] = {"res": res, "reqs": reqs, "obs": obs, "prof": prof,
                      "counters": counters}
        del engine
        torch.cuda.empty_cache()
    base = runs["noop"]
    tokens = [r.out for r in base["reqs"]]
    for name, run in runs.items():
        if [r.out for r in run["reqs"]] != tokens:
            raise AssertionError(f"[serve obs] {name}: tokens differ from "
                                 "the NOOP run's")
        if run["res"]["launches"] != base["res"]["launches"]:
            raise AssertionError(f"[serve obs] {name}: launches "
                                 f"{run['res']['launches']} differ from the "
                                 "NOOP run's")
    mem = runs["memory"]
    trace_path = ROOT / "build" / "serve_obs_trace.json"
    mem["obs"].tracer.save(trace_path)
    v = validate_chrome_trace(
        json.loads(trace_path.read_text()),
        required_names=("serve/admit", "serve/step", "serve/assemble",
                        "serve/forward", "serve/host_sync",
                        "serve/postprocess", "serve/retire",
                        "serve/prefix_probe", "recompile", "plan_trace"))
    counters = mem["counters"]
    if counters.get("serve/completed") != len(prompts) \
            or counters.get("serve/admitted") != len(prompts):
        raise AssertionError(f"[serve obs] counters {counters}")
    lat = latency_summary(mem["reqs"])
    sched = {k: x for k, x in mem["reqs"][0].stats.items()
             if k.startswith("sched/")}
    events = {name: run["prof"]["device_events"]
              for name, run in runs.items()}
    busy = {name: run["prof"]["busy_share"] for name, run in runs.items()}
    print(f"[serve obs] (a) memory bundle vs NOOP vs moe_stats off, fresh "
          f"engines: tokens bitwise equal, launches equal "
          f"({json.dumps(base['res']['launches'])}); over 5 decode steps, "
          f"device activities {json.dumps(events)}, busy share "
          f"{json.dumps({k: round(x, 3) for k, x in busy.items()})}; trace "
          f"{trace_path.relative_to(ROOT)}: {v['events']} events, "
          f"{len(v['names'])} names")
    print(f"[serve obs] counters {json.dumps(counters)}")
    print(f"[serve obs] request 0's plan stats (last step): "
          f"{json.dumps({k: round(x, 4) for k, x in sched.items()})}")
    for fam in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
        a = lat[fam]
        print(f"[serve obs] {fam}: p50 {a['p50'] * 1e3:.2f} ms, p99 "
              f"{a['p99'] * 1e3:.2f} ms, mean {a['mean'] * 1e3:.2f} ms "
              f"(n={a['n']}; 4 requests submitted together on "
              f"{SERVE_SLOTS} slots; host clock)")
    launches = base["res"]["launches"]
    del runs, mem, base
    torch.cuda.empty_cache()

    # the decode step's cost of each arm, switched step by step
    per_round = ("noop", "memory", "stats_off", "stats_off", "memory", "noop")
    n_steps = OBS_ROUNDS * len(per_round)
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                         capacity=len(tail[0]) + n_steps + 8, rc=rc,
                         **paged_kw)
    decode_ready(engine, max_new=n_steps + 4)
    mem_obs = Observability.memory()

    def use(name):
        obs = mem_obs if name == "memory" else NOOP
        engine.obs, engine._clock = obs, obs.clock
        engine.kv.bind_obs(obs.metrics, obs.tracer)
        set_plan_hook(obs.on_plan if obs.enabled else None)
        engine.rc = rc._replace(moe_stats=name != "stats_off")
    times = {name: [] for name in arms}
    for _ in range(OBS_ROUNDS):
        for name in per_round:
            use(name)
            t0 = time.perf_counter()
            rows = engine.step()
            times[name].append(1e3 * (time.perf_counter() - t0))
            if rows != SERVE_SLOTS:
                raise AssertionError(f"[serve obs] a timed step ran {rows} "
                                     f"rows, not {SERVE_SLOTS}")
    set_plan_hook(None)
    del engine
    torch.cuda.empty_cache()

    def paired(a, b):
        """Per round: the mean of a's two steps less b's."""
        return [float(np.mean(times[a][2 * i:2 * i + 2])
                      - np.mean(times[b][2 * i:2 * i + 2]))
                for i in range(OBS_ROUNDS)]
    med = {name: float(np.median(x)) for name, x in times.items()}
    q = {name: [float(np.percentile(x, 25)), float(np.percentile(x, 75))]
         for name, x in times.items()}
    d_obs, d_stats = paired("memory", "noop"), paired("noop", "stats_off")
    print(f"[serve obs] decode ms per step, {OBS_ROUNDS} rounds x "
          f"{per_round} on one engine (2 slots, host clock): median NOOP "
          f"{med['noop']:.3f} (quartiles {q['noop'][0]:.3f}-"
          f"{q['noop'][1]:.3f}), memory {med['memory']:.3f} "
          f"({q['memory'][0]:.3f}-{q['memory'][1]:.3f}), moe_stats off "
          f"{med['stats_off']:.3f} ({q['stats_off'][0]:.3f}-"
          f"{q['stats_off'][1]:.3f}); per round, memory - NOOP: median "
          f"{np.median(d_obs):+.3f} ms, {sum(d > 0 for d in d_obs)} of "
          f"{OBS_ROUNDS} rounds above 0; moe_stats on - off: median "
          f"{np.median(d_stats):+.3f} ms, {sum(d > 0 for d in d_stats)} of "
          f"{OBS_ROUNDS} above 0")
    out = {"decode_ms_median": med, "decode_ms_quartiles": q,
           "memory_minus_noop_ms": d_obs, "stats_on_minus_off_ms": d_stats,
           "latency": lat, "counters": counters,
           "launches": launches,
           "device_events_5_decode_steps": events,
           "busy_share_5_decode_steps": busy,
           "trace_events": v["events"]}
    step_s = med["noop"] / 1e3

    # (b) and (c) -------------------------------------------------------
    n_check = min(cfg.n_layers, CHECK_LAYERS)
    cfg32 = cfg.replace(n_layers=n_check)
    model32 = copy.deepcopy(truncated(model, n_check)).float()
    rc32 = rc._replace(compute_dtype=torch.float32)

    def uninterrupted(m, c, r, kw):
        engine = ServeEngine(c, m, slots=SERVE_SLOTS, capacity=capacity,
                             rc=r, **kw)
        reqs = fresh()
        drive_scheduled(engine, reqs)
        check_requests(reqs, V)
        return [x.out for x in reqs]

    def preempted(m, c, r, kw):
        engine = ServeEngine(c, m, slots=SERVE_SLOTS, capacity=capacity,
                             rc=r, **kw)
        admits = timed_admissions(engine)
        reqs = fresh()
        pending = engine.enqueue(reqs)
        engine.schedule(pending)
        for _ in range(2):
            engine.step()
        victim = engine.preempt(0)
        n_out = len(victim.out)
        parked = engine.kv.stats()["parked_tables"] if engine.paged else 0
        pending.append(victim)
        while pending or engine.n_active:
            engine.schedule(pending)
            engine.step()
        torch.cuda.synchronize()
        check_requests(reqs, V)
        left = engine.kv.stats()["parked_tables"] if engine.paged else 0
        if (engine.n_preempted, engine.n_resumed, parked, left) \
                != (1, 1, int(engine.paged), 0):
            raise AssertionError(
                f"[serve obs] (b) preempted {engine.n_preempted}, resumed "
                f"{engine.n_resumed}, parked {parked} then {left}")
        return ([x.out for x in reqs], victim, n_out,
                1e3 * admits[victim.rid][0], 1e3 * admits[victim.rid][1])

    ref32 = {}
    for kvb in (KV_BLOCK, 0):
        tag = "paged" if kvb else "contiguous"
        kw = dict(paged_kw) if kvb else dict(kv_block_size=0)
        want16 = tokens if kvb else uninterrupted(model, cfg, rc, kw)
        got16, victim, n_out, first_ms, resume_ms = preempted(
            model, cfg, rc, kw)
        differ = [i for i, (a, b) in enumerate(zip(got16, want16)) if a != b]
        ref32[kvb] = uninterrupted(model32, cfg32, rc32, kw)
        got32 = preempted(model32, cfg32, rc32, kw)[0]
        if got32 != ref32[kvb]:
            raise AssertionError(
                f"[serve obs] (b) {tag} fp32: the preempted run's tokens "
                f"differ from the uninterrupted run's: {got32} vs "
                f"{ref32[kvb]}")
        how = ("the parked table re-attached, nothing recomputed" if kvb
               else f"a prefill of prompt + out[:-1] = "
                    f"{len(victim.prompt) + n_out - 1} tokens")
        print(f"[serve obs] (b) {tag}: preempt(0) after 2 steps (request "
              f"{victim.rid}, {n_out} token(s) out), resumed: {how}; bf16 "
              f"admission {first_ms:.3f} ms, resumed admission "
              f"{resume_ms:.3f} ms (host clock, synchronised); bf16 tokens: "
              f"requests {differ or 'none'} differ from the uninterrupted "
              f"run's (other rows beside them after the preemption); fp32 "
              f"({n_check} layers): tokens bitwise the uninterrupted run's")
        out[f"preempt_{tag}"] = {"first_admit_ms": first_ms,
                                 "resume_admit_ms": resume_ms,
                                 "tokens_out_at_preempt": n_out,
                                 "bf16_requests_differing": differ}

    clock = SteppedClock()
    obs = Observability.memory(clock=clock)
    engine = ServeEngine(cfg32, model32, slots=SERVE_SLOTS,
                         capacity=capacity, rc=rc32, admission="slo",
                         obs=obs, **paged_kw)
    engine.step_time_hint = step_s
    if len(prompts[0]) <= PREFILL_CHUNK:
        raise AssertionError("request 0's prompt takes one chunk")
    deadline = {0: 0.5, 2: 10.0}             # in steps
    reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW,
                    slo_ttft=(deadline[i] * step_s if i in deadline
                              else None))
            for i, p in enumerate(prompts)]
    pending = engine.enqueue(reqs[:2])
    engine.schedule(pending)
    engine.step()
    clock.now += step_s
    pending += engine.enqueue(reqs[2:])
    while pending or engine.n_active:
        engine.schedule(pending)
        engine.step()
        clock.now += step_s
    set_plan_hook(None)
    check_requests(reqs, V)
    if engine.n_preempted < 1 or engine.n_resumed != engine.n_preempted:
        raise AssertionError(f"[serve obs] (c) preempted "
                             f"{engine.n_preempted}, resumed "
                             f"{engine.n_resumed}")
    if [r.out for r in reqs] != ref32[KV_BLOCK]:
        raise AssertionError("[serve obs] (c) the slo run's tokens differ "
                             "from the uninterrupted fp32 run's")
    order = [(e["name"].split("/")[1], e["args"]["rid"])
             for e in obs.tracer.events
             if e["name"] in ("serve/admit", "serve/preempt",
                              "serve/resume", "serve/retire")]
    kv = engine.kv.stats()
    print(f"[serve obs] (c) slo admission, fp32 ({n_check} layers), on a "
          f"stepped clock ({step_s * 1e3:.3f} ms a step, step_time_hint the "
          f"same): request 0's TTFT deadline 0.5 steps, request 2's 10; "
          f"{engine.n_preempted} preempted, {engine.n_resumed} resumed, "
          f"park reclaims {kv['park_reclaims']}; tokens the uninterrupted "
          f"run's; events {order}; TTFT misses "
          f"{obs.metrics.counter_value('serve/slo_ttft_miss'):.0f}")
    out["slo"] = {"preempted": engine.n_preempted,
                  "resumed": engine.n_resumed,
                  "park_reclaims": kv["park_reclaims"], "events": order}
    del engine, model32
    torch.cuda.empty_cache()

    # (d) -----------------------------------------------------------------
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc, **paged_kw)
    decode_ready(engine)
    engine.step()                        # the first decode step, untraced
    logdir = ROOT / "build" / "device_trace"
    with device_trace(str(logdir)) as prof:
        if prof is None:
            raise AssertionError("[serve obs] (d) the profiler did not start")
        for _ in range(2):
            engine.step()
    path = logdir / "device_trace.json"
    names = {e.get("name", "") for e in json.loads(
        path.read_text())["traceEvents"]
        if "kernel" in str(e.get("cat", "")).lower()}
    want = {"B1 grouped_gemm": ("fwd_hopper_kernel<false,",
                                "fwd_hopper_kernelILb0E"),
            "B2 fused_gate_up": ("fwd_hopper_kernel<true,",
                                 "fwd_hopper_kernelILb1E"),
            "B6 paged_attention": ("paged_attention_split_kernel",)}
    missing = [k for k, subs in want.items()
               if not any(sub in n for n in names for sub in subs)]
    if missing:
        raise AssertionError(f"[serve obs] (d) {path} names no kernel of "
                             f"{missing}; kernels: {sorted(names)}")
    print(f"[serve obs] (d) device_trace around 2 decode steps -> "
          f"{path.relative_to(ROOT)} ({path.stat().st_size} bytes, "
          f"{len(names)} kernel names; B1, B2 and B6 among them): "
          + "; ".join(sorted(n[:60] for n in names)))
    out["device_trace_kernels"] = sorted(names)
    del engine
    torch.cuda.empty_cache()
    return out


def check_threefry() -> dict:
    """Threefry on the card: the reference's literal words
    (THREEFRY_VECTORS) on the card and on the CPU, then a (4, 163840)
    batch of bits and uniforms under four row keys bitwise the CPU's."""
    import torch
    from repro_torch.sampling import row_key, threefry
    n = 163840
    for seed, ctr, role, key, bits, u in THREEFRY_VECTORS:
        for dev in ("cpu", "cuda"):
            k = row_key(torch.tensor(seed, device=dev),
                        torch.tensor(ctr, device=dev), role)
            b = threefry.random_bits(k, n)
            got = ((int(k[0]), int(k[1])),
                   tuple(int(b[i]) for i in (0, 1, 2, n - 1)),
                   float(threefry.uniform(k)))
            if got != (key, bits, u):
                raise AssertionError(f"threefry on {dev} at ({seed}, {ctr}, "
                                     f"{role}): {got}, the reference's "
                                     f"{(key, bits, u)}")
    seeds = torch.tensor([0, 7, -3, 2 ** 31 - 1])
    ctr = torch.tensor([0, 5, 70000, 12])
    for role in range(4):
        kc = row_key(seeds, ctr, role)
        kg = row_key(seeds.cuda(), ctr.cuda(), role)
        for fn in (threefry.random_bits, threefry.uniform):
            if not torch.equal(fn(kc, n), fn(kg, n).cpu()):
                raise AssertionError(f"{fn.__name__} role {role}: the card "
                                     "differs from the CPU")
    return {"literal_keys": len(THREEFRY_VECTORS), "batch_rows": 4,
            "values_per_row": n}


def serve_sample(cfg, model, model32, cfg32, prompts, capacity,
                 paged_kw) -> dict:
    """[serve sample]: the paged engine's keyed sampling on the served
    model and the [serve paged] traffic (4 requests, 16 new, 2 slots).

    (a) threefry on the card (``check_threefry``).  (b) Each method of
    SAMPLE_METHODS on a fresh engine (after a warm-up request): launches
    as greedy's (``check_launches``), every ``sample_rows`` call recorded
    (the step's logits, seeds, counters, role and tokens) and the tokens
    of the rows that emit one (decode rows, and each slot's last row: a
    prompt's final row; distinct requests carry distinct seeds, base +
    rid, so a seed names a slot) equal to ``sample_rows`` on the CPU over
    the same logits; some tokens differ from greedy's.  (c) fp32 (``model32``, the first CHECK_LAYERS
    layers): under top_p the 4 requests in a batch and each alone on an
    engine of its own sample the same tokens.  (d) decode ms per step of
    each method against greedy, one engine, two requests decoding, the
    method switched step by step in SAMPLE_ROUNDS palindromic rounds (host
    clock; each step ends in its host transfer); then 3 decode steps of
    each under the profiler: device activities a step."""
    import numpy as np
    import torch
    import repro_torch.serve.step as step_mod
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import n_moe_layers
    from repro_torch.sampling import SamplingConfig, sample_rows
    from repro_torch.serve.engine import Request, ServeEngine
    rc = served_rc()
    V, moe_layers = cfg.vocab_size, n_moe_layers(cfg)
    out = {"threefry": check_threefry()}
    print(f"[serve sample] (a) threefry: the reference's words at "
          f"{len(THREEFRY_VECTORS)} (seed, counter, role) keys equal on the "
          f"card and the CPU; bits and uniforms of 4 x 163840 bitwise the "
          f"CPU's")
    greedy = None
    for name, kw in (("greedy", {}), *SAMPLE_METHODS.items()):
        sampling = SamplingConfig(**kw)
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                             capacity=capacity, rc=rc, sampling=sampling,
                             **paged_kw)
        engine.run([Request(rid=-1, prompt=prompts[0][:16], max_new=3)])
        reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(prompts)]
        calls, real = [], step_mod.sample_rows

        def recording(logits, cfg_, seeds, counters, role=0):
            tok = real(logits, cfg_, seeds, counters, role=role)
            if cfg_.method != "greedy":           # greedy is the argmax
                calls.append((logits.detach().clone(), seeds.clone(),
                              counters.clone(), role, tok.clone()))
            return tok
        step_mod.sample_rows = recording
        try:
            res = drive(engine, reqs)
        finally:
            step_mod.sample_rows = real
            set_plan_hook(None)
        n = res["forwards"]
        check_launches(res["launches"], moe_layers * n, cfg.n_layers * n,
                       "dense")
        check_requests(reqs, V)
        toks = [r.out for r in reqs]
        rows = 0
        for logits, seeds, counters, role, tok in calls:
            # the rows whose token is emitted: decode rows (counter > 0)
            # and each slot's last row of the step (a prompt's final row;
            # a chunk row that is not final is drawn and discarded)
            seeds_l, ctr_l = seeds.tolist(), counters.tolist()
            last = {s_: i for i, s_ in enumerate(seeds_l)}
            keep = [i for i, c in enumerate(ctr_l)
                    if c > 0 or last[seeds_l[i]] == i]
            idx = torch.tensor(keep, device=logits.device)
            want = sample_rows(logits[idx].cpu(), sampling,
                               seeds[idx].cpu(), counters[idx].cpu(),
                               role=role)
            if not torch.equal(tok[idx].cpu(), want):
                raise AssertionError(f"[serve sample] {name}: a sampled "
                                     "token differs from sample_rows on the "
                                     "CPU")
            rows += len(keep)
        if name == "greedy":
            greedy = toks
            if calls:
                raise AssertionError("[serve sample] greedy drew a sample")
        elif toks == greedy:
            raise AssertionError(f"[serve sample] {name}: every token is "
                                 "greedy's")
        same = sum(a == b for x, y in zip(toks, greedy) for a, b in zip(x, y))
        out[name] = {"launches": res["launches"], "forwards": n,
                     "checked_steps": len(calls), "checked_rows": rows,
                     "tokens_equal_to_greedy": same}
        print(f"[serve sample] (b) {name} ({json.dumps(kw)}): {n} forwards, "
              f"launches {json.dumps(res['launches'])} (as greedy's: "
              f"{res['launches'] == out['greedy']['launches']}); "
              f"{len(calls)} sampled steps ({rows} emitting rows) equal to "
              f"sample_rows on the CPU over the same logits; {same} of "
              f"{sum(len(t) for t in toks)} tokens equal to greedy's")
        del engine, calls
        torch.cuda.empty_cache()

    # (c) batch independence in fp32
    sampling = SamplingConfig(**SAMPLE_METHODS["top_p"])
    rc32 = rc._replace(compute_dtype=torch.float32)

    def run32(ps, rids):
        eng = ServeEngine(cfg32, model32, slots=SERVE_SLOTS,
                          capacity=capacity, rc=rc32, sampling=sampling,
                          **paged_kw)
        reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in zip(rids, ps)]
        eng.run(reqs)
        set_plan_hook(None)
        return [r.out for r in reqs]
    batched = run32(prompts, range(len(prompts)))
    alone = [run32([p], [i])[0] for i, p in enumerate(prompts)]
    if alone != batched:
        raise AssertionError("[serve sample] (c) fp32 top_p: a request "
                             "alone samples other tokens than in the batch")
    out["fp32_alone_equals_batched"] = True
    print(f"[serve sample] (c) fp32 ({cfg32.n_layers} layers) top_p: "
          f"{len(prompts)} requests batched on {SERVE_SLOTS} slots and each "
          f"alone sample the same {sum(len(t) for t in batched)} tokens")

    # (d) decode ms per step in turns, then device activities a step
    arms = {"greedy": SamplingConfig(), **{
        n: SamplingConfig(**kw) for n, kw in SAMPLE_METHODS.items()}}
    per_round = ("greedy", "temperature", "top_k", "top_p", "top_p",
                 "top_k", "temperature", "greedy")
    n_steps = SAMPLE_ROUNDS * len(per_round) + 3 * len(arms) + 4
    tail = np.random.default_rng(2).integers(0, V, (SERVE_SLOTS, 16)).astype(
        np.int32)
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                         capacity=16 + n_steps + 8, rc=rc, **paged_kw)
    for i in range(SERVE_SLOTS):
        engine.admit(Request(rid=100 + i, prompt=tail[i], max_new=n_steps))
    for _ in range(2):
        engine.step()
    times = {name: [] for name in arms}
    for _ in range(SAMPLE_ROUNDS):
        for name in per_round:
            engine.sampling = arms[name]
            t0 = time.perf_counter()
            rows = engine.step()
            times[name].append(1e3 * (time.perf_counter() - t0))
            if rows != SERVE_SLOTS:
                raise AssertionError(f"[serve sample] a timed step ran "
                                     f"{rows} rows")
    events = {}
    for name in arms:
        engine.sampling = arms[name]
        prof = profile_window(lambda: [engine.step() for _ in range(3)])
        events[name] = prof["device_events"] / 3
    del engine
    torch.cuda.empty_cache()
    med = {n: float(np.median(x)) for n, x in times.items()}
    out["decode_ms_per_step_median"] = med
    out["decode_ms_per_step"] = times
    out["device_activities_per_step"] = events
    print(f"[serve sample] (d) decode ms per step, {SAMPLE_ROUNDS} rounds x "
          f"{per_round} on one engine (2 slots, host clock), median: "
          + ", ".join(f"{n} {m:.3f} ({m - med['greedy']:+.3f} against "
                      "greedy)" for n, m in med.items())
          + "; device activities a step (profiler, 3 steps): "
          + ", ".join(f"{n} {e:.0f} ({e - events['greedy']:+.0f})"
                      for n, e in events.items()))
    return out


def spec_guard(engine, rounds: list, launches: list) -> None:
    """From the engine's second speculative round on, run each round's
    device part (k draft steps, the verify forward) under
    ``set_sync_debug_mode("error")``; ``rounds`` counts the guarded rounds
    and ``launches`` keeps each round's launches of each kernel."""
    import torch
    from repro_torch.kernels import ops
    device_part = engine.spec_device

    def guarded(inp):
        if engine.n_spec_rounds == 0:
            return device_part(inp)
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = device_part(inp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches.append({k: v - before.get(k, 0)
                         for k, v in ops.LAUNCHES.items()
                         if v - before.get(k, 0)})
        rounds.append(1)
        return res
    engine.spec_device = guarded


def serve_spec(cfg, model, model32, cfg32, prompts, capacity,
               paged_kw) -> dict:
    """[serve spec]: speculative decoding (k = SPEC_K) on the served model
    with two drafts: smollm-360m at full width with moonshot's vocabulary
    (``make_draft_config``; random bf16 weights, seed 1) and the target
    itself.

    (a) bf16, in turns (plain, smollm, self, plain), each a fresh engine
    serving two 16-token prompts SPEC_RATE_NEW new tokens each: decode
    tokens/s from the step after both have a token to the end (host
    clock); the launches of the whole run (B6: layers x forwards of the
    target and of the draft; each MoE kernel: MoE layers x forwards of
    each); from the second round on each round's device part under
    ``spec_guard`` (no host sync) with its launches (one plan a MoE layer
    for the verify's VERIFY_ROWS rows); acceptance; the tokens against the
    plain engine's (printed: in bf16 a 10-row verify and a 2-row decode
    round some logits apart).  (b) fp32 (the first CHECK_LAYERS layers;
    the draft an fp32 copy): greedy speculative tokens bitwise the plain
    engine's for both drafts, 2 requests x SPEC_CHECK_NEW."""
    import numpy as np
    import torch
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import init_params, n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.spec import SpecEngine, make_draft_config
    rc = served_rc()
    V = cfg.vocab_size
    dcfg = make_draft_config(cfg)
    t0 = time.perf_counter()
    dmodel = init_params(dcfg, 1, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_dparams = sum(p.numel() for p in dmodel.parameters())
    print(f"[serve spec] draft {dcfg.name} at full width (d_model="
          f"{dcfg.d_model}, {dcfg.n_layers} layers, heads {dcfg.n_heads}/"
          f"{dcfg.n_kv_heads} of {dcfg.head_dim}) with {cfg.name}'s "
          f"vocabulary ({V}): {n_dparams / 1e9:.3f} B parameters, random "
          f"bf16, seed 1, initialised in {time.perf_counter() - t0:.1f} s; "
          f"k = {SPEC_K}")
    drafts = {"smollm": (dcfg, dmodel), "self": (cfg, model)}
    spec_capacity = capacity + SPEC_K + 1
    out = {"draft": {"name": dcfg.name, "layers": dcfg.n_layers,
                     "params": n_dparams}, "k": SPEC_K}

    def engine_for(draft, c=cfg, m=model, r=rc, cap=spec_capacity, **kw):
        if draft is None:
            return ServeEngine(c, m, slots=SERVE_SLOTS, capacity=cap,
                               rc=r, **paged_kw, **kw)
        dc, dm = draft
        return SpecEngine(c, m, draft_cfg=dc, draft_model=dm,
                          spec_k=SPEC_K, slots=SERVE_SLOTS, capacity=cap,
                          rc=r, **paged_kw, **kw)

    # (a) ------------------------------------------------------------------
    from repro_torch.kernels import ops
    tail = np.random.default_rng(3).integers(0, V, (SERVE_SLOTS, 16)).astype(
        np.int32)

    def turn(name):
        draft = drafts.get(name.replace("_again", ""))
        engine = engine_for(draft, cap=16 + SPEC_RATE_NEW + SPEC_K + 2)
        rounds, per_round = [], []
        if draft is not None:
            spec_guard(engine, rounds, per_round)
        reqs = [Request(rid=i, prompt=tail[i], max_new=SPEC_RATE_NEW)
                for i in range(SERVE_SLOTS)]
        torch.cuda.synchronize()
        ops.reset_launches()
        for r in reqs:
            engine.admit(r)
        while not all(r.out for r in reqs):
            engine.step()
        torch.cuda.synchronize()
        n0, t_start = sum(len(r.out) for r in reqs), time.perf_counter()
        steps = 0
        while engine.n_active:
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t_start
        set_plan_hook(None)
        launches = dict(ops.LAUNCHES)
        check_requests(reqs, V, SPEC_RATE_NEW)
        n = engine.n_forwards
        nd = getattr(engine, "n_draft_forwards", 0)
        dc = draft[0] if draft else cfg
        moe = n_moe_layers(cfg) * n + n_moe_layers(dc) * nd
        attn = cfg.n_layers * n + dc.n_layers * nd
        check_launches(launches, moe, attn, "dense")
        n_tok = sum(len(r.out) for r in reqs) - n0
        res = {"tokens": n_tok, "s": dt, "steps": steps,
               "tokens_per_s": n_tok / dt, "forwards": n,
               "draft_forwards": nd, "launches": launches,
               "out": [r.out for r in reqs]}
        if draft is None:
            return res
        if len(rounds) < 2:
            raise AssertionError(f"[serve spec] {name}: {len(rounds)} "
                                 "guarded rounds")
        want = {"paged_attention": cfg.n_layers + SPEC_K * dc.n_layers}
        for k in MOE_KERNELS:
            m_k = n_moe_layers(cfg) + SPEC_K * n_moe_layers(dc)
            if m_k:
                want[k] = m_k
        for got in per_round:
            if got != want:
                raise AssertionError(f"[serve spec] {name}: a round "
                                     f"launched {got}, expected {want}")
        res.update({"rounds": engine.n_spec_rounds,
                    "acceptance_rate": engine.acceptance_rate,
                    "accepted": engine.n_accepted,
                    "drafted": engine.n_drafted,
                    "launches_per_round": per_round[0],
                    "guarded_rounds": len(rounds)})
        return res

    turns = {name: turn(name)
             for name in ("plain", "smollm", "self", "plain_again")}
    plain_tok = turns["plain"]["out"]
    for name, r in turns.items():
        same = sum(a == b for x, y in zip(r.pop("out"), plain_tok)
                   for a, b in zip(x, y))
        r["tokens_equal_to_plain"] = same
        head = (f"[serve spec] (a) {name}: {r['tokens_per_s']:.1f} decode "
                f"tokens/s ({r['tokens']} tokens in {r['steps']} steps, "
                f"{r['s']:.3f} s); {r['forwards']} target + "
                f"{r['draft_forwards']} draft forwards, launches "
                f"{json.dumps({k: v for k, v in r['launches'].items() if v})}")
        if "rounds" in r:
            head += (f"; {r['rounds']} rounds, acceptance "
                     f"{r['acceptance_rate']:.4f} ({r['accepted']}/"
                     f"{r['drafted']}); a round launches "
                     f"{json.dumps(r['launches_per_round'])}: the verify's "
                     f"{VERIFY_ROWS} rows in one plan a MoE layer; "
                     f"{r['guarded_rounds']} rounds' draft steps and verify "
                     f"forward under set_sync_debug_mode('error'); {same} of "
                     f"{SERVE_SLOTS * SPEC_RATE_NEW} bf16 tokens equal to the "
                     "plain engine's")
        print(head)
    plain_rate = 0.5 * (turns["plain"]["tokens_per_s"]
                        + turns["plain_again"]["tokens_per_s"])
    out.update(turns)
    out["speedup"] = {d: turns[d]["tokens_per_s"] / plain_rate
                      for d in ("smollm", "self")}
    print(f"[serve spec] (a) decode tokens/s, speculative / plain (the mean "
          f"of the two plain turns, {plain_rate:.1f}): smollm "
          f"{out['speedup']['smollm']:.3f}, self "
          f"{out['speedup']['self']:.3f}")

    # (b) fp32 identity -------------------------------------------------------
    dmodel32 = copy.deepcopy(dmodel).float()
    rc32 = rc._replace(compute_dtype=torch.float32)
    fp32 = {}
    for name, draft in (("plain", None), ("smollm", (dcfg, dmodel32)),
                        ("self", (cfg32, model32))):
        engine = engine_for(draft, c=cfg32, m=model32, r=rc32)
        reqs = [Request(rid=i, prompt=p, max_new=SPEC_CHECK_NEW)
                for i, p in enumerate(prompts[:SERVE_SLOTS])]
        engine.run(reqs)
        set_plan_hook(None)
        fp32[name] = [r.out for r in reqs]
        if name != "plain":
            if fp32[name] != fp32["plain"]:
                raise AssertionError(f"[serve spec] (b) fp32 {name}: greedy "
                                     "speculative tokens differ from the "
                                     "plain engine's")
            fp32[f"{name}_acceptance"] = engine.acceptance_rate
        del engine
    del dmodel32
    torch.cuda.empty_cache()
    out["fp32"] = {"layers": cfg32.n_layers, "identical": True,
                   "acceptance": {k: fp32[f"{k}_acceptance"]
                                  for k in ("smollm", "self")}}
    print(f"[serve spec] (b) fp32 ({cfg32.n_layers} layers), "
          f"{SERVE_SLOTS} requests x {SPEC_CHECK_NEW} new: greedy tokens of "
          f"both drafts bitwise the plain engine's (acceptance smollm "
          f"{fp32['smollm_acceptance']:.4f}, self "
          f"{fp32['self_acceptance']:.4f})")
    del drafts, dmodel
    torch.cuda.empty_cache()
    return out


def serve_loadgen(cfg, model, paged_kw) -> dict:
    """[serve loadgen]: seeded ``poisson`` and ``burst`` traces
    (``synth_trace``, seed 0, LOADGEN_REQUESTS requests at LOADGEN_RATE
    req/s of virtual time, prompts of 4-40 tokens, SERVE_MAX_NEW new, a
    TTFT SLO of 0.4 s, bursts of 6: the reference launcher's trace)
    replayed through ``ServingFrontend`` on a fresh paged engine with the
    memory bundle on a virtual clock moved by the measured step EWMA
    (``step_time=None``).  Launches as ``check_launches`` expects; every
    request completes; the streamed tokens equal each request's."""
    import torch
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import n_moe_layers
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import (make_virtual_obs, replay,
                                           synth_trace)
    from repro_torch.kernels import ops
    rc = served_rc()
    out = {}
    for pattern in ("poisson", "burst"):
        trace = synth_trace(pattern, seed=0, n=LOADGEN_REQUESTS,
                            rate=LOADGEN_RATE, vocab=cfg.vocab_size,
                            max_new=SERVE_MAX_NEW, slo_ttft=0.4,
                            burst_size=6, prompt_hi=40)
        clock, obs = make_virtual_obs(enabled=True)
        cap = max(len(e.prompt) for e in trace) + SERVE_MAX_NEW + 1
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=cap,
                             rc=rc, obs=obs, **paged_kw)
        streamed = {}
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        rec = replay(engine, trace, clock=clock, step_time=None, seed=0,
                     pattern=pattern, on_token=lambda r, t: streamed.setdefault(
                         r.rid, []).append(t))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        set_plan_hook(None)
        n = engine.n_forwards
        check_launches(dict(ops.LAUNCHES), n_moe_layers(cfg) * n,
                       cfg.n_layers * n, "dense")
        if rec["completed"] != LOADGEN_REQUESTS:
            raise AssertionError(f"[serve loadgen] {pattern}: "
                                 f"{rec['completed']} of {LOADGEN_REQUESTS} "
                                 "completed")
        if streamed != rec["outputs"] or not all(
                len(t) == SERVE_MAX_NEW for t in streamed.values()):
            raise AssertionError(f"[serve loadgen] {pattern}: the streamed "
                                 "tokens differ from the requests'")
        ewma = rec["config"]["step_calibration"]["measured_step_ewma_s"]
        rec.pop("outputs")
        out[pattern] = {**rec, "wall_s": wall, "forwards": n}
        print(f"[serve loadgen] {pattern}: {rec['completed']}/"
              f"{rec['offered']} completed in {rec['steps']} steps "
              f"({n} forwards, wall {wall:.3f} s); virtual makespan "
              f"{rec['makespan_s']:.3f} s; TTFT p50 "
              f"{rec['ttft_p50_s'] * 1e3:.2f} ms, p99 "
              f"{rec['ttft_p99_s'] * 1e3:.2f} ms; TPOT p50 "
              f"{rec['tpot_p50_s'] * 1e3:.2f} ms, p99 "
              f"{rec['tpot_p99_s'] * 1e3:.2f} ms; goodput "
              f"{rec['goodput_rps']:.3f} req/s (SLO TTFT 0.4 s: "
              f"{rec['slo_good']} met, attainment "
              f"{rec['slo_attainment']:.3f}); throughput "
              f"{rec['throughput_rps']:.3f} req/s; calibrated step EWMA "
              f"{ewma * 1e3:.3f} ms; streamed tokens equal every request's")
        del engine
        torch.cuda.empty_cache()
    return out


def check_overlap_launches(launches: dict, moe: int, attn: int) -> None:
    """The pipelined EP dispatch: each microbatch of a MoE layer runs B5,
    B3, B2, B1 and B4 once, so the five counts are equal and at least
    ``moe``; the GQA kernel ran ``attn`` times."""
    runs = {launches[k] for k in MOE_KERNELS}
    if len(runs) != 1 or min(runs) < moe \
            or launches["paged_attention"] != attn:
        raise AssertionError(f"[ep] overlap2 launches {launches}")


def ep_workload(cfg, model, spec: dict, ep: bool) -> dict:
    """[ep]'s runs on ``model`` (bf16; with ``ep`` this rank's experts,
    under the current EP group; else whole): greedy tokens of [serve
    paged]'s requests on fp32 copies (each of EP_ARMS, or one single-rank
    arm), the capacity_factor drop run, an int8_expert run, decode ms per
    step in bf16 (EP_TIMED_ARMS), and one MoE layer in bf16 at EP_LAYER_TS
    in each layout.  Launches as ``drive`` reads them.  Returns numpy and
    Python values only (a rank's result is pickled)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.distributed import apply_moe_ep
    from repro_torch.core.moe_layer import apply_moe, dispatch_config
    from repro_torch.execution import set_plan_hook
    from repro_torch.models.lm import RunConfig
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import Request, ServeEngine
    f32, bf16 = torch.float32, torch.bfloat16
    paged_kw, cap = spec["paged_kw"], spec["capacity"]
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]

    def requests():
        return [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(prompts)]

    def served(eng, reqs, res):
        if not all(r.done and len(r.out) == r.max_new for r in reqs):
            raise AssertionError(f"[ep] requests incomplete: "
                                 f"{[r.out for r in reqs]}")
        return {"tokens": [list(r.out) for r in reqs],
                "launches": res["launches"], "forwards": res["forwards"]}

    out = {"fp32": {}, "decode": {}, "layer": {}}
    dev = model.embed.device
    paged_kw = {**paged_kw, "device": dev}
    model32 = copy.deepcopy(model).float()
    for arm, kw in (EP_ARMS if ep else {"single": {}}).items():
        rc = RunConfig(compute_dtype=f32, schedule_policy="dynamic", ep=ep,
                       **kw)
        eng = ServeEngine(cfg, model32, slots=SERVE_SLOTS, capacity=cap,
                          rc=rc, **paged_kw)
        reqs = requests()
        out["fp32"][arm] = served(eng, reqs, drive(eng, reqs))
        del eng
    # capacity_factor: each request's last-step drops and the EP counter
    cfg_d = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                block_m=EP_DROP_BLOCK_M))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new=m) for i, (n, m) in enumerate(EP_DROP_REQUESTS)]
    obs = Observability.memory()
    eng = ServeEngine(
        cfg_d, model32, slots=SERVE_SLOTS,
        capacity=max(n + m for n, m in EP_DROP_REQUESTS) + 1,
        rc=RunConfig(compute_dtype=f32, schedule_policy="capacity_factor",
                     capacity_factor=EP_CF, moe_stats=True, ep=ep),
        obs=obs, kv_block_size=KV_BLOCK, prefill_chunk=EP_DROP_CHUNK,
        device=dev)
    eng.run(reqs)
    set_plan_hook(None)
    counters = {c["name"]: c["value"]
                for c in obs.metrics.snapshot()["counters"]}
    out["drops"] = {"tokens": [list(r.out) for r in reqs],
                    "dropped_rows": [r.stats["sched/dropped_rows"]
                                     for r in reqs],
                    "ep_dropped_tokens": counters.get(
                        "serve/ep_dropped_tokens")}
    del eng
    # int8_expert experts, quantized by the engine at load
    model_q = copy.deepcopy(model32)
    del model32
    eng = ServeEngine(cfg, model_q, slots=SERVE_SLOTS, capacity=cap,
                      rc=RunConfig(compute_dtype=f32,
                                   schedule_policy="dynamic",
                                   quant="int8_expert", ep=ep), **paged_kw)
    reqs = requests()
    out["int8"] = served(eng, reqs, drive(eng, reqs))
    del eng, model_q
    torch.cuda.empty_cache()
    if ep:
        out["collective_ms"] = time_collectives(cfg.d_model, dev)
    # decode ms per step, bf16, after one warm-up request
    for arm in (EP_TIMED_ARMS if ep else ("single",)):
        rc = RunConfig(compute_dtype=bf16, schedule_policy="dynamic", ep=ep,
                       **EP_ARMS.get(arm, {}))
        eng = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=cap,
                          rc=rc, **paged_kw)
        eng.run([Request(rid=-1, prompt=prompts[0][:32], max_new=3)])
        reqs = requests()
        res = drive(eng, reqs)
        dec = res["decode_steps"]
        out["decode"][arm] = {
            **served(eng, reqs, res), "decode_steps": len(dec),
            "decode_ms_per_step": 1e3 * float(np.mean(dec)),
            "decode_ms_per_step_p50": 1e3 * float(np.median(dec))}
        del eng
    # one MoE layer in bf16, the served policy, decode rows (T, 1, d)
    layer = next(b for b in model.layers if b.kind == "moe").moe.params()
    dcfg = dispatch_config(cfg.moe, executor="cuda",
                           schedule_policy="dynamic")
    with torch.no_grad():
        for T in EP_LAYER_TS:
            x = torch.from_numpy(np.random.default_rng(T).standard_normal(
                (T, 1, cfg.d_model)).astype(np.float32)).to(dev, bf16)
            arms = EP_LAYER_LAYOUTS if ep else {"single": 0}
            for lay, ov in arms.items():
                y, _ = (apply_moe_ep(layer, x, dcfg, overlap=ov,
                                     token_layout=lay.replace("overlap2",
                                                              "sharded"))
                        if ep else apply_moe(layer, x, dcfg))
                out["layer"][f"T{T}/{lay}"] = y.float().cpu().numpy()
    torch.cuda.synchronize()
    return out


def time_collectives(d: int, dev) -> dict:
    """Host ms per collective of the current EP group at a decode step's
    shapes, nothing else running: the output all_reduce of
    ``replicated`` ((SERVE_SLOTS, d) fp32), a ``sharded`` payload
    all_to_all ((ep, 8, d) bf16) and its all_gather ((SERVE_SLOTS / ep, 1,
    d) bf16); the mean of EP_COLLECTIVE_ITERS after 3 warm-up calls, each
    run ending in a synchronize."""
    import torch
    from repro_torch.distributed import current_ep_group
    g = current_ep_group()
    probes = {"all_reduce": (g.all_reduce, torch.ones(
                  (SERVE_SLOTS, d), dtype=torch.float32, device=dev)),
              "all_to_all": (g.all_to_all, torch.ones(
                  (g.size, 8, d), dtype=torch.bfloat16, device=dev)),
              "all_gather": (g.all_gather, torch.ones(
                  (SERVE_SLOTS // g.size, 1, d), dtype=torch.bfloat16,
                  device=dev))}
    out = {}
    for name, (fn, t) in probes.items():
        for _ in range(3):
            fn(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EP_COLLECTIVE_ITERS):
            fn(t)
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / EP_COLLECTIVE_ITERS
    return out


def moe_layer_fp32(model) -> dict:
    """fp32 copies of the first MoE layer's parameters, ``shared`` flat as
    ``shared.<leaf>``."""
    moe = next(b for b in model.layers if b.kind == "moe").moe.params()
    out = {k: v.detach().float().clone() for k, v in moe.items()
           if k != "shared"}
    out.update({f"shared.{k}": v.detach().float().clone()
                for k, v in moe.get("shared", {}).items()})
    return out


def moe_grads(cfg, flat: dict, x, dy, executor: str, ep_kw=None):
    """One forward and backward of ``sum(y * dy)`` through the MoE layer
    ``flat`` (``moe_layer_fp32``'s form; with ``ep_kw`` ``apply_moe_ep``
    over the current EP group, else ``apply_moe``): {"x" or a leaf:
    gradient}."""
    import torch
    from repro_torch.core.distributed import apply_moe_ep
    from repro_torch.core.moe_layer import apply_moe, dispatch_config
    leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
    p = {k: v for k, v in leaves.items() if not k.startswith("shared.")}
    shared = {k[len("shared."):]: v for k, v in leaves.items()
              if k.startswith("shared.")}
    if shared:
        p["shared"] = shared
    xg = x.detach().requires_grad_()
    dcfg = dispatch_config(cfg.moe, executor=executor,
                           schedule_policy=EP_GRAD_POLICY)
    y, _ = (apply_moe_ep(p, xg, dcfg, **ep_kw) if ep_kw is not None
            else apply_moe(p, xg, dcfg))
    wrt = {"x": xg, **leaves}
    return dict(zip(wrt, torch.autograd.grad((y * dy).sum(),
                                             list(wrt.values()))))


def ep_grad_arms(cfg, full: dict, local: dict, group) -> dict:
    """[ep] under autograd on this rank (EP_GRAD_ARMS): each arm's
    gradients against the single rank's ``apply_moe`` backward over
    ``full`` (this rank's slice of the routed stacks), or for
    ``sharded_static`` against the same layout on the plain executor; each
    leaf's error relative to its largest magnitude, B1ᵀ and B7 launches
    of the arm's first pass, EP_GRAD_REPS timed passes of the arm and of
    the single rank's layer, and dx (bitwise alike on every rank)."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import _token_split
    from repro_torch.execution import available_executors
    from repro_torch.kernels import ops
    from repro_torch.weights import EXPERT_MATS
    if "plain" not in available_executors():
        register_plain_executor()
    dev, d = group.device, cfg.d_model
    n = cfg.moe.n_experts // group.size
    own = slice(group.rank * n, (group.rank + 1) * n)

    def timed(fn):
        ms = []
        for _ in range(EP_GRAD_REPS):
            group.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    inputs, single = {}, {}
    for name, (B, S) in EP_GRAD_SHAPES.items():
        rng = np.random.default_rng(B * 1000 + S)
        x, dy = (torch.from_numpy(rng.standard_normal((B, S, d)).astype(
            np.float32)).to(dev) for _ in range(2))
        inputs[name] = (x, dy)
        single[name] = (moe_grads(cfg, full, x, dy, "cuda"), timed(
            lambda: moe_grads(cfg, full, x, dy, "cuda")))
    out = {}
    for arm, (shape, lay, ov) in EP_GRAD_ARMS.items():
        x, dy = inputs[shape]
        kw = dict(token_layout=lay, overlap=ov, group=group)
        if lay == "sharded_static":
            want, whole = moe_grads(cfg, local, x, dy, "plain", kw), False
        else:
            want, whole = single[shape][0], True
        torch.cuda.synchronize()
        ops.reset_launches()
        got = moe_grads(cfg, local, x, dy, "cuda", kw)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        errs = {}
        for k, w in want.items():
            if whole and k in EXPERT_MATS:
                w = w[own]
            errs[k] = float((got[k] - w).abs().max() / w.abs().max())
        out[arm] = {"shape": EP_GRAD_SHAPES[shape], "layout": lay,
                    "runs_as": _token_split(x.shape, group.size, lay)[0],
                    "overlap": ov, "errs": errs, "launches": launches,
                    "held_against": "plain" if not whole else "single",
                    "ms": timed(lambda: moe_grads(cfg, local, x, dy, "cuda",
                                                  kw)),
                    "single_ms": single[shape][1],
                    "dx": got["x"].cpu().numpy()}
    return out


def ep_rank(group, spec: dict) -> dict:
    """One [ep] rank: [serve paged]'s model from the same seed at the
    checked depth, this rank's experts kept, then ``ep_workload``, then
    the first MoE layer under autograd (``ep_grad_arms``)."""
    import torch
    from repro_torch.models.lm import init_params
    from repro_torch.weights import shard_model
    cfg = spec["cfg"]
    model = init_params(cfg, 0, param_dtype=torch.bfloat16,
                        device=group.device)
    full = moe_layer_fp32(model)
    shard_model(model, group.rank, group.size)
    local = moe_layer_fp32(model)
    torch.cuda.empty_cache()
    out = ep_workload(cfg, model, spec, ep=True)
    out["grad"] = ep_grad_arms(cfg, full, local, group)
    del full, local
    torch.cuda.empty_cache()
    out.update(rank=group.rank, backend=group.backend,
               device=str(group.device),
               peak_bytes=torch.cuda.max_memory_allocated(group.device))
    return out


def report_ep_grads(ranks: list) -> dict:
    """[ep] under autograd: every rank's dx bitwise alike, every leaf's
    gradient within TRAIN_CHECK_TOL["float32"]["grad"] of its largest
    magnitude, B1ᵀ and B7 launched in every arm; prints each arm's worst
    errors, launches and fwd + bwd ms (median of EP_GRAD_REPS, rank 0)."""
    import numpy as np
    tol = TRAIN_CHECK_TOL["float32"]["grad"]
    out = {}
    for arm in EP_GRAD_ARMS:
        rs = [r["grad"][arm] for r in ranks]
        if not all(np.array_equal(rs[0]["dx"], g["dx"]) for g in rs[1:]):
            raise AssertionError(f"[ep grad] {arm}: dx differs between "
                                 f"ranks")
        errs = {k: max(g["errs"][k] for g in rs) for k in rs[0]["errs"]}
        bad = {k: e for k, e in errs.items() if not e <= tol}
        launches = [{k: g["launches"][k]
                     for k in ("grouped_gemm_t", "grouped_wgrad")}
                    for g in rs]
        if bad or not all(v > 0 for la in launches for v in la.values()):
            raise AssertionError(f"[ep grad] {arm}: errors {bad} past {tol:g}"
                                 f" or launches {launches}")
        g0 = rs[0]
        out[arm] = {"shape": g0["shape"], "layout": g0["layout"],
                    "runs_as": g0["runs_as"], "overlap": g0["overlap"],
                    "held_against": g0["held_against"], "errs": errs,
                    "launches": launches, "ms": g0["ms"],
                    "ms_median": float(np.median(g0["ms"])),
                    "single_ms_median": float(np.median(g0["single_ms"]))}
        B, S = g0["shape"]
        against = ("the plain executor in the same layout"
                   if g0["held_against"] == "plain" else "the single rank")
        print(f"[ep grad] {arm}: x ({B}, {S}, d), layout {g0['layout']} "
              f"(runs as {g0['runs_as']}), overlap {g0['overlap']}, fp32 "
              f"{EP_GRAD_POLICY}, held against {against}: worst relative "
              f"error (rtol {tol:g}) dx "
              f"{errs['x']:.2e}, router {errs['router']:.2e}, shared "
              + "/".join(f"{errs[k]:.2e}" for k in errs
                         if k.startswith("shared."))
              + ", own experts " + "/".join(
                  f"{errs[k]:.2e}" for k in ("w_gate", "w_up", "w_down"))
              + f"; B1t/B7 launches a rank {launches}; fwd + bwd ms "
              f"(rank 0, host clock, median of {EP_GRAD_REPS}) "
              f"{out[arm]['ms_median']:.2f}, single rank "
              f"{out[arm]['single_ms_median']:.2f}; {smi_line()}")
    return out


def serve_ep(cfg, model, prompts, capacity, paged_kw) -> dict:
    """[ep]: [serve paged]'s model (its first CHECK_LAYERS layers) served
    by EP_RANKS ranks on this one card (gloo), each holding E / EP_RANKS
    experts per MoE layer, against the single-rank engine on the same
    weights and requests: greedy fp32 tokens equal under each of EP_ARMS;
    the MoE layer in bf16 within TOL in every layout at EP_LAYER_TS;
    ``serve/ep_dropped_tokens`` equal to the single-rank run's summed
    ``sched/dropped_rows`` and above 0; int8_expert tokens equal; each
    rank's launches (B5, B3, B2, B1, B4 once per MoE layer per forward, B6
    once per layer per forward); decode ms per step of each beside the
    single rank's, the all_to_all rows and bytes per step
    (``a2a_send_rows``) and the backend.  Two ranks on one card show the
    transport's cost, not scaling."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import a2a_send_rows
    from repro_torch.distributed import spawn_ranks
    from repro_torch.models.lm import n_moe_layers
    n = min(cfg.n_layers, CHECK_LAYERS)
    cfg_ep = cfg.replace(n_layers=n)
    n_moe = n_moe_layers(cfg_ep)
    spec = {"cfg": cfg_ep, "capacity": capacity,
            "prompts": [p.tolist() for p in prompts], "paged_kw": paged_kw}
    t0 = time.perf_counter()
    single = ep_workload(cfg_ep, truncated(model, n), spec, ep=False)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = spawn_ranks(ep_rank, EP_RANKS, "cuda:0", spec, timeout=900)
    t2 = time.perf_counter()
    r0 = ranks[0]
    print(f"[ep] {EP_RANKS} ranks on {r0['device']}, backend "
          f"{r0['backend']} (collectives take the tensors on the card); "
          f"{cfg_ep.n_layers} layers "
          f"({n_moe} MoE), {cfg.moe.n_experts // EP_RANKS} of "
          f"{cfg.moe.n_experts} experts a rank; single-rank runs "
          f"{t1 - t0:.1f} s, ranks (spawn included) {t2 - t1:.1f} s; peak "
          f"device memory a rank " + ", ".join(
              f"{r['peak_bytes'] / 1e9:.2f} GB" for r in ranks))
    want = single["fp32"]["single"]["tokens"]
    for r in ranks:
        for arm in EP_ARMS:
            got = r["fp32"][arm]
            if got["tokens"] != want:
                raise AssertionError(f"[ep] rank {r['rank']} {arm}: tokens "
                                     f"{got['tokens']} != single rank's "
                                     f"{want}")
            fw, la = got["forwards"], got["launches"]
            if arm == "overlap2":
                check_overlap_launches(la, n_moe * fw, n * fw)
            else:
                check_launches(la, n_moe * fw, n * fw, "dense")
        if r["int8"]["tokens"] != single["int8"]["tokens"]:
            raise AssertionError(f"[ep] rank {r['rank']} int8_expert tokens "
                                 f"differ from the single rank's")
        check_launches(r["int8"]["launches"], n_moe * r["int8"]["forwards"],
                       n * r["int8"]["forwards"], "int8")
        for arm in EP_TIMED_ARMS:
            d = r["decode"][arm]
            check_launches(d["launches"], n_moe * d["forwards"],
                           n * d["forwards"], "dense")
    ov_launches = {k: r0["fp32"]["overlap2"]["launches"][k]
                   for k in MOE_KERNELS}
    print(f"[ep] fp32 greedy tokens of {len(want)} requests x "
          f"{SERVE_MAX_NEW} equal the single rank's on both ranks under "
          + ", ".join(EP_ARMS) + "; int8_expert tokens equal; launches a "
          f"rank: {json.dumps(r0['fp32']['replicated']['launches'])} over "
          f"{r0['fp32']['replicated']['forwards']} forwards (replicated), "
          f"overlap2 {json.dumps(ov_launches)} over "
          f"{r0['fp32']['overlap2']['forwards']}")
    # drops
    sd, rd = single["drops"], [r["drops"] for r in ranks]
    want_drop = sum(sd["dropped_rows"])
    for r in rd:
        if r["tokens"] != sd["tokens"] or r["dropped_rows"] \
                != sd["dropped_rows"] or r["ep_dropped_tokens"] != want_drop:
            raise AssertionError(f"[ep] capacity_factor {EP_CF}: rank {r} "
                                 f"against single {sd}")
    if not want_drop > 0:
        raise AssertionError("[ep] the drop check dropped nothing")
    print(f"[ep] capacity_factor {EP_CF} (block_m {EP_DROP_BLOCK_M}, "
          f"prefill chunks of {EP_DROP_CHUNK}, moe_stats): "
          f"serve/ep_dropped_tokens {rd[0]['ep_dropped_tokens']:.0f} on each "
          f"rank = the single rank's summed sched/dropped_rows "
          f"{want_drop:.0f} (per request {sd['dropped_rows']}); tokens equal")
    # one MoE layer in bf16
    layer_err = {}
    for key, y_single in single["layer"].items():
        T = key.split("/")[0]
        for lay in EP_LAYER_LAYOUTS:
            ys = [r["layer"][f"{T}/{lay}"] for r in ranks]
            if not all(np.array_equal(ys[0], y) for y in ys[1:]):
                raise AssertionError(f"[ep] layer {T} {lay}: ranks differ")
            torch.testing.assert_close(torch.from_numpy(ys[0]),
                                       torch.from_numpy(y_single),
                                       **TOL["bfloat16"])
            layer_err[f"{T}/{lay}"] = float(np.abs(ys[0] - y_single).max())
    print(f"[ep] one MoE layer, bf16, dynamic, apply_moe_ep vs single-rank "
          f"apply_moe (rtol=atol={TOL['bfloat16']['atol']:g}): max_abs_err "
          + json.dumps(layer_err))
    # times and transport
    E, k, d = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    rows = a2a_send_rows(SERVE_SLOTS // EP_RANKS, k, E, EP_RANKS,
                         cfg.moe.block_m, cfg.moe.capacity_factor, "dynamic")
    a2a = {"rows_per_destination": rows,
           "payload_bytes_per_step": n_moe * 2 * EP_RANKS * rows * d * 2,
           "expert_id_bytes_per_step": n_moe * EP_RANKS * rows * 4,
           "all_gather_bytes_per_step": n_moe * SERVE_SLOTS * d * 2,
           "replicated_all_reduce_bytes_per_step":
               n_moe * SERVE_SLOTS * d * 4}
    sdec = single["decode"]["single"]
    times = {"single": sdec["decode_ms_per_step"],
             **{arm: ranks[0]["decode"][arm]["decode_ms_per_step"]
                for arm in EP_TIMED_ARMS}}
    p50 = {"single": sdec["decode_ms_per_step_p50"],
           **{arm: ranks[0]["decode"][arm]["decode_ms_per_step_p50"]
              for arm in EP_TIMED_ARMS}}
    print(f"[ep] decode ms per step, bf16, {SERVE_SLOTS} slots (host clock, "
          f"each step ends in its host transfer; mean of decode-only "
          f"steps): single rank {times['single']:.2f} "
          f"(p50 {p50['single']:.2f}); ep={EP_RANKS} "
          + "; ".join(f"{arm} {times[arm]:.2f} (p50 {p50[arm]:.2f})"
                      for arm in EP_TIMED_ARMS)
          + f"; {smi_line()}")
    print(f"[ep] transport per decode step ({SERVE_SLOTS} rows, {n_moe} MoE "
          f"layers, bf16): sharded: {rows} rows a destination "
          f"(a2a_send_rows), payload all_to_all "
          f"{a2a['payload_bytes_per_step']} bytes a rank (out and back), "
          f"expert ids {a2a['expert_id_bytes_per_step']}, all_gather "
          f"{a2a['all_gather_bytes_per_step']}; replicated: all_reduce "
          f"{a2a['replicated_all_reduce_bytes_per_step']} bytes (fp32); "
          f"collectives a decode step: replicated {n_moe}, sharded "
          f"{5 * n_moe}; host ms per collective alone (rank 0, mean of "
          f"{EP_COLLECTIVE_ITERS}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in r0["collective_ms"].items()))
    grad = report_ep_grads(ranks)
    return {"collective_ms": [r["collective_ms"] for r in ranks],
            "ranks": EP_RANKS, "layers": n, "backend": r0["backend"],
            "grad": grad, "decode_ms_per_step": times,
            "decode_p50_ms": p50,
            "transport": a2a, "layer_max_abs_err": layer_err,
            "ep_dropped_tokens": rd[0]["ep_dropped_tokens"],
            "launches": {arm: [r["decode"][arm]["launches"] for r in ranks]
                         for arm in EP_TIMED_ARMS},
            "forwards": {arm: [r["decode"][arm]["forwards"] for r in ranks]
                         for arm in EP_TIMED_ARMS},
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "single_s": t1 - t0, "ranks_s": t2 - t1}


def tune_sweeps() -> dict:
    """[tune] (a): B1 and B2 swept over their tile shapes
    (``repro_torch.tuning.tune_moe_layer``) at ``TUNE_SWEEPS`` in dense
    bf16 and at ``TUNE_INT8`` on int8 weights, the sub-block floor at the
    ``dynamic`` shapes, into a fresh ``TuneCache``.  Fails unless every
    winner is at or below the default tile on the same measurement and
    every candidate's output is bitwise the default's (no shape splits
    K).  Returns the cache and each key's records."""
    import torch
    from repro_torch import tuning
    cache = tuning.TuneCache(device=torch.cuda.get_device_name(0))
    keys = {}
    for (arch, shape, T, policy), scheme in (
            [(t, "dense") for t in TUNE_SWEEPS] + [(TUNE_INT8, "int8")]):
        for res in tuning.tune_moe_layer(
                E=shape["E"], top_k=shape["k"], d_model=shape["d"],
                d_ffn=shape["f"], tokens=T, scheme=scheme, reps=3,
                cache=cache, policy=policy, schedule_block_m=shape["M"],
                block_m=(shape["M"] if policy == "dynamic"
                         and scheme == "dense" else None)):
            w, dflt = res["winner"], res["default"]
            if w["us"] > dflt["us"]:
                raise AssertionError(f"[tune] {res['key']}: winner "
                                     f"{w['us']} us over the default's "
                                     f"{dflt['us']}")
            bad = [r for r in res["records"] if not r.get("bitwise", True)]
            if bad:
                raise AssertionError(
                    f"[tune] {res['key']}: tiles "
                    f"{[(r['block_m'], r['block_n']) for r in bad]} not "
                    f"bitwise the default's (max abs diff "
                    f"{max(r['max_abs_diff'] for r in bad):.3e})")
            tile = ("block_m_min" if res["kernel"] == "sub_block"
                    else "block_m")
            print(f"[tune] {arch} T={T} {policy} {res['kernel']} {scheme} "
                  f"[{res['key']}]: " + "; ".join(
                      (f"floor {r['block_m_min']} (sub-block "
                       f"{r['sub_block']})" if tile == "block_m_min" else
                       f"({r['block_m']}, {r['block_n']})")
                      + f" {r['us']:.2f} us (spread {r['spread']:.3f})"
                      + (" default" if r["is_default"] else "")
                      + (" WINNER" if r is w else "")
                      for r in res["records"])
                  + ("" if res["kernel"] == "sub_block" else
                     "; every tile bitwise the default's"))
            keys[res["key"]] = {
                "arch": arch, "T": T, "policy": policy, "scheme": scheme,
                "records": res["records"],
                "winner": {k: w[k] for k in w if k in (
                    "block_m", "block_n", "block_m_min", "sub_block", "us")},
                "default_us": dflt["us"]}
    return {"cache": cache, "keys": keys}


def serve_tuned(cfg, model, prompts, capacity, paged_kw, cache) -> dict:
    """[tune] (b): [serve paged]'s moonshot requests on two fresh paged
    engines, ``autotune`` off then on, the tuned one reading ``cache``
    through a temporary ``$REPRO_TORCH_TUNE_CACHE`` (over the packaged
    defaults).  Fails unless the greedy tokens and the per-kernel launches
    are equal, the tune cache is hit, and two tuned decode steps' forwards
    (``paged_step``: the engine's host transfers stay outside) run under
    ``set_sync_debug_mode("error")``.  Prints each run's host ms per decode
    step and the tiles the tuned run's keys name."""
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch import tuning
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Request, ServeEngine
    tmp = ROOT / "build" / "tune_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    cache.save(tmp / "cache.json")
    old = os.environ.get(tuning.cache.ENV_CACHE)
    os.environ[tuning.cache.ENV_CACHE] = str(tmp / "cache.json")
    tuning.reset_cache()
    warm = np.random.default_rng(26).integers(0, cfg.vocab_size,
                                              32).astype(np.int32)
    out = {}
    try:
        for arm, autotune in (("untuned", False), ("tuned", True)):
            engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                                 capacity=capacity,
                                 rc=served_rc()._replace(autotune=autotune),
                                 **paged_kw)
            engine.run([Request(rid=-1, prompt=warm, max_new=3)])
            reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                    for i, p in enumerate(prompts)]
            tuning.reset_stats()
            res = drive(engine, reqs)
            stats = dict(tuning.STATS)
            for i in range(SERVE_SLOTS):          # two tuned decode steps
                engine.admit(Request(rid=100 + i, prompt=prompts[i][:24],
                                     max_new=8))
            engine.step()                         # the prompt step(s)
            while engine.last_step[1]:
                engine.step()
            # the step's forward (the engine's host transfers stay outside)
            real = engine_mod.paged_step

            def guarded(*a, **kw):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return real(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            engine_mod.paged_step = guarded
            try:
                for _ in range(2):
                    engine.step()
                    if engine.last_step != (SERVE_SLOTS, 0):
                        raise AssertionError(f"[tune] {engine.last_step}: "
                                             "not a decode step")
            finally:
                engine_mod.paged_step = real
            out[arm] = {"tokens": [list(map(int, r.out)) for r in reqs],
                        "launches": res["launches"], "stats": stats,
                        "decode_ms": [t * 1e3 for t in res["decode_steps"]],
                        "forwards": res["forwards"]}
            del engine
            torch.cuda.empty_cache()
        moe, d = cfg.moe, cfg.d_model
        mine = (f"fused_gate_up|E{moe.n_experts}|K{d}|N{moe.d_ff_expert}|",
                f"grouped_gemm|E{moe.n_experts}|K{moe.d_ff_expert}|N{d}|")
        used = {k: (r["block_m"], r["block_n"])
                for k, r in tuning.get_cache().entries.items()
                if k.startswith(mine) and "|bfloat16|dense|" in k}
    finally:
        if old is None:
            os.environ.pop(tuning.cache.ENV_CACHE, None)
        else:
            os.environ[tuning.cache.ENV_CACHE] = old
        tuning.reset_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    u, t = out["untuned"], out["tuned"]
    if t["tokens"] != u["tokens"]:
        raise AssertionError(f"[tune] tuned greedy tokens {t['tokens']} != "
                             f"untuned {u['tokens']}")
    if t["launches"] != u["launches"]:
        raise AssertionError(f"[tune] tuned launches {t['launches']} != "
                             f"untuned {u['launches']}")
    if t["stats"]["hits"] <= 0 or u["stats"]["lookups"] != 0:
        raise AssertionError(f"[tune] tune cache lookups: tuned "
                             f"{t['stats']}, untuned {u['stats']}")
    med = {a: float(np.median(out[a]["decode_ms"])) for a in out}
    print(f"[tune] served moonshot ({cfg.n_layers} layers, paged, dynamic): "
          f"greedy tokens and launches of the tuned run equal to the "
          f"untuned run's ({json.dumps(t['launches'])}); tune cache "
          f"{t['stats']['lookups']} lookups, {t['stats']['hits']} hits over "
          f"{t['forwards']} forwards; two tuned decode steps' forwards "
          f"under set_sync_debug_mode('error'); host ms per decode step, median "
          f"of {len(t['decode_ms'])}: tuned {med['tuned']:.2f}, untuned "
          f"{med['untuned']:.2f}")
    print("[tune] moonshot's bf16 dense keys in the tuned run's cache: "
          + "; ".join(f"{k.split('|')[0]} {k.split('|')[4]} -> {v}"
                      for k, v in sorted(used.items())))
    return {"stats": t["stats"], "launches": t["launches"],
            "decode_ms_median": med, "tiles": {k: list(v)
                                               for k, v in used.items()}}


def served_rc():
    """The served engines' run config: bf16 compute, ``dynamic``."""
    import torch
    from repro_torch.models.lm import RunConfig
    return RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")


def serve_deepseek(rng) -> dict:
    """deepseek-v2-236b at full width, cut to DEEPSEEK_LAYERS layers (1 dense
    + 3 MoE), random bf16 weights: the paged engine (its attention through
    the MLA kernel), the first paged step's logits in fp32 through the first
    DEEPSEEK_CHECK_LAYERS layers against the plain versions and the gather
    read, the contiguous engine, then the paged engine again on routed
    experts quantized in place under int8_expert.  Returns the summaries."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import (RunConfig, forward, init_params,
                                       n_moe_layers)
    from repro_torch.quantization import routed_expert_bytes
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("deepseek-v2-236b").replace(n_layers=DEEPSEEK_LAYERS)
    V, n_moe, mla, moe = cfg.vocab_size, n_moe_layers(cfg), cfg.mla, cfg.moe
    print(f"[serve deepseek] {cfg.name} at full width (d_model="
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA q_lora {mla.q_lora_rank}"
          f" / kv_lora {mla.kv_lora_rank} / rope {mla.qk_rope_head_dim}, "
          f"{moe.n_experts} experts top-{moe.top_k} + {moe.n_shared_experts}"
          f" shared, d_ff_expert={moe.d_ff_expert}, vocab={V}); reduced: "
          f"n_layers 60 -> {cfg.n_layers} (1 dense + {n_moe} MoE); random "
          f"bf16 weights, seed 0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve deepseek] {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = shared_prefix_prompts(rng, V)
    capacity = max(48, *(len(p) for p in prompts)) + SERVE_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")
    paged_kw = dict(kv_block_size=KV_BLOCK, prefill_chunk=PREFILL_CHUNK)

    # paged ------------------------------------------------------------
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc, **paged_kw)
    print(f"[serve deepseek paged] dynamic schedule, blocks of {KV_BLOCK}, "
          f"prefill chunks of {PREFILL_CHUNK}, fused paged read (MLA "
          f"kernel), {SERVE_SLOTS} slots x {capacity} tokens; prompts of "
          f"{[len(p) for p in prompts]} tokens, requests 0, 2, 3 share "
          f"{SHARED_PREFIX}")
    reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
            for i, p in enumerate(prompts)]
    paged = serve_and_check("serve deepseek paged", engine, reqs, rng,
                            attn_kernel="paged_attention_mla")
    peak = torch.cuda.max_memory_allocated()
    hit = sum(r.stats["serve/prefix_hit_tokens"] for r in reqs)
    if hit <= 0:
        raise AssertionError("deepseek: the prefix cache never hit")
    print(f"[serve deepseek paged] prefix-hit tokens {hit:.0f} "
          f"({json.dumps(engine.kv.stats())}); peak device memory "
          f"{peak / 1e9:.2f} GB (load and serving)")
    summary = summarize("serve deepseek paged", paged, reqs, cfg.n_layers)
    summary.update({"n_params": n_params, "peak_bytes": peak,
                    "prefix_hit_tokens": hit, "launches": paged["launches"]})
    for i in range(SERVE_SLOTS):
        engine.admit(Request(rid=100 + i, prompt=rng.integers(
            0, V, 48).astype(np.int32), max_new=16))
    summary["profile"] = {
        "prefill": profile_window(lambda: [engine.step() for _ in range(2)]),
        "decode": profile_window(lambda: [engine.step() for _ in range(5)])}
    print_profile("serve deepseek paged",
                  "2 chunk steps, 2 x 48 prompt tokens", summary["profile"])
    out = {"paged": summary}
    del engine
    torch.cuda.empty_cache()

    # the first paged step (its prompt-chunk rows) in fp32 through the first
    # layers and the head: kernels + MLA kernel vs plain versions + gather
    # read; and the first prompt's prefill (decompressed MLA) vs the plain
    # versions
    n_check = DEEPSEEK_CHECK_LAYERS
    cfg_check = cfg.replace(n_layers=n_check)
    head32 = copy.deepcopy(truncated(model, n_check)).float()
    rc32 = rc._replace(compute_dtype=torch.float32)
    logits, logits_p, n_rows = first_step_logits(head32, cfg_check, rc32,
                                                 prompts, capacity, paged_kw)
    torch.testing.assert_close(logits, logits_p, **LOGIT_TOL_FP32)
    err = (logits - logits_p).abs().max().item()
    print(f"[serve deepseek paged] first paged step ({n_rows} prompt rows, "
          f"{n_check} layers, fp32) MLA kernel + MoE kernels vs gather read "
          f"+ plain versions: max_abs_err {err:.3e} (|logits| max "
          f"{logits_p.abs().max().item():.2f}; tolerance rtol=atol="
          f"{LOGIT_TOL_FP32['atol']:g}); argmax equal: "
          f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
    out["paged"]["first_step_fp32_max_abs_err"] = err
    first = torch.as_tensor(prompts[0].astype(np.int64), device="cuda")[None]
    rc32c = rc32._replace(schedule_policy="fixed")
    logits, _, _ = forward(head32, cfg_check, rc32c, {"tokens": first},
                           mode="prefill")
    logits_p, _, _ = forward(head32, cfg_check,
                             rc32c._replace(executor="plain"),
                             {"tokens": first}, mode="prefill")
    torch.testing.assert_close(logits, logits_p, **LOGIT_TOL_FP32)
    print(f"[serve deepseek contiguous] first prefill ({len(prompts[0])} "
          f"tokens, {n_check} layers, fp32, fixed) kernels vs plain "
          f"versions: max_abs_err "
          f"{(logits - logits_p).abs().max().item():.3e}")
    del logits, logits_p
    chunk_check = {"float32": mla_chunk_check(cfg_check, head32, rng)}
    del head32
    torch.cuda.empty_cache()

    # contiguous + fixed -----------------------------------------------------
    rc_c = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="fixed")
    reqs_c = [Request(rid=i, prompt=rng.integers(
                  0, V, int(rng.integers(16, 65))).astype(np.int32),
                      max_new=SERVE_MAX_NEW) for i in range(CONTIG_REQUESTS)]
    capacity_c = max(48, *(len(r.prompt) for r in reqs_c)) \
        + SERVE_MAX_NEW + 1
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity_c,
                         rc=rc_c, kv_block_size=0)
    contig = serve_and_check("serve deepseek contiguous", engine, reqs_c,
                             rng)
    out["contiguous"] = summarize("serve deepseek contiguous", contig,
                                  reqs_c, cfg.n_layers)
    del engine
    torch.cuda.empty_cache()

    # [prefill long]: the chunked prefill against one chunk, then one prompt
    # of LONG_PROMPTS tokens through the contiguous prefill (chunks of 512)
    chunk_check["bfloat16"] = mla_chunk_check(cfg.replace(n_layers=1),
                                              truncated(model, 1), rng)
    out["prefill_long"] = prefill_long(cfg, model, rng)
    out["prefill_long"]["chunk_check"] = chunk_check

    # paged on int8_expert experts, quantized in place by the engine -------
    dense_bytes = routed_expert_bytes(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc._replace(quant="int8_expert"), **paged_kw)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    peak_load = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reqs_q = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
              for i, p in enumerate(prompts)]
    res = serve_and_check("serve deepseek int8_expert", engine, reqs_q, rng,
                          "int8", "paged_attention_mla")
    peak_serve = torch.cuda.max_memory_allocated()
    print(f"[serve deepseek int8_expert] {cfg.n_layers} layers, routed "
          f"experts {engine.quant_expert_bytes / 1e9:.3f} GB stored "
          f"({dense_bytes / 1e9:.3f} GB bf16), quantized in "
          f"{quantize_s:.2f} s; peak device memory {peak_load / 1e9:.2f} GB "
          f"while quantizing, {peak_serve / 1e9:.2f} GB while serving")
    summary = summarize("serve deepseek paged int8_expert", res, reqs_q,
                        cfg.n_layers)
    summary.update({"expert_bytes": engine.quant_expert_bytes,
                    "dense_expert_bytes": dense_bytes,
                    "quantize_s": quantize_s,
                    "peak_bytes_quantizing": peak_load,
                    "peak_bytes_serving": peak_serve,
                    "launches": res["launches"]})
    out["int8_expert"] = summary
    del engine, model
    torch.cuda.empty_cache()
    return out


def shared_prefix_prompts(rng, V: int, n: int = SERVE_REQUESTS):
    """[serve paged]'s traffic: ``n`` prompts of 16-64 tokens, all but the
    second opening with one SHARED_PREFIX-token prefix."""
    import numpy as np
    shared = rng.integers(0, V, SHARED_PREFIX)
    return [(rng.integers(0, V, int(rng.integers(16, 65))) if i == 1
             else np.concatenate([shared, rng.integers(
                 0, V, int(rng.integers(1, 25)))])).astype(np.int32)
            for i in range(n)]


def dense_model(name: str, layers=None):
    """A dense config at full width (``layers`` cuts its depth) with random
    bf16 weights from seed 0, on the card; prints its size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    cfg = get_config(name)
    full = cfg.n_layers
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    cut = (f"reduced: n_layers {full} -> {cfg.n_layers}"
           if cfg.n_layers != full else f"all {full} layers")
    print(f"[dense] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff={cfg.d_ff} {cfg.act}, {cfg.norm}, vocab="
          f"{cfg.vocab_size}{', tied' if cfg.tie_embeddings else ''}); "
          f"{cut}; {n_params / 1e9:.3f} B parameters ({n_params * 2 / 1e9:.2f}"
          f" GB bf16), random, seed 0, initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, n_params


def serve_gemma2(rng):
    """gemma2-9b at full width and all 42 layers, random bf16 weights: the
    paged engine on [serve paged]'s traffic (blocks of 16, chunks of 32,
    the fused read: the GQA kernel once per layer per forward, no MoE
    kernel; the prefix cache must hit), a profile of 2 chunk steps and 5
    decode steps, the same traffic on the contiguous engine, and the first
    paged step's logits of a 4-layer fp32 copy through the fused read
    against the gather read.  Returns (summaries, cfg, model)."""
    import numpy as np
    import torch
    from repro_torch.models.lm import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()       # earlier phases' tensors
    cfg, model, n_params = dense_model("gemma2-9b")
    V = cfg.vocab_size
    prompts = shared_prefix_prompts(rng, V)
    capacity = max(48, *(len(p) for p in prompts)) + SERVE_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")
    paged_kw = dict(kv_block_size=KV_BLOCK, prefill_chunk=PREFILL_CHUNK)
    out = {"n_params": n_params}
    for kind, kw in (("paged", paged_kw), ("contiguous",
                                           dict(kv_block_size=0))):
        tag = f"serve gemma2 {kind}"
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                             capacity=capacity, rc=rc, **kw)
        print(f"[{tag}] {SERVE_SLOTS} slots x {capacity} tokens"
              + (f", blocks of {KV_BLOCK}, prefill chunks of "
                 f"{PREFILL_CHUNK}, fused paged read" if engine.paged
                 else "") + f"; prompts of {[len(p) for p in prompts]} "
              f"tokens, requests 0, 2, 3 share {SHARED_PREFIX}")
        reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(prompts)]
        res = serve_and_check(tag, engine, reqs, rng)
        summary = summarize(tag, res, reqs, cfg.n_layers)
        summary.update({"launches": res["launches"],
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "allocated_before_load_bytes": before})
        if engine.paged:
            hit = sum(r.stats["serve/prefix_hit_tokens"] for r in reqs)
            if hit <= 0:
                raise AssertionError("gemma2: the prefix cache never hit")
            summary["prefix_hit_tokens"] = hit
            print(f"[{tag}] prefix-hit tokens {hit:.0f}; peak device "
                  f"memory {summary['peak_bytes'] / 1e9:.2f} GB (load and "
                  f"serving; {before / 1e9:.2f} GB of it allocated before "
                  f"the load by earlier phases)")
            for i in range(SERVE_SLOTS):
                engine.admit(Request(rid=100 + i, prompt=rng.integers(
                    0, V, 48).astype(np.int32), max_new=16))
            summary["profile"] = {
                "prefill": profile_window(
                    lambda: [engine.step() for _ in range(2)]),
                "decode": profile_window(
                    lambda: [engine.step() for _ in range(5)])}
            print_profile(tag, "2 chunk steps, 2 x 48 prompt tokens",
                          summary["profile"])
        out[kind] = summary
        del engine
        torch.cuda.empty_cache()
    # the first paged step's logits, fp32, CHECK_LAYERS layers: the fused
    # read against the gather read (no MoE layer: the same torch ops else)
    n_check = CHECK_LAYERS
    head32 = copy.deepcopy(truncated(model, n_check)).float()
    cfg_check = cfg.replace(n_layers=n_check)
    logits, logits_p, n_rows = first_step_logits(
        head32, cfg_check, rc._replace(compute_dtype=torch.float32),
        prompts, capacity, paged_kw)
    torch.testing.assert_close(logits, logits_p, **LOGIT_TOL_FP32)
    err = (logits - logits_p).abs().max().item()
    print(f"[serve gemma2 paged] first paged step ({n_rows} prompt rows, "
          f"{n_check} layers, fp32) fused read vs gather read: max_abs_err "
          f"{err:.3e} (|logits| max {logits_p.abs().max().item():.2f}, "
          f"final softcap {cfg.final_logit_softcap:g}; tolerance rtol=atol="
          f"{LOGIT_TOL_FP32['atol']:g}); argmax equal: "
          f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
    out["paged"]["first_step_fp32_max_abs_err"] = err
    del head32, logits, logits_p
    torch.cuda.empty_cache()
    return out, cfg, model


def serve_dense(rng) -> dict:
    """qwen2-7b, starcoder2-3b and smollm-360m at full width, depth cut to
    DENSE_LAYERS: DENSE_REQUESTS requests of [serve paged]'s traffic
    through the paged engine (the GQA kernel once per layer per forward)."""
    import torch
    from repro_torch.models.lm import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine
    out = {}
    for name in ("qwen2-7b", "starcoder2-3b", "smollm-360m"):
        cfg, model, n_params = dense_model(name, DENSE_LAYERS)
        prompts = shared_prefix_prompts(rng, cfg.vocab_size, DENSE_REQUESTS)
        capacity = max(48, *(len(p) for p in prompts)) + SERVE_MAX_NEW + 1
        engine = ServeEngine(
            cfg, model, slots=SERVE_SLOTS, capacity=capacity,
            rc=RunConfig(compute_dtype=torch.bfloat16,
                         schedule_policy="dynamic"),
            kv_block_size=KV_BLOCK, prefill_chunk=PREFILL_CHUNK)
        reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(prompts)]
        tag = f"serve dense {name}"
        res = serve_and_check(tag, engine, reqs, rng)
        out[name] = summarize(tag, res, reqs, cfg.n_layers)
        out[name].update({"n_params": n_params, "launches": res["launches"]})
        del engine, model
        torch.cuda.empty_cache()
    return out


def check_flash_long() -> dict:
    """The chunked ``flash_attention`` (chunks of FLASH_CHUNK) against the
    whole-score ``attention`` at gemma2-9b's local (window 4096) and global
    layers, FLASH_CHECK_S positions, softcap 50, fp32 within 1e-5 and bf16
    within 2e-2; the time and the peak device memory above the inputs of
    each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import attention, flash_attention
    cfg = get_config("gemma2-9b")
    a, S = DENSE_ATTN["gemma2-9b"], FLASH_CHECK_S
    out = {}
    for layer, window in (("local", cfg.local_window), ("global", None)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(S)

            def randn(*shape):
                return torch.randn(shape, generator=g,
                                   device="cuda").to(dtype)
            q = randn(1, S, a["Hkv"] * a["G"], a["D"])
            k, v = randn(1, S, a["Hkv"], a["D"]), randn(1, S, a["Hkv"],
                                                       a["D"])
            kw = dict(causal=True, window=window,
                      logit_softcap=cfg.attn_logit_softcap)
            row = {}
            for arm, fn in (("flash", lambda: flash_attention(
                                q, k, v, **kw, q_chunk=FLASH_CHUNK,
                                kv_chunk=FLASH_CHUNK)),
                            ("whole", lambda: attention(q, k, v, **kw))):
                fn()                              # warm
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                row[arm] = fn()
                torch.cuda.synchronize()
                row[f"{arm}_ms"] = (time.perf_counter() - t0) * 1e3
                row[f"{arm}_peak_bytes"] = \
                    torch.cuda.max_memory_allocated() - base
            dt = str(dtype).replace("torch.", "")
            got, want = row.pop("flash"), row.pop("whole")
            torch.testing.assert_close(got.float(), want.float(),
                                       **FLASH_TOL[dt])
            if not torch.isfinite(got).all():
                raise AssertionError("flash_attention: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            row["max_abs_err"] = err
            out[f"{layer}_{dt}"] = row
            print(f"[prefill long] (a) gemma2 {layer} layer (window "
                  f"{window}), S={S}, {dt}: flash_attention (chunks of "
                  f"{FLASH_CHUNK}) vs whole-score attention max_abs_err "
                  f"{err:.3e} (tolerance {FLASH_TOL[dt]['atol']:g}); "
                  f"{row['flash_ms']:.1f} ms, peak "
                  f"{row['flash_peak_bytes'] / 1e9:.3f} GB against "
                  f"{row['whole_ms']:.1f} ms, peak "
                  f"{row['whole_peak_bytes'] / 1e9:.3f} GB")
            del got, want, q, k, v
            torch.cuda.empty_cache()
    return out


def prefill_long(cfg, model, rng) -> dict:
    """One prompt of LONG_PROMPTS[cfg.name] tokens through contiguous
    prefill (the model's ``forward`` over a one-slot cache, as the
    contiguous engine's admission runs it; chunked attention, gemma2's
    window on its local layers), then LONG_DECODE greedy decode steps:
    prefill ms and tokens/s, decode ms per step, the peak device memory;
    every logit finite, every token in the vocabulary."""
    import torch
    from repro_torch.models.lm import RunConfig, forward, init_cache
    S = LONG_PROMPTS[cfg.name]
    rc = RunConfig(compute_dtype=torch.bfloat16)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, S),
                             device="cuda")[None]
    cache = init_cache(cfg, 1, S + LONG_DECODE + 1, dtype=torch.bfloat16,
                       device="cuda")
    cache_bytes = sum(t.numel() * t.element_size() for layer in cache
                      for t in layer.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logits, cache, _ = forward(model, cfg, rc, {"tokens": prompt},
                               mode="prefill", cache=cache)
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    peak_prefill = torch.cuda.max_memory_allocated()
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(LONG_DECODE - 1):
        logits, cache, _ = forward(model, cfg, rc, {"tokens": tok[:, None]},
                                   mode="decode", cache=cache, pos=S + i)
        finite = finite & torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    toks = torch.cat(toks).tolist()
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: non-finite logits in the long "
                             "prefill or its decode")
    if not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"{cfg.name}: tokens outside the vocabulary")
    out = {"prompt_tokens": S, "layers": cfg.n_layers,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": S / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / (LONG_DECODE - 1),
           "peak_bytes_prefill": peak_prefill,
           "resident_bytes": resident, "cache_bytes": cache_bytes,
           "prefill_transient_bytes": peak_prefill - resident,
           "peak_bytes": torch.cuda.max_memory_allocated(), "tokens": toks}
    print(f"[prefill long] {cfg.name} ({cfg.n_layers} layers, bf16): one "
          f"prompt of {S} tokens, contiguous prefill {out['prefill_ms']:.1f}"
          f" ms ({out['prefill_tokens_per_s']:.0f} tokens/s), then "
          f"{LONG_DECODE} greedy tokens ({out['decode_ms_per_step']:.2f} ms "
          f"a decode step): {toks}; peak device memory "
          f"{peak_prefill / 1e9:.2f} GB in the prefill: "
          f"{resident / 1e9:.2f} GB resident before it (the weights, a "
          f"{cache_bytes / 1e9:.2f} GB cache and what earlier phases hold) "
          f"and {(peak_prefill - resident) / 1e9:.2f} GB of the prefill's "
          f"own; {out['peak_bytes'] / 1e9:.2f} GB in all")
    del cache, logits
    torch.cuda.empty_cache()
    return out


def recurrent_model(name: str, layers=None):
    """A recurrent config at full width and depth (``layers`` cuts it) with
    random bf16 weights from seed 0, on the card; prints its size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params, layer_kinds
    cfg = get_config(name)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    t0 = time.perf_counter()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = layer_kinds(cfg)
    print(f"[recurrent] {cfg.name} ({cfg.family}) at full width (d_model="
          f"{cfg.d_model}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}"
          + (f", RWKV heads of {cfg.rwkv.head_size}" if cfg.rwkv else "")
          + (f", Mamba2 state {cfg.ssm.d_state} heads of "
             f"{cfg.ssm.head_dim}, attention {cfg.n_heads} x "
             f"{cfg.head_dim}" if cfg.ssm else "")
          + f"); {cfg.n_layers} layers, {len(kinds)} blocks ("
          + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
          + f"); {n_params / 1e9:.3f} B parameters ({n_params * 2 / 1e9:.2f}"
          f" GB bf16), random, seed 0, initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, n_params


def recurrent_fp32_check(tag: str, cfg, model, prompts) -> dict:
    """An fp32 copy of the first RECURRENT_CHECK_LAYERS[cfg.name] layers on
    the card against the same copy on the CPU, two prompts in one batch:
    prefill logits within RECURRENT_CHECK_TOL and RECURRENT_CHECK_NEW
    greedy tokens equal; then slot reuse on the card: one slot serving two
    requests in turn gives each the tokens it gets alone."""
    import numpy as np
    import torch
    from repro_torch.models.lm import (RunConfig, forward, init_cache,
                                       layer_kinds)
    from repro_torch.serve.engine import Request, ServeEngine
    cfg_c = cfg.replace(n_layers=RECURRENT_CHECK_LAYERS[cfg.name])
    kinds = layer_kinds(cfg_c)
    n_blocks = len(kinds)
    head = truncated(model, n_blocks)
    if [b.kind for b in head.layers] != kinds:
        raise AssertionError(f"{cfg.name}: the first {n_blocks} blocks are "
                             f"not a {cfg_c.n_layers}-layer model's {kinds}")
    card = copy.deepcopy(head).float()
    cpu = copy.deepcopy(card).cpu()
    rc = RunConfig(compute_dtype=torch.float32)
    toks = torch.as_tensor(np.stack(prompts[:2]).astype(np.int64))
    P, n_new = toks.shape[1], RECURRENT_CHECK_NEW

    def greedy(m, dev):
        t0 = time.perf_counter()
        cache = init_cache(cfg_c, 2, P + n_new + 1, device=dev)
        logits, _, _ = forward(m, cfg_c, rc, {"tokens": toks.to(dev)},
                               mode="prefill", cache=cache)
        first, tok = logits.cpu(), logits.argmax(-1)
        out = [tok]
        for i in range(n_new - 1):
            logits, _, _ = forward(m, cfg_c, rc, {"tokens": tok[:, None]},
                                   mode="decode", cache=cache, pos=P + i)
            tok = logits.argmax(-1)
            out.append(tok)
        out = torch.stack(out, 1).cpu().tolist()
        return first, out, time.perf_counter() - t0
    got, got_toks, card_s = greedy(card, "cuda")
    want, want_toks, cpu_s = greedy(cpu, "cpu")
    torch.testing.assert_close(got, want, **RECURRENT_CHECK_TOL)
    err = (got - want).abs().max().item()
    if got_toks != want_toks:
        raise AssertionError(f"{cfg.name}: greedy tokens on the card "
                             f"{got_toks} against the CPU's {want_toks}")
    print(f"[{tag}] fp32, {cfg_c.n_layers} layers ({n_blocks} blocks), 2 "
          f"prompts of {P} tokens: prefill logits on the card against the "
          f"CPU max_abs_err {err:.3e} (tolerance rtol=atol="
          f"{RECURRENT_CHECK_TOL['atol']:g}; card {card_s:.2f} s, CPU "
          f"{cpu_s:.2f} s for the prefill and {n_new - 1} decode steps); "
          f"{n_new} greedy tokens equal: {got_toks}")
    cap = P + n_new + 1

    def serve(reqs):
        eng = ServeEngine(cfg_c, card, slots=1, capacity=cap, rc=rc)
        if eng.paged:
            raise AssertionError(f"{cfg.name}: the engine chose paging")
        eng.run(reqs, max_steps=4 * n_new)
        if not all(r.done for r in reqs):
            raise AssertionError(f"{cfg.name}: slot reuse run incomplete")
        return [r.out for r in reqs]
    turns = serve([Request(rid=i, prompt=prompts[i], max_new=n_new)
                   for i in range(2)])
    alone = [serve([Request(rid=i, prompt=prompts[i], max_new=n_new)])[0]
             for i in range(2)]
    if turns != alone:
        raise AssertionError(f"{cfg.name}: one slot serving two requests "
                             f"in turn gave {turns}, alone {alone}")
    print(f"[{tag}] slot reuse (fp32, one slot, two requests in turn): "
          f"each request's {n_new} tokens equal its tokens alone")
    del card, cpu
    torch.cuda.empty_cache()
    return {"layers": cfg_c.n_layers, "blocks": n_blocks,
            "prompt_tokens": P, "max_abs_err": err, "tokens": got_toks,
            "slot_reuse_tokens": turns}


def prime_prefill(cfg, model, rng) -> dict:
    """Prefill ms of a PRIME_PROMPT-token prompt against an EVEN_PROMPT-token
    one at full depth (one slot, bf16; warm once, then in turns prime, even,
    even, prime): the SSD scan's fixed chunks take ceil(S / chunk) steps
    at either length, so the two must be within PRIME_RATIO (the
    reference's divisor rule would run 2,039 chunk steps a layer against
    16)."""
    import numpy as np
    import torch
    from repro_torch.models.lm import RunConfig, forward, init_cache
    rc = RunConfig(compute_dtype=torch.bfloat16)

    def run(S: int) -> float:
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, S),
                                 device="cuda")[None]
        cache = init_cache(cfg, 1, S + 1, dtype=torch.bfloat16,
                           device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = forward(model, cfg, rc, {"tokens": prompt},
                               mode="prefill", cache=cache)
        finite = bool(torch.isfinite(logits).all())
        ms = (time.perf_counter() - t0) * 1e3
        if not finite:
            raise AssertionError(f"{cfg.name}: non-finite prefill logits "
                                 f"at {S} tokens")
        return ms
    run(EVEN_PROMPT)
    times = {PRIME_PROMPT: [], EVEN_PROMPT: []}
    for S in (PRIME_PROMPT, EVEN_PROMPT, EVEN_PROMPT, PRIME_PROMPT):
        times[S].append(run(S))
    prime, even = (float(np.mean(times[S])) for S in (PRIME_PROMPT,
                                                      EVEN_PROMPT))
    ratio = prime / even
    chunk = cfg.ssm.chunk
    print(f"[serve zamba2] prefill at full depth, bf16, one slot: "
          f"{PRIME_PROMPT} tokens (prime; {-(-PRIME_PROMPT // chunk)} SSD "
          f"chunks a layer) {prime:.1f} ms, {EVEN_PROMPT} tokens "
          f"({EVEN_PROMPT // chunk} chunks) {even:.1f} ms (each the mean of "
          f"2, in turns): ratio {ratio:.3f} (must be within {PRIME_RATIO})")
    if not 1 / PRIME_RATIO <= ratio <= PRIME_RATIO:
        raise AssertionError(f"{cfg.name}: prime-length prefill {prime:.1f}"
                             f" ms against {even:.1f} ms")
    torch.cuda.empty_cache()
    return {"prime_tokens": PRIME_PROMPT, "even_tokens": EVEN_PROMPT,
            "prime_ms": times[PRIME_PROMPT], "even_ms": times[EVEN_PROMPT],
            "ratio": ratio}


def serve_recurrent(name: str, rng) -> dict:
    """[serve rwkv6] / [serve zamba2]: ``name`` at full width and depth,
    random bf16 weights, through ``ServeEngine`` as the launcher builds it
    (``kv_block_size`` left to the engine: contiguous for these), on
    RECURRENT_REQUESTS prompts of RECURRENT_PROMPT tokens: every request
    completes with tokens in the vocabulary, no kernel of the port runs
    (the launch counters stay 0), a full-depth prefill and decode step
    give finite logits; prefill ms a request, decode ms a step, tokens/s
    and peak memory; a profile of RECURRENT_PROFILE_STEPS decode steps on
    2 slots (busy share, device activities a step).  Then the fp32 copy's
    card-vs-CPU and slot-reuse checks; for zamba2 the parameter count (no
    unread body.b0 blocks) and the prime-length prefill; last [prefill
    long] at LONG_PROMPTS[name]."""
    import numpy as np
    import torch
    from repro_torch.models.lm import RunConfig, forward, init_cache
    from repro_torch.serve.engine import Request, ServeEngine
    tag = f"serve {name.split('-')[0]}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()       # earlier phases' tensors
    cfg, model, n_params = recurrent_model(name)
    out = {"n_params": n_params, "blocks": len(model.layers)}
    if name == "zamba2-7b" and n_params != ZAMBA2_LIVE_PARAMS:
        raise AssertionError(f"zamba2-7b holds {n_params} parameters, not "
                             f"{ZAMBA2_LIVE_PARAMS}")
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, RECURRENT_PROMPT).astype(np.int32)
               for _ in range(RECURRENT_REQUESTS)]
    capacity = RECURRENT_PROMPT + RECURRENT_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc)
    if engine.paged:
        raise AssertionError(f"{name}: the engine chose the paged cache")
    print(f"[{tag}] contiguous engine (kv_block_size left to the engine: "
          f"{engine.kv_block_size}), {SERVE_SLOTS} slots x {capacity} "
          f"tokens; {RECURRENT_REQUESTS} prompts of {RECURRENT_PROMPT} "
          f"tokens, {RECURRENT_MAX_NEW} new tokens each")
    engine.run([Request(rid=-1, prompt=rng.integers(0, V, 32).astype(
        np.int32), max_new=3)])                  # warm-up
    reqs = [Request(rid=i, prompt=p, max_new=RECURRENT_MAX_NEW)
            for i, p in enumerate(prompts)]
    res = drive(engine, reqs)
    if any(res["launches"].values()):
        raise AssertionError(f"{name}: kernels launched: "
                             f"{json.dumps(res['launches'])}")
    print(f"[{tag}] {res['forwards']} forwards ({len(res['admit_s'])} "
          f"admissions, {len(res['decode_steps'])} decode steps) in "
          f"{res['run_s']:.3f} s; no kernel of the port launched "
          f"({len(res['launches'])} counters at 0)")
    check_requests(reqs, V, RECURRENT_MAX_NEW)
    summary = summarize(tag, res, reqs, cfg.n_layers)
    summary["max_new"] = RECURRENT_MAX_NEW
    summary["prompt_tokens"] = RECURRENT_PROMPT
    # a full-depth prefill and decode step's logits
    cache = init_cache(cfg, 1, capacity, dtype=torch.bfloat16,
                       device="cuda")
    logits, _, _ = forward(model, cfg, rc, {"tokens": torch.as_tensor(
        prompts[0], device="cuda")[None].long()}, mode="prefill",
        cache=cache)
    step, _, _ = forward(model, cfg, rc, {"tokens": logits.argmax(-1)[:,
                                                                     None]},
                         mode="decode", cache=cache, pos=RECURRENT_PROMPT)
    if not bool(torch.isfinite(logits).all() & torch.isfinite(step).all()):
        raise AssertionError(f"{name}: non-finite logits")
    del cache
    for i in range(SERVE_SLOTS):
        engine.admit(Request(rid=100 + i, prompt=prompts[i], max_new=16))
    prof = profile_window(lambda: [engine.step()
                                   for _ in range(RECURRENT_PROFILE_STEPS)])
    engine.run([])
    prof["device_events_per_step"] = \
        prof["device_events"] / RECURRENT_PROFILE_STEPS
    summary["profile_decode"] = prof
    print(f"[profile {tag}] decode x{RECURRENT_PROFILE_STEPS}, "
          f"{SERVE_SLOTS} slots: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_ms']:.2f} ms (share {prof['busy_share']:.3f}), "
          f"{prof['device_events_per_step']:.0f} device activities a step")
    for kname, calls, ms in prof["top_device"]:
        print(f"    device {ms:9.3f} ms {calls:5d}x  {kname[:70]}")
    for kname, calls, ms in prof["top_cpu"]:
        print(f"    host   {ms:9.3f} ms {calls:5d}x  {kname[:70]}")
    summary.update({"peak_bytes": torch.cuda.max_memory_allocated(),
                    "allocated_before_load_bytes": before})
    print(f"[{tag}] peak device memory {summary['peak_bytes'] / 1e9:.2f} GB "
          f"(load and serving; {before / 1e9:.2f} GB of it allocated before "
          f"the load by earlier phases)")
    out["serve"] = summary
    del engine
    torch.cuda.empty_cache()
    out["fp32_check"] = recurrent_fp32_check(tag, cfg, model, prompts)
    if name == "zamba2-7b":
        out["prime_prefill"] = prime_prefill(cfg, model, rng)
    if name in LONG_LAYERS:          # rwkv6: a block a layer
        depth = LONG_LAYERS[name]
        out["prefill_long"] = prefill_long(cfg.replace(n_layers=depth),
                                           truncated(model, depth), rng)
    else:
        out["prefill_long"] = prefill_long(cfg, model, rng)
    del model
    torch.cuda.empty_cache()
    return out


def vlm_image(rng, rows: int, cfg):
    """Random non-zero image embeddings (rows, n_image_tokens, d_model)
    fp32 on the CPU: make_batch's N(0, 1) * IMAGE_SCALE."""
    import numpy as np
    import torch
    return torch.from_numpy((rng.standard_normal(
        (rows, cfg.n_image_tokens, cfg.d_model)) * IMAGE_SCALE
    ).astype(np.float32))


def vlm_image_effect(cfg, model, rc, prompt, rng) -> dict:
    """A full-depth prefill of ``prompt`` and one decode step (the same
    token) with random non-zero image embeddings and with zero ones: every
    logit finite, the two runs' logits differ at prefill and at decode, and
    the random image leaves a non-zero cross cache."""
    import torch
    from repro_torch.models.lm import forward, init_cache, layer_kinds
    cross = layer_kinds(cfg).index("cross")
    img = vlm_image(rng, 1, cfg).cuda()
    tok = torch.as_tensor(prompt, device="cuda")[None].long()
    runs = {}
    for name, image in (("zero", torch.zeros_like(img)), ("random", img)):
        cache = init_cache(cfg, 1, len(prompt) + 2, dtype=torch.bfloat16,
                           device="cuda")
        pre, _, _ = forward(model, cfg, rc, {"tokens": tok,
                                             "image_embeds": image},
                            mode="prefill", cache=cache)
        dec, _, _ = forward(model, cfg, rc, {"tokens": tok[:, :1]},
                            mode="decode", cache=cache, pos=len(prompt))
        runs[name] = (pre.float(), dec.float(),
                      float(cache[cross]["k"].abs().max()))
        del cache
    (pz, dz, kz), (pr, dr, kr) = runs["zero"], runs["random"]
    if not all(bool(torch.isfinite(t).all()) for t in (pz, dz, pr, dr)):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    out = {"prefill_logits_max_abs_diff": float((pr - pz).abs().max()),
           "decode_logits_max_abs_diff": float((dr - dz).abs().max()),
           "cross_cache_max_abs": {"zero": kz, "random": kr}}
    if not (out["prefill_logits_max_abs_diff"] > 0
            and out["decode_logits_max_abs_diff"] > 0 and kr > 0 and kz == 0):
        raise AssertionError(f"{cfg.name}: the image changed nothing: "
                             f"{json.dumps(out)}")
    print(f"[serve vlm] full depth, bf16, one prompt of {len(prompt)} "
          f"tokens: random image embeddings against zero ones change the "
          f"prefill logits by up to {out['prefill_logits_max_abs_diff']:.3f}"
          f" and a decode step's by up to "
          f"{out['decode_logits_max_abs_diff']:.3f}; the first cross "
          f"block's cached image K max |k| {kr:.3f} (zero image: {kz:g}); "
          f"every logit finite")
    return out


def vlm_fp32_check(cfg, model, prompts, rng) -> dict:
    """An fp32 copy of the first group (``cross_attn_every`` layers, the
    cross block second from the end) on the card against the same copy on
    the CPU: VLM_CHECK_PROMPT tokens of two prompts in one batch with the
    same random image embeddings, prefill logits within VLM_CHECK_TOL and
    VLM_CHECK_NEW greedy tokens equal."""
    import numpy as np
    import torch
    from repro_torch.models.lm import (RunConfig, forward, init_cache,
                                       layer_kinds)
    cfg_c = cfg.replace(n_layers=cfg.cross_attn_every)
    kinds = layer_kinds(cfg_c)
    head = truncated(model, len(kinds))
    if [b.kind for b in head.layers] != kinds or "cross" not in kinds:
        raise AssertionError(f"{cfg.name}: the first {len(kinds)} blocks "
                             f"are not a group {kinds}")
    card = copy.deepcopy(head).float()
    cpu = copy.deepcopy(head).cpu().float()      # the same weights, exactly
    rc = RunConfig(compute_dtype=torch.float32)
    P, n_new = VLM_CHECK_PROMPT, VLM_CHECK_NEW
    toks = torch.as_tensor(np.stack([p[:P] for p in prompts[:2]]
                                    ).astype(np.int64))
    img = vlm_image(rng, 2, cfg)

    def greedy(m, dev):
        t0 = time.perf_counter()
        cache = init_cache(cfg_c, 2, P + n_new + 1, device=dev)
        logits, _, _ = forward(m, cfg_c, rc, {"tokens": toks.to(dev),
                                              "image_embeds": img.to(dev)},
                               mode="prefill", cache=cache)
        first, tok = logits.cpu(), logits.argmax(-1)
        out = [tok]
        for i in range(n_new - 1):
            logits, _, _ = forward(m, cfg_c, rc, {"tokens": tok[:, None]},
                                   mode="decode", cache=cache, pos=P + i)
            tok = logits.argmax(-1)
            out.append(tok)
        return first, torch.stack(out, 1).cpu().tolist(), \
            time.perf_counter() - t0
    got, got_toks, card_s = greedy(card, "cuda")
    want, want_toks, cpu_s = greedy(cpu, "cpu")
    torch.testing.assert_close(got, want, **VLM_CHECK_TOL)
    err = (got - want).abs().max().item()
    if got_toks != want_toks:
        raise AssertionError(f"{cfg.name}: greedy tokens on the card "
                             f"{got_toks} against the CPU's {want_toks}")
    print(f"[serve vlm] fp32, its first group ({len(kinds)} layers: "
          f"{', '.join(kinds)}), 2 prompts of {P} tokens and random image "
          f"embeddings: prefill logits on the card against the CPU "
          f"max_abs_err {err:.3e} (tolerance rtol=atol="
          f"{VLM_CHECK_TOL['atol']:g}; card {card_s:.2f} s, CPU {cpu_s:.2f}"
          f" s for the prefill and {n_new - 1} decode steps); {n_new} greedy "
          f"tokens equal: {got_toks}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"layers": len(kinds), "prompt_tokens": P, "max_abs_err": err,
            "tokens": got_toks, "card_s": card_s, "cpu_s": cpu_s}


def serve_vlm(rng) -> dict:
    """[serve vlm]: llama-3.2-vision-11b at full width and depth, random
    bf16 weights, through ``ServeEngine`` as the launcher builds it
    (``kv_block_size`` left to the engine: contiguous, for the cross
    blocks' image K/V), VLM_REQUESTS prompts of VLM_PROMPT tokens: every
    request completes with tokens in the vocabulary and no kernel of the
    port launches (the counters stay 0); prefill ms a request, decode ms a
    step, tokens/s, peak memory, a profile of VLM_PROFILE_STEPS decode
    steps on 2 slots.  Then ``vlm_image_effect`` and ``vlm_fp32_check``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunConfig, init_params, layer_kinds
    from repro_torch.serve.engine import Request, ServeEngine
    tag = "serve vlm"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()       # earlier phases' tensors
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = layer_kinds(cfg)
    print(f"[{tag}] {cfg.name} ({cfg.family}) at full width (d_model="
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads"
          f" of {cfg.head_dim}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, "
          f"{cfg.n_image_tokens} image tokens); {cfg.n_layers} layers ("
          + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
          + f"); {n_params / 1e9:.3f} B parameters ({n_params * 2 / 1e9:.2f} "
          f"GB bf16), random, seed 0, initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != VLM_PARAMS:
        raise AssertionError(f"{cfg.name} holds {n_params} parameters, not "
                             f"the reference's {VLM_PARAMS}")
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, VLM_PROMPT).astype(np.int32)
               for _ in range(VLM_REQUESTS)]
    capacity = VLM_PROMPT + VLM_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc)
    if engine.paged:
        raise AssertionError(f"{cfg.name}: the engine chose the paged cache")
    print(f"[{tag}] contiguous engine (kv_block_size left to the engine: "
          f"{engine.kv_block_size}), {SERVE_SLOTS} slots x {capacity} "
          f"tokens; {VLM_REQUESTS} prompts of {VLM_PROMPT} tokens, "
          f"{VLM_MAX_NEW} new tokens each; zero image embeddings, as the "
          f"engine feeds")
    engine.run([Request(rid=-1, prompt=rng.integers(0, V, 32).astype(
        np.int32), max_new=3)])                  # warm-up
    reqs = [Request(rid=i, prompt=p, max_new=VLM_MAX_NEW)
            for i, p in enumerate(prompts)]
    res = drive(engine, reqs)
    if any(res["launches"].values()):
        raise AssertionError(f"{cfg.name}: kernels launched: "
                             f"{json.dumps(res['launches'])}")
    print(f"[{tag}] {res['forwards']} forwards ({len(res['admit_s'])} "
          f"admissions, {len(res['decode_steps'])} decode steps) in "
          f"{res['run_s']:.3f} s; no kernel of the port launched "
          f"({len(res['launches'])} counters at 0)")
    check_requests(reqs, V, VLM_MAX_NEW)
    summary = summarize(tag, res, reqs, cfg.n_layers)
    summary.update({"max_new": VLM_MAX_NEW, "prompt_tokens": VLM_PROMPT,
                    "n_params": n_params})
    seconds = {"load_and_serve": time.perf_counter() - t0}
    t1 = time.perf_counter()
    for i in range(SERVE_SLOTS):
        engine.admit(Request(rid=100 + i, prompt=prompts[i], max_new=16))
    prof = profile_window(lambda: [engine.step()
                                   for _ in range(VLM_PROFILE_STEPS)])
    engine.run([])
    seconds["profile"] = time.perf_counter() - t1
    prof["device_events_per_step"] = prof["device_events"] / VLM_PROFILE_STEPS
    summary["profile_decode"] = prof
    print(f"[profile {tag}] decode x{VLM_PROFILE_STEPS}, {SERVE_SLOTS} "
          f"slots: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_ms']:.2f} ms (share {prof['busy_share']:.3f}), "
          f"{prof['device_events_per_step']:.0f} device activities a step")
    for kname, calls, ms in prof["top_device"]:
        print(f"    device {ms:9.3f} ms {calls:5d}x  {kname[:70]}")
    for kname, calls, ms in prof["top_cpu"]:
        print(f"    host   {ms:9.3f} ms {calls:5d}x  {kname[:70]}")
    summary.update({"peak_bytes": torch.cuda.max_memory_allocated(),
                    "allocated_before_load_bytes": before})
    print(f"[{tag}] peak device memory {summary['peak_bytes'] / 1e9:.2f} GB "
          f"(load and serving; {before / 1e9:.2f} GB of it allocated before "
          f"the load by earlier phases)")
    del engine
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    summary["image_effect"] = vlm_image_effect(cfg, model, rc, prompts[0],
                                               rng)
    seconds["image_effect"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    summary["fp32_check"] = vlm_fp32_check(cfg, model, prompts, rng)
    seconds["fp32_check"] = time.perf_counter() - t1
    summary["phase_seconds"] = seconds
    print(f"[{tag}] host seconds of the phase's parts: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    del model
    torch.cuda.empty_cache()
    return summary


def train_family(tag: str, cfg, n_params: int, batch: int, seq: int,
                 steps: int) -> dict:
    """``cfg`` (fp32 parameters and AdamW moments, bf16 compute, remat)
    through ``train()`` for ``steps`` steps of ``make_batch``'s batch x seq:
    every loss finite, no kernel of the port launched, the parameter count
    ``n_params``; the step time from the logged steps after the first and
    the peak.  Returns (summary, the trained model)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   remat=True)
    opt = OptConfig(total_steps=steps, warmup_steps=1)
    stamps = []

    def log(line):
        if line.startswith("[train] step"):  # after the metrics' sync
            stamps.append(time.perf_counter())
        print(f"[{tag}] {line}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train(cfg, rc, opt, steps=steps, batch=batch, seq=seq, seed=0,
                log_every=1, log=log, device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"[{tag}] kernels launched: "
                             f"{dict(ops.LAUNCHES)}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] losses {losses}")
    model = out["state"]["params"]
    n = sum(p.numel() for p in model.parameters())
    if n != n_params:
        raise AssertionError(f"[{tag}] {n} parameters, not the reference's "
                             f"{n_params}")
    step_ms = [float(v) for v in np.diff(stamps) * 1e3]
    med = float(np.median(step_ms))
    summary = {"arch": cfg.name, "layers": cfg.n_layers, "n_params": n,
               "batch": batch, "seq": seq, "losses": losses,
               "step_ms_after_first": step_ms, "step_ms_median": med,
               "tokens_per_s": batch * seq / med * 1e3,
               "train_s_with_init": total_s, "peak_bytes": peak,
               "resident_before_bytes": before,
               "state_bytes": torch.cuda.memory_allocated()}
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, {n / 1e9:.4f} B fp32 "
          f"parameters, bf16 compute, remat, batch {batch} x {seq}: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + "; steps after the "
          "first " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" ms ({summary['tokens_per_s']:.0f} tokens/s); peak device "
          f"memory {peak / 1e9:.2f} GB; no kernel of the port launched; "
          f"{total_s:.1f} s with the initialisation")
    return summary, out["state"]


def train_hubert() -> dict:
    """[train hubert]: hubert-xlarge at full width and depth through
    ``train_family`` (masked prediction on make_batch's frames), one step
    of its first AUDIO_PROFILE_LAYERS layers under the profiler, then the
    fp32 check of AUDIO_CHECK_LAYERS layers on the card against the CPU
    (loss and every gradient within DENSE_CHECK_TOL)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = get_config(AUDIO_ARCH)
    B, S, n = AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_STEPS
    print(f"[train hubert] {cfg.name} at full width and all {cfg.n_layers} "
          f"layers (d_model={cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, bidirectional, no RoPE, layernorm, gelu_mlp, "
          f"d_ff={cfg.d_ff}, {cfg.vocab_size} codebook labels), masked "
          f"prediction on make_batch's {B} x {S} frames; {n} steps through "
          f"train(), random weights, seed 0")
    summary, state = train_family("train hubert", cfg, AUDIO_PARAMS, B, S, n)
    model = state["params"]
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   remat=True)
    cfg_p = cfg.replace(n_layers=AUDIO_PROFILE_LAYERS)
    head = train_state(truncated(model, AUDIO_PROFILE_LAYERS))
    step_fn = make_train_step(cfg_p, rc, OptConfig(total_steps=n,
                                                   warmup_steps=1))
    batch = device_batch(make_batch(cfg, B, S, step=n, seed=1), "cuda")
    step_fn(head, batch)                       # its moments' first step
    prof = profile_window(lambda: step_fn(head, batch), top=12)
    summary["profile"] = {"layers": AUDIO_PROFILE_LAYERS, **prof}
    print(f"[profile train hubert] one step with remat, the first "
          f"{AUDIO_PROFILE_LAYERS} of {cfg.n_layers} layers: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
          f"(share {prof['busy_share']:.3f}), {prof['device_events']} device "
          f"activities")
    for name, calls, t in prof["top_device"]:
        print(f"    device {t:9.3f} ms {calls:5d}x  {name[:70]}")
    del head, step_fn, batch, state, model
    torch.cuda.empty_cache()
    summary["check_fp32"] = fp32_train_check(
        "train hubert", cfg.replace(n_layers=AUDIO_CHECK_LAYERS),
        AUDIO_CHECK_BATCH, AUDIO_CHECK_SEQ)
    return summary


def train_vlm() -> dict:
    """[train vlm]: llama-3.2-vision-11b at full width cut to its first
    group (cross_attn_every layers, the cross block included) through
    ``train_family``: VLM_TRAIN_STEPS steps of VLM_TRAIN_BATCH x
    VLM_TRAIN_SEQ tokens with make_batch's image embeddings."""
    import torch
    from repro_torch.configs import get_config
    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=full.cross_attn_every)
    print(f"[train vlm] {cfg.name} at full width, cut from {full.n_layers} "
          f"to {cfg.n_layers} layers (its first group, the cross block "
          f"{cfg.n_layers - 1}th), {VLM_TRAIN_BATCH} x {VLM_TRAIN_SEQ} "
          f"tokens and make_batch's {cfg.n_image_tokens} image embeddings a "
          f"row; {VLM_TRAIN_STEPS} steps through train()")
    summary, state = train_family("train vlm", cfg, VLM_GROUP_PARAMS,
                                  VLM_TRAIN_BATCH, VLM_TRAIN_SEQ,
                                  VLM_TRAIN_STEPS)
    del state
    torch.cuda.empty_cache()
    return summary


def meta_params(cfg) -> int:
    """``cfg``'s parameter count, from a model on the meta device."""
    import torch
    from repro_torch.models.lm import LM
    return sum(p.numel() for p in LM(cfg, None, torch.float32,
                                     torch.device("meta")).parameters())


def fwd_bwd_peak(cfg, model, rc, batch: dict) -> dict:
    """One forward and backward of ``model`` (gradients of every
    parameter, no optimizer step): its host ms (ending in a synchronise)
    and its peak device memory above what was allocated before."""
    import torch
    from repro_torch.models.lm import loss_fn
    params = [p for p in model.parameters() if p.requires_grad]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, cfg, rc, batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    loss = loss.detach()
    out = {"ms": ms, "loss": float(loss),
           "peak_above_bytes": torch.cuda.max_memory_allocated() - base,
           "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
           # what stays allocated: the gradients and the scalar loss
           "grad_alloc_bytes": torch.cuda.memory_allocated() - base,
           "grad_tensors": len(grads)}
    del loss, grads
    return out


def train_rwkv6() -> dict:
    """[train rwkv6]: rwkv6-1.6b at full width and all its layers through
    ``train_family`` (RWKV_TRAIN_STEPS steps of RWKV_TRAIN_BATCH x
    RWKV_TRAIN_SEQ tokens, bf16 compute, remat); one step of its first
    RWKV_PROFILE_LAYERS layers under the profiler; one forward + backward
    of its first RWKV_PEAK_LAYERS layers at the training batch with and
    without remat (ms, peak); the fp32 check of RWKV_CHECK_LAYERS layers
    card vs CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import make_train_step, train_state
    cfg = get_config(RWKV_ARCH)
    B, S, n = RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS
    print(f"[train rwkv6] {cfg.name} at full width and all {cfg.n_layers} "
          f"layers (d_model={cfg.d_model}, {cfg.d_model // cfg.rwkv.head_size}"
          f" WKV heads of {cfg.rwkv.head_size}, d_ff={cfg.d_ff}, vocab="
          f"{cfg.vocab_size}), fp32 parameters and AdamW moments, bf16 "
          f"compute, remat, batch {B} x seq {S}; {n} steps through train(), "
          f"random weights, seed 0; the WKV recurrence one step a position "
          f"(no kernel of the port on this path)")
    summary, state = train_family("train rwkv6", cfg, meta_params(cfg), B, S,
                                  n)
    model = state["params"]
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   remat=True)
    cfg_p = cfg.replace(n_layers=RWKV_PROFILE_LAYERS)
    head = train_state(truncated(model, RWKV_PROFILE_LAYERS))
    step_fn = make_train_step(cfg_p, rc, OptConfig(total_steps=n,
                                                   warmup_steps=1))
    batch = device_batch(make_batch(cfg, B, S, step=n, seed=1), "cuda")
    step_fn(head, batch)                       # its moments' first step
    prof = profile_window(lambda: step_fn(head, batch), top=12)
    summary["profile"] = {"layers": RWKV_PROFILE_LAYERS, **prof}
    print(f"[profile train rwkv6] one step with remat, the first "
          f"{RWKV_PROFILE_LAYERS} of {cfg.n_layers} layers: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
          f"(share {prof['busy_share']:.3f}), {prof['device_events']} device "
          f"activities ({prof['device_events'] / RWKV_PROFILE_LAYERS:.0f} a "
          f"layer, {prof['device_events'] / RWKV_PROFILE_LAYERS / S:.1f} a "
          f"layer and position)")
    for name, calls, t in prof["top_device"]:
        print(f"    device {t:9.3f} ms {calls:5d}x  {name[:70]}")
    del head, step_fn, batch
    torch.cuda.empty_cache()
    # the first RWKV_PEAK_LAYERS layers' forward + backward with and without
    # remat at the training batch, on the trained weights
    cfg_k = cfg.replace(n_layers=RWKV_PEAK_LAYERS)
    head = truncated(model, RWKV_PEAK_LAYERS)
    batch = device_batch(make_batch(cfg, B, S, step=0, seed=1), "cuda")
    peaks = {}
    for remat in (True, False):
        ops.reset_launches()
        peaks["remat" if remat else "no_remat"] = fwd_bwd_peak(
            cfg_k, head, rc._replace(remat=remat), batch)
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"[train rwkv6] kernels launched: "
                                 f"{dict(ops.LAUNCHES)}")
        torch.cuda.empty_cache()
    summary["fwd_bwd"] = {"layers": RWKV_PEAK_LAYERS, "batch": B, "seq": S,
                          **peaks}
    r, nr = peaks["remat"], peaks["no_remat"]
    print(f"[train rwkv6] one forward + backward of the first "
          f"{RWKV_PEAK_LAYERS} of {cfg.n_layers} layers, batch {B} x seq "
          f"{S}: with remat {r['ms']:.1f} ms, peak "
          f"{r['peak_above_bytes'] / 1e9:.2f} GB above the state; without "
          f"{nr['ms']:.1f} ms, peak {nr['peak_above_bytes'] / 1e9:.2f} GB "
          f"(its gradients {r['grad_bytes'] / 1e9:.2f} GB of each); losses "
          f"{r['loss']:.4f}, {nr['loss']:.4f}; {smi_line()}")
    if not np.isfinite([r["loss"], nr["loss"]]).all():
        raise AssertionError("[train rwkv6] non-finite forward + backward")
    del state, model, head, batch
    torch.cuda.empty_cache()
    summary["check_fp32"] = fp32_train_check(
        "train rwkv6", cfg.replace(n_layers=RWKV_CHECK_LAYERS),
        RWKV_CHECK_BATCH, RWKV_CHECK_SEQ)
    return summary


def train_zamba2() -> dict:
    """[train zamba2]: zamba2-7b at full width cut to ZAMBA_TRAIN_LAYERS
    Mamba2 layers through ``train_family``; then one forward + backward of
    the whole depth with remat and no optimizer step (fp32 weights, bf16
    compute) at ZAMBA_FULL_BATCH rows: ms and peak, or, where it does not
    fit, the bytes it asked for and the depth it cut to; the fp32 check of
    ZAMBA_CHECK_LAYERS layers card vs CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, init_params, layer_kinds
    full = get_config(ZAMBA_ARCH)
    cfg = full.replace(n_layers=ZAMBA_TRAIN_LAYERS)
    B, S, n = ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_SEQ, ZAMBA_TRAIN_STEPS
    kinds = layer_kinds(cfg)
    print(f"[train zamba2] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"Mamba2 state {cfg.ssm.d_state}, heads of {cfg.ssm.head_dim}, "
          f"attention {cfg.n_heads} x {cfg.head_dim}), cut from "
          f"{full.n_layers} to {cfg.n_layers} Mamba2 layers ({len(kinds)} "
          f"blocks: {kinds.count('shared_attn')} attention applications, "
          f"both shared blocks and the suffix's own), fp32 parameters and "
          f"AdamW moments, bf16 compute, remat, batch {B} x seq {S}; {n} "
          f"steps through train(), random weights, seed 0")
    summary, state = train_family("train zamba2", cfg, meta_params(cfg), B,
                                  S, n)
    del state
    torch.cuda.empty_cache()
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   remat=True)
    summary["full_depth"] = {}
    for layers in (full.n_layers,) + ZAMBA_FULL_FALLBACK:
        c = full.replace(n_layers=layers)
        model = None
        resident = torch.cuda.memory_allocated()   # earlier phases' bytes
        try:
            model = init_params(c, 0, device="cuda")
            model.requires_grad_(True)
            weights = torch.cuda.memory_allocated() - resident
            batch = device_batch(make_batch(c, ZAMBA_FULL_BATCH, S, step=0,
                                            seed=1), "cuda")
            ops.reset_launches()
            res = fwd_bwd_peak(c, model, rc, batch)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[train zamba2] {layers} Mamba2 layers do not fit: "
                  f"{str(e).splitlines()[0]}")
            summary["full_depth"][str(layers)] = {"oom": str(e)[:300]}
            del model
            torch.cuda.empty_cache()
            continue
        if any(ops.LAUNCHES.values()) or not np.isfinite(res["loss"]):
            raise AssertionError(f"[train zamba2] {layers} layers: loss "
                                 f"{res['loss']}, launches "
                                 f"{dict(ops.LAUNCHES)}")
        n_p = sum(p.numel() for p in model.parameters())
        res.update(layers=layers, n_params=n_p, weight_bytes=weights,
                   weight_tensors=len(list(model.parameters())),
                   resident_bytes=resident,
                   peak_bytes=resident + weights + res["peak_above_bytes"],
                   batch=ZAMBA_FULL_BATCH, seq=S)
        summary["full_depth"] = res
        print(f"[train zamba2] one forward + backward with remat and no "
              f"optimizer step at {layers} of {full.n_layers} Mamba2 layers "
              f"({n_p / 1e9:.3f} B fp32 parameters, {weights / 1e9:.2f} GB), "
              f"batch {ZAMBA_FULL_BATCH} x seq {S}: {res['ms']:.1f} ms, loss "
              f"{res['loss']:.4f}, gradients {res['grad_bytes'] / 1e9:.2f} "
              f"GB, peak device memory {res['peak_bytes'] / 1e9:.2f} GB "
              f"({resident / 1e9:.2f} GB of it allocated before the model by "
              f"earlier phases); AdamW's two moments would add "
              f"{8 * n_p / 1e9:.1f} GB; "
              f"{smi_line()}")
        del model, batch
        torch.cuda.empty_cache()
        break
    summary["check_fp32"] = fp32_train_check(
        "train zamba2", full.replace(n_layers=ZAMBA_CHECK_LAYERS),
        ZAMBA_CHECK_BATCH, ZAMBA_CHECK_SEQ)
    return summary


def family_sharded(group, ckpt: str) -> dict:
    """[train sharded]'s late families on this rank (``sharded_rank`` runs
    it after moonshot's grids): for each of FAMILY_SHARDED, rank 0 runs the
    single rank's fp32 check step and writes its parameters whole under
    ``ckpt``, then both ranks run the step on each grid of SHARDED_GRIDS
    and hold every block of their parameters after it against the written
    ones.  Returns Python values."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, local_batch, make_batch
    from repro_torch.distributed.group import make_grid
    from repro_torch.distributed.sharding import batch_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step
    dev = group.device
    rc = RunConfig(compute_dtype=torch.float32, loss_chunk=LOSS_CHUNK)
    opt = OptConfig(**SHARDED_CHECK_OPT)
    out = {}
    for arch, layers in FAMILY_SHARDED:
        cfg = get_config(arch).replace(n_layers=layers)
        root = str(pathlib.Path(ckpt) / arch)
        host = make_batch(cfg, SHARDED_CHECK_BATCH, SHARDED_CHECK_SEQ,
                          step=0, seed=1)
        res = {"grids": {}}
        if group.rank == 0:
            t0 = time.perf_counter()
            state = init_train_state(cfg, 0, rc, device=dev)
            res["n_params"] = sum(p.numel()
                                  for p in state["params"].parameters())
            ops.reset_launches()
            state, m = make_train_step(cfg, rc, opt)(
                state, device_batch(host, dev))
            torch.cuda.synchronize(dev)
            res["single"] = {"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "launches": dict(ops.LAUNCHES)}
            shutil.rmtree(root, ignore_errors=True)
            mgr = CheckpointManager(root, keep_last=1, async_save=False)
            mgr.save(0, {"params": dict(state["params"].named_parameters())})
            res["single"]["write_bytes"] = mgr.stats["bytes"]
            res["single"]["s"] = time.perf_counter() - t0
            del state, m, mgr
            torch.cuda.empty_cache()
        group.barrier()
        for data, model, _ in SHARDED_GRIDS:
            name = f"{data}x{model}"
            grid = make_grid(data, model, device=dev, verbose=False)
            t0 = time.perf_counter()
            state = init_train_state(cfg, 0, rc, device=dev, grid=grid)
            torch.cuda.empty_cache()
            step = make_train_step(cfg, rc, opt, grid=grid)
            b = device_batch(local_batch(host, grid, batch_specs(
                cfg, grid, "train", SHARDED_CHECK_BATCH), cfg), dev)
            grid.world.barrier()
            ops.reset_launches()
            t1 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize(dev)
            step_ms = (time.perf_counter() - t1) * 1e3
            blocks = dict(state["params"].named_parameters())
            specs = state["params"].shard_specs
            want = {"params": {n: torch.empty_like(p)
                               for n, p in blocks.items()}}
            CheckpointManager(root).restore(
                want, 0, shardings={f"params/{n}": sp
                                    for n, sp in specs.items()}, grid=grid)
            errs = {n: float((p.detach() - want["params"][n]).abs().max())
                    for n, p in blocks.items()}
            worst = max(errs, key=errs.get)
            res["grids"][name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "max_abs_err": errs[worst], "worst": worst,
                "launches": dict(ops.LAUNCHES), "step_ms": step_ms,
                "s": time.perf_counter() - t0}
            del state, step, b, blocks, want
            torch.cuda.empty_cache()
            grid.world.barrier()
        if group.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        out[arch] = res
    return out


def report_sharded_families(ranks: list) -> dict:
    """[train sharded]'s late families from every rank's
    ``family_sharded``: each grid's fp32 step within [train sharded]'s
    tolerances of the single rank's (loss, grad_norm relative, every
    parameter after the step), no kernel launched.  The recurrent families
    run on the ssm rules (heads split over 'model'), the vlm and hubert
    under sequence parallelism."""
    out = {}
    for arch, layers in FAMILY_SHARDED:
        single = ranks[0][arch]["single"]
        rows = {}
        for data, model, _ in SHARDED_GRIDS:
            name = f"{data}x{model}"
            got = [r[arch]["grids"][name] for r in ranks]
            for rank, c in enumerate(got):
                gn_rel = abs(c["grad_norm"] - single["grad_norm"]) \
                    / single["grad_norm"]
                if abs(c["loss"] - single["loss"]) > SHARDED_LOSS_TOL \
                        or c["max_abs_err"] > SHARDED_PARAM_TOL \
                        or not gn_rel <= SHARDED_GNORM_RTOL \
                        or any(c["launches"].values()):
                    raise AssertionError(
                        f"[train sharded] {arch} {name} rank {rank}: loss "
                        f"{c['loss']} against the single rank's "
                        f"{single['loss']}, grad_norm {c['grad_norm']} "
                        f"against {single['grad_norm']} (relative "
                        f"{gn_rel:.3e}), parameters after the step "
                        f"max_abs_err {c['max_abs_err']:.3e} "
                        f"({c['worst']}), launches {c['launches']}")
            rows[name] = got
            print(f"[train sharded] {arch} at full width, {layers} layers "
                  f"({ranks[0][arch]['n_params'] / 1e9:.3f} B fp32 "
                  f"parameters), grid {name}, fp32 step of batch "
                  f"{SHARDED_CHECK_BATCH} x seq {SHARDED_CHECK_SEQ}: loss "
                  f"{got[0]['loss']:.6f} (single rank {single['loss']:.6f}, "
                  f"tolerance {SHARDED_LOSS_TOL:g}), grad_norm "
                  + ", ".join(f"{c['grad_norm']:.6f}" for c in got)
                  + f" (single {single['grad_norm']:.6f}, relative "
                  f"{SHARDED_GNORM_RTOL:g}), every parameter after the step "
                  f"within " + ", ".join(f"{c['max_abs_err']:.2e} "
                                         f"({c['worst']})" for c in got)
                  + f" (tolerance {SHARDED_PARAM_TOL:g}); step ms "
                  + ", ".join(f"{c['step_ms']:.1f}" for c in got)
                  + f"; no kernel launched; {smi_line()}")
        out[arch] = {"layers": layers, "single": single,
                     "n_params": ranks[0][arch]["n_params"], "grids": rows}
    return out


def moe_layer_backward_no_sync(policy: str) -> dict:
    """``moe_ffn`` forward and backward at moonshot's training shape (T =
    TRAIN_BATCH x TRAIN_SEQ, bf16 experts and activations) under
    ``set_sync_debug_mode("error")``: no host sync anywhere in the layer's
    backward.  Returns the launches of the synced run."""
    import torch
    from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
    from repro_torch.kernels import ops
    s, T = MOONSHOT, TRAIN_BATCH * TRAIN_SEQ
    E, d, f = s["E"], s["d"], s["f"]
    g = torch.Generator(device="cuda").manual_seed(400)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype).requires_grad_(True)
    args = (randn(T, d), randn(d, E, scale=d ** -0.5, dtype=torch.float32),
            randn(E, d, f, scale=d ** -0.5), randn(E, d, f, scale=d ** -0.5),
            randn(E, f, d, scale=f ** -0.5))
    proj = torch.randn((T, d), generator=g, device="cuda")
    cfg = MoEDispatchConfig(n_experts=E, top_k=s["k"], block_m=s["M"],
                            executor="cuda", gating=s["gating"],
                            norm_topk=s["norm_topk"],
                            routed_scale=s["routed_scale"],
                            schedule_policy=policy,
                            capacity_factor=CAPACITY_FACTOR)

    def step():
        y, aux = moe_ffn(*args, cfg)
        loss = ((y.float() * proj).sum() + 0.01 * aux["lb_loss"]
                + 1e-4 * aux["router_z"])
        return torch.autograd.grad(loss, args)
    step()                                   # warm
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if not all(torch.isfinite(gr).all() for gr in grads):
        raise AssertionError(f"moe_ffn backward ({policy}): non-finite grad")
    print(f"[train moe_ffn] moonshot T={T} bf16 {policy}: forward + backward"
          f" with no host sync under set_sync_debug_mode('error'); launches "
          f"{json.dumps(launches)}")
    return launches


def train_grads_vs_plain(compute: str) -> dict:
    """One step's loss and gradients of moonshot at full width cut to
    TRAIN_CHECK_LAYERS layers (1 dense + 1 MoE), fp32 parameters and
    ``compute`` ("float32" or "bfloat16") compute, ``fixed``, batch
    TRAIN_CHECK_BATCH x TRAIN_CHECK_SEQ: on the kernels (the ``cuda``
    executor's autograd Functions) against autograd through the plain
    versions (this script's ``plain`` executor).  The loss within
    TRAIN_CHECK_TOL[compute]'s relative ``loss``; each parameter's gradient
    within its ``grad`` times the largest magnitude of its plain gradient.
    In bf16 the two sides round their bf16 intermediates (h, dg, du, the
    dX products, dW cast to the bf16 expert copy) after sums taken in other
    orders, so they differ by bf16 ulps that the backward carries on."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, init_params, loss_fn
    tol = TRAIN_CHECK_TOL[compute]
    cfg = get_config("moonshot-v1-16b-a3b").replace(
        n_layers=TRAIN_CHECK_LAYERS)
    model = init_params(cfg, 0, device="cuda").requires_grad_(True)
    params = dict(model.named_parameters())
    batch = device_batch(make_batch(cfg, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                                    step=0, seed=1), "cuda")
    rc = RunConfig(compute_dtype=getattr(torch, compute),
                   loss_chunk=LOSS_CHUNK)
    out = {}
    for ex in ("cuda", "plain"):
        loss, _ = loss_fn(model, cfg, rc._replace(executor=ex), batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[ex] = (loss.detach(), grads)
        del loss
    (loss, grads), (loss_p, grads_p) = out["cuda"], out["plain"]
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    if loss_err > tol["loss"]:
        raise AssertionError(f"train loss ({compute}): {float(loss):.6f} on "
                             f"the kernels, {float(loss_p):.6f} plain")
    rel = {}
    for name, g, gp in zip(params, grads, grads_p):
        scale = gp.abs().max().item()
        err = (g - gp).abs().max().item()
        if not torch.isfinite(g).all():
            raise AssertionError(f"train grads ({compute}): {name} not finite")
        if err > tol["grad"] * scale:
            raise AssertionError(f"train grads ({compute}): {name} differs by "
                                 f"{err:.3e} (largest plain magnitude "
                                 f"{scale:.3e})")
        rel[name] = err / scale if scale > 0 else 0.0
    worst_name = max(rel, key=rel.get)
    print(f"[train check] {cfg.name} full width, {cfg.n_layers} layers, "
          f"fp32 parameters, {compute} compute, fixed, batch "
          f"{TRAIN_CHECK_BATCH} x seq {TRAIN_CHECK_SEQ}: loss "
          f"{float(loss):.6f} on the kernels, {float(loss_p):.6f} through "
          f"the plain versions (relative {loss_err:.3e}; tolerance "
          f"{tol['loss']:g}); {len(params)} gradients, worst max|diff| / "
          f"max|plain| {rel[worst_name]:.3e} ({worst_name}; tolerance "
          f"{tol['grad']:g}); per parameter: "
          + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()))
    res = {"compute": compute, "loss": float(loss),
           "loss_plain": float(loss_p), "loss_rel_err": loss_err,
           "worst_rel_grad_err": rel[worst_name], "worst_param": worst_name,
           "rel_grad_err": rel}
    del model, params, grads, grads_p, out
    torch.cuda.empty_cache()
    return res


def check_train_launches(launches: dict, n_moe: int,
                         remat: bool = False) -> None:
    """One training step, per MoE layer: router and fused_gate_up once;
    permute and unpermute twice (each is the other's backward); the dense
    grouped_gemm three times (the down projection and the backward's
    recompute of g and u); B1^T and B7 three times each; nothing else.
    With remat the layer's forward runs again in the backward: router,
    fused_gate_up, permute, unpermute and the down grouped_gemm once more
    each."""
    r = 1 if remat else 0
    want = {"router_topk": (1 + r) * n_moe, "permute": (2 + r) * n_moe,
            "unpermute": (2 + r) * n_moe, "fused_gate_up": (1 + r) * n_moe,
            "grouped_gemm": (3 + r) * n_moe,
            "grouped_gemm_t": 3 * n_moe, "grouped_wgrad": 3 * n_moe}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"training step: {name} launched {n} "
                                 f"times, expected {want.get(name, 0)}")


def train_full_width(layers: int, policy: str = "fixed",
                     remat: bool = False, fit: bool = True,
                     tag: str = "train") -> dict:
    """moonshot at full width cut to ``layers`` layers: TRAIN_STEPS steps of
    batch TRAIN_BATCH x seq TRAIN_SEQ through the port's trainer (fp32
    parameters and AdamW moments, bf16 compute, ``policy`` (capacity_factor
    at CAPACITY_FACTOR, with the sched/* telemetry), ``remat``), one more
    step under the profiler, then with ``fit`` TRAIN_FIT_STEPS steps on the
    first batch again, whose loss must fall."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_state)
    cfg = get_config("moonshot-v1-16b-a3b").replace(n_layers=layers)
    n_moe = n_moe_layers(cfg)
    capacity = policy == "capacity_factor"
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   schedule_policy=policy, capacity_factor=CAPACITY_FACTOR,
                   remat=remat, moe_stats=capacity)
    opt = OptConfig(total_steps=TRAIN_STEPS + 1, warmup_steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, 0, rc, device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    sched_name = (f"capacity_factor {CAPACITY_FACTOR}" if capacity
                  else policy)
    print(f"[{tag}] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff_expert="
          f"{cfg.moe.d_ff_expert}, vocab={cfg.vocab_size}); reduced: n_layers"
          f" 48 -> {layers} (1 dense + {n_moe} MoE); {n_params / 1e9:.3f} B "
          f"parameters, fp32 with fp32 AdamW moments, bf16 compute, "
          f"{sched_name} schedule, remat {remat}, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, loss in strided chunks (loss_chunk {LOSS_CHUNK}); "
          f"random weights, seed 0; the reference's Markov tokens")
    step_fn = make_train_step(cfg, rc, opt)
    batches = [device_batch(make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=i,
                                       seed=1), "cuda")
               for i in range(TRAIN_STEPS + 1)]
    rows = []
    torch.cuda.synchronize()
    ops.reset_launches()
    for i in range(TRAIN_STEPS):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES}
        check_train_launches(launches, n_moe, remat)
        row = {"step": i, **{k: float(v) for k, v in m.items()}, "ms": ms,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "grouped_wgrad_launches": launches["grouped_wgrad"],
               "grouped_gemm_t_launches": launches["grouped_gemm_t"]}
        rows.append(row)
        drop = (f"; sched/drop_fraction {row['sched/drop_fraction'] / n_moe:.4f}"
                f" (mean of {n_moe} MoE layers)" if capacity else "")
        print(f"[{tag}] step {i}: loss {row['loss']:.4f} (ce {row['ce']:.4f})"
              f" grad_norm {row['grad_norm']:.4f} lr {row['lr']:.3e}; "
              f"{ms:.1f} ms ({row['tokens_per_s']:.0f} tokens/s); peak "
              f"memory {row['peak_bytes'] / 1e9:.2f} GB; B7 launches "
              f"{row['grouped_wgrad_launches']}, B1^T "
              f"{row['grouped_gemm_t_launches']}{drop}")
        if not all(np.isfinite(row[k]) for k in ("loss", "ce", "grad_norm")):
            raise AssertionError(f"training step {i}: non-finite loss")
    launches = dict(ops.LAUNCHES)
    prof = profile_window(lambda: step_fn(state, batches[TRAIN_STEPS]),
                          top=16)
    steady = [r["ms"] for r in rows[1:]]
    summary = {"layers": layers, "n_params": n_params, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "policy": policy, "remat": remat,
               "steps": rows, "launches": launches,
               "step_ms_median_after_first": float(np.median(steady)),
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
               / float(np.median(steady)) * 1e3,
               "peak_bytes": max(r["peak_bytes"] for r in rows),
               "profile": prof}
    print(f"[{tag}] {TRAIN_STEPS} steps: median step after the first "
          f"{summary['step_ms_median_after_first']:.1f} ms, "
          f"{summary['tokens_per_s']:.0f} tokens/s, peak device memory "
          f"{summary['peak_bytes'] / 1e9:.2f} GB; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    print(f"[profile {tag}] one step: wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['device_ms']:.2f} ms (share {prof['busy_share']:.3f})")
    for name, calls, ms in prof["top_device"]:
        print(f"    device {ms:9.3f} ms {calls:5d}x  {name[:70]}")
    for name, calls, ms in prof["top_cpu"]:
        print(f"    host   {ms:9.3f} ms {calls:5d}x  {name[:70]}")
    if not fit:
        # the forward and backward alone, with and without remat: the peak
        # above the resident state and gradients' start
        from repro_torch.models.lm import loss_fn
        model = state["params"]
        params = list(model.parameters())
        peaks = {}
        for r in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, _ = loss_fn(model, cfg, rc._replace(remat=r), batches[0])
            grads = torch.autograd.grad(loss, params)
            del loss, grads
            torch.cuda.synchronize()
            peaks[r] = torch.cuda.max_memory_allocated() - base
        summary["fwd_bwd_peak_above_state_bytes"] = {
            "remat": peaks[True], "no_remat": peaks[False]}
        print(f"[{tag}] forward + backward alone (parameters and moments "
              f"resident, {base / 1e9:.2f} GB): peak above them "
              f"{peaks[True] / 1e9:.2f} GB with remat, "
              f"{peaks[False] / 1e9:.2f} GB without")
        del state, batches, model, params
        torch.cuda.empty_cache()
        return summary
    # the model then fits one batch: fresh moments, a constant rate
    model = state["params"]
    del state
    state = train_state(model)
    fit_fn = make_train_step(cfg, rc, OptConfig(
        lr=TRAIN_FIT_LR, warmup_steps=0, total_steps=10 ** 9))
    fit = []
    for i in range(TRAIN_FIT_STEPS):
        state, m = fit_fn(state, batches[0])
        fit.append(float(m["loss"]))
    summary["fit_one_batch"] = {"lr": TRAIN_FIT_LR, "losses": fit}
    print(f"[train fit] the same batch {TRAIN_FIT_STEPS} times at lr "
          f"{TRAIN_FIT_LR:g} from fresh moments: loss before each step "
          + " -> ".join(f"{v:.4f}" for v in fit))
    if not fit[-1] < fit[0]:
        raise AssertionError("training does not lower the loss of the batch "
                             "it steps on")
    del state, model, batches
    torch.cuda.empty_cache()
    return summary


def train_mla(errs: dict) -> dict:
    """[train mla]: deepseek-v2-236b at full width cut to MLA_TRAIN_LAYERS
    layers (1 dense + 1 MoE), fp32 parameters, bf16 compute, ``fixed``, one
    batch of MLA_TRAIN_BATCH x MLA_TRAIN_SEQ: the counts set to 0, one
    forward and backward on the kernels (each kernel's launches checked per
    MoE layer as moonshot's step), its gradients moved to the host, then
    the same through the plain executor: the loss and every gradient within
    TRAIN_CHECK_TOL["bfloat16"].  Then MLA_TRAIN_REPS timed forward and
    backward passes (ms, peak device memory), one under the profiler, and,
    once the model is freed, B7 and B1^T held and timed at this batch's
    T (random routing at deepseek's layer, both orientations).  No AdamW
    step: its state at this width does not fit the card (printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import (RunConfig, init_params, loss_fn,
                                       n_moe_layers)
    cfg = get_config("deepseek-v2-236b").replace(n_layers=MLA_TRAIN_LAYERS)
    n_moe, mla, moe = n_moe_layers(cfg), cfg.mla, cfg.moe
    B, S = MLA_TRAIN_BATCH, MLA_TRAIN_SEQ
    tol = TRAIN_CHECK_TOL["bfloat16"]
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    model = init_params(cfg, 0, device="cuda").requires_grad_(True)
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - before
    n_params = sum(p.numel() for p in model.parameters())
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"[train mla] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"{cfg.n_heads} heads, MLA q_lora {mla.q_lora_rank} / kv_lora "
          f"{mla.kv_lora_rank} / rope {mla.qk_rope_head_dim}, dense FFN "
          f"{moe.d_ff_dense}, {moe.n_experts} experts top-{moe.top_k} + "
          f"{moe.n_shared_experts} shared, d_ff_expert={moe.d_ff_expert}, "
          f"{moe.gating} gating, routed_scale {moe.routed_scale:g}, vocab="
          f"{cfg.vocab_size}); reduced: n_layers 60 -> {cfg.n_layers} (1 "
          f"dense + {n_moe} MoE); {n_params / 1e9:.3f} B parameters, fp32 "
          f"({n_params * 4 / 1e9:.2f} GB), initialised in "
          f"{time.perf_counter() - t0:.1f} s; bf16 compute, fixed, batch {B}"
          f" x seq {S}, attention chunks of {rc.q_chunk}, loss_chunk "
          f"{LOSS_CHUNK}; random weights, seed 0; the reference's Markov "
          f"tokens")
    print(f"[train mla] no AdamW step at this width: fp32 parameters "
          f"{n_params * 4 / 1e9:.1f} GB + gradients {n_params * 4 / 1e9:.1f}"
          f" GB + AdamW's two moments {n_params * 8 / 1e9:.1f} GB = "
          f"{n_params * 16 / 1e9:.1f} GB ({n_params * 16 / 2 ** 30:.1f} GiB)"
          f", past the card's {card / 1e9:.1f} GB ({card / 2 ** 30:.1f} GiB)"
          f" before any activation; the step waits for the state sharded "
          f"over several cards")
    batch = device_batch(make_batch(cfg, B, S, step=0, seed=1), "cuda")
    params = dict(model.named_parameters())

    def fwd_bwd(executor: str = "cuda"):
        loss, _ = loss_fn(model, cfg, rc._replace(executor=executor), batch)
        return loss.detach(), torch.autograd.grad(loss,
                                                  list(params.values()))

    # the main path: every count from 0, one forward and backward
    torch.cuda.synchronize()
    ops.reset_launches()
    loss, grads = fwd_bwd()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check_train_launches(launches, n_moe)
    launches = {k: v for k, v in launches.items() if v}
    grads = [g.to("cpu") for g in grads]       # one gradient set a card
    torch.cuda.empty_cache()
    loss_p, grads_p = fwd_bwd("plain")
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    if loss_err > tol["loss"]:
        raise AssertionError(f"[train mla] loss {float(loss):.6f} on the "
                             f"kernels, {float(loss_p):.6f} plain")
    rel = {}
    for name, g, gp in zip(params, grads, grads_p):
        g = g.to(gp.device)
        scale = gp.abs().max().item()
        err = (g.float() - gp.float()).abs().max().item()
        if not torch.isfinite(g).all():
            raise AssertionError(f"[train mla] {name}: gradient not finite")
        if err > tol["grad"] * scale:
            raise AssertionError(f"[train mla] {name}: gradient differs by "
                                 f"{err:.3e} (largest plain magnitude "
                                 f"{scale:.3e})")
        rel[name] = err / scale if scale > 0 else 0.0
    worst = max(rel, key=rel.get)
    del grads, grads_p, g, gp
    torch.cuda.empty_cache()
    print(f"[train mla] one forward + backward, kernels vs the plain "
          f"executor (same weights and batch; the kernels' gradients on the "
          f"host meanwhile): loss {float(loss):.6f} against "
          f"{float(loss_p):.6f} (relative {loss_err:.3e}; tolerance "
          f"{tol['loss']:g}); {len(params)} gradients, worst max|diff| / "
          f"max|plain| {rel[worst]:.3e} ({worst}; tolerance {tol['grad']:g})"
          "; per parameter: " + ", ".join(f"{n} {r:.2e}"
                                          for n, r in rel.items()))
    per_layer = {k: v / n_moe for k, v in launches.items()}
    print(f"[train mla] launches per MoE layer in that forward + backward: "
          f"B5 router_topk {per_layer.get('router_topk', 0):g}, B3 permute "
          f"{per_layer.get('permute', 0):g}, B2 fused_gate_up "
          f"{per_layer.get('fused_gate_up', 0):g}, B1 grouped_gemm "
          f"{per_layer.get('grouped_gemm', 0):g}, B4 unpermute "
          f"{per_layer.get('unpermute', 0):g}, B1^T grouped_gemm_t "
          f"{per_layer.get('grouped_gemm_t', 0):g}, B7 grouped_wgrad "
          f"{per_layer.get('grouped_wgrad', 0):g} ({n_moe} MoE layer)")
    # timed forward + backward passes, the peak above nothing freed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    times = []
    for _ in range(MLA_TRAIN_REPS):
        t0 = time.perf_counter()
        out = fwd_bwd()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(fwd_bwd, top=16)
    ms = sorted(times)[len(times) // 2]
    summary = {"layers": cfg.n_layers, "n_params": n_params, "batch": B,
               "seq": S, "policy": "fixed", "loss": float(loss),
               "loss_plain": float(loss_p), "loss_rel_err": loss_err,
               "worst_rel_grad_err": rel[worst], "worst_param": worst,
               "rel_grad_err": rel, "launches": launches,
               "launches_per_moe_layer": per_layer, "fwd_bwd_ms": times,
               "fwd_bwd_ms_median": ms,
               "tokens_per_s": B * S / ms * 1e3, "resident_bytes": resident,
               "weight_bytes": weight_bytes, "weight_tensors": len(params),
               "resident_before_bytes": before,
               "peak_bytes": peak, "profile": prof,
               "adamw_state_bytes": n_params * 16, "card_bytes": card}
    print(f"[train mla] forward + backward x{MLA_TRAIN_REPS}: "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms (median {ms:.1f} "
          f"ms, {summary['tokens_per_s']:.0f} tokens/s); peak device memory "
          f"{peak / 1e9:.2f} GB ({resident / 1e9:.2f} GB resident before: "
          f"the fp32 parameters and the batch)")
    print(f"[profile train mla] one forward + backward: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
          f"(share {prof['busy_share']:.3f})")
    for name, calls, t in prof["top_device"]:
        print(f"    device {t:9.3f} ms {calls:5d}x  {name[:70]}")
    for name, calls, t in prof["top_cpu"]:
        print(f"    host   {t:9.3f} ms {calls:5d}x  {name[:70]}")
    del model, params, batch, loss, loss_p
    torch.cuda.empty_cache()
    # B7 and B1^T at this batch's T at deepseek's MoE layer
    T = B * S
    summary["backward_kernels"] = {}
    for orient in ("gate_up", "down"):
        c = TrainCase(DEEPSEEK, T, torch.bfloat16, seed=600, policy="fixed",
                      orient=orient)
        check_train_case(c, errs)
        tm = time_train_case(c)
        summary["backward_kernels"][orient] = tm
        for n, t in tm.items():
            lib = ("null: " + t["library_null_reason"]
                   if t["library_ms"] is None
                   else f"{t['library_ms'] * 1e3:.1f} us ({t['library']})")
            print(f"[times train mla] {n} deepseek bf16 T={T} fixed {orient}"
                  f" ({t['active_blocks']} active blocks of {t['block_m']}):"
                  f" {t['ms'] * 1e3:.1f} us (eager {t['eager_ms'] * 1e3:.1f})"
                  f", bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}; "
                  f"bytes {t['bound_bytes_ms'] * 1e3:.2f} us for "
                  f"{t['bytes'] / 1e6:.1f} MB, tensor-core operations "
                  f"{t['bound_ops_ms'] * 1e3:.2f} us for "
                  f"{t['flops'] / 1e9:.1f} GFLOP), plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, library {lib}")
        del c
        torch.cuda.empty_cache()
    return summary


def mla_chunk_check(cfg, model, rng) -> dict:
    """deepseek-v2's prefill of one MLA_CHUNK_CHECK_S-token prompt with
    attention chunks of FLASH_CHUNK against one chunk (``q_chunk =
    kv_chunk = 0``), in the model's dtype: the first layer's MLA attention
    output (``mla_block`` on the normed embeddings) within FLASH_TOL, and
    the contiguous prefill's logits through every layer of ``model``
    within LOGIT_TOL_FP32 (fp32) or LOGIT_TOL (bf16), the tolerances of
    this script's other checks through layers (in fp32 the two orders of
    summation move a logit near zero by 1.6e-5 through 2 layers here,
    past FLASH_TOL's 1e-5); each prefill's time and peak above what was
    resident."""
    import torch
    from repro_torch.models.lm import RunConfig, embed_tokens, forward
    from repro_torch.models.mla import mla_block
    dt = next(model.parameters()).dtype
    name = str(dt).replace("torch.", "")
    S = MLA_CHUNK_CHECK_S
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, S),
                             device="cuda")[None]
    with torch.no_grad():
        blk = model.layers[0]
        h = blk.norm1(embed_tokens(model, cfg, prompt, dt))
        kw = dict(n_heads=cfg.n_heads, mla=cfg.mla,
                  positions=torch.arange(S, device=prompt.device))
        attn = mla_block(blk.attn, h, **kw, q_chunk=FLASH_CHUNK,
                         kv_chunk=FLASH_CHUNK)
        attn1 = mla_block(blk.attn, h, **kw, q_chunk=S, kv_chunk=S)
    torch.testing.assert_close(attn.float(), attn1.float(), **FLASH_TOL[name])
    row = {"attn_max_abs_err": (attn.float() - attn1.float()).abs().max()
           .item()}
    del h, attn, attn1
    rc = RunConfig(compute_dtype=dt, q_chunk=FLASH_CHUNK,
                   kv_chunk=FLASH_CHUNK)
    for arm, r in (("chunked", rc), ("one_chunk",
                                     rc._replace(q_chunk=0, kv_chunk=0))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row[arm], _, _ = forward(model, cfg, r, {"tokens": prompt},
                                 mode="prefill")
        torch.cuda.synchronize()
        row[f"{arm}_ms"] = (time.perf_counter() - t0) * 1e3
        row[f"{arm}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    got, want = row.pop("chunked"), row.pop("one_chunk")
    if not torch.isfinite(got).all():
        raise AssertionError("deepseek chunked prefill: non-finite logits")
    tol = LOGIT_TOL_FP32 if dt == torch.float32 else LOGIT_TOL
    torch.testing.assert_close(got, want, **tol)
    row["max_abs_err"] = (got - want).abs().max().item()
    print(f"[prefill long] deepseek-v2 chunks of {FLASH_CHUNK} vs one chunk "
          f"({S} tokens, {name}): layer 0's MLA attention output max_abs_err "
          f"{row['attn_max_abs_err']:.3e} (tolerance rtol=atol="
          f"{FLASH_TOL[name]['atol']:g}); logits through {cfg.n_layers} "
          f"layer(s) max_abs_err {row['max_abs_err']:.3e} (|logits| max "
          f"{want.abs().max().item():.2f}; tolerance rtol=atol="
          f"{tol['atol']:g}); prefill {row['chunked_ms']:.1f} ms, peak "
          f"{row['chunked_peak_bytes'] / 1e9:.3f} GB above the resident, "
          f"against {row['one_chunk_ms']:.1f} ms, "
          f"{row['one_chunk_peak_bytes'] / 1e9:.3f} GB in one chunk")
    del got, want
    torch.cuda.empty_cache()
    return row


def train_dense() -> dict:
    """[train dense]: DENSE_TRAIN_ARCH at full width and depth (fp32
    parameters and AdamW moments, bf16 compute, remat) through ``train()``
    for DENSE_TRAIN_STEPS steps of DENSE_TRAIN_BATCH x DENSE_TRAIN_SEQ: each
    step's loss (finite), the step time from the logged steps after the
    first, tokens/s and the peak; no kernel launches (the dense path has
    none); one step of its first DENSE_PROFILE_LAYERS layers under the
    profiler.  Then, on the trained state,
    the forward and backward without remat at batches 1 and 2, their peaks
    above the state extrapolated to the largest batch within
    DENSE_NOREMAT_SHARE of the card, and two training steps without remat
    at that batch (time and peak).  Last, one
    fp32 forward and backward of the first DENSE_CHECK_LAYERS layers on the
    card against the port on the CPU (same weights and batch)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, loss_fn
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_step, train_state
    cfg = get_config(DENSE_TRAIN_ARCH)
    B, S, n = DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   remat=True)
    opt = OptConfig(total_steps=n, warmup_steps=1)
    card = torch.cuda.get_device_properties(0).total_memory
    stamps = []

    def log(line):
        if line.startswith("[train] step"):  # after the metrics' sync
            stamps.append(time.perf_counter())
        print(f"[train dense] {line}")
    print(f"[train dense] {cfg.name} at full width and all {cfg.n_layers} "
          f"layers (d_model={cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}, tied), fp32 parameters and AdamW "
          f"moments, bf16 compute, remat, batch {B} x seq {S}, attention "
          f"chunks of {rc.q_chunk}, loss_chunk {LOSS_CHUNK}; {n} steps "
          f"through train(), random weights, seed 0")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = train(cfg, rc, opt, steps=n, batch=B, seq=S, seed=0, log_every=1,
                log=log, device="cuda")
    torch.cuda.synchronize()
    peak_remat = torch.cuda.max_memory_allocated()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"[train dense] a dense model launched MoE "
                             f"kernels: {dict(ops.LAUNCHES)}")
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != n or not all(np.isfinite(losses)):
        raise AssertionError(f"[train dense] losses {losses}")
    step_ms = [float(v) for v in np.diff(stamps) * 1e3]
    med = float(np.median(step_ms))
    state = out["state"]
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = torch.cuda.memory_allocated()
    summary = {"arch": cfg.name, "layers": cfg.n_layers,
               "n_params": n_params, "batch": B, "seq": S,
               "losses": losses, "step_ms_after_first": step_ms,
               "step_ms_median": med, "tokens_per_s": B * S / med * 1e3,
               "peak_bytes_remat": peak_remat, "state_bytes": state_bytes}
    print(f"[train dense] {n_params / 1e9:.3f} B parameters; steps after "
          f"the first " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" ms (median {med:.1f} ms, {summary['tokens_per_s']:.0f} "
          f"tokens/s); peak device memory with remat {peak_remat / 1e9:.2f} "
          f"GB; state resident after {state_bytes / 1e9:.2f} GB")
    # one step with remat under the profiler, of the model cut to its
    # first DENSE_PROFILE_LAYERS layers (the same weights, fresh moments)
    cfg_p = cfg.replace(n_layers=DENSE_PROFILE_LAYERS)
    head = train_state(truncated(model, DENSE_PROFILE_LAYERS))
    step_fn = make_train_step(cfg_p, rc, opt)
    batch = device_batch(make_batch(cfg, B, S, step=n, seed=1), "cuda")
    step_fn(head, batch)                       # its moments' first step
    prof = profile_window(lambda: step_fn(head, batch), top=12)
    summary["profile"] = {"layers": DENSE_PROFILE_LAYERS, **prof}
    print(f"[profile train dense] one step with remat, the first "
          f"{DENSE_PROFILE_LAYERS} of {cfg.n_layers} layers: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
          f"(share {prof['busy_share']:.3f}), {prof['device_events']} device "
          f"activities")
    for name, calls, t in prof["top_device"]:
        print(f"    device {t:9.3f} ms {calls:5d}x  {name[:70]}")
    del head, step_fn, batch
    # without remat: the forward + backward's peak at batches 1 and 2, a
    # line through them, and the largest batch it keeps within the share
    rc_n = rc._replace(remat=False)
    params = list(model.parameters())

    def fwd_bwd_peak(b: int) -> int:
        batch = device_batch(make_batch(cfg, b, S, step=0, seed=1), "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(model, cfg, rc_n, batch)
        grads = torch.autograd.grad(loss, params)
        del loss, grads
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base
    p1, p2 = fwd_bwd_peak(1), fwd_bwd_peak(2)
    per_row, fixed = p2 - p1, 2 * p1 - p2
    room = DENSE_NOREMAT_SHARE * card - state_bytes
    fit = max([b for b in range(1, B + 1) if fixed + b * per_row <= room],
              default=0)
    if fit < 1:
        raise AssertionError(f"[train dense] no batch fits without remat "
                             f"(batch 1: {p1 / 1e9:.2f} GB above the state)")
    step_fn = make_train_step(cfg, rc_n, opt)
    batch = device_batch(make_batch(cfg, fit, S, step=n, seed=1), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nr_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError("[train dense] non-finite loss, no remat")
        nr_ms.append((time.perf_counter() - t0) * 1e3)
    peak_nr = torch.cuda.max_memory_allocated()
    summary["no_remat"] = {
        "fwd_bwd_peak_above_state_b1": p1, "fwd_bwd_peak_above_state_b2": p2,
        "per_row_bytes": per_row, "predicted_bytes": state_bytes + fixed
        + fit * per_row, "batch": fit, "step_ms": nr_ms,
        "tokens_per_s": fit * S / nr_ms[-1] * 1e3, "peak_bytes": peak_nr}
    print(f"[train dense] without remat: forward + backward peak above the "
          f"state {p1 / 1e9:.2f} GB at batch 1, {p2 / 1e9:.2f} GB at batch "
          f"2 ({per_row / 1e9:.2f} GB a row of {S}); the largest batch "
          f"within {DENSE_NOREMAT_SHARE:g} of the card's {card / 1e9:.1f} GB"
          f" is {fit} (predicted peak "
          f"{summary['no_remat']['predicted_bytes'] / 1e9:.2f} GB): two "
          f"steps {nr_ms[0]:.1f}, {nr_ms[1]:.1f} ms "
          f"({summary['no_remat']['tokens_per_s']:.0f} tokens/s), peak "
          f"device memory {peak_nr / 1e9:.2f} GB against "
          f"{peak_remat / 1e9:.2f} GB with remat at batch {B}")
    del out, state, model, params, batch, step_fn
    torch.cuda.empty_cache()
    summary["check_fp32"] = fp32_train_check(
        "train dense", cfg.replace(n_layers=DENSE_CHECK_LAYERS),
        DENSE_CHECK_BATCH, DENSE_CHECK_SEQ)
    return summary


def unapplied(cfg, model) -> set:
    """The names of ``model``'s parameters that no layer of ``cfg`` applies:
    a hybrid's shared blocks past its groups' count (at n_layers 3 both of
    zamba2's, at 9 the second); empty for every other family."""
    from repro_torch.models.lm import group_structure
    if cfg.family != "hybrid":
        return set()
    n_groups = group_structure(cfg)[2]
    return {name for name, _ in model.named_parameters()
            if name.startswith("shared.")
            and int(name.split(".")[1]) >= n_groups}


def fp32_train_check(tag: str, cfg, batch: int, seq: int) -> dict:
    """One fp32 forward and backward of ``cfg`` (weights from seed 1) on the
    card against the same weights and ``make_batch`` batch on the CPU: the
    loss within DENSE_CHECK_TOL["loss"], every gradient within
    DENSE_CHECK_TOL["grad"].  Every parameter takes a gradient on both but
    a hybrid's shared blocks that the cut depth applies nowhere
    (``unapplied``), which take none on either; any other difference in
    which parameters take a gradient fails."""
    import torch
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, init_params, loss_fn
    model = init_params(cfg, 1, device="cuda")
    cpu_model = copy.deepcopy(model).to("cpu")
    host = make_batch(cfg, batch, seq, step=0, seed=1)
    rc32 = RunConfig(loss_chunk=LOSS_CHUNK)
    expect = unapplied(cfg, model)
    res = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        m.requires_grad_(True)
        t0 = time.perf_counter()
        loss, metrics = loss_fn(m, cfg, rc32, device_batch(host, dev))
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        none = {k for k, g in zip(names, grads) if g is None}
        if none != expect:
            raise AssertionError(
                f"[{tag}] on {dev} no gradient for {sorted(none - expect)}, "
                f"a gradient for the unapplied {sorted(expect - none)}")
        res[dev] = (loss.detach().cpu(),
                    {k: g.cpu() for k, g in zip(names, grads)
                     if g is not None},
                    (time.perf_counter() - t0) * 1e3,
                    float(metrics["tokens"]))
    (loss, grads, ms, n), (loss_c, grads_c, ms_c, _) = res["cuda"], res["cpu"]
    torch.testing.assert_close(loss, loss_c, **DENSE_CHECK_TOL["loss"])
    worst, worst_name = 0.0, None
    for name, g in grads.items():
        gc = grads_c[name]
        torch.testing.assert_close(g, gc, **DENSE_CHECK_TOL["grad"],
                                   msg=lambda m, name=name: f"{name}: {m}")
        err = (g - gc).abs().max().item()
        if err >= worst:
            worst, worst_name = err, name
    out = {"layers": cfg.n_layers, "batch": batch, "seq": seq,
           "loss_positions": n, "loss_cuda": float(loss),
           "loss_cpu": float(loss_c),
           "loss_abs_err": abs(float(loss - loss_c)),
           "worst_grad_abs_err": worst, "worst_param": worst_name,
           "cuda_ms": ms, "cpu_ms": ms_c}
    print(f"[{tag}] fp32 check, {cfg.n_layers} layers, batch {batch} x seq "
          f"{seq} ({n:.0f} positions in the loss), the same weights and "
          f"batch: loss {float(loss):.7f} on the card, {float(loss_c):.7f} on"
          f" the CPU (|diff| {abs(float(loss - loss_c)):.3e}; tolerance "
          f"1e-5); {len(grads)} gradients, worst max|diff| {worst:.3e} "
          f"({worst_name}; tolerance rtol=atol=1e-4)"
          + (f"; {len(expect)} parameters of unapplied shared blocks take "
             f"none on either" if expect else ""))
    del model, cpu_model, res, grads, grads_c
    torch.cuda.empty_cache()
    return out


def train_resume() -> dict:
    """[train resume]: moonshot at full width cut to RESUME_LAYERS layers (1
    dense + 1 MoE), capacity_factor, remat, bf16 compute, batch TRAIN_BATCH
    x seq TRAIN_SEQ, RESUME_STEPS steps.  Two uninterrupted runs first,
    whose parameters must be bitwise equal; then a run that checkpoints
    every RESUME_SAVE_EVERY steps (keeping 1) and fails at step
    RESUME_FAIL_AT, restarted by ``supervise``: it must resume from step
    RESUME_FAIL_AT - 1 and end bitwise where the uninterrupted runs end.
    Prints the directory's free space before writing (a disk that cannot
    hold a checkpoint fails the phase), the checkpoint's bytes, and the
    host copy's, the write's and the restore's times."""
    import collections
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    from repro_torch.obs import Observability
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.fault import supervise
    from repro_torch.train.loop import train
    cfg = get_config("moonshot-v1-16b-a3b").replace(n_layers=RESUME_LAYERS)
    rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                   schedule_policy="capacity_factor",
                   capacity_factor=CAPACITY_FACTOR, remat=True)
    opt = OptConfig(total_steps=RESUME_STEPS, warmup_steps=1)
    kw = dict(steps=RESUME_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              log_every=1, log=lambda line: None, device="cuda")

    def final_params(out):
        params = {n: p.detach().clone()
                  for n, p in out["state"]["params"].named_parameters()}
        out.clear()
        torch.cuda.empty_cache()
        return params
    t0 = time.perf_counter()
    clean = final_params(train(cfg, rc, opt, **kw))
    again = final_params(train(cfg, rc, opt, **kw))
    clean_s = (time.perf_counter() - t0) / 2
    n_params = sum(p.numel() for p in clean.values())
    diff = [n for n in clean if not torch.equal(clean[n], again[n])]
    if diff:
        raise AssertionError(
            "two uninterrupted runs differ in " + ", ".join(
                f"{n} (max |diff| "
                f"{(clean[n] - again[n]).abs().max().item():.3e})"
                for n in diff))
    del again
    root = RESUME_CKPT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    need = 12 * n_params          # fp32 parameters and two fp32 moments
    print(f"[train resume] {cfg.name} at full width, {RESUME_LAYERS} layers"
          f" (1 dense + 1 MoE), {n_params / 1e9:.3f} B parameters, "
          f"capacity_factor {CAPACITY_FACTOR}, remat, {RESUME_STEPS} steps of"
          f" batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: two uninterrupted runs "
          f"bitwise equal ({clean_s:.1f} s each); checkpoint directory "
          f"{root.relative_to(ROOT)}: {free / 1e9:.1f} GB free, a checkpoint "
          f"{need / 1e9:.2f} GB")
    if free < need:
        raise AssertionError(f"the disk holds {free / 1e9:.1f} GB, less than "
                             f"one checkpoint ({need / 1e9:.2f} GB)")
    attempts = []
    obs = Observability.memory()

    def run():
        attempts.append(len(attempts))
        return train(cfg, rc, opt, ckpt_dir=str(root),
                     save_every=RESUME_SAVE_EVERY, keep_last=1,
                     fail_at=RESUME_FAIL_AT if len(attempts) == 1 else None,
                     obs=obs, **kw)
    t0 = time.perf_counter()
    out = supervise(run)
    wall = time.perf_counter() - t0
    stats, resumed_from = out["checkpoint"], out["resumed_from"]
    if out["restarts"] != 1 or resumed_from != RESUME_FAIL_AT - 1:
        raise AssertionError(f"resume: {out['restarts']} restarts, resumed "
                             f"from {resumed_from}")
    on_disk = sorted(p.name for p in root.iterdir())
    disk_bytes = sum(f.stat().st_size for f in root.rglob("*")
                     if f.is_file())
    resumed = final_params(out)
    diff = [n for n in clean if not torch.equal(clean[n], resumed[n])]
    if diff:
        raise AssertionError(
            "the resumed run ends elsewhere than the uninterrupted one: "
            + ", ".join(f"{n} (max |diff| "
                        f"{(clean[n] - resumed[n]).abs().max().item():.3e})"
                        for n in diff))
    spans = collections.Counter(e["name"] for e in obs.tracer.events)
    if not spans["train/step"] or not spans["train/checkpoint"]:
        raise AssertionError(f"[train resume] the memory bundle's spans: "
                             f"{dict(spans)}")
    logged = obs.metrics.counter_value("train/steps_logged")
    print(f"[train resume] memory bundle over the supervised runs: spans "
          f"{dict(sorted(spans.items()))}, train/steps_logged {logged:.0f}")
    res = {"layers": RESUME_LAYERS, "n_params": n_params, "free_bytes": free,
           "checkpoint_bytes": stats["bytes"], "disk_bytes": disk_bytes,
           "host_copy_ms": stats["host_copy_s"] * 1e3,
           "write_s": stats["write_s"], "restore_s": stats["restore_s"],
           "write_GB_per_s": stats["bytes"] / stats["write_s"] / 1e9,
           "clean_run_s": clean_s, "supervised_s": wall,
           "resumed_from": resumed_from, "on_disk": on_disk,
           "spans": dict(spans)}
    print(f"[train resume] failure injected at step {RESUME_FAIL_AT}, "
          f"save_every {RESUME_SAVE_EVERY}, keep_last 1: supervise restarted "
          f"once, resumed from step {resumed_from}, final parameters "
          f"bitwise the uninterrupted run's; on disk {on_disk} "
          f"({disk_bytes / 1e9:.3f} GB); last save: {stats['bytes'] / 1e9:.3f}"
          f" GB, host copy {res['host_copy_ms']:.0f} ms, write "
          f"{stats['write_s']:.2f} s ({res['write_GB_per_s']:.2f} GB/s); "
          f"restore {stats['restore_s']:.2f} s; the supervised runs "
          f"{wall:.1f} s")
    del resumed
    torch.cuda.empty_cache()
    return res, clean


def model_from_params(cfg, params: dict, dtype):
    """``cfg``'s model at ``dtype`` on the card (laid out on the meta
    device, allocated uninitialised) holding ``params`` ({name: tensor}),
    each cast to its parameter's dtype.  A function of its own, so that no
    name outlives the call holding one of its parameters."""
    import torch
    from repro_torch.models.lm import LM
    model = LM(cfg, None, dtype, torch.device("meta")).to_empty(
        device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model


def serve_ckpt(clean: dict, smi: str) -> dict:
    """[serve ckpt]: [train resume]'s checkpoint (``RESUME_CKPT``, its last
    step, fp32 parameters and AdamW moments) served by the launcher with
    ``--ckpt-dir`` in fp32, bf16 and bf16 under ``--quant int8_expert``;
    each run's greedy tokens must equal an engine's over ``clean`` (the
    uninterrupted run's final parameters, {name: fp32 tensor}) cast to the
    run's dtype (and quantized by ``quantize_model``), built as the
    launcher builds its engine, on the same requests.  The launch counters
    are read over the launcher's runs alone.  Returns the bytes read, the
    restore seconds, the bf16 engine's decode ms a step (``drive``), the
    launches and the int8 model's bytes on the card."""
    import contextlib
    import gc
    import io
    import re
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.quantization import quantize_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("moonshot-v1-16b-a3b").replace(n_layers=RESUME_LAYERS)
    arms = (("fp32", "none"), ("bf16", "none"), ("bf16", "int8_expert"))
    launches = {k: 0 for k in ops.LAUNCHES}
    out = {"layers": RESUME_LAYERS, "arms": {}}
    print(f"[serve ckpt] {RESUME_CKPT.relative_to(ROOT)} served by "
          f"repro_torch.launch.serve --ckpt-dir: {cfg.name} at full width, "
          f"{RESUME_LAYERS} layers, {SERVE_REQUESTS} requests x "
          f"{SERVE_MAX_NEW} new on {SERVE_SLOTS} slots, paged dynamic engine")
    for dtype, quant in arms:
        tag = dtype + ("" if quant == "none" else f" {quant}")
        # the engine's model over the same parameters, built first, with
        # nothing of an earlier run left (the allocator's count below is
        # this model's alone)
        dt = launcher.DTYPES[dtype]
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = model_from_params(cfg, clean, dt)
        if quant != "none":
            quantize_model(model, quant)
        torch.cuda.synchronize()
        weight_bytes = torch.cuda.memory_allocated() - before
        weight_tensors = len(list(model.parameters())) \
            + len(list(model.buffers()))
        argv = ["--arch", cfg.name, "--layers", str(RESUME_LAYERS),
                "--ckpt-dir", str(RESUME_CKPT), "--dtype", dtype,
                "--requests", str(SERVE_REQUESTS), "--max-new",
                str(SERVE_MAX_NEW), "--slots", str(SERVE_SLOTS)]
        if quant != "none":
            argv += ["--quant", quant]
        torch.cuda.synchronize()
        ops.reset_launches()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            done = launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        run_launches = dict(ops.LAUNCHES)
        log = text.getvalue()
        m = re.search(r"step (\d+), (\d+) bytes of params/\* read in "
                      r"([\d.]+) s", log)
        if m is None or int(m.group(1)) != RESUME_STEPS - 1:
            raise AssertionError(f"[serve ckpt] {tag}: the launcher did not "
                                 f"restore step {RESUME_STEPS - 1}:\n"
                                 + log[-2000:])
        done = sorted(done, key=lambda r: r.rid)
        if len(done) != SERVE_REQUESTS:
            raise AssertionError(f"[serve ckpt] {tag}: {len(done)} of "
                                 f"{SERVE_REQUESTS} requests completed")
        reqs = [Request(rid=r.rid, prompt=r.prompt, max_new=SERVE_MAX_NEW)
                for r in done]
        capacity = max(len(r.prompt) for r in reqs) + SERVE_MAX_NEW + 1
        rc = RunConfig(compute_dtype=dt, schedule_policy="dynamic",
                       quant=quant, moe_stats=True)
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                             capacity=capacity, rc=rc, device="cuda")
        res = drive(engine, reqs)
        want, got = [r.out for r in reqs], [r.out for r in done]
        if want != got:
            raise AssertionError(f"[serve ckpt] {tag}: the launcher's tokens "
                                 f"{got} != the engine's over the final "
                                 f"parameters {want}")
        dec = res["decode_steps"]
        arm = {"restored_step": int(m.group(1)),
               "bytes_read": int(m.group(2)),
               "restore_s": float(m.group(3)), "launcher_s": wall,
               "launches": run_launches, "tokens": got,
               "engine_forwards": res["forwards"],
               "decode_ms_per_step_p50": 1e3 * float(np.median(dec)),
               "decode_steps": len(dec)}
        if quant != "none":
            arm.update(weight_bytes=weight_bytes,
                       weight_tensors=weight_tensors)
        out["arms"][tag] = arm
        print(f"[serve ckpt] {tag}: step {arm['restored_step']} restored, "
              f"{arm['bytes_read']} bytes of params/* read in "
              f"{arm['restore_s']:.3f} s; the launcher's run "
              f"{wall:.1f} s; tokens identical to the engine's over the "
              f"final parameters ({sum(len(t) for t in got)} tokens, "
              f"{len(got)} requests); the engine's decode "
              f"{arm['decode_ms_per_step_p50']:.2f} ms a step (median of "
              f"{len(dec)}); launches {json.dumps(run_launches)}; {smi}")
        del model, engine, res, done
        torch.cuda.empty_cache()
    n_moe = n_moe_layers(cfg)
    need = MOE_KERNELS + ("paged_attention", "grouped_gemm_int8",
                          "fused_gate_up_int8")
    zero = [k for k in need if launches[k] <= 0]
    if zero:
        raise AssertionError(f"[serve ckpt] never launched: {zero} "
                             f"({json.dumps(launches)})")
    out["launches"] = launches
    print(f"[serve ckpt] launches over the three runs ({n_moe} MoE layer, "
          f"{cfg.n_layers} paged reads a forward): "
          + json.dumps({k: v for k, v in launches.items() if v}))
    return out


def grid_grads(cfg, rc, model, batch: dict, grid):
    """The loss and this rank's gradient blocks, reduced as the step
    reduces them, of one forward and backward on ``grid``."""
    import torch
    from repro_torch.distributed.ctx import use_rules
    from repro_torch.models.lm import loss_fn
    from repro_torch.train.step import grid_rules, reduce_grads
    params = dict(model.named_parameters())
    with use_rules(grid, grid_rules(cfg, grid, batch["tokens"].shape[0])):
        loss, _ = loss_fn(model, cfg, rc, batch)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), gs)}
    return float(loss.detach()), reduce_grads(grads, model.shard_specs, grid)


def overlap_check(cfg, rc, model, batch: dict, grid) -> dict:
    """[train sharded] on a grid with a 'model' axis: the fp32 check
    step's loss and gradient blocks with ``RunConfig.ep_overlap`` (2
    microbatches) against those without, on this rank; each gradient's
    error relative to its largest magnitude."""
    loss0, g0 = grid_grads(cfg, rc, model, batch, grid)
    loss1, g1 = grid_grads(cfg, rc._replace(ep_overlap=True,
                                            ep_microbatches=2),
                           model, batch, grid)
    errs = {n: float((g1[n] - g0[n]).abs().max()
                     / g0[n].abs().max().clamp_min(1e-30)) for n in g0}
    worst = max(errs, key=errs.get)
    return {"loss_off": loss0, "loss_on": loss1, "grad_err": errs[worst],
            "worst": worst}


def sharded_rank(group, spec: dict) -> dict:
    """One [train sharded] rank: for each grid of SHARDED_GRIDS, the fp32
    check step on this rank's blocks (the single rank's parameters after
    its step read back from ``spec["ckpt"]`` as this rank's blocks), then
    the bf16 arm with remat: the warm step through the training loop
    (``train.loop.train(grid=)``, the launcher's path: a fresh state from
    the seed, the batch cut by ``local_batch``), and on its state the
    timed steps.  Returns numpy and Python values."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import device_batch, local_batch, make_batch
    from repro_torch.distributed.group import (COLLECTIVES, make_grid,
                                               reset_collectives)
    from repro_torch.distributed.sharding import batch_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import train
    from repro_torch.train.step import init_train_state, make_train_step
    cfg, dev = spec["cfg"], group.device
    n_moe = n_moe_layers(cfg)
    out = {"rank": group.rank, "device": str(dev), "backend": group.backend,
           "check": {}, "loop": {}, "timed": {}}

    def batch(grid, b, seq, i):
        return device_batch(local_batch(
            make_batch(cfg, b, seq, step=i, seed=1), grid,
            batch_specs(cfg, grid, "train", b), cfg), dev)

    for data, model, n in SHARDED_GRIDS:
        name = f"{data}x{model}"
        grid = make_grid(data, model, device=dev, verbose=group.rank == 0)
        # the fp32 check
        rc = RunConfig(compute_dtype=torch.float32, loss_chunk=LOSS_CHUNK)
        state = init_train_state(cfg, 0, rc, device=dev, grid=grid)
        torch.cuda.empty_cache()
        step = make_train_step(cfg, rc, OptConfig(**SHARDED_CHECK_OPT),
                               grid=grid)
        b = batch(grid, SHARDED_CHECK_BATCH, SHARDED_CHECK_SEQ, 0)
        if model > 1:
            out["overlap"] = overlap_check(cfg, rc, state["params"], b, grid)
        torch.cuda.synchronize()
        ops.reset_launches()
        state, m = step(state, b)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check_train_launches(launches, n_moe)
        blocks = dict(state["params"].named_parameters())
        specs = state["params"].shard_specs
        want = {"params": {n: torch.empty_like(p) for n, p in blocks.items()}}
        CheckpointManager(spec["ckpt"]).restore(
            want, 0, shardings={f"params/{n}": sp for n, sp in specs.items()},
            grid=grid)
        errs = {n: float((p.detach() - want["params"][n]).abs().max())
                for n, p in blocks.items()}
        worst = max(errs, key=errs.get)
        out["check"][name] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "max_abs_err": errs[worst], "worst": worst, "launches": launches,
            "tokens": int(b["tokens"].numel())}
        shard_bytes = 3 * sum(p.numel() * 4 for p in blocks.values())
        del state, step, blocks, want, b
        torch.cuda.empty_cache()
        # bf16, remat: the warm step through the loop, on one rank's data
        # stream (seed 0's batches: make_batch's seed 1)
        rc = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                       remat=True)
        opt = OptConfig(total_steps=n + 1, warmup_steps=1)
        ops.reset_launches()
        warm = train(cfg, rc, opt, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     seed=0, log_every=1, device=dev, grid=grid,
                     log=lambda line: print(f"[train sharded] grid {name} "
                                            f"loop: {line}", flush=True))
        torch.cuda.synchronize()
        check_train_launches(dict(ops.LAUNCHES), n_moe, remat=True)
        out["loop"][name] = {"history": warm["history"],
                             "launches": dict(ops.LAUNCHES)}
        state = warm.pop("state")
        del warm
        step = make_train_step(cfg, rc, opt, grid=grid)
        bs = [batch(grid, TRAIN_BATCH, TRAIN_SEQ, 1 + i) for i in range(n)]
        grid.world.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_collectives()
        ops.reset_launches()
        rows = []
        for i in range(n):
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            state, m = step(state, bs[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_train_launches({k: ops.LAUNCHES[k] - before[k]
                                  for k in ops.LAUNCHES}, n_moe, remat=True)
            row = {"ms": ms, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            if not all(np.isfinite(v) for v in row.values()):
                raise AssertionError(f"[train sharded] {name} step {i}: "
                                     f"not finite: {row}")
            rows.append(row)
        out["timed"][name] = {
            "steps": rows, "ms_median": float(np.median([r["ms"]
                                                         for r in rows])),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "shard_bytes": shard_bytes,
            "launches_per_step": {k: v // n for k, v in ops.LAUNCHES.items()},
            "collectives_per_step": {op: {"calls": c / n, "bytes": b / n,
                                          "host_s": sec / n}
                                     for op, (c, b, sec)
                                     in COLLECTIVES.items()},
            "tokens": int(bs[0]["tokens"].numel())}
        del state, step, bs
        torch.cuda.empty_cache()
        grid.world.barrier()
    out["families"] = family_sharded(group, spec["families_ckpt"])
    return out


def train_sharded() -> dict:
    """[train sharded]: moonshot at full width cut to SHARDED_LAYERS layers
    on SHARDED_RANKS gloo ranks sharing this card, each grid of
    SHARDED_GRIDS.  The single rank's fp32 check step runs here first, its
    parameters are written whole to build/ckpt_sharded and freed; then the
    single rank's bf16 step with remat at this depth is timed (a warm step,
    then one), printed beside the grids'; then the ranks start
    (``sharded_rank``), and after moonshot's grids they run the late
    families' fp32 checks (``family_sharded``, under
    build/ckpt_sharded_families; ``report_sharded_families``)."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.distributed import spawn_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_config("moonshot-v1-16b-a3b").replace(n_layers=SHARDED_LAYERS)
    n_moe = n_moe_layers(cfg)
    t0 = time.perf_counter()
    rc = RunConfig(compute_dtype=torch.float32, loss_chunk=LOSS_CHUNK)
    state = init_train_state(cfg, 0, rc, device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    step = make_train_step(cfg, rc, OptConfig(**SHARDED_CHECK_OPT))
    b = device_batch(make_batch(cfg, SHARDED_CHECK_BATCH, SHARDED_CHECK_SEQ,
                                step=0, seed=1), "cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    state, m = step(state, b)
    torch.cuda.synchronize()
    single_launches = dict(ops.LAUNCHES)
    check_train_launches(single_launches, n_moe)
    single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    root = ROOT / "build" / "ckpt_sharded"
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(str(root), keep_last=1, async_save=False)
    mgr.save(0, {"params": dict(state["params"].named_parameters())})
    saved = dict(mgr.stats)
    del state, step, b, m, mgr                 # and its page-locked staging
    torch.cuda.empty_cache()
    # the single rank's bf16 step with remat at this depth: a warm one, then
    # one timed
    rc16 = RunConfig(compute_dtype=torch.bfloat16, loss_chunk=LOSS_CHUNK,
                     remat=True)
    state = init_train_state(cfg, 0, rc16, device="cuda")
    step = make_train_step(cfg, rc16, OptConfig(total_steps=3,
                                                warmup_steps=1))
    bs = [device_batch(make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, step=i,
                                  seed=1), "cuda") for i in range(2)]
    state, _ = step(state, bs[0])
    torch.cuda.synchronize()
    t_single = time.perf_counter()
    state, _ = step(state, bs[1])
    torch.cuda.synchronize()
    single["bf16_remat_ms"] = (time.perf_counter() - t_single) * 1e3
    del state, step, bs
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    print(f"[train sharded] {cfg.name} at full width, {cfg.n_layers} layers "
          f"(1 dense + {n_moe} MoE), {n_params / 1e9:.3f} B parameters "
          f"({12 * n_params / 1e9:.2f} GB of fp32 parameters and moments); "
          f"single rank's fp32 check step (batch {SHARDED_CHECK_BATCH} x seq "
          f"{SHARDED_CHECK_SEQ}, lr {SHARDED_CHECK_OPT['lr']:g}, eps "
          f"{SHARDED_CHECK_OPT['eps']:g}): loss {single['loss']:.6f}, "
          f"grad_norm {single['grad_norm']:.6f}; its parameters written "
          f"whole ({saved['bytes'] / 1e9:.2f} GB, write "
          f"{saved['write_s']:.2f} s); its bf16 step with remat (batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}) {single['bf16_remat_ms']:.1f} "
          f"ms; {t1 - t0:.1f} s")
    families = ROOT / "build" / "ckpt_sharded_families"
    spec = {"cfg": cfg, "ckpt": str(root), "families_ckpt": str(families)}
    try:
        ranks = spawn_ranks(sharded_rank, SHARDED_RANKS, "cuda:0", spec,
                            timeout=900)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(families, ignore_errors=True)
    t2 = time.perf_counter()
    out = {"n_params": n_params, "single": single,
           "single_launches": single_launches, "ranks_s": t2 - t1,
           "grids": {}}
    for data, model, _ in SHARDED_GRIDS:
        name = f"{data}x{model}"
        checks = [r["check"][name] for r in ranks]
        for r, c in zip(ranks, checks):
            gn_rel = abs(c["grad_norm"] - single["grad_norm"]) \
                / single["grad_norm"]
            if abs(c["loss"] - single["loss"]) > SHARDED_LOSS_TOL \
                    or c["max_abs_err"] > SHARDED_PARAM_TOL \
                    or not gn_rel <= SHARDED_GNORM_RTOL:
                raise AssertionError(
                    f"[train sharded] {name} rank {r['rank']}: loss "
                    f"{c['loss']} against the single rank's "
                    f"{single['loss']}, grad_norm {c['grad_norm']} against "
                    f"{single['grad_norm']} (relative {gn_rel:.3e}), "
                    f"parameters after the step max_abs_err "
                    f"{c['max_abs_err']:.3e} ({c['worst']})")
            if c["loss"] != checks[0]["loss"]:
                raise AssertionError(f"[train sharded] {name}: the ranks' "
                                     f"losses differ")
        timed = [r["timed"][name] for r in ranks]
        out["grids"][name] = {"check": checks, "timed": timed,
                              "loop": ranks[0]["loop"][name]}
        t = timed[0]
        coll = t["collectives_per_step"]
        print(f"[train sharded] grid {name} (data x model) fp32 check: loss "
              f"{checks[0]['loss']:.6f} (single rank {single['loss']:.6f}, "
              f"diff {abs(checks[0]['loss'] - single['loss']):.2e}, "
              f"tolerance {SHARDED_LOSS_TOL:g}); grad_norm "
              + ", ".join(f"{c['grad_norm']:.6f}" for c in checks)
              + f" (single rank {single['grad_norm']:.6f}, relative "
              f"tolerance {SHARDED_GNORM_RTOL:g}); every parameter after the "
              f"step within "
              + ", ".join(f"{c['max_abs_err']:.2e} ({c['worst']})"
                          for c in checks)
              + f" of the single rank's (rank 0, 1; tolerance "
              f"{SHARDED_PARAM_TOL:g}); launches a rank "
              f"{json.dumps({k: v for k, v in checks[0]['launches'].items() if v})}"
              f", as one rank's step "
              f"({checks[0]['tokens']} tokens a rank)")
        warm = ranks[0]["loop"][name]["history"][-1]
        print(f"[train sharded] grid {name} bf16, remat, batch {TRAIN_BATCH}"
              f" x seq {TRAIN_SEQ} ({t['tokens']} tokens a rank): warm step "
              f"through train(grid=) loss {warm['loss']:.4f}, launches "
              f"as one rank's; timed step ms "
              + ", ".join(f"rank {i} " + "/".join(f"{r['ms']:.1f}"
                                                  for r in tt["steps"])
                          for i, tt in enumerate(timed))
              + f" (median rank 0 {t['ms_median']:.1f}); the single rank's "
              f"at this depth {single['bf16_remat_ms']:.1f}; peak memory "
              f"a rank " + ", ".join(f"{tt['peak_bytes'] / 1e9:.2f} GB"
                                     for tt in timed)
              + f"; parameter and moment blocks a rank "
              + ", ".join(f"{tt['shard_bytes'] / 1e9:.3f} GB"
                          for tt in timed)
              + f" (of {12 * n_params / 1e9:.3f} GB whole); collectives a "
              f"step, rank 0 (calls, GB of the whole tensors, host s inside "
              f"them): " + ", ".join(
                  f"{op} {v['calls']:.0f}, {v['bytes'] / 1e9:.3f} GB, "
                  f"{v['host_s']:.2f} s" for op, v in sorted(coll.items()))
              + "; launches a step "
              f"{json.dumps({k: v for k, v in t['launches_per_step'].items() if v})}; "
              f"{smi_line()}")
    tol = TRAIN_CHECK_TOL["float32"]
    ov = [r["overlap"] for r in ranks]
    for r, o in zip(ranks, ov):
        if not (abs(o["loss_on"] - o["loss_off"]) <= tol["loss"]
                * abs(o["loss_off"]) and o["grad_err"] <= tol["grad"]):
            raise AssertionError(f"[train sharded] ep_overlap rank "
                                 f"{r['rank']}: {o}")
    out["overlap"] = ov
    grid_name = next(f"{d}x{m}" for d, m, _ in SHARDED_GRIDS if m > 1)
    print(f"[train sharded] grid {grid_name} fp32 check step with "
          f"ep_overlap (2 microbatches) against without: loss "
          f"{ov[0]['loss_on']:.6f} vs {ov[0]['loss_off']:.6f} (relative "
          f"tolerance {tol['loss']:g}); worst gradient error relative to its "
          f"largest magnitude a rank " + ", ".join(
              f"{o['grad_err']:.2e} ({o['worst']})" for o in ov)
          + f" (tolerance {tol['grad']:g})")
    out["backend"] = ranks[0]["backend"]
    out["families"] = report_sharded_families([r["families"]
                                               for r in ranks])
    print(f"[train sharded] moonshot's grids and the late families: "
          f"{time.perf_counter() - t1:.1f} s with the ranks' start")
    return out


def median_ms(fn, iters: int, warm: int = 1) -> float:
    """Median over ``iters`` calls of ``fn``, each between two CUDA events
    (after ``warm`` calls): the device's time where it is busy throughout,
    else the host's time to issue the call."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def oracle_fp32(x, wg, wu, wd, weights, indices,
                budget: float = EXEC_ORACLE_BYTES):
    """The MoE layer in fp32 on every expert, a chunk of experts at a time
    (at most ``budget`` bytes of fp32 weights a chunk, so deepseek-v3's
    256 experts fit), each expert's output weighted by the routing's
    combine weight for it (0 where it was not picked).  This script's
    own, apart from the port's ``moe_ffn_dense_ref``."""
    import torch
    E, d, f = wg.shape
    step = max(1, int(budget // (3 * d * f * 4)))
    xf = x.float()
    combine = torch.zeros((x.shape[0], E), dtype=torch.float32,
                          device=x.device).scatter_add_(
        1, indices.long(), weights.float())
    y = torch.zeros((x.shape[0], wd.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for e0 in range(0, E, step):
        sl = slice(e0, min(E, e0 + step))
        g = torch.einsum("td,edf->tef", xf, wg[sl].float())
        u = torch.einsum("td,edf->tef", xf, wu[sl].float())
        h = (g * torch.sigmoid(g)) * u * combine[:, sl, None]
        y += torch.einsum("tef,efd->td", h, wd[sl].float())
    return y


def executor_layers() -> dict:
    """[executors]' layer cells: every paper layer at EXEC_TS on each arm
    of EXEC_ARMS.  Each arm: one warm call, one call under
    ``set_sync_debug_mode("error")`` held against ``oracle_fp32`` on the
    routing of the plan (``EXEC_REL_TOL``), its peak bytes above what was
    resident, its launches (B1-B6 only on ``cuda``), its eager ms (host
    issue included) and its device ms (``device_ms``: one call in a CUDA
    graph, replayed)."""
    import torch
    from repro_torch.configs import PAPER_CONFIGS
    from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
    from repro_torch.execution import plan_dispatch
    from repro_torch.kernels import ops
    out = {}
    gen = torch.Generator(device="cuda")
    for name, Ts in EXEC_TS.items():
        pc = PAPER_CONFIGS[name]
        E, k, d, f = pc.n_experts, pc.top_k, pc.d_model, pc.d_ffn
        gen.manual_seed(EXEC_SEED)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(torch.bfloat16)
        wg = randn(E, d, f, scale=d ** -0.5)
        wu = randn(E, d, f, scale=d ** -0.5)
        wd = randn(E, f, d, scale=f ** -0.5)
        router = torch.randn((d, E), generator=gen, device="cuda") \
            * d ** -0.5
        base = MoEDispatchConfig(n_experts=E, top_k=k, block_m=128,
                                 gating=pc.gating, schedule_policy="fixed")
        for T in Ts:
            x = randn(T, d)
            plan = plan_dispatch(x, router, base._replace(executor="dense"))
            want = oracle_fp32(x, wg, wu, wd, plan.weights, plan.indices)
            used = int(torch.unique(plan.indices).numel())
            b_ms, b_by = bound_ms(used * 3 * d * f * 2 + 2 * T * d * 2,
                                  2 * 3 * T * k * d * f)
            cell = {"bound_ms": b_ms, "bound_by": b_by, "experts_used": used,
                    "oracle_max_abs": want.abs().max().item(), "arms": {}}
            for arm, kw in EXEC_ARMS.items():
                if arm == "dense" and E > EXEC_DENSE_MAX_E:
                    continue
                cfg = base._replace(**kw)

                def call():
                    return moe_ffn(x, router, wg, wu, wd, cfg)[0]
                call()
                torch.cuda.synchronize()
                ops.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    y = call()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - resident
                launched = {n: c for n, c in ops.LAUNCHES.items() if c}
                if (cfg.executor == "cuda") != bool(launched):
                    raise AssertionError(f"[executors] {name} T={T} {arm}: "
                                         f"launches {launched}")
                err = (y.float() - want).abs().max().item()
                rel = err / cell["oracle_max_abs"]
                if not torch.isfinite(y).all() or rel > EXEC_REL_TOL:
                    raise AssertionError(
                        f"[executors] {name} T={T} {arm}: max|y - oracle| "
                        f"{err:.3e} is {rel:.3e} of max|oracle| "
                        f"{cell['oracle_max_abs']:.3e} (tolerance "
                        f"{EXEC_REL_TOL:g})")
                del y
                ms = median_ms(call, EXEC_ITERS)
                graph = device_ms(call, per_graph=1, replays=EXEC_ITERS)
                cell["arms"][arm] = {"ms": ms, "graph_ms": graph,
                                     "peak_bytes": peak,
                                     "max_abs_err": err, "rel_err": rel,
                                     "launches": launched}
                print(f"[executors] {name} (E={E} k={k} d={d} f={f}) T={T} "
                      f"{arm}: {ms:.3f} ms eager (median of {EXEC_ITERS} "
                      f"calls between CUDA events), {graph:.3f} ms device "
                      f"(a CUDA graph of one call, mean of {EXEC_ITERS} "
                      f"replays), peak {peak} bytes above the resident, "
                      f"max_abs_err vs the fp32 oracle {err:.3e} ({rel:.2e} "
                      f"of its largest magnitude), no host sync, launches "
                      f"{json.dumps(launched)}")
            print(f"[executors] {name} T={T}: bound {b_ms:.3f} ms "
                  f"({b_by}; {used} experts' bf16 weights); device ms "
                  + ", ".join(f"{arm} {v['graph_ms'] / b_ms:.1f}x" for arm, v
                              in cell["arms"].items()) + " of the bound")
            out[f"{name} T={T}"] = cell
            del x, plan, want
        del wg, wu, wd, router
        torch.cuda.empty_cache()
    return out


def executor_launcher(cfg, layers: int) -> dict:
    """The serve launcher (``launch/serve.py``'s ``main``) at the served
    depth in fp32 on EXEC_SERVE_POLICY with ``--executor`` blocks, dense
    and cuda (its own seeded prompts, [serve paged]'s shape): its startup
    line names each, the greedy tokens are identical, B1-B6 launch only
    under cuda, as many times as [serve paged]'s check wants of its
    forwards."""
    import contextlib
    import io
    import re
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.lm import n_moe_layers
    argv = ["--arch", cfg.name, "--layers", str(layers), "--requests",
            str(SERVE_REQUESTS), "--max-new", str(SERVE_MAX_NEW), "--slots",
            str(SERVE_SLOTS), "--dtype", "fp32", "--seed", "0", "--policy",
            EXEC_SERVE_POLICY]
    out = {}
    for ex in ("blocks", "dense", "cuda"):
        buf = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            done = serve_main(argv + ["--executor", ex])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        log = buf.getvalue()
        startup = next(line for line in log.splitlines()
                       if " layers at " in line)
        if f"{ex} executor" not in startup:
            raise AssertionError(f"[executors] launcher --executor {ex}: "
                                 f"{startup}")
        forwards = int(re.search(r"(\d+) forwards in", log).group(1))
        if ex == "cuda":
            check_launches(launches, n_moe_layers(cfg) * forwards,
                           cfg.n_layers * forwards, "dense")
        elif any(launches.values()):
            raise AssertionError(f"[executors] launcher --executor {ex} "
                                 f"launched {launches}")
        toks = [list(r.out) for r in sorted(done, key=lambda r: r.rid)]
        out[ex] = {"tokens": toks, "forwards": forwards,
                   "seconds": seconds,
                   "launches": {n: c for n, c in launches.items() if c}}
        print(f"[executors serve] launcher --executor {ex}, fp32: "
              f"{len(done)} requests, {forwards} forwards in {seconds:.1f} s "
              f"(model init included); launches "
              f"{json.dumps(out[ex]['launches'])}; startup: {startup}")
    if not out["blocks"]["tokens"] == out["dense"]["tokens"] \
            == out["cuda"]["tokens"]:
        raise AssertionError(f"[executors serve] fp32 tokens differ: "
                             f"{ {ex: v['tokens'] for ex, v in out.items()} }")
    print(f"[executors serve] fp32 greedy tokens of {SERVE_REQUESTS} "
          f"requests x {SERVE_MAX_NEW} identical on blocks, dense and cuda")
    return out


def executor_decode(cfg, model, prompts, capacity, paged_kw) -> dict:
    """[serve paged]'s traffic on [serve paged]'s bf16 model through the
    paged engine on each executor, on EXEC_SERVE_POLICY (one warm-up
    request, then ``drive``):
    decode ms per step (median of the decode-only steps, host clock), B1-B6
    only under cuda."""
    import numpy as np
    import torch
    from repro_torch.models.lm import RunConfig, n_moe_layers
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(1)
    out = {}
    for ex in ("cuda", "blocks", "dense"):
        rc = RunConfig(compute_dtype=torch.bfloat16,
                       schedule_policy=EXEC_SERVE_POLICY, executor=ex)
        engine = ServeEngine(cfg, model, slots=SERVE_SLOTS,
                             capacity=capacity, rc=rc, **paged_kw)
        engine.run([Request(rid=-1, prompt=rng.integers(
            0, cfg.vocab_size, 32).astype(np.int32), max_new=3)])
        reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                for i, p in enumerate(prompts)]
        res = drive(engine, reqs)
        n = res["forwards"]
        if ex == "cuda":
            check_launches(res["launches"], n_moe_layers(cfg) * n,
                           cfg.n_layers * n, "dense")
        elif any(res["launches"].values()):
            raise AssertionError(f"[executors decode] {ex} launched "
                                 f"{res['launches']}")
        check_requests(reqs, cfg.vocab_size)
        steps = sorted(res["decode_steps"])
        ms = steps[len(steps) // 2] * 1e3
        out[ex] = {"decode_ms_per_step": ms, "decode_steps": len(steps),
                   "forwards": n, "tokens": [list(r.out) for r in reqs],
                   "launches": {k: c for k, c in res["launches"].items()
                                if c}}
        print(f"[executors decode] {ex}, bf16, paged, {EXEC_SERVE_POLICY}, "
              f"{SERVE_SLOTS} slots: "
              f"decode {ms:.3f} ms per step (median of {len(steps)} "
              f"decode-only steps, host clock), {n} forwards, launches "
              f"{json.dumps(out[ex]['launches'])}")
        del engine
        torch.cuda.empty_cache()
    for ex in ("blocks", "dense"):
        same = out[ex]["tokens"] == out["cuda"]["tokens"]
        print(f"[executors decode] bf16 tokens of {ex} equal to cuda's: "
              f"{same} (not required: bf16 rounds in other orders)")
    return out


def executor_training() -> dict:
    """One fp32 forward + backward of moonshot at full width cut to
    EXEC_TRAIN_LAYERS layers, batch EXEC_TRAIN_BATCH x EXEC_TRAIN_SEQ,
    ``fixed``, on blocks and dense against cuda: the loss within
    EXEC_TRAIN_TOL's relative ``loss``, each gradient within its ``grad``
    times the largest magnitude of cuda's; no kernel launched off cuda.
    One untimed cuda pass first: the process's first backward took 11.8 s
    more than the next (an H100 run)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import device_batch, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig, init_params, loss_fn
    tol = EXEC_TRAIN_TOL
    cfg = get_config("moonshot-v1-16b-a3b").replace(
        n_layers=EXEC_TRAIN_LAYERS)
    model = init_params(cfg, 0, device="cuda").requires_grad_(True)
    params = dict(model.named_parameters())
    batch = device_batch(make_batch(cfg, EXEC_TRAIN_BATCH, EXEC_TRAIN_SEQ,
                                    step=0, seed=1), "cuda")
    rc = RunConfig(loss_chunk=LOSS_CHUNK)
    torch.autograd.grad(loss_fn(model, cfg, rc, batch)[0],
                        list(params.values()))
    runs, out = {}, {}
    for ex in ("cuda", "blocks", "dense"):
        torch.cuda.synchronize()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, cfg, rc._replace(executor=ex), batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        launched = {n: c for n, c in ops.LAUNCHES.items() if c}
        if (ex == "cuda") != bool(launched):
            raise AssertionError(f"[executors train] {ex}: launches "
                                 f"{launched}")
        runs[ex] = (loss.detach(), grads)
        out[ex] = {"loss": float(loss.detach()),
                   "seconds": time.perf_counter() - t0,
                   "peak_bytes": torch.cuda.max_memory_allocated()
                   - resident, "launches": launched}
        del loss
    loss_c, grads_c = runs["cuda"]
    for ex in ("blocks", "dense"):
        loss, grads = runs[ex]
        loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
        if loss_err > tol["loss"]:
            raise AssertionError(f"[executors train] {ex} loss "
                                 f"{float(loss):.7f}, cuda "
                                 f"{float(loss_c):.7f}")
        worst, worst_name = 0.0, None
        for name, g, gc in zip(params, grads, grads_c):
            scale = gc.abs().max().item()
            err = (g - gc).abs().max().item()
            if not torch.isfinite(g).all() or err > tol["grad"] * scale:
                raise AssertionError(f"[executors train] {ex} {name}: "
                                     f"max|diff| {err:.3e}, largest cuda "
                                     f"magnitude {scale:.3e}")
            rel = err / scale if scale > 0 else 0.0
            if rel >= worst:
                worst, worst_name = rel, name
        out[ex].update(loss_rel_err=loss_err, worst_rel_grad_err=worst,
                       worst_param=worst_name)
    for ex, r in out.items():
        print(f"[executors train] {cfg.name} full width, {cfg.n_layers} "
              f"layers, fp32, fixed, batch {EXEC_TRAIN_BATCH} x seq "
              f"{EXEC_TRAIN_SEQ}, {ex}: loss {r['loss']:.7f}, forward + "
              f"backward {r['seconds'] * 1e3:.1f} ms (host clock, one "
              f"call), peak {r['peak_bytes']} bytes above the resident, "
              f"launches {json.dumps(r['launches'])}"
              + ("" if ex == "cuda" else
                 f"; vs cuda: loss {r['loss_rel_err']:.3e} relative "
                 f"(tolerance {tol['loss']:g}), worst gradient "
                 f"{r['worst_rel_grad_err']:.3e} of its largest magnitude "
                 f"({r['worst_param']}; tolerance {tol['grad']:g})"))
    del model, params, runs, grads_c
    torch.cuda.empty_cache()
    return out


def executors_phase(cfg, model, prompts, capacity, paged_kw,
                    layers: int) -> dict:
    """[executors]: the layer cells, the launcher, [serve paged]'s traffic
    and the training check on the three executors (see the module
    docstring), under the card's name and power limit."""
    t0 = time.perf_counter()
    print(f"[executors] the port's executors (cuda, blocks, dense) on "
          f"{smi_line()}")
    out = {"layers": executor_layers()}
    out["launcher"] = executor_launcher(cfg, layers)
    out["decode"] = executor_decode(cfg, model, prompts, capacity, paged_kw)
    out["train"] = executor_training()
    out["seconds"] = time.perf_counter() - t0
    print(f"[executors] {out['seconds']:.1f} s")
    return out


# [analysis]: the dry run (repro_torch.launch.dryrun, fake tensors, on the
# host) of the measured paths.  Each case: arch, depth (None: the whole),
# kind, batch x seq, remat, and whether AdamW's state and step are in it.
# The serving case's seq is [serve paged]'s capacity (analysis_prediction
# rebuilds it from the same seeded prompts)
ANALYSIS_CASES = {
    "train mla": dict(arch="deepseek-v2-236b", layers=MLA_TRAIN_LAYERS,
                      kind="train", batch=MLA_TRAIN_BATCH,
                      seq=MLA_TRAIN_SEQ, remat=False, optimizer=False),
    "train mla with AdamW": dict(arch="deepseek-v2-236b",
                                 layers=MLA_TRAIN_LAYERS, kind="train",
                                 batch=MLA_TRAIN_BATCH, seq=MLA_TRAIN_SEQ,
                                 remat=False, optimizer=True),
    "train zamba2 full depth": dict(arch="zamba2-7b", layers=None,
                                    kind="train", batch=ZAMBA_FULL_BATCH,
                                    seq=ZAMBA_TRAIN_SEQ, remat=True,
                                    optimizer=False),
    "train zamba2 full depth with AdamW": dict(
        arch="zamba2-7b", layers=None, kind="train", batch=ZAMBA_FULL_BATCH,
        seq=ZAMBA_TRAIN_SEQ, remat=True, optimizer=True),
    "train rwkv6": dict(arch="rwkv6-1.6b", layers=None, kind="train",
                        batch=RWKV_TRAIN_BATCH, seq=RWKV_TRAIN_SEQ,
                        remat=True, optimizer=True),
    "serve paged": dict(arch="moonshot-v1-16b-a3b", layers=None,  # --layers
                        kind="decode", batch=SERVE_SLOTS, seq=None,
                        remat=False, optimizer=False),
    # [serve ckpt]'s int8 model: the launcher's prompts are at most 64
    # tokens (its parameter bytes do not depend on the cache's length)
    "serve ckpt int8": dict(arch="moonshot-v1-16b-a3b", layers=RESUME_LAYERS,
                            kind="decode", batch=SERVE_SLOTS,
                            seq=64 + SERVE_MAX_NEW + 1, remat=False,
                            optimizer=False, quant="int8_expert"),
}
# the verdicts the dry run must give against one card's 80 GB
FIT_VERDICTS = {"train mla with AdamW": False,
                "train zamba2 full depth with AdamW": False,
                "train zamba2 full depth": True}
ANALYSIS_DIR = ROOT / "build" / "analysis"


def analysis_prediction(tag: str, out_path: str,
                        layers: int = TRAIN_LAYERS) -> None:
    """Run ANALYSIS_CASES[tag] through the dry run and write its record to
    ``out_path``: one case in a process of its own (``start_analysis``),
    on fake tensors, so nothing here allocates."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.train import LOSS_CHUNK
    from repro_torch.models.lm import RunConfig
    torch.set_num_threads(1)
    case = ANALYSIS_CASES[tag]
    cfg = get_config(case["arch"])
    serve = case["kind"] == "decode"
    depth = layers if serve and case["layers"] is None else case["layers"]
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    rc = RunConfig(compute_dtype=torch.bfloat16,
                   param_dtype=torch.bfloat16 if serve else torch.float32,
                   loss_chunk=LOSS_CHUNK, remat=case["remat"],
                   schedule_policy="dynamic" if serve else "fixed")
    seq = case["seq"]
    if seq is None:       # [serve paged]'s capacity, from the same prompts
        seq = max(48, *(len(p) for p in shared_prefix_prompts(
            np.random.default_rng(0), cfg.vocab_size))) + SERVE_MAX_NEW + 1
    t0 = time.perf_counter()
    rec = run_cell(case["arch"], ShapeConfig(tag, seq, case["batch"],
                                             case["kind"]), "1x1",
                   cfg=cfg, rc=rc, accum=1, optimizer=case["optimizer"],
                   quant=case.get("quant", "none"))
    if rec["status"] == "ok":
        rec.pop("traceback", None)
    rec["host_s"] = time.perf_counter() - t0
    rec["case"] = dict(case, layers=cfg.n_layers, seq=seq)
    pathlib.Path(out_path).write_text(json.dumps(rec, indent=1))


def start_analysis(layers: int) -> dict:
    """Each ``analysis_prediction`` in a process of its own, all at once,
    started after the last timed phase (the dry run is host work: beside a
    timed phase it would load the host that phase's steps wait on); each
    is killed at exit if it still runs.  {tag: (process, record, log)}."""
    import atexit
    import os
    ANALYSIS_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    jobs = {}
    for i, tag in enumerate(ANALYSIS_CASES):
        out = ANALYSIS_DIR / f"prediction{i}.json"
        if out.exists():
            out.unlink()
        log = open(ANALYSIS_DIR / f"prediction{i}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke."
             f"analysis_prediction({tag!r}, {str(out)!r}, {layers})"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        atexit.register(proc.kill)
        jobs[tag] = (proc, out, log)
    return jobs


def wait_analysis(jobs: dict, timeout: float = 600) -> dict:
    """The dry run's records, {tag: record}; fails the phase if a case
    did not end in ``timeout`` s, exited with an error or is not ok."""
    t_end = time.perf_counter() + timeout
    pred = {}
    for tag, (proc, path, log) in jobs.items():
        try:
            rc = proc.wait(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"[analysis] the dry run of {tag} did not end in "
                 f"{timeout:.0f} s")
        log.close()
        if rc != 0 or not path.exists():
            tail = pathlib.Path(log.name).read_text()[-3000:]
            fail(f"[analysis] the dry run of {tag} exited with {rc}:\n{tail}")
        pred[tag] = json.loads(path.read_text())
    bad = [t for t, r in pred.items() if r["status"] != "ok"]
    if bad:
        fail("[analysis] dry run not ok: " + "; ".join(
            f"{t}: {pred[t].get('error')} at {pred[t].get('where')}"
            for t in bad))
    return pred


def _alloc_check(tag: str, what: str, alloc: dict, measured: int,
                 n_tensors: int, extra: int = 0) -> None:
    """The allocator's count ``measured`` of ``n_tensors`` tensors against
    the dry run's ``alloc`` (``argument_alloc`` of a group) and ``extra``
    tensors of one 512-byte block each (the loss beside the gradients):
    as many tensors, and at least their bytes rounded to 512 B, at most
    that and an unsplit remainder of 1 MiB for each tensor past 1 MiB
    (the caching allocator splits a larger remainder off)."""
    from repro_torch.launch.dryrun import ALLOC_BLOCK, ALLOC_SMALL
    predicted = alloc["alloc_bytes"] + extra * ALLOC_BLOCK
    slack = alloc["large"] * ALLOC_SMALL
    diff = measured - predicted
    want = alloc["tensors"] + extra
    ok = n_tensors == want and 0 <= diff <= slack
    print(f"[analysis memory] {tag}: {what}: {want} tensors predicted, "
          f"{predicted:,} bytes at 512-B rounding; the allocator's "
          f"{n_tensors} tensors, {measured:,} bytes ({diff:+,}; up to "
          f"{slack:,} of unsplit remainders for {alloc['large']} tensors "
          f"past 1 MiB): "
          + ("equal within the rounding" if ok else "DIFFERENT"))
    if not ok:
        fail(f"[analysis] {tag}: {what}: {n_tensors} tensors of {measured} "
             f"bytes on the card, {want} of {predicted} predicted")


def _peak_line(tag: str, rec: dict, peak: int, resident: int,
               smi: str) -> float:
    """The predicted peak beside the phase's own: its peak less what the
    earlier phases left allocated when it began (``resident``)."""
    m = rec["memory"]
    pred = m["argument_bytes"] + m["temp_bytes"]
    ratio = pred / (peak - resident)
    print(f"[analysis memory] {tag}: predicted peak {pred / 1e9:.2f} GB "
          f"({m['argument_bytes'] / 1e9:.2f} GB of arguments "
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                      m["argument_parts"].items())
          + f"; {m['temp_bytes'] / 1e9:.2f} GB above them), measured "
          f"{(peak - resident) / 1e9:.2f} GB ({peak / 1e9:.2f} GB, of it "
          f"{resident / 1e9:.2f} GB left allocated by earlier phases): ratio "
          f"{ratio:.3f}; dry run {rec['compile_s']} s on the host; {smi}")
    return ratio


def quant_bounds_4096(smi: str) -> dict:
    """The bounds of B1 and B2 on int8 and int4 experts at moonshot's MoE
    layer at T = 4096 tokens (the training shape's forward, bf16), on
    both schedules: the compressed-byte bound ``QuantCase.work`` gives the
    T=2 and T=64 rows, from this run's routing; nothing is timed."""
    import torch
    out = {}
    T = TRAIN_BATCH * TRAIN_SEQ
    for policy in ("fixed", "dynamic"):
        c = Case(MOONSHOT, T, torch.bfloat16, seed=T, policy=policy)
        for fmt, scheme in REPORT_SCHEME.items():
            qc = QuantCase(c, scheme)
            for name in ("fused_gate_up", "grouped_gemm"):
                n_bytes, flops = qc.work(name)
                b_ms, by = bound_ms(n_bytes, flops)
                out[f"{name}_{fmt} {policy}"] = {
                    "bound_ms": b_ms, "bound_by": by, "bytes": n_bytes,
                    "flops": flops}
                print(f"[analysis bound] {name} {fmt} ({scheme}) moonshot "
                      f"bf16 T={T} {policy}: bound {b_ms * 1e3:.2f} us "
                      f"({by}; {n_bytes / 1e6:.2f} MB, {flops / 1e9:.1f} "
                      f"GFLOP); {smi}")
            del qc
        del c
        torch.cuda.empty_cache()
    return out


def timed_steps(s: dict) -> list:
    """Every decode step and training step the phases timed, from their
    summaries: tag, arch, layers, kind, batch, seq, remat, the median ms;
    of a served one each decode step's row contexts and routed experts,
    and a quantized one's stored bytes of its routed experts."""
    rows = []
    serve_kv = s["capacity"]

    def row(tag, arch, layers, kind, B, S, remat, ms, summ=None):
        summ = summ or {}
        rows.append(dict(tag=tag, arch=arch, layers=layers, kind=kind,
                         batch=B, seq=S, remat=remat, ms=ms,
                         context=summ.get("decode_context"),
                         routed=summ.get("decode_routed_experts"),
                         expert_bytes=summ.get("expert_bytes")))
    for tag, arch, summ in (
            [("serve paged", "moonshot-v1-16b-a3b", s["paged"]),
             ("serve contiguous", "moonshot-v1-16b-a3b", s["contiguous"])]
            + [(f"serve paged {k}", "moonshot-v1-16b-a3b", v)
               for k, v in s["quant"].items()]
            + [(f"serve deepseek {k}", "deepseek-v2-236b", v)
               for k, v in s["deepseek"].items()]
            + [(f"serve gemma2 {k}", "gemma2-9b", v)
               for k, v in s["gemma2"].items()]
            + [(f"serve {k}", k, v) for k, v in s["dense"].items()]):
        if isinstance(summ, dict) and "decode_ms_per_step_p50" in summ:
            row(tag, arch, summ["layers"], "decode", SERVE_SLOTS, serve_kv,
                False, summ["decode_ms_per_step_p50"], summ)
    for arch, summ in list((k, v["serve"]) for k, v in
                           s["recurrent"].items()) + [
            (VLM_ARCH, s["serve_vlm"])]:
        row(f"serve {arch}", arch, summ["layers"], "decode", SERVE_SLOTS,
            summ["prompt_tokens"] + summ["max_new"], False,
            summ["decode_ms_per_step_p50"], summ)
    for tag, summ, remat in (("train", s["train"], False),
                             ("train capacity remat", s["train_cap"], True)):
        row(tag, "moonshot-v1-16b-a3b", TRAIN_LAYERS, "train", TRAIN_BATCH,
            TRAIN_SEQ, remat, summ["step_ms_median_after_first"])
    for tag, summ in (("train dense", s["train_dense"]),
                      ("train hubert", s["train_hubert"]),
                      ("train vlm", s["train_vlm"]),
                      ("train rwkv6", s["train_rwkv6"]),
                      ("train zamba2", s["train_zamba2"])):
        row(tag, summ.get("arch", DENSE_TRAIN_ARCH), summ.get("layers"),
            "train", summ.get("batch", DENSE_TRAIN_BATCH),
            summ.get("seq", DENSE_TRAIN_SEQ), True, summ["step_ms_median"])
    return rows


def step_bound(r: dict, smi: str) -> dict:
    """The bound of a timed step (``analysis.flops.step_work`` on one
    card over the H100's rates): a training step's at its shape; a decode
    step's for each timed decode step, at its rows' contexts and the
    experts its router chose (a quantized model's at their stored bytes),
    and the median of those beside the median ms."""
    import numpy as np
    from repro_torch.analysis.flops import step_work
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.lm import n_moe_layers
    cfg = get_config(r["arch"])
    cfg = cfg.replace(n_layers=r["layers"]) if r["layers"] else cfg
    steps = [dict(context=None, routed=None)]
    if r["kind"] == "decode" and r["context"]:
        routed = r["routed"] or [None] * len(r["context"])
        steps = [dict(context=c, routed=n)
                 for c, n in zip(r["context"], routed)]
    eb = None
    if r["expert_bytes"]:
        eb = r["expert_bytes"] / (n_moe_layers(cfg) * cfg.moe.n_experts)
    works = [step_work(cfg, ShapeConfig(r["tag"], r["seq"], r["batch"],
                                        r["kind"]), remat=r["remat"],
                       expert_bytes=eb, **st) for st in steps]
    bounds = [bound_ms(w.hbm_bytes, w.flops) for w in works]
    i = int(np.argsort([b for b, _ in bounds])[(len(bounds) - 1) // 2])
    w, (b_ms, by) = works[i], bounds[i]
    out = {"tag": r["tag"], "arch": r["arch"], "layers": cfg.n_layers,
           "kind": r["kind"], "batch": r["batch"], "seq": r["seq"],
           "ms": r["ms"], "bound_ms": b_ms, "bound_by": by,
           "share": b_ms / r["ms"], "flops": w.flops,
           "hbm_bytes": w.hbm_bytes, "bytes_by_part": w.parts,
           "decode_steps": len(steps) if r["context"] else None,
           "routed_experts": steps[i]["routed"],
           "context": steps[i]["context"], "expert_bytes": eb}
    what = (f"{r['kind']} {r['batch']} x {r['seq']}" if not r["context"]
            else f"decode, the median bound of {len(steps)} timed steps: "
            f"rows at {steps[i]['context']} positions"
            + (f", {steps[i]['routed']} routed experts over "
               f"{n_moe_layers(cfg)} MoE layers" if steps[i]["routed"]
               else "")
            + (f" at {eb / 1e6:.2f} MB stored each" if eb else ""))
    print(f"[analysis roofline] {r['tag']}: {r['arch']}, {cfg.n_layers} "
          f"layers, {what}: bound {b_ms:.3f} ms ({by}; "
          f"{w.flops / 1e12:.3f} TFLOP over "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
          f"{w.hbm_bytes / 1e9:.3f} GB over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in w.parts.items())
          + f"), measured {r['ms']:.3f} ms: share {out['share']:.4f}; "
          f"{smi}")
    return out


def analysis(layers: int, s: dict) -> dict:
    """[analysis]: the dry run's predictions against what the phases
    measured, the fit verdicts, the roofline shares, the quickstart.  The
    dry run starts here, after every timed phase; the card's own work of
    the phase runs while it does."""
    import os

    import torch
    from repro_torch.analysis.roofline import HBM_PER_CHIP
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import init_opt_state
    t0 = time.perf_counter()
    jobs = start_analysis(layers)
    smi = smi_line()
    out = {}
    # rwkv6's fp32 parameters and AdamW moments, made here on the card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0 = torch.cuda.memory_allocated()
    model = init_params(get_config("rwkv6-1.6b"), 0, device="cuda")
    a1 = torch.cuda.memory_allocated()
    params = dict(model.named_parameters())
    opt = init_opt_state(params)
    a2 = torch.cuda.memory_allocated()
    rwkv_made = (a1 - a0, len(params), a2 - a1, len(params) * 2 + 1)
    del model, params, opt
    torch.cuda.empty_cache()
    out["roofline"] = [step_bound(r, smi) for r in timed_steps(s)]
    out["quant_bounds_4096"] = quant_bounds_4096(smi)
    # the quickstart example on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    q = subprocess.run([sys.executable, "examples/torch/quickstart.py"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    tail = (q.stdout + q.stderr).strip().splitlines()[-3:]
    print(f"[analysis example] examples/torch/quickstart.py exit {q.returncode}"
          f" in {time.perf_counter() - t1:.1f} s: " + " | ".join(tail))
    if q.returncode != 0:
        fail(f"[analysis] quickstart exited with {q.returncode}:\n"
             + (q.stdout + q.stderr)[-3000:])
    out["quickstart_exit"] = q.returncode
    t2 = time.perf_counter()
    pred = wait_analysis(jobs)
    print(f"[analysis] the dry run's {len(pred)} cases ran on the host after "
          f"the timed phases, at once ({max(r['host_s'] for r in pred.values()):.1f}"
          f" s the longest, {sum(r['host_s'] for r in pred.values()):.1f} s "
          f"in all; waited {time.perf_counter() - t2:.1f} s of the phase's "
          f"{time.perf_counter() - t0:.1f} s); bytes and FLOPs reckoned on "
          f"fake tensors, not measured on the card")
    out["predictions"] = {t: {k: r[k] for k in ("case", "memory", "cost",
                                                "host_s")}
                          for t, r in pred.items()}
    for r in out["predictions"].values():
        r["cost"] = {k: v for k, v in r["cost"].items() if k != "flops_by_op"}
    # parameters, gradients, optimizer state: the allocator's count
    mla, zf, served = s["train_mla"], s["zamba2_full"], s["served"]
    full = pred["train zamba2 full depth"]["case"]["layers"]
    if zf.get("layers") != full:
        fail(f"[analysis] [train zamba2] did not run its full depth "
             f"({full} layers) though the dry run says it fits: "
             f"{json.dumps(zf)[:300]}")

    def alloc(tag, part):
        return pred[tag]["memory"]["argument_alloc"][part]
    _alloc_check("train mla", "fp32 parameters", alloc("train mla", "params"),
                 mla["weight_bytes"], mla["weight_tensors"])
    _alloc_check("train zamba2 full depth", "fp32 parameters",
                 alloc("train zamba2 full depth", "params"),
                 zf["weight_bytes"], zf["weight_tensors"])
    # every parameter takes a gradient of its own dtype and size, and the
    # scalar loss stays allocated beside them
    _alloc_check("train zamba2 full depth", "gradients",
                 alloc("train zamba2 full depth", "params"),
                 zf["grad_alloc_bytes"], zf["grad_tensors"] + 1, extra=1)
    _alloc_check("serve paged", "bf16 parameters",
                 alloc("serve paged", "params"), served["weight_bytes"],
                 served["weight_tensors"])
    # the engine's quantize_model on the fake parameters and on the card
    q8 = s["serve_ckpt"]["arms"]["bf16 int8_expert"]
    _alloc_check("serve ckpt int8", "bf16 parameters, int8_expert experts",
                 alloc("serve ckpt int8", "params"), q8["weight_bytes"],
                 q8["weight_tensors"])
    _alloc_check("train rwkv6", "fp32 parameters",
                 alloc("train rwkv6", "params"), rwkv_made[0], rwkv_made[1])
    _alloc_check("train rwkv6", "AdamW moments and step",
                 alloc("train rwkv6", "opt"), rwkv_made[2], rwkv_made[3])
    # the predicted peak beside the measured one
    rwk = s["train_rwkv6"]
    out["peak_ratio"] = {
        "train mla": _peak_line("train mla", pred["train mla"],
                                mla["peak_bytes"],
                                mla["resident_before_bytes"], smi),
        "train zamba2 full depth": _peak_line(
            "train zamba2 full depth", pred["train zamba2 full depth"],
            zf["peak_bytes"], zf["resident_bytes"], smi),
        "train rwkv6": _peak_line("train rwkv6", pred["train rwkv6"],
                                  rwk["peak_bytes"],
                                  rwk["resident_before_bytes"], smi),
        "serve paged": _peak_line("serve paged", pred["serve paged"],
                                  served["peak_bytes"],
                                  served["resident_before_bytes"], smi)}
    # fit verdicts
    out["fits"] = {}
    for tag, want in FIT_VERDICTS.items():
        m = pred[tag]["memory"]
        peak = m["argument_bytes"] + m["temp_bytes"]
        fits = peak <= HBM_PER_CHIP
        out["fits"][tag] = fits
        print(f"[analysis fit] {tag}: predicted peak {peak / 1e9:.2f} GB "
              f"({m['argument_bytes'] / 1e9:.2f} GB of parameters, state "
              f"and batch): " + ("fits" if fits else "does not fit")
              + f" {HBM_PER_CHIP / 1e9:.0f} GB")
        if fits != want:
            fail(f"[analysis] {tag}: the dry run says "
                 f"{'fits' if fits else 'does not fit'}, expected "
                 f"{'fits' if want else 'does not fit'}")
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="served depth (1 dense + layers-1 MoE); default 4")
    layers = ap.parse_args().layers
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch is not beside this script: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed(phase: str) -> None:
        print(f"[elapsed] {phase}: {time.perf_counter() - t_start:.1f} s "
              "since the start")

    # 1. device ------------------------------------------------------------
    smi = smi_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"[device] {device_name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    # 2. build -------------------------------------------------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a) into {_build.BUILD_DIR.relative_to(ROOT)}; per "
          "source (in parallel): " + ", ".join(
              f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items())))
    entry, spill = None, ""
    for line in _build.build_log.splitlines():      # ptxas -v, per kernel
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif "spill stores" in line and entry is not None:
            spill = "; " + line.strip()
        elif "Used" in line and entry is not None:
            print(f"  ptxas {kernel_name(entry)}: "
                  f"{line.split(':', 1)[1].strip()}{spill}")
            entry = None
    elapsed("build")
    sass_job = start_sass(_build.build())

    # 3. kernels against plain versions, then times ---------------------------
    print("[kernels] CUDA kernel vs plain PyTorch version on the card")
    errs: dict = {}
    timings = {}                      # (policy, T) -> per-kernel times
    qtimings = {}                     # (scheme, policy, T) -> GEMM times
    padding = []
    for shape, policies, Ts in ((MOONSHOT, ("fixed", "dynamic"),
                                 (2, 4, VERIFY_ROWS, 64)),
                                (MIXTRAL, ("fixed", "dynamic"), (512,))):
        for policy in policies:
            for dtype in (torch.bfloat16, torch.float32):
                for T in Ts:
                    c = Case(shape, T, dtype, seed=T, policy=policy)
                    check_case(c, errs)
                    if shape is MOONSHOT and dtype == torch.bfloat16:
                        if T in (SERVE_SLOTS, VERIFY_ROWS, 64):
                            timings[policy, T] = time_case(c)
                        padding.append(padding_share(c))
                    if shape is MOONSHOT and (policy, T) in QUANT_SHAPES:
                        for scheme in QUANT_SCHEMES:
                            qc = QuantCase(c, scheme)
                            check_quant_case(qc, errs)
                            if dtype == torch.bfloat16:
                                qtimings[scheme, policy, T] = \
                                    time_quant_case(qc)
                            del qc
                    del c
                    torch.cuda.empty_cache()
    elapsed("kernels, moonshot and mixtral")
    # B1-B5 at deepseek-v2's MoE layer (E=160, d=5120, f=1536, softmax)
    ds_timings = {}                   # (policy, T) -> per-kernel times
    ds_qtimings = {}                  # T -> int8_expert GEMM times (dynamic)
    for policy in ("fixed", "dynamic"):
        for dtype in (torch.bfloat16, torch.float32):
            for T in (SERVE_SLOTS, 64):
                c = Case(DEEPSEEK, T, dtype, seed=200 + T, policy=policy)
                check_case(c, errs)
                if dtype == torch.bfloat16:
                    ds_timings[policy, T] = time_case(c)
                    padding.append(padding_share(c))
                if policy == "dynamic":
                    qc = QuantCase(c, "int8_expert")
                    check_quant_case(qc, errs)
                    if dtype == torch.bfloat16:
                        ds_qtimings[T] = time_quant_case(qc)
                    del qc
                del c
                torch.cuda.empty_cache()
    elapsed("kernels, deepseek-v2")
    # B1-B5 at the training shape (T = 4096 tokens, bf16): the forward that
    # each training step runs, held and timed; and at deepseek-v2's layer
    for shape, tm in ((MOONSHOT, timings), (DEEPSEEK, ds_timings)):
        for policy in ("fixed", "dynamic"):
            c = Case(shape, TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16,
                     seed=TRAIN_BATCH * TRAIN_SEQ, policy=policy)
            check_case(c, errs)
            tm[policy, TRAIN_BATCH * TRAIN_SEQ] = time_case(c)
            del c
            torch.cuda.empty_cache()
    elapsed("kernels, the training shape's forward")
    # the backward's B7 and B1^T at the training shape (T = 4096 tokens):
    # moonshot's MoE layer and deepseek-v2's (E=160), both policies, in both
    # orientations the layer's backward runs (gate/up and down)
    train_t = {}              # (arch, policy, orient) -> per-kernel times
    for arch, shape in (("moonshot", MOONSHOT), ("deepseek", DEEPSEEK)):
        for policy in ("fixed", "dynamic"):
            for orient in ("gate_up", "down"):
                # fp32 at moonshot's layer; deepseek's held in bf16, timed
                for dtype in ((torch.bfloat16, torch.float32)
                              if arch == "moonshot" else (torch.bfloat16,)):
                    c = TrainCase(shape, TRAIN_BATCH * TRAIN_SEQ, dtype,
                                  seed=500, policy=policy, orient=orient)
                    check_train_case(c, errs)
                    if dtype == torch.bfloat16:
                        train_t[arch, policy, orient] = time_train_case(c)
                    del c
                    torch.cuda.empty_cache()
    elapsed("kernels, the backward's B7 and B1^T")
    # [capacity]: the five kernels, the quantized GEMMs and the backward's
    # on capacity_factor schedules; B1 and B2 timed beside fixed and dynamic
    capacity = check_capacity(errs)
    for orient, tm in capacity["train"].items():
        train_t["moonshot", "capacity_factor", orient] = tm
    cap_t = {(arch, T): time_capacity(shape, T, seed=T)
             for arch, shape, T in (("moonshot", MOONSHOT, 2),
                                    ("moonshot", MOONSHOT, 64),
                                    ("moonshot", MOONSHOT,
                                     TRAIN_BATCH * TRAIN_SEQ),
                                    ("deepseek", DEEPSEEK, 2))}
    for (arch, T), tm in cap_t.items():
        for name, t in tm.items():
            print(f"[times capacity] {name} {arch} bf16 T={T}: " + "; ".join(
                f"{p} {v['ms'] * 1e3:.1f} us (turns "
                + "/".join(f"{x * 1e3:.1f}" for x in v["turns_ms"])
                + f"; bound {v['bound_ms'] * 1e3:.2f} {v['bound_by']}; "
                f"{v['active_blocks']} active blocks of {v['block_m']}, "
                f"capacity {v['capacity']})" for p, v in t.items()))
    elapsed("capacity")
    check_paged(errs)
    paged_t = {k: time_paged(k) for k in PAGED_SHAPES}
    elapsed("kernels, GQA attention")
    check_mla(errs)
    mla_t = {k: time_mla(k) for k in MLA_SHAPES}
    mla_t["decode bs64"] = time_mla("decode bs64", MLA_DECODE_BS64)
    elapsed("kernels, MLA attention")
    # B5 alone at every router, then timed at mixtral's and deepseek-v3's
    # (moonshot's and deepseek-v2's are timed in their Cases); the floor
    for arch in ROUTERS:
        for T in ROUTE_CHECK_TS:
            check_router(arch, T, errs)
    route_t = {(arch, T): time_router(arch, T)
               for arch in ("mixtral-8x7b", "deepseek-v3")
               for T in ROUTE_TIME_TS}
    floor = time_launch_floor()
    for p in padding:
        print(f"[padding] E={p['E']} bf16 T={p['T']} {p['policy']}: block_m "
              f"{p['block_m']}, capacity {p['capacity']} rows "
              f"({p['blocks']} blocks, {p['active_blocks']} active); GEMM "
              f"rows computed {p['computed_rows']} (padding share "
              f"{p['computed_padding_share']:.4f}); written MB "
              f"{json.dumps(p['written_MB'])}, of which padding MB "
              f"{json.dumps(p['padding_MB'])} (share "
              f"{p['padding_share']:.4f}); expert weights read "
              f"{p['expert_weight_MB_read']:.1f} MB once per expert, "
              f"{p['weights_read_by_blocks_MB']:.1f} MB once per active "
              f"block")
    for arch, tm in (("moonshot", timings), ("deepseek", ds_timings)):
        for policy, T in sorted(tm):
            t = tm[policy, T]
            print(f"[times] {arch} bf16 T={T} {policy}: " + "; ".join(
                f"{n} {t[n]['ms'] * 1e3:.1f} us (bound "
                f"{t[n]['bound_ms'] * 1e3:.2f}, plain "
                f"{t[n]['plain_ms'] * 1e3:.1f}, library "
                + ("null" if t[n]['library_ms'] is None
                   else f"{t[n]['library_ms'] * 1e3:.1f}") + ")"
                for n in MOE_KERNELS))
    elapsed("kernels, router, launch floor")
    # the SASS counts of the Hopper kernels, from cuobjdump started after
    # the build
    sass = sass_counts(sass_job)
    print("[build] SASS of the Hopper kernels (cuobjdump -sass):")
    for fn, n in sass.items():
        print(f"  SASS {fn[:72]}: HGMMA {n['HGMMA']}, UTMALDG {n['UTMALDG']}")
    for name, stem in HOPPER_KERNELS.items():
        found = [n for fn, n in sass.items() if stem in fn]
        if not found or any(n["HGMMA"] == 0 or n["UTMALDG"] == 0
                            for n in found):
            fail(f"{name}: no wgmma or no TMA load in the SASS of {stem}")
    for (arch, policy, orient), tm in sorted(train_t.items()):
        for n, t in tm.items():
            lib = ("null: " + t["library_null_reason"]
                   if t["library_ms"] is None
                   else f"{t['library_ms'] * 1e3:.1f} us ({t['library']})")
            print(f"[times] {n} {arch} bf16 T={TRAIN_BATCH * TRAIN_SEQ} "
                  f"{policy} {orient} ({t['active_blocks']} active blocks of "
                  f"{t['block_m']}): {t['ms'] * 1e3:.1f} us (eager "
                  f"{t['eager_ms'] * 1e3:.1f}), bound "
                  f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}; bytes "
                  f"{t['bound_bytes_ms'] * 1e3:.2f} us for "
                  f"{t['bytes'] / 1e6:.1f} MB, tensor-core operations "
                  f"{t['bound_ops_ms'] * 1e3:.2f} us for "
                  f"{t['flops'] / 1e9:.1f} GFLOP), plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, library {lib}")
    for arch, scheme, policy, T, t in (
            [("moonshot", *k, v) for k, v in sorted(qtimings.items())]
            + [("deepseek", "int8_expert", "dynamic", T, v)
               for T, v in sorted(ds_qtimings.items())]):
        print(f"[times] {arch} bf16 T={T} {policy} {scheme}: " + "; ".join(
            f"{n} {t[n]['ms'] * 1e3:.1f} us (eager "
            f"{t[n]['eager_ms'] * 1e3:.1f}, bound "
            f"{t[n]['bound_ms'] * 1e3:.2f} for {t[n]['bytes'] / 1e6:.2f} MB, "
            f"dense bf16 kernel {t[n]['dense_ms'] * 1e3:.1f}, in turns "
            + "/".join(f"{v * 1e3:.1f}" for v in t[n]["turns_ms"])
            + f", plain {t[n]['plain_ms'] * 1e3:.1f}, grouped_mm over the "
            + ("dequantized stack " if n == "grouped_gemm" else
               "dequantized gate|up stacks ")
            + ("null" if t[n]["grouped_mm_dequantized_ms"] is None
               else f"{t[n]['grouped_mm_dequantized_ms'] * 1e3:.1f}")
            + ")" for n in ("fused_gate_up", "grouped_gemm")))
    for step_kind, t in paged_t.items():
        print(f"[times] paged_attention {t['arch']} bf16 {step_kind} "
              f"B={t['rows']} Hkv={t['Hkv']} G={t['G']} D={t['D']} "
              f"nb={t['nb']} "
              f"({t['n_split']} splits of {t['per_split']} entries; "
              f"{t['kv_positions_read']} KV positions read, "
              f"{t['row_kv_positions']} over the rows, "
              f"{t['bytes'] / 1e6:.3f} MB): {t['ms'] * 1e3:.1f} us "
              f"(eager {t['eager_ms'] * 1e3:.1f}), bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, SDPA yardstick "
              f"{t['library_ms'] * 1e3:.1f} us (contiguous cache, excludes "
              f"the gather)")
    for step_kind, t in mla_t.items():
        lib = ("null: " + t["library_null_reason"] if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.1f} us ({t['library']})")
        print(f"[times] paged_attention_mla deepseek bf16 {step_kind} "
              f"B={t['rows']} nb={t['nb']} ({t['n_split']} splits of "
              f"{t['per_split']} entries; {t['kv_positions_read']} latent "
              f"positions read, {t['row_kv_positions']} over the rows): "
              f"{t['ms'] * 1e3:.1f} us (eager {t['eager_ms'] * 1e3:.1f}), "
              f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}; bytes "
              f"{t['bound_bytes_ms'] * 1e3:.2f} us for "
              f"{t['bytes'] / 1e6:.3f} MB, tensor-core operations "
              f"{t['bound_ops_ms'] * 1e3:.2f} us for {t['flops'] / 1e9:.3f} "
              f"GFLOP), plain {t['plain_ms'] * 1e3:.1f} us, SDPA yardstick "
              f"{lib}")

    print(f"[times] launch floor (empty kernel): {floor['ms'] * 1e3:.2f} us "
          f"(eager {floor['eager_ms'] * 1e3:.2f})")
    for arch, tm in (("moonshot", timings), ("deepseek", ds_timings)):
        for n in ("router_topk", "unpermute"):
            print(f"[times] {n} {arch} bf16 dynamic: " + "; ".join(
                f"T={T} {tm['dynamic', T][n]['ms'] * 1e3:.2f} us (eager "
                f"{tm['dynamic', T][n]['eager_ms'] * 1e3:.2f}, bound "
                f"{tm['dynamic', T][n]['bound_ms'] * 1e3:.2f}, floor "
                f"{floor['ms'] * 1e3:.2f})"
                for T in ROUTE_TIME_TS))
    for (arch, T), t in sorted(route_t.items()):
        s = ROUTERS[arch]
        print(f"[times] router_topk {arch} E={s['E']} k={s['k']} "
              f"{s['gating']} T={T}: {t['ms'] * 1e3:.2f} us (eager "
              f"{t['eager_ms'] * 1e3:.2f}; most candidates "
              f"{t['most_candidates_ms'] * 1e3:.2f}), bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, floor {floor['ms'] * 1e3:.2f}")

    # 4. MoE layer without a host sync -----------------------------------
    from repro_torch.core.dispatch import MoEDispatchConfig, moe_ffn
    register_plain_executor()
    from repro_torch.quantization import get_scheme
    # deepseek's layer is held in fp32: with routed_scale 16 a one-ulp
    # difference of a bf16 intermediate is several ulps of the output
    for arch, shape, policy, scheme, Ts, dtype in (
            ("moonshot", MOONSHOT, "fixed", "none", (4, 64), torch.bfloat16),
            ("moonshot", MOONSHOT, "dynamic", "none", (4, 64),
             torch.bfloat16),
            ("moonshot", MOONSHOT, "dynamic", "int8_expert", (4, 64),
             torch.bfloat16),
            ("moonshot", MOONSHOT, "dynamic", "int4_packed", (4, 64),
             torch.bfloat16),
            ("deepseek", DEEPSEEK, "fixed", "none", (SERVE_SLOTS, 64),
             torch.float32),
            ("deepseek", DEEPSEEK, "dynamic", "none", (SERVE_SLOTS, 64),
             torch.float32)):
        dt_name = str(dtype).replace("torch.", "")
        for T in Ts:
            c = Case(shape, T, dtype, seed=100 + T)
            ws = (c.wg, c.wu, c.wd)
            if scheme != "none":
                ws = tuple(get_scheme(scheme).quantize(w) for w in ws)
            router = torch.randn((shape["d"], shape["E"]), device="cuda")
            kw = dict(n_experts=shape["E"], top_k=shape["k"],
                      block_m=shape["M"], gating=shape["gating"],
                      norm_topk=shape["norm_topk"],
                      routed_scale=shape["routed_scale"],
                      schedule_policy=policy)
            cfg = MoEDispatchConfig(executor="cuda", **kw)
            moe_ffn(c.x, router, *ws, cfg)     # warm
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                y, _ = moe_ffn(c.x, router, *ws, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            y_p, _ = moe_ffn(c.x, router, *ws,
                             cfg._replace(executor="plain"))
            torch.testing.assert_close(y.float(), y_p.float(),
                                       **TOL[dt_name])
            print(f"[moe_ffn] {arch} T={T} {dt_name} {policy} experts "
                  f"{scheme}: no host sync under set_sync_debug_mode"
                  f"('error'); max_abs_err vs plain "
                  f"{(y.float() - y_p.float()).abs().max().item():.3e}")
            del c, ws
            torch.cuda.empty_cache()

    elapsed("moe_ffn without a host sync")

    # 5. serving, paged --------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.lm import (RunConfig, forward, init_params,
                                       n_moe_layers)
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("moonshot-v1-16b-a3b")
    cfg = cfg.replace(n_layers=layers)
    V = cfg.vocab_size
    print(f"[serve] {cfg.name} at full width (d_model={cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"d_ff_expert={cfg.moe.d_ff_expert}, vocab={V}); "
          f"reduced: n_layers 48 -> {layers} (1 dense + "
          f"{n_moe_layers(cfg)} MoE); random bf16 weights, seed 0")
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    model = init_params(cfg, 0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    served = {"weight_bytes": torch.cuda.memory_allocated() - before,
              "weight_tensors": len(list(model.parameters())),
              "resident_before_bytes": before}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = shared_prefix_prompts(rng, V)
    # room for the profiled 48-token prompts too
    capacity = max(48, *(len(p) for p in prompts)) + SERVE_MAX_NEW + 1
    rc = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="dynamic")
    paged_kw = dict(kv_block_size=KV_BLOCK, prefill_chunk=PREFILL_CHUNK)
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity,
                         rc=rc, **paged_kw)
    print(f"[serve paged] dynamic schedule, blocks of {KV_BLOCK}, prefill "
          f"chunks of {PREFILL_CHUNK}, fused paged read, {SERVE_SLOTS} "
          f"slots x {capacity} tokens; prompts of "
          f"{[len(p) for p in prompts]} tokens, requests 0, 2, 3 share "
          f"{SHARED_PREFIX}")
    reqs = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    paged = serve_and_check("serve paged", engine, reqs, rng)
    served.update(peak_bytes=torch.cuda.max_memory_allocated(),
                  capacity=capacity)
    hit = sum(r.stats["serve/prefix_hit_tokens"] for r in reqs)
    if hit <= 0:
        raise AssertionError("the prefix cache never hit")
    print(f"[serve paged] prefix-hit tokens {hit:.0f} "
          f"({json.dumps(engine.kv.stats())})")
    paged_summary = summarize("serve paged", paged, reqs, layers)
    elapsed("serving moonshot, paged")

    # the first paged step's logits (64 prompt rows) through the kernels
    # and the fused read, and through the plain versions and the gather
    # read, over the first layers and the head (the same weights).  In fp32
    # through CHECK_LAYERS layers, where the two paths differ only in
    # summation order, within LOGIT_TOL_FP32.  In bf16 a one-ulp difference
    # can flip a near-tied top-k pick of a random-weight router and change
    # that row's logits wholesale, so the served dtype is held through
    # layer 0 (dense: no router) and the head, within LOGIT_TOL.
    n_check = min(layers, CHECK_LAYERS)
    cfg_check = cfg.replace(n_layers=n_check)
    head32 = copy.deepcopy(truncated(model, n_check)).float()
    rc32 = rc._replace(compute_dtype=torch.float32)
    for tag, head, cfg_h, rc_h, tol in (
            ("fp32", head32, cfg_check, rc32, LOGIT_TOL_FP32),
            ("bf16", truncated(model, 1), cfg.replace(n_layers=1), rc,
             LOGIT_TOL)):
        logits, logits_p, n_rows = first_step_logits(head, cfg_h, rc_h,
                                                     prompts, capacity,
                                                     paged_kw)
        torch.testing.assert_close(logits, logits_p, **tol)
        print(f"[serve paged] first paged step ({n_rows} prompt rows, "
              f"{cfg_h.n_layers} layers, {tag}) fused read + kernels vs "
              f"gather read + plain versions: max_abs_err "
              f"{(logits - logits_p).abs().max().item():.3e} (|logits| max "
              f"{logits_p.abs().max().item():.2f}; tolerance rtol=atol="
              f"{tol['atol']:g}); argmax equal: "
              f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
    del head, head32
    torch.cuda.empty_cache()
    elapsed("serving moonshot, first-step logits")

    # where the time goes: two prompt-chunk steps, then five decode steps
    for i in range(SERVE_SLOTS):
        engine.admit(Request(rid=100 + i, prompt=rng.integers(
            0, V, 48).astype(np.int32), max_new=16))
    paged_prof = {"prefill": profile_window(
                      lambda: [engine.step() for _ in range(2)]),
                  "decode": profile_window(
                      lambda: [engine.step() for _ in range(5)])}
    print_profile("serve paged", "2 chunk steps, 2 x 48 prompt tokens",
                  paged_prof)
    del engine
    torch.cuda.empty_cache()

    # [tune]: B1 and B2 swept over their tile shapes, then [serve paged]'s
    # requests served with autotune on from the swept cache
    tune = tune_sweeps()
    tune["serve"] = serve_tuned(cfg, model, prompts, capacity, paged_kw,
                                tune.pop("cache"))
    print(json.dumps({"tune": {"serve": tune["serve"],
                               "keys": {k: {x: v[x] for x in (
                                   "winner", "default_us")}
                                   for k, v in tune["keys"].items()}}}))
    elapsed("tune")

    # [serve obs]: observability, admission policies and preemption on the
    # same model and prompts
    obs_summary = serve_obs(cfg, model, prompts, capacity, paged_kw)
    print(json.dumps({"serve_obs": obs_summary}))
    elapsed("serving moonshot, observability and preemption")

    # [serve sample], [serve spec] and [serve loadgen] on the same model and
    # traffic; their fp32 checks on an fp32 copy of its first CHECK_LAYERS
    # layers
    model32 = copy.deepcopy(truncated(model, n_check)).float()
    sample_summary = serve_sample(cfg, model, model32, cfg_check, prompts,
                                  capacity, paged_kw)
    print(json.dumps({"serve_sample": sample_summary}))
    elapsed("serving moonshot, sampling")
    spec_summary = serve_spec(cfg, model, model32, cfg_check, prompts,
                              capacity, paged_kw)
    print(json.dumps({"serve_spec": spec_summary}))
    del model32
    torch.cuda.empty_cache()
    elapsed("serving moonshot, speculative decoding")
    loadgen_summary = serve_loadgen(cfg, model, paged_kw)
    print(json.dumps({"serve_loadgen": loadgen_summary}))
    elapsed("serving moonshot, load generator")
    # [ep]: the same model and requests on EP_RANKS ranks of this card
    ep_summary = serve_ep(cfg, model, prompts, capacity, paged_kw)
    print(json.dumps({"serve_ep": ep_summary}))
    elapsed("serving moonshot, expert parallelism")
    # [executors]: the three executors on the paper's layers, the launcher,
    # the same traffic, and one training step
    exec_summary = executors_phase(cfg, model, prompts, capacity, paged_kw,
                                   layers)
    print(json.dumps({"executors": exec_summary}))
    elapsed("executors")

    # 6. serving, contiguous + fixed -------------------------------------
    rc_c = RunConfig(compute_dtype=torch.bfloat16, schedule_policy="fixed")
    reqs_c = [Request(rid=i, prompt=rng.integers(
                  0, V, int(rng.integers(16, 65))).astype(np.int32),
                      max_new=SERVE_MAX_NEW) for i in range(CONTIG_REQUESTS)]
    capacity_c = max(48, *(len(r.prompt) for r in reqs_c)) \
        + SERVE_MAX_NEW + 1
    engine = ServeEngine(cfg, model, slots=SERVE_SLOTS, capacity=capacity_c,
                         rc=rc_c, kv_block_size=0)
    contig = serve_and_check("serve contiguous", engine, reqs_c, rng)
    contig_summary = summarize("serve contiguous", contig, reqs_c, layers)
    first = torch.as_tensor(reqs_c[0].prompt.astype(np.int64),
                            device="cuda")[None]
    head = truncated(model, n_check)
    logits, _, _ = forward(head, cfg_check, rc_c, {"tokens": first},
                           mode="prefill")
    logits_p, _, _ = forward(head, cfg_check, rc_c._replace(executor="plain"),
                             {"tokens": first}, mode="prefill")
    torch.cuda.synchronize()
    torch.testing.assert_close(logits, logits_p, **LOGIT_TOL)
    print(f"[serve contiguous] first prefill logits ({n_check} layers) vs "
          f"plain versions on the card: max_abs_err "
          f"{(logits - logits_p).abs().max().item():.3e} (|logits| max "
          f"{logits_p.abs().max().item():.2f}; tolerance rtol=atol=5e-2); "
          f"argmax equal: "
          f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
    del head
    extra = [Request(rid=100 + i, prompt=rng.integers(
        0, V, 48).astype(np.int32), max_new=16) for i in range(SERVE_SLOTS)]
    contig_prof = {"prefill": profile_window(
                       lambda: [engine.admit(r) for r in extra]),
                   "decode": profile_window(
                       lambda: [engine.step() for _ in range(5)])}
    print_profile("serve contiguous", "2 prefills of 48 tokens", contig_prof)
    del engine
    torch.cuda.empty_cache()
    elapsed("serving moonshot, contiguous")

    # 7. serving, paged, quantized experts -------------------------------
    # the served model under int8_expert (quantized in place by the engine)
    # and a copy of its first CHECK_LAYERS layers under int4_packed, taken
    # first, while the model is still bf16
    from repro_torch.quantization import routed_expert_bytes
    int4_model = copy.deepcopy(truncated(model, n_check))
    quant = {}
    for scheme, qmodel, qcfg in (("int8_expert", model, cfg),
                                 ("int4_packed", int4_model, cfg_check)):
        fmt = get_scheme(scheme).kernel_format
        dense_bytes = routed_expert_bytes(qmodel)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = ServeEngine(qcfg, qmodel, slots=SERVE_SLOTS,
                             capacity=capacity,
                             rc=rc._replace(quant=scheme), **paged_kw)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        peak_load = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reqs_q = [Request(rid=i, prompt=p, max_new=SERVE_MAX_NEW)
                  for i, p in enumerate(prompts)]
        res = serve_and_check(f"serve {scheme}", engine, reqs_q, rng, fmt)
        peak_serve = torch.cuda.max_memory_allocated()
        print(f"[serve {scheme}] {qcfg.n_layers} layers, routed experts "
              f"{engine.quant_expert_bytes / 1e9:.3f} GB stored ("
              f"{dense_bytes / 1e9:.3f} GB bf16), quantized in "
              f"{quantize_s:.2f} s; peak device memory "
              f"{peak_load / 1e9:.2f} GB while quantizing, "
              f"{peak_serve / 1e9:.2f} GB while serving")
        summary = summarize(f"serve paged {scheme}", res, reqs_q,
                            qcfg.n_layers)
        summary.update({"expert_bytes": engine.quant_expert_bytes,
                        "dense_expert_bytes": dense_bytes,
                        "quantize_s": quantize_s,
                        "peak_bytes_quantizing": peak_load,
                        "peak_bytes_serving": peak_serve,
                        "launches": res["launches"]})
        # five decode steps under the profiler, as the bf16 engine's
        for i in range(SERVE_SLOTS):
            engine.admit(Request(rid=100 + i, prompt=rng.integers(
                0, V, 48).astype(np.int32), max_new=16))
        for _ in range(2):
            engine.step()                  # the two prompt-chunk steps
        prof = profile_window(lambda: [engine.step() for _ in range(5)])
        print(f"[profile serve paged {scheme}] decode x5, 2 slots: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f}"
              f" ms (share {prof['busy_share']:.3f}; bf16 experts "
              f"{paged_prof['decode']['busy_share']:.3f})")
        for name, calls, ms in prof["top_device"]:
            print(f"    device {ms:9.3f} ms {calls:5d}x  {name[:70]}")
        summary["decode_profile"] = prof
        del engine
        torch.cuda.empty_cache()
        head32 = copy.deepcopy(truncated(qmodel, n_check)).float()
        logits, logits_p, n_rows = first_step_logits(
            head32, cfg_check, rc32, prompts, capacity, paged_kw)
        torch.testing.assert_close(logits, logits_p, **LOGIT_TOL_FP32)
        err = (logits - logits_p).abs().max().item()
        print(f"[serve {scheme}] first paged step ({n_rows} prompt rows, "
              f"{n_check} layers, fp32) fused read + {fmt} kernels vs "
              f"gather read + plain versions: max_abs_err {err:.3e} "
              f"(|logits| max {logits_p.abs().max().item():.2f}; tolerance "
              f"rtol=atol={LOGIT_TOL_FP32['atol']:g}); argmax equal: "
              f"{bool((logits.argmax(-1) == logits_p.argmax(-1)).all())}")
        summary["first_step_fp32_max_abs_err"] = err
        quant[scheme] = summary
        del head32
        torch.cuda.empty_cache()
    print(json.dumps({"serve": {"paged": paged_summary,
                                "contiguous": contig_summary, **quant}}))
    print(json.dumps({"profile": {"paged": paged_prof,
                                  "contiguous": contig_prof}}))
    del model, int4_model
    torch.cuda.empty_cache()

    elapsed("serving moonshot")

    # 8. serving deepseek-v2-236b (MLA), once moonshot's models are freed --
    deepseek = serve_deepseek(rng)
    deepseek_long = deepseek.pop("prefill_long")
    print(json.dumps({"serve_deepseek": deepseek}))
    elapsed("serving deepseek-v2")

    # 9. training: the MoE layer's backward without a host sync, one fp32
    # step's gradients against the plain versions, then the full-width
    # trainer ----------------------------------------------------------------
    train_sync = {p: moe_layer_backward_no_sync(p)
                  for p in ("fixed", "dynamic", "capacity_factor")}
    train_check = {c: train_grads_vs_plain(c)
                   for c in ("float32", "bfloat16")}
    train = train_full_width(TRAIN_LAYERS)
    print(json.dumps({"train": {"moe_ffn_no_sync_launches": train_sync,
                                "check_vs_plain": train_check, **train}}))
    elapsed("training, fixed")
    # [train capacity remat]: the same model and batch on capacity_factor
    # with each layer recomputed in the backward
    train_cap = train_full_width(TRAIN_LAYERS, "capacity_factor", remat=True,
                                 fit=False, tag="train capacity remat")
    drop = [r["sched/drop_fraction"] / n_moe_layers(get_config(
        "moonshot-v1-16b-a3b").replace(n_layers=TRAIN_LAYERS))
        for r in train_cap["steps"]]
    print(f"[train capacity remat] beside fixed without remat (this run): "
          f"median step {train_cap['step_ms_median_after_first']:.1f} ms "
          f"against {train['step_ms_median_after_first']:.1f}, "
          f"{train_cap['tokens_per_s']:.0f} tokens/s against "
          f"{train['tokens_per_s']:.0f}, peak device memory "
          f"{train_cap['peak_bytes'] / 1e9:.2f} GB against "
          f"{train['peak_bytes'] / 1e9:.2f}, device busy share "
          f"{train_cap['profile']['busy_share']:.3f} against "
          f"{train['profile']['busy_share']:.3f}; sched/drop_fraction per "
          f"step " + ", ".join(f"{d:.4f}" for d in drop))
    print(json.dumps({"train_capacity_remat": train_cap}))
    elapsed("training, capacity_factor and remat")
    resume, clean = train_resume()
    print(json.dumps({"train_resume": resume}))
    elapsed("training resume")
    # [serve ckpt]: the checkpoint [train resume] wrote, served by the
    # launcher, then removed
    try:
        serve_ckpt_summary = serve_ckpt(clean, smi)
    finally:
        del clean
        shutil.rmtree(RESUME_CKPT, ignore_errors=True)
        torch.cuda.empty_cache()
    print(json.dumps({"serve_ckpt": serve_ckpt_summary}))
    elapsed("serving the training checkpoint")
    # [train sharded]: moonshot cut to SHARDED_LAYERS layers on 2 ranks of
    # this card, grids 2x1 and 1x2
    sharded = train_sharded()
    print(json.dumps({"train_sharded": sharded}))
    elapsed("training sharded")
    # [train mla]: deepseek-v2 at full width, 2 layers, forward + backward
    train_mla_summary = train_mla(errs)
    print(json.dumps({"train_mla": train_mla_summary}))
    elapsed("training deepseek-v2 (MLA)")

    # 10. the dense family: gemma2-9b served at full width and depth, its
    # 8,192-token prefill; the chunked attention against the whole-score
    # one; qwen2, starcoder2 and smollm served; qwen2-7b's 32,768-token
    # prefill at LONG_LAYERS
    gemma2, g_cfg, g_model = serve_gemma2(rng)
    elapsed("serving gemma2-9b")
    long_prefill = {g_cfg.name: prefill_long(g_cfg, g_model, rng),
                    "deepseek-v2-236b": deepseek_long}
    del g_model
    torch.cuda.empty_cache()
    elapsed("gemma2-9b long prefill")
    flash_long = check_flash_long()
    elapsed("chunked attention vs whole-score")
    dense = serve_dense(rng)
    elapsed("serving qwen2, starcoder2, smollm")
    q_cfg, q_model, _ = dense_model("qwen2-7b",
                                    layers=LONG_LAYERS["qwen2-7b"])
    long_prefill[q_cfg.name] = prefill_long(q_cfg, q_model, rng)
    del q_model
    torch.cuda.empty_cache()
    elapsed("qwen2-7b long prefill")
    # [train dense]: smollm-360m at full width and depth
    dense_train = train_dense()
    elapsed("training smollm-360m")
    print(json.dumps({"dense": {"serve_gemma2": gemma2,
                                "serve_dense": dense,
                                "flash_long": flash_long,
                                "prefill_long": long_prefill,
                                "train_dense": dense_train}}))

    # 11. the recurrent families at full width and depth: rwkv6-1.6b, then
    # zamba2-7b, each served, held in fp32 against the CPU, and its long
    # prefill
    recurrent = {}
    for name in RECURRENT_ARCHS:
        recurrent[name] = serve_recurrent(name, rng)
        elapsed(f"serving {name} and its long prefill")
    print(json.dumps({"recurrent": recurrent}))

    # 12. the vlm and audio families: llama-3.2-vision-11b served at full
    # width and depth, hubert-xlarge trained at full width and depth, the
    # vlm's first group trained
    vlm_audio = {"serve_vlm": serve_vlm(rng)}
    elapsed("serving llama-3.2-vision-11b")
    vlm_audio["train_hubert"] = train_hubert()
    elapsed("training hubert-xlarge")
    vlm_audio["train_vlm"] = train_vlm()
    elapsed("training llama-3.2-vision-11b's first group")
    print(json.dumps({"vlm_audio": vlm_audio}))

    # 13. the recurrent families trained at full width: rwkv6 at full
    # depth, zamba2 at 15 layers and its full depth's forward + backward
    # (the four late families' grids run inside [train sharded])
    late = {"train_rwkv6": train_rwkv6()}
    elapsed("training rwkv6-1.6b")
    late["train_zamba2"] = train_zamba2()
    elapsed("training zamba2-7b")
    print(json.dumps({"late_training": late}))

    # 14. analysis: the dry run's predictions against the measured bytes,
    # the fit verdicts, the roofline shares, the quickstart example
    analysis_summary = analysis(layers, {
        "train_mla": train_mla_summary, "serve_ckpt": serve_ckpt_summary,
        "zamba2_full": late["train_zamba2"]["full_depth"],
        "served": served, "capacity": capacity, "paged": paged_summary,
        "contiguous": contig_summary, "quant": quant, "deepseek": deepseek,
        "gemma2": gemma2, "dense": dense, "recurrent": recurrent,
        "serve_vlm": vlm_audio["serve_vlm"], "train": train,
        "train_cap": train_cap, "train_dense": dense_train,
        "train_hubert": vlm_audio["train_hubert"],
        "train_vlm": vlm_audio["train_vlm"],
        "train_rwkv6": late["train_rwkv6"],
        "train_zamba2": late["train_zamba2"]})
    print(json.dumps({"analysis": analysis_summary}))
    elapsed("analysis")

    # 10. report -----------------------------------------------------------
    from repro_torch.kernels.grouped_gemm import TILE_SHAPES
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    report = []
    for name, (source, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": paged["launches"][name],
                 "max_abs_err": errs[name]}
        fmt = name.rsplit("_", 1)[1] if name.endswith(("_int8", "_int4")) \
            else None
        if fmt is not None:
            kname, scheme = name[:-len(fmt) - 1], REPORT_SCHEME[fmt]
            run = quant[scheme]
            entry["launches"] = run["launches"][name]
            d = qtimings[scheme, "dynamic", SERVE_SLOTS][kname]
            qkeys = keys + ("dense_ms", "grouped_mm_dequantized_ms")
            extra = {
                "shape": f"moonshot-v1-16b-a3b bf16 decode T={SERVE_SLOTS}, "
                         f"dynamic schedule (8-row blocks), {scheme} experts",
                "launches_run": f"paged serving under {scheme}, "
                                f"{run['layers']} layers",
                "bound_counts": "compressed payload + scales + activations "
                                "in + output written",
                "dense_ms": d["dense_ms"],
                "grouped_mm_dequantized_ms": d["grouped_mm_dequantized_ms"],
                "prefill_T64": {k: qtimings[scheme, "dynamic", 64][kname][k]
                                for k in qkeys},
                "fixed": {f"T{T}": {
                    k: qtimings[scheme, "fixed", T][kname][k]
                    for k in qkeys} for T in (SERVE_SLOTS, 64)},
                "sass": {fn: n for fn, n in sass.items()
                         if HOPPER_KERNELS[name] in fn}}
            if fmt == "int8":
                extra["int8_channel"] = {
                    f"{policy}_T{T}": {
                        k: qtimings["int8_channel", policy, T][kname][k]
                        for k in qkeys} for policy, T in QUANT_SHAPES}
                extra["deepseek_int8_expert"] = {
                    f"dynamic_T{T}": {k: ds_qtimings[T][kname][k]
                                      for k in qkeys}
                    for T in sorted(ds_qtimings)}
        elif name in _build.BACKWARD_KERNELS:
            entry["launches"] = train["launches"][name]
            tkeys = keys + ("bound_bytes_ms", "bound_ops_ms")
            # B7's entry is its bf16-output form, the one training launches
            tname = "grouped_wgrad_bf16" if name == "grouped_wgrad" else name
            d = train_t["moonshot", "fixed", "gate_up"][tname]

            def cells(tn, skip=("fixed", "gate_up")):
                return {**{f"{policy}_{orient}": {
                    k: train_t["moonshot", policy, orient][tn][k]
                    for k in tkeys}
                    for policy in ("fixed", "dynamic")
                    for orient in ("gate_up", "down")
                    if (policy, orient) != skip},
                    "deepseek": {f"{policy}_{orient}": {
                        k: train_t["deepseek", policy, orient][tn][k]
                        for k in tkeys}
                        for policy in ("fixed", "dynamic")
                        for orient in ("gate_up", "down")}}
            extra = {
                "shape": (f"moonshot-v1-16b-a3b bf16 training, T="
                          f"{TRAIN_BATCH * TRAIN_SEQ} (batch {TRAIN_BATCH} x "
                          f"seq {TRAIN_SEQ}), fixed schedule, gate/up "
                          "orientation; "
                          + ("x (capacity, 2048), dy (capacity, 1408) -> "
                             "dW (64, 2048, 1408) bf16"
                             if name == "grouped_wgrad" else
                             "dy (capacity, 1408) x W (64, 2048, 1408) "
                             "read transposed -> (capacity, 2048)")),
                "launches_run": f"moonshot-v1-16b-a3b training, "
                                f"{TRAIN_LAYERS} layers, {TRAIN_STEPS} "
                                "steps (2 of each 3 per MoE layer in the "
                                "gate/up orientation, 1 in the down one)",
                "bound_bytes_ms": d["bound_bytes_ms"],
                "bound_ops_ms": d["bound_ops_ms"],
                "sass": {fn: n for fn, n in sass.items()
                         if HOPPER_KERNELS[name] in fn},
                **cells(tname)}
            extra["capacity_factor"] = {
                orient: {k: train_t["moonshot", "capacity_factor",
                                    orient][tname][k] for k in tkeys}
                for orient in ("gate_up", "down")}
            if name == "grouped_wgrad":
                entry["max_abs_err"] = errs["grouped_wgrad_bf16"]
                extra.update({"out_dtype": "bfloat16",
                              "max_abs_err_fp32_out": errs[name],
                              "fp32_out": cells(name, skip=None)})
        elif name == "paged_attention":
            pkeys = keys + ("n_split", "per_split", "bytes")
            d, extra = paged_t["decode"], {
                "shape": "moonshot-v1-16b-a3b bf16 paged decode B=2 "
                         "(kv_limit 100 and 77, blocks of 16)",
                "n_split": paged_t["decode"]["n_split"],
                "chunk_B64": {k: paged_t["chunk"][k] for k in pkeys},
                f"verify_B{VERIFY_ROWS}": {
                    "shape": f"moonshot bf16 speculative verify, {SPEC_K + 1} "
                             "rows a slot from kv_limit 100 and 77, nb 8",
                    **{k: paged_t["verify"][k] for k in pkeys}},
                "launches_spec": {d: spec_summary[d]["launches"][name]
                                  for d in ("smollm", "self")},
                "launches_run_spec": "[serve spec] (a) bf16 turns, 2 "
                                     "requests x 24 new (target 4 layers; "
                                     "draft smollm-360m 32 layers or the "
                                     "target)",
                "long_context_B2": {
                    "shape": "moonshot bf16, kv_limit 8191 and 6143, nb 512",
                    **{k: paged_t["long"][k] for k in pkeys}},
                "batched_B32": {
                    "shape": "moonshot bf16, 32 rows at kv_limit 2047, "
                             "nb 128",
                    **{k: paged_t["batched"][k] for k in pkeys}},
                "mixtral_gqa_decode_B2": {
                    "shape": "mixtral-8x7b bf16 (Hkv 8, G 4), kv_limit 100 "
                             "and 77, nb 8",
                    **{k: paged_t["gqa_decode"][k] for k in pkeys}},
                "dense": {kind: {
                    "shape": f"{t['arch']} bf16 (Hkv {t['Hkv']}, G "
                             f"{t['G']}, D {t['D']}), B={t['rows']}, nb 8",
                    **{k: t[k] for k in pkeys}}
                    for kind, t in paged_t.items()
                    if t["arch"] in DENSE_ATTN},
                "launches_gemma2": gemma2["paged"]["launches"][name],
                "launches_run_gemma2": "gemma2-9b paged serving, all 42 "
                                       "layers",
                "launches_dense": {n: d["launches"][name]
                                   for n, d in dense.items()}}
        elif name == "paged_attention_mla":
            entry["launches"] = deepseek["paged"]["launches"][name]
            mkeys = keys + ("bound_bytes_ms", "bound_ops_ms", "n_split",
                            "per_split", "bytes")
            d, extra = mla_t["decode"], {
                "shape": "deepseek-v2-236b bf16 paged MLA decode B=2 "
                         "(kv_limit 100 and 77, blocks of 16; q 128 x 512 "
                         "+ 128 x 64, latent 512 + rope key 64)",
                "launches_run": f"deepseek-v2-236b paged serving, "
                                f"{DEEPSEEK_LAYERS} layers",
                "bound_bytes_ms": mla_t["decode"]["bound_bytes_ms"],
                "bound_ops_ms": mla_t["decode"]["bound_ops_ms"],
                "n_split": mla_t["decode"]["n_split"],
                "chunk_B64": {k: mla_t["chunk"][k] for k in mkeys},
                "long_context_B2": {
                    "shape": "deepseek bf16, kv_limit 8191 and 6143, nb 512",
                    **{k: mla_t["long"][k] for k in mkeys}},
                "batched_B32": {
                    "shape": "deepseek bf16, 32 rows at kv_limit 2047, "
                             "nb 128",
                    **{k: mla_t["batched"][k] for k in mkeys}},
                "sass": {fn: n for fn, n in sass.items()
                         if HOPPER_KERNELS[name] in fn}}
        else:
            d = timings["dynamic", SERVE_SLOTS][name]
            extra = {
                "shape": f"moonshot-v1-16b-a3b bf16 decode T={SERVE_SLOTS}, "
                         "dynamic schedule (8-row blocks)",
                "launches_contiguous": contig["launches"][name],
                "prefill_T64": {k: timings["dynamic", 64][name][k]
                                for k in keys},
                f"verify_T{VERIFY_ROWS}": {
                    k: timings["dynamic", VERIFY_ROWS][name][k]
                    for k in keys},
                "launches_spec": {d: spec_summary[d]["launches"][name]
                                  for d in ("smollm", "self")},
                "fixed": {f"T{T}": {k: timings["fixed", T][name][k]
                                    for k in keys}
                          for T in (SERVE_SLOTS, VERIFY_ROWS, 64)},
                "deepseek": {f"{policy}_T{T}": {
                    k: ds_timings[policy, T][name][k] for k in keys}
                    for policy, T in sorted(ds_timings)},
                "launches_deepseek": deepseek["paged"]["launches"][name],
                "training_T4096": {policy: {
                    k: timings[policy, TRAIN_BATCH * TRAIN_SEQ][name][k]
                    for k in keys} for policy in ("fixed", "dynamic")}}
            if name in ("router_topk", "unpermute"):
                extra["launch_floor_ms"] = floor["ms"]
            if name == "router_topk":
                extra.update({f"{arch}_T{T}": {
                    k: route_t[arch, T][k]
                    for k in keys + ("most_candidates_ms",)}
                    for arch, T in sorted(route_t)})
            if name in HOPPER_KERNELS:
                # B1 and B2: bf16 on dense weights runs the Hopper kernel
                # (one work-list build inside each call)
                extra["sass"] = {fn: n for fn, n in sass.items()
                                 if HOPPER_KERNELS[name] in fn}
                extra["capacity_factor"] = {
                    f"{arch}_T{T}": tm[name]
                    for (arch, T), tm in cap_t.items()}
                # every time above is at the default tile; [tune] held
                # every tile bitwise the default's and timed each
                shapes = TILE_SHAPES[name, "dense"]
                extra["tile"] = {
                    "timed_at": list(shapes[0]),
                    "held": [list(t) for t in shapes],
                    "swept": {k: v["winner"] for k, v in tune["keys"].items()
                              if k.startswith(name + "|")}}
        entry.update({k: d[k] for k in keys})
        entry.update({"library": d["library"],
                      "library_null_reason": d["library_null_reason"]})
        entry.update(extra)
        if name in MOE_KERNELS or name in _build.BACKWARD_KERNELS:
            # [train mla]'s launches over one forward + backward
            entry["launches_train_mla"] = train_mla_summary["launches"][name]
            entry["launches_train_mla_run"] = (
                f"[train mla] deepseek-v2-236b, {MLA_TRAIN_LAYERS} layers "
                f"(1 MoE), one bf16 forward + backward, batch "
                f"{MLA_TRAIN_BATCH} x seq {MLA_TRAIN_SEQ}")
        if name in _build.BACKWARD_KERNELS:
            tname = "grouped_wgrad_bf16" if name == "grouped_wgrad" else name
            entry["deepseek_train_mla"] = {
                "shape": f"deepseek-v2-236b bf16 training, T="
                         f"{MLA_TRAIN_BATCH * MLA_TRAIN_SEQ}, fixed",
                **{orient: {k: t[tname][k] for k in keys + (
                    "bound_bytes_ms", "bound_ops_ms")}
                   for orient, t in
                   train_mla_summary["backward_kernels"].items()}}
        if name in MOE_KERNELS or name in _build.BACKWARD_KERNELS:
            # each [train sharded] rank's launches over one timed step
            entry["launches_train_sharded"] = {
                f"{g} rank {i}": t["launches_per_step"][name]
                for g, d in sharded["grids"].items()
                for i, t in enumerate(d["timed"])}
            entry["launches_train_sharded_run"] = (
                f"[train sharded] one bf16 step with remat, {SHARDED_LAYERS} "
                f"layers, on each rank of the grids "
                + ", ".join(sharded["grids"]))
        if name in MOE_KERNELS or name in ("paged_attention",
                                           "grouped_gemm_int8",
                                           "fused_gate_up_int8"):
            # [serve ckpt]: the launcher's three runs over the checkpoint
            entry["launches_serve_ckpt"] = serve_ckpt_summary[
                "launches"][name]
            entry["launches_serve_ckpt_run"] = (
                f"[serve ckpt] the serve launcher over [train resume]'s "
                f"checkpoint, {RESUME_LAYERS} layers, fp32, bf16 and bf16 "
                f"int8_expert, {SERVE_REQUESTS} requests x {SERVE_MAX_NEW}")
        if name in MOE_KERNELS or name == "paged_attention":
            # each [ep] rank's launches over its bf16 timed run
            entry["launches_ep"] = {
                f"{arm} rank {i}": la[name]
                for arm, las in ep_summary["launches"].items()
                for i, la in enumerate(las)}
            entry["launches_ep_run"] = (
                f"[ep] bf16 paged serving on {ep_summary['ranks']} ranks, "
                f"{ep_summary['layers']} layers, forwards "
                f"{json.dumps(ep_summary['forwards'])}")
        report.append(entry)
    print(json.dumps({"kernels": report}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
