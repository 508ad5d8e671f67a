#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. ``build``     — compile every CUDA kernel of the port with nvcc, one
   process per source, all started together (six sources; K1, K2 and K5
   share one); the CUDA toolkit's version (K3's table is one kernel
   parameter of up to 32,764 bytes: CUDA 12.1 or later).
2. ``kernels``   — hold each kernel against its plain PyTorch version on
   the card at the shapes of the serve phases (K4; K6 for each KV grid,
   with bf16 and f32 q), each (slot, head) row to its own scale, with a
   control that the tolerance fails a kernel reading one row past pos;
   and time kernel, plain version and one PyTorch library call computing
   the same function. K4 and K6 (split-KV: a split pass and an ordered
   combine pass per call, sharing ``csrc/paged_decode_split.cuh``, each
   under kernel names of its own) also record their splits per slot,
   equal their reruns bit for bit, make no host sync
   (``torch.cuda.set_sync_debug_mode``), have each of their two kernels
   timed under the profiler, and are held again at a small shape the
   serve shapes do not reach (``K4_EDGE``: rep 6, several splits a slot,
   splits past pos; K6 on a 1-byte grid and the fp16 grid), with the
   control that the plain version one row past pos fails the limit there
   too. K4 and K6, their plain
   versions and SDPA are timed twice: by events over calls made back to
   back (``ms``), and replayed from CUDA graphs (``device_graph_ms``: no
   host in the loop; a K4 call is shorter than its wrapper's host time).
3. ``parity``    — llama3-8b at full width, 2 layers, float32: the serve
   engine with the kernel and with the gather path gives identical tokens
   and per-tick logits within 1e-4 x max|logit| over an unquantized pool
   (K4), and within 1e-3 over int8 and fp8_e4m3 pools (K6), where a
   value near a rounding boundary may take the neighbouring code on one
   path (``PARITY_TOL``; the codes that differ are counted, and the
   quantized pool's logits against the fp32 pool's are read as the
   control).
4. ``serve``     — llama3-8b at its full published config in bfloat16
   serves 16 requests; K4 must run once per layer per tick.
5. ``profile``   — a short second load on the same engine under
   ``torch.profiler``: device time by kernel group (K4's two kernels,
   K6's two, matrix products, the rest) against wall time.
6. ``serve_kvq`` — the same model serves 8 requests (one wave of the 8
   slots; a second wave's ~35 s is left to later phases) over an
   fp8_e4m3 KV pool (kernel path, replayed prompts); K6 must run once per
   layer per tick, K4 never. ``profile_kvq`` profiles a second load on it.
7. ``pim_lenet``   — the paper's LeNet-5 through the mapper: the compiled
   program (K1 and K3) and the per-block executor (K2 and K3) at batch 256
   and 4096 over digit images, with seeded random parameters and non-zero
   biases, bit-equal to each other and within 1e-4 of the plain
   ``lenet_apply`` (TF32 off); launches per call, ms per call, images/s,
   peak memory, and a profile of the program's device time by kernel
   group against wall time. The shapes of the batch-256 launches are
   logged for the next phase.
8. ``kernels_pim`` — K1, K2 and K3 at the shapes ``pim_lenet`` launched
   them at batch 256 (K1 at each placed node's grouped shape, K2 at each
   placed block's, K3 at each add's wave form — its members' shapes,
   layouts, operand strides and immediates — and the adds as one wave),
   on seeded random data, each held against its plain version (TF32 off;
   K1 and K2 per output row to its own max|out|, with a control that
   dropping the last K tile fails that limit), K1 equal to K2 and to
   itself on a second run bit for bit, each K1/K2 launch's K split
   recorded (one chunk at every K <= 256), and timed beside its bound and
   a library call. K3 (``hold_k3``): one launch a wave, bit for bit, each
   output in its member's layout, a negated immediate caught, no host
   sync (``set_sync_debug_mode``), timed by events, by CUDA graph and on
   the host, beside its bound (each operand read once where it lies) and
   ``add`` / ``sub`` / ``mul`` (and ``addcmul``); a wave of every member
   form (dense, broadcast, 0-d on the card and on the CPU, immediates,
   strided, six dims, off 16 bytes, NaN, inf) bit for bit against the
   plain version and the pre-change formulation, with the ``0 + (-0) =
   +0`` control; K3's SASS by source line (the flat path holds its
   16-byte loads and no division); and waves of 179 and 600 members,
   above what a table passed by value holds (``k3_above_cap``: the table
   through device memory, one launch, bit for bit, no host sync).
9. ``pim_train`` — the paper's LeNet-5 trained through the mapper:
   ``Trainer(backend="pim")`` (the whole AdamW step compiled once) and
   ``backend="jit"`` (the plain eager step) from the same seeded
   parameters, TF32 off, batch 64: the first 10 losses agree within
   rtol 1e-4, atol 1e-5, the loss at step 300 is below step 0's, one
   compiled step equals the per-block executor bit for bit; launches per
   step, ms per step, images/s, peak memory, ``train.step_wall_s``. Then
   20 steps at batch 4096 with a profile of the compiled step. The
   batch-64 step's launches are logged, and ``kernels_pim`` (``"path":
   "pim_train"``) holds and times K1, K2 and K3 at their shapes as in 8
   (K3 at each of the step's real waves).
10. ``pim_grad`` — gradients of ``lenet_loss`` at batch 256 through the
   mapper against ``torch.func.grad`` of the plain loss (rtol = atol =
   1e-4): autograd through a compiled ``lenet_loss`` program (its
   backward's K1 and K3 launches are exactly the cotangents autograd
   asked for, no native product is differentiated), and the compiled
   program of ``grad(lenet_loss)`` (its backward products are K1
   launches, as in the train step); the typical |grad| per leaf, and
   controls: each backward K1 and K3 launch dropped must fail the check,
   and the readings of each scaled by 1.01. Then autograd through the
   per-block executor of the same schedule (7 K2 and 5 K3 forward; its
   backward's K2 launches, K2's VJP, and K3 launches are the cotangents
   asked): its gradients within 1e-4 of the compiled program's and of
   plain autograd.
11. ``kernels_pim`` (``"path": "pim_grad_backward"``) — the VJP of each K1
   node (dA with and without a shared A, dB) of ``pim_grad``'s autograd
   graph at its shapes: the cotangents equal the launches they make,
   which are those of the main path's backward, held against the plain
   formula as in 8, and timed; K3 at each wave the backward launched, as
   in 8; K2's VJP the same way at the K2 nodes of ``pim_grad``'s
   executor backward, whose launches it equals.
   Every K1/K2 launch records its K split (S chunks of whole 128-deep
   tiles), equals the other kernel on the same blocks and itself on a
   second run bit for bit; dB reads Aᵀ in place and equals the launch on
   the materialized transpose, both timed beside the transpose copy;
   ``split_db`` lists each split dB launch (conv1's and conv2's) with
   its time, ``bmm``/``mm`` and bound.
12. ``pim_lenet_q`` — phase 7 with the weights on each quantized grid
   (int8, fp8_e4m3, fp8_e5m2, fp16 at batch 256, int8 at 4096): 5 K5 and
   5 K3 launches per call, no K1; the compiled program bit-equal to the
   per-block executor, and within 1e-4 of the plain ``lenet_apply`` over
   the weights each grid stores (``fake_quant`` per output column, TF32
   off); ms per call, images/s, and the K5 launch shapes.
13. ``kernels_pim`` (``"path": "pim_lenet_q"`` and ``"pim_train_q"``) — K5
   at those launches' shapes over int8-grid weights, against its plain
   version (as K1 in 8) and against K1 on ``q * s`` bit for bit; timed
   with its bound and the library call (``q * s`` then ``bmm``).
14. ``pim_train_q`` — ``Trainer(backend="pim", weight_dtype="int8")``,
   AdamW, batch 64, 31 steps: 11 K5 per step and no K1 or K2; the first
   5 losses within 2% of ``pim_train``'s fp32 run from the same
   parameters and batches, whose ms per step it is set beside; the last
   below the first; one compiled step bit-equal to the executor and
   within 1e-4 of the plain step over fake-quantized stationary operands
   (``run_fake_quant_plain``).
15. ``pim_grad_q`` — phase 10's autograd check through a compiled int8
   ``lenet_loss``, the path of K5's VJP and the straight-through
   quantizer: the backward's K1 and K3 launches are the cotangents asked,
   the gradients within 1e-4 of plain autograd at the dequantized
   weights, and every backward launch dropped fails that check.
16. ``kernels_attn`` — K7 through ``ops.attention``, its only entry, at the
   reference's test shapes ((B, S, H, G, D) (1,128,4,2,64), (2,128,8,8,32),
   (1,64,6,3,16), chunks of 64) and llama3-8b's heads (H 32, G 8, D 128,
   B 1, S 2048 and 8192), a ragged length ((1,200,8,2,64), chunks of
   256 clamped to S) and head dims the kernel pads to 128 ((1,256,8,2,112),
   (1,256,8,2,80)) or 256 ((1,256,8,2,160)), and 256 itself
   ((1,256,8,2,256)), float32 and bfloat16: each call one launch of the
   body of its dtype (the profiler names it: bf16 on the tensor-core
   body, whose SASS must hold HMMA instructions), held
   against ``flash_attention_ref`` (TF32 off) per (batch, query, head)
   row at rtol = atol = 2e-5 (f32) or 2e-2 (bf16), atol x the row's
   max|out|, with a control that
   dropping the last query tile's diagonal KV tile fails that limit in
   that tile; at llama3-8b's heads timed
   against the plain version and ``scaled_dot_product_attention``
   (causal, GQA), beside the causal-flops bound.
17. ``pim_fp`` — K8 over 2^20 random float32 bit patterns of every
   exponent, the reference's edge table, and normal pairs whose product
   is subnormal or within three ulps of 2^-126: one launch, equal bit for
   bit (NaN as NaN) to its plain version and to the port's bit-plane
   ``core.fp.fp32_mul_pim`` on the card, and to ``torch.mul`` of the DAZ'd
   inputs wherever the exact product is normal (below 2^-126 IEEE may
   round up to 2^-126 where the procedure flushes); ``fp32_add_pim`` equal
   to IEEE
   addition where the sum is normal or zero, ``pim_dot`` to a sequential
   float32 sum; K8 timed at 2^24 elements against its plain version and
   ``torch.mul`` beside its byte bound and its SASS integer instructions
   per element (over the sites where the kernel inlines the procedure,
   counted by their one FMUL each).
18. ``pim_llama`` — llama3-8b's decode step through the mapper,
   ``compile_arch("llama3-8b", "serve")``, at its published width in
   float32 cut to 2 layers, batch 8, a 512-token contiguous cache, on
   the fp32 grid (K1 on the LM head) and the int8 grid (K5), K3 on the
   final norm's MACs, the layer stack native: launches per step equal
   to the CPU's (1 and 3), the compiled step within rtol = atol = 1e-4
   of the per-block executor and the plain step (``prog.verify``; int8:
   the plain step over the stored head, ``run_fake_quant_plain``), 16
   greedy steps with identical tokens, no host sync in a step, and the
   control that the head's last block column zeroed fails that hold.
   Then the published config as it is (bf16, 32 layers), batch 8, a
   2048-token cache: ms per compiled and plain step, wall and under the
   profiler, K1's LM-head launch against its bound and ``mm``, peak
   memory. ``kernels_pim`` (``"path": "pim_llama"`` / ``"pim_llama_q"``)
   holds K1, K2, K3 and K5 at that step's launches as in 8 and 13.
19. ``pim_llama_train`` — llama3-8b's train step through the mapper,
   ``compile_arch("llama3-8b", "train")``, at its published width in
   float32 cut to 2 layers (1.487 B parameters), batch 1, seq 128, one
   ``TokenStream`` batch, seeded parameters and AdamW state: every
   product lies in a folded loop and runs natively, so K3 alone launches
   (84 waves a compiled step, 148 launches a per-block step, the CPU's
   counts; members up to the 525 M elements of the embedding and the LM
   head); one run on the card at a time, its outputs moved to host
   memory: the compiled step bit-equal to the executor's and within
   rtol = atol = 1e-4 of the plain step (loss, params, m and v), no host
   sync in a step, the control (the last wave one ulp off) breaking the
   bit equality, every wave of a step held against K3's plain version
   member by member, peak memory. Then 3 steps of ``Trainer(backend=
   "pim")`` against ``"jit"`` (losses within 1e-4, each run's final
   checkpoint timed and removed). Then the published dtype (bf16) cut to
   2 layers, batch 1, seq 2048: ms per compiled and plain step (wall and
   under the profiler: kernels a step, busy share), peak memory, and
   each of the step's K3 waves timed on its own operands by events and by
   CUDA graph against its plain version, its library calls and its byte
   bound; the K3 entry of the kernels line carries their sum.
20. ``pim_llama_pipe`` — llama3-8b's decode step cut into pipeline
   stages, ``compile_arch("llama3-8b", "serve", partitions=4,
   expand_scans=True)``. Hold: published width, float32, 2 layers,
   batch 8, a 512-token cache, fp32 and int8 grids; the expansion
   unrolls the stack, so the layers' products run on K1 (K5) and their
   MACs on K3 inside the stages: the partitioned step bit for bit the
   unpartitioned program of the same schedule and the per-block
   executor, within 1e-4 of the plain step, its stages' launches summing
   to the unpartitioned program's; ``run_partitioned`` over 8
   microbatches (each its own tokens and random cache) and
   ``run_partitioned_async`` on 4 streams bit for bit their sequential
   calls; no host sync; the control, one boundary value swapped between
   two microbatches, failing. Time: the published config (bf16) cut to
   16 of its 32 layers, batch 8, a 2048-token cache, 8 microbatches: 8
   sequential compiled steps, ``run_partitioned`` and
   ``run_partitioned_async`` (wall and under the profiler), peak memory.
21. ``pim_pipe`` — LeNet-5, not cut: ``compile_lenet("serve",
   batch=256, partitions=2 and 3)`` bit for bit the unpartitioned
   program and the executor, the GPipe grid over 8 microbatches
   (synchronous and on streams) bit for bit their sequential calls, with
   the boundary-swap control; ``Trainer(backend="pim", microbatches=8,
   partitions=2)`` at batch 64, 20 AdamW steps, losses within rtol 1e-4,
   atol 1e-5 of the plain and the unpartitioned pim trainers, K1/K3
   launches per stage forward and backward, ms per step against
   ``pim_train``'s, and the control that one stage's output cotangent
   swapped between two microbatches fails the gradients' hold.
22. ``serve_pim`` — ``ServeEngine(backend="pim")``: the paged tick
   (``models.transformer.decode_step_paged``) mapped, its KV pool placed
   and priced, and compiled. Hold: published width, float32, 2 layers,
   batch 8, ``max_len`` 512, blocks of 8, ``attn_kernel=True``, 12
   seeded requests (prompts 16–200 tokens, 16 output tokens, slots
   recycling): each pim run's tokens identical to the jit engine's with
   batched and replayed prefill, a tight pool that preempts, an int8 pool
   at blocks of 16 (K6) and an int8 weight grid (K5; the jit engine over
   the LM head the grid stores); launches a tick K4 2 (or K6 2), K1 1 (or
   K5 1), K3 3; one mid-run tick's logits within rtol = atol = 1e-4 x
   max|logit| of ``decode_step_paged``'s gather path on a copy of the
   pool, the control (two slots' table rows swapped) failing; no host
   sync in a program call; 4 partitions of the expanded stack on one
   stream and on a ring of 4 token-identical to the unpartitioned pim
   engine. Time: the serve phase's bf16 model (32 layers), batch 8,
   ``max_len`` 1024, blocks of 8, 8 of its requests: the pim and the jit
   engine — tok/s, TTFT, ms a tick, device ms and kernels a tick under
   the profiler, peak memory, the pim tick's drift ratio (recorded).
23. ``pim_llama_long`` — llama3-8b's train step above seq 2048 and with
   ``grad_accum``, and its prefill. Holds, each on seeded parameters,
   AdamW state and one ``TokenStream`` batch, as ``pim_llama_train``'s
   (``train_hold``: K3 alone at the CPU's counts, compiled == executor
   bit for bit, within rtol = atol = 1e-4 of the plain step, no host
   sync, the last wave one ulp off must break the bit equality, peak
   memory; the waves themselves held in ``pim_llama_train``): the
   chunked attention at published width, float32, 2 layers, remat,
   batch 1, seq 4096 (the pair scan: 36 causal pairs of 512-token chunks
   a layer; K3 84 / 148); ``grad_accum=2`` at published width, float32,
   cut to 1 layer, batch 2, seq 128 (K3 74 / 134), its plain step's
   gradients and loss also within 1e-4 of the one-microbatch step's;
   ``make_prefill_step`` at float32, 2 layers, seq 4096, its last
   position's logits within rtol 1e-4 and atol 1e-4 x max|logit| of a
   plain forward over the full causal attention, the control (the last
   diagonal pair dropped from ``attention._pair_indices``) failing it.
   Time: the bf16 step at 2 layers, seq 2560 (ms per compiled and plain
   step, wall and under the profiler, the pair scan's and the LM head's
   shares of the plain step's device time, peak memory) and the
   published config's prefill (bf16, 32 layers) at seq 4096 (ms a call,
   tokens/s, peak memory; 32768 left out, minutes of eager launches).
24. ``dense_variants`` — the dense attention variants, after the serve
   phases' model is freed: qwen2.5-32b (q/k/v biases), qwen3-32b
   (per-head q/k norm; H·hd 8192 ≠ d_model 5120) and chatglm3-6b (half
   RoPE, 32 q heads over 2 kv heads), their biases and norm scales
   seeded away from their init. Holds at the published width in float32:
   (a) each config cut to 2 layers, 8 requests: the kernel and the
   gather path token-identical, logits within 1e-4 x max|logit| over an
   fp32 pool (K4) and 1e-3 over an int8 pool (K6), the int8 pool's logits
   against the fp32 pool's as the control, launches = layers x ticks (one
   ``parity`` line each); K4 (f32, bf16 q) and K6 (int8, f32 q) at rep
   5, 8 and 16 at the serve shapes, held and timed as in ``kernels``;
   (b) qwen3-32b's decode step through ``compile_arch(...,
   expand_scans=True)`` at ``pim_llama``'s hold on the fp32 and int8
   grids, as ``pim_llama`` holds llama3-8b's, bit for bit the executor,
   its launches the CPU's plan; (c) chatglm3-6b through
   ``ServeEngine(backend="pim")`` at ``serve_pim``'s hold,
   token-identical to the jit engine, K4 at rep 16 in the program; (d)
   qwen3-32b's train step at 1 layer, batch 2 (``grad_accum`` 2), seq
   128, as ``pim_llama_train`` holds llama3-8b's. Time (bf16):
   chatglm3-6b at 28 layers and qwen2.5-32b at the most layers that fit
   ~76 GB (64, reckoned 73.9 GB) serve the serve phase's load — tok/s,
   TTFT, ms a tick, K4 a tick, busy share, peak memory. Then
   ``kernels_pim`` at (b)'s launches (``"path": "dense_variants"``:
   K1 on the layers' products and the 151,936-column head, K2, K3;
   ``dense_variants_q``: K5).
25. ``io_variants`` — the model's inputs and outputs (item 5.2), after
   ``dense_variants``: musicgen-medium (frame embeddings in; full MHA, K4
   at rep 1, head dim 64) and qwen2-vl-2b (embeddings in, M-RoPE over a
   (t, h, w) grid, the LM head tied to the embedding table). Holds at the
   published width in float32, 2 layers: (a) kernel-vs-gather parity of
   both over fp32 and int8 pools; (b) K4 (f32, bf16 q) and K6 (int8, f32
   q) at rep 1 and rep 6 with the one-row-past-pos control; (c)
   qwen2-vl-2b's decode step expanded through the mapper on both grids
   (the tied head on K1 / K5), bit for bit the executor, its launches
   the CPU's plan; (d) musicgen-medium through
   ``ServeEngine(backend="pim")``, token-identical to jit; (e) both
   train steps (batch 2, seq 128) on seeded embeddings, qwen2-vl-2b's
   under a seeded grid whose rows differ, bit for bit the executor and
   within 1e-4 of the plain step, musicgen-medium's unused table moved
   exactly as AdamW moves a zero-gradient leaf. Time (bf16, not cut):
   musicgen-medium at 48 layers and qwen2-vl-2b at 28 serve the serve
   phase's load. Then ``kernels_pim`` at (c)'s launches (``"path":
   "io_variants"``: K1 on the layers' products and the tied head, K2,
   K3; ``io_variants_q``: K5).
26. ``moe_variants`` — mixture of experts for serving (item 5.3), after
   ``io_variants``: granite-moe-1b-a400m (an MoE block every layer, 32
   experts top-8, 16 q heads over 8 kv heads at head dim 64: K4 at rep
   2) and llama4-maverick-400b-a17b (units of a dense block then an MoE
   block, 128 experts top-1 and a shared expert). Holds, granite at the
   published width in float32, 2 layers: (a) kernel-vs-gather parity
   over fp32 and int8 pools; (b) K4 (f32, bf16 q) and K6 (int8, f32 q)
   at rep 2 with the one-row-past-pos control, and at ``K4_EDGE``'s
   splits with granite's heads (``MOE_EDGE``); (c) the decode step
   expanded through the mapper on both grids (the router, attention and
   head products on K1 / K5, the float waves on K3, the experts' batched
   products native as the reference's lowering runs them), bit for bit
   the executor, its launches the CPU's plan; (d)
   ``ServeEngine(backend="pim")``, token-identical to jit. Time (bf16):
   granite not cut (24 layers) serves the serve phase's load; maverick
   at one unit (2 of 48 layers, ~37 GB) serves it through the jit
   engine's kernel path, with its experts' ``bmm`` share of device time,
   after its hold: the first tick's kernel path against its gather path
   (``MOE_BF16_TOL``), a control shifting one token's top-1 expert by one
   failing it. Then ``kernels_pim`` at (c)'s launches (``"path":
   "moe_variants"``; ``moe_variants_q``: K5).
27. ``moe_train`` — the MoE train step (item 5.3b), after
   ``moe_variants``: (a) granite-moe-1b-a400m at its published width in
   float32, 2 layers, remat as published, and (b) llama4-maverick-400b-a17b
   at its published width in float32, one unit (2 layers), its experts cut
   to 8 and its vocabulary to 32,768 (``MOE_TRAIN_CUTS``), each at batch 2,
   seq 128 through ``compile_arch(kind="train")``: K3 alone at the CPU's
   counts, the compiled step bit for bit the per-block executor's and a
   second run's (the gathers' transposes sum in a fixed order), within
   1e-4 of the plain step (loss; params, m, v), no host sync, the one-ulp
   last-wave control failing, and the router's choices of the compiled
   and plain steps the same, with the smallest top-k margin. Time
   (bf16): granite as published (24 layers) takes plain train steps at
   batch 4, seq 2048: ms a step, tokens/s, device ms and busy share, the
   experts' ``bmm`` share of device time, peak memory. Then
   ``kernels_pim`` at (a)'s launches (``"path": "moe_train"``: K3).
28. ``recurrent`` — the recurrent families for serving (item 5.4, the
   serve half), after ``moe_train``: xlstm-350m (units of an mLSTM and
   an sLSTM block) and zamba2-7b (groups of 6 Mamba2 layers, each
   followed by the weight-tied attention + MLP block, then 3 tail
   layers). Holds at the published width in float32, TF32 off, cut to
   xlstm 4 layers and zamba2 13 (2 groups and the tail's 1): (a) decode
   == prefill over 16 positions at the reference's 2e-3 / 2e-2, and the
   chunked mLSTM / Mamba2 == its sequential form at seq 512 (2 / 4
   chunks) at 2e-4 / 1e-3; (b) the decode step expanded through the
   mapper on both grids, bit for bit the executor, its launches the
   CPU's plan (``REC_DECODE_PLAN``), within 1e-4 of the plain step, 8
   greedy steps with identical tokens, no host sync, the last K3 wave
   one ulp off failing; (c) ``ServeEngine(paged=False, backend="pim")``
   token-identical to jit over 12 requests in 8 lanes (recycled), one K1
   and 3 K3 a tick. Time (bf16, not cut): both through
   ``ServeEngine(paged=False)``, batch 8 (ms a tick, tok/s, device ms,
   kernels and busy share a tick, peak memory), and one
   ``make_prefill_step`` call at seq 512. Then ``kernels_pim`` at (b)'s
   launches (``"path": "recurrent"``: K1, K2, K3; ``recurrent_q``: K5).
29. ``recurrent_train`` — the recurrent train step (item 5.4b), after
   ``recurrent``: xlstm-350m at its published width in float32, 4 layers,
   batch 1, seq 512 (two mLSTM chunks, 512 sLSTM tokens a unit) and
   zamba2-7b at its published width in float32, 13 layers, batch 2, seq
   256 (two Mamba2 chunks, its published ``grad_accum=2``) through
   ``compile_arch(kind="train")``: K3 alone at the CPU's counts
   (``REC_TRAIN_K3``), the compiled step bit for bit the per-block
   executor's and a second run's, within 1e-4 of the plain step (loss;
   params, m, v), no host sync, the one-ulp last-wave control failing;
   zamba2's shared block (rope ``"none"``) trains here on the card. Time
   (bf16, one cold step under the profiler): xlstm-350m as published at
   batch 8, seq 32; zamba2-7b at batch 2, seq 512, cut to the whole
   groups of 6 that fit 76 GB (``rec_train_groups``). Then
   ``kernels_pim`` at xlstm's launches (``"path": "recurrent_train"``:
   K3).

Then the card's name and power limit, one line with every kernel's
numbers, and as the last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Needs one CUDA device; imports nothing
of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import gc
import importlib
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    # the seconds since the start, on stderr: where the run's time goes
    print(f"[{time.perf_counter() - T0:.1f} s] {obj.get('phase', '')} "
          f"{obj.get('path', obj.get('weight_dtype', ''))}",
          file=sys.stderr, flush=True)


# host sleep inside each end of a profiler window (``device_profile``)
PROFILE_PAD_S = 0.01


@contextlib.contextmanager
def device_profile(cpu: bool = True, pad: float = PROFILE_PAD_S):
    """``torch.profiler.profile`` of the card, and of the host when
    ``cpu``, with ``pad`` seconds of host sleep inside each end of its
    window; the body synchronizes before it ends. Unpadded, a window that
    holds one short kernel sometimes comes back with no device event at
    all (``scripts/profile_window_probe.py`` counts how often)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        time.sleep(pad)
        yield prof
        time.sleep(pad)


def cuda_ms(fn, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events."""
    import torch
    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    """Build every source, one nvcc each, all started together; each
    source's own build time is reported beside the total, so their sum is
    what building them one after another would take."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build

    def timed(name):
        t = time.perf_counter()
        path = build.build(name)
        return path.name, time.perf_counter() - t

    names = build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(timed, names))
    seconds = time.perf_counter() - t0
    # K3's table is one kernel parameter of up to 32,764 bytes: CUDA 12.1
    # or later
    layout = build.load("pim_mac_layout", (ctypes.c_int,), source="pim_mac")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    emit({"phase": "build", "seconds": seconds, "seconds_by_library": libs,
          "nvcc": nvcc.splitlines()[-2:], "cuda_toolkit": layout(4)})


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

K4 = {"name": "paged_decode_attention_grouped", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:174"}
K6 = {"name": "paged_decode_attention_grouped_q", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/paged_decode_attention_q.cu",
      "replaces": "src/repro/kernels/flash_attention.py:278"}
# (KV grid, q dtype) of K6's checks: every grid with bf16 q, as the
# serve_kvq phase runs it, and with f32 q, held to f32 rounding
K6_CASES = tuple((g, t) for t in ("bfloat16", "float32")
                 for g in ("int8", "fp8_e4m3", "fp8_e5m2", "fp16"))
SERVE_KV_DTYPE = "fp8_e4m3"
K6_EDGE_GRIDS = ("fp8_e4m3", "fp16")   # a 1-byte grid and the 2-byte one
# serve-phase shapes: batch 8, llama3-8b heads, 16-token blocks, 1024 max_len
K4_SHAPES = dict(B=8, H=32, G=8, D=128, bs=16, W=64)
K4_POS = (0, 15, 16, 255, 511, 700, 1000, 1023)   # 0, block edges, W*bs-1
K4_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # x max|out| per row
N_COPIES = 8        # rotated pool copies: the working set exceeds the L2
# K4's split schedule where the serve shapes do not reach it: rep 6 (query
# rows padded to 8), 4-key blocks (8 a split, 3 splits a slot, the last
# one 4 entries short of a split), a slot at 0, a position inside a block,
# a slot with a split wholly past it and one at the table's last key
K4_EDGE = dict(B=4, H=12, G=2, D=64, bs=4, W=20)
K4_EDGE_POS = (0, 5, 40, 79)


def k4_table(rng, s=K4_SHAPES, positions=K4_POS):
    """A block table and positions (the serve shapes' by default): every
    slot's valid blocks are distinct random blocks of the pool, its table
    tail is the scratch block 0."""
    b, bs, w = s["B"], s["bs"], s["W"]
    n = 1 + b * w
    pos = np.asarray(positions, np.int32)
    table = np.zeros((b, w), np.int32)
    for i, p in enumerate(pos):
        nv = p // bs + 1
        table[i, :nv] = rng.choice(n - 1, nv, replace=False) + 1
    return n, table, pos


def k4_inputs(dtype, rng, device, s=K4_SHAPES, positions=K4_POS,
              copies=N_COPIES):
    """Inputs at the serve phase's shapes (``k4_table``) or ``s``; block 0
    holds large finite values that must never be read."""
    import torch
    b, h, g, d, bs = s["B"], s["H"], s["G"], s["D"], s["bs"]
    n, table, pos = k4_table(rng, s, positions)
    pools = []
    for _ in range(copies):
        kv = rng.standard_normal((2, n, bs, g, d), np.float32)
        kv[:, 0] = 3.0e4
        pools.append(torch.from_numpy(kv).to(device, dtype))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32)).to(
        device, dtype)
    return (q, pools, torch.from_numpy(table).to(device),
            torch.from_numpy(pos).to(device))


def k4_bound(q, pos, dtype_name, s=K4_SHAPES) -> tuple[float, str]:
    """Least time for this call: the bytes the function must move (q and
    pos read once, the K and V rows at positions 0..pos[b] of each slot
    read once with the table entries they sit in, the output written
    once) over HBM rate, against its flops over the peak rate of its
    type. Whole blocks and the table's tail are the kernel's tiling, not
    the function's, and are not counted."""
    item = q.element_size()
    p = pos.cpu().numpy().astype(np.int64)
    rows = int((p + 1).sum())               # K/V rows the function reads
    entries = int((p // s["bs"] + 1).sum())  # table entries they sit in
    nbytes = (2 * q.numel() * item + 2 * rows * s["G"] * s["D"] * item
              + entries * 4 + pos.numel() * 4)
    flops = 4 * rows * s["H"] * s["D"]       # q.k and p.v per query head
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def over_limit(out, want, tol):
    """The error of ``out`` against ``want`` as a fraction of ``tol`` x
    max|want| of each (slot, head) row: [B, H]. The long slots average
    hundreds of rows, so their outputs are ~40x smaller than the
    position-0 slot's; each row is held at its own scale."""
    want = want.float()
    err = (out.float() - want).abs().amax(-1)
    return err / (tol * want.abs().amax(-1)).clamp_min(1e-30)


def off_by_one_control(label, plain, want, pos, length, tol) -> float:
    """The control of a decode kernel's tolerance: ``plain`` reading one
    row past pos (clamped at the table's end) must exceed ``tol`` x
    max|out| in every slot that this changes; returns the least excess."""
    import torch
    moved = pos < length - 1
    off = over_limit(plain(torch.clamp(pos + 1, max=length - 1)), want,
                     tol).amax(-1)[moved]
    control = float(off.min())
    if not control > 1:
        raise AssertionError(f"{label}: reading one row past pos gives "
                             f"only {control} x the limit in some slot")
    return control


def hold_and_time(label, q, pos, pools, kernel, plain, heads,
                  s=K4_SHAPES) -> dict:
    """Hold ``kernel(pool, pos)`` against ``plain(pool, pos)`` on the
    first pool within ``K4_TOL`` x max|out| of each (slot, head), then
    time kernel and plain version over the rotated pools, and the library
    yardstick: SDPA over K/V that ``heads(pool)`` gathered through the
    table beforehand ([B, H, L, D] each, untimed), its error held to the
    same tolerance. The mask is additive (-inf past pos): in bf16 the
    default backend (cuDNN) lets masked keys through under a boolean mask.

    A control shows the tolerance fails a wrong kernel: the plain version
    reading one row past pos (clamped at the table's end) must exceed it
    in every slot that this changes. The three are timed again from CUDA
    graphs (``graph_ms``): the device time of a call with no host in the
    loop, beside the event time of calls made back to back, which the
    host paces when a call is shorter than its wrapper's host time."""
    import torch
    import torch.nn.functional as F
    qname = str(q.dtype).split(".")[1]
    tol = K4_TOL[qname]
    out, want = kernel(pools[0], pos), plain(pools[0], pos)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    err = float((out.float() - want.float()).abs().max())
    ratio = float(over_limit(out, want, tol).max())
    if not ratio <= 1:
        raise AssertionError(f"{label}: error {ratio} x the limit {tol} x "
                             f"max|out| of a (slot, head)")
    length = s["W"] * s["bs"]
    control = off_by_one_control(label, lambda at: plain(pools[0], at),
                                 want, pos, length, tol)

    def rotated(fn):
        it = iter(range(1 << 30))
        return lambda: fn(pools[next(it) % N_COPIES], pos)

    kernel_ms = cuda_ms(rotated(kernel))
    plain_ms = cuda_ms(rotated(plain))
    keep = (torch.arange(length, device=DEVICE)[None]
            <= pos[:, None]).view(s["B"], 1, 1, length)
    bias = torch.zeros(keep.shape, dtype=q.dtype, device=DEVICE
                       ).masked_fill(~keep, float("-inf"))
    gathered = [heads(p) for p in pools]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, *gathered[0],
                                         attn_mask=bias)[:, :, 0]
    lib_err = float((lib.float() - want.float()).abs().max())
    lib_ratio = float(over_limit(lib, want, tol).max())
    if not lib_ratio <= 1:
        raise AssertionError(f"SDPA yardstick {label}: error {lib_ratio} x "
                             f"the limit {tol} x max|out| of a (slot, head)")
    it = iter(range(1 << 30))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, *gathered[next(it) % N_COPIES], attn_mask=bias))
    graph = {
        "kernel_graph_ms": graph_ms([lambda p=p: kernel(p, pos)
                                     for p in pools]),
        "plain_graph_ms": graph_ms([lambda p=p: plain(p, pos)
                                    for p in pools]),
        "library_graph_ms": graph_ms([
            lambda g=g: F.scaled_dot_product_attention(q4, *g,
                                                       attn_mask=bias)
            for g in gathered])}
    return {**graph, "max_err": err, "tol": tol, "max_err_over_limit": ratio,
            "off_by_one_min_over_limit": control,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "library_max_err_over_limit": lib_ratio}


def to_heads(k, v, table, dtype, s=K4_SHAPES):
    """K/V [N, bs, G, D] gathered through the table and repeated to every
    query head: [B, H, L, D] each, in ``dtype``."""
    length, rep = s["W"] * s["bs"], s["H"] // s["G"]
    return tuple(x[table.long()].reshape(s["B"], length, s["G"], s["D"])
                 .repeat_interleave(rep, dim=2).transpose(1, 2)
                 .to(dtype).contiguous() for x in (k, v))


def kernel_ms_by_name(fn, calls: int) -> dict:
    """Mean device time (ms) of each kernel that ``calls`` calls of ``fn``
    launch, by the profiler's kernel name, after a warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def graph_ms(fns) -> float:
    """Device time of one call, over ``fns`` called in turn, captured once
    into a CUDA graph and replayed: no host in the loop."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    return cuda_ms(graph.replay, iters=20) / len(fns)


def split_readings(label, call, prefix, pools, table, pos, bs) -> dict:
    """The split schedule of K4 or K6 (``call(pool)``, its kernels named
    ``<prefix>_split_kernel`` and ``<prefix>_combine_kernel``) at these
    inputs, and three checks of it: a call and its rerun equal bit for
    bit (no float atomics); the wrapper makes no host sync (it never
    reads ``pos``: under ``set_sync_debug_mode`` any sync raises); and
    each of its two kernels' device time under the profiler over the
    rotated pools, the combine pass alone among them."""
    import torch
    from repro_torch.kernels.flash_attention import split_policy

    first = call(pools[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = call(pools[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(first, again):
        raise AssertionError(f"{label}: a rerun differs from its call")
    it = iter(range(1 << 30))
    by_name = kernel_ms_by_name(lambda: call(pools[next(it) % N_COPIES]),
                                40)
    ms = {part: sum(t for n, t in by_name.items()
                    if f"{prefix}_{part}_kernel" in n)
          for part in ("split", "combine")}
    if not all(ms.values()):
        raise AssertionError(f"{label}: the profiler saw {sorted(by_name)}")
    per, n_split = split_policy(table.shape[1], bs)
    return {"blocks_per_split": per, "n_split": n_split,
            "live_splits": int((pos // (per * bs) + 1).sum()),
            "rerun_equal": True, "host_syncs": 0,
            "split_ms": ms["split"], "combine_ms": ms["combine"]}


def hold_edge(label, kernel, plain, pos, tol, s=K4_EDGE) -> dict:
    """A decode kernel at ``s`` (``K4_EDGE``'s splits): each (slot, head)
    row of ``kernel(pos)`` within ``tol`` x max|out| of ``plain(pos)``, a
    call equal to its rerun bit for bit, and the control (the plain
    version one row past pos must exceed the limit)."""
    import torch
    from repro_torch.kernels.flash_attention import split_policy
    out, again, want = kernel(pos), kernel(pos), plain(pos)
    ratio = float(over_limit(out, want, tol).max())
    if not ratio <= 1.0 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label} at {s}: {ratio} x the limit")
    if not torch.equal(out, again):
        raise AssertionError(f"{label} at {s}: a rerun differs")
    control = off_by_one_control(f"{label} at {s}", plain, want, pos,
                                 s["W"] * s["bs"], tol)
    per, n_split = split_policy(s["W"], s["bs"])
    return {"shapes": s, "positions": list(K4_EDGE_POS),
            "blocks_per_split": per, "n_split": n_split,
            "max_err_over_limit": ratio, "off_by_one_min_over_limit": control,
            "rerun_equal": True}


def k4_edge_readings(dtype, rng, s=K4_EDGE) -> dict:
    """K4 at ``s`` (``K4_EDGE``; ``hold_edge``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    name = str(dtype).split(".")[1]
    q, (pool,), table, pos = k4_inputs(dtype, rng, DEVICE, s, K4_EDGE_POS,
                                       copies=1)
    return hold_edge(
        f"K4 {name}",
        lambda at: paged_decode_attention_grouped(q, pool[0], pool[1],
                                                  table, at),
        lambda at: ref.paged_decode_attention_ref(q, pool[0], pool[1],
                                                  table, at),
        pos, K4_TOL[name], s)


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, pools, table, pos = k4_inputs(dtype, rng, DEVICE)
        r = hold_and_time(
            f"K4 {name}", q, pos, pools,
            lambda p, at: paged_decode_attention_grouped(q, p[0], p[1],
                                                         table, at),
            lambda p, at: ref.paged_decode_attention_ref(q, p[0], p[1],
                                                         table, at),
            lambda p: to_heads(p[0], p[1], table, dtype))
        bound_ms, bound_by = k4_bound(q, pos, name)
        results[name] = {"dtype": name, **r, "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         **split_readings(
                             f"K4 {name}",
                             lambda p: paged_decode_attention_grouped(
                                 q, p[0], p[1], table, pos),
                             "paged_decode", pools, table, pos,
                             K4_SHAPES["bs"]),
                         "edge": k4_edge_readings(dtype, rng)}
        del pools
        torch.cuda.empty_cache()
    emit({"phase": "kernels", **K4, "shapes": K4_SHAPES,
          "positions": list(K4_POS),
          "launches": paged_decode_attention_grouped.launches,
          "results": list(results.values())})
    return results


def k6_inputs(kv_dtype, dtype, rng, device, s=K4_SHAPES, positions=K4_POS,
              copies=N_COPIES):
    """K6's inputs at the serve shapes (``k4_table``) or ``s``: ``copies``
    pools of random K/V quantized on the card with the port's quantizer,
    whose scratch block 0 holds the grid's max-magnitude codes and scales
    of 3e4 — garbage that must never be read."""
    import torch
    from repro_torch.core import quant
    b, h, g, d, bs = s["B"], s["H"], s["G"], s["D"], s["bs"]
    n, table, pos = k4_table(rng, s, positions)
    spec = quant.spec(kv_dtype)
    top = ((1 << spec.n_mant) - 1 if spec.kind == "int" else
           (((1 << spec.n_exp) - 1) << spec.n_mant) | ((1 << spec.n_mant) - 1))
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    pools = []
    for _ in range(copies):
        kv = torch.randn((2, n, bs, g, d), generator=gen, device=device)
        codes, scales = quant.quantize_kv(kv, kv_dtype)
        codes[:, 0] = top
        scales[:, 0] = 3.0e4
        pools.append((codes, scales))
        del kv
    q = torch.randn((b, h, d), generator=gen, device=device).to(dtype)
    return (q, pools, torch.from_numpy(table).to(device),
            torch.from_numpy(pos).to(device))


def k6_bound(q, codes, pos, s=K4_SHAPES) -> tuple[float, str]:
    """Least time for this K6 call: the bytes the function must move (q
    and pos read once; the codes and the float32 scales of the K and V
    rows at positions 0..pos[b] read once with the table entries they sit
    in; the output written once) over HBM rate, against its float32
    operations (q.k and p.v per query head, one dequantizing multiply per
    K/V element) over the float32 peak."""
    p = pos.cpu().numpy().astype(np.int64)
    rows = int((p + 1).sum())
    entries = int((p // s["bs"] + 1).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * rows * s["G"] * (s["D"] * codes.element_size() + 4)
              + entries * 4 + pos.numel() * 4)
    flops = 4 * rows * s["H"] * s["D"] + 2 * rows * s["G"] * s["D"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k6_edge_readings(kv_dtype, dtype, rng, s=K4_EDGE) -> dict:
    """K6 at ``s`` (``K4_EDGE``; ``hold_edge``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped_q)
    name = str(dtype).split(".")[1]
    q, (pool,), table, pos = k6_inputs(kv_dtype, dtype, rng, DEVICE, s,
                                       K4_EDGE_POS, copies=1)
    (kc, vc), (ks, vs) = pool
    return hold_edge(
        f"K6 {kv_dtype}/{name}",
        lambda at: paged_decode_attention_grouped_q(
            q, kc, ks, vc, vs, table, at, kv_dtype=kv_dtype),
        lambda at: ref.paged_decode_attention_q_ref(
            q, kc, ks, vc, vs, table, at, kv_dtype),
        pos, K4_TOL[name], s)


def phase_kernels_q(seed: int) -> dict:
    """K6 against its plain version for every grid, timed and checked as
    K4 is (its split readings; its edge check for ``K6_EDGE_GRIDS``). The
    library yardstick's K/V are dequantized as well as gathered
    beforehand: no single PyTorch call dequantizes and attends, so it
    times the attention alone."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped_q)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed + 10)
    results = {}
    for kv_dtype, qname in K6_CASES:
        dtype = getattr(torch, qname)
        q, pools, table, pos = k6_inputs(kv_dtype, dtype, rng, DEVICE)

        def args(pool, at):
            (kc, vc), (ks, vs) = pool
            return (q, kc, ks, vc, vs, table, at)

        def heads(pool):
            (kc, vc), (ks, vs) = pool
            return to_heads(quant.dequantize_kv(kc, ks, kv_dtype),
                            quant.dequantize_kv(vc, vs, kv_dtype), table,
                            dtype)

        r = hold_and_time(
            f"K6 {kv_dtype}/{qname}", q, pos, pools,
            lambda p, at: paged_decode_attention_grouped_q(
                *args(p, at), kv_dtype=kv_dtype),
            lambda p, at: ref.paged_decode_attention_q_ref(*args(p, at),
                                                           kv_dtype),
            heads)
        bound_ms, bound_by = k6_bound(q, pools[0][0], pos)
        split = split_readings(
            f"K6 {kv_dtype}/{qname}",
            lambda p: paged_decode_attention_grouped_q(*args(p, pos),
                                                       kv_dtype=kv_dtype),
            "paged_decode_q", pools, table, pos, K4_SHAPES["bs"])
        edge = (k6_edge_readings(kv_dtype, dtype, rng)
                if kv_dtype in K6_EDGE_GRIDS else None)
        results[(kv_dtype, qname)] = {"kv_dtype": kv_dtype, "dtype": qname,
                                      **r, "bound_ms": bound_ms,
                                      "bound_by": bound_by, **split,
                                      "edge": edge}
        del pools
        torch.cuda.empty_cache()
    emit({"phase": "kernels", **K6, "shapes": K4_SHAPES,
          "positions": list(K4_POS),
          "launches": paged_decode_attention_grouped_q.launches,
          "results": list(results.values())})
    return results


# ---------------------------------------------------------------------------
# 3. parity: kernel vs gather path at full width, 2 layers, float32
# ---------------------------------------------------------------------------


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)),
                         dtype=np.int32) for _ in range(n)]


# Logits of the kernel and the gather path, relative to max|logit|. The
# two paths sum in different orders, so a K/V vector of the second layer
# differs in its last bits between them; over a quantized pool, a value
# that lies that close to a rounding boundary takes the neighbouring code
# on one path, and that whole grid step (1/16 of the value in fp8_e4m3)
# moves the logits by some 1e-4 of their range. So quantized pools are
# held to 1e-3, and ``pool_flips`` counts the codes that differ and checks
# each is one grid step.
PARITY_TOL = {False: 1e-4, True: 1e-3}


def pool_flips(pool_a, pool_b, kv_dtype) -> dict:
    """Codes that differ between two quantized pools written through the
    same block trajectory, with the largest scale difference; raises
    unless every differing value is within twice the grid's error bound
    of the other. The scratch block 0 is left out: idle slots and prefill
    padding write there at one index, and which write lands is not
    defined on the card."""
    from repro_torch.core import quant
    flips, worst_scale = 0, 0.0
    for leaf in ("k", "v"):
        sa, sb = pool_a[leaf + "_scale"][:, 1:], pool_b[leaf + "_scale"][:, 1:]
        ca, cb = pool_a[leaf][:, 1:], pool_b[leaf][:, 1:]
        flips += int((ca != cb).sum())
        worst_scale = max(worst_scale, float(
            ((sa - sb).abs() / sb.abs().clamp_min(1e-30)).max()))
        a = quant.dequantize_kv(ca, sa, kv_dtype)
        b = quant.dequantize_kv(cb, sb, kv_dtype)
        bound = 2 * quant.error_bound(b, kv_dtype, sb) + 1e-5 * b.abs().amax(
            -1, keepdim=True)
        if not bool(((a - b).abs() <= bound).all()):
            raise AssertionError(f"parity {kv_dtype}: pools differ by more "
                                 f"than one grid step")
    return {"code_flips": flips, "max_scale_rel_diff": worst_scale}


def quantization_reading(ticks, fp32_ticks, tol) -> float:
    """The control of the quantized parity: the kernel path's logits over
    the quantized pool against those over the fp32 pool, as a fraction of
    the parity limit, over the ticks up to the first whose tokens differ
    (later logits follow other tokens). Every value of that pool is up to
    half a grid step off the fp32 one: a path that decoded all its codes
    one step wrong, or attended in a coarser precision, reads like this."""
    worst = 0.0
    for a, b in zip(ticks, fp32_ticks):
        worst = max(worst, float((a - b).abs().max())
                    / (tol * float(b.abs().max())))
        if not bool((a.argmax(-1) == b.argmax(-1)).all()):
            break
    return worst


def parity_runs(cfg, model, prompts, kv_dtypes, config: str,
                batch: int = 4) -> dict:
    """The kernel path against the gather path of ``ServeEngine`` on
    ``model`` over ``prompts`` (8 new tokens each, batched prefill, blocks
    of 16), for each pool of ``kv_dtypes`` (the first "fp32"): identical
    tokens, each tick's logits within ``PARITY_TOL`` x max|logit|, K4 (K6
    over a quantized pool) launched ``cfg.n_layers`` times a tick — its
    count set to 0 just before the kernel path's run, read just after —
    and over a quantized pool the control (``quantization_reading``) and
    the codes that differ (``pool_flips``). Emits one ``parity`` line per
    pool; returns each pool's kernel launches."""
    import torch
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q)
    from repro_torch.serve import Request, ServeEngine

    def drive(attn_kernel, kv_dtype):
        ticks = []

        def sample(logits):
            ticks.append(logits.clone())
            return torch.argmax(logits, -1)

        eng = ServeEngine(cfg, model, batch=batch, max_len=64, paged=True,
                          kv_block_size=16, prefill="batch",
                          attn_kernel=attn_kernel, sample=sample,
                          kv_dtype=kv_dtype, device=DEVICE)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=8))
        return {r.rid: r.out for r in eng.run()}, ticks, eng.cache

    fp32_ticks = None
    launched = {}
    for kv_dtype in kv_dtypes:
        kernel = (paged_decode_attention_grouped if kv_dtype == "fp32"
                  else paged_decode_attention_grouped_q)
        kernel.launches = 0
        got, lk, pool_k = drive(True, kv_dtype)
        fp32_ticks = lk if fp32_ticks is None else fp32_ticks
        launches = launched[kv_dtype] = kernel.launches
        want, lg, pool_g = drive(False, kv_dtype)
        if got != want:
            raise AssertionError(f"parity {config} {kv_dtype}: tokens "
                                 f"differ: kernel {got} vs gather {want}")
        if len(lk) != len(lg):
            raise AssertionError(f"parity {config} {kv_dtype}: tick counts "
                                 f"differ")
        if launches != cfg.n_layers * len(lk):
            raise AssertionError(f"parity {config} {kv_dtype}: "
                                 f"{kernel.__name__} ran {launches} times, "
                                 f"want {cfg.n_layers} x {len(lk)} ticks")
        worst = 0.0
        tol = PARITY_TOL[kv_dtype != "fp32"]
        for a, b in zip(lk, lg):
            err = float((a - b).abs().max())
            lim = tol * float(b.abs().max())
            worst = max(worst, err / lim)
            if not err <= lim:
                raise AssertionError(f"parity {config} {kv_dtype}: logits "
                                     f"differ by {err} > {lim}")
        line = {"phase": "parity", "config": config,
                "requests": len(prompts), "ticks": len(lk),
                "tokens_identical": True, "max_err_over_limit": worst}
        if kv_dtype != "fp32":
            line.update(kv_dtype=kv_dtype, kernel=kernel.__name__,
                        launches=launches, tol=tol,
                        quantization_over_limit=quantization_reading(
                            lk, fp32_ticks, tol),
                        **pool_flips(pool_k, pool_g, kv_dtype))
        else:
            line.update(launches=launches)
        emit(line)
    return launched


def phase_parity(seed: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    prompts = make_prompts(np.random.default_rng(seed), 4, 17, 40,
                           cfg.vocab_size)
    parity_runs(cfg, model, prompts, ("fp32", "int8", "fp8_e4m3"),
                "llama3-8b n_layers=2 float32")


# ---------------------------------------------------------------------------
# 4. serve: llama3-8b full published config, bfloat16
# ---------------------------------------------------------------------------


def phase_serve(seed: int) -> dict:
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped)
    from repro_torch.models import DecoderLM
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"serve: {n_params} params, want "
                             f"{cfg.param_count() + cfg.d_model}")
    prompts = make_prompts(np.random.default_rng(seed + 1), 16, 64, 512,
                           cfg.vocab_size)
    finite = []

    def sample(logits):
        if logits.shape != (8, cfg.vocab_size):
            raise AssertionError(f"serve: logits {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, model, batch=8, max_len=1024, kv_block_size=16,
                      paged=True, attn_kernel=True, prefill="batch",
                      sample=sample, device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=32))
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention_grouped.launches = 0
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_decode_attention_grouped.launches
    obs.disable()
    if launches != cfg.n_layers * eng._tick or launches == 0:
        raise AssertionError(f"serve: {launches} kernel launches, want "
                             f"{cfg.n_layers} x {eng._tick} ticks")
    if len(done) != len(prompts) or any(
            len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in r.out) for r in done):
        raise AssertionError("serve: not every request finished with 32 "
                             "valid tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("serve: non-finite logits")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    prefill_s = sum(e.dur_s for e in tr.spans(name="prefill:batch"))
    generated = sum(len(r.out) for r in done)
    emit({"phase": "serve", "config": "llama3-8b full (32 layers) bfloat16",
          "params": n_params, "init_s": init_s, "requests": len(done),
          "ticks": eng._tick, "generated_tokens": generated,
          "wall_s": wall_s, "decode_s": decode_s, "prefill_s": prefill_s,
          "decode_tok_per_s": generated / decode_s,
          "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "k4_launches": launches, "preemptions": eng.preemptions})
    return {"launches": launches, "engine": eng}


def decode_group(name: str) -> str | None:
    """"k6" or "k4" for a profiled kernel of K6 or K4 (each its split and
    combine kernels, by their own names: no K6 name holds a K4 name), else
    None."""
    name = name.lower()
    if any(f"paged_decode_q_{part}_kernel" in name
           for part in ("split", "combine")):
        return "k6"
    if any(f"paged_decode_{part}_kernel" in name
           for part in ("split", "combine")):
        return "k4"
    return None


def phase_profile(eng, seed: int, phase: str = "profile",
                  prompt_len: int = 256, warm_ticks: int = 1) -> None:
    """Where a decode tick's time goes: a second load (8 requests of
    ``prompt_len`` prompt tokens, 8 output tokens each) on a serve
    phase's engine. The first ``warm_ticks`` ticks (admission, and
    prefill or prompt replay) run untraced; the remaining ticks run
    under ``torch.profiler`` (the card traced alone): device time of
    every kernel, grouped into K4 (its split and combine kernels), K6,
    matrix products and the rest, against the host's wall time."""
    import torch
    from repro_torch.serve import Request
    prompts = make_prompts(np.random.default_rng(seed + 2), 8, prompt_len,
                           prompt_len, eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=p, max_tokens=8))
    for _ in range(warm_ticks):
        eng.tick_once()
    torch.cuda.synchronize()
    ticks0 = eng._tick
    # the card alone, as profile_device traces it: no host event is read,
    # and reducing a window of ~10^5 kernels with the host's events
    # beside them takes over a minute
    with device_profile(cpu=False) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {"k4": 0.0, "k6": 0.0, "matmul": 0.0, "other": 0.0}
    n_kernels = 0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        us = e.self_device_time_total
        name = e.key.lower()
        n_kernels += e.count
        if decode_group(name):
            groups[decode_group(name)] += us
        elif any(k in name for k in ("gemm", "gemv", "xmma", "cutlass",
                                     "nvjet")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    device_s = sum(groups.values()) / 1e6
    ticks = eng._tick - ticks0
    emit({"phase": phase, "requests": len(prompts), "ticks": ticks,
          "wall_s": wall_s, "device_kernel_s": device_s,
          "device_kernel_s_per_tick": device_s / ticks,
          "device_busy_share_under_profiler": device_s / wall_s,
          "kernels_launched": n_kernels,
          "device_s_by_group": {k: v / 1e6 for k, v in groups.items()},
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "device_s": e.self_device_time_total / 1e6}
                          for e in top]})


# ---------------------------------------------------------------------------
# 6. serve_kvq: the same model over an fp8_e4m3 KV pool
# ---------------------------------------------------------------------------

# one wave of the 8 slots and prompts of 32–64 tokens: each prompt token
# is a replayed tick (~0.24 s on this pool), a second wave of 8 added ~35
# s of ticks of the same kind, and the script's time limit is shared by
# every phase
SERVE_KVQ_REQUESTS = 8
SERVE_KVQ_PROMPTS = (32, 64)


def phase_serve_kvq(model, seed: int) -> dict:
    """llama3-8b full config, bf16, over a ``SERVE_KV_DTYPE`` pool: the
    kernel path with replayed prompts (a bf16 model with a quantized pool
    runs nowhere else, as in the reference). ``SERVE_KVQ_REQUESTS``
    requests of ``SERVE_KVQ_PROMPTS`` prompt tokens, 32 output tokens
    each, all submitted at once."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q)
    from repro_torch.serve import Request, ServeEngine
    cfg = model.cfg
    prompts = make_prompts(np.random.default_rng(seed + 3),
                           SERVE_KVQ_REQUESTS, *SERVE_KVQ_PROMPTS,
                           cfg.vocab_size)
    finite = []

    def sample(logits):
        if logits.shape != (8, cfg.vocab_size):
            raise AssertionError(f"serve_kvq: logits {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, model, batch=8, max_len=1024, kv_block_size=16,
                      paged=True, attn_kernel=True, prefill="replay",
                      kv_dtype=SERVE_KV_DTYPE, sample=sample, device=DEVICE)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in eng.cache.values())
    kv_blocks = eng.kv.num_blocks
    bf16_bytes = (cfg.n_layers * kv_blocks * eng.block_size * 2
                  * cfg.n_kv_heads * cfg.resolved_head_dim * 2)
    d = cfg.resolved_head_dim
    if pool_bytes * 2 * d != bf16_bytes * (d + 4):     # 132/256 = 0.516
        raise AssertionError(f"serve_kvq: pool {pool_bytes} B, bf16 pool "
                             f"{bf16_bytes} B: want the ratio (D+4)/2D")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention_grouped.launches = 0
    paged_decode_attention_grouped_q.launches = 0
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_decode_attention_grouped_q.launches
    k4_launches = paged_decode_attention_grouped.launches
    obs.disable()
    if launches != cfg.n_layers * eng._tick or launches == 0:
        raise AssertionError(f"serve_kvq: {launches} K6 launches, want "
                             f"{cfg.n_layers} x {eng._tick} ticks")
    if k4_launches != 0:
        raise AssertionError(f"serve_kvq: K4 ran {k4_launches} times")
    if len(done) != len(prompts) or any(
            len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in r.out) for r in done):
        raise AssertionError("serve_kvq: not every request finished with "
                             "32 valid tokens")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("serve_kvq: non-finite logits")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    generated = sum(len(r.out) for r in done)
    emit({"phase": "serve_kvq",
          "config": "llama3-8b full (32 layers) bfloat16",
          "kv_dtype": SERVE_KV_DTYPE, "prefill": "replay",
          "requests": len(done), "ticks": eng._tick,
          "generated_tokens": generated, "wall_s": wall_s,
          "decode_s": decode_s, "tick_ms": decode_s / eng._tick * 1e3,
          "decode_tok_per_s": generated / decode_s,
          "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "kv_blocks": kv_blocks, "pool_bytes": pool_bytes,
          "bf16_pool_bytes": bf16_bytes,
          "pool_ratio": pool_bytes / bf16_bytes,
          "kv_bytes_read": eng.kv_bytes_read,
          "kv_bytes_written": eng.kv_bytes_written,
          "k6_launches": launches, "k4_launches": k4_launches,
          "preemptions": eng.preemptions})
    return {"launches": launches, "engine": eng}


# ---------------------------------------------------------------------------
# 7. pim_lenet: the paper's LeNet-5 through the mapper
# ---------------------------------------------------------------------------


K1 = {"name": "pim_matmul_grouped", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:319"}
K2 = {"name": "pim_matmul", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:230"}
K3 = {"name": "pim_mac", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_mac.cu",
      "replaces": "src/repro/kernels/pim_mac.py:124"}
K5 = {"name": "pim_matmul_grouped_q", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
      "replaces": "src/repro/kernels/pim_mac.py:433"}
# the (weight grid, batch) cases pim_lenet serves; kernels_pim runs the
# first one's launches
PIM_SERVE = (("fp32", 256), ("fp32", 4096))
# K1/K2 against the plain blocked product, per output row as a fraction of
# the row's max|out|: the two sum each product in another order
PIM_MM_TOL = 1e-5
PIM_TOL = dict(rtol=1e-4, atol=1e-4)    # the mapper's verify tolerance


def wall_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean wall time of one ``fn()`` call that ends synchronized."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


PIM_KEYS = ("k1", "k2", "k3", "k5")


def pim_kernels():
    from repro_torch.kernels.pim_mac import (pim_mac, pim_matmul,
                                             pim_matmul_grouped,
                                             pim_matmul_grouped_q)
    return pim_matmul_grouped, pim_matmul, pim_mac, pim_matmul_grouped_q


def reset_counts() -> None:
    for k in pim_kernels():
        k.launches = 0


def read_counts() -> dict:
    return dict(zip(PIM_KEYS, (k.launches for k in pim_kernels())))


def profile_groups(name: str) -> str:
    """Kernel group of a profiled device kernel: K4 or K6
    (``decode_group``), K5 (the dequantizing instantiation of K1's body),
    K1 (with its split-K sum pass), K3, native convolutions (cuDNN),
    native matrix products (cuBLAS), copies/fills/concatenations, or the
    rest."""
    name = name.lower()
    if decode_group(name):
        return decode_group(name)
    if "pim_matmul_kernel<true" in name:
        return "k5"
    if "pim_matmul" in name:
        return "k1"
    if "pim_mac_kernel" in name:
        return "k3"
    if any(k in name for k in ("conv", "cudnn", "wgrad", "dgrad", "fprop",
                               "implicit_gemm")):
        return "native_conv"
    if any(k in name for k in ("gemm", "gemv", "nvjet", "xmma")):
        return "native_mm"
    if any(k in name for k in ("copy", "fill", "cat", "memset", "memcpy")):
        return "copy_fill_cat"
    return "other"


def profile_device(fn, calls: int, warm: bool = True) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler`` after a warm
    call (none where ``warm`` is false: the caller's last call was
    ``fn``'s): device time by ``profile_groups`` against the host's wall
    time. The profiler traces the card alone: the host's events are not
    read, and tracing them would halve the profile's speed and slow the
    host it measures."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    with device_profile(cpu=False) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = dict.fromkeys(("k1", "k5", "k3", "k4", "k6", "native_conv",
                            "native_mm", "copy_fill_cat", "other"), 0.0)
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += e.count
        groups[profile_groups(e.key)] += e.self_device_time_total
    device_s = sum(groups.values()) / 1e6
    return {"calls": calls, "wall_ms_per_call": wall_s / calls * 1e3,
            "device_ms_per_call": device_s / calls * 1e3,
            "device_busy_share_under_profiler": device_s / wall_s,
            "kernels_per_call": n_kernels / calls,
            "device_ms_per_call_by_group": {
                k: v / calls / 1e3 for k, v in groups.items()}}


def faulty(fn, fault, index: int):
    """``fn`` with the ``fault`` (a function of its output) applied to the
    output of its ``index``-th call from now; ``index`` None: no fault."""
    calls = [0]

    def call(*args, **kw):
        out = fn(*args, **kw)
        calls[0] += 1
        return out if calls[0] - 1 != index else fault(out)
    return call


@contextlib.contextmanager
def recording_launches(fault=None, index=None, key="k1"):
    """Log the argument shapes of every K1, K2, K3 and K5 launch the
    mapper's lowering makes while open (K3: the elements of each wave
    under ``k3``, its ``wave_form`` under ``k3_forms``). The lowering's
    wrappers are wrapped, not replaced: they launch and count as always.
    With a ``fault``, the output of the ``index``-th K1 launch (``key``
    "k5": K5's) goes through it (``faulty``): a control that a check must
    catch."""
    from repro_torch.mapper import lowering
    log = {"k1": [], "k2": [], "k3": [], "k5": [], "k3_forms": []}
    orig = {name: getattr(lowering, name)
            for name in ("pim_matmul_grouped", "pim_matmul", "mac_wave",
                         "pim_matmul_grouped_q")}
    k1_call = faulty(orig["pim_matmul_grouped"], fault,
                     index if key == "k1" else None)
    k5_call = faulty(orig["pim_matmul_grouped_q"], fault,
                     index if key == "k5" else None)

    def k1(a, b, **kw):
        log["k1"].append((b.shape[0], kw.get("col_groups", 1), a.shape[1],
                          a.shape[2], b.shape[2]))
        return k1_call(a, b, **kw)

    def k5(a, q, s, **kw):
        log["k5"].append((q.shape[0], kw.get("col_groups", 1), a.shape[1],
                          a.shape[2], q.shape[2]))
        return k5_call(a, q, s, **kw)

    def k2(a, b, **kw):
        log["k2"].append((a.shape[0], a.shape[1], b.shape[1]))
        return orig["pim_matmul"](a, b, **kw)

    def k3(members, *args):           # one K3 launch over the whole wave
        log["k3"].append(wave_elements(members))
        log["k3_forms"].append(wave_form(members))
        return orig["mac_wave"](members, *args)

    for name, fn in zip(orig, (k1, k2, k3, k5)):
        setattr(lowering, name, fn)
    try:
        yield log
    finally:
        for name, fn in orig.items():
            setattr(lowering, name, fn)


def wave_elements(members) -> int:
    """The elements of a K3 wave (its members' outputs)."""
    return sum(int(np.prod(m[0], dtype=np.int64)) for m in members)


def wave_form(members) -> tuple:
    """A K3 wave's form, hashable: per member its shape, its output's
    layout and, per operand, ("t", shape, strides, on the CPU, requires
    grad) for a tensor or the number itself."""
    import torch

    def operand(x):
        if isinstance(x, torch.Tensor):
            return ("t", tuple(x.shape), tuple(x.stride()), x.is_cpu,
                    x.requires_grad)
        return float(x)
    return tuple((tuple(m[0]), m[4] and tuple(m[4]),
                  *(operand(x) for x in m[1:4])) for m in members)


@contextlib.contextmanager
def recording_helpers(fault=None, key=None, index=None):
    """Log every single launch made through the kernel module's helpers
    ``_matmul_grouped`` (K1: G, col_groups, M, K, N), ``_matmul`` (K2: M,
    K, N), ``_mac`` (K3: a wave's elements, and its ``wave_form`` under
    ``k3_forms``) and ``_matmul_grouped_q`` (K5, as K1) while open: the
    autograd Functions' backward passes launch through them. A product logs its logical shape: with ``trans_a`` the stored
    ``a`` is [.., K, M], read as its transpose. With a ``fault``, the
    output of the ``index``-th launch of kernel ``key`` goes through it
    (``faulty``)."""
    mod = importlib.import_module("repro_torch.kernels.pim_mac")
    log = {"k1": [], "k2": [], "k3": [], "k5": [], "k3_forms": []}
    names = {"k1": "_matmul_grouped", "k2": "_matmul", "k3": "_mac",
             "k5": "_matmul_grouped_q"}
    orig = {k: getattr(mod, n) for k, n in names.items()}
    # K3's launch returns one output per member: a fault hits each
    faults = {k: fault if fault is None or k != "k3"
              else (lambda outs: [fault(o) for o in outs]) for k in names}
    calls = {k: faulty(fn, faults[k], index if k == key else None)
             for k, fn in orig.items()}

    def k1(a, b, bm, bn, bk, cg, trans_a=False):
        m, k = a.shape[1:][::-1] if trans_a else a.shape[1:]
        log["k1"].append((b.shape[0], cg, m, k, b.shape[2]))
        return calls["k1"](a, b, bm, bn, bk, cg, trans_a=trans_a)

    def k2(a, b, bm, bn, bk, trans_a=False):
        m, k = a.shape[::-1] if trans_a else a.shape
        log["k2"].append((m, k, b.shape[1]))
        return calls["k2"](a, b, bm, bn, bk, trans_a=trans_a)

    def k3(members, *args):
        log["k3"].append(wave_elements(members))
        log["k3_forms"].append(wave_form(members))
        return calls["k3"](members, *args)

    def k5(a, q, s, bm, bn, bk, cg):
        log["k5"].append((q.shape[0], cg, a.shape[1], a.shape[2],
                          q.shape[2]))
        return calls["k5"](a, q, s, bm, bn, bk, cg)

    for k, fn in zip(names, (k1, k2, k3, k5)):
        setattr(mod, names[k], fn)
    try:
        yield log
    finally:
        for k, fn in orig.items():
            setattr(mod, names[k], fn)


def launch_shapes(prog, prog_log, ex_log, mm: str) -> dict:
    """The logged launches of one compiled call (``mm``: K1, or K5 on a
    quantized grid; K3) and one executor run (K2), each named by the node
    (and block) its plan step lowers: ``mm`` (G, col_groups, M, K, N) per
    placed node, K2 (M, K, N) per placed block, K3 the ``wave_form`` of
    each add; each row one launch (a count of 1, as ``phase_kernels_pim``
    takes them)."""
    placed = [st.node for st in prog.ctx.steps if st.kind == "placed"]
    nodes = [nd for nd in placed if nd.kind != "eltwise"]
    blocks = [f"{nd.name}@{blk.row0},{blk.col0}" for nd in nodes
              for blk in prog.schedule.placement.iter_blocks(nd.idx, 0)]
    adds = [nd.name for nd in placed if nd.kind == "eltwise"]
    want = (len(nodes), len(blocks), len(adds), prog_log["k3_forms"])
    got = (len(prog_log[mm]), len(ex_log["k2"]), len(prog_log["k3"]),
           ex_log["k3_forms"])
    if got != want:
        raise AssertionError(f"pim_lenet: logged launches {got[:3]} do not "
                             f"follow the plan's {want[:3]} (or the "
                             f"executor's adds differ in form)")
    return {mm: [(nd.name, *sh, 1)
                 for nd, sh in zip(nodes, prog_log[mm])],
            "k2": [(b, *sh, 1) for b, sh in zip(blocks, ex_log["k2"])],
            "k3": [(add, form, 1)
                   for add, form in zip(adds, prog_log["k3_forms"])]}


def seeded_params(seed: int, bias_seed: int):
    """LeNet-5 parameters from ``seed`` with seeded non-zero biases (the
    adds the mapper lowers to K3 then carry values)."""
    import torch
    from repro_torch.models import lenet
    params = lenet.init_lenet(seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(bias_seed)
    for leaves in params.values():
        leaves["b"] = torch.randn(leaves["b"].shape, generator=gen,
                                  device=DEVICE)
    return params


def fake_quant_params(params, dtype: str) -> dict:
    """Each weight as the placed block stores it, dequantized: the
    port's ``fake_quant`` per output column of its (k, n) view — every
    node of the LeNet-5 serve and loss graphs is one block on a sub-fp32
    grid, so a column's scale is the block column's. On fp32, the
    parameters themselves."""
    from repro_torch.core import quant
    if dtype == "fp32":
        return params
    return {layer: {"w": quant.fake_quant(
        v["w"].reshape(-1, v["w"].shape[-1]), dtype).reshape(v["w"].shape),
        "b": v["b"]} for layer, v in params.items()}


def phase_pim_lenet(seed: int, cases) -> dict:
    """``compile_lenet("serve", weight_dtype=grid)`` and
    ``ScheduleExecutor`` on the card for each (grid, batch) of ``cases``,
    over digit images, with seeded random parameters (non-zero biases, so
    the adds lowered to K3 carry values). Per call: 5 placed products (K1
    on fp32, K5 on a quantized grid) and 5 K3; the executor one K2 per
    placed block (7 on fp32, 5 on a quantized grid) and 5 K3; logits
    bit-equal to the executor's and within 1e-4 of plain ``lenet_apply``
    over ``fake_quant_params`` (TF32 off). The first case is the main
    path: every count set to 0 just before one program call and one
    executor run, read just after, with the shapes of their launches
    logged for ``kernels_pim``. Emitted as ``pim_lenet`` (fp32) or
    ``pim_lenet_q``."""
    import torch
    from repro_torch import mapper
    from repro_torch.data import make_digits
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    params = seeded_params(seed, seed + 30)
    launches = shapes = profile = None
    for dtype, batch in cases:
        phase = "pim_lenet" if dtype == "fp32" else "pim_lenet_q"
        mm = "k1" if dtype == "fp32" else "k5"
        blocks = 7 if dtype == "fp32" else 5
        imgs, _ = make_digits(batch, seed=seed + batch)
        x = torch.from_numpy(imgs).to(DEVICE)
        prog = mapper.compile_lenet("serve", batch=batch, weight_dtype=dtype)
        ex = mapper.ScheduleExecutor(prog.schedule)
        reset_counts()
        with recording_launches() as prog_log:
            out = prog(params, x)
        prog_counts = read_counts()
        with recording_launches() as ex_log:
            oracle = ex.run(params, x)
        torch.cuda.synchronize()
        counts = read_counts()
        ex_counts = {k: counts[k] - prog_counts[k] for k in counts}
        if launches is None:
            launches = counts
            shapes = launch_shapes(prog, prog_log, ex_log, mm)
        want = ({"k1": 0, "k2": 0, "k3": 5, "k5": 0, mm: 5},
                {"k1": 0, "k2": blocks, "k3": 5, "k5": 0})
        if (prog_counts, ex_counts) != want:
            raise AssertionError(f"{phase} {dtype} {batch}: launches "
                                 f"{prog_counts} compiled, {ex_counts} "
                                 f"per-block; want {want}")
        if (prog.matmul_launches, prog.kernel_launches,
                prog.placed_blocks) != (5, 10, blocks):
            raise AssertionError(f"{phase} {dtype} {batch}: program "
                                 f"counters")
        if out.shape != (batch, 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{phase} {dtype} {batch}: logits "
                                 f"{tuple(out.shape)} not finite")
        if not torch.equal(out, oracle):
            raise AssertionError(f"{phase} {dtype} {batch}: compiled "
                                 f"program and executor differ")
        stored = fake_quant_params(params, dtype)
        with torch.no_grad(), full_float32():
            err = max_deviation(out, lenet.lenet_apply(stored, x), **PIM_TOL)
            fp32_dev = float((out - lenet.lenet_apply(params, x)).abs().max())
            torch.cuda.reset_peak_memory_stats()
            prog(params, x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            prog_ms = wall_ms(lambda: prog(params, x))
            ex_ms = wall_ms(lambda: ex.run(params, x), iters=5)
            plain_ms = wall_ms(lambda: lenet.lenet_apply(stored, x))
            prof = profile_device(lambda: prog(params, x), calls=5)
        emit({"phase": phase, "weight_dtype": dtype, "batch": batch,
              "config": "lenet5 (paper, 21655 params) serve, weights on "
                        f"the {dtype} grid, float32 accumulation",
              "launches_per_call": {"compiled": prog_counts,
                                    "per_block": ex_counts},
              "placed_blocks": prog.placed_blocks,
              "subarrays": prog.schedule.placement.n_subarrays,
              "compiled_equals_executor": True,
              "plain": "lenet_apply over the stored (fake_quant) weights",
              "max_abs_err_vs_plain": err,
              "max_abs_dev_vs_fp32_plain": fp32_dev,
              "ms_per_call": prog_ms, "images_per_s": batch / prog_ms * 1e3,
              "executor_ms_per_call": ex_ms, "plain_ms_per_call": plain_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              f"{mm}_launch_shapes": prog_log[mm],
              "profile": prof})
        if profile is None:
            profile = prof
        del out, oracle, x
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes, "profile": profile}


# ---------------------------------------------------------------------------
# 8. kernels_pim: K1, K2, K3 at the shapes of a main path's launches
# ---------------------------------------------------------------------------

def pim_bound(nbytes: int, flops: int) -> tuple[float, float]:
    """(byte time, operation time) in ms: bytes over HBM rate, float32
    operations over the float32 peak."""
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / PEAK_FLOPS["float32"] * 1e3)


def pim_timing(kernel, plain, library, nbytes: int, flops: int,
               iters: int = 40, plain_iters: int | None = None,
               plain_ms: float | None = None) -> dict:
    """Kernel, plain version and library call timed (``iters`` calls
    each; the plain version ``plain_iters`` where one call takes
    seconds, or ``plain_ms``, one call's time measured by the hold),
    beside the bound of ``nbytes`` moved and ``flops`` float32
    operations."""
    t_bytes, t_ops = pim_bound(nbytes, flops)
    warm = min(3, iters)
    plain_iters = plain_iters or iters
    if plain_ms is None:
        plain_ms = cuda_ms(plain, plain_iters, min(3, plain_iters))
    return {"ms": cuda_ms(kernel, iters, warm),
            "plain_ms": plain_ms,
            "library_ms": cuda_ms(library, iters, warm),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def row_ratio(out, want, tol) -> float:
    """Max over output rows of the error against ``tol`` x the row's
    max|want|."""
    err = (out - want).abs().amax(-1)
    return float((err / (tol * want.abs().amax(-1)).clamp_min(1e-30)).max())


def mm_limit(k: int) -> float:
    """The per-row limit of a K-deep product: ``PIM_MM_TOL`` up to K = 256
    (every serve shape), then growing as sqrt(K), as the rounding of a
    K-term float32 sum does — ``pim_grad``'s dB contracts over M, up to
    147,456 terms at batch 256."""
    return PIM_MM_TOL * max(1.0, (k / 256) ** 0.5)


def split_of(g: int, m: int, k: int, n: int) -> dict:
    """The K split of a K1/K2/K5 launch of G groups of per-block shape (M,
    K, N) (``pim_mac.split_k``): S, the chunk depth and the thread blocks
    of the product. Fails if a launch with K <= 256 splits: every forward
    and dA launch keeps its one ascending chain over K."""
    from repro_torch.kernels.pim_mac import TILE_MN, chunk_depth, split_k
    splits = split_k(m, k, n)
    if k <= 256 and splits != 1:
        raise AssertionError(f"({m}, {k}, {n}) splits {splits} ways")
    return {"splits": splits, "chunk": chunk_depth(k, splits),
            "blocks": g * (m // TILE_MN) * (n // TILE_MN) * splits}


def hold_matmul(label, kernel, plain, dropped, tol=PIM_MM_TOL) -> dict:
    """Hold ``kernel()`` against ``plain()`` per output row, to ``tol`` x
    the row's max|out|; the control ``dropped()`` (the plain product
    without its last K tile) must exceed the limit. ``plain_call_ms``:
    the plain call's time by CUDA events (a loop over groups takes
    seconds at an LM head's G: the caller may time it by this call)."""
    import torch
    out = kernel()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite output")
    ratio = row_ratio(out, want, tol)
    if not ratio <= 1:
        raise AssertionError(f"{label}: error {ratio} x the limit "
                             f"{tol} x max|out| of a row")
    control = row_ratio(dropped(), want, tol)
    if not control > 1:
        raise AssertionError(f"{label}: dropping the last K tile gives only "
                             f"{control} x the limit")
    return {"max_err": float((out - want).abs().max()), "tol": tol,
            "max_err_over_limit": ratio, "control_over_limit": control,
            "out": out, "plain_call_ms": start.elapsed_time(end)}


def counted(rows) -> list:
    """Each distinct launch shape (a tuple, or K3's element count) once,
    with its number of launches last."""
    return [(*(row if isinstance(row, tuple) else (row,)), n)
            for row, n in collections.Counter(rows).items()]


def phase_kernels_pim(seed: int, shapes: dict, path: str, batch: int,
                      wave: bool = False, iters: int = 40,
                      plain_iters: int | None = None) -> dict:
    """K1, K2 and K3 at the ``shapes`` of one of ``path``'s main-path runs,
    each distinct shape once with its number of launches (``counted``), on
    seeded random data, against their plain versions on the card, and
    timed: kernel, plain version, bound (each operand read once and the
    output written once; 2 MK N float32 operations for a product, 2 per
    MAC element) and the library call — ``torch.bmm`` on the same padded
    stacks (shared-A slabs repeated beforehand, untimed) for K1,
    ``torch.mm`` for K2, both with TF32 off. K1 and K2 are held per output
    row to ``mm_limit`` of their contraction. Each K1 and K2 row records
    its K split (``split_of``: S = 1 at every K <= 256), and a K1 launch
    equals K2 on each block and itself on a second run bit for bit. K3 at
    each logged wave's form (``hold_k3``: bit for bit, controls, host
    syncs, events, graph and host time, its bound and library calls).
    With ``wave`` the adds are also made as one wave, and a wave of every
    member form (``k3_forms``) is held with its -0, NaN and inf cases;
    the phase then also reads K3's SASS (``k3_sass``) and holds two waves
    above the member cap a table passed by value holds
    (``k3_above_cap``). ``iters``: the calls timed of each K1 and K2
    shape (fewer where a plain version takes seconds); ``plain_iters``:
    of their plain versions, where one call takes seconds."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import pim_matmul, pim_matmul_grouped
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    k1 = []
    for name, g, cg, m, k, n, count in shapes["k1"]:
        a, b = randn(g // cg, m, k), randn(g, k, n)
        r = hold_matmul(
            f"K1 {path} {name}",
            lambda: pim_matmul_grouped(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a, b, col_groups=cg),
            lambda: ref.pim_matmul_grouped_ref(a[..., :k - 128],
                                               b[:, :k - 128],
                                               col_groups=cg),
            mm_limit(k))
        out = r.pop("out")
        plain_ms = r.pop("plain_call_ms") if plain_iters == 1 else None
        for i in range(g):              # K1 == K2 on the same blocks
            if not torch.equal(out[i], pim_matmul(a[i // cg], b[i])):
                raise AssertionError(f"K1 {path} {name}: group {i} differs "
                                     f"from K2")
        if not torch.equal(out, pim_matmul_grouped(a, b, col_groups=cg)):
            raise AssertionError(f"K1 {path} {name}: a second run differs")
        a_rep = a.repeat_interleave(cg, 0)
        k1.append({"node": name, "G": g, "col_groups": cg, "M": m, "K": k,
                   "N": n, "count": count, **r, **split_of(g, m, k, n),
                   "k1_equals_k2": True, "rerun_equal": True,
                   **pim_timing(
                       lambda: pim_matmul_grouped(a, b, col_groups=cg),
                       lambda: ref.pim_matmul_grouped_ref(a, b,
                                                          col_groups=cg),
                       lambda: torch.bmm(a_rep, b),
                       4 * (a.numel() + b.numel() + g * m * n),
                       2 * g * m * k * n, iters, plain_iters, plain_ms)})
        del a, b, a_rep, out
    k2 = []
    for name, m, k, n, count in shapes["k2"]:
        a, b = randn(m, k), randn(k, n)
        r = hold_matmul(f"K2 {path} {name}", lambda: pim_matmul(a, b),
                        lambda: ref.pim_matmul_ref(a, b),
                        lambda: ref.pim_matmul_ref(a[:, :k - 128],
                                                   b[:k - 128]),
                        mm_limit(k))
        r.pop("out")
        plain_ms = r.pop("plain_call_ms") if plain_iters == 1 else None
        k2.append({"block": name, "M": m, "K": k, "N": n, "count": count,
                   **r, **split_of(1, m, k, n),
                   **pim_timing(
                       lambda: pim_matmul(a, b),
                       lambda: ref.pim_matmul_ref(a, b),
                       lambda: torch.mm(a, b),
                       4 * (a.numel() + b.numel() + m * n),
                       2 * m * k * n, iters, plain_iters, plain_ms)})
        del a, b
    k3 = [hold_k3(f"K3 {path} {name}", form, count, randn)
          for name, form, count in shapes["k3"]]
    extra = {}
    if wave:                        # the adds as one wave, and every form
        adds = tuple(m for _, form, _ in shapes["k3"] for m in form)
        k3.append(hold_k3(f"K3 {path} adds as one wave", adds, 0, randn))
        extra = {"k3_forms": k3_forms(randn), "k3_sass": k3_sass(),
                 "k3_above_cap": [k3_above_cap(n, randn)
                                  for n in K3_ABOVE_CAP]}
    torch.cuda.empty_cache()
    emit({"phase": "kernels_pim", "path": path, "batch": batch,
          "tol": "mm_limit(K)",
          "results": [{**K1, "shapes": k1}, {**K2, "shapes": k2},
                      {**K3, "shapes": k3, **extra}]})
    return {"k1": k1, "k2": k2, "k3": [r for r in k3 if r["count"]]}


def wave_members(form, randn) -> list:
    """The members of a logged ``wave_form`` over fresh data: each tensor
    operand at its logged shape and strides (a strided view of seeded
    random storage; on the CPU where a CPU 0-d tensor was logged), each
    number as logged."""
    from repro_torch.kernels.pim_mac import MacMember

    def operand(x):
        if not isinstance(x, tuple):
            return x
        _, shape, stride, cpu, _ = x
        extent = 1 + sum((d - 1) * st for d, st in zip(shape, stride))
        t = randn(max(extent, 1)).as_strided(shape, stride)
        return t.cpu() if cpu else t
    return [MacMember(shape, *(operand(x) for x in ops), stride)
            for shape, stride, *ops in form]


def same_bits(x, y) -> bool:
    """Bit for bit, NaN as NaN (the card's NaN is not the CPU's)."""
    import torch
    if x.shape != y.shape:
        return False
    # elementwise, with no masked copy: a boolean index of a 778 M-element
    # member (qwen3-32b's tables) would build 12 GB of int64 indices
    nan = torch.isnan(x)
    return bool((nan == torch.isnan(y)).all()) and bool(
        ((x.view(torch.int32) == y.view(torch.int32)) | nan).all())


def k3_library(member):
    """(name, call): the one PyTorch call that computes a member's
    function — ``add`` for ``acc + a*1``, ``sub`` / ``rsub`` for ``acc +
    a*(-1)``, ``mul`` for ``0 + a*b`` (it may keep the sign of a zero
    product), else ``addcmul`` (it may round once)."""
    import torch
    _, a, b, acc, _ = member
    tensor = isinstance(acc, torch.Tensor)
    if not isinstance(b, torch.Tensor) and b == 1.0:
        return "add", (lambda: torch.add(acc, a)) if tensor else (
            lambda: torch.add(a, acc))
    if not isinstance(b, torch.Tensor) and b == -1.0:
        return ("sub", lambda: torch.sub(acc, a)) if tensor else (
            "rsub", lambda: torch.rsub(a, acc))
    if not tensor and acc == 0.0:
        return "mul", lambda: torch.mul(a, b)
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    a_, b_, acc_ = (x if isinstance(x, torch.Tensor)
                    else torch.tensor(x, device=dev) for x in (a, b, acc))
    return "addcmul", lambda: torch.addcmul(acc_, a_, b_)


def host_us(fn, iters: int = 200) -> float:
    """Mean host time (µs) of one ``fn()`` call: the time to enqueue it,
    no sync in the loop."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def negated_immediate(members):
    """The members with their first non-zero immediate negated (what a
    kernel that swapped an immediate for its negation computes), or None
    where the wave has none."""
    for i, m in enumerate(members):
        for r in (1, 2, 3):
            if not hasattr(m[r], "shape") and m[r] != 0:
                bad = list(m)
                bad[r] = -m[r]
                return [*members[:i], type(m)(*bad), *members[i + 1:]]
    return None


# calls captured in one CUDA graph to time a K3 wave: a one-launch graph
# is paced by its own launch
GRAPH_CALLS = 32


def hold_k3(label, form, count, randn) -> dict:
    """K3 over one wave of ``form`` (``wave_members``): one launch, bit
    for bit (NaN as NaN) against its plain version on the card, each
    output in the layout its member asked for; a control — the same wave
    with a non-zero immediate negated must fail that check —; no host sync
    in a launch (``set_sync_debug_mode("error")``); timed by events over
    back-to-back calls (``ms``, the wrapper's host time paces it), from a
    CUDA graph of ``GRAPH_CALLS`` calls (``device_graph_ms``) and on the
    host (``host_us``), beside
    its bound — each operand read once where it lies (a broadcast tensor
    its own elements, an immediate or a CPU 0-d tensor nothing), each
    output written once; 2 operations an element — and the library calls
    computing each member's function (``k3_library``: ``add``, ``sub``,
    ``mul``), with ``addcmul`` on the members' materialized operands for
    continuity with earlier rows."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import mac_wave
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    members = wave_members(form, randn)
    plain = pm._normalized(members, "pim_mac")
    before = pm.pim_mac.launches
    out = mac_wave(members)
    want = ref.pim_mac_wave_ref(plain)
    torch.cuda.synchronize()
    if pm.pim_mac.launches != before + 1:
        raise AssertionError(f"{label}: not one launch")
    for o, w, m in zip(out, want, members, strict=True):
        if not same_bits(o, w):
            raise AssertionError(f"{label}: member {m[0]} not bit-equal to "
                                 f"the plain version")
        if m[4] is not None and o.stride() != tuple(m[4]):
            raise AssertionError(f"{label}: member {m[0]} written in "
                                 f"{o.stride()}, asked {m[4]}")
    bad = negated_immediate(members)
    caught = None
    if bad is not None:
        caught = not all(same_bits(o, w) for o, w in zip(mac_wave(bad),
                                                          want))
        if not caught:
            raise AssertionError(f"{label}: a negated immediate passes")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mac_wave(members)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = pm._plan(plain).rows
    n = wave_elements(members)
    operands = {(x.data_ptr(), tuple(x.shape), x.stride()): x.numel()
                for m in members for x in m[1:4]
                if isinstance(x, torch.Tensor) and x.is_cuda}
    nbytes = 4 * (n + sum(operands.values()))
    libs = [k3_library(m) for m in plain]
    full = [tuple(torch.broadcast_to(torch.as_tensor(
        x, dtype=torch.float32, device=DEVICE), m[0]).contiguous()
        for x in m[1:4]) for m in plain]

    def kernel():
        return mac_wave(members)

    def library():
        return [call() for _, call in libs]

    return {"wave": label, "members": len(members), "n": n, "count": count,
            "flat_members": sum(not r.flags & pm._FLAG_STRIDED
                                for r in rows),
            "strided_members": sum(bool(r.flags & pm._FLAG_STRIDED)
                                   for r in rows),
            "max_err": 0.0, "bit_equal": True, "host_syncs": 0,
            "negated_immediate_caught": caught,
            **pim_timing(kernel, lambda: ref.pim_mac_wave_ref(plain),
                         library, nbytes, 2 * n),
            "library": sorted({name for name, _ in libs}),
            "device_graph_ms": graph_ms([kernel] * GRAPH_CALLS),
            "library_graph_ms": graph_ms([library] * GRAPH_CALLS),
            "host_us": host_us(kernel), "library_host_us": host_us(library),
            "addcmul_ms": cuda_ms(lambda: [torch.addcmul(acc, a, b)
                                           for a, b, acc in full])}


# wave sizes above the member cap of a table passed by value (178): the
# table then goes to the card through device memory, still one launch
K3_ABOVE_CAP = (179, 600)


def k3_above_cap(n: int, randn) -> dict:
    """K3 over one wave of ``n`` members (dense triples, a bias over [R,
    8], an rsub of immediates, a transposed operand times an immediate,
    ragged shapes): one launch, bit for bit (NaN as NaN) against its
    plain version on the card, each output in its member's layout, no
    host sync (``set_sync_debug_mode("error")``: the table's copy to the
    card is enqueued on the stream); timed by events beside its bound and
    the members' library calls (``k3_library``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import MAC_MAX_MEMBERS, MacMember, \
        mac_wave
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    if n <= MAC_MAX_MEMBERS:
        raise AssertionError(f"K3 above the cap: {n} members is not above "
                             f"{MAC_MAX_MEMBERS}")
    members = []
    for i in range(n):
        shape = (3 + i % 61, 8)
        a = randn(*shape)
        members.append((MacMember(shape, a, randn(*shape), randn(*shape)),
                        MacMember(shape, a, 1.0, randn(8)),
                        MacMember(shape, a, -1.0, 0.5),
                        MacMember(shape[::-1], a.T, 2.0, 0.0))[i % 4])
    plain = pm._normalized(members, "pim_mac")
    label = f"K3 a wave of {n} members"
    before = pm.pim_mac.launches
    out = mac_wave(members)
    want = ref.pim_mac_wave_ref(plain)
    torch.cuda.synchronize()
    if pm.pim_mac.launches != before + 1:
        raise AssertionError(f"{label}: not one launch")
    for o, w in zip(out, want, strict=True):
        if not same_bits(o, w):
            raise AssertionError(f"{label}: not bit-equal to the plain "
                                 f"version")
    torch.cuda.set_sync_debug_mode("error")
    try:
        mac_wave(members)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    elems = wave_elements(members)
    operands = {(x.data_ptr(), tuple(x.shape), x.stride()): x.numel()
                for m in members for x in m[1:4]
                if isinstance(x, torch.Tensor)}
    libs = [k3_library(m) for m in plain]
    return {"wave": label, "members": n, "n": elems, "bit_equal": True,
            "max_err": 0.0, "host_syncs": 0,
            **pim_timing(lambda: mac_wave(members),
                         lambda: ref.pim_mac_wave_ref(plain),
                         lambda: [call() for _, call in libs],
                         4 * (elems + sum(operands.values())), 2 * elems,
                         iters=10)}


def k3_forms(randn) -> dict:
    """K3 over one ragged wave of every member form, bit for bit (NaN as
    NaN) against its plain version and against the formulation before
    waves read operands in place (each operand broadcast and laid out
    contiguously, then the plain MAC): dense members; a [C] bias over an
    NHWC view of NCHW and over [N, C]; a 0-d tensor on the card and one on
    the CPU (read as a number); AdamW's float64 constants (0.1, 1e-8, 1 -
    0.999) as immediates; rsub; transposed and sliced operands; a wave
    member of six dims (an operand copied into place, counted); an
    operand off 16 bytes (the scalar path); an immediate -0 in an add and
    an rsub; NaN and inf. Two controls: a
    mul whose product is -0 reads +0 (``torch.mul`` keeps -0), and the
    wave with an immediate negated fails the check."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import MacMember, mac_wave
    pm = importlib.import_module("repro_torch.kernels.pim_mac")

    def t(*shape):
        return randn(*shape) if shape else randn(1)[0]

    inf, nan = float("inf"), float("nan")
    x = t(4, 6, 5, 5)
    nhwc = x.permute(0, 2, 3, 1)
    s0 = t()
    neg_a = torch.tensor([-0.0, 0.0, -1.0, 1e-30, -3.0, 2.0], device=DEVICE)
    neg_b = torch.tensor([1.0, -1.0, 0.0, -1e-30, 0.0, -0.0], device=DEVICE)
    members = [
        *(MacMember(s, t(*s), t(*s), t(*s))
          for s in ((5, 7), (64,), (2, 3, 4), (1031,), (3000,))),
        MacMember(tuple(nhwc.shape), nhwc, 1.0, t(6), nhwc.stride()),
        MacMember((4, 6, 5, 5), x, 1.0, t(6, 1, 1)),
        MacMember((8, 35), t(8, 35), 1.0, t(35)),
        MacMember((3, 4), t(3, 4), s0, 0.0),
        MacMember((), s0, -1.0, 1),
        MacMember((5,), t(5), torch.tensor(0.25), 0.0),
        *(MacMember((257,), t(257), v, 0.0) for v in (0.1, 1e-8, 1 - 0.999)),
        MacMember((257,), t(257), 1.0, 1e-8),
        MacMember((7, 3), t(7, 3), -1.0, 1),
        MacMember((5, 7), t(7, 5).T, t(5, 14)[:, ::2], t(5, 7)),
        MacMember((5, 7), t(7, 5).T, 2.0, t(1, 7), (1, 5)),
        MacMember((2, 3, 4, 5, 6, 7),
                  t(4, 3, 8, 5, 12, 7)[::2, :, ::2, :, ::2, :],
                  t(7, 6, 5, 4, 3, 2).permute(5, 4, 3, 2, 1, 0), 0.5),
        MacMember((1000,), t(1001)[1:], t(1000), 0.5),
        MacMember((6,), neg_a, 1.0, -0.0),      # an immediate -0 kept
        MacMember((6,), neg_a, -1.0, -0.0),
        MacMember((6,), neg_a, neg_b, 0.0),
        MacMember((7,), torch.tensor([nan, inf, -inf, 1.0, inf, 0.0, 2.0],
                                     device=DEVICE),
                  torch.tensor([1.0, 0.0, 2.0, inf, 1.0, nan, 3.0],
                               device=DEVICE),
                  torch.tensor([0.0, 1.0, inf, -inf, -inf, 1.0, nan],
                               device=DEVICE))]
    before = (pm.pim_mac.launches, pm.pim_mac.materialized)
    out = mac_wave(members)
    torch.cuda.synchronize()
    launches = pm.pim_mac.launches - before[0]
    copied = pm.pim_mac.materialized - before[1]
    plain = ref.pim_mac_wave_ref(pm._normalized(members, "pim_mac"))
    for o, w, m in zip(out, plain, members, strict=True):
        pre = ref.pim_mac_ref(*(torch.broadcast_to(torch.as_tensor(
            v, dtype=torch.float32, device=DEVICE), m[0]).contiguous()
            for v in m[1:4]))
        if not (same_bits(o, w) and same_bits(o.contiguous(), pre)):
            raise AssertionError(f"K3 forms: member {m[0]} not bit-equal")
    if launches != 1 or not copied:
        raise AssertionError(f"K3 forms: {launches} launches, {copied} "
                             f"operands copied; want 1 and some")
    zero = out[-2].view(torch.int32)
    signed = torch.mul(neg_a, neg_b).view(torch.int32)
    if not (bool((zero == 0).all()) and bool((signed == -2 ** 31).all())):
        raise AssertionError("K3 forms: 0 + (-0) is not +0")
    bad = mac_wave(negated_immediate(members))
    if all(same_bits(o, w) for o, w in zip(bad, plain)):
        raise AssertionError("K3 forms: a negated immediate passes")
    rows = pm._plan(pm._normalized(members, "pim_mac")).rows
    return {"members": len(members), "launches": launches,
            "bit_equal": True, "pre_change_bit_equal": True,
            "operands_copied": copied,
            "flat_members": sum(not r.flags & pm._FLAG_STRIDED
                                for r in rows),
            "float4_members": sum(bool(r.flags & pm._FLAG_VEC)
                                  for r in rows),
            "neg_zero_reads_plus_zero": True,
            "negated_immediate_caught": True}


def k3_sass() -> dict:
    """K3's SASS by the source lines of its two paths: ``pim_mac.cu``
    built again with line info (``-cubin -lineinfo``, the library's
    flags otherwise) and disassembled (``nvdisasm --print-line-info``).
    Each instruction counts under the flat path (``load4`` through
    ``flat_member``), the index map (``divmod`` through
    ``strided_member``), the compiler's 64-bit division subroutine (which
    the wide index map calls) or elsewhere, by the line it comes from.
    The flat path must hold the 16-byte loads and stores and none of the
    index map's multiply-high or division instructions."""
    import tempfile
    from repro_torch.kernels import build
    src = build.CSRC / "pim_mac.cu"
    text = src.read_text().splitlines()

    def line_of(anchor):
        return next(i for i, ln in enumerate(text, 1) if anchor in ln)

    flat = (line_of("float4 load4("), line_of("// x / size[d + 1]") - 1)
    index = (flat[1] + 1, line_of("pim_mac_kernel(const __grid_constant__")
             - 2)
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "pim_mac.cubin"
        subprocess.run([nvcc, *flags, "-cubin", "-lineinfo", "-o",
                        str(cubin), str(src)], check=True,
                       capture_output=True, timeout=300)
        sass = subprocess.run(
            [str(pathlib.Path(nvcc).with_name("nvdisasm")),
             "--print-line-info", str(cubin)], check=True,
            capture_output=True, text=True, timeout=120).stdout
    ops = ("LDG.E.128", "STG.E.128", "LDG.E", "STG.E", "IMAD.HI", "CALL",
           "MUFU.RCP", "I2F")
    counts = {k: collections.Counter()
              for k in ("flat", "index", "subroutine", "other")}
    line = 0
    for ln in sass.splitlines():
        if "//## File" in ln and "pim_mac.cu" in ln:
            line = int(ln.rsplit("line", 1)[1].split()[0].strip(","))
        elif ln.startswith("$") and ln.rstrip().endswith(":"):
            line = -1               # the compiler's 64-bit division, called
        elif ln.strip().startswith("/*") and "*/" in ln:
            words = ln.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words or not words[0][0].isalpha():
                continue
            where = ("subroutine" if line < 0 else
                     "flat" if flat[0] <= line <= flat[1] else
                     "index" if index[0] <= line <= index[1] else "other")
            counts[where]["instructions"] += 1
            for op in ops:
                if words[0] == op or words[0].startswith(op + "."):
                    counts[where][op] += 1
    got = {k: dict(v) for k, v in counts.items()}
    f = counts["flat"]
    if not (f["LDG.E.128"] and f["STG.E.128"]) or any(
            f[op] for op in ("IMAD.HI", "CALL", "MUFU.RCP", "I2F")):
        raise AssertionError(f"K3 SASS: the flat path {got['flat']}")
    if not counts["index"]["IMAD.HI"]:
        raise AssertionError(f"K3 SASS: no multiply-shift division in the "
                             f"index map {got['index']}")
    return {"lines": {"flat": flat, "index": index}, **got}


# ---------------------------------------------------------------------------
# 9. pim_train: LeNet-5 training through the mapper, Trainer(backend="pim")
# ---------------------------------------------------------------------------

# batch 64 is the reference example's (examples/train_lenet.py); at 4096
# the card, not the host, should set the pace
TRAIN_BATCHES = (64, 4096)
TRAIN_STEPS = 31           # the batch-64 pim run: loss at step 30 < step 0
TRAIN_PARITY_STEPS = 10    # pim against the plain step, loss by loss
TRAIN_BIG_STEPS = 20       # the batch-4096 run
TRAIN_LR = 2e-3            # AdamW, as the reference's example and test
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)   # the reference's pim-vs-jit test
PIM_GRAD_BATCH = 256
PIM_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # the reference's _tree_close


def adamw_train_step(opt):
    """The reference example's step: loss and grads of ``lenet_loss``,
    then one AdamW update."""
    import torch
    from repro_torch.models import lenet

    def train_step(params, opt_state, batch):
        imgs, labels = batch
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return train_step


def make_trainer(backend, params0, batches, steps, ckpt_dir, **kw):
    """A ``Trainer`` on the card from copies of ``params0``, AdamW at
    ``TRAIN_LR``; ``batches`` holds each step's batch, made beforehand on
    the card (``DigitsDataset(seed=0)``), so a step's time is the step's
    own. One checkpoint, at the end. ``kw`` goes to the ``Trainer``
    (``weight_dtype``)."""
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainerConfig
    opt = make_optimizer("adamw", lr=TRAIN_LR)

    def init_state():
        p = {k: {j: v.clone() for j, v in layer.items()}
             for k, layer in params0.items()}
        return p, opt.init(p)

    tc = TrainerConfig(total_steps=steps, ckpt_every=steps + 1,
                       ckpt_dir=str(ckpt_dir), async_ckpt=False)
    return Trainer(tc, train_step=adamw_train_step(opt),
                   init_state=init_state, batch_fn=batches.__getitem__,
                   backend=backend, device=DEVICE, **kw)


def digit_batches(batch: int, steps: int) -> list:
    import torch
    from repro_torch.data import DigitsDataset
    ds = DigitsDataset(batch_size=batch, seed=0)
    return [tuple(torch.from_numpy(x).to(DEVICE) for x in ds.batch(s))
            for s in range(steps)]


def step_wall_s() -> dict:
    """``train.step_wall_s`` of the run since the registry's reset, and
    the mean of its steps after the first (which pays the first launches
    and cuDNN's set-up; ``train.first_step_wall_s``)."""
    from repro_torch import obs
    snap = obs.metrics().snapshot()
    h = snap["histograms"]["train.step_wall_s"]
    first = snap["gauges"]["train.first_step_wall_s"]
    return {**{k: h[k] for k in ("count", "mean", "p50", "p95", "max")},
            "first_s": first,
            "steady_mean": (h["sum"] - first) / (h["count"] - 1)}


def leaves_differing(a, b) -> dict:
    """The leaves of two pytrees that are not bit-equal, with their
    largest difference."""
    from repro_torch._tree import leaves_with_path
    la, lb = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    if la.keys() != lb.keys():
        return {"structure": f"{sorted(la)} != {sorted(lb)}"}
    return {p: float((la[p].double() - lb[p].double()).abs().max())
            for p in la if not la[p].equal(lb[p])}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: the native backward convolutions
    may otherwise sum in an order that changes from run to run, and no
    two runs could be held bit for bit."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def phase_pim_train(seed: int) -> dict:
    """``Trainer(backend="pim")`` and ``Trainer(backend="jit")`` (the plain
    eager step) on the card from the same seeded parameters, TF32 off.
    The batch-64 pim run is the main path: every count set to 0 just
    before its ``TRAIN_STEPS`` steps and read just after. Then one compiled step
    against the per-block executor, bit for bit, with the shapes of both
    logged for ``kernels_pim``, and a profile of the compiled step; then
    20 steps at batch 4096 with a profile of the compiled step."""
    import tempfile

    import torch
    from repro_torch import mapper, obs
    from repro_torch.mapper.executor import full_float32
    from repro_torch.models import lenet
    from repro_torch.optim import make_optimizer
    params0 = lenet.init_lenet(seed, device=DEVICE)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, full_float32():
        tmp = pathlib.Path(tmp)
        batch = TRAIN_BATCHES[0]
        batches = digit_batches(batch, TRAIN_STEPS)
        t0 = time.perf_counter()
        pim = make_trainer("pim", params0, batches, TRAIN_STEPS, tmp / "p")
        build_s = time.perf_counter() - t0
        prog = pim.pim_program
        obs.metrics().reset()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = pim.run()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        wall = step_wall_s()
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        if (counts["k2"] or counts["k5"] or counts["k1"] != 11 * TRAIN_STEPS
                or counts["k3"] % TRAIN_STEPS or not counts["k3"]):
            raise AssertionError(f"pim_train: launches {counts} over "
                                 f"{TRAIN_STEPS} steps; want 11 K1 and a "
                                 f"fixed number of K3 per step, no K2")
        losses = res["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pim_train: loss {losses[-1]} at step "
                                 f"{TRAIN_STEPS - 1} not below {losses[0]}")
        jit = make_trainer("jit", params0, batches, TRAIN_PARITY_STEPS,
                           tmp / "j")
        obs.metrics().reset()
        jit_losses = jit.run()["losses"]
        jit_wall = step_wall_s()
        np.testing.assert_allclose(losses[:TRAIN_PARITY_STEPS], jit_losses,
                                   **LOSS_TOL)
        ex = mapper.ScheduleExecutor(prog.schedule, device=DEVICE)
        state = (pim.params, pim.opt_state, batches[0])
        with deterministic_cudnn():
            with recording_launches() as prog_log:
                got = prog(*state)
            c0 = read_counts()
            with recording_launches() as ex_log:
                want = ex.run(*state)
            torch.cuda.synchronize()
            c1 = read_counts()
            again = prog(*state)
        ex_counts = {k: c1[k] - c0[k] for k in c1}
        diff = leaves_differing(got, want)
        if diff or leaves_differing(got, again):
            raise AssertionError(f"pim_train: compiled step and executor "
                                 f"differ: {diff}; program run twice: "
                                 f"{leaves_differing(got, again)}")
        if (ex_counts["k1"] or ex_counts["k2"] != len(ex_log["k2"])
                or len(prog_log["k3"]) != per_step["k3"]):
            raise AssertionError(f"pim_train: executor launches "
                                 f"{ex_counts}, logged {len(ex_log['k2'])}")
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train", "batch": batch,
              "config": "lenet5 (paper, 21655 params) AdamW lr 2e-3, "
                        "float32, DigitsDataset(seed=0)",
              "steps": TRAIN_STEPS, "build_s": build_s,
              "losses_first": losses[:TRAIN_PARITY_STEPS],
              "loss_last": losses[-1],
              "plain_losses_first": jit_losses,
              "max_loss_dev_vs_plain": float(np.max(np.abs(
                  np.subtract(losses[:TRAIN_PARITY_STEPS], jit_losses)))),
              "launches_per_step": per_step,
              "executor_launches_per_step": ex_counts,
              "compiled_equals_executor": True,
              "nodes": len(prog.schedule.graph.nodes),
              "placed_blocks": prog.placed_blocks,
              "ms_per_step": wall["steady_mean"] * 1e3,
              "images_per_s": batch / wall["steady_mean"],
              "plain_ms_per_step": jit_wall["steady_mean"] * 1e3,
              "train.step_wall_s": wall,
              "plain_train.step_wall_s": jit_wall,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              "profile": prof})
        out["launches"] = counts
        out["executor_launches"] = ex_counts
        out["losses"] = losses
        out["ms_per_step"] = wall["steady_mean"] * 1e3
        out["shapes"] = {"k1": prog_log["k1"], "k2": ex_log["k2"],
                         "k3": prog_log["k3_forms"]}
        out["profile"] = prof
        del pim, jit, got, want, again, state, batches, ex
        torch.cuda.empty_cache()

        batch = TRAIN_BATCHES[1]
        batches = digit_batches(batch, TRAIN_BIG_STEPS)
        big = make_trainer("pim", params0, batches, TRAIN_BIG_STEPS,
                           tmp / "b")
        torch.cuda.reset_peak_memory_stats()
        obs.metrics().reset()
        losses = big.run()["losses"]
        wall = step_wall_s()
        ms = wall["steady_mean"] * 1e3
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train 4096: non-finite loss")
        prog = big.pim_program
        state = (big.params, big.opt_state, batches[0])
        plain = adamw_train_step(make_optimizer("adamw", lr=TRAIN_LR))
        plain_ms = wall_ms(lambda: plain(*state), iters=5)
        prog_ms = wall_ms(lambda: prog(*state), iters=5)
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train", "batch": batch,
              "steps": TRAIN_BIG_STEPS, "losses": losses,
              "ms_per_step": ms, "images_per_s": batch / ms * 1e3,
              "train.step_wall_s": wall,
              "program_ms_per_call": prog_ms,
              "plain_ms_per_step": plain_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "placed_blocks": prog.placed_blocks,
              "profile": prof})
        del big, batches, state
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 10. pim_grad: autograd through a compiled lenet_loss program
# ---------------------------------------------------------------------------


def backward_nodes(*roots) -> dict:
    """The kernel nodes of the autograd graph behind ``roots`` (a loss, or
    a stage's outputs), each by its saved
    operands and the cotangents autograd will ask of it: K1 (A's shape,
    B's shape, tiles, (dA, dB) wanted), K2 (as K1), K5 (A's shape, Q's
    shape, tiles, (dA, dq, ds) wanted), K3 (a wave's elements, (da, db,
    dacc) asked by some member). Fails if a native matrix product or
    convolution is in the graph."""
    nodes = {"k1": [], "k2": [], "k3": [], "k5": []}
    seen, stack = set(), [r.grad_fn for r in roots]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        name = type(fn).__name__
        if name in ("MmBackward0", "BmmBackward0", "ConvolutionBackward0",
                    "AddmmBackward0"):
            raise AssertionError(f"pim_grad: native {name} in the graph")
        wanted = tuple(f is not None for f, _ in fn.next_functions)
        if name in ("_MatmulGroupedBackward", "_MatmulBackward"):
            a, b = fn.saved_tensors
            key = "k1" if name == "_MatmulGroupedBackward" else "k2"
            nodes[key].append((tuple(a.shape), tuple(b.shape), fn.tiles,
                               wanted[:2]))
        elif name == "_MatmulGroupedQBackward":
            a, q, _ = fn.saved_tensors
            nodes["k5"].append((tuple(a.shape), tuple(q.shape), fn.tiles,
                                wanted[:3]))
        elif name == "_MacWaveBackward":
            nodes["k3"].append((sum(int(np.prod(m[0], dtype=np.int64))
                                    for m in fn.spec), fn.asked))
        stack.extend(f for f, _ in fn.next_functions)
    return nodes


def asked(nodes) -> dict:
    """The backward launches ``nodes`` ask of K1, K2 and K3: one per
    operand that wants a cotangent (K3: one per wave for its members'
    da, one for their db; the accumulator takes the cotangent as it is;
    K5's dA and dq are K1 launches, its ds none)."""
    return {"k1": sum(sum(w[:2]) for *_, w in nodes["k1"] + nodes["k5"]),
            "k2": sum(sum(w) for *_, w in nodes["k2"]),
            "k3": sum(sum(w[:2]) for _, w in nodes["k3"])}


def close_ratio(got, want, rtol: float, atol: float) -> float:
    """Max over the leaves' elements of |got - want| / (atol + rtol x
    |want|): above 1 fails ``max_deviation`` at the same rtol and atol."""
    from torch.utils import _pytree as pytree
    return max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
               for g, w in zip(pytree.tree_leaves(got),
                               pytree.tree_leaves(want), strict=True)
               if g.numel())


def grad_magnitudes(grads, rtol: float, atol: float) -> dict:
    """Per leaf: max and median |grad|, and the smallest error in the
    leaf's scale that the rtol/atol check catches (rtol + atol /
    max|grad|)."""
    from repro_torch._tree import leaves_with_path
    out = {}
    for path, v in leaves_with_path(grads):
        top = float(v.abs().max())
        out[path] = {"max_abs": top, "median_abs": float(v.abs().median()),
                     "catches_scale_error_above": rtol + atol / top}
    return out


def grad_controls(run, launches: dict, plain) -> dict:
    """``run(fault, key, index)`` gives gradients with ``fault`` applied
    to the output of launch ``index`` of kernel ``key``. Each launch in
    ``launches`` is dropped (zeroed) and, apart, scaled by 1.01, one at a
    time; every dropped launch must fail the gradient check against
    ``plain``, and the scaled ones' readings (error over the limit) say
    how fine an error the check sees."""
    import torch
    out = {}
    for key, n in launches.items():
        dropped = [close_ratio(run(torch.zeros_like, key, i), plain,
                               **PIM_GRAD_TOL) for i in range(n)]
        scaled = [close_ratio(run(lambda t: t * 1.01, key, i), plain,
                              **PIM_GRAD_TOL) for i in range(n)]
        if not all(r > 1 for r in dropped):
            raise AssertionError(f"pim_grad: a dropped {key} launch passes "
                                 f"the gradient check: {dropped}")
        out[key] = {"dropped_over_limit": dropped,
                    "scaled_1pct_over_limit": scaled}
    return out


def phase_pim_grad(seed: int, weight_dtype: str = "fp32") -> dict:
    """Gradients of ``lenet_loss`` at batch 256 through the mapper with the
    weights on ``weight_dtype``'s grid, against ``torch.func.grad`` of the
    plain loss taken at ``fake_quant_params`` (TF32 off; with the
    straight-through quantizer the weight gradient is Aᵀg at the stored
    point), rtol = atol = 1e-4. ``autograd``: autograd through
    ``compile_schedule(build_schedule(lenet_loss))`` — the main path,
    counts set to 0 just before the program's call and its backward,
    read after each. The forward is 5 placed products (K1, or K5 on a
    quantized grid, the path of K5's VJP and the straight-through
    quantizer) and 5 K3; the backward's K1 and K3 launches must be every
    cotangent autograd asked for (K5's dA and dq are K1 launches), and
    their shapes are logged for the backward kernel checks. On fp32 also
    ``grad_graph``: the compiled program of ``torch.func.grad(lenet_loss)``
    itself, whose backward products are K1 launches of the graph, as in
    the train step. For each, the typical |grad| per leaf beside the
    limit, and controls: each K1 and K3 launch of the backward dropped,
    then scaled by 1.01. The autograd step's wall time and a profile of
    its device time by kernel group (``profile_device``). Emitted as
    ``pim_grad`` or ``pim_grad_q``."""
    import torch
    from repro_torch import mapper
    from repro_torch.data import make_digits
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    phase = "pim_grad" if weight_dtype == "fp32" else "pim_grad_q"
    mm = "k1" if weight_dtype == "fp32" else "k5"
    batch = PIM_GRAD_BATCH
    params = seeded_params(seed, seed + 40)
    imgs, labels = make_digits(batch, seed=seed + 41)
    x = torch.from_numpy(imgs).to(DEVICE)
    y = torch.from_numpy(labels).to(DEVICE)
    abstract = (mapper.abstract_like(params),
                *mapper.abstract_like((x, y)))
    prog = mapper.compile_schedule(
        mapper.build_schedule(lenet.lenet_loss, *abstract,
                              weight_dtype=weight_dtype),
        use_cache=False, device=DEVICE)
    tree = {k: {j: v.clone().requires_grad_(True) for j, v in layer.items()}
            for k, layer in params.items()}
    leaves = [v for layer in tree.values() for v in layer.values()]

    def as_tree(grads):
        it = iter(grads)
        return {k: {j: next(it) for j in layer} for k, layer in tree.items()}

    with full_float32():
        reset_counts()
        loss = prog(tree, x, y)
        torch.cuda.synchronize()
        forward = read_counts()
        if forward != {"k1": 0, "k2": 0, "k3": 5, "k5": 0, mm: 5}:
            raise AssertionError(f"{phase}: forward launches {forward}")
        nodes = backward_nodes(loss)
        want = asked(nodes)
        reset_counts()
        with recording_helpers() as launched:
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        backward = read_counts()
        if ((backward["k1"], backward["k3"]) != (want["k1"], want["k3"])
                or backward["k2"] or backward["k5"] or not backward["k1"]
                or not backward["k3"]):
            raise AssertionError(f"{phase}: backward launches {backward}, "
                                 f"autograd asked for {want}")
        stored = fake_quant_params(params, weight_dtype)
        plain = torch.func.grad(lenet.lenet_loss)(stored, x, y)
        err = max_deviation(as_tree(grads), plain, **PIM_GRAD_TOL)

        def autograd_run(fault, key, index):
            loss = prog(tree, x, y)
            with recording_helpers(fault, key, index):
                return as_tree(torch.autograd.grad(loss, leaves))

        controls = grad_controls(
            autograd_run, {k: want[k] for k in ("k1", "k3")}, plain)

        def step():
            return torch.autograd.grad(prog(tree, x, y), leaves)

        ms = wall_ms(step, iters=10)
        prof = profile_device(step, 5)
        plain_ms = wall_ms(lambda: torch.func.grad(lenet.lenet_loss)(
            stored, x, y), iters=10)
        graph = (grad_graph_check(abstract, params, x, y, plain)
                 if weight_dtype == "fp32" else None)
        executor = (executor_grad_check(prog.schedule, tree, leaves, as_tree,
                                        x, y, grads, plain)
                    if weight_dtype == "fp32" else None)
    emit({"phase": phase, "batch": batch, "weight_dtype": weight_dtype,
          "tol": PIM_GRAD_TOL,
          "grad_magnitudes": grad_magnitudes(plain, **PIM_GRAD_TOL),
          "autograd": {"launches_forward": forward,
                       "launches_backward": backward,
                       "cotangents_asked": want, f"{mm}_nodes": nodes[mm],
                       "max_abs_err_vs_plain": err, "controls": controls,
                       "ms_forward_backward": ms, "profile": prof},
          "grad_graph": graph,
          "executor": executor and {k: v for k, v in executor.items()
                                    if k not in ("nodes", "launched")},
          "plain_ms": plain_ms})
    return {"forward": forward, "backward": backward, "nodes": nodes,
            "launched": launched, "executor": executor, "profile": prof}


def executor_grad_check(schedule, tree, leaves, as_tree, x, y, prog_grads,
                        plain) -> dict:
    """Autograd through the per-block executor (``ScheduleExecutor.run``)
    of the same ``lenet_loss`` schedule: counts set to 0 just before its
    forward and its backward, read after each. The forward is 7 K2 (one
    per placed block) and 5 K3; the backward's K2 launches (K2's VJP
    ``_Matmul``) and K3 launches must be every cotangent autograd asked
    of them, with no K1 or K5. Its gradients agree with the compiled
    program's and with plain autograd's (``plain``) within rtol = atol =
    1e-4; whether they equal the compiled program's bit for bit is
    recorded, and its step is profiled as the compiled one's."""
    import torch
    from repro_torch import mapper
    from repro_torch.mapper.executor import max_deviation
    ex = mapper.ScheduleExecutor(schedule, device=DEVICE)
    reset_counts()
    loss = ex.run(tree, x, y)
    torch.cuda.synchronize()
    forward = read_counts()
    if forward != {"k1": 0, "k2": 7, "k3": 5, "k5": 0}:
        raise AssertionError(f"pim_grad executor: forward launches "
                             f"{forward}")
    nodes = backward_nodes(loss)
    want = asked(nodes)
    reset_counts()
    with recording_helpers() as launched:
        flat = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    backward = read_counts()
    grads = as_tree(flat)
    if ((backward["k2"], backward["k3"]) != (want["k2"], want["k3"])
            or backward["k1"] or backward["k5"] or not backward["k2"]):
        raise AssertionError(f"pim_grad executor: backward launches "
                             f"{backward}, autograd asked for {want}")
    err_plain = max_deviation(grads, plain, **PIM_GRAD_TOL)
    err_prog = max_deviation(grads, as_tree(prog_grads), **PIM_GRAD_TOL)

    def step():
        return torch.autograd.grad(ex.run(tree, x, y), leaves)

    ms = wall_ms(step, iters=5)
    return {"launches_forward": forward, "launches_backward": backward,
            "cotangents_asked": want, "k2_nodes": nodes["k2"],
            "max_abs_err_vs_plain": err_plain,
            "max_abs_dev_vs_compiled": err_prog,
            "bit_equal_to_compiled": all(map(torch.equal, flat, prog_grads)),
            "ms_forward_backward": ms, "profile": profile_device(step, 3),
            "nodes": nodes, "launched": launched}


def grad_graph_check(abstract, params, x, y, plain) -> dict:
    """The compiled program of ``torch.func.grad(lenet_loss)`` (fp32): 11
    K1 launches, some K3, no K2; its gradients against ``plain``, with
    each K1 launch dropped and scaled as in ``grad_controls``."""
    import torch
    from repro_torch import mapper
    from repro_torch.mapper.executor import max_deviation
    from repro_torch.models import lenet
    gprog = mapper.compile_schedule(
        mapper.build_schedule(torch.func.grad(lenet.lenet_loss), *abstract),
        use_cache=False, device=DEVICE)
    reset_counts()
    with recording_launches() as glog:
        ggrads = gprog(params, x, y)
    torch.cuda.synchronize()
    gcounts = read_counts()
    if gcounts["k2"] or gcounts["k1"] != 11 or not gcounts["k3"]:
        raise AssertionError(f"pim_grad: grad graph launches {gcounts}; "
                             f"want 11 K1, some K3, no K2")
    gerr = max_deviation(ggrads, plain, **PIM_GRAD_TOL)

    def graph_run(fault, key, index):
        with recording_launches(fault, index):
            return gprog(params, x, y)

    gcontrols = grad_controls(graph_run, {"k1": len(glog["k1"])}, plain)
    gms = wall_ms(lambda: gprog(params, x, y), iters=10)
    return {"launches": gcounts, "max_abs_err_vs_plain": gerr,
            "controls": gcontrols, "ms": gms}


# ---------------------------------------------------------------------------
# 11. kernels_pim, backward: the VJPs of K1 and K3 at pim_grad's shapes
# ---------------------------------------------------------------------------


def phase_kernels_pim_backward(seed: int, grad_run: dict) -> dict:
    """The backward of each K1 node of ``pim_grad``'s autograd graph
    (``backward_nodes``), each distinct node once with its count: random
    operands of the node's shapes, the cotangents it was asked for through
    its autograd Function, whose launches, over every node, must be those
    the main path's backward made. Each launch is held against the plain
    formula on the plain kernels (each output row to ``mm_limit`` of its
    contraction, with the dropped-K-tile control) and timed with its
    bound and a library call (``bmm`` with TF32 off, on Aᵀ as a view for
    dB). K3: each wave the main path's backward launched (``da = g*b +
    0`` over its members), at its logged form (``hold_k3``; library
    ``mul``). Each K1 and K2
    launch records its K split (``split_of``), equals itself on a second
    run and the other kernel on the same blocks bit for bit (K1 group by
    group against K2; K2 against K1 with one group), and dB, which reads
    Aᵀ in place, equals the launch on the materialized transpose; dB's
    row also times that launch and the transpose copy it no longer
    needs. K2's VJP is held and timed the same way (``mm``) at each K2
    node of the executor's autograd graph in ``pim_grad``; its launches
    must be those of the executor's backward. ``split_db`` gathers each
    split dB launch's numbers."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import pim_matmul, pim_matmul_grouped
    mod = importlib.import_module("repro_torch.kernels.pim_mac")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 50)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    def segsum(x, cg):
        return x.reshape(x.shape[0] // cg, cg, *x.shape[1:]).sum(1)

    def cotangents(fn, operands, wanted, g):
        """``fn``'s cotangents for the operands ``wanted``, and the
        launches they made."""
        leaves = [t.clone().requires_grad_(w)
                  for t, w in zip(operands, wanted)]
        out = fn(*leaves)
        with recording_helpers() as log:
            got = torch.autograd.grad(out, [t for t in leaves
                                            if t.requires_grad], g)
        it = iter(got)
        return [next(it) if w else None for w in wanted], log

    def same_bits(label, launch, out, others) -> dict:
        """``launch()`` a second time equals ``out`` bit for bit, and so
        does each ``(i, other)``: ``out[i] == other()``."""
        if not torch.equal(launch(), out):
            raise AssertionError(f"{label}: a second run differs")
        for i, other in others:
            if not torch.equal(out[i], other()):
                raise AssertionError(f"{label}: block {i} differs from the "
                                     f"other kernel's launch")
        return {"rerun_equal": True, "k1_equals_k2": True}

    made = collections.Counter()
    k1 = []
    for a_shape, b_shape, (bm, bn, bk, cg), wanted, count in counted(
            grad_run["nodes"]["k1"]):
        a, b = randn(*a_shape), randn(*b_shape)
        g_, k, n = b_shape
        m = a_shape[1]
        g = randn(g_, m, n)
        (da, db), log = cotangents(
            lambda p, q: pim_matmul_grouped(p, q, bm=bm, bn=bn, bk=bk,
                                            col_groups=cg),
            (a, b), wanted, g)
        for sh in log["k1"]:
            made["k1", sh] += count
        lead = {"G": g_, "col_groups": cg, "M": m, "K": k, "N": n,
                "count": count}
        if da is not None:             # dA = K1(g, Bᵀ), summed over groups
            bt = b.transpose(1, 2).contiguous()
            r = hold_matmul(
                f"K1 dA {lead}",
                lambda: segsum(pim_matmul_grouped(g, bt), cg),
                lambda: segsum(ref.pim_matmul_grouped_ref(g, bt), cg),
                lambda: segsum(ref.pim_matmul_grouped_ref(
                    g[..., :n - 128], bt[:, :n - 128]), cg),
                mm_limit(n))
            if not torch.equal(r.pop("out"), da):
                raise AssertionError(f"K1 dA {lead}: autograd differs from "
                                     f"the launch")
            raw = pim_matmul_grouped(g, bt)
            k1.append({"cotangent": "dA", "shared_a": cg > 1, **lead, **r,
                       **split_of(g_, m, n, k),
                       **same_bits(f"K1 dA {lead}",
                                   lambda: pim_matmul_grouped(g, bt), raw,
                                   [(i, lambda i=i: pim_matmul(g[i], bt[i]))
                                    for i in range(g_)]),
                       **pim_timing(
                           lambda: pim_matmul_grouped(g, bt),
                           lambda: ref.pim_matmul_grouped_ref(g, bt),
                           lambda: torch.bmm(g, bt),
                           4 * (g.numel() + bt.numel() + g_ * m * k),
                           2 * g_ * m * k * n)})
            del bt, raw
        if db is not None:             # dB = K1(Aᵀ, g, col_groups)
            at = a.transpose(1, 2).contiguous()

            def in_place():            # the main path's launch: Aᵀ read
                return mod._matmul_grouped(a, g, bk, bn, bm, cg,
                                           trans_a=True)

            r = hold_matmul(
                f"K1 dB {lead}", in_place,
                lambda: ref.pim_matmul_grouped_ref(at, g, col_groups=cg),
                lambda: ref.pim_matmul_grouped_ref(at[..., :m - 128],
                                                   g[:, :m - 128],
                                                   col_groups=cg),
                mm_limit(m))
            out = r.pop("out")
            if not (torch.equal(out, db) and torch.equal(
                    out, pim_matmul_grouped(at, g, col_groups=cg))):
                raise AssertionError(f"K1 dB {lead}: autograd, the launch "
                                     f"and the launch on the materialized "
                                     f"transpose differ")
            a_rep = a.repeat_interleave(cg, 0)
            row = {"cotangent": "dB", "shared_a": cg > 1, **lead, **r,
                   **split_of(g_, k, m, n),
                   **same_bits(f"K1 dB {lead}", in_place, out,
                               [(i, lambda i=i: mod._matmul(
                                   a[i // cg], g[i], bk, bn, bm,
                                   trans_a=True)) for i in range(g_)]),
                   "in_place_equals_materialized": True,
                   "materialized_ms": cuda_ms(
                       lambda: pim_matmul_grouped(at, g, col_groups=cg)),
                   "transpose_copy_ms": cuda_ms(
                       lambda: a.transpose(1, 2).contiguous()),
                   **pim_timing(
                       in_place,
                       lambda: ref.pim_matmul_grouped_ref(
                           at, g, col_groups=cg),
                       lambda: torch.bmm(a_rep.transpose(1, 2), g),
                       4 * (a.numel() + g.numel() + g_ * k * n),
                       2 * g_ * m * k * n)}
            k1.append(row)
            del at, a_rep, out
        del a, b, g, da, db
    # K3: each wave the main path's backward launched, at its logged form
    k3 = [hold_k3(f"K3 pim_grad backward wave {i}", form, count, randn)
          for i, (form, count) in enumerate(collections.Counter(
              grad_run["launched"]["k3_forms"]).items())]
    path = collections.Counter(
        {("k1", sh): c for sh, c in
         collections.Counter(grad_run["launched"]["k1"]).items()})
    if made != path:
        raise AssertionError(f"kernels_pim backward: the held nodes launch "
                             f"{sorted(made.items())}, pim_grad's backward "
                             f"{sorted(path.items())}")
    k2 = []
    made_k2 = collections.Counter()
    for a_shape, b_shape, (bm, bn, bk), wanted, count in counted(
            grad_run["executor"]["nodes"]["k2"]):
        a, b = randn(*a_shape), randn(*b_shape)
        (m, k), n = a_shape, b_shape[1]
        g = randn(m, n)
        (da, db), log = cotangents(
            lambda p, q: pim_matmul(p, q, bm=bm, bn=bn, bk=bk), (a, b),
            wanted, g)
        for sh in log["k2"]:
            made_k2[sh] += count
        lead = {"M": m, "K": k, "N": n, "count": count}
        bt = b.T.contiguous()
        at = a.T.contiguous()
        # (name, the main path's launch, its operands as materialized,
        # the contraction, the cotangent autograd gave)
        for name, launch, lhs, rhs, c, got in (
                ("dA", lambda: pim_matmul(g, bt), g, bt, n, da),
                ("dB", lambda: mod._matmul(a, g, bk, bn, bm, trans_a=True),
                 at, g, m, db)):
            if got is None:
                continue
            r = hold_matmul(f"K2 {name} {lead}", launch,
                            lambda: ref.pim_matmul_ref(lhs, rhs),
                            lambda: ref.pim_matmul_ref(lhs[:, :c - 128],
                                                       rhs[:c - 128]),
                            mm_limit(c))
            out = r.pop("out")
            if not (torch.equal(out, got)
                    and torch.equal(out, pim_matmul(lhs, rhs))):
                raise AssertionError(f"K2 {name} {lead}: autograd, the "
                                     f"launch and the launch on the "
                                     f"materialized operands differ")
            p, q = lhs.shape[0], rhs.shape[1]
            k2.append({"cotangent": name, **lead, **r,
                       **split_of(1, p, c, q),
                       **same_bits(f"K2 {name} {lead}",
                                   lambda: launch()[None], out[None],
                                   [(0, lambda: pim_matmul_grouped(
                                       lhs[None], rhs[None])[0])]),
                       **pim_timing(
                           launch, lambda: ref.pim_matmul_ref(lhs, rhs),
                           lambda: torch.mm(lhs, rhs) if name == "dA"
                           else torch.mm(a.T, g),
                           4 * (lhs.numel() + rhs.numel() + p * q),
                           2 * p * c * q)})
            del out
        del a, b, g, da, db, at, bt
    if made_k2 != collections.Counter(grad_run["executor"]["launched"]["k2"]):
        raise AssertionError(f"kernels_pim backward: the held K2 nodes "
                             f"launch {sorted(made_k2.items())}, the "
                             f"executor's backward "
                             f"{grad_run['executor']['launched']['k2']}")
    torch.cuda.empty_cache()
    split_db = [{"kernel": key, "G": r.get("G", 1), **{f: r[f] for f in (
        "M", "K", "N", "splits", "chunk", "blocks", "ms", "library_ms",
        "bound_ms", "max_err_over_limit", "control_over_limit")}}
        for key, rows in (("k1", k1), ("k2", k2)) for r in rows
        if r["cotangent"] == "dB" and r["splits"] > 1]
    emit({"phase": "kernels_pim", "path": "pim_grad_backward",
          "batch": PIM_GRAD_BATCH, "tol": "mm_limit(contraction)",
          "split_db": split_db,
          "results": [{**K1, "shapes": k1}, {**K3, "shapes": k3},
                      {**K2, "path": "pim_grad executor", "shapes": k2}]})
    return {"k1": k1, "k2": k2, "k3": k3}


# ---------------------------------------------------------------------------
# 12. pim_lenet_q: LeNet-5 served on quantized weight grids (K5), by
# phase_pim_lenet over Q_SERVE
# ---------------------------------------------------------------------------

# (weight grid, batch) of pim_lenet_q; the first is the main path, whose
# launch shapes kernels_pim holds K5 at
Q_SERVE = (("int8", 256), ("fp8_e4m3", 256), ("fp8_e5m2", 256),
           ("fp16", 256), ("int8", 4096))
Q_TRAIN_DTYPE = "int8"
Q_PARITY_STEPS = 5         # int8 against fp32, loss by loss
Q_LOSS_RTOL = 0.02         # the reference's test_trainer_int8_losses_...


# ---------------------------------------------------------------------------
# 13. kernels_pim, K5: at the shapes of a quantized path's launches
# ---------------------------------------------------------------------------


def phase_kernels_pim_q(seed: int, shapes: list, path: str,
                        batch: int, iters: int = 40,
                        plain_iters: int | None = None) -> list:
    """K5 at the ``shapes`` (``(name, G, col_groups, M, K, N, count)``) of
    one of ``path``'s runs, on seeded random activations and weights
    quantized to the int8 grid (``quantize_axis``, as the lowering
    quantizes them), against its plain version per output row to
    ``mm_limit`` (with the dropped-K-tile control) and against K1 on
    ``q * s`` bit for bit; timed (``iters`` calls each, the plain version
    ``plain_iters``) beside its bound
    (each operand read once — Q as float32 — the output written once; 2
    MKN operations per group and the KN dequantizing multiplies) and the
    library call: ``q * s`` then ``torch.bmm`` (TF32 off)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_mac import (pim_matmul_grouped,
                                             pim_matmul_grouped_q)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    rows = []
    for name, g, cg, m, k, n, count in shapes:
        a = randn(g // cg, m, k)
        q, s = quant.quantize_axis(randn(g, k, n), Q_TRAIN_DTYPE, 1)
        r = hold_matmul(
            f"K5 {path} {name}",
            lambda: pim_matmul_grouped_q(a, q, s, col_groups=cg),
            lambda: ref.pim_matmul_grouped_q_ref(a, q, s, col_groups=cg),
            lambda: ref.pim_matmul_grouped_q_ref(a[..., :k - 128],
                                                 q[:, :k - 128], s,
                                                 col_groups=cg),
            mm_limit(k))
        plain_ms = r.pop("plain_call_ms") if plain_iters == 1 else None
        if not torch.equal(r.pop("out"),
                           pim_matmul_grouped(a, q * s, col_groups=cg)):
            raise AssertionError(f"K5 {path} {name}: differs from K1 on "
                                 f"q * s")
        a_rep = a.repeat_interleave(cg, 0)
        rows.append({"node": name, "G": g, "col_groups": cg, "M": m,
                     "K": k, "N": n, "count": count, **r,
                     **split_of(g, m, k, n),
                     "k5_equals_k1_on_q_times_s": True,
                     **pim_timing(
                         lambda: pim_matmul_grouped_q(a, q, s,
                                                      col_groups=cg),
                         lambda: ref.pim_matmul_grouped_q_ref(
                             a, q, s, col_groups=cg),
                         lambda: torch.bmm(a_rep, q * s),
                         4 * (a.numel() + q.numel() + s.numel()
                              + g * m * n),
                         2 * g * m * k * n + g * k * n, iters,
                         plain_iters, plain_ms)})
        del a, q, s, a_rep
    torch.cuda.empty_cache()
    emit({"phase": "kernels_pim", "path": path, "batch": batch,
          "weight_dtype": Q_TRAIN_DTYPE, "tol": "mm_limit(K)",
          "results": [{**K5, "shapes": rows}]})
    return rows


# ---------------------------------------------------------------------------
# 14. pim_train_q: LeNet-5 trained on the int8 weight grid
# ---------------------------------------------------------------------------


def phase_pim_train_q(seed: int, fp32: dict) -> dict:
    """``Trainer(backend="pim", weight_dtype="int8")`` on the card, AdamW
    at ``TRAIN_LR``, batch 64, ``TRAIN_STEPS`` steps from ``pim_train``'s
    seeded parameters and batches — the main path, every count set to 0
    just before and read just after: 11 K5 and a fixed number of K3 per
    step, no K1 or K2. Its first 5 losses within 2% relative of the fp32
    pim trainer's (``fp32``: ``pim_train``'s run of as many steps, whose
    ms per step it is timed beside), and its loss at the last step below
    its first. Then one compiled step against the per-block executor, bit
    for bit (deterministic cuDNN), and against
    ``run_fake_quant_plain`` — the step with native ops over each placed
    product's stationary operand fake-quantized, which shares nothing
    with the lowering — at rtol = atol = 1e-4, with the step's K5 launch
    shapes logged and a profile of the compiled step."""
    import tempfile

    import torch
    from repro_torch import mapper, obs
    from repro_torch.mapper.executor import (full_float32, max_deviation,
                                             run_fake_quant_plain)
    from repro_torch.models import lenet
    params0 = lenet.init_lenet(seed, device=DEVICE)
    batch, steps = TRAIN_BATCHES[0], TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp, full_float32():
        batches = digit_batches(batch, steps)
        t0 = time.perf_counter()
        q = make_trainer("pim", params0, batches, steps, tmp,
                         weight_dtype=Q_TRAIN_DTYPE)
        build_s = time.perf_counter() - t0
        prog = q.pim_program
        obs.metrics().reset()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = q.run()["losses"]
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        wall = step_wall_s()
        if (counts["k1"] or counts["k2"] or counts["k5"] != 11 * steps
                or counts["k3"] % steps or not counts["k3"]):
            raise AssertionError(f"pim_train_q: launches {counts} over "
                                 f"{steps} steps; want 11 K5 and a fixed "
                                 f"number of K3 per step, no K1 or K2")
        if not all(np.isfinite(losses)):
            raise AssertionError("pim_train_q: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pim_train_q: loss {losses[-1]} at step "
                                 f"{steps - 1} not below {losses[0]}")
        fp32_losses = fp32["losses"][:Q_PARITY_STEPS]
        rel = [abs(a - b) / max(abs(b), 1e-6)
               for a, b in zip(losses, fp32_losses)]
        if not max(rel) < Q_LOSS_RTOL:
            raise AssertionError(f"pim_train_q: int8 losses "
                                 f"{losses[:Q_PARITY_STEPS]} off fp32's "
                                 f"{fp32_losses} by {rel}")
        ex = mapper.ScheduleExecutor(prog.schedule, device=DEVICE)
        state = (q.params, q.opt_state, batches[0])
        with deterministic_cudnn():
            with recording_launches() as prog_log:
                got = prog(*state)
            want = ex.run(*state)
        diff = leaves_differing(got, want)
        if diff:
            raise AssertionError(f"pim_train_q: compiled step and executor "
                                 f"differ: {diff}")
        err = max_deviation(got, run_fake_quant_plain(prog.schedule, *state),
                            **PIM_TOL)
        prof = profile_device(lambda: prog(*state), calls=3)
        emit({"phase": "pim_train_q", "batch": batch,
              "weight_dtype": Q_TRAIN_DTYPE,
              "config": "lenet5 (paper, 21655 params) AdamW lr 2e-3, int8 "
                        "weight grid, DigitsDataset(seed=0)",
              "steps": steps, "build_s": build_s,
              "losses_first": losses[:Q_PARITY_STEPS],
              "loss_last": losses[-1], "fp32_losses_first": fp32_losses,
              "max_rel_loss_dev_vs_fp32": max(rel),
              "launches_per_step": {k: v / steps for k, v in counts.items()},
              "compiled_equals_executor": True,
              "max_abs_err_vs_fake_quant_plain_step": err,
              "placed_blocks": prog.placed_blocks,
              "replicas": sum(p.replicas for p in
                              prog.schedule.placement.node_placements
                              .values()),
              "subarrays": prog.schedule.placement.n_subarrays,
              "ms_per_step": wall["steady_mean"] * 1e3,
              "images_per_s": batch / wall["steady_mean"],
              "fp32_pim_ms_per_step": fp32["ms_per_step"],
              "train.step_wall_s": wall,
              "max_memory_allocated_gb": peak / 1e9,
              "modeled_pim_latency_s": prog.schedule.report.latency_s,
              "k5_launch_shapes": prog_log["k5"], "profile": prof})
        del q, got, want, state, batches, ex
        torch.cuda.empty_cache()
    return {"launches": counts, "shapes": {"k5": prog_log["k5"]}}


# ---------------------------------------------------------------------------
# 16. kernels_attn: causal GQA flash attention (K7) through ops.attention
# ---------------------------------------------------------------------------

K7 = {"name": "flash_attention", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
      "replaces": "src/repro/kernels/flash_attention.py:101"}
# (B, S, H, G, D) of the reference's sweep (tests/test_kernels.py), chunks
# of 64; then llama3-8b's heads at S 2048 and 8192, the default chunks
ATTN_TEST_SHAPES = ((1, 128, 4, 2, 64), (2, 128, 8, 8, 32), (1, 64, 6, 3, 16))
ATTN_LLAMA_SHAPES = tuple((1, s, 32, 8, 128) for s in (2048, 8192))
# S no multiple of the 64-row tile: the ragged tile's mask and zero-fill
ATTN_RAGGED_SHAPES = ((1, 200, 8, 2, 64),)
# head dims the kernel is not compiled for, zero-padded to 128 by the
# wrapper (zamba2_7b's 112, and 80), and above 128: 160 padded to 256,
# and 256 itself
ATTN_PADDED_SHAPES = ((1, 256, 8, 2, 112), (1, 256, 8, 2, 80),
                      (1, 256, 8, 2, 160), (1, 256, 8, 2, 256))
# the profiler's name of the body each dtype runs (csrc dispatch)
ATTN_BODY = {"float32": "flash_kernel", "bfloat16": "flash_mma_kernel"}
# the reference's tolerances (rtol = atol), atol here x max|out| of each
# (batch, query, head) row
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_TILE = 64      # csrc kBQ = kBK: the kernel's query and key tiles


def attn_over_limit(out, want, tol):
    """The reference's check, ``assert_allclose(rtol=tol, atol=tol)``,
    with atol scaled to each row's own size: the largest |out - want| /
    (tol (max|want| of the row + |want|)) of each (batch, query, head) row
    of [B, S, H, D], so [B, S, H]. Late queries average thousands of keys
    and their outputs are ~100x smaller than the first query's, so a
    fixed atol, or one scaled to a whole head, could not see their
    errors. The rtol term stays, as in the reference: its bf16 oracle
    rounds the scores to bf16, which alone moves it off an oracle with
    float32 scores by about tol x max|want| of a row
    (``phase_kernels_attn`` reads both against that oracle)."""
    want = want.float()
    scale = want.abs().amax(-1, keepdim=True) + want.abs()
    return ((out.float() - want).abs()
            / (tol * scale).clamp_min(1e-30)).amax(-1)


def last_tile_without_diagonal(s: int, device):
    """The control's mask [S, S]: causal, except that the rows of the last
    ``ATTN_TILE``-row query tile do not read that tile's own (diagonal)
    keys — the fault of a kernel that skips the last query tile's last KV
    tile. Those rows are the latest, so their outputs are the smallest
    and their limits the tightest."""
    import torch
    pos = torch.arange(s, device=device)
    keep = pos[None] <= pos[:, None]
    last = (s - 1) // ATTN_TILE * ATTN_TILE
    keep[last:, last:] = False
    return keep, last


def attn_bound(q, k) -> tuple[float, str]:
    """Least time for one call: the causal flops 4 B H D S (S + 1) / 2 at
    the peak rate of q's type, against q, k, v and the output moved once
    over HBM rate."""
    b, s, h, d = q.shape
    flops = 4 * b * h * d * s * (s + 1) // 2
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels_attn(seed: int) -> dict:
    """K7 through its public entry ``ops.attention`` — the reference's only
    way to its kernel (no model calls it) — at the reference's test shapes
    (chunks of 64) and llama3-8b's heads (S 2048 and 8192), float32 and
    bfloat16, on seeded random q, k, v. The main path is one
    ``ops.attention`` call per case, the launch count set to 0 just before
    each and read after it. Each output is held against
    ``flash_attention_ref`` on the card (TF32 off), every (batch, query,
    head) row to the reference's rtol = atol = ``ATTN_TOL`` with atol x
    the row's own max|out| (``attn_over_limit``), as K4 holds its rows;
    the control — the plain version with the last query tile's diagonal
    KV tile dropped (``last_tile_without_diagonal``) — must exceed that
    limit in some row of that tile. At llama3-8b's heads the kernel, the
    plain version and ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` (held to the same limit) are timed beside the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                    flash_head_dim)
    from repro_torch.mapper.executor import full_float32
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)
    cases = [(name, shape, chunk) for name in ("float32", "bfloat16")
             for shapes, chunk in ((ATTN_TEST_SHAPES, 64),
                                   (ATTN_RAGGED_SHAPES, 256),
                                   (ATTN_PADDED_SHAPES, 64),
                                   (ATTN_LLAMA_SHAPES, 256))
             for shape in shapes]
    results, launches = [], 0
    with torch.no_grad(), full_float32():
        for name, (b, s, h, g, d), chunk in cases:
            dtype, tol = getattr(torch, name), ATTN_TOL[name]
            q, k, v = (torch.randn(shape, generator=gen, device=DEVICE)
                       .to(dtype) for shape in ((b, s, h, d), (b, s, g, d),
                                                (b, s, g, d)))
            label = f"K7 {name} {(b, s, h, g, d)}"
            flash_attention.launches = 0
            with device_profile() as prof:
                out = ops.attention(q, k, v, q_chunk=chunk, kv_chunk=chunk)
                torch.cuda.synchronize()
            if flash_attention.launches != 1:
                raise AssertionError(f"{label}: ops.attention made "
                                     f"{flash_attention.launches} K7 "
                                     f"launches, want 1")
            bodies = [e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "flash" in e.key]
            if len(bodies) != 1 or f"{ATTN_BODY[name]}<" not in bodies[0]:
                raise AssertionError(f"{label}: ran {bodies}, want "
                                     f"{ATTN_BODY[name]}")
            launches += flash_attention.launches
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{label}: non-finite output")
            want = ref.flash_attention_ref(q, k, v)
            ratio = float(attn_over_limit(out, want, tol).max())
            if not ratio <= 1:
                raise AssertionError(f"{label}: error {ratio} x the limit "
                                     f"of a row")
            keep, last = last_tile_without_diagonal(s, DEVICE)
            dropped = ref._masked_attention(q, k, v, keep)
            control = attn_over_limit(dropped[:, last:], want[:, last:],
                                      tol)
            del dropped
            if not float(control.max()) > 1:
                raise AssertionError(
                    f"{label}: dropping the last query tile's diagonal KV "
                    f"tile gives only {float(control.max())} x the limit")
            r = {"dtype": name, "shape": dict(zip("BSHGD", (b, s, h, g, d))),
                 "chunk": chunk, "body": ATTN_BODY[name],
                 "compiled_head_dim": flash_head_dim(d), "tol": tol,
                 "max_err": float((out.float() - want.float()).abs().max()),
                 "max_err_over_limit": ratio,
                 "last_tile_max_err_over_limit": float(attn_over_limit(
                     out[:, last:], want[:, last:], tol).max()),
                 # the row limit without the rtol term, for comparison
                 "max_err_over_tol_row_max": float(
                     over_limit(out, want, tol).max()),
                 "control_max_over_limit": float(control.max()),
                 "control_rows_over_limit": float((control > 1).float()
                                                  .mean())}
            del control
            if name == "bfloat16":
                causal = torch.ones((s, s), dtype=torch.bool,
                                    device=DEVICE).tril()
                f32_scores = ref._masked_attention(
                    q.float(), k.float(), v.float(), causal).to(dtype)
                r.update(oracle_vs_f32_scores_over_tol_row_max=float(
                             over_limit(want, f32_scores, tol).max()),
                         kernel_vs_f32_scores_over_tol_row_max=float(
                             over_limit(out, f32_scores, tol).max()))
                del f32_scores
            if (b, s, h, g, d) in ATTN_LLAMA_SHAPES:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)

                lib_ratio = float(attn_over_limit(
                    library().transpose(1, 2), want, tol).max())
                if not lib_ratio <= 1:
                    raise AssertionError(f"SDPA yardstick {label}: error "
                                         f"{lib_ratio} x the limit")
                iters = 20 if s <= 2048 else 5
                bound_ms, bound_by = attn_bound(q, k)
                r.update(
                    ms=cuda_ms(lambda: flash_attention(q, k, v),
                               iters=iters, warmup=1),
                    plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                        q, k, v), iters=iters, warmup=1),
                    library_ms=cuda_ms(library, iters=iters, warmup=1),
                    library_max_err_over_limit=lib_ratio,
                    bound_ms=bound_ms, bound_by=bound_by)
            results.append(r)
            del q, k, v, out, want
            torch.cuda.empty_cache()
    # the tensor cores are on the bf16 path: HMMA in its SASS (the f32
    # body's for contrast)
    sass = {body: sass_instructions(body, "flash_attention",
                                    count=("HMMA",))
            for body in ATTN_BODY.values()}
    if not sass["flash_mma_kernel"]["HMMA"]:
        raise AssertionError(f"K7: no HMMA in the bf16 body: {sass}")
    emit({"phase": "kernels_attn", **K7, "path": "ops.attention",
          "launches": launches, "sass": sass, "results": results})
    return {"launches": launches, "results": results}


# ---------------------------------------------------------------------------
# 17. pim_fp: the bit-serial multiply (K8) and the bit-plane procedures
# ---------------------------------------------------------------------------

K8 = {"name": "pim_fp32_mul", "route": "cuda",
      "source": "src/repro_torch/kernels/csrc/pim_fp.cu",
      "replaces": "src/repro/kernels/pim_fp.py:104"}
PIM_FP_PAIRS = 1 << 20       # random float32 bit patterns, every exponent
PIM_FP_EDGE_PAIRS = 1 << 12  # each: subnormal products, around 2^-126
PIM_FP_ADD_LANES = 1 << 16   # fp32_add_pim against IEEE addition
PIM_FP_DOT = 64              # pim_dot against a sequential float32 sum
PIM_FP_TIME_N = 1 << 24      # K8 timed against torch.mul
# integer opcodes of the SASS (``sass_instructions``)
SASS_INT_OPS = ("IADD", "IMAD", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL",
                "LEA", "IMNMX", "BFE", "BFI", "PRMT", "FLO", "POPC", "IABS",
                "VIADD", "VIMNMX", "IMUL")


def pim_fp_inputs(seed: int):
    """float32 pairs (numpy): random bit patterns over every exponent
    (zeros, subnormals, inf and NaN included), the reference's edge table
    (``tests/test_kernels.py``), normal pairs whose exact product is
    subnormal, and normal pairs within three ulps of a product of 2^-126
    (either side of the flush)."""
    rng = np.random.default_rng(seed + 70)

    def bits(n):
        return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.float32)

    def normals(n):
        return (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-100, -27, n)
                ).astype(np.float32)

    n = PIM_FP_EDGE_PAIRS
    sub_a = normals(n)
    sub_b = (2.0 ** rng.uniform(-150, -126, n) / sub_a).astype(np.float32)
    near_a = normals(n)
    near_b = ((2.0 ** -126 / near_a.astype(np.float64)).astype(np.float32)
              .view(np.uint32).astype(np.int64) + rng.integers(-3, 4, n)
              ).astype(np.uint32).view(np.float32)
    edge_a = np.array([1e30, 1e30, 1e-30, 1.0, -0.0, np.inf, 1.5, 3.0,
                       1 + 2 ** -23], np.float32)
    edge_b = np.array([1e30, -1e30, 1e-30, 0.0, 2.0, 2.0, 1.5, 1 + 2 ** -23,
                       1 + 2 ** -23], np.float32)
    a = np.concatenate([bits(PIM_FP_PAIRS), edge_a, sub_a, near_a])
    b = np.concatenate([bits(PIM_FP_PAIRS), edge_b, sub_b, near_b])
    return a, b


def bits_differ(got, want) -> int:
    """Lanes whose float32 bits differ, a NaN matching any NaN."""
    import torch
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    return int((~same).sum())


def max_abs_diff(got, want) -> float:
    """max |got - want| over the lanes where neither is NaN (equal infs
    differ by 0, unequal ones by inf)."""
    import torch
    both = ~(got.isnan() | want.isnan())
    diff = torch.where(got[both] == want[both], 0.0,
                       (got[both] - want[both]).abs())
    return float(diff.max()) if diff.numel() else 0.0


def sass_instructions(kernel: str, source: str, count=()) -> dict:
    """All and integer instructions of ``kernel`` (every instantiation) in
    the built ``source`` library's SASS (``cuobjdump -sass``, beside
    nvcc), and those of each opcode prefix in ``count``."""
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build(source))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ops, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):   # predicated
                words = words[1:]
            if words and words[0][0].isalpha():
                ops.append(words[0])
    if not ops:
        raise AssertionError(f"no SASS found for {kernel} in {source}")
    return {"instructions": len(ops),
            "int_instructions": sum(op.startswith(SASS_INT_OPS)
                                    for op in ops),
            **{c: sum(op.startswith(c) for op in ops) for c in count}}


def phase_pim_fp(seed: int) -> dict:
    """K8 and the paper's bit-level FP procedures on the card. The main
    path is one ``pim_fp32_mul`` call over ``pim_fp_inputs`` (the launch
    count set to 0 just before, read after); its result equals, bit for
    bit with NaN as NaN, the plain version ``pim_fp32_mul_ref`` and the
    port's bit-plane ``core.fp.fp32_mul_pim``, both run on the card, and
    ``torch.mul`` of the inputs with subnormals read as signed zeros
    wherever that product is normal (its exact value at least 2^-126 in
    magnitude). ``fp32_add_pim`` on normal-range
    pairs equals IEEE addition wherever the sum is normal or zero, and
    ``pim_dot`` a sequential float32 sum of products (as
    ``tests/test_fp_bitexact.py`` holds them). Then K8 is timed at
    ``PIM_FP_TIME_N`` elements against its plain version and
    ``torch.mul``, beside its byte bound and a static estimate of its
    integer instructions per element: the kernel's integer SASS
    instructions over the sites where it inlines the per-element
    procedure (four in its float4 loop, one in its scalar tail), its loop,
    address and special-value code included. The sites are counted in the
    SASS: each holds one FMUL, its special-value product."""
    import torch
    from repro_torch.core import fp
    from repro_torch.kernels import ref
    from repro_torch.kernels.pim_fp import pim_fp32_mul
    a_np, b_np = pim_fp_inputs(seed)
    a, b = (torch.from_numpy(x).to(DEVICE) for x in (a_np, b_np))
    pim_fp32_mul.launches = 0
    out = pim_fp32_mul(a, b)
    torch.cuda.synchronize()
    launches = pim_fp32_mul.launches
    if launches != 1:
        raise AssertionError(f"pim_fp: {launches} K8 launches, want 1")
    t0 = time.perf_counter()
    bitplane = fp.fp32_mul_pim(a, b)
    torch.cuda.synchronize()
    bitplane_s = time.perf_counter() - t0
    daz_a, daz_b = fp.flush_subnormal(a), fp.flush_subnormal(b)
    ieee = daz_a * daz_b
    # normal: the exact product (a float64 product of float32s is exact)
    # at least 2^-126. Just below it IEEE rounds at the subnormal ulp,
    # 2^-149, and may reach 2^-126, where the procedure rounds at 24 bits
    # and then flushes: the reference's contract, not IEEE's.
    exact = daz_a.double() * daz_b.double()
    normal = ieee.isfinite() & (exact.abs() >= 2.0 ** -126)
    plain = ref.pim_fp32_mul_ref(a, b)
    max_err = max_abs_diff(out, plain)
    checks = {
        "lanes": a.numel(),
        "differ_from_plain": bits_differ(out, plain),
        "differ_from_fp32_mul_pim": bits_differ(out, bitplane),
        "normal_products": int(normal.sum()),
        "differ_from_torch_mul_where_normal": bits_differ(out[normal],
                                                          ieee[normal]),
        "flushed_normal_input_pairs": int(
            ((a.abs() >= 2.0 ** -126) & (b.abs() >= 2.0 ** -126)
             & a.isfinite() & b.isfinite() & (out == 0)).sum()),
        "ieee_subnormal_products": int(
            ((exact.abs() < 2.0 ** -126) & (exact != 0)).sum()),
        "flushed_where_ieee_rounds_to_2^-126": int(
            ((exact.abs() < 2.0 ** -126) & (ieee.abs() == 2.0 ** -126)
             & (out == 0)).sum())}
    rng = np.random.default_rng(seed + 71)
    u = ((rng.integers(0, 2, (2, PIM_FP_ADD_LANES), dtype=np.uint32) << 31)
         | (rng.integers(40, 216, (2, PIM_FP_ADD_LANES), dtype=np.uint32)
            << 23)
         | rng.integers(0, 2 ** 23, (2, PIM_FP_ADD_LANES), dtype=np.uint32))
    x, y = torch.from_numpy(u.view(np.float32)).to(DEVICE)
    s_ieee = x + y
    keep = (s_ieee == 0) | (s_ieee.abs() >= 2.0 ** -126)
    checks["add_lanes"] = int(keep.sum())
    checks["add_differ_from_ieee"] = bits_differ(fp.fp32_add_pim(x, y)[keep],
                                                 s_ieee[keep])
    da = rng.standard_normal(PIM_FP_DOT).astype(np.float32)
    db = rng.standard_normal(PIM_FP_DOT).astype(np.float32)
    seq = np.float32(0)
    for p, r in zip(da, db):
        seq = np.float32(seq + np.float32(p * r))
    dot = float(fp.pim_dot(torch.from_numpy(da).to(DEVICE),
                           torch.from_numpy(db).to(DEVICE)))
    checks["dot_differs_from_sequential"] = int(dot != float(seq))
    bad = {k: v for k, v in checks.items() if "differ" in k and v}
    if bad or not checks["flushed_normal_input_pairs"]:
        raise AssertionError(f"pim_fp: {bad or 'no product was flushed'}")

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 72)
    ta, tb = (torch.randint(-2 ** 31, 2 ** 31, (PIM_FP_TIME_N,),
                            generator=gen, dtype=torch.int64, device=DEVICE)
              .to(torch.int32).view(torch.float32) for _ in range(2))
    if bits_differ(pim_fp32_mul(ta, tb), ref.pim_fp32_mul_ref(ta, tb)):
        raise AssertionError("pim_fp: K8 differs from its plain version at "
                             "the timed size")
    sass = sass_instructions("pim_fp32_mul_kernel", "pim_fp",
                             count=("FMUL",))
    if not sass["FMUL"]:
        raise AssertionError("pim_fp: no FMUL in K8's SASS to count its "
                             "inlined sites by")
    timing = {"n": PIM_FP_TIME_N,
              "ms": cuda_ms(lambda: pim_fp32_mul(ta, tb)),
              "plain_ms": cuda_ms(lambda: ref.pim_fp32_mul_ref(ta, tb),
                                  iters=5, warmup=1),
              "library_ms": cuda_ms(lambda: torch.mul(ta, tb)),
              "bound_ms": 12 * PIM_FP_TIME_N / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "sass": sass,
              "inlined_sites": sass["FMUL"],
              "int_instructions_per_element_static_estimate":
                  sass["int_instructions"] / sass["FMUL"]}
    emit({"phase": "pim_fp", **K8, "path": "pim_fp32_mul",
          "launches": launches, "max_abs_err": max_err, "checks": checks,
          "bitplane_mul_s": bitplane_s, "timing": timing})
    del a, b, out, plain, bitplane, daz_a, daz_b, ieee, exact, ta, tb
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, **timing}


# ---------------------------------------------------------------------------
# 18. pim_llama: llama3-8b's decode step through the mapper
# ---------------------------------------------------------------------------

# the hold: llama3-8b at its published width, float32, cut to 2 layers
LLAMA_HOLD = dict(batch=8, seq_len=512, n_layers=2)
LLAMA_STEPS = 16           # greedy decode steps, compiled against plain
LLAMA_TOL = dict(rtol=1e-4, atol=1e-4)   # the mapper's verify tolerance
# the K3 launches of one step: the final norm's three MACs, the CPU's
# count (tests/test_torch_compile_arch.py); the layer stack runs natively
LLAMA_K3 = 3
# the timed run: the published config as it is (bf16, 32 layers)
LLAMA_TIME = dict(batch=8, seq_len=2048, pos=1024)


def vary_attention_(model, seed: int):
    """``model`` with its attention variants' leaves seeded away from their
    init (which the holds could not tell from a dropped leaf): q/k/v biases
    0.1 N(0, 1), q/k norm scales 1 + 0.25 N(0, 1); a recurrent model's
    constant leaves too (``vary_recurrent_``). A no-op for llama3-8b,
    which has none. Returns ``model``."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 90)
    with torch.no_grad():
        for blk in model.layers:
            for name in ("q_bias", "k_bias", "v_bias", "q_norm", "k_norm"):
                if hasattr(getattr(blk, "attn", None), name):
                    leaf = blk.attn[name]
                    draw = torch.randn(leaf.shape, generator=gen,
                                       device=DEVICE)
                    leaf.copy_(0.1 * draw if name.endswith("bias")
                               else 1 + 0.25 * draw)
        vary_recurrent_(model, gen)
    return model


def vary_recurrent_(model, gen) -> None:
    """The recurrent blocks' leaves their init makes constants seeded
    away from it (``tests/test_torch_recurrent_train.py`` seeds the
    same): ``f_bias``, ``dt_bias``, ``d_skip`` and every norm scale
    (zamba2's shared block's too) + 0.2 N(0, 1), ``a_log`` -1 + 0.2 N(0,
    1) (its decays' exponents stay finite above a chunk's diagonal). A
    no-op for the attention patterns."""
    import torch
    from repro_torch.models import ssm
    shift = {"a_log": -1.0}
    mods = [m for m in model.modules() if isinstance(m, ssm.RecurrentBlock)]
    if not mods:
        return
    if hasattr(model, "shared"):
        mods += [model.shared.norm1, model.shared.norm2]
    for m in mods:
        for name in ("f_bias", "dt_bias", "a_log", "d_skip", "norm/scale",
                     "scale"):
            try:
                leaf = m[name] if isinstance(m, ssm.RecurrentBlock) \
                    else getattr(m, name)
            except (AttributeError, KeyError):
                continue
            leaf.add_(shift.get(name, 0.0) + 0.2 * torch.randn(
                leaf.shape, generator=gen, device=DEVICE).to(leaf.dtype))


def llama_params(cfg, seed: int):
    """(the reference's parameter tree, seeded, on the card; a zero
    contiguous cache is made by the caller): a ``DecoderLM`` initialised
    from ``seed`` (``vary_attention_``) and its ``stacked_params``, the
    module dropped."""
    import torch
    from repro_torch.models import DecoderLM
    model = vary_attention_(DecoderLM(cfg, device=DEVICE).init(seed), seed)
    params = model.stacked_params()
    del model
    torch.cuda.empty_cache()
    return params


def llama_cache(cfg, batch: int, seq_len: int):
    """A zero contiguous cache on the card: ``DecoderLM.init_cache``'s
    tree (one ``{"k", "v"}`` a block of the unit, stacked over units)."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.models import DecoderLM
    meta = DecoderLM(cfg, device="meta").init_cache(batch, seq_len)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=DEVICE), meta)


def head_column_zeroed(prog):
    """A fault of the LM head's K1 (or K5) launch: its last block
    column's groups zeroed (the logits of the vocabulary's last 32 or 128
    entries)."""
    import torch
    head = prog.schedule.graph.nodes[-1]
    np_ = prog.schedule.placement.node_placements[head.idx]
    last = [r * np_.col_blocks + np_.col_blocks - 1
            for r in range(np_.row_blocks)]

    def fault(out):
        return out.index_fill(0, torch.tensor(last, device=out.device), 0.0)
    return fault


def llama_hold(seed: int, weight_dtype: str, arch: str = "llama3-8b",
               expand: bool = False, plan: tuple | None = None) -> dict:
    """``compile_arch(arch, "serve", weight_dtype=..., expand_scans=
    expand)`` at ``LLAMA_HOLD`` (published width, float32, 2 layers;
    ``plan``: the CPU's (products, K3 launches, K3 members) of a compiled
    step, which its launches must equal; llama3-8b folded: 1 product,
    ``LLAMA_K3`` waves of one member): the main path —
    every count set to 0 just before one compiled step and one executor
    run, read just after — with its launches logged; the compiled step
    against the executor and the plain step (``prog.verify``; int8: the
    plain step over the weights the grid stores,
    ``run_fake_quant_plain``) at ``LLAMA_TOL``; ``LLAMA_STEPS`` greedy
    steps with identical tokens; no host sync in a compiled step
    (``set_sync_debug_mode("error")``); and the control: the step with
    the LM head's last block column zeroed must fail the hold."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.launch import make_serve_step
    from repro_torch.mapper.executor import (full_float32, max_deviation,
                                             run_fake_quant_plain)
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=LLAMA_HOLD["n_layers"],
                              dtype="float32")
    b, s = LLAMA_HOLD["batch"], LLAMA_HOLD["seq_len"]
    mm = "k1" if weight_dtype == "fp32" else "k5"
    label = "pim_llama" if arch == "llama3-8b" else f"dense_variants {arch}"
    params = llama_params(cfg, seed)
    cache = llama_cache(cfg, b, s)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 70)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    pos0 = torch.tensor(0, dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    prog = mapper.compile_arch(arch, "serve", batch=b, seq_len=s,
                               weight_dtype=weight_dtype, config=cfg,
                               expand_scans=expand)
    compile_s = time.perf_counter() - t0
    n_mm, n_k3, n_calls = plan or (1, LLAMA_K3, LLAMA_K3)
    ex = mapper.ScheduleExecutor(prog.schedule)
    step = make_serve_step(cfg)

    def plain(params, cache, tok, pos):
        with torch.no_grad(), full_float32():
            if weight_dtype == "fp32":
                return step(params, cache, tok, pos)
            return run_fake_quant_plain(prog.schedule, params, cache, tok,
                                        pos)

    with full_float32():
        reset_counts()
        with recording_launches() as prog_log:
            out = prog(params, cache, tok, pos0)
        prog_counts = read_counts()
        with recording_launches() as ex_log:
            ex_out = ex.run(params, cache, tok, pos0)
        torch.cuda.synchronize()
        counts = read_counts()
        ex_counts = {k: counts[k] - prog_counts[k] for k in counts}
        blocks = prog.placed_blocks
        want = ({"k1": 0, "k2": 0, "k3": n_k3, "k5": 0, mm: n_mm},
                {"k1": 0, "k2": blocks, "k3": n_calls, "k5": 0})
        if (prog_counts, ex_counts) != want or (
                prog.matmul_launches, prog.eltwise_launches,
                prog.eltwise_calls) != (n_mm, n_k3, n_calls):
            raise AssertionError(f"{label} {weight_dtype}: launches "
                                 f"{prog_counts} compiled, {ex_counts} "
                                 f"per-block; want {want}")
        logits = out[0]
        if logits.shape != (b, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{label} {weight_dtype}: logits "
                                 f"{tuple(logits.shape)} not finite")
        vs_executor = max_deviation(out, ex_out, **LLAMA_TOL)
        executor_bit_equal = all(torch.equal(x, y) for x, y in zip(
            torch.utils._pytree.tree_leaves(out),
            torch.utils._pytree.tree_leaves(ex_out)))
        if plan and not executor_bit_equal:
            raise AssertionError(f"{label} {weight_dtype}: the compiled step "
                                 f"differs from the per-block executor's")
        if weight_dtype == "fp32":
            vs_plain = prog.verify(params, cache, tok, pos0, **LLAMA_TOL)
        else:
            vs_plain = max_deviation(out, plain(params, cache, tok, pos0),
                                     **LLAMA_TOL)
        del ex_out
        # greedy decode, compiled against plain, from the same start
        c_cache = p_cache = cache
        c_tok = p_tok = tok
        worst = 0.0
        tokens = []
        for i in range(LLAMA_STEPS):
            pos = torch.tensor(i, dtype=torch.int32, device=DEVICE)
            lc, c_cache = prog(params, c_cache, c_tok, pos)
            lp, p_cache = plain(params, p_cache, p_tok, pos)
            worst = max(worst, max_deviation(lc, lp, **LLAMA_TOL))
            c_tok = lc.argmax(-1).to(torch.int32)
            p_tok = lp.argmax(-1).to(torch.int32)
            if not torch.equal(c_tok, p_tok):
                raise AssertionError(f"{label} {weight_dtype}: step {i} "
                                     f"tokens differ")
            tokens.append(c_tok.tolist())
        cache_dev = max_deviation(c_cache, p_cache, **LLAMA_TOL)
        del c_cache, p_cache
        # no host sync inside a compiled step
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog(params, cache, tok, pos0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # the control: the LM head's last block column zeroed fails the hold
        # the head is the step's last product
        with recording_launches(fault=head_column_zeroed(prog),
                                index=n_mm - 1, key=mm):
            bad = prog(params, cache, tok, pos0)[0]
        try:
            max_deviation(bad, out[0], **LLAMA_TOL)
        except AssertionError:
            control = float((bad - out[0]).abs().max())
        else:
            raise AssertionError(f"{label} {weight_dtype}: the head's "
                                 f"last block column zeroed passes the hold")
    shapes = {mm: prog_log[mm], "k2": ex_log["k2"],
              "k3": prog_log["k3_forms"]}
    r = {"weight_dtype": weight_dtype, "launches": counts,
         "launches_per_step": {"compiled": prog_counts,
                               "per_block": ex_counts},
         "placed_blocks": blocks, "nodes": len(prog.schedule.graph.nodes),
         "subarrays": prog.schedule.placement.n_subarrays,
         "compile_s": compile_s,
         "max_abs_err_vs_executor": vs_executor,
         "compiled_bit_equal_executor": executor_bit_equal,
         "plain": ("decode_step" if weight_dtype == "fp32" else
                   "run_fake_quant_plain: the plain step over the stored "
                   "LM head"),
         "max_abs_err_vs_plain": vs_plain,
         "greedy_steps": LLAMA_STEPS, "greedy_max_abs_err": worst,
         "greedy_tokens_identical": True, "tokens_first_slot": [
             t[0] for t in tokens],
         "cache_max_abs_err": cache_dev, "host_syncs_in_step": 0,
         "control_head_column_zeroed_max_abs_err": control,
         f"{mm}_launch_shapes": prog_log[mm]}
    del params, cache, out, prog, ex, bad
    torch.cuda.empty_cache()
    return {"row": r, "shapes": shapes, "launches": counts}


def llama_time(seed: int) -> dict:
    """The published config as it is (bf16, 32 layers) at ``LLAMA_TIME``:
    one compiled step counted (K1 1, K3 ``LLAMA_K3``); ms per compiled and
    per plain step (wall, and device time under the profiler: kernels
    per step, busy share, time by kernel group); the LM head's K1 launch
    alone on its operands against its bound and ``mm`` of the unpadded
    operands (TF32 off); ``max_memory_allocated``."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.kernels.pim_mac import pim_matmul_grouped
    from repro_torch.launch import make_serve_step
    from repro_torch.mapper import lowering
    from repro_torch.mapper.executor import full_float32
    cfg = get_config("llama3-8b")
    b, s = LLAMA_TIME["batch"], LLAMA_TIME["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    params = llama_params(cfg, seed)
    cache = llama_cache(cfg, b, s)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 71)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    pos = torch.tensor(LLAMA_TIME["pos"], dtype=torch.int32, device=DEVICE)
    prog = mapper.compile_arch("llama3-8b", "serve", batch=b, seq_len=s)
    step = make_serve_step(cfg)
    with torch.no_grad(), full_float32():
        reset_counts()
        logits = prog(params, cache, tok, pos)[0]
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {"k1": 1, "k2": 0, "k3": LLAMA_K3, "k5": 0}:
            raise AssertionError(f"pim_llama time: launches {counts}")
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError("pim_llama time: logits not finite")
        want = step(params, cache, tok, pos)[0]
        agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
        del logits, want
        ms = wall_ms(lambda: prog(params, cache, tok, pos), iters=5,
                     warmup=1)
        plain_ms = wall_ms(lambda: step(params, cache, tok, pos), iters=5,
                           warmup=1)
        prof = profile_device(lambda: prog(params, cache, tok, pos), 3)
        plain_prof = profile_device(lambda: step(params, cache, tok, pos), 3)
        peak = torch.cuda.max_memory_allocated()
        # the LM head's K1 launch alone, on the operands the step builds
        head = prog.schedule.graph.nodes[-1]
        x = torch.randn((b, cfg.d_model), generator=gen, device=DEVICE)
        w = params["lm_head"]["w"]
        a_g, b_g, meta = lowering._grouped_operands(prog.ctx, head.idx, x, w)
        cg = meta[1]
        t_bytes, t_ops = pim_bound(4 * (a_g.numel() + b_g.numel()
                                        + b_g.shape[0] * a_g.shape[1]
                                        * b_g.shape[2]),
                                   2 * b_g.shape[0] * a_g.shape[1]
                                   * a_g.shape[2] * b_g.shape[2])
        w32 = w.float()
        u_bytes, u_ops = pim_bound(4 * (x.numel() + w32.numel()
                                        + b * cfg.vocab_size),
                                   2 * b * cfg.d_model * cfg.vocab_size)
        head_k1 = {
            "G": b_g.shape[0], "col_groups": cg, "M": a_g.shape[1],
            "K": a_g.shape[2], "N": b_g.shape[2],
            "ms": cuda_ms(lambda: pim_matmul_grouped(a_g, b_g,
                                                     col_groups=cg),
                          iters=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "operands_build_ms": cuda_ms(lambda: lowering._grouped_operands(
                prog.ctx, head.idx, x, w), iters=5, warmup=1),
            "library_ms": cuda_ms(lambda: torch.mm(x, w32), iters=5,
                                  warmup=1),
            "library": "torch.mm of the unpadded f32 operands (TF32 off)",
            "unpadded_bound_ms": max(u_bytes, u_ops)}
        del a_g, b_g, w32
    r = {"config": "llama3-8b published (configs/llama3_8b.py), bf16, 32 "
                   "layers, not cut", **LLAMA_TIME,
         "launches_per_step": counts,
         "greedy_token_agreement_vs_plain_bf16": agree,
         "ms_per_step": ms, "plain_ms_per_step": plain_ms,
         "profile": prof, "plain_profile": plain_prof,
         # the LM head's padded operands, built alone, against the step
         "head_padding_share_of_device_time": (
             head_k1["operands_build_ms"] / prof["device_ms_per_call"]),
         "max_memory_allocated_gb": peak / 1e9, "head_k1": head_k1}
    if peak >= 80e9:
        raise AssertionError(f"pim_llama time: {peak / 1e9} GB allocated")
    del params, cache, prog
    torch.cuda.empty_cache()
    return r


def phase_pim_llama(seed: int) -> dict:
    """llama3-8b's decode step through the mapper (``compile_arch(...,
    "serve")``): ``llama_hold`` on the fp32 grid (K1 on the LM head) and
    the int8 grid (K5), then ``llama_time`` on the published config.
    Emitted as one ``pim_llama`` line."""
    fp32 = llama_hold(seed, "fp32")
    int8 = llama_hold(seed, "int8")
    timing = llama_time(seed)
    emit({"phase": "pim_llama",
          "config": "llama3-8b at its published width (configs/"
                    "llama3_8b.py), float32, cut to "
                    f"{LLAMA_HOLD['n_layers']} layers",
          **{k: LLAMA_HOLD[k] for k in ("batch", "seq_len")},
          "reduced": {"n_layers": [32, LLAMA_HOLD["n_layers"]],
                      "dtype": ["bfloat16", "float32"]},
          "tol": LLAMA_TOL, "fp32": fp32["row"], "int8": int8["row"],
          "time": timing})
    return {"fp32": fp32, "int8": int8, "time": timing}


# ---------------------------------------------------------------------------
# 19. pim_llama_train: llama3-8b's train step through the mapper
# ---------------------------------------------------------------------------

# the hold: llama3-8b at its published width, float32, cut to 2 layers
LLAMA_TRAIN_HOLD = dict(batch=1, seq_len=128, n_layers=2)
LLAMA_TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)   # the mapper's verify tol
# K3 launches of one compiled and one per-block step at the hold (the
# plan tests/test_torch_arch_train.py counts on the CPU): the 148
# add/sub/mul nodes outside the folded loops, in 84 waves; every product
# lies in a loop and runs natively, so K1, K2 and K5 launch nothing
LLAMA_TRAIN_K3 = {"compiled": 84, "per_block": 148}
LLAMA_TRAIN_STEPS = 3      # Trainer(backend="pim") against "jit"
LLAMA_TRAIN_LR = 3e-4      # make_train_step's default
# the timed run: the published dtype (bf16), cut to 2 layers (AdamW's
# state for 32 does not fit one card; 4 take ~10 s more of the script's
# shared time), the longest sequence the reference trains on full
# attention
LLAMA_TRAIN_TIME = dict(batch=1, seq_len=2048, n_layers=2)
# a K3 wave of more elements than this is timed by fewer calls
K3_BIG_WAVE = 1 << 26


def llama_train_state(cfg, seed: int):
    """(params, opt_state) on the card: the seeded parameters
    (``llama_params``) and a seeded AdamW state in the reference's tree,
    m ~ 1e-3 N(0, 1), v the square of another such draw, step 5."""
    import torch
    from repro_torch._tree import tree_map
    params = llama_params(cfg, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 80)

    def draw(p):
        return 1e-3 * torch.randn(p.shape, generator=gen, device=DEVICE)

    opt = {"m": tree_map(draw, params),
           "v": tree_map(lambda p: draw(p).square_(), params),
           "step": torch.tensor(5, dtype=torch.int32, device=DEVICE)}
    return params, opt


def token_batch(cfg, batch: int, seq_len: int, seed: int, step: int = 0):
    """``TokenStream(seed=seed).batch(step)`` on the card."""
    import torch
    from repro_torch.data import TokenStream
    stream = TokenStream(cfg.vocab_size, seq_len, batch, seed=seed)
    return {k: torch.as_tensor(v, device=DEVICE)
            for k, v in stream.batch(step).items()}


def host_copy(tree):
    """A pytree's tensors copied to host memory (the card holds one run's
    outputs at a time at full width)."""
    import torch
    return torch.utils._pytree.tree_map(lambda t: t.cpu(), tree)


def compared_leafwise(host, tree, check) -> dict:
    """``check(path, host leaf, leaf)`` over the leaves of two step outputs
    ``(params, opt_state, loss)``, the first held in host memory, each of
    its leaves brought back to the card one at a time; the largest
    difference of each group (loss, params, m, v)."""
    from repro_torch._tree import leaves_with_path
    worst = dict.fromkeys(("loss", "params", "m", "v", "step"), 0.0)
    leaves = dict(leaves_with_path(tree))
    for path, h in leaves_with_path(host):
        d = leaves[path]
        h = h.to(d.device)
        check(path, h, d)
        group = ("loss" if path == "2" else "params" if path[0] == "0"
                 else path.split("/")[1])
        if h.numel():
            worst[group] = max(worst[group], float(
                (h.double() - d.double()).abs().max()))
    return worst


def ulp_up(out):
    """A fault of one K3 launch: each output's first element moved one
    ulp up."""
    import torch
    bad = out.clone()
    flat = bad.view(-1)
    flat[0] = torch.nextafter(flat[0], torch.tensor(float("inf"),
                                                    device=out.device))
    return bad


@contextlib.contextmanager
def holding_waves(label):
    """Hold every K3 wave the mapper's lowering launches while open
    against its plain version, member by member (one plain output alive
    at a time: a member of llama3-8b's step holds up to 525 M elements),
    bit for bit, NaN as NaN; log each wave's members and elements. The
    launches go and count as always."""
    from repro_torch.kernels import ref
    from repro_torch.mapper import lowering
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    orig = lowering.mac_wave
    log = []

    def held(members, *args):
        outs = orig(members, *args)
        for i, (o, m) in enumerate(zip(outs, pm._normalized(members,
                                                             "pim_mac"),
                                       strict=True)):
            (want,) = ref.pim_mac_wave_ref([m])
            if not same_bits(o, want):
                raise AssertionError(f"{label}: wave {len(log)} member {i} "
                                     f"{tuple(m[0])} not bit-equal to the "
                                     f"plain version")
            del want
        log.append({"members": len(members),
                    "n": wave_elements(members)})
        return outs

    lowering.mac_wave = held
    try:
        yield log
    finally:
        lowering.mac_wave = orig


@contextlib.contextmanager
def timing_waves():
    """Time every K3 wave the mapper's lowering launches while open, on
    the step's own operands: the launch by events over calls made back
    to back (``ms``) and from a CUDA graph (``device_graph_ms``), its
    plain version, and the library calls computing each member's function
    (``k3_library``: ``add`` / ``sub`` / ``mul``) by events and by graph,
    beside its bound (each operand read once where it lies, each output
    written once). A wave above ``K3_BIG_WAVE`` elements is timed by 2
    calls (1 in a graph); the step's own launch goes and counts as
    always."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.mapper import lowering
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    orig = lowering.mac_wave
    rows = []

    def timed(members, *args):
        outs = orig(members, *args)
        plain = pm._normalized(members, "pim_mac")
        libs = [k3_library(m) for m in plain]
        n = wave_elements(members)
        big = n > K3_BIG_WAVE
        iters, calls = (2, 1) if big else (20, GRAPH_CALLS)
        operands = {(x.data_ptr(), tuple(x.shape), x.stride()): x.numel()
                    for m in members for x in m[1:4]
                    if isinstance(x, torch.Tensor) and x.is_cuda}

        def kernel():
            return orig(members, *args)

        def library():
            return [call() for _, call in libs]

        rows.append({
            "wave": len(rows), "members": len(members), "n": n,
            "count": 1, "max_err": 0.0,
            **pim_timing(kernel, lambda: ref.pim_mac_wave_ref(plain),
                         library, 4 * (n + sum(operands.values())), 2 * n,
                         iters),
            "library": sorted({name for name, _ in libs}),
            "device_graph_ms": graph_ms([kernel] * calls),
            "library_graph_ms": graph_ms([library] * calls)})
        torch.cuda.empty_cache()
        return outs

    lowering.mac_wave = timed
    try:
        yield rows
    finally:
        lowering.mac_wave = orig


def llama_train_hold(seed: int) -> dict:
    """``train_hold`` at ``LLAMA_TRAIN_HOLD`` (published width, float32,
    2 layers, batch 1, seq 128) at the CPU's counts ``LLAMA_TRAIN_K3``."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LLAMA_TRAIN_HOLD["n_layers"],
                              dtype="float32")
    return train_hold(seed, cfg, LLAMA_TRAIN_HOLD["batch"],
                      LLAMA_TRAIN_HOLD["seq_len"], LLAMA_TRAIN_K3,
                      "pim_llama_train hold")


@contextlib.contextmanager
def recording_sorts(k: int):
    """While open, every aten ``sort`` (the router's top-k: ``models.moe.
    top_k`` is a stable descending sort, then a slice) in the order a step
    makes them, eager or replayed from a compiled program: its first
    ``k + 1`` values and first ``k`` indices, copies on the card (no host
    read). ``k`` 0: nothing recorded, no mode entered."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    calls = []
    if not k:
        yield calls
        return

    class Sorts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket is torch.ops.aten.sort:
                calls.append((out[0][..., :k + 1].clone(),
                              out[1][..., :k].clone()))
            return out

    with Sorts():
        yield calls


def same_routes(got: list, want: list, cfg, label: str) -> dict:
    """The router's choices of two runs of one step (``recording_sorts``)
    the same: each call's expert indices, hence the keep mask, a function
    of them alone; with the smallest top-k margin (the k-th probability
    less the next, over every token of every call), so that a failure at
    a near-tie can be told from a fault."""
    import torch
    if len(got) != len(want) or not got:
        raise AssertionError(f"{label}: {len(got)} router sorts in the "
                             f"compiled step, {len(want)} in the plain one")
    k = cfg.top_k
    margins = [(v[..., k - 1] - v[..., k]).min() for v, _ in want]
    margin = float(torch.stack(margins).min())
    differing = sum(int((a != b).any(-1).sum())
                    for (_, a), (_, b) in zip(got, want))
    if differing:
        raise AssertionError(f"{label}: {differing} tokens routed "
                             f"differently by the compiled and the plain "
                             f"step (smallest top-k margin {margin})")
    return {"router_sorts": len(got), "tokens_routed_alike": sum(
        int(idx.numel() // k) for _, idx in got),
        "smallest_top_k_margin": margin}


def train_hold(seed: int, cfg, b: int, s: int, k3: dict, label: str,
               hold_waves: bool = True, on_host: bool = True,
               arch: str = "llama3-8b", batch: dict | None = None,
               check=None, rerun: bool = False,
               log_shapes: bool = False) -> dict:
    """``compile_arch(arch, "train", config=cfg)`` at batch ``b``,
    seq ``s`` on seeded parameters and AdamW state and one
    ``TokenStream`` batch. The main path — every count set to 0 just
    before one compiled step and one executor step, read just after —
    must launch K3 alone, at the CPU's counts ``k3`` (``"compiled"`` and
    ``"per_block"``). One run on the card at a time, its outputs moved
    to host memory: the compiled step bit-equal to the per-block
    executor's; within ``LLAMA_TRAIN_TOL`` of the plain step (loss, and
    every leaf of params, m and v; TF32 off); no host sync in a compiled
    step (``set_sync_debug_mode("error")``); the control — the step's
    last K3 wave (the last leaf's ``p - lr·upd``) one ulp off in one
    element of each output — must break the bit equality; and every K3
    wave of a step held against its plain version member by member
    (``holding_waves``; ``hold_waves=False`` leaves that to
    ``pim_llama_train``, whose AdamW waves are the same).
    ``on_host=False`` keeps the first run's outputs on the card, where
    they fit beside the others (moving 17.8 GB to pageable host memory
    and back takes ~10 s a pass). ``batch``: the step's batch where it
    is not a ``TokenStream`` one (``io_batch``); ``check(params,
    opt_state, outputs)``, where given, holds more of the compiled step's
    outputs and returns a dict the row takes. ``rerun``: the step run
    without host syncs must equal the first run bit for bit (an MoE
    step's gathers' transposes sum in a fixed order). With experts, the
    router's choices (``recording_sorts``) of the compiled and the plain
    step must be the same (``same_routes``). ``log_shapes``: the row
    keeps the compiled step's launch shapes under ``shapes``
    (``recording_launches``' log). ``max_memory_allocated`` over the
    hold."""
    import torch
    from repro_torch import mapper
    from repro_torch.launch import make_train_step
    from repro_torch.mapper.executor import full_float32
    torch.cuda.reset_peak_memory_stats()
    params, opt = llama_train_state(cfg, seed)
    if batch is None:
        batch = token_batch(cfg, b, s, seed)
    t0 = time.perf_counter()
    prog = mapper.compile_arch(arch, "train", batch=b, seq_len=s,
                               config=cfg)
    compile_s = time.perf_counter() - t0
    ex = mapper.ScheduleExecutor(prog.schedule)
    step = make_train_step(cfg)
    seconds, peaks = {}, {}

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()

    with full_float32():
        reset_counts()
        with recording_sorts(cfg.top_k if cfg.n_experts else 0) as sorts, \
                recording_launches() as log:
            out = prog(params, opt, batch)
        torch.cuda.synchronize()
        prog_counts = read_counts()
        loss = float(out[2])
        if not all(bool(torch.isfinite(x).all())
                   for x in torch.utils._pytree.tree_leaves(out)[:-1]):
            raise AssertionError(f"{label}: a leaf is not finite")
        lap("compiled_step")
        got = host_copy(out) if on_host else out
        del out
        lap("host_copy")
        ex_out = ex.run(params, opt, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        ex_counts = {k: counts[k] - prog_counts[k] for k in counts}
        want = ({"k1": 0, "k2": 0, "k3": k3["compiled"], "k5": 0},
                {"k1": 0, "k2": 0, "k3": k3["per_block"], "k5": 0})
        if (prog_counts, ex_counts) != want or (
                prog.eltwise_launches, prog.matmul_launches,
                ex.eltwise_launches) != (k3["compiled"], 0,
                                         k3["per_block"]):
            raise AssertionError(f"{label}: launches {prog_counts} "
                                 f"compiled, {ex_counts} per-block; want "
                                 f"{want}")

        def bit_equal(path, h, d):
            if not torch.equal(h, d):
                raise AssertionError(f"{label}: {path} differs from the "
                                     f"per-block executor's")

        lap("executor_step")
        compared_leafwise(got, ex_out, bit_equal)
        del ex_out
        lap("compared_executor")

        def close(path, h, d):
            torch.testing.assert_close(h, d, **LLAMA_TRAIN_TOL,
                                       msg=lambda m: f"{label} {path}: {m}")

        with recording_sorts(cfg.top_k if cfg.n_experts else 0) as \
                plain_sorts:
            plain = step(params, opt, batch)
        lap("plain_step")
        vs_plain = compared_leafwise(got, plain, close)
        del plain
        lap("compared_plain")
        checked = check(params, opt, got) if check else {}
        if cfg.n_experts:
            checked["routes"] = same_routes(sorts, plain_sorts, cfg, label)
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = prog(params, opt, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if rerun:
            def rerun_equal(path, h, d):
                if not torch.equal(h, d):
                    raise AssertionError(f"{label}: {path} of a second "
                                         f"compiled step differs from the "
                                         f"first's")

            compared_leafwise(got, again, rerun_equal)
            checked["rerun_bit_equal"] = True
            lap("compared_rerun")
        del again
        # the control: the last wave one ulp off
        with recording_helpers(fault=ulp_up, key="k3",
                               index=k3["compiled"] - 1):
            bad = prog(params, opt, batch)
        differing = {}

        def count(path, h, d):
            if not torch.equal(h, d):
                differing[path] = int((h != d).sum())

        lap("no_sync_and_control_steps")
        compared_leafwise(got, bad, count)
        del bad
        lap("compared_control")
        if not differing:
            raise AssertionError(f"{label}: the last K3 wave one ulp off "
                                 f"passes the bit-for-bit hold")
        waves = []
        if hold_waves:
            with holding_waves(label) as waves:
                again = prog(params, opt, batch)
            del again
            lap("waves_held")
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"{label}: {peak / 1e9} GB allocated")
    largest = max(waves, key=lambda w: w["n"], default=None)
    r = {"launches": counts,
         "launches_per_step": {"compiled": prog_counts,
                               "per_block": ex_counts},
         "nodes": len(prog.schedule.graph.nodes),
         "aten_ops": len(prog.schedule.graph.gm.graph.nodes),
         "subarrays": prog.schedule.placement.n_subarrays,
         "parameters": sum(x.numel() for x in
                           torch.utils._pytree.tree_leaves(params)),
         "compile_s": compile_s, "seconds": seconds, "loss": loss,
         "compiled_bit_equal_executor": True,
         "max_abs_err_vs_plain": vs_plain, "host_syncs_in_step": 0,
         "control_last_wave_one_ulp_elements_differing": differing,
         "k3_waves_held_bit_equal": len(waves),
         "k3_largest_wave": largest,
         "k3_largest_member": max(int(np.prod(f[0], dtype=np.int64))
                                  for form in log["k3_forms"]
                                  for f in form),
         "max_memory_allocated_gb": peak / 1e9,
         "max_memory_allocated_gb_by_lap": peaks, **checked}
    if log_shapes:
        r["shapes"] = {"k1": log["k1"], "k2": log["k2"],
                       "k3": log["k3_forms"], "k5": log["k5"]}
    del params, opt, got, prog, ex
    torch.cuda.empty_cache()
    return r


def llama_train_trainer(seed: int) -> dict:
    """``Trainer(backend="pim")`` against ``Trainer(backend="jit")`` at the
    hold's cut, ``LLAMA_TRAIN_STEPS`` steps of ``TokenStream`` batches
    from the same seeded parameters (AdamW from zeros), one after the
    other: losses within ``LLAMA_TRAIN_TOL``. Each writes its final
    checkpoint (params, m and v) into a temporary directory removed after
    it; its time is the run's less its steps'."""
    import shutil
    import tempfile
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import make_train_step
    from repro_torch.mapper.executor import full_float32
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LLAMA_TRAIN_HOLD["n_layers"],
                              dtype="float32")
    b, s = LLAMA_TRAIN_HOLD["batch"], LLAMA_TRAIN_HOLD["seq_len"]
    stream = TokenStream(cfg.vocab_size, s, b, seed=seed)
    opt = make_optimizer("adamw", lr=LLAMA_TRAIN_LR)

    def init_state():
        p = llama_params(cfg, seed)
        return p, opt.init(p)

    runs = {}
    for backend in ("pim", "jit"):
        d = tempfile.mkdtemp(prefix="llama_train_ckpt_")
        try:
            obs.metrics().reset()
            tc = TrainerConfig(total_steps=LLAMA_TRAIN_STEPS,
                               ckpt_every=LLAMA_TRAIN_STEPS + 1, ckpt_dir=d,
                               keep=1, async_ckpt=False)
            with full_float32():
                t0 = time.perf_counter()
                tr = Trainer(tc, train_step=make_train_step(
                                 cfg, lr=LLAMA_TRAIN_LR),
                             init_state=init_state, batch_fn=stream.batch,
                             backend=backend, device=DEVICE)
                build_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = tr.run()
                run_s = time.perf_counter() - t0
            walls = step_wall_s()
            ckpt_bytes = sum(f.stat().st_size
                             for f in pathlib.Path(d).iterdir())
            runs[backend] = {
                "losses": out["losses"], "build_s": build_s,
                "run_s": run_s, "step_wall_s": walls,
                "checkpoint_s": run_s - walls["count"] * walls["mean"],
                "checkpoint_gb": ckpt_bytes / 1e9}
            del tr, out
        finally:
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    np.testing.assert_allclose(runs["pim"]["losses"], runs["jit"]["losses"],
                               **LLAMA_TRAIN_TOL)
    return {"steps": LLAMA_TRAIN_STEPS, "lr": LLAMA_TRAIN_LR, **runs,
            "max_loss_diff": float(np.abs(
                np.subtract(runs["pim"]["losses"],
                            runs["jit"]["losses"])).max())}


def llama_train_time(seed: int) -> dict:
    """llama3-8b at its published dtype (bf16) cut to
    ``LLAMA_TRAIN_TIME``'s 2 layers, batch 1, seq 2048, on seeded
    parameters and AdamW state: one warm compiled step counted (K3 at the
    plan's waves, no K1, K2 or K5; the loss finite and against the plain
    step's), then ms per compiled and plain step (wall, 3 steps after one
    warm), device time, kernels a step and the busy share under the
    profiler, ``max_memory_allocated``; then one more compiled step with
    every K3 wave timed on its own operands (``timing_waves``) against
    its library calls and its byte bound."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LLAMA_TRAIN_TIME["n_layers"])
    b, s = LLAMA_TRAIN_TIME["batch"], LLAMA_TRAIN_TIME["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    params, opt = llama_train_state(cfg, seed)
    batch = token_batch(cfg, b, s, seed)
    prog = mapper.compile_arch("llama3-8b", "train", batch=b, seq_len=s,
                               config=cfg)
    waves = sum(st.kind == "placed" for st in prog.ctx.steps)
    step = make_train_step(cfg)
    reset_counts()
    out = prog(params, opt, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != {"k1": 0, "k2": 0, "k3": waves, "k5": 0}:
        raise AssertionError(f"pim_llama_train time: launches {counts}, "
                             f"want {waves} K3")
    loss = float(out[2])
    del out
    plain_loss = float(step(params, opt, batch)[2])
    if not np.isfinite(loss):
        raise AssertionError("pim_llama_train time: loss not finite")
    # both warm: the counted step and the plain loss's
    ms = wall_ms(lambda: prog(params, opt, batch), iters=2, warmup=0)
    prof = profile_device(lambda: prog(params, opt, batch), 1, warm=False)
    plain_ms = wall_ms(lambda: step(params, opt, batch), iters=2, warmup=0)
    plain_prof = profile_device(lambda: step(params, opt, batch), 1,
                                warm=False)
    peak = torch.cuda.max_memory_allocated()
    with timing_waves() as rows:
        prog(params, opt, batch)
    torch.cuda.synchronize()
    if len(rows) != waves:
        raise AssertionError(f"pim_llama_train time: {len(rows)} waves "
                             f"timed, the plan has {waves}")
    r = {"config": "llama3-8b at its published width (configs/"
                   "llama3_8b.py), bf16, cut to "
                   f"{LLAMA_TRAIN_TIME['n_layers']} layers",
         **LLAMA_TRAIN_TIME,
         "reduced": {"n_layers": [32, LLAMA_TRAIN_TIME["n_layers"]]},
         "parameters": sum(x.numel() for x in
                           torch.utils._pytree.tree_leaves(params)),
         "launches_per_step": counts, "loss": loss,
         "plain_loss": plain_loss, "loss_abs_diff": abs(loss - plain_loss),
         "ms_per_step": ms, "plain_ms_per_step": plain_ms,
         "profile": prof, "plain_profile": plain_prof,
         "max_memory_allocated_gb": peak / 1e9,
         "k3_per_step": {**sums(rows),
                         "waves": len(rows),
                         "elements": sum(w["n"] for w in rows),
                         "largest_wave": max(rows, key=lambda w: w["n"])}}
    if peak >= 80e9:
        raise AssertionError(f"pim_llama_train time: {peak / 1e9} GB "
                             f"allocated")
    del params, opt, prog
    torch.cuda.empty_cache()
    return {"row": r, "k3_rows": rows}


def phase_pim_llama_train(seed: int) -> dict:
    """llama3-8b's train step through the mapper (``compile_arch(...,
    "train")``, ``Trainer(backend="pim")``): ``llama_train_hold``,
    ``llama_train_trainer`` and ``llama_train_time``. Emitted as one
    ``pim_llama_train`` line."""
    t0 = time.perf_counter()
    hold = llama_train_hold(seed)
    t1 = time.perf_counter()
    trainer = llama_train_trainer(seed)
    t2 = time.perf_counter()
    timing = llama_train_time(seed)
    seconds = {"hold": t1 - t0, "trainer": t2 - t1,
               "time": time.perf_counter() - t2}
    emit({"phase": "pim_llama_train", "seconds": seconds,
          "config": "llama3-8b at its published width (configs/"
                    "llama3_8b.py), float32, cut to "
                    f"{LLAMA_TRAIN_HOLD['n_layers']} layers",
          **{k: LLAMA_TRAIN_HOLD[k] for k in ("batch", "seq_len")},
          "reduced": {"n_layers": [32, LLAMA_TRAIN_HOLD["n_layers"]],
                      "dtype": ["bfloat16", "float32"]},
          "tol": LLAMA_TRAIN_TOL, "hold": hold, "trainer": trainer,
          "time": timing["row"]})
    return {"launches": hold["launches"], "k3_rows": timing["k3_rows"],
            "time": timing["row"]}


# ---------------------------------------------------------------------------
# 20. pim_llama_pipe: llama3-8b's decode step cut into pipeline stages
# ---------------------------------------------------------------------------

PIPE_PARTITIONS = 4
PIPE_MICRO = 8             # GPipe microbatches
PIPE_STREAMS = 4           # the asynchronous driver's ring of streams
LLAMA_PIPE_POS = 5         # the hold's position: the caches' rows 0..5 read
# the timed run: the published config (bf16) cut to 16 of its 32 layers
# (the script's time is shared by every phase: 32 take ~20 s more)
LLAMA_PIPE_TIME = dict(batch=8, seq_len=2048, pos=1024, n_layers=16)


def leaves_equal(a, b) -> bool:
    """Two pytrees (or lists) of tensors bit for bit."""
    import torch
    la, lb = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def stage_launches(prog) -> list:
    """Each stage's launches in its last call: (K1 or K5, K3)."""
    return [[st.matmul_launches, st.eltwise_launches] for st in prog.stages]


def stage_vjps(prog, flat, n_wanted: int) -> list:
    """Each stage's backward launches for one microbatch (``flat``),
    derived from the autograd graph of its forward (``backward_nodes``,
    ``asked``) run as ``gpipe_value_and_grad`` runs it: on detached inputs
    that require grad where they are floating and cross a cut or are one
    of the first ``n_wanted`` arguments."""
    import torch
    from repro_torch.parallel.pipeline import _resolve
    outs, want = [], []
    for st in prog.stages:
        ins = [x.detach().requires_grad_(True)
               if isinstance(x, torch.Tensor) and x.is_floating_point()
               and (r[0] == "stage" or r[1] < n_wanted) else x
               for r, x in ((r, _resolve(r, flat, outs))
                            for r in st.in_refs)]
        with torch.enable_grad():
            outs.append(st.fn(*ins))
        want.append(asked(backward_nodes(*(
            y for y in outs[-1] if isinstance(y, torch.Tensor)
            and y.grad_fn is not None))))
    return want


def swapped_boundary(prog, mbs, m_a: int, m_b: int):
    """Microbatch ``m_a``'s outputs with one boundary value swapped: the
    first stage that reads an earlier stage's value reads microbatch
    ``m_b``'s instead (a control: the hold must see it)."""
    from repro_torch.parallel.pipeline import _resolve
    outs = {m_a: [], m_b: []}
    swapped = False
    for st in prog.stages:
        for m in (m_b, m_a):
            ins = [_resolve(r, mbs[m], outs[m]) for r in st.in_refs]
            if m == m_a and not swapped:
                for j, r in enumerate(st.in_refs):
                    if r[0] == "stage":
                        ins[j] = _resolve(r, mbs[m_b], outs[m_b])
                        swapped = True
                        break
            outs[m].append(st.fn(*ins))
    if not swapped:
        raise AssertionError("swapped_boundary: no stage reads another")
    return [_resolve(r, mbs[m_a], outs[m_a]) for r in prog.out_refs]


def llama_pipe_hold(seed: int, weight_dtype: str) -> dict:
    """``compile_arch("llama3-8b", "serve", partitions=4,
    expand_scans=True)`` at ``LLAMA_HOLD`` (published width, float32, 2
    layers): the expansion unrolls the stack (one chunk a layer), so the
    layers' products run on K1 (K5) and their MACs on K3 inside the
    stages. The main path — every count set to 0 just before it and read
    just after — is one partitioned step and ``run_partitioned`` over
    ``PIPE_MICRO`` microbatches (each its own tokens and random cache).
    Held: the partitioned step bit for bit the unpartitioned compiled
    program of the same schedule and the per-block executor, within
    ``LLAMA_TOL`` of the plain step; its stages' launches summing to the
    unpartitioned program's; ``run_partitioned`` and
    ``run_partitioned_async`` (``PIPE_STREAMS`` streams) bit for bit the
    microbatches' sequential calls, and ``run_async`` the step; no host
    sync in a partitioned step, ``run_async`` or an asynchronous grid; and the control — one boundary value swapped
    between two microbatches — failing the hold. The partitioned step's
    launch shapes are logged (``recording_launches``) for
    ``phase_kernels_pim`` / ``phase_kernels_pim_q``."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.launch import make_serve_step
    from repro_torch.mapper.executor import (full_float32, max_deviation,
                                             run_fake_quant_plain)
    from repro_torch.parallel import pipeline as pipe
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LLAMA_HOLD["n_layers"],
                              dtype="float32")
    b, s = LLAMA_HOLD["batch"], LLAMA_HOLD["seq_len"]
    params = llama_params(cfg, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 80)
    toks = [torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
            for _ in range(PIPE_MICRO)]
    caches = []
    for _ in range(PIPE_MICRO):
        c = llama_cache(cfg, b, s)
        for t in c["layers"]["block0"].values():
            t.normal_(generator=gen)
        caches.append(c)
    pos = torch.tensor(LLAMA_PIPE_POS, dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    prog = mapper.compile_arch("llama3-8b", "serve", batch=b, seq_len=s,
                               weight_dtype=weight_dtype, config=cfg,
                               partitions=PIPE_PARTITIONS, expand_scans=True)
    compile_s = time.perf_counter() - t0
    sched = prog.schedule
    if sched.graph.groups != {"layers": 1}:
        raise AssertionError(f"pim_llama_pipe: expansion "
                             f"{sched.graph.groups}, want a full unroll")
    base = mapper.compile_schedule(sched, use_cache=False)
    ex = mapper.ScheduleExecutor(sched)
    ring = [torch.cuda.Stream() for _ in range(PIPE_STREAMS)]
    aprog = mapper.compile_partitioned(sched, use_cache=False,
                                       streams=ring)
    mbs = [prog.flatten_args(params, caches[m], toks[m], pos)
           for m in range(PIPE_MICRO)]
    args0 = (params, caches[0], toks[0], pos)
    step = make_serve_step(cfg)
    with torch.no_grad(), full_float32():
        reset_counts()
        with recording_launches() as log:
            out = prog(*args0)
        step_counts = read_counts()
        per_stage = stage_launches(prog)
        pipe_outs = pipe.run_partitioned(prog.stages, prog.out_refs, mbs)
        torch.cuda.synchronize()
        counts = read_counts()
        reset_counts()
        base_out = base(*args0)
        torch.cuda.synchronize()
        base_counts = read_counts()
        if step_counts != base_counts or [
                sum(col) for col in zip(*per_stage)] != [
                base.matmul_launches, base.eltwise_launches]:
            raise AssertionError(
                f"pim_llama_pipe {weight_dtype}: launches {step_counts} "
                f"(stages {per_stage}) vs unpartitioned {base_counts}")
        if {k: v for k, v in counts.items()} != {
                k: v * (1 + PIPE_MICRO) for k, v in step_counts.items()}:
            raise AssertionError(f"pim_llama_pipe {weight_dtype}: the "
                                 f"grid launched {counts}")
        if not leaves_equal(out, base_out):
            raise AssertionError(f"pim_llama_pipe {weight_dtype}: "
                                 f"partitioned != unpartitioned")
        ex_out = ex.run(*args0)
        if not leaves_equal(out, ex_out):
            raise AssertionError(f"pim_llama_pipe {weight_dtype}: "
                                 f"partitioned != per-block executor")
        del ex_out
        if weight_dtype == "fp32":
            want = step(*args0)
        else:
            want = run_fake_quant_plain(sched, *args0)
        vs_plain = max_deviation(out, want, **LLAMA_TOL)
        del want
        seq = [base(params, caches[m], toks[m], pos)
               for m in range(PIPE_MICRO)]
        grid_equal = all(leaves_equal(o, q) for o, q in zip(
            pipe_outs, seq))
        asy = pipe.run_partitioned_async(aprog.stages, aprog.out_refs, mbs)
        one_async = aprog.run_async(*args0)
        torch.cuda.synchronize()
        async_equal = all(leaves_equal(o, q) for o, q in zip(asy, pipe_outs))
        if not (grid_equal and async_equal and leaves_equal(one_async, out)):
            raise AssertionError(f"pim_llama_pipe {weight_dtype}: grid == "
                                 f"sequential {grid_equal}, async == grid "
                                 f"{async_equal}, run_async == the step "
                                 f"{leaves_equal(one_async, out)}")
        del one_async
        del asy, pipe_outs
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog(*args0)
            aprog.run_async(*args0)
            pipe.run_partitioned_async(aprog.stages, aprog.out_refs, mbs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        bad = swapped_boundary(prog, mbs, 0, 1)
        want0 = torch.utils._pytree.tree_leaves(seq[0])
        if leaves_equal(bad, want0):
            raise AssertionError(f"pim_llama_pipe {weight_dtype}: a "
                                 f"boundary value swapped passes the hold")
        control = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(bad, want0))
    r = {"weight_dtype": weight_dtype,
         "expansion": sched.graph.groups,
         "partitions": [{"nodes": len(p.nodes), "units":
                         [p.unit_start, p.unit_end], "out_bits": p.out_bits}
                        for p in prog.partitions],
         "stage_in_out": [[len(st.in_refs), st.n_outs]
                          for st in prog.stages],
         "subarrays": sched.placement.n_subarrays,
         "nodes": len(sched.graph.nodes), "compile_s": compile_s,
         "launches_per_step": step_counts,
         "launches_by_stage": per_stage,
         "partitioned_bit_equal_unpartitioned": True,
         "partitioned_bit_equal_executor": True,
         "max_abs_err_vs_plain": vs_plain,
         "plain": ("decode_step" if weight_dtype == "fp32" else
                   "run_fake_quant_plain"),
         "microbatches": PIPE_MICRO, "grid_bit_equal_sequential": True,
         "async_streams": PIPE_STREAMS, "async_bit_equal_grid": True,
         "run_async_bit_equal_step": True,
         "host_syncs": 0,
         "control_boundary_swapped_max_abs_err": control,
         "modeled": dataclasses.asdict(sched.pipeline(PIPE_MICRO))}
    del params, caches, mbs, prog, aprog, base, ex, seq, out, base_out, bad
    torch.cuda.empty_cache()
    return {"row": r, "launches": counts,
            "shapes": {"k1": log["k1"], "k2": [], "k3": log["k3_forms"],
                       "k5": log["k5"]}}


def llama_pipe_time(seed: int) -> dict:
    """The published config (bf16) cut to ``LLAMA_PIPE_TIME``'s layers at
    ``LLAMA_PIPE_TIME`` with ``PIPE_MICRO`` microbatches (each its own
    tokens and cache), ``partitions=4, expand_scans=True``: the expansion
    (chunks of the stack, each a folded loop), the cut, ms of
    ``PIPE_MICRO`` sequential compiled steps, of ``run_partitioned`` and
    of ``run_partitioned_async`` on ``PIPE_STREAMS`` streams (wall, and
    device time under the profiler: kernels per microbatch, busy share),
    the three bit for bit on the logits, and ``max_memory_allocated``."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.mapper.executor import full_float32
    from repro_torch.parallel import pipeline as pipe
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LLAMA_PIPE_TIME["n_layers"])
    b, s = LLAMA_PIPE_TIME["batch"], LLAMA_PIPE_TIME["seq_len"]
    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    params = llama_params(cfg, seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 81)
    toks = [torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
            for _ in range(PIPE_MICRO)]
    caches = [llama_cache(cfg, b, s) for _ in range(PIPE_MICRO)]
    pos = torch.tensor(LLAMA_PIPE_TIME["pos"], dtype=torch.int32,
                       device=DEVICE)
    # the peak of the runs, from the weights and the caches they read
    torch.cuda.reset_peak_memory_stats()
    lap("weights_and_caches")
    prog = mapper.compile_arch("llama3-8b", "serve", batch=b, seq_len=s,
                               partitions=PIPE_PARTITIONS, expand_scans=True,
                               config=cfg)
    lap("compile")
    sched = prog.schedule
    base = mapper.compile_schedule(sched, use_cache=False)
    aprog = mapper.compile_partitioned(
        sched, use_cache=False,
        streams=[torch.cuda.Stream() for _ in range(PIPE_STREAMS)])
    mbs = [prog.flatten_args(params, caches[m], toks[m], pos)
           for m in range(PIPE_MICRO)]

    def sequential():
        return [base(params, caches[m], toks[m], pos)[0]
                for m in range(PIPE_MICRO)]

    def grid():
        return [o[0] for o in pipe.run_partitioned(prog.stages,
                                                   prog.out_refs, mbs)]

    def grid_async():
        return [o[0] for o in pipe.run_partitioned_async(
            aprog.stages, aprog.out_refs, mbs)]

    with torch.no_grad(), full_float32():
        reset_counts()
        prog(params, caches[0], toks[0], pos)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != {"k1": 1, "k2": 0, "k3": LLAMA_K3, "k5": 0}:
            raise AssertionError(f"pim_llama_pipe time: launches {counts}")
        a, g, y = sequential(), grid(), grid_async()
        torch.cuda.synchronize()
        if not (leaves_equal(a, g) and leaves_equal(g, y)):
            raise AssertionError("pim_llama_pipe time: sequential, grid "
                                 "and async logits differ")
        if not all(bool(torch.isfinite(x.float()).all()) for x in a):
            raise AssertionError("pim_llama_pipe time: logits not finite")
        del a, g, y
        lap("checks")
        rows = {}
        for name, fn in (("sequential", sequential),
                         ("run_partitioned", grid),
                         ("run_partitioned_async", grid_async)):
            stats0 = torch.cuda.memory_stats()
            # the checks above made each driver's first call
            ms = wall_ms(fn, iters=1, warmup=0)
            stats1 = torch.cuda.memory_stats()
            lap(f"{name}_wall")
            # warm: the timed calls just ran
            prof = profile_device(fn, 1, warm=False)
            lap(f"{name}_profile")
            rows[name] = {"wall_ms": ms,
                          # the caching allocator over the timed calls:
                          # cudaMalloc / cudaFree calls and retries (a
                          # retry frees the cache, with a device sync)
                          "allocator": {k: stats1.get(k, 0) - stats0.get(
                              k, 0) for k in ("num_device_alloc",
                                              "num_device_free",
                                              "num_alloc_retries")},
                          "wall_ms_per_microbatch": ms / PIPE_MICRO,
                          "device_ms": prof["device_ms_per_call"],
                          "kernels_per_microbatch":
                              prof["kernels_per_call"] / PIPE_MICRO,
                          "device_busy_share_under_profiler":
                              prof["device_busy_share_under_profiler"],
                          "device_ms_by_group":
                              prof["device_ms_per_call_by_group"]}
        peak = torch.cuda.max_memory_allocated()
    r = {"config": "llama3-8b published (configs/llama3_8b.py), bf16, "
                   f"{cfg.n_layers} of 32 layers", **LLAMA_PIPE_TIME,
         "microbatches": PIPE_MICRO, "streams": PIPE_STREAMS,
         "expansion": sched.graph.groups,
         "partitions": [{"nodes": len(p.nodes), "out_bits": p.out_bits}
                        for p in prog.partitions],
         "stage_in_out": [[len(st.in_refs), st.n_outs]
                          for st in prog.stages],
         "subarrays": sched.placement.n_subarrays,
         "compile_s": seconds["compile"], "seconds": seconds,
         "launches_per_microbatch": counts, "bit_equal": True, **rows,
         "max_memory_allocated_gb": peak / 1e9,
         "modeled": dataclasses.asdict(sched.pipeline(PIPE_MICRO))}
    if peak >= 80e9:
        raise AssertionError(f"pim_llama_pipe time: {peak / 1e9} GB")
    del params, caches, mbs, prog, aprog, base
    torch.cuda.empty_cache()
    return r


def phase_pim_llama_pipe(seed: int) -> dict:
    """llama3-8b's decode step cut into pipeline stages inside its layer
    stack (``partitions=4, expand_scans=True``): ``llama_pipe_hold`` on
    the fp32 and int8 grids, then ``llama_pipe_time``. Emitted as one
    ``pim_llama_pipe`` line."""
    t0 = time.perf_counter()
    fp32 = llama_pipe_hold(seed, "fp32")
    int8 = llama_pipe_hold(seed, "int8")
    t1 = time.perf_counter()
    timing = llama_pipe_time(seed)
    emit({"phase": "pim_llama_pipe",
          "seconds": {"hold": t1 - t0, "time": time.perf_counter() - t1},
          "config": "llama3-8b at its published width (configs/"
                    "llama3_8b.py), float32, cut to "
                    f"{LLAMA_HOLD['n_layers']} layers",
          **{k: LLAMA_HOLD[k] for k in ("batch", "seq_len")},
          "pos": LLAMA_PIPE_POS, "partitions": PIPE_PARTITIONS,
          "reduced": {"n_layers": [32, LLAMA_HOLD["n_layers"]],
                      "dtype": ["bfloat16", "float32"]},
          "tol": LLAMA_TOL, "fp32": fp32["row"], "int8": int8["row"],
          "time": timing})
    return {"fp32": fp32, "int8": int8,
            "launches": {k: fp32["launches"][k] + int8["launches"][k]
                         for k in PIM_KEYS}}


# ---------------------------------------------------------------------------
# 21. pim_pipe: LeNet-5 through pipeline partitions and GPipe training
# ---------------------------------------------------------------------------

PIPE_SERVE_BATCH = 256
PIPE_SERVE_PARTS = (2, 3)
PIPE_TRAIN_BATCH = 64
PIPE_TRAIN_STEPS = 20
PIPE_TRAIN_PARTS = 2


@contextlib.contextmanager
def cotangent_swapped():
    """A control: ``torch.autograd.grad`` with the output cotangents of
    the second stage call that takes non-scalar ones replaced by the
    first such call's (one stage's output cotangent swapped between two
    microbatches). Yields a list that holds True once swapped."""
    import torch
    real = torch.autograd.grad
    seen: list = []
    done = [False]

    def grad(outputs, inputs, grad_outputs=None, **kw):
        gos = list(grad_outputs)
        if any(g.dim() for g in gos):
            if seen and not done[0] and [g.shape for g in gos] == [
                    g.shape for g in seen[0]]:
                gos = [g.clone() for g in seen[0]]
                done[0] = True
            elif not seen:
                seen.append([g.clone() for g in gos])
        return real(outputs, inputs, gos, **kw)

    torch.autograd.grad = grad
    try:
        yield done
    finally:
        torch.autograd.grad = real


def phase_pim_pipe(seed: int, pim_train_ms: float) -> dict:
    """The paper's LeNet-5, not cut, through pipeline partitions.
    Serve: ``compile_lenet("serve", batch=256, partitions=2 and 3)`` bit
    for bit the unpartitioned program and the per-block executor, its
    stages' launches summing to the unpartitioned program's;
    ``run_partitioned`` over ``PIPE_MICRO`` microbatches of 256 images bit
    for bit their sequential calls, ``run_partitioned_async`` on the
    stages' streams bit for bit the grid, both timed, and ``run_async``
    the partitioned call; the control, one
    boundary value swapped between two microbatches, failing. Train:
    ``Trainer(backend="pim", microbatches=8, partitions=2)`` at batch 64,
    AdamW lr 2e-3, ``DigitsDataset(seed=0)``, ``PIPE_TRAIN_STEPS`` steps —
    the main path, every count set to 0 just before and read just after
    — its losses within ``LOSS_TOL`` of ``Trainer(backend="jit")`` and of
    the unpartitioned pim trainer; its K1/K3 launches per step and stage,
    forward and backward, each equal to its derived count (forward: M x
    the stage program's; backward: M x the cotangents its autograd graph
    asks, ``stage_vjps``); ms per step against ``pim_train``'s. The
    asynchronous variant, ``pim_compile={"streams": ring}`` (each stage's
    cells on its own stream), driven the same way: its losses, launches
    and gradients bit for bit the one-stream run's, its ms per step. The
    control, one stage's output cotangent swapped between two
    microbatches, failing the gradients' hold (a control that swaps
    nothing fails the phase)."""
    import tempfile

    import torch
    from repro_torch import mapper, obs
    from repro_torch.data import DigitsDataset
    from repro_torch.mapper.executor import full_float32, max_deviation
    from repro_torch.models import lenet
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import pipeline as pipe
    params = seeded_params(seed, seed + 1)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 90)
    images = [torch.randn((PIPE_SERVE_BATCH, 28, 28, 1), generator=gen,
                          device=DEVICE) for _ in range(PIPE_MICRO)]
    total = dict.fromkeys(PIM_KEYS, 0)
    serve_rows = []
    with torch.no_grad(), full_float32():
        base = mapper.compile_lenet("serve", batch=PIPE_SERVE_BATCH)
        for k in PIPE_SERVE_PARTS:
            prog = mapper.compile_lenet("serve", batch=PIPE_SERVE_BATCH,
                                        partitions=k)
            ring = [torch.cuda.Stream() for _ in range(k)]
            aprog = mapper.compile_partitioned(prog.schedule,
                                               use_cache=False, streams=ring)
            mbs = [prog.flatten_args(params, x) for x in images]
            reset_counts()
            out = prog(params, images[0])
            per_stage = stage_launches(prog)
            grid = pipe.run_partitioned(prog.stages, prog.out_refs, mbs)
            torch.cuda.synchronize()
            counts = read_counts()
            for key in PIM_KEYS:
                total[key] += counts[key]
            want = base(params, images[0])
            ex_out = mapper.ScheduleExecutor(prog.schedule).run(params,
                                                                images[0])
            seq = [base(params, x) for x in images]
            asy = pipe.run_partitioned_async(aprog.stages, aprog.out_refs,
                                             mbs)
            one_async = aprog.run_async(params, images[0])
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(out, ex_out)
                    and torch.equal(one_async, out)
                    and all(torch.equal(g[0], q) for g, q in zip(grid, seq))
                    and all(torch.equal(a[0], g[0])
                            for a, g in zip(asy, grid))):
                raise AssertionError(f"pim_pipe serve k={k}: partitioned, "
                                     f"unpartitioned, executor, run_async, "
                                     f"grid and async differ")
            if [sum(c) for c in zip(*per_stage)] != [
                    base.matmul_launches, base.eltwise_launches]:
                raise AssertionError(f"pim_pipe serve k={k}: stage "
                                     f"launches {per_stage}")
            vs_plain = max_deviation(out, lenet.lenet_apply(params,
                                                            images[0]),
                                     **PIM_TOL)
            bad = swapped_boundary(prog, mbs, 0, 1)[0]
            if torch.equal(bad, seq[0]):
                raise AssertionError(f"pim_pipe serve k={k}: a boundary "
                                     f"value swapped passes the hold")
            serve_rows.append({
                "partitions": k,
                "nodes": [len(p.nodes) for p in prog.partitions],
                "out_bits": [p.out_bits for p in prog.partitions],
                "launches_by_stage": per_stage,
                "launches_per_call": {kk: v // (1 + PIPE_MICRO)
                                      for kk, v in counts.items()},
                "bit_equal": True, "max_abs_err_vs_plain": vs_plain,
                "control_boundary_swapped_max_abs_err": float(
                    (bad - seq[0]).abs().max()),
                "sequential_ms": wall_ms(
                    lambda: [base(params, x) for x in images], iters=10),
                "run_partitioned_ms": wall_ms(
                    lambda: pipe.run_partitioned(prog.stages, prog.out_refs,
                                                 mbs), iters=10),
                "run_partitioned_async_ms": wall_ms(
                    lambda: pipe.run_partitioned_async(
                        aprog.stages, aprog.out_refs, mbs), iters=10),
                "modeled": dataclasses.asdict(
                    prog.schedule.pipeline(PIPE_MICRO))})
            del prog, aprog, grid, asy, seq, mbs

    # GPipe training: the main path
    opt = make_optimizer("adamw", lr=TRAIN_LR)
    batches = digit_batches(PIPE_TRAIN_BATCH, PIPE_TRAIN_STEPS)
    params0 = lenet.init_lenet(seed, device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp, full_float32():
        tmp = pathlib.Path(tmp)
        pipe_tr = make_trainer(
            "pim", params0, batches, PIPE_TRAIN_STEPS, tmp / "g",
            microbatches=PIPE_MICRO, partitions=PIPE_TRAIN_PARTS,
            loss_fn=lenet.lenet_loss, optimizer=opt)
        prog = pipe_tr.pim_program
        obs.metrics().reset()
        reset_counts()
        res = pipe_tr.run()
        torch.cuda.synchronize()
        counts = read_counts()
        for key in PIM_KEYS:
            total[key] += counts[key]
        wall = step_wall_s()
        stats = pipe_tr.pipeline_stats
        losses = res["losses"]
        # the asynchronous variant: each stage's cells on its own stream
        ring = [torch.cuda.Stream() for _ in range(PIPE_TRAIN_PARTS)]
        async_tr = make_trainer(
            "pim", params0, batches, PIPE_TRAIN_STEPS, tmp / "a",
            microbatches=PIPE_MICRO, partitions=PIPE_TRAIN_PARTS,
            loss_fn=lenet.lenet_loss, optimizer=opt,
            pim_compile={"streams": ring})
        obs.metrics().reset()
        reset_counts()
        async_losses = async_tr.run()["losses"]
        torch.cuda.synchronize()
        async_counts = read_counts()
        async_wall = step_wall_s()
        for key in PIM_KEYS:
            total[key] += async_counts[key]
        if async_losses != losses or async_counts != counts:
            raise AssertionError(f"pim_pipe train: on {len(ring)} streams "
                                 f"losses {async_losses}, launches "
                                 f"{async_counts}; on one {losses}, "
                                 f"{counts}")
        jit_losses = make_trainer("jit", params0, batches, PIPE_TRAIN_STEPS,
                                  tmp / "j").run()["losses"]
        pim_losses = make_trainer("pim", params0, batches, PIPE_TRAIN_STEPS,
                                  tmp / "p").run()["losses"]
        np.testing.assert_allclose(losses, jit_losses, **LOSS_TOL)
        np.testing.assert_allclose(losses, pim_losses, **LOSS_TOL)
        # every stage's launches a step, derived: forward M x its
        # program's launches, backward M x the cotangents its forward's
        # autograd graph asks (``stage_vjps``); the update runs natively
        mb = PIPE_TRAIN_BATCH // PIPE_MICRO
        imgs, labels = batches[0]
        flat = [prog.flatten_args(params0, imgs[m * mb:(m + 1) * mb],
                                  labels[m * mb:(m + 1) * mb])
                for m in range(PIPE_MICRO)]
        n_param = len(torch.utils._pytree.tree_leaves(params0))
        per_stage = stage_launches(prog)
        vjps = stage_vjps(prog, flat[0], n_param)
        fwd = {s: stats["fwd"][s] for s in range(len(prog.stages))}
        bwd = {s: stats["bwd"][s] for s in range(len(prog.stages))}
        want_fwd = {s: {"K1": PIPE_MICRO * k1, "K2": 0,
                        "K3": PIPE_MICRO * k3, "K5": 0}
                    for s, (k1, k3) in enumerate(per_stage)}
        want_bwd = {s: {"K1": PIPE_MICRO * v["k1"], "K2": 0,
                        "K3": PIPE_MICRO * v["k3"], "K5": 0}
                    for s, v in enumerate(vjps)}
        want_step = {k: sum(r[k.upper()] for r in (*want_fwd.values(),
                                                   *want_bwd.values()))
                     for k in PIM_KEYS}
        if (fwd != want_fwd or bwd != want_bwd or counts != {
                k: PIPE_TRAIN_STEPS * v for k, v in want_step.items()}
                or not want_step["k1"] or not want_step["k3"]):
            raise AssertionError(f"pim_pipe train: launches {counts}, "
                                 f"stats {stats}; derived forward "
                                 f"{want_fwd}, backward {want_bwd}")
        # the control: one stage's output cotangent swapped between two
        # microbatches fails the gradients' hold
        want = torch.utils._pytree.tree_leaves(torch.func.grad(
            lenet.lenet_loss)(params0, imgs, labels))
        _, good = pipe.gpipe_value_and_grad(prog.stages, prog.out_refs[0],
                                            flat, list(range(n_param)))
        grad_dev = max_deviation(good, want, **LOSS_TOL)
        aprog = async_tr.pim_program
        _, on_ring = pipe.gpipe_value_and_grad(
            aprog.stages, aprog.out_refs[0],
            [aprog.flatten_args(params0, imgs[m * mb:(m + 1) * mb],
                                labels[m * mb:(m + 1) * mb])
             for m in range(PIPE_MICRO)], list(range(n_param)))
        torch.cuda.synchronize()
        if not leaves_equal(on_ring, good):
            raise AssertionError("pim_pipe train: gradients on the ring of "
                                 "streams differ from one stream's")
        with cotangent_swapped() as swapped:
            _, bad = pipe.gpipe_value_and_grad(
                prog.stages, prog.out_refs[0], flat, list(range(n_param)))
        if not swapped[0]:
            raise AssertionError("pim_pipe train: the control swapped no "
                                 "cotangent")
        try:
            max_deviation(bad, want, **LOSS_TOL)
        except AssertionError:
            control = max(float((x - y).abs().max())
                          for x, y in zip(bad, want))
        else:
            raise AssertionError("pim_pipe train: a cotangent swapped "
                                 "passes the hold")
    emit({"phase": "pim_pipe",
          "config": "lenet5 (paper, 21655 params), float32, not cut",
          "serve": serve_rows,
          "train": {"batch": PIPE_TRAIN_BATCH, "steps": PIPE_TRAIN_STEPS,
                    "microbatches": PIPE_MICRO,
                    "partitions": PIPE_TRAIN_PARTS,
                    "nodes": [len(p.nodes) for p in prog.partitions],
                    "losses": losses, "plain_losses": jit_losses,
                    "pim_unpartitioned_losses": pim_losses,
                    "max_loss_dev_vs_plain": float(np.max(np.abs(
                        np.subtract(losses, jit_losses)))),
                    "launches_per_step": {k: v / PIPE_TRAIN_STEPS
                                          for k, v in counts.items()},
                    "launches_by_stage_last_step": {"fwd": fwd,
                                                    "bwd": bwd},
                    "cotangents_asked_by_stage_per_microbatch": vjps,
                    "grad_max_abs_err_vs_plain": grad_dev,
                    "control_cotangent_swapped_max_abs_err": control,
                    "ms_per_step": wall["steady_mean"] * 1e3,
                    "pim_train_ms_per_step": pim_train_ms,
                    "train.step_wall_s": wall,
                    "gpipe_driver": "one stream (the caller's)",
                    "async": {
                        "streams": len(ring),
                        "losses_bit_equal_one_stream": True,
                        "grads_bit_equal_one_stream": True,
                        "launches_equal_one_stream": True,
                        "ms_per_step": async_wall["steady_mean"] * 1e3,
                        "train.step_wall_s": async_wall}}})
    return {"launches": total}


# ---------------------------------------------------------------------------
# 22. serve_pim: ServeEngine(backend="pim"), the paged tick through the mapper
# ---------------------------------------------------------------------------

# the hold: llama3-8b at its published width, float32, cut to 2 layers
SERVE_PIM_HOLD = dict(batch=8, max_len=512, kv_block_size=8, n_layers=2)
SERVE_PIM_REQUESTS = dict(n=12, lo=16, hi=200, max_tokens=16)
# the tight pool: 60 allocatable blocks for 8 slots of up to 27 blocks;
# admitted slots outgrow it and one is swapped out (the allocator does
# not depend on the tokens: one preemption at this seed, as on the CPU)
SERVE_PIM_TIGHT = dict(kv_blocks=61, prefill="batch")
SERVE_PIM_Q = dict(kv_dtype="int8", kv_block_size=16)   # K6
SERVE_PIM_TOL = 1e-4       # x max|logit|, rtol and atol
SERVE_PIM_CHECK_TICK = 6   # the tick whose logits are held
# the K3 launches of one tick: the final norm's three MACs, the CPU's
# count (tests/test_torch_serve_pim.py); the stack runs natively
SERVE_PIM_K3 = 3
# the timed run: the published config (bf16, 32 layers), the serve phase's
# load at block size 8 (an fp32 16-token block exceeds a subarray there)
SERVE_PIM_TIME = dict(batch=8, max_len=1024, kv_block_size=8)


def decode_kernels():
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q)
    return {"k4": paged_decode_attention_grouped,
            "k6": paged_decode_attention_grouped_q}


def serve_counts_reset() -> None:
    reset_counts()
    for k in decode_kernels().values():
        k.launches = 0


def serve_counts() -> dict:
    return {**read_counts(), **{key: k.launches
                                for key, k in decode_kernels().items()}}


def serve_engine(cfg, model, prompts, max_tokens, *, count=False, **opts):
    """One engine over ``prompts`` (``attn_kernel=True`` on ``DEVICE``),
    run to the end; with ``count`` every kernel's count set to 0 just
    before the run and read just after. Returns (engine, {rid: tokens},
    counts or None)."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, model, paged=True, attn_kernel=True,
                      device=DEVICE, **opts)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=max_tokens))
    if count:
        serve_counts_reset()
    out = {r.rid: r.out for r in eng.run()}
    counts = serve_counts() if count else None
    return eng, out, counts


def per_tick(counts: dict, ticks: int) -> dict:
    return {k: v / ticks for k, v in counts.items()}


def serve_pim_logits(eng, cfg) -> dict:
    """One tick of ``eng`` (mid-run) on copies of its pool: the program's
    logits against ``decode_step_paged``'s gather path (float32, TF32
    off) at ``SERVE_PIM_TOL`` x max|logit|, and the control — the same
    program with two slots' block-table rows swapped — failing it."""
    import torch
    from repro_torch.mapper.executor import full_float32
    from repro_torch.models import transformer
    active = [s for s in range(eng.batch) if eng.slots[s] is not None]
    params, cache, tok, table, pos = eng._pim_args(eng._feed(active))
    pool = cache["layers"]["block0"]

    def copy():
        return {"layers": {"block0": {k: v.clone() for k, v in pool.items()}}}

    with torch.no_grad(), full_float32():
        got = eng.pim_program(params, copy(), tok, table, pos)[0]
        want = transformer.decode_step_paged(
            cfg, params, copy(), tok, table, pos, kernel=False,
            kv_dtype=eng.kv_dtype)[0]
        swapped = table.clone()
        swapped[[0, 1]] = table[[1, 0]]
        bad = eng.pim_program(params, copy(), tok, swapped, pos)[0]
    limit = SERVE_PIM_TOL * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=SERVE_PIM_TOL, atol=limit)
    try:
        torch.testing.assert_close(bad, want, rtol=SERVE_PIM_TOL,
                                   atol=limit)
    except AssertionError:
        control = float((bad - want).abs().max())
    else:
        raise AssertionError("serve_pim: two slots' table rows swapped "
                             "pass the logits hold")
    err = float((got - want).abs().max())
    return {"active_slots": len(active), "positions": pos.tolist(),
            "max_abs_err": err, "limit": limit,
            "control_rows_swapped_max_abs_err": control}


def serve_pim_no_sync(eng) -> int:
    """One program call under ``set_sync_debug_mode("error")``, its
    arguments made before: 0 host syncs, or it raises."""
    import torch
    active = [s for s in range(eng.batch) if eng.slots[s] is not None]
    args = eng._pim_args(eng._feed(active))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._pim_call(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return 0


def serve_pim_hold(seed: int) -> dict:
    """``SERVE_PIM_HOLD``: the pim engine against the jit engine on the
    same seeded requests, token for token — with batched and replayed
    prefill (and one tick's logits and a sync-free call checked mid-run),
    a tight pool that preempts, an int8 pool (K6), an int8 weight grid
    (K5; the jit engine over the LM head the grid stores) and 4
    partitions on one stream and on a ring of 4 — with each pim run's
    launches a tick."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.mapper.executor import fake_quant_stationary
    from repro_torch.models import DecoderLM
    from repro_torch.serve import Request, ServeEngine, map_paged_tick
    h, rq = SERVE_PIM_HOLD, SERVE_PIM_REQUESTS
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=h["n_layers"], dtype="float32")
    model = DecoderLM(cfg, device=DEVICE).init(seed)
    prompts = make_prompts(np.random.default_rng(seed + 80), rq["n"],
                           rq["lo"], rq["hi"], cfg.vocab_size)
    base = {k: h[k] for k in ("batch", "max_len", "kv_block_size")}
    n, total = rq["max_tokens"], {k: 0 for k in (*PIM_KEYS, "k4", "k6")}
    rows = {}

    def run(name, opts, want_tick, jit_model=None, jit_opts=None):
        eng, got, counts = serve_engine(cfg, model, prompts, n, count=True,
                                        backend="pim", **{**base, **opts})
        _, want, _ = serve_engine(cfg, jit_model or model, prompts, n,
                                  **{**base, **(jit_opts or opts)})
        if got != want:
            raise AssertionError(f"serve_pim {name}: tokens differ from "
                                 f"the jit engine's")
        tick = per_tick(counts, eng._tick)
        if tick != {**dict.fromkeys(tick, 0), **want_tick}:
            raise AssertionError(f"serve_pim {name}: launches a tick "
                                 f"{tick}, want {want_tick}")
        for k in total:
            total[k] += counts[k]
        rows[name] = {"ticks": eng._tick, "tokens_identical_to_jit": True,
                      "launches_per_tick": {k: v for k, v in tick.items()
                                            if v},
                      "preemptions": eng.preemptions,
                      "nodes": len(eng.schedule.graph.nodes),
                      "subarrays": eng.schedule.placement.n_subarrays,
                      "kv_subarrays": eng.kv_placement.n_subarrays,
                      "kv_t_s": eng.schedule.kv.t_s}
        return eng, got

    layers = cfg.n_layers
    fp32_tick = {"k1": 1, "k3": SERVE_PIM_K3, "k4": layers}
    t0 = time.perf_counter()
    with torch.no_grad():
        # batched prefill, with one tick's logits and a sync-free call
        eng = ServeEngine(cfg, model, paged=True, attn_kernel=True,
                          device=DEVICE, backend="pim", prefill="batch",
                          **base)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=n))
        for _ in range(SERVE_PIM_CHECK_TICK):
            eng.tick_once()
        logits = serve_pim_logits(eng, cfg)
        syncs = serve_pim_no_sync(eng)
        del eng
        _, tokens = run("batch", dict(prefill="batch"), fp32_tick)
        run("replay", dict(prefill="replay"), fp32_tick)
        tight, _ = run("tight_pool", SERVE_PIM_TIGHT, fp32_tick)
        if tight.preemptions == 0 or tight.resumes == 0:
            raise AssertionError("serve_pim: the tight pool preempted "
                                 "nothing")
        run("int8_pool", dict(SERVE_PIM_Q, prefill="batch"),
            {"k1": 1, "k3": SERVE_PIM_K3, "k6": layers})
        # the int8 weight grid: the jit engine over the stored LM head
        sched = map_paged_tick(cfg, attn_kernel=True, weight_dtype="int8",
                               **base)
        head = next(nd for nd in sched.graph.nodes
                    if nd.kind == "matmul" and not nd.scanned)
        stored = DecoderLM(cfg, device=DEVICE).init(seed)
        stored.lm_head.w.copy_(fake_quant_stationary(sched, head,
                                                     model.lm_head.w))
        run("int8_weights", dict(weight_dtype="int8", prefill="batch"),
            {"k5": 1, "k3": SERVE_PIM_K3, "k4": layers}, jit_model=stored,
            jit_opts=dict(prefill="batch"))
        del stored, sched
        # 4 partitions over the expanded stack, on one stream and a ring
        parts = dict(partitions=PIPE_PARTITIONS, expand_scans=True,
                     microbatches=PIPE_MICRO, prefill="batch")
        for name, extra in (("partitions", {}), ("partitions_ring", {
                "pim_compile": {"streams": [torch.cuda.Stream() for _ in
                                            range(PIPE_STREAMS)]}})):
            eng, got, counts = serve_engine(cfg, model, prompts, n,
                                            count=True, backend="pim",
                                            **base, **parts, **extra)
            if got != tokens:
                raise AssertionError(f"serve_pim {name}: tokens differ "
                                     f"from the unpartitioned pim engine's")
            if counts["k4"] != layers * eng._tick:
                raise AssertionError(f"serve_pim {name}: K4 ran "
                                     f"{counts['k4']} times")
            for k in total:
                total[k] += counts[k]
            rows[name] = {"ticks": eng._tick,
                          "tokens_identical_to_unpartitioned": True,
                          "launches_per_tick": {
                              k: v for k, v in per_tick(counts,
                                                        eng._tick).items()
                              if v},
                          "nodes": len(eng.schedule.graph.nodes),
                          "partition_nodes": [len(p.nodes) for p in
                                              eng.schedule.partitions],
                          "pipeline_speedup": eng.pipeline_timeline.speedup}
            del eng
    del model
    torch.cuda.empty_cache()
    return {"rows": rows, "logits": logits, "host_syncs_in_call": syncs,
            "launches": total, "seconds": time.perf_counter() - t0}


def serve_pim_profile(eng, seed: int) -> dict:
    """A second load on a time engine (8 requests of 64 prompt tokens, 8
    output tokens): after the admitting tick, 3 ticks under the profiler
    (``profile_device``: device ms and kernels a tick) and one traced
    tick joined against the schedule (``drift_report``, pim only), then
    drained."""
    from repro_torch import obs
    from repro_torch.serve import Request
    prompts = make_prompts(np.random.default_rng(seed + 81), 8, 64, 64,
                           eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=200 + i, prompt=p, max_tokens=8))
    eng.tick_once()
    prof = profile_device(eng.tick_once, 3)
    r = {"profile": prof}
    if eng.backend == "pim":
        with obs.scoped() as tr:
            eng.tick_once()
        rep = eng.drift_report(tr)
        r["drift"] = {"ratio": rep.ratio, "clock": rep.clock,
                      "measured_s": rep.measured_total_s,
                      "modeled_s": rep.modeled_total_s,
                      "kv_modeled_s": rep.kv_modeled_s,
                      "nodes_measured": rep.n_measured}
    eng.run()
    return r


# the serve-load time runs (serve_pim, the variants'): one wave of the 8
# slots, 32 output tokens each (two waves took ~60 s more of the script's
# shared time limit over the phases)
TIME_LOAD_REQUESTS = 8


def serve_pim_time(model, seed: int) -> dict:
    """The published config (the serve phase's bf16 model, 32 layers) at
    ``SERVE_PIM_TIME`` over ``TIME_LOAD_REQUESTS`` of the serve phase's
    requests, 32 output tokens each: the pim engine and the jit engine in turn — tok/s, TTFT,
    ms a tick, device ms and kernels a tick under the profiler, peak
    memory — and the pim tick's drift ratio (recorded, not held)."""
    import torch
    from repro_torch import obs
    from repro_torch.serve import Request, ServeEngine
    cfg = model.cfg
    prompts = make_prompts(np.random.default_rng(seed + 1),
                           TIME_LOAD_REQUESTS, 64, 512, cfg.vocab_size)
    out = {}
    for backend in ("pim", "jit"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, model, paged=True, attn_kernel=True,
                          prefill="batch", backend=backend, device=DEVICE,
                          **SERVE_PIM_TIME)
        build_s = time.perf_counter() - t0
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=32))
        serve_counts_reset()
        tr = obs.enable()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        obs.disable()
        counts = serve_counts()
        if len(done) != len(prompts) or any(
                len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                            for t in r.out) for r in done):
            raise AssertionError(f"serve_pim time {backend}: not every "
                                 f"request finished with 32 valid tokens")
        if counts["k4"] != cfg.n_layers * eng._tick:
            raise AssertionError(f"serve_pim time {backend}: K4 ran "
                                 f"{counts['k4']} times")
        decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
        generated = sum(len(r.out) for r in done)
        row = {"build_s": build_s, "ticks": eng._tick,
               "generated_tokens": generated, "wall_s": wall_s,
               "decode_s": decode_s,
               "decode_tok_per_s": generated / decode_s,
               "tick_ms": decode_s / eng._tick * 1e3,
               "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
               "launches_per_tick": {k: v for k, v in per_tick(
                   counts, eng._tick).items() if v},
               "tokens_first_request": done[0].out[:8],
               **serve_pim_profile(eng, seed)}
        row["max_memory_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
        if row["max_memory_allocated_gb"] >= 80:
            raise AssertionError(f"serve_pim time {backend}: "
                                 f"{row['max_memory_allocated_gb']} GB")
        if backend == "pim":
            row["nodes"] = len(eng.schedule.graph.nodes)
            row["kv_t_s"] = eng.schedule.kv.t_s
            pim_counts = counts
        out[backend] = row
        del eng, done
        torch.cuda.empty_cache()
    pim_tokens = out["pim"].pop("tokens_first_request")
    out["first_request_tokens_agree"] = pim_tokens == out["jit"].pop(
        "tokens_first_request")
    return {"rows": out, "launches": pim_counts}


def phase_serve_pim(model, seed: int) -> dict:
    """``ServeEngine(backend="pim")``: ``serve_pim_hold`` at the published
    width in float32 cut to 2 layers, then ``serve_pim_time`` on
    ``model`` (the serve phase's). Emitted as one ``serve_pim`` line."""
    hold = serve_pim_hold(seed)
    t0 = time.perf_counter()
    timing = serve_pim_time(model, seed)
    launches = {k: hold["launches"][k] + timing["launches"][k]
                for k in hold["launches"]}
    emit({"phase": "serve_pim",
          "seconds": {"hold": hold["seconds"],
                      "time": time.perf_counter() - t0},
          "config": "llama3-8b at its published width (configs/"
                    "llama3_8b.py), float32, cut to "
                    f"{SERVE_PIM_HOLD['n_layers']} layers",
          **SERVE_PIM_HOLD, "requests": SERVE_PIM_REQUESTS,
          "reduced": {"n_layers": [32, SERVE_PIM_HOLD["n_layers"]],
                      "dtype": ["bfloat16", "float32"]},
          "tol": SERVE_PIM_TOL, "hold": hold["rows"],
          "logits": hold["logits"],
          "host_syncs_in_call": hold["host_syncs_in_call"],
          "time": {**SERVE_PIM_TIME,
                   "config": "llama3-8b published, bf16, 32 layers",
                   **timing["rows"]},
          "launches": launches})
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 23. pim_llama_long: llama3-8b above seq 2048 and with grad_accum
# ---------------------------------------------------------------------------

# the chunked hold: published width, float32, 2 layers, remat as published
# (the pair scan's forward recomputed inside the transposed stack), one
# sequence of 4096 tokens: 8 chunks of 512, 36 causal pairs a layer
LONG_HOLD = dict(batch=1, seq_len=4096, n_layers=2)
# the grad_accum hold: 2 microbatches of one sequence of 128 tokens, cut
# to 1 layer at full width: its float32 accumulator adds 5.9 GB at 2
# layers, which would take the seq-128 train hold's 69.4 GB past ~76 GB
LONG_ACCUM_HOLD = dict(batch=2, seq_len=128, n_layers=1, grad_accum=2)
# K3 launches of one compiled and one per-block step at each hold (the
# CPU's plans of the same configs, tests/test_torch_long_train.py at the
# smoke width): the add/sub/mul nodes outside the folded loops
LONG_K3 = {"chunked": {"compiled": 84, "per_block": 148},
           "accum": {"compiled": 74, "per_block": 134}}
ACCUM_TOL = 1e-4           # accumulated vs one-step gradients and loss
# the prefill hold: make_prefill_step (the chunked pair scan) against a
# plain forward over the full causal attention at the same length
LONG_PREFILL_HOLD = dict(batch=1, seq_len=4096, n_layers=2)
LONG_PREFILL_TOL = 1e-4    # rtol, and atol x max|logit|
# the timed runs: the published dtype (bf16) at seq 2560, the shortest
# the pair scan takes (the reference's train_4k length takes ~20 s more of
# the script's shared time), cut to 2 layers (AdamW's state for 32 does
# not fit one card; at 4 layers, 47,552 aten ops to trace, the whole
# script took 709 s, past its 702.8 s budget); the published config's
# prefill as it is at 4096
# tokens (the script's time is shared by every phase: 8192 takes ~6 s
# more, 32768 ~66,560 pair iterations of eager launches a call, minutes)
LONG_TRAIN_TIME = dict(batch=1, seq_len=2560, n_layers=2)
LONG_PREFILL_TIME = dict(batch=1, seq_len=4096)


def accum_against_one(seed: int, cfg, b: int, s: int) -> dict:
    """The plain ``grad_accum`` step's loss and gradients against the
    plain ``grad_accum=1`` step's on the same batch and seeded parameters
    (TF32 off): the microbatches are of equal size, so the mean of their
    means is the batch mean. Each step takes SGD with momentum at lr 1
    from zeros, whose new state is the step's float32 gradient, bit for
    bit (an AdamW update divides by √v̂, which turns float32 rounding
    into large differences where a seeded v is near 0). Each leaf within
    ``ACCUM_TOL`` × its largest |gradient|, the loss within
    ``ACCUM_TOL``."""
    import torch
    from repro_torch._tree import leaves_with_path
    from repro_torch.launch import make_train_step
    from repro_torch.mapper.executor import full_float32
    from repro_torch.optim import make_optimizer
    params = llama_params(cfg, seed)
    state = make_optimizer("sgdm", lr=1.0).init(params)
    batch = token_batch(cfg, b, s, seed)

    def grads(c):
        _, new, loss = make_train_step(c, optimizer_name="sgdm", lr=1.0)(
            params, state, batch)
        return new["mu"], float(loss)

    with full_float32():
        got, loss = grads(cfg)
        want, one_loss = grads(dataclasses.replace(cfg, grad_accum=1))
    worst = max(float((g - w).abs().max() / w.abs().max())
                for (_, g), (_, w) in zip(leaves_with_path(got),
                                          leaves_with_path(want),
                                          strict=True))
    if not (worst <= ACCUM_TOL and abs(loss - one_loss) <= ACCUM_TOL):
        raise AssertionError(f"pim_llama_long accum vs one step: gradients "
                             f"{worst} of their largest, loss {loss} vs "
                             f"{one_loss}")
    del params, state, got, want
    torch.cuda.empty_cache()
    return {"loss_abs_diff": abs(loss - one_loss),
            "grad_max_diff_of_largest": worst}


def full_attention_last_logits(cfg, params, tokens):
    """The last position's logits of a plain forward over the full causal
    attention at the sequence's length (``attention.full_causal_attention``
    and ``layers``, each layer's scores whole): what ``make_prefill_step``
    computes chunk pair by chunk pair above seq 2048."""
    import torch
    from repro_torch.models import attention, layers
    b, s = tokens.shape
    hd = cfg.resolved_head_dim
    lp = params["layers"]["block0"]
    with torch.no_grad():
        x = layers.embed(tokens, params["embed"]["table"])
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(cfg.n_layers):
            w = {f"{g}/{n}": lp[g][n][i] for g in lp for n in lp[g]}
            h = layers.rms_norm(x, w["norm1/scale"], cfg.norm_eps)

            def heads(name, n):
                return (h @ w[f"attn/{name}"]).reshape(b, s, n, hd)

            q = layers.apply_rope(heads("wq", cfg.n_heads), pos,
                                  theta=cfg.rope_theta, style=cfg.rope_style)
            k = layers.apply_rope(heads("wk", cfg.n_kv_heads), pos,
                                  theta=cfg.rope_theta, style=cfg.rope_style)
            o = attention.full_causal_attention(q, k, heads("wv",
                                                            cfg.n_kv_heads))
            x = x + o.reshape(b, s, -1) @ w["attn/wo"]
            x = x + layers.mlp(layers.rms_norm(x, w["norm2/scale"],
                                               cfg.norm_eps),
                               w["mlp/w_gate"], w["mlp/w_up"],
                               w["mlp/w_down"])
            del h, q, k, o
        x = layers.rms_norm(x[:, -1:], params["final_norm"]["scale"],
                            cfg.norm_eps)
        return layers.lm_head(x, params["lm_head"]["w"])[:, 0]


def prefill_ratio(got, want) -> float:
    """The largest ``|got - want|`` over its limit ``rtol·|want| + atol ×
    max|want|`` (``LONG_PREFILL_TOL`` both): above 1 fails."""
    limit = LONG_PREFILL_TOL * (want.abs() + want.abs().max())
    return float(((got - want).abs() / limit).max())


def long_prefill_hold(seed: int) -> dict:
    """``make_prefill_step`` at ``LONG_PREFILL_HOLD`` (published width,
    float32, 2 layers, batch 1, seq 4096: the chunked attention's pair
    scan, 36 pairs a layer) against ``full_attention_last_logits`` on the
    same seeded parameters and tokens (TF32 off); the control — one chunk
    pair, the last q chunk's diagonal, dropped from the pair list
    (``attention._pair_indices`` patched) — must fail the hold."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step
    from repro_torch.mapper.executor import full_float32
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LONG_PREFILL_HOLD["n_layers"],
                              dtype="float32")
    b, s = LONG_PREFILL_HOLD["batch"], LONG_PREFILL_HOLD["seq_len"]
    params = llama_params(cfg, seed)
    batch = {"tokens": token_batch(cfg, b, s, seed)["tokens"]}
    step = make_prefill_step(cfg)
    pairs = attention._pair_indices
    with full_float32():
        got = step(params, batch)
        want = full_attention_last_logits(cfg, params, batch["tokens"])
        ratio = prefill_ratio(got, want)
        if got.shape != (b, cfg.vocab_size) or not ratio <= 1.0:
            raise AssertionError(f"pim_llama_long prefill: {tuple(got.shape)}"
                                 f", {ratio} of the limit")
        attention._pair_indices = lambda n: tuple(p[:-1] for p in pairs(n))
        try:
            bad = prefill_ratio(step(params, batch), want)
        finally:
            attention._pair_indices = pairs
    if not bad > 1.0:
        raise AssertionError("pim_llama_long prefill: the last diagonal "
                             "pair dropped passes the hold")
    r = {**LONG_PREFILL_HOLD, "max_abs_err": float((got - want).abs().max()),
         "max_abs_logit": float(want.abs().max()), "ratio_of_limit": ratio,
         "control_pair_dropped_ratio": bad}
    del params, got, want
    torch.cuda.empty_cache()
    return r


def pair_share(cfg, b: int, s: int, seed: int, step_ms: float) -> dict:
    """The pair scan's device ms in one step of ``cfg`` at batch ``b``,
    seq ``s``: its forward and its backward (``attention.chunked_forward``
    / ``chunked_backward``) at the step's shapes and dtype, on seeded
    q, k, v, each profiled once on the card (``profile_device``), times
    their calls a step (a layer's forward, again under remat inside the
    transposed stack, and its backward), against the step's device ms
    ``step_ms``."""
    import torch
    from repro_torch.models import attention
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 90)
    hd, dtype = cfg.resolved_head_dim, getattr(torch, cfg.dtype)

    def draw(heads):
        return torch.randn((b, s, heads, hd), generator=gen,
                           device=DEVICE).to(dtype)

    q, k, v = draw(cfg.n_heads), draw(cfg.n_kv_heads), draw(cfg.n_kv_heads)
    dout = draw(cfg.n_heads)
    with torch.no_grad():
        out, lse = attention.chunked_forward(q, k, v)
        fwd = profile_device(lambda: attention.chunked_forward(q, k, v), 1)
        bwd = profile_device(lambda: attention.chunked_backward(
            q, k, v, out, lse, dout), 1)
    calls = {"forward": cfg.n_layers * (2 if cfg.remat else 1),
             "backward": cfg.n_layers}
    ms = (calls["forward"] * fwd["device_ms_per_call"]
          + calls["backward"] * bwd["device_ms_per_call"])
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    return {"forward_device_ms": fwd["device_ms_per_call"],
            "backward_device_ms": bwd["device_ms_per_call"],
            "forward_kernels": fwd["kernels_per_call"],
            "backward_kernels": bwd["kernels_per_call"],
            "calls_per_step": calls, "device_ms_per_step": ms,
            "share_of_plain_step_device_ms": ms / step_ms}


def head_share(cfg, b: int, s: int, seed: int, step_ms: float) -> dict:
    """The fused LM head and cross entropy's device ms in one step of
    ``cfg`` at batch ``b``, seq ``s`` (``layers.fused_xent_head``, its
    forward and its VJP, once a step; its products on bf16 operands
    widened to f32, ``layers._chunk_logits``), on seeded inputs at the
    step's shapes and dtype, profiled once on the card, against the
    step's device ms ``step_ms``."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 91)
    dtype = getattr(torch, cfg.dtype)
    x = torch.randn((b, s, cfg.d_model), generator=gen,
                    device=DEVICE).to(dtype).requires_grad_()
    w = (0.02 * torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                            device=DEVICE)).to(dtype).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=DEVICE)

    def head():
        loss = layers.fused_xent_head(x, w, labels, max(1, s // 512))
        return torch.autograd.grad(loss, (x, w))

    prof = profile_device(head, 1)
    del x, w, labels
    torch.cuda.empty_cache()
    return {"device_ms_per_step": prof["device_ms_per_call"],
            "kernels": prof["kernels_per_call"],
            "share_of_plain_step_device_ms":
                prof["device_ms_per_call"] / step_ms}


def long_train_time(seed: int) -> dict:
    """llama3-8b at its published dtype (bf16), remat as published, cut
    to ``LONG_TRAIN_TIME``'s 2 layers, batch 1, seq 2560, on seeded
    parameters and AdamW state: one warm compiled step counted (K3 at the
    plan's waves, no K1, K2 or K5; the loss finite and against the plain
    step's), then ms per compiled and plain step (wall, one step each,
    both warm), device time, kernels a step and the busy share under the
    profiler, the pair scan's and the LM head's shares of the plain
    step's device time (``pair_share``, ``head_share``),
    ``max_memory_allocated`` (before those)."""
    import torch
    from repro_torch import mapper
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=LONG_TRAIN_TIME["n_layers"])
    b, s = LONG_TRAIN_TIME["batch"], LONG_TRAIN_TIME["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    params, opt = llama_train_state(cfg, seed)
    batch = token_batch(cfg, b, s, seed)
    t0 = time.perf_counter()
    prog = mapper.compile_arch("llama3-8b", "train", batch=b, seq_len=s,
                               config=cfg)
    compile_s = time.perf_counter() - t0
    waves = sum(st.kind == "placed" for st in prog.ctx.steps)
    step = make_train_step(cfg)
    reset_counts()
    out = prog(params, opt, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != {"k1": 0, "k2": 0, "k3": waves, "k5": 0}:
        raise AssertionError(f"pim_llama_long time: launches {counts}, "
                             f"want {waves} K3")
    loss = float(out[2])
    del out
    plain_loss = float(step(params, opt, batch)[2])
    if not np.isfinite(loss):
        raise AssertionError("pim_llama_long time: loss not finite")
    # both warm: the counted step and the plain loss's
    ms = wall_ms(lambda: prog(params, opt, batch), iters=1, warmup=0)
    prof = profile_device(lambda: prog(params, opt, batch), 1, warm=False)
    plain_ms = wall_ms(lambda: step(params, opt, batch), iters=1, warmup=0)
    plain_prof = profile_device(lambda: step(params, opt, batch), 1,
                                warm=False)
    peak = torch.cuda.max_memory_allocated()
    aten_ops = len(prog.schedule.graph.gm.graph.nodes)
    del params, opt, prog
    torch.cuda.empty_cache()
    pairs = pair_share(cfg, b, s, seed, plain_prof["device_ms_per_call"])
    head = head_share(cfg, b, s, seed, plain_prof["device_ms_per_call"])
    if peak >= 80e9:
        raise AssertionError(f"pim_llama_long time: {peak / 1e9} GB "
                             f"allocated")
    r = {"config": "llama3-8b at its published width (configs/"
                   "llama3_8b.py), bf16, remat, cut to "
                   f"{LONG_TRAIN_TIME['n_layers']} layers",
         **LONG_TRAIN_TIME,
         "reduced": {"n_layers": [32, LONG_TRAIN_TIME["n_layers"]]},
         "compile_s": compile_s,
         "aten_ops": aten_ops, "launches_per_step": counts, "loss": loss,
         "plain_loss": plain_loss, "loss_abs_diff": abs(loss - plain_loss),
         "ms_per_step": ms, "plain_ms_per_step": plain_ms,
         "profile": prof, "plain_profile": plain_prof,
         "pair_scan": pairs, "lm_head": head,
         "max_memory_allocated_gb": peak / 1e9}
    return r


def long_prefill_time(seed: int) -> dict:
    """``make_prefill_step`` at the published config as it is (bf16, 32
    layers), ``LONG_PREFILL_TIME``'s batch 1 and 4096 tokens (8 chunks,
    36 pairs a layer) on seeded parameters: the last position's logits
    finite, ms of that one call (wall; its kernels warm from
    ``long_train_time``'s bf16 pairs), tokens/s,
    ``max_memory_allocated``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step
    cfg = get_config("llama3-8b")
    b, s = LONG_PREFILL_TIME["batch"], LONG_PREFILL_TIME["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    params = llama_params(cfg, seed)
    batch = {"tokens": token_batch(cfg, b, s, seed)["tokens"]}
    step = make_prefill_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if out.shape != (b, cfg.vocab_size) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"pim_llama_long prefill time: "
                             f"{tuple(out.shape)} or not finite")
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"pim_llama_long prefill time: {peak / 1e9} "
                             f"GB allocated")
    del params, out
    torch.cuda.empty_cache()
    return {"config": "llama3-8b published (configs/llama3_8b.py), bf16, "
                      "32 layers", **LONG_PREFILL_TIME, "ms_per_call": ms,
            "tokens_per_s": b * s / (ms / 1e3),
            "max_memory_allocated_gb": peak / 1e9,
            "left_out": {"seq_len": 32768, "why": "~66,560 pair iterations "
                         "of eager launches a call: minutes, past the "
                         "script's budget"}}


def phase_pim_llama_long(seed: int) -> dict:
    """llama3-8b above seq 2048 and with ``grad_accum``: ``train_hold`` at
    ``LONG_HOLD`` (the chunked attention) and at ``LONG_ACCUM_HOLD``
    (two microbatches; ``accum_against_one``), ``long_prefill_hold``,
    ``long_train_time`` and ``long_prefill_time``. Emitted as one
    ``pim_llama_long`` line."""
    from repro_torch.configs import get_config
    seconds = {}
    base = get_config("llama3-8b")
    accum_cfg = dataclasses.replace(
        base, n_layers=LONG_ACCUM_HOLD["n_layers"], dtype="float32",
        grad_accum=LONG_ACCUM_HOLD["grad_accum"])
    ab, as_ = LONG_ACCUM_HOLD["batch"], LONG_ACCUM_HOLD["seq_len"]

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] pim_llama_long {name} "
              f"{seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    chunked = part("chunked_hold", lambda: train_hold(
        seed, dataclasses.replace(base, n_layers=LONG_HOLD["n_layers"],
                                  dtype="float32"),
        LONG_HOLD["batch"], LONG_HOLD["seq_len"], LONG_K3["chunked"],
        "pim_llama_long chunked hold", hold_waves=False, on_host=False))
    accum = part("accum_hold", lambda: train_hold(
        seed, accum_cfg, ab, as_, LONG_K3["accum"],
        "pim_llama_long accum hold", hold_waves=False, on_host=False))
    accum["plain_vs_one_step"] = part(
        "accum_vs_one", lambda: accum_against_one(seed, accum_cfg, ab, as_))
    prefill = part("prefill_hold", lambda: long_prefill_hold(seed))
    timing = part("train_time", lambda: long_train_time(seed))
    prefill_time = part("prefill_time", lambda: long_prefill_time(seed))
    launches = {k: chunked["launches"][k] + accum["launches"][k]
                for k in PIM_KEYS}
    emit({"phase": "pim_llama_long", "seconds": seconds,
          "config": "llama3-8b at its published width (configs/"
                    "llama3_8b.py), float32",
          "reduced": {"n_layers": [32, LONG_HOLD["n_layers"]],
                      "accum_n_layers": [32, LONG_ACCUM_HOLD["n_layers"]],
                      "dtype": ["bfloat16", "float32"]},
          "tol": LLAMA_TRAIN_TOL, "launches": launches,
          "chunked_hold": {**LONG_HOLD, **chunked},
          "accum_hold": {**LONG_ACCUM_HOLD, **accum},
          "prefill_hold": prefill, "time": timing,
          "prefill_time": prefill_time})
    return {"launches": launches, "time": timing}


# ---------------------------------------------------------------------------
# 24. dense_variants: qwen2.5-32b, qwen3-32b, chatglm3-6b (item 5.1)
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("qwen2.5-32b", "qwen3-32b", "chatglm3-6b")
# (a) each at its published width, float32, cut to 2 layers: 8 requests of
# 17-40 prompt tokens, 8 output tokens, through 8 slots
DENSE_PARITY = dict(n_layers=2, requests=8, lo=17, hi=40, batch=8)
# K4 (f32 and bf16 q) and K6 (int8, f32 q: the parity runs') at each
# variant's heads, the serve shapes otherwise: rep 5 (40 q heads over 8
# kv heads: 8 query rows, 3 idle), rep 8 (64 over 8) and rep 16 (32 over
# 2: kMaxRep, 16 float accumulators a thread at D 128)
DENSE_REPS = {"qwen2.5-32b": dict(K4_SHAPES, H=40, G=8),
              "qwen3-32b": dict(K4_SHAPES, H=64, G=8),
              "chatglm3-6b": dict(K4_SHAPES, H=32, G=2)}
# (b) qwen3-32b's decode step, expanded, at LLAMA_HOLD: the CPU's plan of
# a compiled step (products, K3 launches, K3 members), the same on both
# grids (tests/test_torch_dense_variants.py counts the smoke config's)
DENSE_DECODE_PLAN = (15, 47, 63)
# (d) qwen3-32b's train step: published width, float32, 1 layer, batch 2
# (grad_accum 2: two microbatches of 1), seq 128; the CPU's K3 counts.
# Its waves are llama3-8b's forms (AdamW, the rope tables, the final
# norm: every product and the head norm lie in folded loops), held
# member by member in pim_llama_train; holding a 778 M-element member's
# plain output beside the step would pass ~76 GB here.
# Peak, reckoned: 8.2 GB of params (the two 151,936 x 5,120 tables 6.2,
# the layer 2.0) and 16.4 of m and v; the compiled step makes 8.2 of
# gradients (f32 accumulators of both microbatches) and 24.6 of new
# params, m and v, moved to host memory before the executor's step makes
# its own: ~24.6 + 8.2 + 24.6 + activations ~ 60 GB, under 76
DENSE_TRAIN_HOLD = dict(batch=2, seq_len=128, n_layers=1)
DENSE_TRAIN_K3 = {"compiled": 86, "per_block": 156}
# (c) chatglm3-6b through ServeEngine(backend="pim") at SERVE_PIM_HOLD
# (float32, 2 layers), the serve_pim hold's requests: K4 at rep 16 inside
# the mapped program
# time runs (bf16): the serve phase's load (batch 8, TIME_LOAD_REQUESTS
# requests of 64-512 prompt tokens, 32 output tokens), blocks of 16
DENSE_TIME = dict(batch=8, max_len=1024, kv_block_size=16)
DENSE_TIME_ARCHS = ("chatglm3-6b", "qwen2.5-32b")
# qwen2.5-32b's time at 32 of its 64 layers (all 64 fit; the script's time
# is shared by every phase, and the 64 take ~10 s more of init and ticks)
DENSE_TIME_LAYERS = {"qwen2.5-32b": 32}
DENSE_MEMORY_LIMIT = 76e9


def dense_cfg(arch: str, **changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **changes)


def config_file(arch: str) -> str:
    """The port's config module of ``arch``, as the lines name it."""
    from repro_torch.configs import _MODULES
    return f"configs/{_MODULES[arch]}.py"


def dense_model(cfg, seed: int):
    from repro_torch.models import DecoderLM
    return vary_attention_(DecoderLM(cfg, device=DEVICE).init(seed), seed)


def rep_readings(seed: int, reps: dict = DENSE_REPS) -> dict:
    """K4 and K6 at ``reps`` (``DENSE_REPS`` by default): each held against
    its plain version per (slot, head) row with the one-row-past-pos
    control, timed against its bound and SDPA (``hold_and_time``), its
    splits per slot recorded."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        paged_decode_attention_grouped, paged_decode_attention_grouped_q,
        split_policy)
    rng = np.random.default_rng(seed + 30)
    out = {}
    for arch, s in reps.items():
        rep = s["H"] // s["G"]
        rows = []
        for qname in ("float32", "bfloat16"):
            dtype = getattr(torch, qname)
            q, pools, table, pos = k4_inputs(dtype, rng, DEVICE, s)
            r = hold_and_time(
                f"K4 rep {rep} {qname}", q, pos, pools,
                lambda p, at: paged_decode_attention_grouped(
                    q, p[0], p[1], table, at),
                lambda p, at: ref.paged_decode_attention_ref(
                    q, p[0], p[1], table, at),
                lambda p: to_heads(p[0], p[1], table, dtype, s), s)
            bound_ms, bound_by = k4_bound(q, pos, qname, s)
            rows.append({"kernel": "K4", "dtype": qname, **r,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            del pools
        q, pools, table, pos = k6_inputs("int8", torch.float32, rng, DEVICE,
                                         s)

        def args(pool, at):
            (kc, vc), (ks, vs) = pool
            return (q, kc, ks, vc, vs, table, at)

        def heads(pool):
            (kc, vc), (ks, vs) = pool
            return to_heads(quant.dequantize_kv(kc, ks, "int8"),
                            quant.dequantize_kv(vc, vs, "int8"), table,
                            torch.float32, s)

        r = hold_and_time(
            f"K6 rep {rep} int8/float32", q, pos, pools,
            lambda p, at: paged_decode_attention_grouped_q(
                *args(p, at), kv_dtype="int8"),
            lambda p, at: ref.paged_decode_attention_q_ref(*args(p, at),
                                                           "int8"),
            heads, s)
        bound_ms, bound_by = k6_bound(q, pools[0][0], pos, s)
        rows.append({"kernel": "K6", "kv_dtype": "int8", "dtype": "float32",
                     **r, "bound_ms": bound_ms, "bound_by": bound_by})
        del pools
        torch.cuda.empty_cache()
        per, n_split = split_policy(s["W"], s["bs"])
        out[arch] = {"rep": rep, "shapes": s,
                     "rows_padded_to": 1 << (rep - 1).bit_length(),
                     "blocks_per_split": per, "n_split": n_split,
                     "results": rows}
    return out


def dense_pim_engine(seed: int, arch: str = "chatglm3-6b",
                     phase: str = "dense_variants") -> dict:
    """(c): ``arch`` (chatglm3-6b) at ``SERVE_PIM_HOLD`` (published width,
    float32, 2 layers) through ``ServeEngine(backend="pim")`` against the
    jit engine on the serve_pim hold's requests: tokens identical,
    launches a tick K1 1, K3 ``SERVE_PIM_K3``, K4 one a layer (rep 16
    inside the mapped program; musicgen-medium's rep 1 in ``io_variants``),
    each count set to 0 just before the pim run, read just after."""
    import torch
    h, rq = SERVE_PIM_HOLD, SERVE_PIM_REQUESTS
    cfg = dense_cfg(arch, n_layers=h["n_layers"], dtype="float32")
    model = dense_model(cfg, seed)
    prompts = make_prompts(np.random.default_rng(seed + 80), rq["n"],
                           rq["lo"], rq["hi"], cfg.vocab_size)
    base = {k: h[k] for k in ("batch", "max_len", "kv_block_size")}
    with torch.no_grad():
        eng, got, counts = serve_engine(cfg, model, prompts,
                                        rq["max_tokens"], count=True,
                                        backend="pim", prefill="batch",
                                        **base)
        _, want, _ = serve_engine(cfg, model, prompts, rq["max_tokens"],
                                  prefill="batch", **base)
    if got != want:
        raise AssertionError(f"{phase} {arch} pim engine: tokens differ "
                             f"from the jit engine's")
    tick = per_tick(counts, eng._tick)
    want_tick = {"k1": 1, "k3": SERVE_PIM_K3, "k4": cfg.n_layers}
    if tick != {**dict.fromkeys(tick, 0), **want_tick}:
        raise AssertionError(f"{phase} {arch} pim engine: launches a tick "
                             f"{tick}, want {want_tick}")
    row = {"ticks": eng._tick, "tokens_identical_to_jit": True,
           "launches_per_tick": {k: v for k, v in tick.items() if v},
           "nodes": len(eng.schedule.graph.nodes),
           "subarrays": eng.schedule.placement.n_subarrays,
           "kv_subarrays": eng.kv_placement.n_subarrays}
    del eng, model
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts}


def dense_time_layers(cfg, n_layers: int | None = None
                      ) -> tuple[int, float]:
    """The most layers (up to the published depth, in whole units of
    ``transformer.unit_blocks``) whose reckoned peak stays under
    ``DENSE_MEMORY_LIMIT``, or ``n_layers`` where given: the bf16 weights
    (``param_count`` of the cut config), the KV pool of ``DENSE_TIME``
    (every slot's blocks and the scratch block), and the largest
    transient, init's float32 draw of the largest leaf (an expert's slice
    of an expert leaf: ``MoE.init`` draws one expert at a time). Returns
    (layers, the reckoned peak in bytes)."""
    from repro_torch.models.transformer import leaf_shapes, unit_blocks
    b, m, bs = (DENSE_TIME[k] for k in ("batch", "max_len", "kv_block_size"))
    blocks = 1 + b * -(-m // bs)
    kv = 2 * blocks * bs * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    largest = 4 * max(
        int(np.prod(s[(2 if "/moe/w_" in k else 1)
                      if k.startswith("layers/") else 0:]))
        for k, s in leaf_shapes(cfg).items())
    unit = unit_blocks(cfg)
    for n in ([n_layers] if n_layers else
              range(cfg.n_layers, 0, -unit)):
        params = 2 * (dataclasses.replace(cfg, n_layers=n).param_count()
                      + cfg.d_model)
        peak = params + n * kv + largest
        if peak < DENSE_MEMORY_LIMIT:
            return n, float(peak)
    raise AssertionError(f"{cfg.name}: no depth fits {DENSE_MEMORY_LIMIT}")


def dense_time(arch: str, seed: int, phase: str = "dense_variants",
               n_layers: int | None = None, before=None,
               after=None) -> dict:
    """One bf16 config at the most layers that fit (``dense_time_layers``;
    the published depth where it fits; ``n_layers`` where given) serving
    the serve phase's load at ``DENSE_TIME`` on the kernel path: tok/s,
    TTFT, ms a tick, K4 launches (one a layer a tick, its count set to 0
    just before the run and read just after), then a second short load
    with 3 ticks under the profiler (device ms, kernels and the busy share
    a tick), peak memory. ``before(cfg, model)`` runs after the init and
    ``after(eng)`` after the loads, their readings joined to the row."""
    import torch
    from repro_torch import obs
    from repro_torch.serve import Request, ServeEngine
    published = dense_cfg(arch)
    layers, reckoned = dense_time_layers(published, n_layers)
    cfg = dataclasses.replace(published, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dense_model(cfg, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    extra = before(cfg, model) if before else {}
    prompts = make_prompts(np.random.default_rng(seed + 1),
                           TIME_LOAD_REQUESTS, 64, 512, cfg.vocab_size)
    eng = ServeEngine(cfg, model, paged=True, attn_kernel=True,
                      prefill="batch", device=DEVICE, **DENSE_TIME)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=32))
    serve_counts_reset()
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    obs.disable()
    counts = serve_counts()
    if len(done) != len(prompts) or any(
            len(r.out) != 32 or not all(0 <= t < cfg.vocab_size
                                        for t in r.out) for r in done):
        raise AssertionError(f"{phase} time {arch}: not every request "
                             f"finished with 32 valid tokens")
    if counts["k4"] != cfg.n_layers * eng._tick or counts["k4"] == 0:
        raise AssertionError(f"{phase} time {arch}: K4 ran "
                             f"{counts['k4']} times")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    generated = sum(len(r.out) for r in done)
    row = {"config": f"{arch} published ({config_file(arch)}), bf16, "
                     f"{layers} of {published.n_layers} layers",
           **DENSE_TIME, "n_layers": layers, "init_s": init_s,
           "ticks": eng._tick, "generated_tokens": generated,
           "wall_s": wall_s, "decode_s": decode_s,
           "decode_tok_per_s": generated / decode_s,
           "tick_ms": decode_s / eng._tick * 1e3,
           "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
           "k4_launches": counts["k4"], "preemptions": eng.preemptions,
           "reckoned_peak_gb": reckoned / 1e9,
           **serve_pim_profile(eng, seed), **extra}
    if after:
        row.update(after(eng))
    row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if row["max_memory_allocated_gb"] * 1e9 >= DENSE_MEMORY_LIMIT:
        raise AssertionError(f"{phase} time {arch}: "
                             f"{row['max_memory_allocated_gb']} GB")
    del eng, done, model
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts}


def phase_dense_variants(seed: int) -> dict:
    """The dense attention variants (item 5.1): qwen2.5-32b's q/k/v biases,
    qwen3-32b's per-head q/k norm, chatglm3-6b's half RoPE, each with
    seeded biases and norm scales away from their init. Holds at the
    published width in float32: (a) each config's kernel-vs-gather
    parity over fp32 and int8 pools (``parity_runs``), K4 and K6 at rep 5,
    8 and 16 (``rep_readings``); (b) qwen3-32b's decode step expanded
    through the mapper on both grids (``llama_hold``); (c) chatglm3-6b's
    pim engine (``dense_pim_engine``); (d) qwen3-32b's train step
    (``train_hold``). Time: chatglm3-6b and qwen2.5-32b in bf16
    (``dense_time``). Emitted as one ``dense_variants`` line."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    launches = {k: 0 for k in (*PIM_KEYS, "k4", "k6")}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] dense_variants {name} "
              f"{seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    parity = {}
    for arch in DENSE_ARCHS:
        def run(arch=arch):
            cfg = dense_cfg(arch, n_layers=DENSE_PARITY["n_layers"],
                            dtype="float32")
            model = dense_model(cfg, seed)
            prompts = make_prompts(np.random.default_rng(seed + 3),
                                   DENSE_PARITY["requests"],
                                   DENSE_PARITY["lo"], DENSE_PARITY["hi"],
                                   cfg.vocab_size)
            got = parity_runs(cfg, model, prompts, ("fp32", "int8"),
                              f"{arch} n_layers=2 float32",
                              DENSE_PARITY["batch"])
            del model
            torch.cuda.empty_cache()
            return got
        parity[arch] = part(f"parity {arch}", run)
        add({"k4": parity[arch]["fp32"], "k6": parity[arch]["int8"]})
    reps = part("reps", lambda: rep_readings(seed))
    decode = {}
    for grid in ("fp32", "int8"):
        decode[grid] = part(f"decode {grid}", lambda grid=grid: llama_hold(
            seed, grid, "qwen3-32b", expand=True, plan=DENSE_DECODE_PLAN))
        add(decode[grid]["launches"])
    engine = part("pim_engine", lambda: dense_pim_engine(seed))
    add(engine["launches"])
    train = part("train", lambda: train_hold(
        seed, dense_cfg("qwen3-32b", n_layers=DENSE_TRAIN_HOLD["n_layers"],
                        dtype="float32"),
        DENSE_TRAIN_HOLD["batch"], DENSE_TRAIN_HOLD["seq_len"],
        DENSE_TRAIN_K3, "dense_variants qwen3-32b train hold",
        hold_waves=False, arch="qwen3-32b"))
    add(train["launches"])
    timing = {}
    for arch in DENSE_TIME_ARCHS:
        timing[arch] = part(f"time {arch}", lambda arch=arch: dense_time(
            arch, seed, n_layers=DENSE_TIME_LAYERS.get(arch)))
        add(timing[arch]["launches"])
    emit({"phase": "dense_variants", "seconds": seconds,
          "configs": {a: config_file(a) for a in DENSE_ARCHS},
          "variants": "q/k/v biases 0.1 N(0,1), q/k norm scales "
                      "1 + 0.25 N(0,1) (vary_attention_)",
          "reduced": {"holds": {"n_layers": "2 (train hold 1)",
                                "dtype": ["bfloat16", "float32"]},
                      "time": {a: [dense_cfg(a).n_layers,
                                   timing[a]["row"]["n_layers"]]
                               for a in DENSE_TIME_ARCHS}},
          "parity_launches": parity, "reps": reps,
          "decode": {g: {**LLAMA_HOLD, **decode[g]["row"]}
                     for g in decode},
          "pim_engine": {**SERVE_PIM_HOLD, **engine["row"]},
          "train": {**DENSE_TRAIN_HOLD, **train},
          "time": {a: timing[a]["row"] for a in DENSE_TIME_ARCHS},
          "launches": launches})
    return {"launches": launches, "reps": reps,
            "shapes": {g: decode[g]["shapes"] for g in decode}}


# ---------------------------------------------------------------------------
# 25. io_variants: musicgen-medium, qwen2-vl-2b (item 5.2)
# ---------------------------------------------------------------------------

IO_ARCHS = ("musicgen-medium", "qwen2-vl-2b")
# (a) each at its published width, float32, cut to 2 layers: DENSE_PARITY's
# 8 requests through 8 slots
# K4 (f32 and bf16 q) and K6 (int8, f32 q) at the two new reps, the serve
# shapes otherwise: rep 1 (musicgen-medium's 24 q heads over 24 kv heads,
# head dim 64) and rep 6 (qwen2-vl-2b's 12 over 2: 6 query rows padded to 8)
IO_REPS = {"musicgen-medium": dict(K4_SHAPES, H=24, G=24, D=64),
           "qwen2-vl-2b": dict(K4_SHAPES, H=12, G=2)}
# (c) qwen2-vl-2b's decode step, expanded, at LLAMA_HOLD: the CPU's plan
# (products, K3 launches, K3 members), the same on both grids
# (tests/test_torch_io_variants.py counts the smoke config's): M-RoPE's
# section products are 4 K3 members a layer more than llama3-8b's
IO_DECODE_PLAN = (15, 43, 59)
# (e) both train steps: published width, float32, 2 layers, batch 2, seq
# 128, on seeded embeddings (qwen2-vl-2b: and a seeded position grid); the
# CPU's K3 counts (the smoke configs' at 2 layers: the count does not move
# with the width). qwen2-vl-2b has no lm_head leaf (tied): 2 waves fewer
IO_TRAIN_HOLD = dict(batch=2, seq_len=128, n_layers=2)
IO_TRAIN_K3 = {"musicgen-medium": {"compiled": 84, "per_block": 148},
               "qwen2-vl-2b": {"compiled": 82, "per_block": 141}}


def position_grid(rng, b: int, s: int):
    """A qwen2-vl position grid [3, B, S] int32 (numpy): per row, some text
    tokens (t = h = w = i), an image of ph x pw patches with t constant and
    h / w stepping over the patch grid, then text from one past the image's
    largest position on; the text length and the image's height drawn by
    row, so the three rows differ."""
    g = np.zeros((3, b, s), np.int32)
    for row in range(b):
        n0 = int(rng.integers(1, max(2, s // 4)))
        ph = int(rng.integers(2, 9))
        pw = max(1, (s - n0) // (2 * ph))
        img = np.stack([np.full((ph, pw), n0),
                        n0 + np.arange(ph)[:, None].repeat(pw, 1),
                        n0 + np.arange(pw)[None].repeat(ph, 0)]).reshape(3, -1)
        after = s - n0 - img.shape[1]
        g[:, row] = np.concatenate([
            np.broadcast_to(np.arange(n0), (3, n0)), img,
            np.broadcast_to(img.max() + 1 + np.arange(after), (3, after))],
            1)
    if not ((g[0] != g[1]).any() and (g[1] != g[2]).any()):
        raise AssertionError("position grid: the t, h and w rows agree")
    return g


def io_batch(cfg, b: int, s: int, seed: int) -> dict:
    """A train step's batch of the stub frontends on the card, in
    ``steps.input_specs``'s key order: seeded embeddings [B, S, D] in the
    model dtype, seeded labels and, under ``needs_position_grid``, a
    seeded ``position_grid``."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 60)
    batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen,
                                   device=DEVICE).to(getattr(torch,
                                                             cfg.dtype)),
             "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    if cfg.needs_position_grid:
        batch["positions"] = torch.from_numpy(position_grid(
            np.random.default_rng(seed + 61), b, s)).to(DEVICE)
    return batch


def zero_gradient_table(cfg):
    """A ``train_hold`` check: musicgen-medium's embedding table, which the
    loss does not reach under embedding inputs, leaves the compiled step
    (and its m and v) exactly as the plain AdamW moves it on a zero
    gradient, and moves."""
    def check(params, opt, got):
        import torch
        from repro_torch.optim import make_optimizer
        adamw = make_optimizer("adamw", lr=3e-4,
                               state_dtype=cfg.opt_state_dtype)
        t = params["embed"]["table"]
        state = {"m": {"t": opt["m"]["embed"]["table"]},
                 "v": {"t": opt["v"]["embed"]["table"]}, "step": opt["step"]}
        new_p, new_s = adamw.update({"t": torch.zeros_like(t)}, state,
                                    {"t": t})
        for name, tree, b in (("params", got[0], new_p["t"]),
                              ("m", got[1]["m"], new_s["m"]["t"]),
                              ("v", got[1]["v"], new_s["v"]["t"])):
            a = tree["embed"]["table"].to(b.device)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"io_variants musicgen-medium train hold: embed/table's "
                    f"{name} differs from AdamW on a zero gradient by "
                    f"{float((a - b).abs().max())}")
        moved = float((new_p["t"] - t).abs().max())
        if moved == 0:
            raise AssertionError("io_variants musicgen-medium train hold: "
                                 "embed/table did not move")
        return {"embed_table_zero_gradient": {
            "bit_equal_adamw_on_zero_gradient": True, "max_move": moved}}
    return check


def phase_io_variants(seed: int) -> dict:
    """The model's inputs and outputs (item 5.2): musicgen-medium's frame
    embeddings in (full MHA: K4 at rep 1, head dim 64) and qwen2-vl-2b's
    embeddings in, M-RoPE over a (t, h, w) grid and the LM head tied to the
    embedding table (K1 / K5 on the table read transposed). Holds at the
    published width in float32: (a) each config cut to 2 layers,
    kernel-vs-gather parity over fp32 and int8 pools (``parity_runs``);
    (b) K4 and K6 at rep 1 and rep 6 (``rep_readings``); (c) qwen2-vl-2b's
    decode step expanded through the mapper on both grids
    (``llama_hold``); (d) musicgen-medium's pim engine
    (``dense_pim_engine``); (e) both train steps on seeded embeddings
    (qwen2-vl-2b: and a grid whose rows differ), musicgen-medium's unused
    table moved exactly as AdamW moves a zero-gradient leaf
    (``train_hold``). Time: both configs in bf16 at their published depth
    (``dense_time``). Emitted as one ``io_variants`` line."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    launches = {k: 0 for k in (*PIM_KEYS, "k4", "k6")}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] io_variants {name} "
              f"{seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    parity = {}
    for arch in IO_ARCHS:
        def run(arch=arch):
            cfg = dense_cfg(arch, n_layers=DENSE_PARITY["n_layers"],
                            dtype="float32")
            model = dense_model(cfg, seed)
            prompts = make_prompts(np.random.default_rng(seed + 4),
                                   DENSE_PARITY["requests"],
                                   DENSE_PARITY["lo"], DENSE_PARITY["hi"],
                                   cfg.vocab_size)
            got = parity_runs(cfg, model, prompts, ("fp32", "int8"),
                              f"{arch} n_layers=2 float32",
                              DENSE_PARITY["batch"])
            del model
            torch.cuda.empty_cache()
            return got
        parity[arch] = part(f"parity {arch}", run)
        add({"k4": parity[arch]["fp32"], "k6": parity[arch]["int8"]})
    reps = part("reps", lambda: rep_readings(seed, IO_REPS))
    decode = {}
    for grid in ("fp32", "int8"):
        decode[grid] = part(f"decode {grid}", lambda grid=grid: llama_hold(
            seed, grid, "qwen2-vl-2b", expand=True, plan=IO_DECODE_PLAN))
        add(decode[grid]["launches"])
    engine = part("pim_engine", lambda: dense_pim_engine(
        seed, "musicgen-medium", "io_variants"))
    add(engine["launches"])
    train = {}
    for arch in IO_ARCHS:
        def hold(arch=arch):
            h = IO_TRAIN_HOLD
            cfg = dense_cfg(arch, n_layers=h["n_layers"], dtype="float32")
            return train_hold(
                seed, cfg, h["batch"], h["seq_len"], IO_TRAIN_K3[arch],
                f"io_variants {arch} train hold", hold_waves=False,
                on_host=False, arch=arch,
                batch=io_batch(cfg, h["batch"], h["seq_len"], seed),
                check=(zero_gradient_table(cfg) if not cfg.tie_embeddings
                       else None))
        train[arch] = part(f"train {arch}", hold)
        add(train[arch]["launches"])
    timing = {}
    for arch in IO_ARCHS:
        timing[arch] = part(f"time {arch}", lambda arch=arch: dense_time(
            arch, seed, "io_variants"))
        add(timing[arch]["launches"])
    emit({"phase": "io_variants", "seconds": seconds,
          "configs": {a: config_file(a) for a in IO_ARCHS},
          "inputs": "serving: token ids through the embedding table (the "
                    "reference's engine); train: seeded embeddings "
                    "N(0, 1), qwen2-vl-2b's grid position_grid",
          "reduced": {"holds": {"n_layers": 2,
                                "dtype": ["bfloat16", "float32"]},
                      "time": {a: [dense_cfg(a).n_layers,
                                   timing[a]["row"]["n_layers"]]
                               for a in IO_ARCHS}},
          "parity_launches": parity, "reps": reps,
          "decode": {g: {**LLAMA_HOLD, **decode[g]["row"]}
                     for g in decode},
          "pim_engine": {**SERVE_PIM_HOLD, **engine["row"]},
          "train": {a: {**IO_TRAIN_HOLD, **train[a]} for a in IO_ARCHS},
          "time": {a: timing[a]["row"] for a in IO_ARCHS},
          "launches": launches})
    return {"launches": launches, "reps": reps,
            "shapes": {g: decode[g]["shapes"] for g in decode}}


# ---------------------------------------------------------------------------
# 26. moe_variants: granite-moe-1b-a400m, llama4-maverick-400b-a17b (item 5.3)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
# (a) granite at its published width, float32, cut to 2 layers:
# DENSE_PARITY's 8 requests through 8 slots
# (b) K4 (f32 and bf16 q) and K6 (int8, f32 q) at granite's heads, the
# serve shapes otherwise: rep 2 (16 q heads over 8 kv heads, head dim 64);
# and at K4_EDGE's splits (4-key blocks, 3 splits a slot) with its heads
MOE_REPS = {"granite-moe-1b-a400m": dict(K4_SHAPES, H=16, G=8, D=64)}
MOE_EDGE = dict(K4_EDGE, H=16, G=8)
# (c) granite's decode step, expanded, at LLAMA_HOLD: the CPU's plan
# (products, K3 launches, K3 members), the same on both grids and at the
# smoke width: each layer's q, k, v, o and router products and the tied
# head; the experts' batched products run natively, as the reference's
# lowering declines batched dot_generals, and the int32 waves of the
# dispatch decline K3
MOE_DECODE_PLAN = (11, 39, 55)
# maverick's hold: the first tick's logits, kernel path against gather
# path, bf16, x max|logit| (K7's bf16 precedent); a slot whose top-1
# expert differs between the two paths is left out of the logits only
# where its two experts' router probabilities lie within bf16's
# resolution (MOE_TIE_REL of the larger: a near-tie that rounding decides)
MOE_BF16_TOL = 2e-2
MOE_TIE_REL = 2.0 ** -6
MOE_MAVERICK_LAYERS = 2    # one unit: a dense block, then the MoE block


@contextlib.contextmanager
def recording_routes(shift: bool = False):
    """Record ``(probs, expert indices)`` of every ``models.moe.top_k``
    call while open; with ``shift``, the first token's first choice moved
    to the next expert (the control that the maverick hold must see)."""
    from repro_torch.models import moe
    real, calls = moe.top_k, []

    def top_k(probs, k):
        vals, idx = real(probs, k)
        if shift:
            flat = idx.view(-1)
            flat[0] = (flat[0] + 1) % probs.shape[-1]
        calls.append((probs, idx))
        return vals, idx

    moe.top_k = top_k
    try:
        yield calls
    finally:
        moe.top_k = real


def moe_first_tick(cfg, model, prompts, kernel: bool, shift: bool = False):
    """One engine (batch 8, blocks of 16, batched prefill) admitting
    ``prompts`` and running one decode tick: (its logits [8, V] float32,
    the tick's router probabilities and top-1 experts)."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    ticks = []

    def sample(logits):
        ticks.append(logits.float())
        return torch.argmax(logits, -1)

    eng = ServeEngine(cfg, model, paged=True, batch=8, max_len=1024,
                      kv_block_size=16, prefill="batch", attn_kernel=kernel,
                      sample=sample, device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=1))
    eng._admit()                         # the prompts' batched prefills
    with recording_routes(shift) as calls:
        eng.tick_once()
    probs, idx = calls[-1]               # the tick's MoE block
    del eng
    return ticks[0], probs.reshape(len(prompts), -1), idx.reshape(-1)


def maverick_hold(cfg, model, seed: int) -> dict:
    """The maverick hold (bf16, one unit): the first tick's logits on the
    kernel path against the gather path within ``MOE_BF16_TOL`` x
    max|logit|; the tick's top-1 experts equal, or apart only at a
    near-tie (``MOE_TIE_REL``), such a slot left out of the logits; and
    the control, the kernel path with the first token's expert shifted
    by one, failing the logits limit."""
    import torch
    prompts = make_prompts(np.random.default_rng(seed + 5), 8, 64, 512,
                           cfg.vocab_size)
    with torch.no_grad():
        got, _, idx = moe_first_tick(cfg, model, prompts, True)
        want, probs, want_idx = moe_first_tick(cfg, model, prompts, False)
        bad, _, bad_idx = moe_first_tick(cfg, model, prompts, True,
                                         shift=True)
    moved = (idx != want_idx).nonzero().flatten().tolist()
    for slot in moved:
        a, b = (float(probs[slot, int(e)]) for e in (idx[slot],
                                                     want_idx[slot]))
        if abs(a - b) > MOE_TIE_REL * max(a, b):
            raise AssertionError(f"moe_variants maverick hold: slot {slot}'s "
                                 f"top-1 expert {int(idx[slot])} on the "
                                 f"kernel path, {int(want_idx[slot])} on the "
                                 f"gather path ({a} vs {b})")
    held = [i for i in range(len(prompts)) if i not in moved]
    lim = MOE_BF16_TOL * float(want[held].abs().max())
    err = float((got[held] - want[held]).abs().max())
    if not err <= lim or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"moe_variants maverick hold: logits differ "
                             f"by {err} > {lim}")
    control = float((bad - want).abs().max()) / lim
    if not control > 1 or int(bad_idx[0]) == int(want_idx[0]):
        raise AssertionError(f"moe_variants maverick hold: shifting slot 0's"
                             f" expert gives only {control} x the limit")
    return {"hold": {"tol": MOE_BF16_TOL, "slots": len(prompts),
                     "routing_differs_at_near_ties": moved,
                     "max_err_over_limit": err / lim,
                     "control_expert_shifted_over_limit": control,
                     "top1_experts": want_idx.tolist()}}


def experts_share(eng, seed: int) -> dict:
    """A third short load (8 requests of 64 prompt tokens, 8 output
    tokens): after the admitting tick, 2 ticks under the profiler with the
    host traced, the device time under ``aten::bmm`` (the experts'
    batched products: the kernel path's attention is K4) against all the
    device time."""
    import torch
    from repro_torch.serve import Request
    prompts = make_prompts(np.random.default_rng(seed + 82), 8, 64, 64,
                           eng.cfg.vocab_size)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=300 + i, prompt=p, max_tokens=8))
    eng.tick_once()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(2):
            eng.tick_once()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    bmm = sum(e.device_time_total for e in events if e.key == "aten::bmm")
    eng.run()
    if not bmm:
        raise AssertionError("moe_variants: no aten::bmm on the card in a "
                             "maverick tick")
    return {"experts_bmm_ms_per_tick": bmm / 2 / 1e3,
            "device_ms_per_tick_traced": device / 2 / 1e3,
            "experts_bmm_share_of_device": bmm / device}


def phase_moe_variants(seed: int) -> dict:
    """Mixture of experts for serving (item 5.3): granite-moe-1b-a400m's
    MoE block on every layer (K4 at rep 2, head dim 64; the tied head on
    K1 / K5) and llama4-maverick-400b-a17b's interleaved unit with its
    shared expert. Holds, granite at the published width in float32, 2
    layers: (a) kernel-vs-gather parity over fp32 and int8 pools
    (``parity_runs``); (b) K4 and K6 at rep 2 (``rep_readings``) and at
    ``MOE_EDGE`` (``hold_edge``); (c) the decode step expanded through the
    mapper on both grids (``llama_hold``); (d) the pim engine
    (``dense_pim_engine``). Time, bf16 (``dense_time``): granite not cut;
    maverick at one unit through the jit engine, after its hold
    (``maverick_hold``), with the experts' share (``experts_share``).
    Emitted as one ``moe_variants`` line."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    granite = MOE_ARCHS[0]
    seconds = {}
    launches = {k: 0 for k in (*PIM_KEYS, "k4", "k6")}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] moe_variants {name} "
              f"{seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    def parity():
        cfg = dense_cfg(granite, n_layers=DENSE_PARITY["n_layers"],
                        dtype="float32")
        model = dense_model(cfg, seed)
        prompts = make_prompts(np.random.default_rng(seed + 6),
                               DENSE_PARITY["requests"], DENSE_PARITY["lo"],
                               DENSE_PARITY["hi"], cfg.vocab_size)
        got = parity_runs(cfg, model, prompts, ("fp32", "int8"),
                          f"{granite} n_layers=2 float32",
                          DENSE_PARITY["batch"])
        del model
        torch.cuda.empty_cache()
        return got

    par = part("parity", parity)
    add({"k4": par["fp32"], "k6": par["int8"]})

    def reps():
        out = rep_readings(seed, MOE_REPS)
        rng = np.random.default_rng(seed + 31)
        out[granite]["edge"] = {
            **{f"K4 {q}": k4_edge_readings(getattr(torch, q), rng, MOE_EDGE)
               for q in ("float32", "bfloat16")},
            **{f"K6 int8/{q}": k6_edge_readings("int8", getattr(torch, q),
                                                rng, MOE_EDGE)
               for q in ("float32", "bfloat16")}}
        return out

    rep = part("reps", reps)
    decode = {}
    for grid in ("fp32", "int8"):
        decode[grid] = part(f"decode {grid}", lambda grid=grid: llama_hold(
            seed, grid, granite, expand=True, plan=MOE_DECODE_PLAN))
        add(decode[grid]["launches"])
    engine = part("pim_engine", lambda: dense_pim_engine(
        seed, granite, "moe_variants"))
    add(engine["launches"])
    timing = {granite: part(f"time {granite}", lambda: dense_time(
        granite, seed, "moe_variants"))}
    maverick = MOE_ARCHS[1]
    timing[maverick] = part(f"time {maverick}", lambda: dense_time(
        maverick, seed, "moe_variants", n_layers=MOE_MAVERICK_LAYERS,
        before=lambda cfg, model: maverick_hold(cfg, model, seed),
        after=lambda eng: experts_share(eng, seed)))
    for arch in MOE_ARCHS:
        add(timing[arch]["launches"])
    emit({"phase": "moe_variants", "seconds": seconds,
          "configs": {a: config_file(a) for a in MOE_ARCHS},
          "reduced": {"holds": {"n_layers": 2, "dtype": ["bfloat16",
                                                         "float32"]},
                      "time": {a: [dense_cfg(a).n_layers,
                                   timing[a]["row"]["n_layers"]]
                               for a in MOE_ARCHS}},
          "parity_launches": par, "reps": rep,
          "decode": {g: {**LLAMA_HOLD, **decode[g]["row"]}
                     for g in decode},
          "pim_engine": {**SERVE_PIM_HOLD, **engine["row"]},
          "time": {a: timing[a]["row"] for a in MOE_ARCHS},
          "launches": launches})
    return {"launches": launches, "reps": rep,
            "shapes": {g: decode[g]["shapes"] for g in decode}}


# ---------------------------------------------------------------------------
# 27. moe_train: the MoE train step (item 5.3b)
# ---------------------------------------------------------------------------

# (a), (b): the train steps at the published width, float32, one unit each
# (granite: 2 layers of its 24; maverick: a dense block, then the MoE
# block, 2 of 48), batch 2, seq 128, remat as published. maverick's 128
# experts cut to 8 and its vocabulary to 32,768: 1.720 B parameters, ~27.5
# GB with their gradients and float32 AdamW state (the whole width at one
# unit is 18.55 B, ~297 GB); its grad_accum of 4 to 1 (batch 2 is not 4
# microbatches) and its bf16 AdamW state to float32 (the hold's seeded
# state, as the llama holds). Reckoned peak of (b), its first run's 20.6
# GB of params, m and v moved to host memory: 20.6 of inputs + 6.9 of
# gradients + 20.6 of outputs ~ 48 GB (kept on the card: ~70, too near
# the limit); (a) ~2.5 GB, kept on the card
MOE_TRAIN_HOLD = dict(batch=2, seq_len=128, n_layers=2)
MOE_TRAIN_CUTS = {"granite-moe-1b-a400m": {},
                  "llama4-maverick-400b-a17b": dict(
                      n_experts=8, vocab_size=32768, grad_accum=1,
                      opt_state_dtype="float32")}
# the CPU's K3 counts (tests/test_torch_moe_train_step.py: the smoke
# configs' with the holds' AdamW state; the width does not move them)
MOE_TRAIN_K3 = {"granite-moe-1b-a400m": {"compiled": 84, "per_block": 148},
                "llama4-maverick-400b-a17b": {"compiled": 164,
                                              "per_block": 293}}
# the time: granite as published (24 layers, bf16, remat), plain steps
MOE_TRAIN_TIME = dict(batch=4, seq_len=2048, steps=1)


def moe_train_cfg(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch),
                               n_layers=MOE_TRAIN_HOLD["n_layers"],
                               dtype="float32", **MOE_TRAIN_CUTS[arch])


@contextlib.contextmanager
def timing_experts():
    """While open, every expert product of ``models.moe`` (``_experts``,
    ``_experts_bwd``: the batched ``bmm``s and their layout copies) inside
    a ``moe_experts`` profiler range, for ``experts_device_ms``."""
    import torch
    from repro_torch.models import moe
    real = {name: getattr(moe, name) for name in ("_experts",
                                                  "_experts_bwd")}

    def ranged(fn):
        def call(*args):
            with torch.profiler.record_function("moe_experts"):
                return fn(*args)
        return call

    for name, fn in real.items():
        setattr(moe, name, ranged(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)


def experts_device_ms(prof) -> float:
    """The device time of the ``aten::bmm`` calls inside ``moe_experts``
    ranges (``timing_experts``) of a profile, in ms."""
    total = 0.0
    for e in prof.events():
        if e.name != "aten::bmm":
            continue
        up = e.cpu_parent
        while up is not None and up.name != "moe_experts":
            up = up.cpu_parent
        if up is not None:
            total += e.device_time_total
    return total / 1e3


def moe_train_time(seed: int) -> dict:
    """granite-moe-1b-a400m as published (24 layers, bf16, remat) takes
    plain train steps (``make_train_step``) at ``MOE_TRAIN_TIME``, on
    seeded parameters and AdamW state: ms a step (wall, after one warm),
    tokens/s, one step under the profiler (the card alone:
    ``profile_device``'s device ms, busy share and groups), one more with
    the host traced for the experts' ``bmm`` (``timing_experts``) and
    their share of the first's device time, and
    ``max_memory_allocated``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    arch = MOE_ARCHS[0]
    cfg = get_config(arch)
    b, s = MOE_TRAIN_TIME["batch"], MOE_TRAIN_TIME["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    params, opt = llama_train_state(cfg, seed)
    batch = token_batch(cfg, b, s, seed)
    step = make_train_step(cfg)
    loss = float(step(params, opt, batch)[2])
    if not np.isfinite(loss):
        raise AssertionError("moe_train time: loss not finite")
    ms = wall_ms(lambda: step(params, opt, batch),
                 iters=MOE_TRAIN_TIME["steps"], warmup=0)
    prof = profile_device(lambda: step(params, opt, batch), 1, warm=False)
    with timing_experts(), device_profile() as experts_prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    experts_ms = experts_device_ms(experts_prof)
    if not experts_ms:
        raise AssertionError("moe_train time: no expert bmm on the card")
    peak = torch.cuda.max_memory_allocated()
    r = {"config": f"{arch} as published ({config_file(arch)}): 24 layers, "
                   f"bfloat16, remat",
         **MOE_TRAIN_TIME, "tokens_per_step": b * s,
         "parameters": sum(x.numel() for x in
                           torch.utils._pytree.tree_leaves(params)),
         "loss": loss, "ms_per_step": ms,
         "tokens_per_s": b * s / (ms / 1e3), "profile": prof,
         "experts_bmm_ms": experts_ms,
         "experts_bmm_share_of_device":
             experts_ms / prof["device_ms_per_call"],
         "max_memory_allocated_gb": peak / 1e9}
    del params, opt, batch
    torch.cuda.empty_cache()
    return r


def phase_moe_train(seed: int) -> dict:
    """The MoE train step (item 5.3b): granite-moe-1b-a400m and
    llama4-maverick-400b-a17b through ``compile_arch(kind="train")``
    (``train_hold``) at ``MOE_TRAIN_HOLD`` (the cuts of
    ``MOE_TRAIN_CUTS``): K3 alone at the CPU's counts (``MOE_TRAIN_K3``),
    the compiled step bit for bit the per-block executor's and a rerun's,
    within ``LLAMA_TRAIN_TOL`` of the plain step, no host sync, the
    one-ulp last-wave control failing, the routes of the compiled and
    plain steps the same. Then granite's bf16 time (``moe_train_time``).
    Emitted as one ``moe_train`` line; returns (a)'s launch shapes for
    ``kernels_pim``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds, holds = {}, {}
    launches = dict.fromkeys(PIM_KEYS, 0)
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        h = MOE_TRAIN_HOLD
        holds[arch] = train_hold(
            seed, moe_train_cfg(arch), h["batch"], h["seq_len"],
            MOE_TRAIN_K3[arch], f"moe_train {arch} hold", hold_waves=False,
            on_host=arch != MOE_ARCHS[0], arch=arch, rerun=True,
            log_shapes=arch == MOE_ARCHS[0])
        for k in launches:
            launches[k] += holds[arch]["launches"][k]
        seconds[arch] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] moe_train {arch} "
              f"{seconds[arch]:.1f} s", file=sys.stderr, flush=True)
    shapes = holds[MOE_ARCHS[0]].pop("shapes")
    t0 = time.perf_counter()
    timing = moe_train_time(seed)
    seconds["time"] = time.perf_counter() - t0
    emit({"phase": "moe_train", "seconds": seconds,
          "configs": {a: config_file(a) for a in MOE_ARCHS},
          **{k: MOE_TRAIN_HOLD[k] for k in ("batch", "seq_len")},
          "reduced": {"holds": {
              "n_layers": {a: [dense_cfg(a).n_layers,
                               MOE_TRAIN_HOLD["n_layers"]]
                           for a in MOE_ARCHS},
              "dtype": ["bfloat16", "float32"],
              MOE_ARCHS[1]: {k: [getattr(dense_cfg(MOE_ARCHS[1]), k), v]
                             for k, v in MOE_TRAIN_CUTS[MOE_ARCHS[1]]
                             .items()}}},
          "tol": LLAMA_TRAIN_TOL, "holds": holds, "time": timing,
          "launches": launches})
    return {"launches": launches, "shapes": shapes}


# ---------------------------------------------------------------------------
# 28. recurrent: xlstm-350m and zamba2-7b for serving (item 5.4)
# ---------------------------------------------------------------------------

REC_ARCHS = ("xlstm-350m", "zamba2-7b")
# the holds at the published width in float32, cut in depth: xlstm to 4
# layers (2 units of an mLSTM and an sLSTM block), zamba2 to 13 (2 groups
# of 6 Mamba2 layers, each with the shared attention site, and the tail's
# 1)
REC_LAYERS = {"xlstm-350m": 4, "zamba2-7b": 13}
# (a) decode == prefill at the reference's own tolerance
# (tests/test_arch_smoke.py), and the chunked forms == the sequential ones
# at seq 512 (2 mLSTM chunks of 256, 4 Mamba2 chunks of 128) at the
# reference's (tests/test_attention_ssm.py)
REC_CONSISTENCY = dict(batch=2, seq_len=16, atol=2e-3, rtol=2e-2)
REC_CHUNKED = dict(batch=1, seq_len=512, atol=2e-4, rtol=1e-3)
# (b) the decode step expanded through the mapper at LLAMA_HOLD's batch
# and cache: the CPU's plan (products, K3 launches, K3 members) of the cut
# configs' structure (tests/test_torch_recurrent_schedules.py, at the
# smoke width: the width does not move it); the batched products (the
# mLSTM's two einsums, the Mamba2 conv's and output's) run natively, as
# the reference's lowering declines batched dot_generals, and zamba2's
# Mamba2 layers inside each group stay a folded loop of their own
REC_DECODE_PLAN = {"xlstm-350m": (29, 81, 95), "zamba2-7b": (15, 23, 23)}
REC_STEPS = 8
# (c) the contiguous lanes' pim engine against the jit engine, cut depth
REC_ENGINE = dict(batch=8, max_len=64, requests=12, lo=4, hi=16,
                  max_tokens=8)
# the time: bf16, not cut, through ServeEngine(paged=False): 8 requests of
# 16 prompt tokens and 8 output tokens in 8 lanes of 128 (23 ticks); then
# one make_prefill_step call at seq 512 (xlstm's sLSTM scans each token
# eagerly: 2048 takes ~10 s of the script's time), after a warm call at 64
REC_TIME = dict(batch=8, max_len=128, prompt=16, max_tokens=8)
REC_PREFILL = dict(batch=1, seq_len=512)


def recurrent_model(arch: str, seed: int, **changes):
    """(config, ``DecoderLM`` on the card from ``seed``) of ``arch``'s
    published config with ``changes``."""
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    cfg = dataclasses.replace(get_config(arch), **changes)
    return cfg, DecoderLM(cfg, device=DEVICE).init(seed)


def recurrent_consistency(cfg, model, seed: int) -> dict:
    """(a): greedy decode logits against the full-sequence logits position
    by position (``REC_CONSISTENCY``), and the block's chunked form
    against its sequential one at ``REC_CHUNKED`` (xlstm: layer 0's
    mLSTM; zamba2: layer 0's Mamba2), on the module's own tree."""
    import torch
    from repro_torch.mapper.executor import full_float32
    from repro_torch.models import ssm, transformer
    c, k = REC_CONSISTENCY, REC_CHUNKED
    tree = model.shared_stacked_params()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    toks = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq_len"]),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    tol = dict(atol=c["atol"], rtol=c["rtol"])
    with torch.no_grad(), full_float32():
        full = transformer.apply(cfg, tree, toks)
        cache = model.init_cache(c["batch"], c["seq_len"])
        worst = 0.0
        for t in range(c["seq_len"]):
            lg, cache = transformer.decode_step(
                cfg, tree, cache, toks[:, t],
                torch.tensor(t, dtype=torch.int32, device=DEVICE))
            torch.testing.assert_close(lg, full[:, t], **tol)
            worst = max(worst, float((lg - full[:, t]).abs().max()))
        x = torch.randn((k["batch"], k["seq_len"], cfg.d_model),
                        generator=gen, device=DEVICE)
        blk = model.layers[0]
        if cfg.block_pattern == "xlstm":
            seq = ssm.mlstm_seq(x, blk, cfg.n_heads)
            chk = ssm.mlstm_seq_chunked(x, blk, cfg.n_heads)
            chunks = k["seq_len"] // 256
        else:
            kw = dict(ssm_state=cfg.ssm_state, headdim=cfg.mamba_headdim)
            seq = ssm.mamba2_seq(x, blk, **kw)
            chk = ssm.mamba2_seq_chunked(x, blk, **kw)
            chunks = k["seq_len"] // 128
        torch.testing.assert_close(chk, seq, atol=k["atol"], rtol=k["rtol"])
    return {"decode_vs_prefill": {**c, "max_abs_err": worst},
            "chunked_vs_sequential": {
                **k, "block": "mlstm" if cfg.block_pattern == "xlstm"
                else "mamba2", "chunks": chunks,
                "max_abs_err": float((chk - seq).abs().max())}}


def recurrent_hold(seed: int, arch: str, cfg, model,
                   weight_dtype: str) -> dict:
    """(b): ``compile_arch(arch, "serve", expand_scans=True)`` at the cut
    ``cfg`` and ``LLAMA_HOLD``'s batch and cache, on the module's tree:
    every count set to 0 just before one compiled step and one executor
    run, read just after, against the CPU's plan (``REC_DECODE_PLAN``);
    the compiled step bit for bit the executor's, and against the plain
    step (fp32: ``prog.verify``; int8: ``run_fake_quant_plain``) at
    ``LLAMA_TOL``; ``REC_STEPS`` greedy steps with identical tokens; no
    host sync in a compiled step; the control: the last K3 wave one ulp
    off must break the bit equality."""
    import torch
    from repro_torch import mapper
    from repro_torch.launch import make_serve_step
    from repro_torch.mapper.executor import (full_float32, max_deviation,
                                             run_fake_quant_plain)
    b, s = LLAMA_HOLD["batch"], LLAMA_HOLD["seq_len"]
    mm = "k1" if weight_dtype == "fp32" else "k5"
    label = f"recurrent {arch} {weight_dtype}"
    params = model.shared_stacked_params()
    cache = model.init_cache(b, s)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 101)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    pos0 = torch.tensor(0, dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    prog = mapper.compile_arch(arch, "serve", batch=b, seq_len=s,
                               weight_dtype=weight_dtype, config=cfg,
                               expand_scans=True)
    compile_s = time.perf_counter() - t0
    n_mm, n_k3, n_calls = REC_DECODE_PLAN[arch]
    ex = mapper.ScheduleExecutor(prog.schedule)
    step = make_serve_step(cfg)
    leaves = torch.utils._pytree.tree_leaves

    def plain(params, cache, tok, pos):
        if weight_dtype == "fp32":
            return step(params, cache, tok, pos)
        return run_fake_quant_plain(prog.schedule, params, cache, tok, pos)

    with torch.no_grad(), full_float32():
        reset_counts()
        with recording_launches() as prog_log:
            out = prog(params, cache, tok, pos0)
        prog_counts = read_counts()
        with recording_launches() as ex_log:
            ex_out = ex.run(params, cache, tok, pos0)
        torch.cuda.synchronize()
        counts = read_counts()
        ex_counts = {k: counts[k] - prog_counts[k] for k in counts}
        blocks = prog.placed_blocks
        want = ({"k1": 0, "k2": 0, "k3": n_k3, "k5": 0, mm: n_mm},
                {"k1": 0, "k2": blocks, "k3": n_calls, "k5": 0})
        if (prog_counts, ex_counts) != want or (
                prog.matmul_launches, prog.eltwise_launches,
                prog.eltwise_calls) != (n_mm, n_k3, n_calls):
            raise AssertionError(f"{label}: launches {prog_counts} "
                                 f"compiled, {ex_counts} per-block; want "
                                 f"{want}")
        logits = out[0]
        if logits.shape != (b, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{label}: logits {tuple(logits.shape)} "
                                 f"not finite")
        if not all(torch.equal(x, y)
                   for x, y in zip(leaves(out), leaves(ex_out))):
            raise AssertionError(f"{label}: the compiled step differs from "
                                 f"the per-block executor's")
        del ex_out
        if weight_dtype == "fp32":
            vs_plain = prog.verify(params, cache, tok, pos0, **LLAMA_TOL)
        else:
            vs_plain = max_deviation(out, plain(params, cache, tok, pos0),
                                     **LLAMA_TOL)
        c_cache = p_cache = cache
        c_tok = p_tok = tok
        worst = 0.0
        for i in range(REC_STEPS):
            pos = torch.tensor(i, dtype=torch.int32, device=DEVICE)
            lc, c_cache = prog(params, c_cache, c_tok, pos)
            lp, p_cache = plain(params, p_cache, p_tok, pos)
            worst = max(worst, max_deviation(lc, lp, **LLAMA_TOL))
            c_tok = lc.argmax(-1).to(torch.int32)
            p_tok = lp.argmax(-1).to(torch.int32)
            if not torch.equal(c_tok, p_tok):
                raise AssertionError(f"{label}: step {i} tokens differ")
        state_dev = max_deviation(c_cache, p_cache, **LLAMA_TOL)
        del c_cache, p_cache
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prog(params, cache, tok, pos0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # the control: the last K3 wave one ulp off
        with recording_helpers(fault=ulp_up, key="k3", index=n_k3 - 1):
            bad = prog(params, cache, tok, pos0)
        differing = sum(int((x != y).sum())
                        for x, y in zip(leaves(bad), leaves(out)))
        if not differing:
            raise AssertionError(f"{label}: the last K3 wave one ulp off "
                                 f"passes the bit-for-bit hold")
    shapes = {mm: prog_log[mm], "k2": ex_log["k2"],
              "k3": prog_log["k3_forms"]}
    r = {"weight_dtype": weight_dtype, "launches": counts,
         "launches_per_step": {"compiled": prog_counts,
                               "per_block": ex_counts},
         "placed_blocks": blocks, "nodes": len(prog.schedule.graph.nodes),
         "subarrays": prog.schedule.placement.n_subarrays,
         "expanded": prog.schedule.graph.groups, "compile_s": compile_s,
         "compiled_bit_equal_executor": True,
         "plain": ("decode_step" if weight_dtype == "fp32" else
                   "run_fake_quant_plain: the plain step over the stored "
                   "weights"),
         "max_abs_err_vs_plain": vs_plain, "greedy_steps": REC_STEPS,
         "greedy_max_abs_err": worst, "greedy_tokens_identical": True,
         "state_max_abs_err": state_dev, "host_syncs_in_step": 0,
         "control_last_wave_one_ulp_elements_differing": differing}
    del params, cache, out, prog, ex, bad
    return {"row": r, "shapes": shapes, "launches": counts}


def recurrent_engine(cfg, model, seed: int) -> dict:
    """(c): ``ServeEngine(paged=False, backend="pim")`` against the jit
    engine on ``REC_ENGINE``'s requests (more than the lanes: recycled
    mid-stream): tokens identical; each tick one K1 (the LM head) and
    ``LLAMA_K3`` K3 launches (the final norm), the folded stack native,
    the counts set to 0 just before the pim run and read just after."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    e = REC_ENGINE
    prompts = make_prompts(np.random.default_rng(seed + 102),
                           e["requests"], e["lo"], e["hi"], cfg.vocab_size)

    def run(backend):
        eng = ServeEngine(cfg, model, paged=False, batch=e["batch"],
                          max_len=e["max_len"], backend=backend,
                          device=DEVICE)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=e["max_tokens"]))
        reset_counts()
        out = {r.rid: list(r.out) for r in eng.run()}
        return eng, out, read_counts()

    with torch.no_grad():
        eng, got, counts = run("pim")
        _, want, _ = run("jit")
    if got != want or len(got) != e["requests"]:
        raise AssertionError(f"recurrent {cfg.name} pim engine: tokens "
                             f"differ from the jit engine's")
    ticks = eng._tick
    want_counts = {"k1": ticks, "k2": 0, "k3": LLAMA_K3 * ticks, "k5": 0}
    if counts != want_counts:
        raise AssertionError(f"recurrent {cfg.name} pim engine: launches "
                             f"{counts}, want {want_counts}")
    row = {**e, "ticks": ticks, "tokens_identical_to_jit": True,
           "launches_per_tick": {k: v / ticks for k, v in counts.items()
                                 if v},
           "nodes": len(eng.schedule.graph.nodes),
           "subarrays": eng.schedule.placement.n_subarrays}
    del eng
    return {"row": row, "launches": counts}


def recurrent_time(arch: str, seed: int) -> dict:
    """The published config as it is (bf16, every layer) through
    ``ServeEngine(paged=False)`` at ``REC_TIME``: ms a tick, decode
    tokens/s, then 3 ticks under the profiler (device ms, kernels and the
    busy share a tick), and one ``make_prefill_step`` call at
    ``REC_PREFILL`` after a warm call at 64 tokens (ms, tokens/s); peak
    memory."""
    import torch
    from repro_torch import obs
    from repro_torch.launch import make_prefill_step
    from repro_torch.serve import Request, ServeEngine
    t = REC_TIME
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = recurrent_model(arch, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = make_prompts(np.random.default_rng(seed + 103), t["batch"],
                           t["prompt"], t["prompt"], cfg.vocab_size)
    eng = ServeEngine(cfg, model, paged=False, batch=t["batch"],
                      max_len=t["max_len"], device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=t["max_tokens"]))
    tr = obs.enable()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    obs.disable()
    if len(done) != len(prompts) or any(
            len(r.out) != t["max_tokens"]
            or not all(0 <= x < cfg.vocab_size for x in r.out)
            for r in done):
        raise AssertionError(f"recurrent time {arch}: not every request "
                             f"finished with valid tokens")
    decode_s = sum(e.dur_s for e in tr.spans(name="decode:tick"))
    generated = sum(len(r.out) for r in done)
    feed = np.zeros(t["batch"], np.int32)
    prof = profile_device(lambda: eng.step(1, feed), calls=3)
    pre = make_prefill_step(cfg)
    p = REC_PREFILL
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 104)
    toks = torch.randint(0, cfg.vocab_size, (p["batch"], p["seq_len"]),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    warm = pre(eng.params, {"tokens": toks[:, :64]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = pre(eng.params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if last.shape != (p["batch"], cfg.vocab_size) or not bool(
            torch.isfinite(last.float()).all()) or not bool(
            torch.isfinite(warm.float()).all()):
        raise AssertionError(f"recurrent time {arch}: prefill logits not "
                             f"finite")
    row = {"config": f"{arch} published ({config_file(arch)}), bf16, "
                     f"{cfg.n_layers} layers",
           **t, "init_s": init_s, "ticks": eng._tick,
           "generated_tokens": generated, "wall_s": wall_s,
           "decode_s": decode_s, "decode_tok_per_s": generated / decode_s,
           "tick_ms": decode_s / eng._tick * 1e3,
           "profile": prof,
           "prefill": {**p, "ms": prefill_s * 1e3,
                       "tok_per_s": p["batch"] * p["seq_len"] / prefill_s},
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    del eng, done, model, warm, last
    torch.cuda.empty_cache()
    return row


def phase_recurrent(seed: int) -> dict:
    """The recurrent families for serving (item 5.4, the serve half):
    xlstm-350m (alternating mLSTM / sLSTM blocks) and zamba2-7b (Mamba2
    layers, a weight-tied attention + MLP block every 6). Holds at the
    published width in float32, cut to ``REC_LAYERS``, TF32 off: (a)
    decode == prefill and chunked == sequential
    (``recurrent_consistency``); (b) the decode step expanded through the
    mapper on both grids (``recurrent_hold``); (c) the contiguous lanes'
    pim engine against jit (``recurrent_engine``). Time (bf16, not cut):
    ``recurrent_time``. Emitted as one ``recurrent`` line."""
    import gc as gc_mod
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    launches = {k: 0 for k in PIM_KEYS}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] recurrent {name} "
              f"{seconds[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    holds, shapes = {}, {"fp32": {}, "int8": {}}
    for arch in REC_ARCHS:
        cfg, model = part(f"init {arch}", lambda arch=arch: recurrent_model(
            arch, seed, n_layers=REC_LAYERS[arch], dtype="float32"))
        h = {"consistency": part(f"consistency {arch}",
                                 lambda: recurrent_consistency(cfg, model,
                                                               seed))}
        for grid in ("fp32", "int8"):
            d = part(f"decode {arch} {grid}", lambda grid=grid:
                     recurrent_hold(seed, arch, cfg, model, grid))
            h[f"decode_{grid}"] = d["row"]
            for key, rows in d["shapes"].items():
                shapes[grid].setdefault(key, []).extend(rows)
            for k in launches:
                launches[k] += d["launches"][k]
        e = part(f"pim_engine {arch}", lambda: recurrent_engine(cfg, model,
                                                                seed))
        h["pim_engine"] = e["row"]
        for k in launches:
            launches[k] += e["launches"][k]
        holds[arch] = h
        del model
        gc_mod.collect()
        torch.cuda.empty_cache()
    timing = {arch: part(f"time {arch}", lambda arch=arch: recurrent_time(
        arch, seed)) for arch in REC_ARCHS}
    emit({"phase": "recurrent", "seconds": seconds,
          "configs": {a: config_file(a) for a in REC_ARCHS},
          "reduced": {"holds": {"n_layers": REC_LAYERS, "dtype": "float32"},
                      "time": "none"},
          "holds": holds, "time": timing, "launches": launches})
    return {"launches": launches, "shapes": shapes}


# ---------------------------------------------------------------------------
# 29. recurrent_train: xlstm-350m and zamba2-7b's train step (item 5.4b)
# ---------------------------------------------------------------------------

# the holds at the published width in float32, cut in depth: xlstm 4 layers at batch 1, seq 512 (two mLSTM chunks,
# 512 sLSTM tokens a unit); zamba2 13 layers (2 groups of 6 and the
# tail's 1) at batch 2, seq 256 (two Mamba2 chunks) with its published
# grad_accum=2. zamba2's 5.8 GB of f32 params and ~17.5 GB with AdamW's
# state: its first run's outputs go to host memory, as llama3-8b's
REC_TRAIN_HOLDS = {"xlstm-350m": dict(n_layers=4, batch=1, seq_len=512),
                   "zamba2-7b": dict(n_layers=13, batch=2, seq_len=256)}
# the CPU's K3 counts (tests/test_torch_recurrent_train_step.py: the
# smoke width in the holds' structure; the width does not move them)
REC_TRAIN_K3 = {"xlstm-350m": {"compiled": 142, "per_block": 256},
                "zamba2-7b": {"compiled": 194, "per_block": 354}}
# the time, bf16 plain steps, in the script's shared time limit: xlstm-350m
# not cut at batch 8, seq 32 (a cold step at seq 256 took 128 s under the
# profiler, at 64 30 s: the sLSTM's eager tokens, forward, recomputed and
# transposed, ~2,000 launches a token); zamba2-7b at batch 2, seq 512 (at
# 2048 a cold step took 40 s) in whole groups of 6
# (no tail), as many as fit DENSE_MEMORY_LIMIT by REC_TRAIN_BYTES a
# parameter (bf16 params and gradients, the f32 microbatch sum, f32 m and
# v, and AdamW's f32 temporaries of the stacked leaves: 5 and 4 groups
# ran out of the card in AdamW, 67.6 and 69.2 GB allocated)
REC_TRAIN_TIME = {"xlstm-350m": dict(batch=8, seq_len=32),
                  "zamba2-7b": dict(batch=2, seq_len=512)}
REC_TRAIN_BYTES = 36


def rec_train_groups() -> int:
    """zamba2-7b's groups for the bf16 time: the most whole groups whose
    parameters at ``REC_TRAIN_BYTES`` each fit ``DENSE_MEMORY_LIMIT``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("zamba2-7b")
    groups = 1
    while groups < transformer.n_units(cfg):
        nxt = dataclasses.replace(cfg, n_layers=6 * (groups + 1))
        n = sum(math.prod(s) for s in transformer.leaf_shapes(nxt).values())
        if n * REC_TRAIN_BYTES > DENSE_MEMORY_LIMIT:
            break
        groups += 1
    return groups


def rec_train_cfg(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype="float32",
                               n_layers=REC_TRAIN_HOLDS[arch]["n_layers"])


def rec_train_time(arch: str, seed: int) -> dict:
    """``arch``'s bf16 plain train step (``make_train_step``) at
    ``REC_TRAIN_TIME`` on seeded parameters and AdamW state: one step,
    cold, under the profiler (``profile_device``: its wall ms, device ms,
    busy share, kernels, groups), tokens/s and
    ``max_memory_allocated``. xlstm-350m as published; zamba2-7b cut to
    ``rec_train_groups()`` groups."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    cfg = get_config(arch)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=6 * rec_train_groups())
    t = REC_TRAIN_TIME[arch]
    b, s = t["batch"], t["seq_len"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt = llama_train_state(cfg, seed)
    batch = token_batch(cfg, b, s, seed)
    step = make_train_step(cfg)
    out = []
    # one step, under the profiler (the card alone): its wall is the
    # step's; a step costs xlstm ~1 min of eager launches
    prof = profile_device(lambda: out.append(step(params, opt, batch)[2]),
                          1, warm=False)
    loss = float(out[0])
    if not np.isfinite(loss):
        raise AssertionError(f"recurrent_train time {arch}: loss not finite")
    ms = prof["wall_ms_per_call"]
    peak = torch.cuda.max_memory_allocated()
    r = {"config": f"{arch} ({config_file(arch)}): {cfg.n_layers} of "
                   f"{get_config(arch).n_layers} layers, bfloat16, remat "
                   f"{cfg.remat}, grad_accum {cfg.grad_accum}",
         **t, "tokens_per_step": b * s,
         "parameters": sum(x.numel() for x in
                           torch.utils._pytree.tree_leaves(params)),
         "loss": loss, "ms_per_step": ms,
         "tokens_per_s": b * s / (ms / 1e3), "profile": prof,
         "max_memory_allocated_gb": peak / 1e9}
    del params, opt, batch
    torch.cuda.empty_cache()
    if peak >= DENSE_MEMORY_LIMIT:
        raise AssertionError(f"recurrent_train time {arch}: {peak / 1e9} "
                             f"GB allocated")
    return r


def phase_recurrent_train(seed: int) -> dict:
    """The recurrent train step (item 5.4b): xlstm-350m and zamba2-7b
    through ``compile_arch(kind="train")`` (``train_hold``) at
    ``REC_TRAIN_HOLDS`` (f32, TF32 off): K3 alone at the CPU's counts
    (``REC_TRAIN_K3``), the compiled step bit for bit the per-block
    executor's and a rerun's, within ``LLAMA_TRAIN_TOL`` of the plain
    step (loss, params, m, v), no host sync, the one-ulp last-wave
    control failing; zamba2's shared block (rope ``"none"``) trains here
    on the card. Then the bf16 time (``rec_train_time``). Emitted as one
    ``recurrent_train`` line; returns xlstm's launch shapes for
    ``kernels_pim``."""
    import gc as gc_mod
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds, holds = {}, {}
    launches = dict.fromkeys(PIM_KEYS, 0)
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        h = REC_TRAIN_HOLDS[arch]
        holds[arch] = train_hold(
            seed, rec_train_cfg(arch), h["batch"], h["seq_len"],
            REC_TRAIN_K3[arch], f"recurrent_train {arch} hold",
            hold_waves=False, on_host=arch != REC_ARCHS[0], arch=arch,
            rerun=True, log_shapes=arch == REC_ARCHS[0])
        for k in launches:
            launches[k] += holds[arch]["launches"][k]
        gc_mod.collect()
        torch.cuda.empty_cache()
        seconds[arch] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] recurrent_train {arch} "
              f"{seconds[arch]:.1f} s", file=sys.stderr, flush=True)
    shapes = holds[REC_ARCHS[0]].pop("shapes")
    timing = {}
    for arch in REC_ARCHS:
        t0 = time.perf_counter()
        timing[arch] = rec_train_time(arch, seed)
        seconds[f"time {arch}"] = time.perf_counter() - t0
        print(f"[{time.perf_counter() - T0:.1f} s] recurrent_train time "
              f"{arch} {seconds[f'time {arch}']:.1f} s", file=sys.stderr,
              flush=True)
    emit({"phase": "recurrent_train", "seconds": seconds,
          "configs": {a: config_file(a) for a in REC_ARCHS},
          "holds_shape": REC_TRAIN_HOLDS,
          "reduced": {"holds": {"n_layers": {
              a: [dense_cfg(a).n_layers, REC_TRAIN_HOLDS[a]["n_layers"]]
              for a in REC_ARCHS}, "dtype": ["bfloat16", "float32"]},
              "time": {"zamba2-7b": {"n_layers": [
                  dense_cfg("zamba2-7b").n_layers,
                  6 * rec_train_groups()]},
                  "seq_len": {a: [{"xlstm-350m": 256, "zamba2-7b": 2048}[a],
                                  REC_TRAIN_TIME[a]["seq_len"]]
                              for a in REC_ARCHS}}},
          "tol": LLAMA_TRAIN_TOL, "holds": holds, "time": timing,
          "launches": launches})
    return {"launches": launches, "shapes": shapes}


def sums(rows) -> dict:
    """Times and bounds of one run's launches: each distinct shape's
    numbers times its count, summed (each shape's bound the larger of its
    two times); the largest error."""
    def total(key):
        return sum(r[key] * r["count"] for r in rows)

    t_bytes, t_ops = total("bytes_ms"), total("ops_ms")
    # K3's rows add its graph and host times and its host syncs
    extra = ("device_graph_ms", "library_graph_ms", "host_us",
             "library_host_us", "addcmul_ms", "host_syncs")
    return {"max_abs_err": max(r["max_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"),
            **{k: total(k) for k in extra if all(k in r for r in rows)}}


def pim_entry(ids, key, by_path, rows) -> dict:
    """A PIM kernel's kernels-line entry: its launches summed over the
    main paths (forward and backward; ``launches_by_path`` splits them),
    the times of one batch-256 serve forward (``pim_lenet``) and, under
    ``pim_train``, ``backward``, ``pim_llama`` and ``pim_llama_train``,
    those of one batch-64 train step (K2: one executor step), of
    ``pim_grad``'s backward (K2: the executor's backward there), of one
    llama3-8b decode step (K2: one executor step) and of one llama3-8b
    train step (bf16, 2 layers, seq 2048; K3 alone launches there); under
    ``pim_llama_pipe``, those of one partitioned decode step of the hold
    (f32, 2 layers unrolled: the layers' products and waves). ``pim_pipe``
    (LeNet-5 through the partitions) adds launches only: its stages run
    the shapes ``pim_lenet``, ``pim_train`` and ``backward`` time."""
    launches = {path: counts[key] for path, counts in by_path.items()
                if path != "pim_grad_backward"}
    backward = rows["pim_grad_backward"].get(key)
    return {**ids, "launches": sum(launches.values()),
            **sums(rows["pim_lenet"][key]),
            "launches_by_path": {**launches, "pim_grad_backward":
                                 by_path["pim_grad_backward"][key]},
            "pim_train": sums(rows["pim_train"][key]),
            "backward": sums(backward) if backward else None,
            "pim_llama": sums(rows["pim_llama"][key]),
            "pim_llama_train": (sums(rows["pim_llama_train"][key])
                                if rows["pim_llama_train"].get(key)
                                else None),
            "pim_llama_pipe": (sums(rows["pim_llama_pipe"][key])
                               if rows["pim_llama_pipe"].get(key)
                               else None),
            "dense_variants": (sums(rows["dense_variants"][key])
                               if rows["dense_variants"].get(key)
                               else None),
            "io_variants": (sums(rows["io_variants"][key])
                            if rows["io_variants"].get(key) else None),
            "moe_variants": (sums(rows["moe_variants"][key])
                             if rows["moe_variants"].get(key) else None),
            "moe_train": (sums(rows["moe_train"][key])
                          if rows["moe_train"].get(key) else None),
            "recurrent": (sums(rows["recurrent"][key])
                          if rows["recurrent"].get(key) else None),
            "recurrent_train": (sums(rows["recurrent_train"][key])
                                if rows["recurrent_train"].get(key)
                                else None)}


def with_counts(shapes: dict) -> dict:
    """Logged launch shapes as ``phase_kernels_pim`` rows: each distinct
    shape once, named by itself, with its count; each distinct K3 wave
    form once, named by its order of first launch."""
    return {key: [(f"wave {i}", form, n) for i, (form, n) in enumerate(
        collections.Counter(rows).items())] if key == "k3" else
            [("x".join(map(str, row[:-1])), *row) for row in counted(rows)]
            for key, rows in shapes.items()}


def timed_elsewhere(shapes: list, timed: list) -> tuple:
    """``shapes`` (``with_counts`` K1 or K5 rows) split into the rows of
    ``timed`` (another path's timed rows) at the same launch shape, each
    with this path's count, and the shapes left to time."""
    done = {(r["G"], r["col_groups"], r["M"], r["K"], r["N"]): r
            for r in timed}
    return ([{**done[tuple(row[1:6])], "count": row[6]}
             for row in shapes if tuple(row[1:6]) in done],
            [row for row in shapes if tuple(row[1:6]) not in done])


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    phase_build()
    k4 = phase_kernels(args.seed)
    k6 = phase_kernels_q(args.seed)
    attn = phase_kernels_attn(args.seed)
    pim_fp = phase_pim_fp(args.seed)
    lenet_run = phase_pim_lenet(args.seed, PIM_SERVE)
    rows = {"pim_lenet": phase_kernels_pim(
        args.seed, lenet_run["shapes"], "pim_lenet", PIM_SERVE[0][1],
        wave=True)}
    train = phase_pim_train(args.seed)
    rows["pim_train"] = phase_kernels_pim(
        args.seed, with_counts(train["shapes"]), "pim_train",
        TRAIN_BATCHES[0])
    grad = phase_pim_grad(args.seed)
    rows["pim_grad_backward"] = phase_kernels_pim_backward(args.seed, grad)
    lenet_q = phase_pim_lenet(args.seed, Q_SERVE)
    rows["pim_lenet_q"] = phase_kernels_pim_q(
        args.seed, lenet_q["shapes"]["k5"], "pim_lenet_q", Q_SERVE[0][1])
    train_q = phase_pim_train_q(args.seed, train)
    rows["pim_train_q"] = phase_kernels_pim_q(
        args.seed, with_counts(train_q["shapes"])["k5"], "pim_train_q",
        TRAIN_BATCHES[0])
    grad_q = phase_pim_grad(args.seed, Q_TRAIN_DTYPE)
    llama = phase_pim_llama(args.seed)
    llama_train = phase_pim_llama_train(args.seed)
    rows["pim_llama_train"] = {"k3": llama_train["k3_rows"]}
    llama_long = phase_pim_llama_long(args.seed)
    llama_pipe = phase_pim_llama_pipe(args.seed)
    pipe_run = phase_pim_pipe(args.seed, train["ms_per_step"])
    rows["pim_llama"] = phase_kernels_pim(
        args.seed, with_counts(llama["fp32"]["shapes"]), "pim_llama",
        LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rows["pim_llama_q"] = phase_kernels_pim_q(
        args.seed, with_counts({"k5": llama["int8"]["shapes"]["k5"]})["k5"],
        "pim_llama_q", LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    # the partitioned decode step's own launch shapes: the layers'
    # products (K1, K5) and the waves the expansion brings to top level;
    # the LM head's launch is pim_llama's shape, timed there
    pipe_shapes = with_counts({key: llama_pipe["fp32"]["shapes"][key]
                               for key in ("k1", "k2", "k3")})
    head, pipe_shapes["k1"] = timed_elsewhere(pipe_shapes["k1"],
                                              rows["pim_llama"]["k1"])
    rows["pim_llama_pipe"] = phase_kernels_pim(
        args.seed, pipe_shapes, "pim_llama_pipe", LLAMA_HOLD["batch"],
        iters=3, plain_iters=1)
    rows["pim_llama_pipe"]["k1"] += head
    head, pipe_q = timed_elsewhere(
        with_counts({"k5": llama_pipe["int8"]["shapes"]["k5"]})["k5"],
        rows["pim_llama_q"])
    rows["pim_llama_pipe_q"] = phase_kernels_pim_q(
        args.seed, pipe_q, "pim_llama_pipe_q", LLAMA_HOLD["batch"],
        iters=3, plain_iters=1) + head
    by_path = {"pim_lenet": lenet_run["launches"],
               "pim_train": {k: train["launches"][k]
                             + train["executor_launches"][k]
                             for k in PIM_KEYS},
               "pim_grad": {k: grad["forward"][k] + grad["backward"][k]
                            for k in PIM_KEYS},
               "pim_grad_executor": {
                   k: grad["executor"]["launches_forward"][k]
                   + grad["executor"]["launches_backward"][k]
                   for k in PIM_KEYS},
               "pim_lenet_q": lenet_q["launches"],
               "pim_train_q": train_q["launches"],
               "pim_grad_q": {k: grad_q["forward"][k] + grad_q["backward"][k]
                              for k in PIM_KEYS},
               "pim_llama": llama["fp32"]["launches"],
               "pim_llama_q": llama["int8"]["launches"],
               "pim_llama_train": llama_train["launches"],
               "pim_llama_long": llama_long["launches"],
               "pim_llama_pipe": llama_pipe["launches"],
               "pim_pipe": pipe_run["launches"],
               "pim_grad_backward": {
                   k: grad["backward"][k]
                   + grad["executor"]["launches_backward"][k]
                   for k in PIM_KEYS}}
    phase_parity(args.seed)
    serve = phase_serve(args.seed)
    phase_profile(serve["engine"], args.seed)
    kvq = phase_serve_kvq(serve["engine"].model, args.seed)
    # 10-token prompts replayed: the last 10 ticks (2 of replay, 8 of
    # generation) run under the profiler; each replayed tick costs ~0.24 s
    # of the script's time, and the profiler's reduction of a window ~1 s
    # a tick more
    phase_profile(kvq["engine"], args.seed, "profile_kvq", prompt_len=10,
                  warm_ticks=8)
    serve_pim = phase_serve_pim(serve["engine"].model, args.seed)
    by_path["serve_pim"] = {k: serve_pim["launches"][k] for k in PIM_KEYS}
    # the serve phases' bf16 model (16 GB) goes before the variants' time
    # runs, which need up to ~74 GB
    del serve["engine"], kvq["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    dense = phase_dense_variants(args.seed)
    by_path["dense_variants"] = {k: dense["launches"][k] for k in PIM_KEYS}
    rows["dense_variants"] = phase_kernels_pim(
        args.seed, with_counts(dense["shapes"]["fp32"]), "dense_variants",
        LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rows["dense_variants_q"] = phase_kernels_pim_q(
        args.seed, with_counts({"k5": dense["shapes"]["int8"]["k5"]})["k5"],
        "dense_variants_q", LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    io = phase_io_variants(args.seed)
    by_path["io_variants"] = {k: io["launches"][k] for k in PIM_KEYS}
    rows["io_variants"] = phase_kernels_pim(
        args.seed, with_counts(io["shapes"]["fp32"]), "io_variants",
        LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rows["io_variants_q"] = phase_kernels_pim_q(
        args.seed, with_counts({"k5": io["shapes"]["int8"]["k5"]})["k5"],
        "io_variants_q", LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    moe = phase_moe_variants(args.seed)
    by_path["moe_variants"] = {k: moe["launches"][k] for k in PIM_KEYS}
    rows["moe_variants"] = phase_kernels_pim(
        args.seed, with_counts(moe["shapes"]["fp32"]), "moe_variants",
        LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rows["moe_variants_q"] = phase_kernels_pim_q(
        args.seed, with_counts({"k5": moe["shapes"]["int8"]["k5"]})["k5"],
        "moe_variants_q", LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    moe_train = phase_moe_train(args.seed)
    by_path["moe_train"] = moe_train["launches"]
    rows["moe_train"] = phase_kernels_pim(
        args.seed, with_counts(moe_train["shapes"]), "moe_train",
        MOE_TRAIN_HOLD["batch"], iters=3, plain_iters=1)
    rec = phase_recurrent(args.seed)
    by_path["recurrent"] = rec["launches"]
    rows["recurrent"] = phase_kernels_pim(
        args.seed, with_counts(rec["shapes"]["fp32"]), "recurrent",
        LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rows["recurrent_q"] = phase_kernels_pim_q(
        args.seed, with_counts({"k5": rec["shapes"]["int8"]["k5"]})["k5"],
        "recurrent_q", LLAMA_HOLD["batch"], iters=3, plain_iters=1)
    rec_train = phase_recurrent_train(args.seed)
    by_path["recurrent_train"] = rec_train["launches"]
    rows["recurrent_train"] = phase_kernels_pim(
        args.seed, with_counts(rec_train["shapes"]), "recurrent_train",
        REC_TRAIN_HOLDS[REC_ARCHS[0]]["batch"], iters=3, plain_iters=1)
    print(gpu_name_and_power_limit(), flush=True)

    def entry(ids, launches, r):
        # ms, plain_ms, library_ms: CUDA events over calls made back to
        # back; the *_device_graph_ms beside them: the same calls replayed
        # from a CUDA graph, with no host in the loop
        return {**ids, "launches": launches, "max_abs_err": r["max_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "device_graph_ms": r["kernel_graph_ms"],
                "plain_device_graph_ms": r["plain_graph_ms"],
                "library_device_graph_ms": r["library_graph_ms"]}

    # the PIM paths' kernels per call under the profiler: one batch-256
    # serve forward, one batch-64 train step, one pim_grad step
    paths = {"pim_lenet": lenet_run, "pim_train": train, "pim_grad": grad,
             "pim_llama_train": llama_train["time"],
             "pim_llama_long": llama_long["time"]}
    long_bf16 = next(r for r in attn["results"] if r["dtype"] == "bfloat16"
                     and r["shape"]["S"] == ATTN_LLAMA_SHAPES[-1][1])
    k5_launches = {path: by_path[path]["k5"]
                   for path in ("pim_lenet_q", "pim_train_q", "pim_grad_q",
                                "pim_llama_q", "pim_llama_pipe",
                                "serve_pim", "dense_variants",
                                "io_variants", "moe_variants",
                                "recurrent")}
    k4_bf16 = k4["bfloat16"]
    k6_serve = k6[(SERVE_KV_DTYPE, "bfloat16")]
    k4_launches = {"serve": serve["launches"],
                   "serve_pim": serve_pim["launches"]["k4"],
                   "dense_variants": dense["launches"]["k4"],
                   "io_variants": io["launches"]["k4"],
                   "moe_variants": moe["launches"]["k4"]}
    k6_launches = {"serve_kvq": kvq["launches"],
                   "serve_pim": serve_pim["launches"]["k6"],
                   "dense_variants": dense["launches"]["k6"],
                   "io_variants": io["launches"]["k6"],
                   "moe_variants": moe["launches"]["k6"]}

    def by_rep(kernel, dtype):
        # K4 / K6 at the variants' reps (dense_variants: 5, 8, 16;
        # io_variants: 1, 6; moe_variants: 2): the event times
        return {str(r["rep"]): {k: row[k] for k in (
            "max_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms",
            "kernel_graph_ms")}
            for r in (*dense["reps"].values(), *io["reps"].values(),
                      *moe["reps"].values())
            for row in r["results"]
            if row["kernel"] == kernel and row["dtype"] == dtype}
    emit({"kernels": [
        {**entry(K4, sum(k4_launches.values()), k4_bf16),
         "launches_by_path": k4_launches,
         "by_rep": {q: by_rep("K4", q) for q in ("bfloat16", "float32")},
         "n_split": k4_bf16["n_split"], "split_ms": k4_bf16["split_ms"],
         "combine_ms": k4_bf16["combine_ms"]},
        {**entry(K6, sum(k6_launches.values()), k6_serve),
         "launches_by_path": k6_launches,
         "by_rep": {"int8/float32": by_rep("K6", "float32")},
         "n_split": k6_serve["n_split"], "split_ms": k6_serve["split_ms"],
         "combine_ms": k6_serve["combine_ms"]},
        *(pim_entry(ids, key, by_path, rows)
          for ids, key in ((K1, "k1"), (K2, "k2"))),
        {**pim_entry(K3, "k3", by_path, rows),
         "member_cap": importlib.import_module(
             "repro_torch.kernels.pim_mac").MAC_MAX_MEMBERS,
         "kernels_per_call": {p: r["profile"]["kernels_per_call"]
                              for p, r in paths.items()},
         "device_busy_share": {
             p: r["profile"]["device_busy_share_under_profiler"]
             for p, r in paths.items()}},
        {**K5, "launches": sum(k5_launches.values()),
         **sums(rows["pim_lenet_q"]), "launches_by_path": k5_launches,
         "pim_train": sums(rows["pim_train_q"]),
         "pim_llama": sums(rows["pim_llama_q"]),
         "pim_llama_pipe": sums(rows["pim_llama_pipe_q"]),
         "dense_variants": sums(rows["dense_variants_q"]),
         "io_variants": sums(rows["io_variants_q"]),
         "moe_variants": sums(rows["moe_variants_q"]),
         "recurrent": sums(rows["recurrent_q"])},
        {**K7, "launches": attn["launches"],
         "max_abs_err": long_bf16["max_err"],
         **{k: long_bf16[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "case": {"dtype": "bfloat16", **long_bf16["shape"]}},
        {**K8, **{k: pim_fp[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            "int_instructions_per_element_static_estimate")},
         "case": {"n": pim_fp["n"]}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
