#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 0]

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` a source, ``sm_90a``, all started together) and holds each
   against its plain PyTorch version on the card, bitwise:
   ``tree_reduce_slots`` over f32, bf16, f16 and int32, P = 1, 2, 3
   (padded), 4, 8 and 64, G > 1, a ragged row length, a strided stack,
   -0.0 rows, and its flat form ``tree_reduce``; ``quantize`` over f32,
   bf16 and f16 with zero, tie, NaN and inf blocks (scales only where a
   block holds NaN or inf) and a row-strided view; ``dequantize`` into
   f32, bf16 and f16 and as the fused error-feedback residual, in place
   too; ``dequant_accum_slots`` with P = 1, 2, 3, 4, 5, 8, G = 3 and
   strided P and G; its flat form ``dequant_accum``.
2. The dense main path: reduces the gradient tree of TinyLlama-1.1B at its
   published widths (depth cut to ``LAYERS``; fp32; random per-rank
   gradients from a seeded ``torch.Generator`` on the card) over 8
   emulated ranks on the ``(2, 4)`` mesh through
   ``GradReducer(FlareConfig(axes=("pod", "data"), transport="innetwork",
   reproducible=True))``: arena → switch data plane → fixed-tree fold
   kernel on every tree level.  The launch counters are set to 0 just
   before and read just after.  The result must be bitwise equal to the
   same reduction with the plain fold and to the wire ``fixed_tree``
   transport, and within a tree's rounding of an fp64 sum.  Then the
   flat ``(1, 8)`` mesh, the same way.
3. The int8 main path (F1): the same model and mesh through
   ``FlareConfig(axes=("pod", "data"), transport="innetwork",
   compression="int8")``, two steps with the error-feedback state
   carried: quantize → fold (``dequant_accum_slots``) on every level →
   quantize and dequantize at the root → the fused residual.  Counters
   reset just before, read just after: ``quantize``, ``dequantize`` and
   ``dequant_accum_slots`` must each have launched.  Result and state
   must be bitwise equal to the same two steps with the kernels patched
   to their plain versions, and step 1 within half an int8 step of every
   quantization on each element's path of an fp64 sum.  Then the flat
   ``(1, 8)`` mesh, and the ``multi`` and ``tree`` designs on a reduced
   arena, each bitwise against its plain twin.
4. The sparse main path (§7): the same model and mesh through
   ``FlareConfig(axes=("pod", "data"), transport="innetwork",
   sparse_k_frac=f)`` for f = 0.01 (the lists reach the root, which
   densifies them) and f = 0.05 (the level-1 switches densify, the pod
   level folds dense), two steps each with the state carried.  Counters
   reset just before, read just after: ``sparse_accum_slots`` must have
   launched.  Results, state and collision counts must be bitwise equal
   to the same steps with the plain kernels patched in; on a few
   buckets every selected magnitude is at least every unselected one,
   exactly ``k`` are selected, and the result is within ``8 · 2^-24 ·
   Σ|selected|`` of the fp64 sum of the ranks' selected entries; the
   plane gives the same bits under per-level arrival permutations.  On a
   reduced arena, both meshes, the per-packet plane under arrival
   permutations and a densify before level 1 (f = 0.1) agree bitwise
   with the batched plane on the kernels and on the plain versions.
   Before it, both sparse kernels are held against their plain versions
   (``sparse_accum_slots`` sorted and unsorted, -1 and out-of-range
   entries, duplicates, B = 1, 3, 294, strided G; ``topk_compact`` with
   k = 1, 2, 8, 64, block - 1 and block, ties, zero, ±0.0, inf and NaN
   blocks, the cluster (one 1e6, the rest in [1, 1.0001]), all-NaN and
   all-inf blocks, f32, bf16, f16).
5. The SparCML sparsifier: ``ops.blockwise_sparsify`` (k = 1 per block of
   512) of a 2^28-element vector and its round trip into the flat
   ``ops.sparse_accum``, counters reset just before and read just after,
   bitwise against the plain versions; the round trip's device time.
6. Times each whole reduction (median of a few runs) with its peak
   device memory, profiles one int8 and one sparse reduction, and times
   every kernel, its plain version and, where one PyTorch call computes
   the same function, that call, at the shapes the paths gave the
   kernel, beside the kernel's memory bound; ``topk_compact`` also at
   k = 8 and 64 on the sparsifier's 2^28 vector.
7. The flash attention kernels (``csrc/flash_attn.cu``: bf16 on the
   tensor cores by wgmma, fp32 on them in three TF32 products, every
   launch of at most 64 query rows a KV group on the decode kernel)
   against their plain version: causal and not, cap 0 and 30, window 0
   and 256, GQA 1, 4 and 8, ragged ``Sq``/``Sk``, fp32 (``atol = 3e-5``,
   the reference's own, on ``o`` and ``lse``, each launch twice with the
   same bits) and bf16 (one bf16 ulp of the plain version on the same
   bf16 inputs) at hd 64, with the launch counters showing every bf16
   case on the wgmma kernel and every fp32 one on the 3xTF32 kernel
   (``fp32_launches``); both dtypes at ``(hd, vd)`` = (16, 16), (32, 32),
   (128, 128), (256, 256) and (192, 128); fp32 at (128, 128), causal and
   not, ``Sq != Sk``, GQA 8, cap 0 and 30; ``base.attend`` in bf16 at hd
   128 on the card against its dense
   CPU branch (the scale rounded to bf16 in both), and a bf16 query over
   fp32 K/V the same way (upcast, the fp32 kernel, bf16 out).  The decode
   kernels (``DECODE_CASES``) in both dtypes at every ``TC_DIMS`` pair
   (bf16 on ``flash_decode_mma_kernel``, counted by
   ``decode_mma_launches``; fp32 on ``flash_decode_kernel``):
   G 1, 2, 8, 16 and 48, Sq 1 and 4, ragged ``kv_len``, the window inside
   and past the cache, cap 50, cross launches (not causal), one split and
   many, fp32 keys and values off 16 bytes (4-byte copies), and bf16 at
   the most splits the plan gives (one (b, KV head) over 65536 keys: one
   split an SM, joined through scratch), so that bf16 joins its splits
   both in a cluster and through scratch; each launch counted by
   ``decode_launches``, twice the same bits, against the plain version
   and the plain version of its own splits (``ref.flash_attention_split``)
   within one bf16 ulp (fp32 3e-5).  Then
   ``FLASH_MODEL_CASES``: every launch shape that the model paths give
   the kernel (TinyLlama's train step, prefill and decode; gemma2-2b's
   train step, prefill and decode, local and global, hd 256, cap 50,
   window 4096; qwen3's prefill and decode, hd 128, 16-way groups;
   deepseek's MLA train step, prefill and decode at ``(hd, vd)`` = (192,
   128); the VLM's self prefill and decode, its cross prefill and decode
   over 1600 vision keys, not causal, fp32 K/V, and the slot server's
   self and bf16 cross decode; whisper's train step, prefill and decode:
   its encoder over 1500 frames, not causal, its causal decoder, its
   cross-attention of the decoder's queries over the 1500 encoder keys,
   not causal, the masked self decode and the cross decode, and the slot
   server's; zamba2's shared block, 32 MHA heads × 64, in its train
   step, prefill, decode and slot server; TinyLlama's train step on
   ``2x2x2``, a model rank's 16 heads over 2 KV heads, all 8 ranks'
   rows in one launch), granite-20b's 48 query heads on one KV
   head, gemma2's window where it hides most keys (``Sq = Sk = 8192``)
   and its masked decode at ``kv_len`` 6144, and the fp32 kernel at
   gemma2-2b's (256, 256) with cap 50 and deepseek's (192, 128).  Each
   is one launch (a decode-shaped one on the decode kernel, else bf16 on
   the wgmma kernel and fp32, twice with the same bits, on the 3xTF32
   one) held against the plain version at every batch row, timed beside
   its bound (fp32: three times its flops at TF32's rate, the CUDA-core
   bound printed beside it) and ``scaled_dot_product_attention`` in the
   same dtype with the same boolean mask (no cap: SDPA takes none; in
   fp32 its distance from the plain version without the cap is printed
   beside the kernel's); where the window hides a key,
   the plain version without it differs.  After phase 31 every launch
   that phases 9, 18–31 recorded must have its case here.  Then the
   partial launch over a sequence split (``shards=``, sharded serving's
   decode) alone: 2 data × 4 ``model`` ranks × 2 rows, the keys one
   layer's strided slice of a ``(ranks, L, B, S_l, KV, d)`` cache, GQA
   8/2, keyless shards, the window and the cap across shard boundaries,
   Sq > 1, both dtypes at every ``TC_DIMS`` pair,
   against ``ref.flash_attention_partial``: bf16 one ulp, fp32 3e-5, a
   keyless row ``o = 0``, ``lse = -inf`` bit for bit; every launch of Sq
   < 128 on the decode kernel; and the decode kernel's partial launches
   at G 1 and 48 over longer shards (many splits, keyless shards), both
   dtypes at every ``TC_DIMS`` pair.  Then the backward kernels
   (``csrc/flash_bwd.cu``: bf16 on ``flash_bwd_dkdv_wgmma_kernel`` and
   ``flash_bwd_dq_wgmma_kernel``, fp32 on ``flash_bwd_dkdv_tf32_kernel``
   and ``flash_bwd_dq_tf32_kernel``, three TF32 products on ``wgmma`` at
   every pair, (256, 256) and (192, 128) in a design of their own)
   against their plain version ``ref.flash_attention_bwd`` on the
   forward kernel's ``o`` and log-sum-exp: ``BWD_SYNTH`` at every
   ``TC_DIMS`` pair in both dtypes (causal and not, cap, window, GQA 8/8,
   8/2 and 8/1, ``Sq`` and ``Sk`` ragged against every tile, ``Sq !=
   Sk``, a strided ``v``) and ``BWD_CASES``, every training launch of the
   path phases (TinyLlama's, on ``2x2x2`` too, gemma2-2b's local and
   global at hd 256 with cap 50, deepseek's MLA with its strided ``v``,
   whisper's encoder, decoder and cross, zamba2's, and phase 31's fp32
   steps' at the wide pairs: gemma2-2b's local and global, deepseek's)
   and two fp32 ones;
   each launched twice with the same bits, one ``bwd_launches`` each,
   fp32 within 1e-4, bf16 each gradient within 2e-2 of its largest; each
   model case timed beside its bound (five products a visible pair:
   ``flash_attn.flops_bwd``), the plain backward and SDPA's backward (the
   gradient alone, its forward outside the timed window, KV heads
   repeated, no cap), and each of its kernels' device time by the
   profiler beside its own bound (``bwd_kernel_bounds``: D by its bytes,
   the dK/dV and dQ kernels by four and three products a pair, fp32's
   three times at TF32's rate); the path launch's two bf16 kernels and
   TinyLlama's fp32 launch's two go into the last-but-one line as
   kernels of their own, the fp32 ones with phase 31's fp32 steps'
   launches; gemma2-2b's global and deepseek's fp32 launches' two, the
   wide pairs', on a line before it, under names that say the pair.
8. The wire dense reductions (``WIRE_RUNS``), at the reduction paths'
   model and size: on ``(2, 4)`` the default (the hierarchical schedule,
   rhd levels), ``reproducible=True`` (its fixed-tree variant),
   ``two_level`` and ``ring``; on ``(1, 8)`` the default (the ring, each
   bucket at its own stagger) and ``fixed_tree``.  Each: every rank the
   same bits within ``(P - 1) · 2^-24 · Σ|x|`` of an fp64 sum, P = 8;
   bitwise the same through the transport's per-bucket oracle
   (``batched=False``); for the fixed trees, bitwise the same through the
   per-bucket ``arena=False`` loop, and twice the same when reproducible;
   on a reduced arena of 2 buckets, the card's bits equal the CPU's.  Its
   median time of 5, its peak and ``wire_bytes_per_rank``.
9. The training step, the port's main path end to end, through the
   launcher's own setup (``repro_torch.launch.train.setup``):
   TinyLlama-1.1B at full width and depth ``TRAIN_LAYERS``, bf16 compute
   with fp32 master weights, 8 ranks on ``--mesh 2x4x1``, one sequence
   of 4096 a rank (global batch 8, cut from ``TRAIN_4K``'s 256),
   ``--transport innetwork --reproducible`` (gather ``fixed_tree``), lr
   5e-6, data ``synthetic_batches(seed=1)``.  A warm-up step, then 5
   steps with the counters set to 0 just before and read just after:
   every layer's attention launches the flash kernel in the forward and
   again in the remat recompute, ``2 × TRAIN_LAYERS`` a step, all of them
   the tensor-core kernel.  It prints each loss
   (all finite, the 5th below the 1st), the median step time, the peak
   device memory and a profile of one step; replays one step's captured
   per-rank gradients through the reduce-scatter and through the
   ``GradReducer`` with the plain fold (bitwise, and bitwise to the wire
   ``fixed_tree``: F3); and runs one step at ``COMPARE_LAYERS`` with the
   plain attention patched in against the kernel's step from the same
   parameters (loss and gradient norm within 2e-2 relative: bf16).
   The kernel's line takes phase 7's figures at the path's launch, with
   ``scaled_dot_product_attention`` causal and unmasked as its library
   yardstick (which the port never calls).  Every ``phase_train`` run
   (phases 9, 19, 22, 25, 27, 29, 31) also counts the backward kernel's
   launches over its 5 steps (``bwd_launches``: one a call site of the
   attention a step, 22 a TinyLlama step) and the plain backward's calls
   (none), records each backward launch's signature (``path_bwd``, each
   a ``BWD_CASES`` case) and prints its step time and peak beside the
   step's with the plain attention backward (``PLAIN_BWD_STEPS``); the
   comparison step at ``compare_layers`` patches the plain forward and
   the plain backward in.
10. The training step on the wire, the launcher's default
   (``WIRE_TRAIN_FLAGS``: the same flags without ``--transport innetwork
   --reproducible``), after the in-network run is freed: a warm-up step,
   then ``WIRE_STEPS`` with the counters set to 0 just before and read
   just after (flash ``2 × TRAIN_LAYERS`` a step, all on the tensor
   cores; the norms through ``hierarchical_allreduce``); losses finite
   and falling; step 1's loss bitwise the in-network step 1's (the same
   forward, the rhd and fixed-tree gathers the same all-gather) and its
   gradient norm within 1e-3; at ``COMPARE_LAYERS``, ``--gather-algorithm
   ring`` against rhd the same way.
11. The wire int8 and sparse reductions (``WIRE_LOSSY_RUNS``) on the
   reduction paths' tree, before the training phase: int8 on ``(2, 4)``
   hierarchical and flat and on ``(1, 8)``; sparse at f = 0.01 and 0.05
   on ``(2, 4)`` hierarchical (the lists cross the pod hop) and
   ``two_level`` and on ``(1, 8)``.  Two steps each with the state
   carried, the counters set to 0 just before and read just after
   (``quantize``, ``dequantize`` and the wire-order ``dequant_accum``;
   ``sparse_accum_slots``, which ``scatter_dense`` launches); results and
   state bitwise the plain twin's (through digests: the two do not fit
   on the card at once); int8 step 1 within half a step of every
   quantization on each element's path of an fp64 sum, sparse step 1
   keeping exactly k, the largest, within ``8 · 2^-24 · Σ|kept|``;
   batched == per bucket and card == CPU on a reduced arena of 8
   buckets; the median time of 5 with a state, the peak, the wire bytes
   a rank; a profile of one int8 and one sparse reduction.  Phase 1
   holds the wire order bitwise against its plain version (P = 1 .. 8),
   and ``scatter_dense`` on the card against the CPU's on sorted lists
   with -0.0 values and a SENTINEL tail, fp32 and a bf16 ``mine``.
12. The wire training step with ``--compression int8`` and with
   ``--sparse-k 0.01`` (``LOSSY_TRAIN``) at 22 layers, each after the
   previous run is freed: a warm-up step, then ``LOSSY_STEPS`` timed;
   losses finite and falling, flash 44 launches a step on the tensor
   cores, the three norm leaves' state in ``opt["ef"]``, step 1's loss
   bitwise the dense wire step's and its gradient norm within 1e-3.
13. The remat policies ``full``, ``dots`` and ``names`` on the wire at
   ``COMPARE_LAYERS`` from the same parameters and batch: step 1's loss
   and gradient norm bitwise equal, flash 2 × 2 launches a step under
   each; each policy's peak and step time.
14. The in-network reduction over a lossy fabric (``FABRIC_RATES``:
   drops, corruption, duplicates and reordered rounds, each plan's seed
   the first that survives the retry budget and makes every fault
   happen).  The schedules' host time, cold and cached, beside
   ``model_lossy``.  On the reduction paths' tree: dense reproducible
   (the traced fault counters integer-equal to the static schedules',
   ``plan_counters`` and ``model_point``; then the flat ``(1, 8)`` mesh),
   int8 and sparse at f = 0.01 (two steps with the state), each bitwise
   the fault-free run (digests where both do not fit), the counters set
   to 0 just before and read just after, the median of 5 and the peak
   beside phases 2-4's.  On a reduced arena: the per-packet plane under
   the plan and arrival permutations == the batched plane == fault-free,
   card == CPU.  A doomed plan (drop 0.9, no retries) degrades to the
   wire: dense at full width bitwise the in-network fault-free result
   and the wire ``fixed_tree``; int8 and sparse bitwise the wire
   transport ``_degrade`` builds.  The launcher with ``--fault-rate 0.01
   --fault-seed 1`` at ``TRAIN_LAYERS``: losses finite and falling,
   flash on the tensor cores, one step's per-rank gradients replayed
   with and without the plan, bitwise.  Prints its own wall time.
15. The shared switch (``runtime.SessionManager``).  At scale on ``(2,
   4)``: three tenants (``SHARED_TENANTS``: dense reproducible, int8,
   sparse at f = 0.01) at the largest arenas the static memory share
   admits, seeded per rank on the card; under two manager seeds each
   shared reduction bitwise its solo run, the solo run under a manager
   bitwise the manager-less plane; the median of 5, shared and solo,
   with the peak; the arrival permutations' host time, cold and cached;
   the same on ``(1, 8)`` at the arenas it admits; the 4-layer gradient
   arena raises ``AdmissionError``.  Then the launcher's ``--tenants 3``
   path (``TENANT_FLAGS``: three TinyLlama jobs at published widths,
   ``TENANT_LAYERS`` deep, each with its own parameters, optimizer and
   data, reducing as tenants of one switch): a warm-up step, then
   ``TENANT_STEPS`` a job with every kernel counter set to 0 just before
   and read just after (``tree_reduce_slots``, ``quantize``,
   ``dequant_accum_slots``, ``dequantize``, ``sparse_accum_slots`` and
   flash all launched); losses finite and falling; every tenant's
   reduced gradients at the first timed step bitwise a manager-less
   reduction of the same leaves; the report names three sessions; the
   replan's line, after which the reproducible tenant keeps its bits.
16. Checkpoints, recovery and the flight recorder, through the
   launcher's ``main`` (``TRAIN_FLAGS`` at ``CKPT_LAYERS``, a 3.69 GB
   checkpoint in a temporary directory, removed at the end): 2 steps
   with ``--ckpt-every 2``, the kernel counters set to 0 just before and
   read just after (flash twice a layer a step on the tensor cores,
   ``tree_reduce_slots``); ``--resume --steps 3`` prints ``resumed from
   step 2`` and restores every rank's parameters and optimizer state
   bitwise, and its step's loss is bitwise the saved run's on batch 0 of
   a fresh stream; the heartbeat ``Coordinator`` loses host 7, its
   ``plan`` gives a world of 4, and the resume on ``--mesh 1x4x1``
   restores the saved global leaves bitwise and steps to a finite loss.
   The times of ``save``'s host copy, of the write until ``wait()`` and
   of ``restore``, with the bytes on disk.  Then 1 + ``OBS_STEPS`` steps
   with and without ``--trace-out`` / ``--metrics-out``: the same bits,
   the step time ratio, the ``switch.*`` counters ``plan_counters``'
   (recorded once), ``python -m repro_torch.obs.report`` on both files.
   The ``obs`` group at phase 15's dense shape twice under a counting
   clock: byte-identical exports, bits neutral to telemetry.  A leaf
   switch fails under ``SHARED_TENANTS`` on a radix-2 lease
   (``Coordinator.switch_failure``): every tenant re-admitted, as the
   reference's manager decides, reduces bitwise as before, each
   kernel of the three planes launched; a root without a sibling drains
   every session.

17. The fabric health plane (``obs.HealthMonitor``, ``obs.SLOPolicy``) at
   phase 15's dense shape on ``(2, 4)``: a reproducible canary and a
   lossy dense tenant (``FABRIC_RATES``, the first plan that survives
   and makes every fault happen) share one ``SessionManager`` under one
   ``Telemetry`` with counting clocks; the hot slot ``HEALTH_HOT``;
   ``watch(3)`` under a drift rule.  The fault storm's evidence equals
   the static ``FaultSchedule`` sums as integers; the policy's replan
   equals a twin manager's manual replan and each tenant's next
   reduction on the card is bitwise the twin's (the canary's also
   bitwise its first); polls 2 and 3 raise nothing new but the standing
   storm and dispatch nothing; a ``recover_session`` rule drains the
   lossy tenant, whose next reduction is bitwise the manually recovered
   twin's; two watched runs export byte-identical incident JSON; the
   ``health.incidents.*`` counters and instants agree with the log; the
   host cost of one poll.  Then the launcher with ``TENANT_FLAGS``,
   ``--health-policy auto --incidents-out`` at ``HEALTH_LAYERS`` and one
   step: the log loads in ``python -m repro_torch.obs.report --incidents``
   and ``--fail-on critical`` exits as the log says.
18. Serving TinyLlama-1.1B at full width and all 22 layers, bf16, random
   weights from a seed.  The main path, ``launch.serve`` at the
   reference's defaults (8 requests, 4 slots, ``max_len`` 64, ``max_new``
   16), with the flash counter set to 0 just before and read just after:
   22 launches a decode call, every one on the decode kernel; its tok/s.
   At scale: ``prefill`` of ``SERVE_B`` prompts of ``SERVE_PROMPT``
   tokens, the cache grown to ``SERVE_CACHE``, then ``SERVE_STEPS``
   lockstep greedy decode steps (22 flash launches a step), against the
   same steps with the plain attention teacher-forced on the kernel's
   tokens: logits within ``SERVE_LOGIT_TOL`` of max|logit|, greedy
   tokens equal except where the plain run's top two logits lie within
   that tolerance (counted).  The median prefill and decode step times,
   the peak; a profile of one decode step (device time against wall
   time).  The decode launch's own figures are phase 7's.
19. The gemma2-2b training step: phase 9's checks through
   ``launch.train.setup`` with ``GEMMA_TRAIN_FLAGS`` (``TRAIN_FLAGS`` and
   ``--arch gemma2-2b``: local/global pairs, softcaps, sandwich norms, the
   tied head) at ``GEMMA_TRAIN_LAYERS``: 5 timed steps, flash 2 a layer a
   step on the tensor cores at hd 256, ``tree_reduce_slots`` launched,
   losses finite and falling, the F3 replay, 2 layers against the plain
   attention; the median step, the peak and a profile.
20. Serving gemma2-2b at all 26 layers, bf16: ``launch.serve --arch
   gemma2-2b`` at its defaults (26 flash launches a decode call), then
   ``GEMMA_SERVE_B`` prompts of ``GEMMA_SERVE_PROMPT`` tokens (past the
   window of 4096) and ``GEMMA_SERVE_STEPS`` decode steps past them
   against the plain attention, as phase 18 holds TinyLlama; opening the
   window moves the logits by more than that comparison's tolerance.
21. Serving qwen3-moe-235b-a22b at published widths, ``QWEN_SERVE_LAYERS``
   deep (bf16, the router fp32, drawn a layer at a time): prefill and
   decode as phase 20, the plain run teacher-forced on the kernel run's
   expert choices as well as its tokens (the router flips it would have
   made counted), with the ``gather`` combine and then ``scatter_ar``
   teacher-forced on gather's tokens and choices (logits within
   ``SERVE_LOGIT_TOL``, tokens equal outside near ties); the slot server
   on the same model.  The MoE train step does not fit the card at these
   widths (one layer's fp32 state is about 60 GB before any gradient):
   it is held on the CPU against the reference.
22. deepseek-v2-lite's training step, the first MoE step on the card:
   phase 9's checks through ``launch.train.setup`` with
   ``DEEPSEEK_TRAIN_FLAGS`` (``TRAIN_FLAGS`` and ``--arch
   deepseek-v2-lite-16b``) at ``DEEPSEEK_TRAIN_LAYERS`` (the dense first
   layer and one MoE layer, 64 experts × 1408, top 6, 2 shared): 5 timed
   steps, flash 2 a layer a step on the tensor cores at ``(hd, vd)`` =
   (192, 128) (MLA's strided ``v`` as it is), ``tree_reduce_slots``
   launched, the MoE's dropped choices counted, losses finite and
   falling, the F3 replay, 2 layers against the plain attention; the
   median step, the peak and a profile.
23. Serving deepseek-v2-lite at all 27 layers (bf16, the router fp32,
   drawn a layer at a time): ``launch.serve --arch deepseek-v2-lite-16b``
   at its defaults (27 flash launches a decode call), then
   ``DS_SERVE_B`` prompts of ``DS_SERVE_PROMPT`` and ``DS_SERVE_STEPS``
   expanded-MLA decode steps against the plain attention (the plain run
   forced on the kernel run's tokens and expert choices, as phase 21);
   then the absorbed decode (latent-space fp32 products, no flash)
   against the expanded one on the same cache, step by step (each
   absorbed step on a copy of the expanded run's cache, both fed its
   tokens and forced on its expert choices): logits within
   ``MLA_ABSORBED_TOL``, tokens equal outside near ties, both step times;
   and a witness for that tolerance (``mla_fp32_witness``): the same
   steps in fp32 from the same cache and weights, where the absorbed and
   expanded decodes agree within ``MLA_FP32_TOL`` and each bf16 decode
   lies within ``SERVE_LOGIT_TOL`` of them.
24. Serving llama-3.2-vision at published widths, ``VLM_SERVE_GROUPS``
   groups deep (4 self layers and a gated cross layer each; bf16, the
   gates drawn away from their init of 0): ``VLM_SERVE_B`` prompts of
   ``VLM_SERVE_PROMPT`` with the data pipeline's fp32 ``vision_embeds``
   ``(B, 1600, 8192)`` and ``VLM_SERVE_STEPS`` decode steps against the
   plain attention, the cross layers' launches on the fp32 kernel
   (counted); closing the gates moves the logits by more than the
   tolerance; the slot server (``SERVER_SLOTS`` lanes, ``SERVER_MAX_LEN``)
   against the zero cross cache, every launch on the decode kernel.  The
   VLM's train step does not fit the card at these widths (one group's
   fp32 state with the embedding and head is about 102 GB): it is held
   on the CPU against the reference.
25. whisper-medium's training step, the first encoder-decoder on the
   card: phase 9's checks through ``launch.train.setup`` with
   ``WHISPER_TRAIN_FLAGS`` (``TRAIN_FLAGS`` and ``--arch
   whisper-medium``) at all 24 encoder and 24 decoder layers, each
   rank's sequence of 4096 over its 1500 fp32 frames: 5 timed steps,
   flash ``flash_per_call`` times a step (every encoder layer and twice
   every decoder layer, self and cross, each again in the remat
   recompute: 144) on the tensor cores, the cross-attention's ``Sq =
   4096`` over ``Sk = 1500`` through the plain backward,
   ``tree_reduce_slots`` launched, losses finite and falling, the F3
   replay, 2 + 2 layers against the plain attention; the median step,
   the peak and a profile.
26. Serving whisper-medium at all 24 + 24 layers (bf16): ``launch.serve
   --arch whisper-medium`` at its defaults (48 flash launches a decode
   call: self and cross, the cross over the zero cache), then
   ``WSP_SERVE_B`` prompts of ``WSP_SERVE_PROMPT`` with the pipeline's
   fp32 frames, the self K/V grown to ``WSP_SERVE_CACHE`` (the cross K/V
   keep their 1500 keys), and ``WSP_SERVE_STEPS`` decode steps against
   the plain attention, as phase 18 holds TinyLlama; other frames move
   the last prefill logits by more than that tolerance.
27. mamba2-370m's training step, the first attention-free model: phase
   9's checks with ``MAMBA_TRAIN_FLAGS`` at ``MAMBA_TRAIN_LAYERS`` = 24
   of 48 layers (the chunked
   SSD, chunk 256), no flash launch, ``tree_reduce_slots`` launched,
   losses finite and falling, the F3 replay, 2 layers with the plain
   attention patched in (which changes nothing).
28. Serving mamba2-370m at all 48 layers: ``launch.serve --arch
   mamba2-370m`` at its defaults (no flash launch); in fp32 at
   ``MAMBA_FEED_LAYERS`` the chunked prefill of ``MAMBA_FEED_B`` prompts
   of ``MAMBA_FEED_PROMPT`` (two chunks) against the same tokens fed one
   at a time through
   ``decode_step`` (the recurrent path), the last logits within
   ``MAMBA_FEED_TOL`` of max|logit|, with the decode state's bytes; in
   bf16 the prefill of ``MAMBA_SERVE_B`` prompts of
   ``MAMBA_SERVE_PROMPT`` and ``MAMBA_SERVE_STEPS`` lockstep decode
   steps, their times and a profile of one step.
29. zamba2-1.2b's training step, the first hybrid: phase 9's checks with
   ``ZAMBA_TRAIN_FLAGS`` at ``ZAMBA_TRAIN_LAYERS`` = 12 of 38 layers (2
   groups of 6 mamba layers, each closed by the shared attention block,
   whose uses are one leaf's and sum their gradients; 38 do not fit the
   card): flash once a group
   a step (``flash_per_call``: the shared block runs outside remat) on
   the tensor cores, ``tree_reduce_slots`` launched, losses finite and
   falling, the F3 replay, and one group (``ZAMBA_COMPARE_LAYERS``)
   against the plain attention.
30. Serving zamba2-1.2b: ``launch.serve --arch zamba2-1.2b`` at its
   defaults (6 flash launches a decode call); in fp32 at
   ``ZAMBA_FEED_LAYERS`` (two groups) the chunked prefill of
   ``ZAMBA_FEED_B`` prompts of ``ZAMBA_FEED_PROMPT`` against the same
   tokens fed one at a time through ``decode_step``, the last logits
   within ``ZAMBA_FEED_TOL`` of max|logit|, the mamba state and the
   shared block's K/V beside the prefill's; in bf16 at all 38 layers the
   prefill of ``ZAMBA_SERVE_B`` prompts of ``ZAMBA_SERVE_PROMPT``, the
   K/V (not the mamba state) grown to ``ZAMBA_SERVE_CACHE``, and
   ``ZAMBA_SERVE_STEPS`` decode steps against the plain attention.
31. Tensor and expert parallelism over ``model``: phase 9's checks (the
   F3 replay among them) with ``TP_TRAIN_FLAGS`` (TinyLlama at 22
   layers on ``2x2x2``, global batch 4: a model rank's 16 of 32 heads
   over 2 of 4 KV heads, half the FFN and of the vocabulary), its step
   time and peak beside ``2x2x1``'s at the same batch; in fp32 two steps
   of ``2x2x2`` against ``2x2x1`` for TinyLlama at ``COMPARE_LAYERS`` and
   zamba2 at two groups, losses and gradient norms within
   ``TP_FP32_TOL``, every backward launch of those steps counted
   (``bwd_tf32_launches``) on the fp32 ``wgmma`` kernels, none on the
   plain backward; two fp32 steps on ``2x2x1`` of gemma2-2b and of
   deepseek-v2-lite at ``WIDE_FP32_LAYERS`` (their backward at (256, 256)
   and (192, 128)), every backward launch on the fp32 ``wgmma`` kernels
   and recorded (``path_bwd``), each against a twin with the plain
   backward patched in (deepseek's forced onto the first run's expert
   choices), losses and gradient norms within ``TP_FP32_TOL``, step time,
   peak and launches printed; deepseek-v2-lite's two layers in bf16 (32
   experts a model rank), the ``2x2x2`` steps forced on the ``2x2x1`` steps' expert
   choices (the flips counted), within ``TP_BF16_TOL``, the dropped
   choices' share equal.
32. The dry-run against the card: ``launch/dryrun.py``'s train tracer
   counts phase 10's wire step (``WIRE_TRAIN_FLAGS``, 22 layers) on
   ``meta`` tensors; its predicted peak of live bytes must lie within
   ``DRYRUN_PEAK_TOL`` of the peak that phase measured on the card, and
   it must count the flash launches the card made a step.  Prints the
   counted FLOPs, bytes and wire bytes, their roofline terms on the
   H100's data-sheet peaks, and the measured step's share of the compute
   term.
33. A query head split over ``model``: gemma2-2b at published widths,
   ``HEAD_SPLIT_LAYERS`` layers, one sequence of 4096 in bf16, on
   ``--mesh 1x1x16`` (its 8 query heads over 16 model ranks: every rank
   attends over all heads, XLA's partition inside a head) against
   ``1x1x1``: flash launched on the tensor cores at hd 256 as
   ``flash_per_call`` says, losses and gradient norms finite and within
   ``TP_BF16_TOL``.
34. The examples on the card at their default sizes, through their
   ``main`` in this process (``examples_torch/quickstart.py``,
   ``sparse_allreduce_demo.py``, ``train_e2e.py``, ``serve_batched.py``):
   what each prints, its claims checked (the collectives within 1e-4 of
   the sum, F3 bitwise, every transport's and ``train_e2e``'s losses
   falling, its checkpoints, every request answered) and the
   kernels it runs launched (the int8 ones, ``sparse_accum_slots``,
   flash).

35. Sharded serving (``serve.engine.make_serve_fns``): TinyLlama-1.1B at
   published widths and 22 layers, bf16, global batch ``SHARD_B``, a
   cache of ``SHARD_CACHE``, on ``(pod, data, model)`` = ``1x2x8`` (4
   KV heads over 8 ranks: the cache split over its sequence, attended
   by one partial flash launch a layer over every rank's block and
   combined by the log-sum-exp over ``model``) and ``1x2x4`` (KV heads
   over ``model``), each against the unsharded ``prefill`` /
   ``decode_step`` on the same parameters: (a) a prefill of
   ``SHARD_B`` prompts of ``SHARD_PROMPT``, logits within
   ``SERVE_LOGIT_TOL`` of max|logit| and the cache's global view within
   ``SHARD_CACHE_TOL`` of its largest element; (b) ``SHARD_STEPS``
   teacher-forced decode steps from ``SHARD_POS`` in the cache (its
   first ``SHARD_POS`` rows an unsharded prefill's, placed by
   ``shard_cache``; at ``1x2x8`` ranks 5–7 hold no visible key on every
   step), each step's logits within ``SERVE_LOGIT_TOL``, the flash
   counters set to 0 just before and read just after (a partial launch
   a layer a step at ``1x2x8``, an ordinary one at ``1x2x4``); (c) an
   fp32 witness at ``SHARD_FP32_LAYERS`` layers within
   ``SHARD_FP32_TOL``; (d) the last step's last partial launch at
   ``1x2x8``, its tensors as the main path gave them, against the
   plain version (``ref.flash_attention_partial``) on the same inputs:
   the output within one bf16 ulp, the log-sum-exp within 3e-5 on the
   rows that see a key, the keyless rows ``o = 0``, ``lse = -inf`` in
   both.  Prints the median decode step at each layout
   and unsharded, the peaks, the launches a step, and the partial
   launch's time against its byte bound and against
   ``scaled_dot_product_attention`` with a boolean mask over the same
   shard's keys (its output only).  The dry-run's trace of the ``1x2x8``
   decode step on ``meta`` must predict the card's peak for it (the
   step's arguments and what it allocates above them) within
   ``DRYRUN_PEAK_TOL``.
36. gemma2-2b served sharded at all 26 layers, bf16, ``1x1x8`` (one of
   its 8 query heads a rank, its 4 KV heads at hd 256 split over the
   sequence: ``GEMMA_SHARD_CACHE`` / 8 positions a rank): global batch
   ``GEMMA_SHARD_B``, ``GEMMA_SHARD_STEPS`` teacher-forced decode steps
   from ``GEMMA_SHARD_POS``, so that on the local layers the window of
   4096 starts inside rank 0, ``kv_len`` ends inside rank 4, ranks 5–7
   are keyless and both softcaps apply: logits within
   ``SERVE_LOGIT_TOL`` of the unsharded decode's; the last step's last
   partial launch (a global layer) and its last windowed one (a local
   layer) against the plain version as in phase 35 (d); the same
   figures as phase 35.

37. Ranks as processes (``launch/procs.py``, ``mesh.ProcessMesh``): the
   parent (every library built by phase 1) starts ``PROC_WORLD``
   processes with ``procs.spawn``, one a rank of the ``2x4`` mesh, all on
   this one card over gloo (NCCL refuses two ranks on one device; gloo's
   collectives copy CUDA tensors through the host, and the mesh stages
   the point-to-point operands itself, so the timings measure host
   copies and loopback sockets, not an interconnect).  (a) Each
   draws ``make_grads``' gradients of TinyLlama at ``LAYERS`` layers and
   keeps its own rank's slice, and reduces them (``PROC_REDUCTIONS``) in
   the network (reproducible: the level's children send their arenas to
   the switch rank, which alone folds on ``tree_reduce_slots``; int8:
   their int8 payloads and scales, folded on ``dequant_accum_slots``, the
   root's int8 copy multicast down and dequantized on every rank; sparse
   at ``sparse_k_frac`` 0.01: their coordinate lists, merged at the
   switch and densified at the root on ``sparse_accum_slots``, the fp32
   result multicast down) and on the wire (``fixed_tree``, int8, sparse):
   every rank's bits (a digest a leaf, one for its error-feedback state)
   equal its slice of the emulated reduction's on the card, and every
   kernel launched as ``proc_launch_plan`` says, by the rank's role (the
   folds on the switch ranks, ``data`` = 0, and nowhere else); the median
   of ``PROC_RUNS`` calls (the slowest rank's each) beside the emulated
   reduction's.  (b) ``launch.train --ranks processes`` (``PROC_TRAIN``)
   with ``TRAIN_FLAGS`` (TinyLlama at published widths, ``PROC_LAYERS``
   of 22 layers, one 4096-token sequence a rank, FSDP over ``data``, remat
   ``full``, in the network): two fp32 steps (the TF32 flash kernels)
   whose losses and gradient norms lie within ``PROC_FP32_RTOL`` of the
   emulated launcher's same steps, two bf16 steps (the ``wgmma``
   kernels), finite, printed beside the emulated run's, and two bf16
   steps each with ``--compression int8`` and with ``--sparse-k 0.01``
   (without ``--reproducible``), within ``PROC_FP32_RTOL`` of the
   emulated steps, whether bitwise printed; each process counts its
   launches of the flash forward and backward (set to 0 before its run,
   read after), every one of them nonzero, and of the reductions'
   kernels, as planned for two steps.  (c) NCCL asked for with two ranks
   on this card raises before any process group forms.  It runs right
   after phase 1's build, while the parent holds next to nothing on the
   card, which its eight processes share.

Phases 18–36 run under ``decode_gate``: every flash launch goes through
a check that a bf16 decode-shaped one moved the bf16 decode kernel's
counter (``decode_mma_launches``, set to 0 before phase 18) by one and
any other launch by none; each serving phase with attention must make
some, and the counter read after phase 36 is the JSON line's
``flash_decode_mma_kernel`` launches.

Prints the card's name and power limit (``nvidia-smi``), one JSON line
of kernel figures, and as its last line ``{"ok": true, "device": ...}``.
Exits non-zero without a result when no GPU is present or any check
fails; there is no fallback.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), the kernels' bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), the flash
#: kernel's bound: the least time its flops could take on this card
BF16_FLOPS_PER_S = 989e12
#: H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet): the
#: bound the fp32 flash launches had on the CUDA cores, printed beside
#: their bound on the tensor cores
FP32_FLOPS_PER_S = 67e12
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet): the fp32
#: flash kernel does each product three times in TF32 (3xTF32), so its
#: bound takes three times its flops at this rate
TF32_FLOPS_PER_S = 495e12
#: depth of the training phase: TinyLlama's published 22 (predicted
#: peak 45-60 GiB of the card's 80)
TRAIN_LAYERS = 22
#: depth of the step compared against the plain attention, whose
#: forward holds a (ranks · heads, 4096, 512) fp32 score tile
COMPARE_LAYERS = 2
#: the training phase's launcher flags.  Adam's first steps move every
#: weight by about lr in its gradient's sign, and on this random 22-layer
#: init any lr from 2e-5 up overshoots within 5 steps (the loss climbs
#: back above its step-1 value; at lr 0 it stays at 11.15-11.27, so the
#: climb is the update, not the data).  5e-6 falls on every step: it is
#: where TinyLlama's published warm-up (linear to 4e-4 over 2000 steps,
#: arXiv:2401.02385) stands near its 25th step.
TRAIN_FLAGS = ["--mesh", "2x4x1", "--batch", "8", "--seq", "4096",
               "--transport", "innetwork", "--reproducible", "--lr", "5e-6",
               "--device", "cuda"]
#: the wire training phase: ``TRAIN_FLAGS`` without ``--transport
#: innetwork --reproducible``, the launcher's default wire reduction (FSDP
#: gathers rhd, the norms through the hierarchical schedule)
WIRE_TRAIN_FLAGS = [f for f in TRAIN_FLAGS
                    if f not in ("--transport", "innetwork", "--reproducible")]
#: timed steps of the wire training phase, after its warm-up step
WIRE_STEPS = 3
#: the wire reductions: name, mesh, ``FlareConfig`` fields.  On (2, 4)
#: over ``("pod", "data")``, where auto resolves to the hierarchical
#: schedule (rhd levels); on (1, 8) over ``("data",)``, ``FlareConfig``'s
#: default axes and the launcher's on ``--mesh 8x1``, where auto resolves,
#: with 4 MiB buckets, to the ring with staggers = bucket index
WIRE_RUNS = (("auto", (2, 4), {}),
             ("reproducible", (2, 4), {"reproducible": True}),
             ("two_level", (2, 4), {"algorithm": "two_level"}),
             ("ring", (2, 4), {"algorithm": "ring"}),
             ("auto", (1, 8), {"axes": ("data",)}),
             ("fixed_tree", (1, 8), {"axes": ("data",),
                                     "algorithm": "fixed_tree"}))
#: the wire lossy reductions: name, mesh, ``FlareConfig`` fields.  int8 on
#: (2, 4) hierarchical (auto) and flat (data, then pod), and on (1, 8);
#: sparse at each fraction on (2, 4) hierarchical (auto: the lists cross
#: the pod hop, densifying there at 0.05) and ``two_level`` (dense across
#: pods), and on (1, 8) (densifying at the third step at 0.05)
WIRE_LOSSY_RUNS = (
    ("int8 hierarchical", (2, 4), {"compression": "int8"}),
    ("int8 flat", (2, 4), {"compression": "int8", "hierarchical": False}),
    ("int8", (1, 8), {"axes": ("data",), "compression": "int8"}),
    *((f"sparse f={f}{kind}", shape, dict(kw, sparse_k_frac=f))
      for f in (0.01, 0.05)
      for kind, shape, kw in ((" hierarchical", (2, 4), {}),
                              (" two_level", (2, 4), {"hierarchical": False}),
                              ("", (1, 8), {"axes": ("data",)}))))
#: the reduced arena on which batched == per bucket and card == CPU
SMALL_BUCKETS, SMALL_S = 8, 1 << 17
#: the wire training step with a lossy transport: extra launcher flags
LOSSY_TRAIN = {"int8": ["--compression", "int8"],
               "sparse": ["--sparse-k", "0.01"]}
#: timed steps of each lossy wire step, after its warm-up step
LOSSY_STEPS = 2
#: the remat policies held against each other at ``COMPARE_LAYERS``
REMAT_POLICIES = ("full", "dots", "names")
#: the lossy fabric (phase 14): rates under which every level of the
#: reduction paths' tree (2.4-4.8 M packets a level) survives the default
#: retry budget with ``model_lossy``'s survival above 0.8; the seed is the
#: first that survives and makes every kind of fault happen
FABRIC_RATES = dict(drop=0.01, corrupt=0.002, duplicate=0.1, reorder=0.5)
#: the sparse fraction of phase 14 (the lists reach the root)
FABRIC_SPARSE = 0.01
#: the launcher's in-network training step over the lossy fabric
FABRIC_TRAIN_FLAGS = [*TRAIN_FLAGS, "--fault-rate", "0.01", "--fault-seed",
                      "1"]
#: timed steps of the lossy-fabric training step, after its warm-up step
FABRIC_STEPS = 2
#: the shared switch (phase 15): the launcher's ``--tenants 3`` path, three
#: TinyLlama jobs at published widths and ``TENANT_LAYERS`` (three jobs'
#: fp32 parameters and Adam state, held on both pods, are about 3 x 11.6
#: GB at 8 layers)
TENANT_FLAGS = ["--mesh", "2x4x1", "--batch", "8", "--seq", "4096",
                "--lr", "5e-6", "--device", "cuda", "--tenants", "3",
                "--congestion-replan", "0.9"]
TENANT_LAYERS = 8
#: timed steps of every job, after one warm-up step
TENANT_STEPS = 2
#: phase 16: the launcher's in-network reproducible step (``TRAIN_FLAGS``)
#: at this depth holds 307,251,200 parameters, a 3.69 GB checkpoint (fp32
#: parameters and both Adam moments); cut from 8 layers to make room for
#: phase 37 (the save and restore of 8 took 28.4 s on an NVIDIA H100
#: 80GB HBM3 at 700 W)
CKPT_LAYERS = 4
#: timed steps of phase 16's flight-recorder runs, after one warm-up step
OBS_STEPS = 3
#: the at-scale tenants of phase 15 on (2, 4): name, (B, S), FlareConfig
#: fields; the largest arenas the 8 MiB static share (64 clusters x 1 MiB
#: / 8 sessions) admits there.  (1, 8) halves B until it admits.
SHARED_TENANTS = (("dense", (16, 1 << 16), {"reproducible": True}),
                  ("int8", (6, 1 << 20), {"compression": "int8"}),
                  ("sparse", (64, 1 << 20), {"sparse_k_frac": 0.01}))
#: phase 17: the hot slot the health plane's drift detector must see
HEALTH_HOT = ((1, 0), 0.9)
#: phase 17: the launcher's health pass at this depth, one step (a check
#: of the launcher's path, not a figure)
HEALTH_LAYERS = 2
#: phase 18: the at-scale serving run: prompts, prompt length, the cache
#: grown to this many positions, lockstep decode steps
SERVE_B, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 16, 1024, 2048, 64
#: phase 18: logits of the kernel's steps within this share of max|logit|
#: of the same steps with the plain attention (bf16 through 22 layers)
SERVE_LOGIT_TOL = 3e-2
#: phase 19: the gemma2-2b training step, ``TRAIN_FLAGS`` with its arch.
#: Depth cut from the published 26 to fit: fp32 weights, gradients and
#: both Adam moments are 16 B a parameter, held by both pods (8 layers:
#: 1.21 G parameters, 0.59 G of them the tied embedding, 38.8 GB), beside
#: the gathered bf16 embedding (9.4 GB on 8 ranks) and its gradient
GEMMA_TRAIN_FLAGS = [*TRAIN_FLAGS, "--arch", "gemma2-2b"]
GEMMA_TRAIN_LAYERS = 8
#: phase 20: gemma2-2b served at all 26 layers: prompts, prompt length
#: (past the local layers' window of 4096), the cache grown to this many
#: positions, lockstep decode steps
GEMMA_SERVE_B, GEMMA_SERVE_PROMPT, GEMMA_SERVE_CACHE, GEMMA_SERVE_STEPS = (
    2, 6144, 6144 + 32, 32)
#: phase 21: qwen3-moe-235b-a22b served at published widths, depth cut
#: from 94: a layer is 2.49 G parameters (4.98 GB in bf16), the untied
#: embedding and head 2.49 GB more, so 8 layers hold about 42 GB
QWEN_SERVE_LAYERS = 8
QWEN_SERVE_B, QWEN_SERVE_PROMPT, QWEN_SERVE_CACHE, QWEN_SERVE_STEPS = (
    4, 1024, 1024 + 32, 32)
#: phase 22: deepseek-v2-lite's training step, ``TRAIN_FLAGS`` with its
#: arch, at this depth: the dense first layer and one MoE layer.  Its
#: published widths give a MoE layer 584.8 M parameters, the dense layer
#: 81.0 M and the untied embedding and head 419.4 M: 1.085 G, 17.4 GB of
#: fp32 weights, gradients and both Adam moments, which both pods hold
DEEPSEEK_TRAIN_FLAGS = [*TRAIN_FLAGS, "--arch", "deepseek-v2-lite-16b"]
DEEPSEEK_TRAIN_LAYERS = 2
#: phase 23: deepseek-v2-lite served at all 27 layers (15.71 G parameters,
#: 31.4 GB in bf16): prompts, prompt length, cache positions, steps
DS_SERVE_B, DS_SERVE_PROMPT, DS_SERVE_CACHE, DS_SERVE_STEPS = (
    4, 2048, 2048 + 32, 32)
#: phase 23: the absorbed decode's logits within this share of max|logit|
#: of the expanded decode's, each step from the same cache.  The two
#: round to bf16 at other points of every MLA layer (the expanded one the
#: up-projected K and V, the absorbed one the latent query and output),
#: so each carries its own bf16 error, and two independent errors of up
#: to ``SERVE_LOGIT_TOL`` add to about √2 of it.  The fp32 witness
#: (``mla_fp32_witness``) holds each decode within ``SERVE_LOGIT_TOL`` of
#: the same steps in fp32
MLA_ABSORBED_TOL = math.sqrt(2) * SERVE_LOGIT_TOL
#: phase 23's fp32 witness: the fp32 absorbed and expanded decodes (one
#: function, two orders of operations) within this share of max|logit|
#: of each other: fp32 rounding through 27 layers is far below it, and
#: it is 300 times under ``SERVE_LOGIT_TOL``, so a wrong term of either
#: decode cannot hide under it
MLA_FP32_TOL = 1e-4
#: phase 24: llama-3.2-vision-90b served at published widths, cut to this
#: many groups of 4 self layers and a cross layer (a layer is 855.6 M
#: parameters, the untied embedding and head 2.10 G: 21.3 GB in bf16)
VLM_SERVE_GROUPS = 2
VLM_SERVE_B, VLM_SERVE_PROMPT, VLM_SERVE_CACHE, VLM_SERVE_STEPS = (
    2, 1024, 1024 + 16, 16)
#: the slot servers' lanes and cache length (``launch.serve``'s defaults,
#: which ``served_at_defaults`` runs; phases 21 and 24 take them too)
SERVER_SLOTS, SERVER_MAX_LEN = 4, 64
#: phase 25: whisper-medium's training step, ``TRAIN_FLAGS`` with its
#: arch, at all 24 encoder and 24 decoder layers (0.79 G parameters: 12.6
#: GB of fp32 weights, gradients and both Adam moments, which both pods
#: hold), each rank's 4096 decoder tokens over its 1500 frames
WHISPER_TRAIN_FLAGS = [*TRAIN_FLAGS, "--arch", "whisper-medium"]
WHISPER_TRAIN_LAYERS = 24
#: phase 26: whisper-medium served at all 24 + 24 layers: prompts (each
#: with the pipeline's 1500 fp32 frames), prompt length, the self K/V
#: grown to this many positions, lockstep decode steps
WSP_SERVE_B, WSP_SERVE_PROMPT, WSP_SERVE_CACHE, WSP_SERVE_STEPS = (
    8, 1024, 1024 + 32, 32)
#: phase 27: mamba2-370m's training step, ``TRAIN_FLAGS`` with its arch
#: (the SSD's chunk of 256 divides the 4096 tokens), cut from all 48
#: layers to 24 to make room for phase 37 in the script's time (a step
#: took 3.68 s at 48 layers on an NVIDIA H100 80GB HBM3 at 700 W)
MAMBA_TRAIN_FLAGS = [*TRAIN_FLAGS, "--arch", "mamba2-370m"]
MAMBA_TRAIN_LAYERS = 24
#: phase 28: mamba2-370m in fp32 at published widths: prompts, prompt
#: length (two chunks of 256) and depth for the chunked prefill against
#: the same tokens fed one at a time through ``decode_step`` (the
#: recurrent path).  Depth cut from 48: the feed is host-bound, 73 ms a
#: step at 48 layers on an H100, 37.5 s for the 512 steps; from 16 to 8
#: to make room for phase 37 (16.1 s at 16 on an NVIDIA H100 80GB HBM3
#: at 700 W)
MAMBA_FEED_B, MAMBA_FEED_PROMPT, MAMBA_FEED_LAYERS = 4, 512, 8
#: phase 28: the chunked prefill's last logits within this share of
#: max|logit| of the recurrent feed's (``tests/test_models.py::
#: test_mamba_chunked_equals_recurrent``'s bound on the reference)
MAMBA_FEED_TOL = 1e-3
#: phase 28: the bf16 decode at a batch of 16: prompt length (chunked),
#: lockstep decode steps
MAMBA_SERVE_B, MAMBA_SERVE_PROMPT, MAMBA_SERVE_STEPS = 16, 1024, 32
#: phase 29: zamba2-1.2b's training step, ``TRAIN_FLAGS`` with its arch.
#: Depth cut from the published 38 (6 groups of 6 mamba layers, each
#: closed by the shared block, and a tail of 2) to the deepest whole
#: number of groups that fits: 5.  The shared block's uses run outside
#: remat and keep their activations, about 5.8 GB a use for the 8 ranks,
#: beside the fp32 weights, gradients and both Adam moments that both
#: pods hold (37.5 GB at 38 layers): 38 layers ran out of the card's
#: memory in the first forward, 30 peak at 65.87 GiB, and a sixth group
#: would add about 11 GB (measured on one H100)
#: Cut again to 2 groups to make room for phase 37 in the script's time
#: (a step took 4.29 s at 30 layers on an NVIDIA H100 80GB HBM3 at 700 W)
ZAMBA_TRAIN_FLAGS = [*TRAIN_FLAGS, "--arch", "zamba2-1.2b"]
ZAMBA_TRAIN_LAYERS = 12
#: phase 29's step against the plain attention: one group (at
#: ``COMPARE_LAYERS`` zamba2 has no attention to compare)
ZAMBA_COMPARE_LAYERS = 6
#: phase 30: zamba2 in fp32 at published widths, two groups deep: the
#: chunked prefill of ``ZAMBA_FEED_B`` prompts of ``ZAMBA_FEED_PROMPT``
#: (two chunks) against the same tokens fed one at a time through
#: ``decode_step``, the last logits within ``ZAMBA_FEED_TOL`` of
#: max|logit| (``tests/test_models.py::test_prefill_vs_decode_consistency``'s
#: bound on the reference)
ZAMBA_FEED_B, ZAMBA_FEED_PROMPT, ZAMBA_FEED_LAYERS = 4, 512, 12
ZAMBA_FEED_TOL = 2e-3
#: phase 30: the bf16 serving run at all 38 layers: prompts, prompt
#: length, the shared block's K/V grown to this many positions, steps
ZAMBA_SERVE_B, ZAMBA_SERVE_PROMPT, ZAMBA_SERVE_CACHE, ZAMBA_SERVE_STEPS = (
    16, 1024, 1024 + 32, 32)
#: phase 30: the kernel run's logits within this share of max|logit| of
#: the plain-attention run's.  Both are bf16 through 38 mamba layers and
#: 6 attention blocks, each with its own rounding, so two errors of up to
#: ``SERVE_LOGIT_TOL`` add to about √2 of it (as ``MLA_ABSORBED_TOL``).
#: The fp32 witness measures each run's error against the same steps in
#: fp32 and holds the kernel run's within ``ZAMBA_WITNESS_RATIO`` of the
#: plain run's: the kernel no less exact than the plain attention
ZAMBA_SERVE_TOL = math.sqrt(2) * SERVE_LOGIT_TOL
ZAMBA_WITNESS_RATIO = 1.25
#: phase 31: tensor parallelism over ``model``: ``TRAIN_FLAGS`` on
#: ``2x2x2`` (2 pods x 2 data ranks, each split over 2 model ranks) and
#: on ``2x2x1``, both at a global batch of 4 (one sequence a (pod, data)
#: rank)
TP_TRAIN_FLAGS = ["--mesh", "2x2x2", "--batch", "4", *TRAIN_FLAGS[4:]]
DP_TRAIN_FLAGS = ["--mesh", "2x2x1", "--batch", "4", *TRAIN_FLAGS[4:]]
#: phase 31: ``2x2x2`` against ``2x2x1`` in fp32: losses and gradient
#: norms within this share (the CPU tests' bound: fp32 sums in another
#: order), TinyLlama at ``COMPARE_LAYERS`` and zamba2 at two groups
TP_FP32_TOL = 1e-5
ZAMBA_TP_LAYERS = 12
#: phase 31: gemma2-2b's and deepseek-v2-lite's fp32 steps on ``2x2x1``,
#: cut in depth only: gemma2-2b's one local layer (window 4096) and one
#: global, deepseek's dense first layer and one MoE layer
WIDE_FP32_LAYERS = 2
#: phase 31: deepseek-v2-lite's two layers at ``2x2x2`` (32 experts a
#: model rank) against ``2x2x1`` in bf16, the ``2x2x2`` step forced on the
#: ``2x2x1`` step's expert choices: losses and norms within this share
TP_BF16_TOL = 2e-2
#: phase 32: the dry-run's predicted peak against the card's, within
#: this share of the card's
DRYRUN_PEAK_TOL = 0.25
#: phase 33: gemma2-2b at published widths on one sequence, its 8 query
#: heads split over 16 model ranks (``--mesh 1x1x16``) and on one rank
HEAD_SPLIT_FLAGS = ["--arch", "gemma2-2b", "--batch", "1", "--seq", "4096",
                    "--lr", "5e-6", "--device", "cuda"]
HEAD_SPLIT_LAYERS = 2
HEAD_SPLIT_STEPS = 3
#: phase 35: TinyLlama-1.1B served sharded at 22 layers: global batch,
#: prompt, cache, the decode's first position and its steps; the two
#: layouts ``(pod, data, model)``: the cache split over its sequence
#: (4 KV heads over 8) and over its KV heads
SHARD_B, SHARD_PROMPT, SHARD_CACHE = 16, 4096, 4096
SHARD_POS, SHARD_STEPS = 2048, 32
SHARD_MESHES = ((1, 2, 8), (1, 2, 4))
#: phase 35: the sharded prefill's bf16 cache against the unsharded
#: one's, within this share of its largest element.  Tensor parallelism
#: sums a row-parallel product's bf16 partial outputs over ``model`` in
#: bf16 (as XLA's all-reduce of them does), so every layer past the first
#: takes K/V from a residual stream a few bf16 ulps off: the CPU
#: rehearsal at 3–6 narrow layers found 1.4e-2 at ``1x2x8`` and at
#: ``1x2x4`` alike (fp32: 1.3e-6), past the 1e-2 first planned.  The fp32
#: witness holds the cache at ``SHARD_FP32_TOL``
SHARD_CACHE_TOL = SERVE_LOGIT_TOL
#: phase 35: the fp32 witness, its depth, decode steps and bound (the CPU
#: tests hold fp32 at 1e-5 at SMOKE size)
SHARD_FP32_LAYERS, SHARD_FP32_STEPS, SHARD_FP32_TOL = 2, 4, 1e-4
#: phase 36: gemma2-2b served sharded at 26 layers on ``1x1x8``: global
#: batch, the decode's first position, cache, steps
GEMMA_SHARD_B, GEMMA_SHARD_POS = 8, 5000
GEMMA_SHARD_CACHE, GEMMA_SHARD_STEPS = 8192, 16
GEMMA_SHARD_MESH = (1, 1, 8)


#: phase 37: ranks as processes on the one card (gloo), the mesh, the
#: depth of its train steps (TinyLlama's published widths), the timed
#: calls of each reduction (the first, checked one among them), the
#: tolerance of the fp32 steps against the emulated ones and the time
#: limit of the children
PROC_MESH = (2, 4)
PROC_WORLD = 8
PROC_LAYERS = 2
PROC_RUNS = 3
PROC_FP32_RTOL = 1e-5
PROC_TIMEOUT = 600.0
#: the reductions of phase 37 (a): reproducible in the network and on the
#: wire, then the int8 and sparse planes in the network and on the wire
PROC_REDUCTIONS = (("innetwork", dict(transport="innetwork",
                                      reproducible=True)),
                   ("wire fixed_tree", dict(algorithm="fixed_tree",
                                            reproducible=True)),
                   ("int8 innetwork", dict(transport="innetwork",
                                           compression="int8")),
                   ("sparse innetwork", dict(transport="innetwork",
                                             sparse_k_frac=0.01)),
                   ("int8 wire", dict(compression="int8")),
                   ("sparse wire", dict(sparse_k_frac=0.01)))
#: the train steps of phase 37 (b): label, flags, compute dtype; the lossy
#: ones in the network without ``--reproducible``, which they refuse
PROC_TRAIN = (("fp32", TRAIN_FLAGS, "float32"),
              ("bf16", TRAIN_FLAGS, "bfloat16")) + tuple(
    (f"bf16 {name}", [f for f in TRAIN_FLAGS if f != "--reproducible"]
     + extra, "bfloat16") for name, extra in LOSSY_TRAIN.items())


def proc_launch_plan(name: str, c: tuple[int, int]) -> dict:
    """The kernel launches that one reduction ``name`` of phase 37 (a)
    makes on the rank at ``c`` of ``PROC_MESH`` = (2, 4), by its role
    (keyed as ``proc_rank`` counts them): the tree reduces ``data``, then
    ``pod``; ``data`` = 0 are the first level's switch ranks, ``(0, 0)``
    the second's and the root.  A kernel it does not name launches no
    time.  A 4 MiB bucket's int8 image is past §6.4's 512 KiB line: the
    ``single`` design, one fold a level.  The sparse lists (1 % of a
    bucket of at least 10240 elements) stay under a quarter of it through
    8 ranks: they densify at the root in the network and after the last
    merge on the wire."""
    switch, root = int(c[1] == 0), int(c == (0, 0))
    plan = {
        "innetwork": {"fold": switch + root},
        # quantize: each level the rank takes part in, the root's
        # requantization, the error feedback's residual; dequantize: the
        # root's multicast copy and the residual
        "int8 innetwork": {"int8 fold": switch + root,
                           "quantize": 2 + switch + root, "dequantize": 2},
        "sparse innetwork": {"densify": root},
        # the hierarchical protocol: four legs quantized (a reduce-scatter
        # and a gather over data and over pod) and the residual; a fold a
        # reduce-scatter; the two gathers and the residual dequantized
        "int8 wire": {"quantize": 5, "int8 fold": 2, "dequantize": 3},
        "sparse wire": {"densify": 1}}.get(name, {})
    return {k: v for k, v in plan.items() if v}


def reduction_kinds(launches: dict) -> set:
    """The reduction kernels of a ``proc_rank`` launch count or a
    ``proc_launch_plan``, either fold as ``"fold"``."""
    return {"fold" if k == "int8 fold" else k for k in launches
            if k in ("fold", "int8 fold", "quantize", "dequantize",
                     "densify")}


def flash_per_call(cfg, kind: str) -> int:
    """Flash launches a model makes in one call of ``kind``: ``train``
    (a step: the forward and the remat recompute), ``prefill`` or
    ``decode`` (one step).  A decoder-only layer launches once a call
    (twice a train step); whisper's encoder layer once, its decoder layer
    twice (self, cross), each doubled by the remat in a train step;
    mamba2 never (attention-free); zamba2 once a group in every call (its
    shared block runs outside remat)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "audio":
        return {"train": 2 * (cfg.encoder_layers + 2 * cfg.n_layers),
                "prefill": cfg.encoder_layers + 2 * cfg.n_layers,
                "decode": 2 * cfg.n_layers}[kind]
    return cfg.n_layers * (2 if kind == "train" else 1)


def flash_case(b, sq, sk, h, kv, hd, cap=0.0, window=0, q_offset=0,
               kv_len=None, *, vd=None, causal=True, dtype="bfloat16",
               v_in=None, scale_of="bfloat16") -> dict:
    """One ``FLASH_MODEL_CASES`` entry: the launch's shapes (q ``(b, sq,
    h, hd)``, k ``(b, sk, kv, hd)``, v ``(b, sk, kv, vd)``), cap, window,
    mask, the kernel's dtype (bf16: the wgmma kernel; fp32: the 3xTF32
    kernel, which a bf16 query over fp32 K/V reaches upcast), where the
    model's ``v`` is a strided view of a wider tensor, that tensor's width
    a head (MLA's up-projection: ``v`` its last ``vd`` of ``v_in`` values
    a head), and the dtype of the model's query, which rounds its scale
    (bf16 but in an fp32 model)."""
    return dict(b=b, sq=sq, sk=sk, h=h, kv=kv, hd=hd, cap=cap, window=window,
                q_offset=q_offset, kv_len=kv_len, vd=vd or hd, causal=causal,
                dtype=dtype, v_in=v_in, scale_of=scale_of)


#: phase 7's flash cases at the model paths' launches: every launch shape
#: that phases 9, 18–31 give the kernel (a decode case at its last step's
#: position, a slot server's at its cache's end; ``path_flash`` records
#: the paths' launches and ``main`` checks each has its case here), and
#: five that no path's recorded phase launches on the card: gemma2's
#: window where it hides most keys (Sq = Sk = 8192), granite-20b's 48
#: query heads on one KV head, gemma2's windowed decode at ``kv_len``
#: 6144 of an 8192-position cache, and the fp32 kernel at (256, 256) and
#: (192, 128).  MLA's ``v`` is the model's strided view of its
#: up-projection (head stride 256, 128 values in)
_TL, _GE, _QW = (32, 4, 64, 0.0), (8, 4, 256, 50.0), (64, 4, 128, 0.0)
_DS = dict(h=16, kv=16, hd=192, vd=128, v_in=256)
_SRV = (SERVER_SLOTS, 1, SERVER_MAX_LEN)
_SRV_MASK = dict(q_offset=SERVER_MAX_LEN - 2, kv_len=SERVER_MAX_LEN - 1)
_VL = dict(h=64, kv=8, hd=128)
_WS = dict(h=16, kv=16, hd=64)
_ZA = dict(h=32, kv=32, hd=64)
FLASH_MODEL_CASES = {k: flash_case(*v) for k, v in {
    "tinyllama train": (8, 4096, 4096, *_TL, 0, 0, None),
    "tinyllama prefill": (SERVE_B, SERVE_PROMPT, SERVE_PROMPT, *_TL, 0, 0,
                          None),
    "tinyllama decode": (SERVE_B, 1, SERVE_CACHE, *_TL, 0,
                         SERVE_PROMPT + SERVE_STEPS - 1,
                         SERVE_PROMPT + SERVE_STEPS),
    "gemma2 train local": (8, 4096, 4096, *_GE, 4096, 0, None),
    "gemma2 train global": (8, 4096, 4096, *_GE, 0, 0, None),
    "gemma2 prefill local": (GEMMA_SERVE_B, GEMMA_SERVE_PROMPT,
                             GEMMA_SERVE_PROMPT, *_GE, 4096, 0, None),
    "gemma2 prefill global": (GEMMA_SERVE_B, GEMMA_SERVE_PROMPT,
                              GEMMA_SERVE_PROMPT, *_GE, 0, 0, None),
    "gemma2 decode local": (GEMMA_SERVE_B, 1, GEMMA_SERVE_CACHE, *_GE,
                            4096, GEMMA_SERVE_PROMPT + GEMMA_SERVE_STEPS - 1,
                            GEMMA_SERVE_PROMPT + GEMMA_SERVE_STEPS),
    "gemma2 decode global": (GEMMA_SERVE_B, 1, GEMMA_SERVE_CACHE, *_GE, 0,
                             GEMMA_SERVE_PROMPT + GEMMA_SERVE_STEPS - 1,
                             GEMMA_SERVE_PROMPT + GEMMA_SERVE_STEPS),
    "qwen3 prefill": (QWEN_SERVE_B, QWEN_SERVE_PROMPT, QWEN_SERVE_PROMPT,
                      *_QW, 0, 0, None),
    "qwen3 decode": (QWEN_SERVE_B, 1, QWEN_SERVE_CACHE, *_QW, 0,
                     QWEN_SERVE_PROMPT + QWEN_SERVE_STEPS - 1,
                     QWEN_SERVE_PROMPT + QWEN_SERVE_STEPS),
    "gemma2 window 4096 at 8192": (1, 8192, 8192, *_GE, 4096, 0, None),
    "granite GQA 48": (1, 4096, 4096, 48, 1, 128, 0.0, 0, 0, None),
    "gemma2 decode kv_len 6144": (2, 1, 8192, *_GE, 4096, 6143, 6144),
    "tinyllama server decode": (*_SRV, *_TL, 0, *_SRV_MASK.values()),
    "gemma2 server decode local": (*_SRV, *_GE, 4096,
                                   *_SRV_MASK.values()),
    "gemma2 server decode global": (*_SRV, *_GE, 0, *_SRV_MASK.values()),
    "qwen3 server decode": (*_SRV, *_QW, 0, *_SRV_MASK.values()),
}.items()} | {
    "deepseek train": flash_case(8, 4096, 4096, **_DS),
    "deepseek prefill": flash_case(DS_SERVE_B, DS_SERVE_PROMPT,
                                   DS_SERVE_PROMPT, **_DS),
    "deepseek decode": flash_case(
        DS_SERVE_B, 1, DS_SERVE_CACHE, **_DS,
        q_offset=DS_SERVE_PROMPT + DS_SERVE_STEPS - 1,
        kv_len=DS_SERVE_PROMPT + DS_SERVE_STEPS),
    "deepseek server decode": flash_case(*_SRV, **_DS, **_SRV_MASK),
    "vlm self prefill": flash_case(VLM_SERVE_B, VLM_SERVE_PROMPT,
                                   VLM_SERVE_PROMPT, **_VL),
    "vlm self decode": flash_case(
        VLM_SERVE_B, 1, VLM_SERVE_CACHE, **_VL,
        q_offset=VLM_SERVE_PROMPT + VLM_SERVE_STEPS - 1,
        kv_len=VLM_SERVE_PROMPT + VLM_SERVE_STEPS),
    "vlm cross prefill fp32": flash_case(
        VLM_SERVE_B, VLM_SERVE_PROMPT, 1600, **_VL, causal=False,
        dtype="float32"),
    "vlm cross decode fp32": flash_case(VLM_SERVE_B, 1, 1600, **_VL,
                                        causal=False, dtype="float32"),
    "vlm server self decode": flash_case(*_SRV, **_VL, **_SRV_MASK),
    "vlm server cross decode bf16": flash_case(SERVER_SLOTS, 1, 1600,
                                               **_VL, causal=False),
    "whisper train encoder": flash_case(8, 1500, 1500, **_WS, causal=False),
    "whisper train decoder": flash_case(8, 4096, 4096, **_WS),
    "whisper train cross": flash_case(8, 4096, 1500, **_WS, causal=False),
    "whisper prefill encoder": flash_case(WSP_SERVE_B, 1500, 1500, **_WS,
                                          causal=False),
    "whisper prefill decoder": flash_case(WSP_SERVE_B, WSP_SERVE_PROMPT,
                                          WSP_SERVE_PROMPT, **_WS),
    "whisper prefill cross": flash_case(WSP_SERVE_B, WSP_SERVE_PROMPT, 1500,
                                        **_WS, causal=False),
    "whisper decode self": flash_case(
        WSP_SERVE_B, 1, WSP_SERVE_CACHE, **_WS,
        q_offset=WSP_SERVE_PROMPT + WSP_SERVE_STEPS - 1,
        kv_len=WSP_SERVE_PROMPT + WSP_SERVE_STEPS),
    "whisper decode cross": flash_case(WSP_SERVE_B, 1, 1500, **_WS,
                                       causal=False),
    "whisper server decode self": flash_case(*_SRV, **_WS, **_SRV_MASK),
    "whisper server decode cross": flash_case(SERVER_SLOTS, 1, 1500, **_WS,
                                              causal=False),
    "zamba2 train": flash_case(8, 4096, 4096, **_ZA),
    "zamba2 prefill": flash_case(ZAMBA_SERVE_B, ZAMBA_SERVE_PROMPT,
                                 ZAMBA_SERVE_PROMPT, **_ZA),
    "zamba2 decode": flash_case(
        ZAMBA_SERVE_B, 1, ZAMBA_SERVE_CACHE, **_ZA,
        q_offset=ZAMBA_SERVE_PROMPT + ZAMBA_SERVE_STEPS - 1,
        kv_len=ZAMBA_SERVE_PROMPT + ZAMBA_SERVE_STEPS),
    "zamba2 server decode": flash_case(*_SRV, **_ZA, **_SRV_MASK),
    "tinyllama train 2x2x2": flash_case(8, 4096, 4096, 16, 2, 64),
    # the fp32 kernel at the two pairs it took first: gemma2-2b's global
    # attention (hd 256, cap 50) and deepseek's MLA (192, 128), strided v,
    # as the fp32 witnesses run them, at 2 batch rows
    "gemma2 global fp32": flash_case(2, 4096, 4096, *_GE, 0, 0, None,
                                     dtype="float32"),
    "deepseek fp32": flash_case(2, 4096, 4096, **_DS, dtype="float32")}
#: phase 7's synthetic backward launches, each at every ``TC_DIMS`` pair
#: in both dtypes: B, Sq, Sk, H, KV, causal, cap, window and the values
#: before ``v`` in each head of the tensor it is a view of (0: contiguous,
#: as MLA's strided ``v``); lengths ragged against every tile of both
#: dtypes' kernels (``flash_attn.BWD_TILES`` for bf16), GQA 8/8, 8/2 and
#: 8/1 (the first eight of ``tests/test_torch_cuda.py``'s ``_BWD_CASES``)
BWD_SYNTH = ((2, 300, 300, 8, 8, True, 0.0, 0, 0),
             (1, 300, 300, 8, 2, True, 30.0, 100, 0),
             (2, 200, 333, 8, 2, False, 0.0, 0, 0),
             (1, 333, 200, 8, 8, False, 50.0, 0, 0),
             (1, 257, 257, 8, 2, True, 0.0, 64, 0),
             (1, 130, 130, 8, 1, True, 0.0, 0, 0),
             (2, 97, 161, 8, 1, False, 30.0, 0, 64),
             (1, 700, 700, 4, 4, True, 0.0, 300, 64))
#: phase 7's backward cases: every training launch of the path phases
#: (``path_bwd`` records them: phase 31's fp32 steps of gemma2-2b and
#: deepseek on ``2x2x1`` among them, the wide pairs' path), the fp32 shape
#: ``tools/flash_ab.py`` times and phase 31's fp32 TinyLlama on ``2x2x2``
BWD_CASES = {name: FLASH_MODEL_CASES[name] for name in (
    "tinyllama train", "tinyllama train 2x2x2", "gemma2 train local",
    "gemma2 train global", "deepseek train", "whisper train encoder",
    "whisper train decoder", "whisper train cross", "zamba2 train")} | {
    "train fp32": flash_case(4, 1024, 1024, 8, 8, 64, dtype="float32"),
    "tinyllama fp32 2x2x2": flash_case(8, 4096, 4096, 16, 2, 64,
                                       dtype="float32"),
    "gemma2 fp32 train local": flash_case(
        4, 4096, 4096, *_GE, 4096, dtype="float32", scale_of="float32"),
    "gemma2 fp32 train global": flash_case(
        4, 4096, 4096, *_GE, 0, dtype="float32", scale_of="float32"),
    "deepseek fp32 train": flash_case(4, 4096, 4096, **_DS, dtype="float32",
                                      scale_of="float32")}
#: each training phase's step ms and peak GiB with the plain attention
#: backward, the last run before the backward kernel (PERF.md §5; an
#: NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's
PLAIN_BWD_STEPS = {"phase 9": (4107.0, 45.03), "phase 10": (4070.3, 45.03),
                   "int8": (4059.8, 45.03), "sparse": (4092.0, 45.03),
                   "phase 19": (2518.7, 65.10), "phase 22": (1114.5, 59.43),
                   "phase 25": (4625.2, 40.02), "phase 27": (3446.9, 29.20),
                   "phase 29": (4684.0, 65.89), "phase 31": (2356.7, 42.05)}
#: phase 7's synthetic decode-kernel launches over 2 KV heads, each at
#: every ``TC_DIMS`` pair in both dtypes: G (query heads a KV head), Sq,
#: Sk, q_offset, kv_len, causal, cap, window.  A ragged ``kv_len``, the
#: window inside the cache and past it, cap 50, Sq 4, cross launches.
DECODE_CASES = ((1, 1, 2000, 1990, 1991, True, 0.0, 0),
                (2, 1, 2048, 2011, 2012, True, 50.0, 1024),
                (8, 4, 2048, 1020, 1024, True, 30.0, 256),
                (16, 1, 1100, 1099, 1100, True, 0.0, 2000),
                (48, 1, 1500, 0, None, False, 0.0, 0),
                (8, 1, 1600, 0, None, False, 50.0, 0))
#: TinyLlama depth, cut from the published 22: the int8 reduction's peak
#: is about four times the 8 ranks' fp32 gradient bytes (the caller's
#: gradients and state, the two packed arenas), and 22 layers of fp32
#: gradients for 8 ranks alone are 35 GB of the card's 80
LAYERS = 4
SOURCES = {"tree_reduce": "src/repro_torch/kernels/csrc/tree_reduce.cu",
           "quant": "src/repro_torch/kernels/csrc/quant.cu",
           "sparse": "src/repro_torch/kernels/csrc/sparse.cu",
           "flash_attn": "src/repro_torch/kernels/csrc/flash_attn.cu",
           "flash_bwd": "src/repro_torch/kernels/csrc/flash_bwd.cu"}
#: the pallas_call each kernel replaces
REPLACES = {"tree_reduce_slots": "src/repro/kernels/tree_reduce.py:101",
            "tree_reduce": "src/repro/kernels/tree_reduce.py:56",
            "quantize": "src/repro/kernels/quant.py:52",
            "dequant_accum": "src/repro/kernels/quant.py:99",
            "dequant_accum_slots": "src/repro/kernels/quant.py:148",
            "dequantize": "src/repro/kernels/quant.py:171",
            "sparse_accum_slots": "src/repro/kernels/sparse_accum.py:123",
            "sparse_accum": "src/repro/kernels/sparse_accum.py:67",
            "topk_compact": "src/repro/kernels/topk_compact.py:95",
            "flash_attention": "src/repro/kernels/flash_attn.py:86",
            "flash_fwd_tf32_kernel": "src/repro/kernels/flash_attn.py:86",
            # the reference has no backward kernel: XLA differentiates attend
            "flash_attention_bwd": "src/repro/models/base.py:189",
            "flash_bwd_dkdv_wgmma_kernel": "src/repro/models/base.py:189",
            "flash_bwd_dq_wgmma_kernel": "src/repro/models/base.py:189",
            "flash_bwd_dkdv_tf32_kernel": "src/repro/models/base.py:189",
            "flash_bwd_dq_tf32_kernel": "src/repro/models/base.py:189",
            "flash_bwd_dot_kernel": "src/repro/models/base.py:189",
            "flash_decode_mma_kernel": "src/repro/kernels/flash_attn.py:86"}
QBLOCK = 256
#: the sparse path's fractions: the root densifies at 0.01, the level-1
#: switches at 0.05 (``density_threshold`` 0.25)
SPARSE_FRACS = (0.01, 0.05)
#: the SparCML sparsifier's setting: one value of every block of 512
SPARCML_K = 1
#: the informative part of a templated kernel name in a profile
KERNEL_NAME = re.compile(
    r"(tree_reduce|quantize|dequantize|dequant_accum|accum_sorted|"
    r"accum_scatter|zero|topk|flash_fwd_wgmma|flash_fwd_tf32|"
    r"flash_decode_join|flash_decode_mma|flash_decode|flash_bwd_dot|"
    r"flash_bwd_dkdv_wgmma|"
    r"flash_bwd_dq_wgmma|flash_bwd_dkdv_tf32|flash_bwd_dq_tf32)"
    r"_kernel(<[^>]*>)?|"
    r"\w*gemm\w*|"
    r"CatArrayBatchedCopy\w*|\w*(Sort|sort|TopK|topk|Select)\w*|"
    r"\w+_kernel_cuda|\w*Functor\w*(<\w+>)?")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    a, b = a.contiguous(), b.contiguous()
    return torch.equal(a.view(ints[a.element_size()]),
                       b.view(ints[b.element_size()]))


def same_or_both_nan(a, b) -> bool:
    """Bitwise, except that a NaN matches any NaN."""
    import torch
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def trees_same_bits(a, b) -> bool:
    from repro_torch import tree
    return all(same_bits(x, y) for x, y in zip(tree.flatten(a)[0],
                                               tree.flatten(b)[0]))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters``
    calls queued behind a sleep on the card (twice the host's time for
    them, at most 50 ms), so that the host's launch cost does not pace
    short launches (a call that synchronises is paced all the same)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ahead = min(2 * iters * (time.perf_counter() - t0), 0.05)
    torch.cuda._sleep(int(ahead * 2e9))         # cycles, at most 2 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(torch, fn, n):
    """Host time of ``n`` synchronised calls: (median, all)."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), ts


def phase_build(kb, sources) -> None:
    t0 = time.perf_counter()
    libs = kb.build(*sources)
    took = time.perf_counter() - t0
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        print(f"build: {lib.name}; {len(regs)} kernels, registers max "
              f"{max(regs)}, spill stores max {max(spills, default=0)} "
              "bytes")
    print(f"build: {len(libs)} sources in {took:.1f} s, compiled at once")


def phase_kernel_vs_plain(torch, ops) -> None:
    """Bitwise kernel vs plain version over dtypes, P, G, layouts."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        for p in (1, 2, 3, 4, 8, 64):
            for s, e in ((5, 256), (3, 100)):
                shape = (3, p, s, e)
                if dtype == torch.int32:
                    x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                      device="cuda", dtype=dtype)
                else:
                    x = (torch.randn(shape, generator=gen, device="cuda")
                         * 100).to(dtype)
                    x[0, :, 0, :8] = -0.0       # a row of -0.0 for every P
                got = ops.tree_reduce_slots(x)
                want = ops.tree_reduce_slots_plain(x)
                torch.cuda.synchronize()
                check(same_bits(got, want), f"kernel != plain {dtype} {shape}")
                cases += 1
        if dtype.is_floating_point:
            # a (G=4, P=2) stack gathered along the leading rank axis
            x = torch.randn((2, 4, 6, 256), generator=gen,
                            device="cuda").to(dtype).movedim(0, 1)
            check(same_bits(ops.tree_reduce_slots(x),
                            ops.tree_reduce_slots_plain(x)),
                  f"kernel != plain on a strided stack {dtype}")
            cases += 1
        # the flat (P, N) form, P padded from 3
        x = (torch.randn((3, 4100), generator=gen, device="cuda")
             * 100).to(dtype)
        check(same_bits(ops.tree_reduce(x),
                        ops.tree_reduce_slots_plain(x.reshape(1, 3, 1, -1))
                        .reshape(-1)), f"flat tree_reduce != plain {dtype}")
        cases += 1
    torch.cuda.synchronize()
    print(f"tree_reduce kernel vs plain: {cases} cases bitwise equal "
          "(f32 bf16 f16 int32; P 1 2 3 4 8 64; G=3; ragged; strided; "
          "-0.0; flat)")


def phase_quant_vs_plain(torch, ops, qt) -> None:
    """Bitwise quant kernels vs their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for qblock in qt.QBLOCKS:
            x = (torch.randn((6, 4 * qblock), generator=gen, device="cuda")
                 * 50).to(dtype)
            x[0, :qblock] = 0.0                                 # zero block
            x[1, :qblock] = (torch.arange(qblock, device="cuda") % 7
                             - 3.5).to(dtype)                   # k + 1/2
            x[1, 0], x[1, 1] = 127.0, -127.0                    # ±127 ties
            x[2, 5], x[3, qblock + 1] = float("nan"), float("inf")
            q, s = ops.quantize(x, qblock)
            pq, ps = ops.quantize_plain(x, qblock)
            torch.cuda.synchronize()
            check(same_or_both_nan(s, ps), f"quantize scales {dtype} {qblock}")
            check(same_bits(q[:2], pq[:2]) and same_bits(q[4:], pq[4:]),
                  f"quantize q {dtype} {qblock}")
            check(bool((s[0, 0] == ps[0, 0]) & (q[1, 0] == 127)),
                  "zero and tie blocks")
            cases += 1
            for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
                check(same_bits(ops.dequantize(q[4:], s[4:], qblock,
                                               out_dtype),
                                ops.dequantize_plain(q[4:], s[4:], qblock,
                                                     out_dtype)),
                      f"dequantize {out_dtype} {qblock}")
                cases += 1
            v = x[4:].contiguous()
            want = ops.dequantize_plain(q[4:], s[4:], qblock, minuend=v)
            check(same_bits(ops.dequantize(q[4:], s[4:], qblock, minuend=v),
                            want), f"residual {dtype} {qblock}")
            ops.dequantize(q[4:], s[4:], qblock, minuend=v, out=v)
            check(same_bits(v, want), f"residual in place {dtype} {qblock}")
            cases += 2
        rows = torch.randn((3, 2560), generator=gen, device="cuda").to(
            dtype)[:, 256:2304]
        for a, b in zip(ops.quantize(rows), ops.quantize_plain(rows)):
            check(same_bits(a, b), f"quantize on strided rows {dtype}")
        cases += 1
    wire = qt.wire_launches
    for p in (1, 2, 3, 4, 5, 8):
        q = torch.randint(-127, 128, (3, p, 7, 1024), generator=gen,
                          device="cuda", dtype=torch.int8)
        s = torch.rand((3, p, 7, 4), generator=gen, device="cuda") * 4
        for order in (False, True):          # the switch's, the wire's
            for qq, ss in ((q, s), (q[:, ::2], s[:, ::2]),
                           (q.movedim(0, 1), s.movedim(0, 1))):
                check(same_bits(
                    ops.dequant_accum_slots(qq, ss, wire_order=order),
                    ops.dequant_accum_slots_plain(qq, ss, wire_order=order)),
                      f"dequant_accum_slots {tuple(qq.shape)} {qq.stride()}"
                      f" wire_order={order}")
                cases += 1
            flat, fs = q[0].reshape(p, -1), s[0].reshape(p, -1)
            check(same_bits(ops.dequant_accum(flat, fs, wire_order=order),
                            ops.dequant_accum_plain(flat, fs,
                                                    wire_order=order)),
                  f"dequant_accum P={p} wire_order={order}")
            cases += 1
    torch.cuda.synchronize()
    check(qt.wire_launches - wire == 6 * 4, "the wire order missed its "
          "kernel")
    print(f"quant kernels vs plain: {cases} cases bitwise equal (quantize "
          "f32 bf16 f16, qblock 32..1024, zero/tie/NaN/inf blocks, strided "
          "rows; dequantize to f32 bf16 f16 and the residual, in place "
          "too; dequant_accum_slots P 1 2 3 4 5 8, G=3, strided P and G, "
          "in the switch's and the wire's order; dequant_accum in both)")


def phase_profile(torch, run, card: str, what: str) -> None:
    """Where one reduction's device time goes: ``torch.profiler`` over a
    warm run, device time by kernel, largest first.  It records the
    device's activity alone: the host's operator events add nothing to
    the table and cost more than the run to collect (a whisper training
    step's profile took 99.4 s with them and 31.8 s without on an
    H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(r[0] for r in rows)
    if total == 0:
        print(f"profile of {what}: the profiler saw no device time "
              "(not measured)")
        return
    print(f"profile of {what} [{card}]: device time {total / 1e3:.3f} ms "
          f"in {wall:.3f} ms of wall time under the profiler, by kernel:")
    # the largest twelve, and this repo's kernels wherever they rank
    ranked = sorted(rows, reverse=True)
    for n, (us, key, count) in enumerate(ranked):
        m = KERNEL_NAME.search(key)
        if n < 12 or (m and m.group(1)):
            print(f"  {us / 1e3:9.3f} ms {us / total:6.1%}  x{count}  "
                  f"{m.group(0) if m else key[:70]}")


def make_grads(torch, tree, transformer, cfg, mesh_shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = transformer.init_params(cfg, gen)
    return tree.map_leaves(
        lambda p: torch.randn((*mesh_shape, *p.shape), generator=gen,
                              device="cuda"), params)


def own_grads(torch, tree, transformer, cfg, mesh, seed):
    """``make_grads``' gradients as one rank of ``mesh`` (a
    ``ProcessMesh``) holds them: the same draws on the card, leaf by
    leaf, this rank's slice of each kept (``mesh.own``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves, spec = tree.flatten(transformer.init_params(cfg, gen))
    shapes = [tuple(l.shape) for l in leaves]
    del leaves
    own = []
    for shape in shapes:
        full = torch.randn((*mesh.shape, *shape), generator=gen,
                           device="cuda")
        own.append(mesh.own(full).clone())
        del full
    return tree.unflatten(spec, own)


def proc_rank(seed: int) -> dict:
    """One rank of phase 37, in a process of its own (``procs.spawn``):
    the reductions of (a) and the train steps of (b), each with its
    launch counters set to 0 just before and read just after.  Returns
    what the parent checks: digests, times, launches, losses."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import tinyllama_1_1b as tl
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.launch import procs
    from repro_torch.launch import train as launch
    from repro_torch.mesh import AXES
    from repro_torch.models import transformer

    def zero_reduction_counts():
        tr.launches = 0
        for counts in (qt.launches, sa.launches):
            for k in counts:
                counts[k] = 0

    def reduction_counts() -> dict:
        """The reductions' launches by role name (``proc_launch_plan``),
        the ones that did not launch left out."""
        got = {"fold": tr.launches, "quantize": qt.launches["quantize"],
               "int8 fold": qt.launches["dequant_accum_slots"],
               "dequantize": qt.launches["dequantize"],
               "densify": sa.launches["sparse_accum_slots"]}
        return {k: v for k, v in got.items() if v}

    mesh, _ = procs.setup(PROC_MESH, AXES, device="cuda", backend="gloo")
    out = {"rank": mesh.rank, "coords": mesh.coords}
    grads = own_grads(torch, tree, transformer,
                      tl.CONFIG.scaled(n_layers=LAYERS), mesh, seed)
    for name, kw in PROC_REDUCTIONS:
        red = GradReducer(FlareConfig(axes=AXES, **kw), mesh)
        got = {"ms": []}
        for i in range(PROC_RUNS):
            dist.barrier()
            torch.cuda.synchronize()
            zero_reduction_counts()
            t0 = time.perf_counter()
            res, state = red(grads)
            torch.cuda.synchronize()
            got["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                got["launches"] = reduction_counts()
                got["digests"] = [digest(torch, [l])
                                  for l in tree.flatten(res)[0]]
                got["state"] = (None if state is None else
                                digest(torch, tree.flatten(state)[0]))
            del res, state
        out[name] = got
    del grads
    torch.cuda.empty_cache()
    for label, flags, dtype in PROC_TRAIN:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.tc_launches = fa.fp32_launches = 0
        fa.bwd_launches = fa.bwd_tf32_launches = 0
        zero_reduction_counts()
        run = launch.setup(flags + ["--ranks", "processes"],
                           n_layers=PROC_LAYERS,
                           dtype=getattr(torch, dtype))
        got = {"losses": [], "norms": [], "ms": []}
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = run.train_step()
            got["losses"].append(float(m["loss"]))
            got["norms"].append(float(m["grad_norm"]))
            got["ms"].append((time.perf_counter() - t0) * 1e3)
        got["launches"] = dict(
            forward=fa.fp32_launches if label == "fp32" else fa.tc_launches,
            all_forward=fa.launches, backward=fa.bwd_launches,
            backward_tf32=fa.bwd_tf32_launches, **reduction_counts())
        got["peak"] = torch.cuda.max_memory_allocated()
        out[label] = got
        del run
        torch.cuda.empty_cache()
    procs.teardown()
    return out


def phase_processes(torch, card, cfg, seed) -> dict:
    """Phase 37 (module docstring): the emulated references on the card,
    NCCL's refusal, then ``PROC_WORLD`` processes on the card.  Returns
    the figures of the phase's JSON line."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.launch import procs
    from repro_torch.mesh import AXES, RankMesh
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    mesh = RankMesh(PROC_MESH, AXES)
    coords = list(itertools.product(*map(range, PROC_MESH)))
    grads = make_grads(torch, tree, transformer, cfg, PROC_MESH, seed)
    want, emu_ms = {}, {}
    for name, kw in PROC_REDUCTIONS:
        red = GradReducer(FlareConfig(axes=AXES, **kw), mesh)
        res, state = red(grads)
        want[name] = [dict(
            digests=[digest(torch, [l[c]]) for l in tree.flatten(res)[0]],
            state=None if state is None else digest(
                torch, [l[c] for l in tree.flatten(state)[0]]))
            for c in coords]
        del res, state
        emu_ms[name] = timed(torch, lambda: red(grads), PROC_RUNS)
    del grads, red
    emu = {label: steps_of(torch, flags, PROC_LAYERS, 2,
                           dtype=getattr(torch, dtype))
           for label, flags, dtype in PROC_TRAIN}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (c) NCCL refuses two ranks on one card before any group forms
    env = dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="2")
    with mock.patch.dict(os.environ, env):
        try:
            procs.setup((2,), ("data",), device="cuda", backend="nccl")
            refused = None
        except RuntimeError as e:
            refused = str(e)
    check(refused is not None and not dist.is_initialized(),
          "nccl with two ranks on one card did not raise before forming a "
          "process group")

    print(f"phase 37: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated here ({torch.cuda.memory_reserved() / 2**30:.2f} "
          f"reserved) as {PROC_WORLD} processes start")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = procs.spawn(proc_rank, PROC_WORLD, "gloo",
                            str(Path(tmp) / "store"), (seed,),
                            timeout=PROC_TIMEOUT)
    spawn_s = time.perf_counter() - t0

    figures = {}
    for name, _ in PROC_REDUCTIONS:
        for c, got in zip(coords, ranks):
            check(got[name]["digests"] == want[name][coords.index(c)]
                  ["digests"] and got[name]["state"]
                  == want[name][coords.index(c)]["state"],
                  f"processes: {name} on rank {c} != its slice of the "
                  "emulated reduction (result or error-feedback state)")
            plan = proc_launch_plan(name, c)
            check(got[name]["launches"] == plan,
                  f"processes: {name} on rank {c} launched "
                  f"{got[name]['launches']}, the plan {plan}")
        calls = [max(r[name]["ms"][i] for r in ranks)
                 for i in range(PROC_RUNS)]
        figures[name] = dict(
            ms=statistics.median(calls), calls_ms=calls,
            emulated_ms=emu_ms[name][0],
            launches=[r[name]["launches"] for r in ranks])
        print(f"processes: {name} reduction of TinyLlama's {LAYERS}-layer "
              f"gradients on {PROC_MESH}, {PROC_WORLD} processes: every "
              f"rank's bits == its slice of the emulated reduction (a digest "
              f"a leaf, one for its error-feedback state); launches by rank "
              f"{figures[name]['launches']}, as planned; ms (median of "
              f"{PROC_RUNS}, the slowest rank's each, gloo on one card, "
              f"staged through the host) {figures[name]['ms']:.1f} (calls "
              f"{[round(t, 1) for t in calls]}); emulated on the card "
              f"{emu_ms[name][0]:.3f} [{card}]")

    for label, _, _ in PROC_TRAIN:
        e = emu[label]
        lossy = label.split()[1] if " " in label else None
        for c, got in zip(coords, ranks):
            g = got[label]
            lc = g["launches"]
            check(lc["forward"] > 0 and lc["backward"] > 0
                  and lc["forward"] == lc["all_forward"],
                  f"processes {label} step on rank {c}: launches {lc}")
            if label == "fp32":
                check(lc["backward_tf32"] == lc["backward"],
                      f"processes fp32 on rank {c}: backward off the TF32 "
                      f"kernels {lc}")
            # the reductions' kernels on the ranks the plan names and
            # nowhere else; a step's small arena takes the int8 plane's
            # tree design, whose fold is tree_reduce_slots (and another
            # count than (a)'s), so either fold is the fold here
            plan = proc_launch_plan(
                f"{lossy} innetwork" if lossy else "innetwork", c)
            check(reduction_kinds(lc) == reduction_kinds(plan),
                  f"processes {label} on rank {c}: reduction launches "
                  f"{lc}, the plan's kernels {sorted(plan)}")
            vals = g["losses"] + g["norms"]
            check(all(map(math.isfinite, vals)),
                  f"processes {label} on rank {c}: {vals}")
            if label != "bf16":
                rel = max(abs(a - b) / abs(b) for a, b in zip(
                    vals, e["losses"] + e["norms"]))
                check(rel <= PROC_FP32_RTOL,
                      f"processes {label} on rank {c}: {rel} from the "
                      "emulated steps")
        steps = [max(r[label]["ms"][i] for r in ranks) for i in range(2)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            ranks[0][label]["losses"] + ranks[0][label]["norms"],
            e["losses"] + e["norms"]))
        bitwise = all(r[label]["losses"] == e["losses"]
                      and r[label]["norms"] == e["norms"] for r in ranks)
        figures[f"train {label}"] = dict(
            losses=ranks[0][label]["losses"], norms=ranks[0][label]["norms"],
            emulated_losses=e["losses"], emulated_norms=e["norms"],
            worst_rel=rel, bitwise=bitwise, step_ms=steps,
            emulated_step_ms=e["step_ms"],
            launches=[r[label]["launches"] for r in ranks],
            peak_gib=max(r[label]["peak"] for r in ranks) / 2**30)
        print(f"processes: launch.train --ranks processes, {label}, "
              f"TinyLlama at {PROC_LAYERS} of 22 layers, {PROC_MESH}, one "
              f"4096-token sequence a rank, 2 steps: losses "
              f"{ranks[0][label]['losses']} norms {ranks[0][label]['norms']}"
              f" (every rank the same); emulated losses {e['losses']} norms "
              f"{e['norms']}; worst relative {rel:.2e}"
              + ("" if label == "bf16" else
                 f" (tolerance {PROC_FP32_RTOL})")
              + f", every rank's bits the emulated steps': {bitwise}"
              + f"; step ms (the slowest rank's, gloo staged through the "
              f"host) {[round(t, 1) for t in steps]}, emulated "
              f"{e['step_ms']:.1f}; per process launches "
              f"{ranks[0][label]['launches']} (rank 0), by rank "
              f"{[r[label]['launches'] for r in ranks]}; peak a "
              f"process {figures[f'train {label}']['peak_gib']:.2f} GiB "
              f"[{card}]")
    print(f"processes: nccl with two ranks on one card raised before any "
          f"group formed: {refused!r}")
    print(f"phase 37: {PROC_WORLD} processes {spawn_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return figures


def check_against_fp64(torch, grads, out, lead) -> float:
    """Every leaf within a 3-level tree's rounding of the fp64 sum:
    |r - s| <= 3 · 2^-24 · Σ|x| elementwise.  Returns the worst ratio."""
    worst = 0.0
    for g, r in zip(grads, out):
        x = g.double()
        exact = x.sum(dim=tuple(range(lead)))
        bound = 3 * 2.0**-24 * x.abs().sum(dim=tuple(range(lead)))
        err = (r[(0,) * lead].double() - exact).abs()
        check(bool((err <= bound).all()), "result outside fp64 bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
        del x, exact, bound, err
    return worst


def check_wire_bound(torch, grads, out, p) -> float:
    """Every rank holds the same bits, within ``(P - 1) · 2^-24 · Σ|x|``
    of the fp64 sum (a chain of P - 1 fp32 adds, the longest any wire
    schedule takes).  Returns the worst ratio to the bound."""
    worst = 0.0
    for g, r in zip(grads, out):
        iv = r.view(torch.int32)
        check(bool((iv == iv[0, 0]).all()), "the ranks' results differ")
        del iv
        x = g.double()
        exact = x.sum(dim=(0, 1))
        bound = (p - 1) * 2.0**-24 * x.abs().sum(dim=(0, 1))
        err = (r[0, 0].double() - exact).abs()
        check(bool((err <= bound).all()), "wire result outside fp64 bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
        del x, exact, bound, err
    return worst


def check_quant_bound(torch, group, leaves, out_leaves, mesh,
                      rounds=3) -> float:
    """Step 1 of the int8 path against the fp64 sum of the gradients.

    Each quantization on an element's path errs by at most half a step
    of its block, and every level's blocks cover the same 256 positions
    of a bucket.  A leaf rank's step is its block's ``max|x| / 127``; an
    aggregate is at most the sum of its children's dequantized maxima, so
    its step is at most the sum of their steps, and a full sum's at most
    the sum of every leaf's.  With ``rounds`` quantizations on the path
    (in the network on the ``(2, 4)`` mesh 3: every leaf rank, every
    level-1 switch, the root) that bounds the error by ``rounds / 2 ·
    Σ_r step_r``, with 2^-10 of slack for the fp32 rounding of the folds.
    Checked block by block on the arena; returns the worst ratio of error
    to bound."""
    check(len(mesh.shape) == 2, "the bound is written for a 2-level mesh")
    x = group.pack(leaves)                                   # (2, 4, B, S)
    red = group.pack([o[:1, :1] for o in out_leaves])[0, 0]  # (B, S)
    worst = 0.0
    for b in range(x.shape[-2]):
        xb = x[..., b, :].double()
        exact = xb.sum(dim=(0, 1))
        steps = xb.abs().reshape(*mesh.shape, -1, QBLOCK).amax(-1) / 127
        bound = (rounds / 2 * (1 + 2.0**-10) * steps.sum(dim=(0, 1))
                 ).repeat_interleave(QBLOCK)
        err = (red[b].double() - exact).abs()
        check(bool((err <= bound).all()), f"int8 result outside the "
              f"quantization bound in bucket {b}")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
    return worst


#: the digest's modulus, the prime 2^31 - 1
DIGEST_P = (1 << 31) - 1


def digest(torch, tensors) -> tuple[int, int]:
    """Two sums of the bit patterns of ``tensors`` (in order), each
    pattern times a weight of its position, modulo the prime 2^31 - 1:
    equal bits give equal digests, and any change of bits changes both
    but with a chance of about 2^-62.  Used to hold a full-size result
    against its plain twin where the two do not fit on the card at
    once."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    d1 = d2 = pos = 0
    for t in tensors:
        flat = t.contiguous().view(ints[t.element_size()]).reshape(-1)
        for i in range(0, flat.numel(), 1 << 26):
            b = flat[i:i + (1 << 26)].long() % DIGEST_P
            w = torch.arange(pos + i, pos + i + b.numel(), device=b.device)
            d1 = (d1 + int(((b * (w % DIGEST_P + 1)) % DIGEST_P).sum())
                  ) % DIGEST_P
            d2 = (d2 + int(((b * ((w * 48271) % DIGEST_P + 1)) % DIGEST_P
                            ).sum())) % DIGEST_P
        pos += flat.numel()
    return d1, d2


def plain_quant_patches(qt, ops):
    """The int8 kernels' entries patched to their plain versions."""
    return [mock.patch.object(qt, "quantize", ops.quantize_plain),
            mock.patch.object(qt, "dequantize", ops.dequantize_plain),
            mock.patch.object(qt, "dequant_accum_slots",
                              ops.dequant_accum_slots_plain),
            mock.patch.object(qt, "dequant_accum", ops.dequant_accum_plain)]


def run_plain(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


class Recorder:
    """Wraps a kernel entry to record the arguments of every launch."""

    def __init__(self, module, name, describe):
        self.module, self.name, self.describe = module, name, describe
        self.real = getattr(module, name)
        self.seen = []

    def __call__(self, *a, **kw):
        self.seen.append(self.describe(*a, **kw))
        return self.real(*a, **kw)

    def patch(self):
        return mock.patch.object(self.module, self.name, self)


def sorted_lists(torch, gen, rows, e, size):
    """The sparse plane's list form: ascending as unsigned integers, 80 %
    distinct indices (some at and past ``size``) then a ``-1`` tail;
    entries 1 and 2 of each row share an index."""
    m = int(0.8 * e)
    keys = torch.rand((rows, size + 50), generator=gen, device="cuda")
    idx = torch.full((rows, e), -1, dtype=torch.int32, device="cuda")
    idx[:, :m] = keys.argsort(dim=1)[:, :m].sort(dim=1).values.int()
    idx[:, 1] = idx[:, 2]
    return idx


def phase_sparse_vs_plain(torch, ops, tk, sa, sparse) -> None:
    """The sparse kernels vs their plain versions: bitwise, except three
    or more duplicates of an index in unsorted lists (rtol = atol =
    1e-5, the reference's own tolerance) and NaN payloads."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for b, e, size in ((1, 777, 10_007), (3, 4099, 50_000),
                           (294, 1500, 30_001)):
            idx = sorted_lists(torch, gen, b, e, size)
            val = torch.randn((b, e), generator=gen, device="cuda").to(dtype)
            want = ops.sparse_accum_slots_plain(idx, val, size)
            got = ops.sparse_accum_slots(idx, val, size, indices_sorted=True)
            torch.cuda.synchronize()
            check(same_bits(got, want), f"sorted sparse_accum_slots {dtype} "
                  f"{(b, e, size)}")
            fi, fv = idx.flip(1).contiguous(), val.flip(1).contiguous()
            check(same_bits(ops.sparse_accum_slots(fi, fv, size),
                            ops.sparse_accum_slots_plain(fi, fv, size)),
                  f"unsorted sparse_accum_slots {dtype} {(b, e, size)}")
            cases += 2
        # a (G, B) stack strided over G, unsorted, many duplicates
        lists = torch.randint(-3, 70, (3, 2, 5000), generator=gen,
                              device="cuda", dtype=torch.int32)
        vals = torch.randn((3, 2, 5000), generator=gen, device="cuda").to(
            dtype)
        got = ops.sparse_accum_slots(lists.movedim(0, 1), vals.movedim(0, 1),
                                     64)
        want = ops.sparse_accum_slots_plain(lists.movedim(0, 1),
                                            vals.movedim(0, 1), 64)
        check(bool(torch.isclose(got, want, rtol=1e-5, atol=1e-5).all()),
              f"unsorted triples {dtype}")
        flat = ops.sparse_accum(lists[0, 0], vals[0, 0], 64)
        check(bool(torch.isclose(flat, want[0, 0], rtol=1e-5,
                                 atol=1e-5).all()), f"flat {dtype}")
        cases += 2
        for block in tk.BLOCKS:
            for k in sorted({1, 2, 8, 64, block - 1, block}):
                if not 1 <= k <= block:
                    continue
                x = torch.randn((12, block), generator=gen, device="cuda")
                x[1] = torch.randint(-3, 4, (block,), generator=gen,
                                     device="cuda") / 2        # ties
                x[2] = 0.0
                x[3, ::2] = -0.0
                x[4, 0], x[5, block - 1] = float("inf"), float("nan")
                x[6, 1], x[6, 2] = float("-inf"), float("inf")
                # the cluster: every entry above the threshold, the cap by
                # index order decides
                x[8] = 1 + 1e-4 * torch.rand(block, generator=gen,
                                             device="cuda")
                x[8, block // 3] = 1e6
                x[9] = float("nan")
                x[10] = float("inf")
                x[10, ::3] = float("-inf")
                x = x.to(dtype).reshape(-1)
                v, i = ops.topk_compact(x, k, block)
                pv, pi = ops.topk_compact_plain(x, k, block)
                torch.cuda.synchronize()
                check(torch.equal(i, pi) and same_or_both_nan(v, pv),
                      f"topk_compact {dtype} block {block} k {k}")
                cases += 1
    # core/sparse.scatter_dense, which launches the sorted mode on the
    # card: index-sorted, index-unique lists with their SENTINEL tail
    # (as topk_sparsify and merge_coordinate_lists give them), -0.0 and
    # ordinary values, into fp32 and into a bf16 ``mine``
    launched = 0
    for dtype in (torch.float32, torch.bfloat16):
        keys = torch.rand((6, 50_050), generator=gen, device="cuda")
        idx = torch.full((6, 3000), sparse.SENTINEL, dtype=torch.int32,
                         device="cuda")
        idx[:, :2400] = keys.argsort(dim=1)[:, :2400].sort(dim=1).values.int()
        val = torch.randn((6, 3000), generator=gen, device="cuda").to(dtype)
        val[:, ::3] = -0.0
        lead = (2, 3)
        before = sa.launches["sparse_accum_slots"]
        got = sparse.scatter_dense(val.view(*lead, -1), idx.view(*lead, -1),
                                   50_000, dtype)
        launched += sa.launches["sparse_accum_slots"] - before
        want = sparse.scatter_dense(val.cpu().view(*lead, -1),
                                    idx.cpu().view(*lead, -1), 50_000, dtype)
        check(same_bits(got.cpu(), want), f"scatter_dense {dtype} on the "
              "card != the CPU's")
        cases += 1
    check(launched == 2, "scatter_dense missed the kernel on the card")
    print(f"sparse kernels vs plain: {cases} cases (sparse_accum_slots "
          "sorted and unsorted, -1 and out-of-range entries, duplicates, "
          "B 1 3 294, strided G, ragged E and size, f32 bf16 f16: bitwise, "
          "unsorted triples within rtol = atol = 1e-5; topk_compact every "
          "block size, k 1 2 8 64 block-1 block, ties, zero, ±0.0, inf, "
          "NaN, cluster, all-NaN and all-inf blocks: bitwise, NaN payloads "
          "aside; sparse.scatter_dense of sorted unique lists with -0.0 "
          "values and a SENTINEL tail, fp32 and a bf16 mine, card == CPU)")


def plain_sparse_patches(sa, tk, ops):
    """The sparse kernels' entries patched to their plain versions."""
    return [mock.patch.object(
                sa, "sparse_accum_slots",
                lambda i, v, size, indices_sorted=False:
                ops.sparse_accum_slots_plain(i, v, size)),
            mock.patch.object(
                sa, "sparse_accum", lambda i, v, size:
                ops.sparse_accum_slots_plain(i[None], v[None], size)[0]),
            mock.patch.object(tk, "topk_compact", ops.topk_compact_plain)]


class SparseSpy:
    """Wraps ``dataplane.switch_allreduce_sparse`` inside a reduction: it
    asks for the collision counts and keeps them, notes the device memory
    allocated when the plane starts and the peak when it returns, and on
    its first call keeps a few buckets of the arena ``v``, of the lists
    sent and of the result (for the checks), then hands the transport
    what it expects."""

    def __init__(self, dataplane, buckets):
        self.dataplane, self.buckets = dataplane, buckets
        self.real = dataplane.switch_allreduce_sparse
        self.collisions, self.kept, self.memory = [], None, []

    def __call__(self, arena, mesh, axes, ks, **kw):
        import torch
        held = torch.cuda.memory_allocated()
        red, sent, stats = self.real(arena, mesh, axes, ks, with_stats=True,
                                     **kw)
        self.memory.append((held, torch.cuda.max_memory_allocated()))
        self.collisions.append(stats["collisions"].clone())
        if self.kept is None:
            b = self.buckets
            self.kept = {"v": arena[..., b, :].clone(),
                         "val": sent[0][..., b, :].clone(),
                         "idx": sent[1][..., b, :].clone(),
                         "red": red[(0,) * mesh.ndim][b].clone(),
                         "ks": [ks[i] for i in b]}
        return red, sent

    def patch(self):
        return mock.patch.object(self.dataplane, "switch_allreduce_sparse",
                                 self)


class Capture:
    """Wraps a function to keep a copy of the arguments and the result of
    its calls (the first ``keep`` whose first argument has at most
    ``max_elems`` elements; every call by default), for timing a kernel on
    exactly what the path gave it or replaying a call."""

    def __init__(self, module, name, keep=None, max_elems=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.keep, self.max_elems = keep, max_elems
        self.seen, self.calls = [], 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if not ((self.keep is None or len(self.seen) < self.keep)
                and (self.max_elems is None
                     or a[0].numel() <= self.max_elems)):
            return self.real(*a, **kw)
        args = [t.clone() if hasattr(t, "clone") else t for t in a]
        out = self.real(*a, **kw)
        self.seen.append((args, kw,
                          out.clone() if hasattr(out, "clone") else out))
        return out

    def patch(self):
        return mock.patch.object(self.module, self.name, self)


def check_sparse_kept(torch, kept, sentinel) -> tuple[float, int]:
    """On the kept buckets: every rank selected exactly ``k`` entries,
    each at least as large in magnitude as every entry it left, and the
    result lies within ``8 · 2^-24 · Σ|selected|`` of the fp64 sum of
    every rank's selected entries.  Returns the worst error ratio and the
    buckets checked."""
    v, val, idx, red = kept["v"], kept["val"], kept["idx"], kept["red"]
    lead = v.shape[:-2]
    worst = 0.0
    for j, k in enumerate(kept["ks"]):
        exact = torch.zeros(v.shape[-1], dtype=torch.float64, device="cuda")
        mag = torch.zeros_like(exact)
        for rr in itertools.product(*map(range, lead)):
            ix, vs, row = idx[rr][j], val[rr][j], v[rr][j]
            ok = ix != sentinel
            check(int(ok.sum()) == k, f"rank {rr} selected {int(ok.sum())} "
                  f"!= k={k}")
            sel = torch.zeros(row.shape, dtype=torch.bool, device="cuda")
            sel[ix[ok].long()] = True
            check(bool(row.abs()[sel].min() >= row.abs()[~sel].max()),
                  f"rank {rr}: an unselected magnitude beats a selected one")
            check(same_bits(vs[ok], row[ix[ok].long()]),
                  "sent values != the arena's")
            exact.index_add_(0, ix[ok].long(), vs[ok].double())
            mag.index_add_(0, ix[ok].long(), vs[ok].double().abs())
        err = (red[j].double() - exact).abs()
        bound = 8 * 2.0**-24 * mag
        check(bool((err <= bound).all()), "sparse result outside the fp64 "
              "bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
    return worst, len(kept["ks"])


def level_perms(dataplane, mesh, axes, seed):
    """Per-slot arrival permutations, one callable per level."""
    import numpy as np

    def perm(p, n, s):
        r = np.random.default_rng(s + 31 * n)
        return np.stack([r.permutation(p) for _ in range(n)], axis=1)
    return [lambda p, n, s=seed + i: perm(p, n, s)
            for i, _ in enumerate(dataplane._levels(mesh, axes))]


def bf16_ulp(torch, x):
    """One bf16 ulp at each value (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def flash_err(torch, got, want, v) -> float:
    """Worst |kernel − plain|.  fp32: at most 3e-5.  bf16: at most one
    bf16 ulp of the plain output plus the fp32 sums' own rounding floor,
    2^-17 · max|v|: both versions sum in fp32 in different orders, and
    where an output nearly cancels, that rounding exceeds a bf16 ulp of
    the tiny result (the one-ulp claim holds wherever |o| > 2^-9·max|v|)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype == torch.float32:
        check(err <= 3e-5, f"flash fp32 error {err} > 3e-5")
    else:
        floor = 2.0**-17 * float(v.float().abs().max())
        excess = diff - bf16_ulp(torch, want)
        check(float(excess.max()) <= floor, f"flash bf16 output more than "
              f"one ulp + {floor:.2e} from plain (by {float(excess.max())})")
    return err


def decode_vs_plain(torch, fa, ref, q, k, v, kw: dict, label: str) -> tuple:
    """One launch of ``q, k, v, kw``, which must be the decode kernel's
    (``decode_launches`` and ``launches`` up by one, ``tc_launches`` not),
    twice with the same bits, against the plain version
    (``ref.flash_attention_bshd``, or ``flash_attention_partial`` with
    ``shards``) and the plain version of its own splits
    (``ref.flash_attention_split`` at ``decode_plan``'s plan), as
    :func:`partial_vs_plain` holds them (keyless rows exact).  Returns
    (the output's worst error, the log-sum-exp's, the keyless rows, the
    plan)."""
    n, b = (q.shape[0], q.shape[1]) if q.dim() == 5 else (1, q.shape[0])
    sq, h, hd = q.shape[-3:]
    sk, kvh, vd = k.shape[-3], k.shape[-2], v.shape[-1]
    mma = q.dtype == torch.bfloat16
    before = (fa.launches, fa.tc_launches, fa.decode_launches,
              fa.decode_mma_launches)
    o, lse = fa.attention_fwd(q, k, v, **kw)
    again = fa.attention_fwd(q, k, v, **kw)
    check((fa.launches, fa.tc_launches, fa.decode_launches,
           fa.decode_mma_launches) == (
        before[0] + 2, before[1], before[2] + 2, before[3] + 2 * mma),
        f"{label}: not on the {'bf16' if mma else 'fp32'} decode kernel")
    check(same_bits(o, again[0]) and same_bits(lse, again[1]),
          f"{label}: the same launch gave other bits")
    shards = kw.get("shards")
    plan = fa.decode_plan(
        n, b, h, kvh, sq, sk, hd, vd, q.dtype, causal=kw["causal"],
        window=kw["window"], q_offset=kw.get("q_offset", 0),
        kv_len=kw.get("kv_len") or sk * (shards or 1), shards=shards)
    blocks = n * b * kvh
    if mma:   # every SM a block, unless a block would not fill its ring
        # or the grid would outgrow one wave of the blocks SMs hold
        want = min(fa.SMS, blocks * max(1, plan.tiles // fa.DECODE_STAGES),
                   blocks * max(1, fa.SMS * fa.decode_blocks_per_sm(hd, vd)
                                // blocks))
    else:     # two blocks an SM where the tiles allow
        want = min(2 * fa.SMS, blocks * plan.tiles)
    check(blocks * plan.splits >= want,
          f"{label}: {blocks * plan.splits} blocks for {plan.tiles} tiles")
    res = partial_vs_plain(torch, fa, ref, (q, k, v, kw), label,
                           got=(o, lse))
    partial_vs_plain(torch, fa, ref, (q, k, v, kw), f"{label} (its splits)",
                     got=(o, lse), plain=ref.flash_attention_split(
                         q, k, v, **plan._asdict(), **kw))
    return (*res, plan)


def fp32_vs_plain(torch, fa, ref, q, k, v, kw: dict, label: str) -> float:
    """One fp32 launch of ``q, k, v, kw``, which must be the 3xTF32
    kernel's (``fp32_launches`` up by one), twice with the same bits,
    ``o`` and ``lse`` within 3e-5 of the plain version; returns the worse
    of the two errors."""
    before = fa.fp32_launches
    o, lse = fa.attention_fwd(q, k, v, **kw)
    again = fa.attention_fwd(q, k, v, **kw)
    check(fa.fp32_launches == before + 2, f"{label}: not on the fp32 kernel")
    check(same_bits(o, again[0]) and same_bits(lse, again[1]),
          f"{label}: the same launch gave other bits")
    want, plse = ref.flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    err = flash_err(torch, o, want, v)
    lerr = float((lse - plse).abs().max())
    check(lerr <= 3e-5, f"{label}: log-sum-exp {lerr} from plain > 3e-5")
    return max(err, lerr)


def phase_flash_vs_plain(torch, ops, ref, fa, base) -> None:
    """The flash kernels vs their plain version on synthetic cases."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    fa.launches = fa.tc_launches = fa.fp32_launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for h, kv in ((8, 8), (8, 1)):
            for sq, sk, causal in ((700, 700, True), (300, 1000, False),
                                   (129, 129, True)):
                for cap, win in ((0.0, 0), (30.0, 0), (0.0, 256),
                                 (30.0, 256)):
                    if win and not causal:
                        continue
                    q = torch.randn((2, sq, h, 64), generator=gen,
                                    device="cuda").to(dtype)
                    k, v = (torch.randn((2, sk, kv, 64), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(2))
                    cases += 1
                    if dtype == torch.float32:
                        worst[dtype] = max(worst[dtype], fp32_vs_plain(
                            torch, fa, ref, q, k, v, dict(
                                causal=causal, scale=0.125, attn_cap=cap,
                                window=win), f"fp32 {(sq, sk, h, kv)}"))
                        continue
                    got = ops.attention(q, k, v, causal=causal,
                                        attn_cap=cap, window=win)
                    want, _ = ref.flash_attention_bshd(
                        q, k, v, causal=causal, attn_cap=cap, window=win)
                    torch.cuda.synchronize()
                    worst[dtype] = max(worst[dtype],
                                       flash_err(torch, got, want, v))
    # every bf16 case went to the wgmma kernel, every fp32 one (launched
    # twice) to the 3xTF32 one
    check(fa.launches == 3 * cases // 2 and fa.tc_launches == cases // 2
          and fa.fp32_launches == cases,
          f"flash routing: {fa.tc_launches} bf16 and {fa.fp32_launches} "
          f"fp32 tensor-core launches of {fa.launches}, want {cases // 2} "
          f"and {cases} of {3 * cases // 2}")
    # the (BH, S, hd) signature of the TPU kernel, fp32
    q, k, v = (torch.randn((6, 333, 64), generator=gen, device="cuda")
               for _ in range(3))
    worst[torch.float32] = max(worst[torch.float32], flash_err(
        torch, ops.flash_attention(q, k, v, causal=True, attn_cap=30.0),
        ref.flash_attention(q, k, v, causal=True, attn_cap=30.0), v))
    cases += 1
    # both tensor-core kernels' other head dims: (hd, vd) with GQA 8/2,
    # causal and not, cap and window, ragged Sq and Sk, Sq > Sk (rows past
    # Sk + 255 see no key)
    wide = 0
    for hd, vd in ((16, 16), (32, 32), (128, 128), (256, 256), (192, 128)):
        for sq, sk, causal, cap, win in ((700, 700, True, 0.0, 0),
                                         (300, 1000, False, 30.0, 0),
                                         (129, 129, True, 30.0, 256),
                                         (600, 300, True, 0.0, 256)):
            q = torch.randn((2, sq, 8, hd), generator=gen, device="cuda")
            k = torch.randn((2, sk, 2, hd), generator=gen, device="cuda")
            v = torch.randn((2, sk, 2, vd), generator=gen, device="cuda")
            worst[torch.float32] = max(worst[torch.float32], fp32_vs_plain(
                torch, fa, ref, q, k, v, dict(
                    causal=causal, scale=hd ** -0.5, attn_cap=cap,
                    window=win), f"fp32 {(hd, vd)} {(sq, sk)}"))
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
            before = fa.tc_launches
            got = ops.attention(q, k, v, causal=causal, attn_cap=cap,
                                window=win)
            want, _ = ref.flash_attention_bshd(q, k, v, causal=causal,
                                               attn_cap=cap, window=win)
            torch.cuda.synchronize()
            check(fa.tc_launches == before + 1 and got.shape == want.shape,
                  f"(hd, vd) = {(hd, vd)} missed the tensor-core kernel")
            worst[torch.bfloat16] = max(worst[torch.bfloat16],
                                        flash_err(torch, got, want, v))
            wide += 2
    cases += wide
    # the fp32 kernel at (128, 128), the VLM's fp32 cross K/V: causal and
    # not, Sq != Sk, GQA 8, cap 0 and 30
    fp32_128 = 0
    for sq, sk, causal in ((700, 700, True), (300, 1600, False),
                           (129, 1000, True)):
        for cap in (0.0, 30.0):
            q = torch.randn((2, sq, 64, 128), generator=gen, device="cuda")
            k, v = (torch.randn((2, sk, 8, 128), generator=gen,
                                device="cuda") for _ in range(2))
            worst[torch.float32] = max(worst[torch.float32], fp32_vs_plain(
                torch, fa, ref, q, k, v, dict(
                    causal=causal, scale=128 ** -0.5, attn_cap=cap,
                    window=0), f"fp32 (128, 128) GQA 8 {(sq, sk)}"))
            fp32_128 += 1
    # a bf16 query over fp32 K/V through base.attend: upcast, the fp32
    # kernel, bf16 out, against the CPU's dense branch (scale rounded to
    # bf16 in both)
    q = (torch.randn((2, 300, 64, 128), generator=gen, device="cuda")
         * 4).bfloat16()
    k, v = (torch.randn((2, 1600, 8, 128), generator=gen, device="cuda")
            for _ in range(2))
    before = (fa.launches, fa.tc_launches, fa.fp32_launches)
    got = base.attend(q, k, v, causal=False).cpu()
    check((fa.launches, fa.tc_launches, fa.fp32_launches) == (
        before[0] + 1, before[1], before[2] + 1)
        and got.dtype == torch.bfloat16,
        "a bf16 query over fp32 K/V missed the fp32 kernel")
    mixed_err = flash_err(torch, got, base.attend(
        q.cpu(), k.cpu(), v.cpu(), causal=False), v.cpu())
    cases += fp32_128 + 1
    # the model's attention at hd 128 (scale 128^-0.5 rounded to bf16) on
    # the card against the dense CPU branch on the same bf16 inputs
    q = torch.randn((2, 256, 8, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((2, 256, 2, 128), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    got = base.attend(q, k, v, causal=True).cpu()
    want = base.attend(q.cpu(), k.cpu(), v.cpu(), causal=True)
    attend_err = flash_err(torch, got, want, v.cpu())
    cases += 1
    # the decode kernel, both dtypes at every TC_DIMS pair (DECODE_CASES),
    # and fp32 keys and values 4 bytes off 16 (the 4-byte copies)
    dec = {torch.float32: 0.0, torch.bfloat16: 0.0}
    dec_cases, splits, joins = 0, set(), set()
    for dt in dec:
        for hd, vd in fa.TC_DIMS:
            for g, sq, sk, off, kvl, causal, cap, win in DECODE_CASES:
                q = torch.randn((2, sq, 2 * g, hd), generator=gen,
                                device="cuda").to(dt)
                k = torch.randn((2, sk, 2, hd), generator=gen,
                                device="cuda").to(dt)
                v = torch.randn((2, sk, 2, vd), generator=gen,
                                device="cuda").to(dt)
                kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap,
                          window=win, q_offset=off, kv_len=kvl)
                label = f"decode {dt} {(hd, vd)} G {g} Sq {sq} Sk {sk}"
                err, _, _, plan = decode_vs_plain(torch, fa, ref, q, k, v,
                                                  kw, label)
                dec[dt] = max(dec[dt], err)
                splits.add(plan.splits)
                if dt == torch.bfloat16:
                    joins.add(fa.decode_cluster(plan.splits, hd, vd, 4))
                dec_cases += 1
                if dt == torch.float32 and g == 8 and sq == 4:
                    ko, vo = (torch.randn((2, sk, 2, d + 1), generator=gen,
                                          device="cuda")[..., 1:]
                              for d in (hd, vd))
                    check(bool(ko.data_ptr() % 16), "an aligned offset view")
                    err, *_ = decode_vs_plain(torch, fa, ref, q, ko, vo, kw,
                                              f"{label} off 16 bytes")
                    dec[dt] = max(dec[dt], err)
                    dec_cases += 1
    # the first 9 keys of 1100, one tile: one split, no join
    for dt in dec:
        q = torch.randn((4, 1, 16, 128), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((4, 1100, 8, 128), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        err, _, _, plan = decode_vs_plain(
            torch, fa, ref, q, k, v, dict(causal=True, scale=128 ** -0.5,
                                          attn_cap=0.0, window=0,
                                          q_offset=8, kv_len=9),
            f"decode {dt} one split")
        check(plan.splits == 1, f"one tile took {plan.splits} splits")
        dec[dt] = max(dec[dt], err)
        dec_cases += 1
    # bf16 at the most splits the plan gives (one block a split over 65536
    # keys: one split an SM, joined through scratch), each TC_DIMS pair
    for hd, vd in fa.TC_DIMS:
        q = torch.randn((1, 1, 8, hd), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((1, 65536, 1, hd), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((1, 65536, 1, vd), generator=gen,
                        device="cuda").bfloat16()
        err, _, _, plan = decode_vs_plain(
            torch, fa, ref, q, k, v, dict(causal=True, scale=hd ** -0.5,
                                          attn_cap=0.0, window=0,
                                          q_offset=65535, kv_len=65536),
            f"decode bf16 {(hd, vd)} the most splits")
        check(plan.splits == fa.SMS, f"{plan.splits} splits, not {fa.SMS}")
        joins.add(fa.decode_cluster(plan.splits, hd, vd, 1))
        splits.add(plan.splits)
        dec[torch.bfloat16] = max(dec[torch.bfloat16], err)
        dec_cases += 1
    check(joins == {True, False}, "the bf16 decode launches did not take "
          "both joins (in a cluster, through scratch)")
    cases += dec_cases
    print(f"flash decode kernels vs plain: {dec_cases} launches (G 1, 2, "
          f"8, 16 and 48, Sq 1 and 4, the masks, cross launches, fp32 on "
          f"flash_decode_kernel and bf16 on flash_decode_mma_kernel at "
          f"{list(fa.TC_DIMS)}, {min(splits)} to {max(splits)} splits a "
          f"launch, bf16's joined in a cluster and through scratch), each "
          f"twice with the same bits, against the plain version and the "
          f"plain version of its splits: worst fp32 "
          f"{dec[torch.float32]:.3e}, bf16 {dec[torch.bfloat16]:.3e}")
    print(f"flash kernels vs plain: {cases} cases within tolerance (causal "
          "and not, cap 0 and 30, window 0 and 256, GQA 1, 4 and 8, ragged "
          "Sq and Sk; fp32 on the 3xTF32 kernel, each launched twice with "
          "the same bits, o and lse at atol 3e-5, bf16 on the wgmma kernel "
          f"within one ulp + 2^-17 max|v|, {wide} of them at (hd, vd) = "
          "(16, 16), (32, 32), (128, 128), (256, 256), (192, 128) in both "
          f"dtypes; {fp32_128} fp32 at (128, 128), GQA 8, Sq != Sk); worst "
          f"error fp32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}; base.attend bf16 hd 128 on the card "
          f"vs the CPU's dense branch {attend_err:.3e}; a bf16 query over "
          f"fp32 K/V (upcast, the fp32 kernel) vs the CPU's {mixed_err:.3e}")


def flash_signature(q, k, v, *, causal, scale, attn_cap, window,
                    q_offset=0, kv_len=None) -> tuple:
    """What a flash launch's arithmetic depends on but its decode
    position: shapes, dtype, mask kind, scale, cap, window."""
    return (tuple(q.shape), tuple(k.shape), tuple(v.shape), str(q.dtype),
            causal, scale, attn_cap, window,
            bool(q_offset) or kv_len is not None)


#: label → the set of ``flash_signature``s a path phase launched
PATH_FLASH: dict = {}


def path_flash(label: str):
    """Record the signature of every flash launch under ``label`` (the
    kernel still launches)."""
    from repro_torch.kernels import flash_attn as fa
    seen = PATH_FLASH.setdefault(label, set())
    real = fa.attention_fwd

    def record(q, k, v, **kw):
        seen.add(flash_signature(q, k, v, **kw))
        return real(q, k, v, **kw)
    return mock.patch.object(fa, "attention_fwd", record)


@contextlib.contextmanager
def decode_gate(label: str, counts: dict):
    """Every flash launch under ``label`` through a check: a bf16 launch
    that ``flash_attn.decodes`` takes moves ``decode_mma_launches`` (the
    bf16 decode kernel's counter) up by one, any other launch by none.
    ``counts[label]``: the bf16 decode launches seen."""
    import torch
    from repro_torch.kernels import flash_attn as fa
    real = fa.attention_fwd
    seen = [0]

    def gated(q, k, v, **kw):
        before = fa.decode_mma_launches
        out = real(q, k, v, **kw)
        mma = q.dtype == torch.bfloat16 and fa.decodes(
            q.shape[-2], k.shape[-2], q.shape[-3])
        check(fa.decode_mma_launches == before + mma, f"{label}: a "
              f"{'bf16 decode' if mma else 'flash'} launch of q "
              f"{tuple(q.shape)} {q.dtype} moved the bf16 decode kernel's "
              f"counter by {fa.decode_mma_launches - before}")
        seen[0] += mma
        return out
    with mock.patch.object(fa, "attention_fwd", gated):
        yield
    counts[label] = seen[0]


#: the phases whose serving runs make bf16 decode launches
DECODE_PHASES = ("phase 18", "phase 20", "phase 21", "phase 23",
                 "phase 24", "phase 26", "phase 30", "phase 35", "phase 36")


def check_decode_gates(counts: dict, total: int) -> None:
    """Every serving phase's bf16 decode launches went through
    ``flash_decode_mma_kernel`` (``decode_gate``), each serving phase made
    some, and the kernel's counter, set to 0 before phase 18, counts them
    all."""
    check(all(counts[p] > 0 for p in DECODE_PHASES)
          and sum(counts.values()) == total, f"bf16 decode launches by "
          f"phase {counts}, the kernel's counter {total}")
    print(f"bf16 decode launches on flash_decode_mma_kernel, phases 18-36: "
          f"{total} ({', '.join(f'{p} {n}' for p, n in counts.items() if n)})"
          "; every one of them counted by the kernel's wrapper")


def case_kw(torch, case) -> dict:
    """A ``FLASH_MODEL_CASES`` entry's launch keywords: the model's query
    scale (``hd ** -0.5`` rounded to the query's dtype: bf16, also where
    the query is upcast over fp32 K/V, or an fp32 model's), its cap,
    window and mask."""
    return dict(causal=case["causal"], scale=torch.tensor(
        case["hd"] ** -0.5, dtype=getattr(torch, case["scale_of"])).item(),
        attn_cap=case["cap"], window=case["window"],
        q_offset=case["q_offset"], kv_len=case["kv_len"])


def case_shapes(case) -> tuple:
    """A ``FLASH_MODEL_CASES`` entry's q, k and v shapes."""
    c = case
    return ((c["b"], c["sq"], c["h"], c["hd"]),
            (c["b"], c["sk"], c["kv"], c["hd"]),
            (c["b"], c["sk"], c["kv"], c["vd"]))


def check_path_flash(torch) -> None:
    """Every flash launch the path phases recorded has its phase-7 case."""
    cases = {flash_signature(*(torch.empty(shape, dtype=getattr(
        torch, case["dtype"]), device="meta")
        for shape in case_shapes(case)), **case_kw(torch, case))
        for case in FLASH_MODEL_CASES.values()}
    for label, seen in PATH_FLASH.items():
        missing = seen - cases
        check(bool(seen) and not missing, f"{label}: flash launches "
              f"{sorted(missing)} have no case in FLASH_MODEL_CASES")
    print(f"every flash launch of {sorted(PATH_FLASH)} is a phase-7 case "
          f"({sum(map(len, PATH_FLASH.values()))} shapes), held there "
          "against the plain version at every batch row")


#: label → the set of ``flash_signature``s of the backward launches a
#: training phase made
PATH_BWD: dict = {}


def path_bwd(label: str):
    """Record the signature of every backward launch under ``label`` (the
    kernel still launches)."""
    from repro_torch.kernels import flash_attn as fa
    seen = PATH_BWD.setdefault(label, set())
    real = fa.attention_bwd

    def record(q, k, v, o, lse, do, **kw):
        seen.add(flash_signature(q, k, v, **kw))
        return real(q, k, v, o, lse, do, **kw)
    return mock.patch.object(fa, "attention_bwd", record)


def check_path_bwd(torch) -> None:
    """Every backward launch the training phases recorded has its phase-7
    case in ``BWD_CASES``."""
    cases = {flash_signature(*(torch.empty(shape, dtype=getattr(
        torch, case["dtype"]), device="meta")
        for shape in case_shapes(case)), **case_kw(torch, case))
        for case in BWD_CASES.values()}
    for label, seen in PATH_BWD.items():
        missing = seen - cases
        check(bool(seen) and not missing, f"{label}: backward launches "
              f"{sorted(missing)} have no case in BWD_CASES")
    print(f"every backward launch of {sorted(PATH_BWD)} is a phase-7 case "
          f"({sum(map(len, PATH_BWD.values()))} shapes), held there against "
          "the plain backward")


@contextlib.contextmanager
def counting_plain_bwd(calls: list):
    """Append one to ``calls`` for every call of the plain attention
    backward (``ref.flash_attention_bwd``); a training step on the card
    makes none."""
    from repro_torch.kernels import ref
    real = ref.flash_attention_bwd

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    with mock.patch.object(ref, "flash_attention_bwd", counted):
        yield


def bwd_vs_plain(torch, fa, ref, q, k, v, o, lse, do, kw: dict,
                 label: str) -> tuple:
    """One backward launch ``(q, k, v, o, lse, do)`` against its plain
    version on the same inputs: launched twice with the same bits, one
    ``bwd_launches`` each; fp32 within 1e-4, bf16 each gradient within
    2e-2 of its largest.  Returns the largest ``|kernel - plain|``, the
    largest plain gradient and each gradient's ``|kernel - plain|``."""
    before = fa.bwd_launches
    got = fa.attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    check(fa.bwd_launches == before + 2, f"{label}: backward launches "
          f"{fa.bwd_launches - before}, want 2")
    check(all(same_bits(a, b) for a, b in zip(got, again)),
          f"{label}: two backward launches differ")
    del again
    want = ref.flash_attention_bwd(q, k, v, lse, do, **kw)
    worst = top = 0.0
    errs = {}
    for g, w, t, what in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        check(g.shape == t.shape and g.dtype == w.dtype == t.dtype,
              f"{label}: {what} {tuple(g.shape)} {g.dtype}")
        err = float((g.float() - w.float()).abs().max())
        big = float(w.float().abs().max())
        bound = 1e-4 if q.dtype == torch.float32 else 2e-2 * big
        check(err <= bound, f"{label}: {what} |kernel - plain| {err:.3e} > "
              f"{bound:.3e}")
        worst, top = max(worst, err), max(top, big)
        errs[what] = err
    return worst, top, errs


def bwd_kernel_ms(torch, fn) -> dict:
    """Device ms of each kernel of one backward launch ``fn`` (``D``,
    dK/dV, dQ), by ``torch.profiler`` over 3 warm launches; empty where
    the profiler sees no device time (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        m = KERNEL_NAME.search(e.key)
        if m and (m.group(1) or "").startswith("flash_bwd"):
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + e.device_time_total / 1e3 / 3)
    return out


def bwd_kernel_names(q) -> tuple:
    """The profiler names of the backward's dK/dV and dQ kernels for this
    launch's dtype: bf16 ``wgmma``, fp32 TF32 ``wgmma``."""
    if q.element_size() == 2:
        return "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"
    return "flash_bwd_dkdv_tf32", "flash_bwd_dq_tf32"


def bwd_kernel_bounds(fa, q, k, v, kw: dict) -> dict:
    """The least time of each kernel of the backward on this launch, in
    ms: D (``flash_bwd_dot``) by bytes, the output and its gradient read
    and D written; dK/dV's four products a visible pair (``S``, ``dP``,
    ``dV``, ``dK``: ``4·(hd + vd)`` flops) against q, k, v and dO read and
    dk, dv written; dQ's three (``S``, ``dP``, ``dQ``: ``2·(2·hd + vd)``)
    against q, k, v and dO read and dq written.  The operations at bf16's
    989 TFLOP/s, or fp32's three TF32 products at 495; the larger of
    operations and bytes over 3.35 TB/s."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    pairs = fa.flops_bwd(b, h, sq, k.shape[1], hd, causal=kw["causal"],
                         window=kw["window"], vd=vd) // (2 * (3 * hd + 2 * vd))
    size = q.element_size()
    per_flop = (1 / BF16_FLOPS_PER_S if size == 2
                else 3 / TF32_FLOPS_PER_S)
    out = b * sq * h * vd * size
    ins = (q.numel() + k.numel() + v.numel()) * size + out
    stats = 8 * b * h * sq  # lse and D
    dkdv, dq = bwd_kernel_names(q)
    return {
        "flash_bwd_dot": 1e3 * (2 * out + 4 * b * h * sq) / HBM_BYTES_PER_S,
        dkdv: 1e3 * max(
            pairs * 4 * (hd + vd) * per_flop,
            (ins + stats + (k.numel() + v.numel()) * size) / HBM_BYTES_PER_S),
        dq: 1e3 * max(
            pairs * 2 * (2 * hd + vd) * per_flop,
            (ins + stats + q.numel() * size) / HBM_BYTES_PER_S)}


def sdpa_backend(torch, q, k, v, kw: dict) -> str:
    """The backend PyTorch's dispatcher picks for SDPA on these inputs,
    laid out as ``sdpa_bwd_ms`` hands them over (``"unknown"`` where the
    installed torch does not say)."""
    try:
        from torch.nn.attention import SDPBackend
        g = q.shape[2] // k.shape[2]
        qt, kt, vt = (x.transpose(1, 2) if x is q else
                      x.repeat_interleave(g, dim=2).transpose(1, 2)
                      for x in (q, k, v))
        return SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, None, 0.0, kw["causal"], scale=kw["scale"])).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError):
        return "unknown"


def sdpa_bwd_ms(torch, q, k, v, do, kw: dict):
    """SDPA's backward on the same inputs, the gradient alone (its forward
    outside the timed window): the KV heads repeated to the query heads,
    ``is_causal`` where the window hides no key, else the boolean mask, no
    cap (SDPA takes none).  ``None`` where SDPA refuses the shape."""
    import torch.nn.functional as F
    sq, h = q.shape[1], q.shape[2]
    g = h // k.shape[2]
    qt = q.detach().transpose(1, 2).requires_grad_()
    kt, vt = (x.detach().repeat_interleave(g, dim=2).transpose(1, 2)
              .requires_grad_() for x in (k, v))
    win, mask = kw["window"], None
    if kw["causal"] and win and sq - 1 >= win:
        pos = torch.arange(sq, device="cuda")
        kp = torch.arange(k.shape[1], device="cuda")
        mask = ((kp[None] <= pos[:, None])
                & (kp[None] > pos[:, None] - win))[None, None]
    try:
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"],
            is_causal=kw["causal"] and mask is None)
        dot = do.transpose(1, 2)
        return cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 3)
    except RuntimeError as e:
        print(f"SDPA's backward refused q {tuple(q.shape)} k "
              f"{tuple(k.shape)} v {tuple(v.shape)}: {str(e)[:200]}")
        return None


def phase_flash_bwd(torch, fa, ref, card) -> dict:
    """Phase 7's backward (module docstring, item 7): ``BWD_SYNTH`` at
    every ``TC_DIMS`` pair in both dtypes, then ``BWD_CASES`` timed beside
    their bound, the plain backward and SDPA's backward.  Returns each
    model case's figures."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    t_phase = time.perf_counter()

    def draw(shapes, dtype, v_in=None):
        qs, ks, vs = shapes
        q, k = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                for s in (qs, ks))
        if v_in:
            v = torch.randn((*vs[:-1], v_in), generator=gen,
                            device="cuda").to(dtype)[..., -vs[-1]:]
        else:
            v = torch.randn(vs, generator=gen, device="cuda").to(dtype)
        do = torch.randn((*qs[:-1], vs[-1]), generator=gen,
                         device="cuda").to(dtype)
        return q, k, v, do

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        for hd, vd in fa.TC_DIMS:
            for b, sq, sk, h, kv, causal, cap, win, v_pad in BWD_SYNTH:
                q, k, v, do = draw(((b, sq, h, hd), (b, sk, kv, hd),
                                    (b, sk, kv, vd)), dtype,
                                   v_pad + vd if v_pad else None)
                kw = dict(causal=causal, scale=hd ** -0.5, attn_cap=cap,
                          window=win)
                o, lse = fa.attention_fwd(q, k, v, **kw)
                err, top, _ = bwd_vs_plain(
                    torch, fa, ref, q, k, v, o, lse, do, kw,
                    f"backward {dtype} {(hd, vd)} {(b, sq, sk, h, kv, v_pad)}")
                worst[dtype] = max(worst[dtype], err / (
                    1.0 if dtype == torch.float32 else top))
    print(f"flash backward kernel vs plain: {len(BWD_SYNTH)} cases at "
          f"{len(fa.TC_DIMS)} (hd, vd) pairs in fp32 and bf16, each twice "
          f"the same bits; fp32 worst |kernel - plain| "
          f"{worst[torch.float32]:.3e} (bound 1e-4), bf16 worst "
          f"{worst[torch.bfloat16]:.3e} of the largest gradient (bound 2e-2)")
    out = {}
    for name, case in BWD_CASES.items():
        dtype = getattr(torch, case["dtype"])
        q, k, v, do = draw(case_shapes(case), dtype, case["v_in"])
        kw = {key: val for key, val in case_kw(torch, case).items()
              if key in ("causal", "scale", "attn_cap", "window")}
        o, lse = fa.attention_fwd(q, k, v, **kw)
        err, top, errs = bwd_vs_plain(torch, fa, ref, q, k, v, o, lse, do, kw,
                                      f"backward {name}")
        torch.cuda.empty_cache()
        k_ms = cuda_ms(lambda: fa.attention_bwd(q, k, v, o, lse, do, **kw),
                       5)
        parts = bwd_kernel_ms(
            torch, lambda: fa.attention_bwd(q, k, v, o, lse, do, **kw))
        # D alone (flash_bwd_dot_kernel) against its plain version
        before = fa.dot_launches
        dd = fa.attention_dot(o, do)
        check(fa.dot_launches == before + 1 and same_bits(
            dd, fa.attention_dot(o, do)), f"{name}: D's launches or bits")
        d_err = float((dd - ref.flash_attention_dot(o, do)).abs().max())
        d_top = float(ref.flash_attention_dot(o.abs(), do.abs()).max())
        check(d_err <= 1e-5 * d_top, f"{name}: D {d_err} from plain, over "
              f"1e-5 of its terms' {d_top}")
        d_ms = cuda_ms(lambda: ref.flash_attention_dot(o, do), 5)
        del dd
        p_ms = cuda_ms(lambda: ref.flash_attention_bwd(q, k, v, lse, do,
                                                       **kw), 1, warmup=1)
        torch.cuda.empty_cache()
        l_ms = sdpa_bwd_ms(torch, q, k, v, do, kw)
        torch.cuda.empty_cache()
        b, sq, h, hd = q.shape
        flops = fa.flops_bwd(b, h, sq, k.shape[1], hd, causal=kw["causal"],
                             window=kw["window"], vd=v.shape[-1])
        nbytes = fa.bytes_moved_bwd(q, k, v)
        if dtype == torch.float32:
            ops_s = 3 * flops / TF32_FLOPS_PER_S
            rate_txt = (f"3 x {flops} flops at "
                        f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s TF32")
        else:
            ops_s = flops / BF16_FLOPS_PER_S
            rate_txt = (f"{flops} flops at {BF16_FLOPS_PER_S / 1e12:.0f} "
                        "TFLOP/s")
        by_ops = ops_s > nbytes / HBM_BYTES_PER_S
        bound = max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3
        print(f"flash_attention_bwd {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} v {tuple(v.shape)}"
              + (f" (a view, strides {v.stride()})" if case["v_in"] else "")
              + f" {case['dtype']} {'causal' if kw['causal'] else 'not causal'}"
              f" cap {kw['attn_cap']} window {kw['window']}: {k_ms:.4f} ms; "
              f"bound {bound:.4f} ms by "
              f"{'operations' if by_ops else 'bytes'} ({rate_txt}, {nbytes} "
              f"bytes; {bound / k_ms:.1%} of the bound); plain {p_ms:.3f} ms;"
              f" library SDPA backward (the gradient alone, KV heads "
              f"repeated, no cap) "
              + (f"{l_ms:.4f} ms" if l_ms is not None else "refused")
              + f"; max |kernel - plain| {err:.3e} (largest plain gradient "
              f"{top:.3e})  [{card}]")
        bounds = bwd_kernel_bounds(fa, q, k, v, kw)
        print(f"  by kernel (torch.profiler, device ms): " + (", ".join(
            f"{part} {ms:.4f}" + (f" ({bounds[part] / ms:.1%} of its "
                                  f"{bounds[part]:.4f} ms bound)"
                                  if part in bounds else "")
            for part, ms in sorted(parts.items())) or "not measured")
              + f"; D alone vs its plain version {d_err:.3e}, the plain "
              f"version {d_ms:.4f} ms")
        out[name] = dict(ms=k_ms, bound_ms=bound, plain_ms=p_ms,
                         library_ms=l_ms, max_abs_err=err, errs=errs,
                         kernels_ms=parts, kernel_bounds_ms=bounds,
                         dot_plain_ms=d_ms, dot_err=d_err)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(f"phase 7 backward: {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


def phase_flash_model_cases(torch, fa, ref, card) -> dict:
    """Phase 7's model-path cases (``FLASH_MODEL_CASES``): flash against
    its plain version at every batch row (a decode-shaped one, ``G·Sq <=
    64``, on a decode kernel, twice with the same bits, against the plain
    version and the plain version of its splits: ``decode_vs_plain``;
    else bf16 once on the wgmma kernel, fp32 on the 3xTF32 one, twice
    with the same bits and its log-sum-exp within 3e-5 too), timed by
    CUDA events beside its bound
    and ``scaled_dot_product_attention`` in the same dtype on the same
    boolean mask, or none where nothing is masked (SDPA takes no tanh
    cap: it is timed without one, and in fp32 its output is held against
    the plain version without the cap).  Where the window hides a key,
    the plain version without it must differ.  The bound takes the
    operations at the kernel's peak: bf16 on the tensor cores, fp32 three
    times on them in TF32 (the fp32 launch's bound on the CUDA cores
    printed beside it), a decode launch's fp32 on the CUDA cores.
    Returns each case's figures."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    for name, case in FLASH_MODEL_CASES.items():
        dtype = getattr(torch, case["dtype"])
        tc = dtype == torch.bfloat16
        qs, ks, vs = case_shapes(case)
        q, k = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in (qs, ks))
        if case["v_in"]:
            v = torch.randn((*vs[:-1], case["v_in"]), generator=gen,
                            device="cuda").to(dtype)[..., -case["vd"]:]
        else:
            v = torch.randn(vs, generator=gen, device="cuda").to(dtype)
        kw = case_kw(torch, case)
        b, sq, h, hd = q.shape
        sk = k.shape[1]
        win, off, kvl = kw["window"], kw["q_offset"], kw["kv_len"]
        causal = kw["causal"]
        dec = fa.decodes(h, k.shape[2], sq)
        fp32 = not (tc or dec)
        route = "decode" if dec else "wgmma" if tc else "3xTF32"
        before = (fa.launches, fa.tc_launches, fa.decode_launches,
                  fa.fp32_launches, fa.decode_mma_launches)
        if fp32:
            err = fp32_vs_plain(torch, fa, ref, q, k, v, kw, name)
        elif dec:   # twice, against the plain version and its splits'
            err = decode_vs_plain(torch, fa, ref, q, k, v, kw, name)[0]
        else:
            got, _ = fa.attention_fwd(q, k, v, **kw)
        check((fa.launches, fa.tc_launches, fa.decode_launches,
               fa.fp32_launches, fa.decode_mma_launches) == (
            before[0] + 1 + fp32 + dec, before[1] + (tc and not dec),
            before[2] + 2 * dec, before[3] + 2 * fp32,
            before[4] + 2 * (tc and dec)),
            f"{name}: not on the {route} kernel")
        want, _ = ref.flash_attention_bshd(q, k, v, **kw)
        torch.cuda.synchronize()
        if not (fp32 or dec):
            err = flash_err(torch, got, want, v)
            del got
        if win and off + sq - 1 >= win:
            opened, _ = ref.flash_attention_bshd(q, k, v,
                                                 **dict(kw, window=0))
            check(not torch.equal(opened, want), f"{name}: the window hid "
                  "no key")
            del opened
        k_ms = cuda_ms(lambda: fa.attention_fwd(q, k, v, **kw), 10)
        p_ms = cuda_ms(lambda: ref.flash_attention_bshd(q, k, v, **kw), 1,
                       warmup=1)
        mask = None
        if causal or kvl:
            pos = off + torch.arange(sq, device="cuda")
            kp = torch.arange(sk, device="cuda")
            mask = (kp[None] < (kvl or sk)).expand(sq, sk)
            if causal:
                mask = mask & (kp[None] <= pos[:, None])
            if win:
                mask &= kp[None] > pos[:, None] - win
            mask = mask[None, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True)
        l_ms = cuda_ms(sdpa, 10)
        sdpa_err = None
        if fp32:
            uncapped = (want if not kw["attn_cap"] else
                        ref.flash_attention_bshd(q, k, v, **dict(
                            kw, attn_cap=0.0))[0])
            sdpa_err = float((sdpa().transpose(1, 2) - uncapped).abs().max())
            del uncapped
        flops = fa.flops(b, h, sq, sk, hd, causal=causal, window=win,
                         q_offset=off, kv_len=kvl or sk, vd=v.shape[-1])
        nbytes = fa.bytes_moved(q, k, v, kvl or sk, window=win,
                                q_offset=off)
        byte_s = nbytes / HBM_BYTES_PER_S
        if fp32:
            cores = max(flops / FP32_FLOPS_PER_S, byte_s) * 1e3
            print(f"flash_attention {name}: on the CUDA cores its bound "
                  f"would be {cores:.4f} ms ({flops} flops at "
                  f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s); on the tensor "
                  "cores in three TF32 products it is the one below  "
                  f"[{card}]")
            ops_s = 3 * flops / TF32_FLOPS_PER_S
            rate_txt = (f"3 x {flops} flops at "
                        f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s TF32")
        else:
            rate = BF16_FLOPS_PER_S if tc else FP32_FLOPS_PER_S
            ops_s = flops / rate
            rate_txt = f"{flops} flops at {rate / 1e12:.0f} TFLOP/s"
        by_ops = ops_s > byte_s
        bound = max(ops_s, byte_s) * 1e3
        print(f"flash_attention {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} v {tuple(v.shape)}"
              + (f" (a view, strides {v.stride()}, offset "
                 f"{v.storage_offset()})" if case["v_in"] else "")
              + f" {case['dtype']} ({route} kernel) "
              f"{'causal' if causal else 'not causal'} cap {kw['attn_cap']} "
              f"window {win}" + (f" q_offset {off} kv_len {kvl}" if kvl
                                 else "")
              + f": {k_ms:.4f} ms; bound {bound:.4f} ms by "
              f"{'operations' if by_ops else 'bytes'} ({rate_txt}, "
              f"{nbytes} bytes; {bound / k_ms:.1%} of the bound); plain "
              f"{p_ms:.3f} ms; library scaled_dot_product_attention "
              f"{case['dtype']} with " + ("the boolean mask" if mask is not
                                          None else "no mask")
              + f", no cap, {l_ms:.4f} ms"
              + (f" (|sdpa - plain without the cap| {sdpa_err:.3e})"
                 if fp32 else "")
              + f"; max |kernel - plain| over all {b} batch rows "
              f"{err:.3e}  [{card}]")
        out[name] = dict(ms=k_ms, bound_ms=bound, plain_ms=p_ms,
                         library_ms=l_ms, max_abs_err=err, route=route,
                         library_err=sdpa_err)
        del q, k, v, want, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def counting_drops(drops: list):
    """Count the MoE's dropped choices: each router call's ``(dropped,
    choices)``, as ``base.moe_block``'s ``_expert_slots`` finds them,
    appended to ``drops`` (the dropped count a tensor on the card, read
    after the run)."""
    from repro_torch.models import base
    real = base._expert_slots

    def slots(flat_e, e, cap):
        pos, keep = real(flat_e, e, cap)
        drops.append(((~keep).sum(), keep.numel()))
        return pos, keep
    with mock.patch.object(base, "_expert_slots", slots):
        yield
    for i, (d, n) in enumerate(drops):
        drops[i] = (int(d), n)


def phase_train(torch, card, total_mem, tr, flags=TRAIN_FLAGS,
                layers=TRAIN_LAYERS, phase=9,
                compare_layers=COMPARE_LAYERS) -> dict:
    """The training step at full width (the launcher's ``flags``, depth
    ``layers``): checks, time, memory, profile, the F3 replay and the
    comparison against the plain attention at ``compare_layers``."""
    from repro_torch import configs
    from repro_torch import tree
    from repro_torch.core import collectives as coll
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    published = configs.load(launch._parse(flags).arch).CONFIG

    def depth(n):
        # an encoder-decoder's encoder is cut with its decoder
        return dict(n_layers=n, dtype=torch.bfloat16,
                    **({"encoder_layers": n} if published.encoder_layers
                       else {}))
    t_phase = t0 = time.perf_counter()
    run = launch.setup(flags, **depth(layers))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p[(0,) * run.step.mesh.ndim].numel()
                   for p in tree.flatten(run.params)[0])
    enc = (f" (and {run.cfg.encoder_layers} of {published.encoder_layers} "
           "encoder layers)" if published.encoder_layers else "")
    print(f"training: {run.cfg.name} at published widths, {run.cfg.n_layers} "
          f"of {published.n_layers} layers{enc}, bf16 compute, fp32 master "
          f"weights, mesh "
          f"{dict(zip(run.mesh.axes, run.mesh.shape))}, global batch "
          f"{run.args.batch} x {run.args.seq} (one sequence a rank), "
          f"{n_params} parameters a rank, set up in {setup_s:.1f} s")

    steps, losses, norms = [], [], []

    def one():
        t = time.perf_counter()
        m = run.train_step()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)

    per_step = flash_per_call(run.cfg, "train")
    # one backward a call site of the attention: its forward runs once more
    # in the remat recompute, the backward once
    per_bwd = flash_per_call(run.cfg, "prefill")
    with (path_flash(f"phase {phase}") if per_step
          else contextlib.nullcontext()), \
            (path_bwd(f"phase {phase}") if per_step
             else contextlib.nullcontext()):
        one()                                  # warm-up
    fa.launches = fa.tc_launches = fa.bwd_launches = tr.launches = 0
    drops: list = []
    plain_bwd: list = []
    with (counting_drops(drops) if run.cfg.is_moe
          else contextlib.nullcontext()), counting_plain_bwd(plain_bwd):
        for _ in range(5):
            one()
    torch.cuda.synchronize()
    launches, tc_launches, folds = fa.launches, fa.tc_launches, tr.launches
    bwd = fa.bwd_launches
    was_ms, was_peak = PLAIN_BWD_STEPS[f"phase {phase}"]
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(steps[1:])
    print(f"training losses (warm-up, then steps 1-5): "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"training step ms (median of 5, {card}): {step_ms:.1f} (runs "
          f"{[round(t, 1) for t in steps[1:]]}; warm-up {steps[0]:.1f}); "
          f"flash launches {launches} over 5 steps ({launches // 5} a step,"
          f" {per_step} by flash_per_call; {tc_launches} of them the "
          f"tensor-core kernel's); backward kernel launches {bwd} "
          f"({bwd // 5} a step), plain backward calls {len(plain_bwd)}; "
          f"tree_reduce_slots launches "
          f"{folds} ({folds // 5} a step); peak device memory "
          f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}; with the "
          f"plain attention backward {was_ms:.1f} ms, peak {was_peak:.2f} "
          "GiB (PERF.md)"
          + (f"; the MoE dropped {int(sum(d for d, _ in drops))} of "
             f"{sum(n for _, n in drops)} expert choices over "
             f"{len(drops)} router calls (forward and remat recompute; "
             f"capacity factor {run.cfg.capacity_factor})" if drops else ""))
    check(all(map(math.isfinite, losses)), f"a loss is not finite: {losses}")
    check(losses[5] < losses[1], f"step 5 loss {losses[5]} is not below "
          f"step 1 loss {losses[1]}")
    check(launches == 5 * per_step, f"flash launches {launches} over 5 "
          f"steps, want {5 * per_step} ({per_step} a step)")
    check(tc_launches == launches, f"{launches - tc_launches} of the step's "
          "flash launches missed the tensor-core kernel")
    check(bwd == 5 * per_bwd and not plain_bwd, f"backward kernel launches "
          f"{bwd} and plain backward calls {len(plain_bwd)} over 5 steps, "
          f"want {5 * per_bwd} and none")
    check(folds > 0, "the step's reduction launched no tree_reduce_slots")

    phase_profile(torch, run.train_step, card, "one training step")

    # -- F3: one step's captured per-rank gradients, replayed ---------------
    rs = Capture(coll, "reduce_scatter", keep=8, max_elems=1 << 30)
    red_in = []
    real_call = GradReducer.__call__

    def spy(self, grads, state=None):
        out = real_call(self, grads, state)
        red_in.append(([g.clone() for g in grads],
                       [o.clone() for o in out[0]]))
        return out
    with rs.patch(), mock.patch.object(GradReducer, "__call__", spy):
        run.train_step()
    torch.cuda.synchronize()
    check(rs.calls > 0 and len(rs.seen) == min(8, rs.calls)
          and len(red_in) == 1, "capture missed a call")
    for a, kw, out in rs.seen:
        check(same_bits(coll.reduce_scatter(*a, **kw), out),
              "reduce-scatter replay != the step's")
    grads, reduced = red_in[0]
    with mock.patch.object(ops, "tree_reduce_slots",
                           ops.tree_reduce_slots_plain):
        before = tr.launches
        plain, _ = run.step.reducer(grads)
        check(tr.launches == before, "the plain fold launched the kernel")
    wire, _ = GradReducer(FlareConfig(axes=run.mesh.reduce_axes,
                                      algorithm="fixed_tree",
                                      reproducible=True),
                          run.step.mesh)(grads)
    check(all(same_bits(a, b) for a, b in zip(reduced, plain)),
          "the step's reduced gradients != the plain fold's")
    check(all(same_bits(a, b) for a, b in zip(reduced, wire)),
          "the step's reduced gradients != the wire fixed tree's")
    print(f"F3 replay of one step's per-rank gradients: {len(rs.seen)} of "
          f"its {rs.calls} FSDP reduce-scatters (shapes "
          f"{[tuple(a[0].shape) for a, *_ in rs.seen]}) "
          f"bitwise; the GradReducer's {len(grads)} replicated leaves "
          f"({[tuple(g.shape) for g in grads]}) bitwise == the plain fold "
          "== the wire fixed_tree")
    del rs, red_in, grads, reduced, plain, wire, run
    torch.cuda.empty_cache()

    # -- the plain attention patched in, at COMPARE_LAYERS ------------------
    def compare_step(plain):
        r = launch.setup(flags, **depth(compare_layers))
        if not plain:
            return r.train_step()
        before = (fa.launches, fa.bwd_launches)
        with mock.patch.object(fa, "attention_fwd",
                               lambda q, k, v, **kw:
                               ref.flash_attention_bshd(q, k, v, **kw)), \
                mock.patch.object(fa, "attention_bwd",
                                  lambda q, k, v, o, lse, do, **kw:
                                  ref.flash_attention_bwd(q, k, v, lse, do,
                                                          **kw)):
            m = r.train_step()
        check((fa.launches, fa.bwd_launches) == before,
              "the plain step launched a kernel")
        return m
    km, pm = compare_step(False), compare_step(True)
    torch.cuda.synchronize()
    rel = {k: abs(float(km[k]) - float(pm[k])) / abs(float(pm[k]))
           for k in ("loss", "grad_norm")}
    check(all(v <= 2e-2 for v in rel.values()),
          f"kernel step vs plain-attention step: {rel}")
    print(f"kernel step vs plain-attention step at {compare_layers} layers: "
          f"loss {float(km['loss']):.5f} vs {float(pm['loss']):.5f}, grad "
          f"norm {float(km['grad_norm']):.5f} vs {float(pm['grad_norm']):.5f}"
          f"; relative {rel['loss']:.2e} and {rel['grad_norm']:.2e} (bf16 "
          "tolerance 2e-2)")
    torch.cuda.empty_cache()
    print(f"phase {phase}: phase {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    return {"launches": launches, "folds": folds, "step_ms": step_ms,
            "peak": peak, "loss1": losses[0], "norm1": norms[0],
            "bwd_launches": bwd}


def phase_wire_reductions(torch, card, total_mem, cfg, seed) -> None:
    """The wire dense reductions at full width (``WIRE_RUNS``): the fp64
    bound, batched == per-bucket, arena == per-bucket loop for the fixed
    trees, reproducible twice, card == CPU on two buckets; time, peak and
    the bytes each rank would put on the wire."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.core import arena as arena_mod
    from repro_torch.core import collectives as coll, transports
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.mesh import AXES, RankMesh
    from repro_torch.models import transformer

    held = torch.cuda.memory_allocated()
    grads = make_grads(torch, tree, transformer, cfg, (2, 4), seed)
    n_params = sum(l[0, 0].numel() for l in tree.flatten(grads)[0])
    print(f"wire reductions: {cfg.name} at published widths, {LAYERS} "
          f"layers, {n_params} fp32 parameters a rank, 8 ranks "
          f"({8 * n_params * 4 / 1e9:.2f} GB of input); "
          f"{held / 2**30:.2f} GiB allocated as the phase starts")
    for name, shape, kw in WIRE_RUNS:
        mesh = RankMesh(shape, AXES)
        gt = tree.map_leaves(lambda g: g.view(*shape, *g.shape[2:]), grads)
        leaves = tree.flatten(gt)[0]
        config = FlareConfig(**{"axes": AXES, **kw})
        red = GradReducer(config, mesh)
        grp = arena_mod.build_plan(leaves, config.bucket_bytes,
                                   pad_multiple=red._pad_multiple(8),
                                   lead_dims=2).groups[0]
        batched = transports.from_config(config, mesh, torch.float32)
        alg = batched._resolve(torch.empty(grp.bucket_elems, device="meta"))
        what = (f"{name} on {shape} over {config.axes} ({alg}"
                f"{', fixed tree' if config.reproducible else ''})")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr.launches = 0
        out, _ = red(gt)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(tr.launches == 0, f"{what}: the wire launched the switch fold")
        out_leaves = tree.flatten(out)[0]
        worst = check_wire_bound(torch, leaves, out_leaves, 8)
        done = [f"within {worst:.3f} of the fp64 bound, every rank the same"]
        if config.reproducible:
            again = tree.flatten(red(gt)[0])[0]
            check(all(same_bits(a, b) for a, b in zip(out_leaves, again)),
                  f"{what}: two runs differ")
            del again
            done.append("the same bits twice")
        if config.reproducible or alg == "fixed_tree":
            legacy = GradReducer(dataclasses.replace(config, arena=False),
                                 mesh)(gt)[0]
            check(trees_same_bits(out, legacy),
                  f"{what}: arena != per-bucket loop")
            del legacy
            done.append("arena == arena=False")
        arena = grp.pack(leaves)
        st = grp.staggers(config.stagger, arena.device)
        small = arena[..., :2, :].clone()
        per = transports.from_config(config, mesh, torch.float32,
                                     batched=False)
        per_out = per(arena, None, st, grp.valid_extents)[0]
        del arena
        per_leaves = [None] * len(leaves)
        grp.unpack(per_out, per_leaves)
        check(all(same_bits(a, b) for a, b in zip(out_leaves, per_leaves)),
              f"{what}: batched != per-bucket")
        del per_leaves, per_out, out, out_leaves
        ext = grp.valid_extents[:2]
        on_card = batched(small, None, st[:2], ext)[0]
        on_cpu = batched(small.cpu(), None, st[:2].cpu(), ext)[0]
        check(same_bits(on_card.cpu(), on_cpu), f"{what}: card != CPU")
        del small, on_card, on_cpu
        done += ["batched == per-bucket", "card == CPU on 2 buckets"]
        ms, runs = timed(torch, lambda: red(gt), 5)
        wire = coll.wire_bytes_per_rank(n_params * 4, shape[1], shape[0],
                                        algorithm=alg)
        print(f"wire {what}: arena B={grp.num_buckets} "
              f"S={grp.bucket_elems}; {'; '.join(done)}; ms (median of 5, "
              f"{card}): {ms:.3f} (runs {[round(t, 3) for t in runs]}); "
              f"peak device memory {peak / 2**30:.2f} GiB of "
              f"{total_mem / 2**30:.1f}; wire_bytes_per_rank "
              f"{wire / 1e9:.3f} GB")
        del gt, leaves, red
    del grads
    torch.cuda.empty_cache()


def phase_wire_train(torch, card, total_mem, innet: dict) -> dict:
    """The training step on the wire at full size (``WIRE_TRAIN_FLAGS``):
    losses finite and falling, flash on the tensor cores 2 × layers a
    step, step 1's loss bitwise the in-network phase's, its gradient norm
    within 1e-3; then the ring gather against rhd at ``COMPARE_LAYERS``.
    Returns step 1's loss and gradient norm."""
    from repro_torch.core import collectives as coll
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import train as launch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = launch.setup(WIRE_TRAIN_FLAGS, n_layers=TRAIN_LAYERS,
                       dtype=torch.bfloat16)
    cfg = run.step.reducer.config
    check(cfg.transport == "auto" and not cfg.reproducible
          and run.args.gather_algorithm == "rhd",
          f"the wire step is not the launcher's default wire path: {cfg}")
    steps, losses, norms = [], [], []

    def one():
        t = time.perf_counter()
        m = run.train_step()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)

    one()                                      # warm-up: step 1
    hier = Capture(coll, "hierarchical_allreduce", keep=0)
    fa.launches = fa.tc_launches = fa.bwd_launches = 0
    plain_bwd: list = []
    with hier.patch(), counting_plain_bwd(plain_bwd):
        for _ in range(WIRE_STEPS):
            one()
    torch.cuda.synchronize()
    launches, tc_launches, bwd = fa.launches, fa.tc_launches, fa.bwd_launches
    was_ms, was_peak = PLAIN_BWD_STEPS["phase 10"]
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(steps[1:])
    print(f"wire training ({' '.join(WIRE_TRAIN_FLAGS)}, {TRAIN_LAYERS} "
          f"layers): losses (warm-up, then steps 2-{WIRE_STEPS + 1}) "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"wire training step ms (median of {WIRE_STEPS}, {card}): "
          f"{step_ms:.1f} (runs {[round(t, 1) for t in steps[1:]]}; warm-up "
          f"{steps[0]:.1f}); flash launches {launches} over {WIRE_STEPS} "
          f"steps, {tc_launches} of them the tensor-core kernel's; backward "
          f"kernel launches {bwd}, plain backward calls {len(plain_bwd)}; "
          f"hierarchical_allreduce calls {hier.calls}; peak device memory "
          f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}; with the "
          f"plain attention backward {was_ms:.1f} ms, peak {was_peak:.2f} "
          "GiB (PERF.md)")
    check(all(map(math.isfinite, losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the last loss {losses[-1]} is not below "
          f"step 1's {losses[0]}")
    check(launches == WIRE_STEPS * 2 * TRAIN_LAYERS
          and tc_launches == launches,
          f"flash launches {launches} ({tc_launches} tensor-core) over "
          f"{WIRE_STEPS} steps, want {2 * TRAIN_LAYERS} a step, all on the "
          "tensor cores")
    check(bwd == WIRE_STEPS * TRAIN_LAYERS and not plain_bwd,
          f"backward kernel launches {bwd} and plain backward calls "
          f"{len(plain_bwd)} over {WIRE_STEPS} steps, want "
          f"{TRAIN_LAYERS} a step and none")
    check(hier.calls >= WIRE_STEPS, "the norms missed the hierarchical "
          "schedule")
    rel = abs(norms[0] - innet["norm1"]) / innet["norm1"]
    check(losses[0] == innet["loss1"], f"step 1 loss {losses[0]!r} != the "
          f"in-network step's {innet['loss1']!r}")
    check(rel <= 1e-3, f"step 1 grad norm {norms[0]} vs in-network "
          f"{innet['norm1']}: relative {rel:.2e}")
    print(f"wire step 1 vs in-network step 1: loss {losses[0]!r} bitwise "
          f"equal; grad norm {norms[0]!r} vs {innet['norm1']!r}, relative "
          f"{rel:.2e} (limit 1e-3)")
    del run
    torch.cuda.empty_cache()

    def first_step(*flags):
        r = launch.setup([*WIRE_TRAIN_FLAGS, *flags], n_layers=COMPARE_LAYERS,
                         dtype=torch.bfloat16)
        m = r.train_step()
        return float(m["loss"]), float(m["grad_norm"])
    (l_rhd, n_rhd), (l_ring, n_ring) = first_step(), first_step(
        "--gather-algorithm", "ring")
    rel = abs(n_ring - n_rhd) / n_rhd
    check(l_ring == l_rhd, f"ring gather loss {l_ring!r} != rhd {l_rhd!r}")
    check(rel <= 1e-3, f"ring gather grad norm {n_ring} vs rhd {n_rhd}")
    print(f"wire step 1 at {COMPARE_LAYERS} layers, --gather-algorithm ring "
          f"vs rhd: loss {l_ring!r} bitwise equal; grad norm {n_ring!r} vs "
          f"{n_rhd!r}, relative {rel:.2e} (limit 1e-3)")
    torch.cuda.empty_cache()
    return {"loss1": losses[0], "norm1": norms[0], "peak": peak,
            "step_ms": step_ms}


def phase_lossy_train(torch, card, total_mem, dense: dict) -> None:
    """The wire training step with a lossy transport at full size
    (``WIRE_TRAIN_FLAGS`` plus each of ``LOSSY_TRAIN``): a warm-up step,
    then ``LOSSY_STEPS`` timed with the counters set to 0 just before and
    read just after.  Losses finite and falling from step 1 to 2, flash
    on the tensor cores 2 × layers a step, the error-feedback state in
    ``opt["ef"]`` (the three norm leaves), step 1's loss bitwise the
    dense wire step's (the forward does not depend on the reduction) and
    its gradient norm within 1e-3 (only the norm leaves go lossy)."""
    from repro_torch import tree
    from repro_torch.core import transports
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.launch import train as launch

    for name, extra in LOSSY_TRAIN.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flags = [*WIRE_TRAIN_FLAGS, *extra]
        run = launch.setup(flags, n_layers=TRAIN_LAYERS, dtype=torch.bfloat16)
        t = run.step.reducer._transport(torch.float32, batched=True)
        check(isinstance(t, transports.Int8Transport if name == "int8"
                         else transports.SparseTransport),
              f"--{name}: the launcher built {type(t).__name__}")
        steps, losses, norms = [], [], []

        def one():
            t0 = time.perf_counter()
            m = run.train_step()
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)

        one()                                  # warm-up: step 1
        fa.launches = fa.tc_launches = fa.bwd_launches = 0
        qt.wire_launches = 0
        for k in qt.launches:
            qt.launches[k] = 0
        for k in sa.launches:
            sa.launches[k] = 0
        plain_bwd: list = []
        with counting_plain_bwd(plain_bwd):
            for _ in range(LOSSY_STEPS):
                one()
        torch.cuda.synchronize()
        launches, tc_launches = fa.launches, fa.tc_launches
        bwd = fa.bwd_launches
        kernels = {k: v // LOSSY_STEPS for k, v in dict(
            qt.launches, wire_order=qt.wire_launches, **sa.launches).items()
            if v}
        peak = torch.cuda.max_memory_allocated()
        ef = tree.flatten(run.opt["ef"])[0]
        rel = abs(norms[0] - dense["norm1"]) / dense["norm1"]
        print(f"wire training with {' '.join(extra)} ({TRAIN_LAYERS} "
              f"layers): losses (warm-up, then steps 2-{LOSSY_STEPS + 1}) "
              f"{[round(x, 4) for x in losses]}; grad norms "
              f"{[round(x, 3) for x in norms]}; step ms (median of "
              f"{LOSSY_STEPS}, {card}): {statistics.median(steps[1:]):.1f} "
              f"(runs {[round(x, 1) for x in steps[1:]]}; warm-up "
              f"{steps[0]:.1f}); flash launches {launches} over "
              f"{LOSSY_STEPS} steps ({tc_launches} tensor-core), backward "
              f"kernel launches {bwd}, plain backward calls "
              f"{len(plain_bwd)}; with the plain attention backward "
              f"{PLAIN_BWD_STEPS[name][0]:.1f} ms; reduction "
              f"kernels a step {kernels}; opt['ef'] "
              f"{[tuple(e.shape) for e in ef]}; peak device memory "
              f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}; step 1 "
              f"vs the dense wire step: loss {losses[0]!r} vs "
              f"{dense['loss1']!r}, grad norm relative {rel:.2e}")
        check(all(map(math.isfinite, losses)), f"a loss is not finite: "
              f"{losses}")
        check(losses[1] < losses[0], f"--{name}: step 2 loss {losses[1]} is "
              f"not below step 1's {losses[0]}")
        check(launches == LOSSY_STEPS * 2 * TRAIN_LAYERS
              and tc_launches == launches, f"--{name}: flash launches "
              f"{launches} ({tc_launches} tensor-core) over {LOSSY_STEPS} "
              "steps")
        check(bwd == LOSSY_STEPS * TRAIN_LAYERS and not plain_bwd,
              f"--{name}: backward kernel launches {bwd} and plain backward "
              f"calls {len(plain_bwd)} over {LOSSY_STEPS} steps")
        check(len(ef) == 3, f"--{name}: opt['ef'] holds {len(ef)} leaves")
        check(kernels.get("wire_order" if name == "int8"
                          else "sparse_accum_slots", 0) > 0,
              f"--{name}: the step launched no reduction kernel")
        check(losses[0] == dense["loss1"], f"--{name}: step 1 loss "
              f"{losses[0]!r} != the dense wire step's {dense['loss1']!r}")
        check(rel <= 1e-3, f"--{name}: step 1 grad norm {norms[0]} vs "
              f"{dense['norm1']}")
        del run, ef, t
        torch.cuda.empty_cache()


def phase_remat(torch, card, total_mem) -> None:
    """The remat policies at full width (``WIRE_TRAIN_FLAGS`` at
    ``COMPARE_LAYERS``), each from the same parameters and batch: step 1's
    loss and gradient norm bitwise equal under ``full``, ``dots`` and
    ``names`` (remat changes what is kept, not what is computed), flash
    2 × layers a step under each (the backward recomputes it: no policy
    sees the kernel's launch); each policy's peak and step time."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import train as launch

    got = {}
    for policy in REMAT_POLICIES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = launch.setup(WIRE_TRAIN_FLAGS, n_layers=COMPARE_LAYERS,
                           dtype=torch.bfloat16, remat_policy=policy)
        fa.launches = 0
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = run.train_step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if len(ms) == 1:
                m1 = {k: m[k].clone() for k in ("loss", "grad_norm")}
        got[policy] = (m1, fa.launches, ms,
                       torch.cuda.max_memory_allocated())
        del run, m
    for policy, (m1, launches, ms, peak) in got.items():
        print(f"remat {policy} at {COMPARE_LAYERS} layers: step 1 loss "
              f"{float(m1['loss'])!r} grad norm {float(m1['grad_norm'])!r}; "
              f"flash launches {launches} over 2 steps; step ms ({card}) "
              f"{ms[0]:.1f} then {ms[1]:.1f}; peak device memory "
              f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}")
        check(launches == 2 * 2 * COMPARE_LAYERS, f"remat {policy}: flash "
              f"launches {launches}, want {2 * COMPARE_LAYERS} a step")
        for k in ("loss", "grad_norm"):
            check(same_bits(m1[k], got["full"][0][k]), f"remat {policy}: "
                  f"step 1 {k} != full's")
    torch.cuda.empty_cache()


def int8_wire_bytes(z: int, sizes: dict, axes, hier: bool,
                    block: int = QBLOCK) -> float:
    """Bytes a rank puts on the wire for the int8 protocol on ``z``
    elements: each leg over an axis of P ranks sends ``(P - 1) / P`` of
    its vector as int8 plus a 4-byte scale a block, once in the
    ``all_to_all`` and once in the all-gather.  Hierarchical: the inner
    legs at ``z``, each outer axis at ``z / P_inner``; flat: every axis
    at ``z``."""
    def legs(n, p):
        return 2 * (p - 1) / p * n * (1 + 4 / block)
    *outer, inner = axes
    total = legs(z, sizes[inner])
    n = z / sizes[inner] if hier else z
    return total + sum(legs(n, sizes[a]) for a in outer)


def sparse_wire_bytes(sparse, ks, s: int, sizes: dict, axes, hier: bool,
                      threshold: float) -> float:
    """Bytes a rank puts on the wire for the sparse schedules on B
    buckets of ``s`` elements (lists of capacity ``max(ks)``):
    ``expected_sparse_wire_bytes`` over the recursive doubling (across
    every level when hierarchical), plus the dense rhd hop across pods
    for ``two_level``."""
    *outer, inner = axes
    p = sizes[inner] * (math.prod(sizes[a] for a in outer) if hier else 1)
    one = sparse.expected_sparse_wire_bytes(s, max(ks), p,
                                            density_threshold=threshold)
    if outer and not hier:
        q = sizes[outer[-1]]
        one += 2 * (q - 1) / q * s * 4
    return len(ks) * one


class WireSparseSpy:
    """Keeps a few buckets of a wire sparse reduction's first step: the
    arena ``v`` its transport reduces (the gradients: no state yet), the
    lists each rank sent (``topk_sparsify``'s first call) and the
    result."""

    def __init__(self, sparse, transports, buckets):
        self.sparse, self.transports, self.buckets = sparse, transports, buckets
        self.topk = sparse.topk_sparsify
        self.call = transports.SparseTransport.__call__
        self.kept = None

    def patches(self):
        spy = self

        def topk(x, k, k_eff=None):
            val, idx = spy.topk(x, k, k_eff)
            if spy.kept is not None and "val" not in spy.kept:
                spy.kept["val"] = val[..., spy.buckets, :].clone()
                spy.kept["idx"] = idx[..., spy.buckets, :].clone()
            return val, idx

        def call(self, buf, ef, staggers, extents):
            first = spy.kept is None
            if first:
                spy.kept = {"v": buf[..., spy.buckets, :].clone(),
                            "ks": [spy.sparse.sparse_k(self.k_frac,
                                                       extents[b])
                                   for b in spy.buckets]}
            red, ef_out = spy.call(self, buf, ef, staggers, extents)
            if first:
                spy.kept["red"] = red[(0,) * self.mesh.ndim][
                    spy.buckets].clone()
            return red, ef_out
        return [mock.patch.object(self.sparse, "topk_sparsify", topk),
                mock.patch.object(self.transports.SparseTransport,
                                  "__call__", call)]


def phase_wire_lossy(torch, card, total_mem, cfg, seed) -> dict:
    """The wire int8 and sparse reductions at full width
    (``WIRE_LOSSY_RUNS``): two steps with the error-feedback state, the
    kernels' launches, the plain twin, the int8 and kept-entry bounds,
    batched == per bucket and card == CPU on a reduced arena; time, peak
    and the bytes each rank would put on the wire.  Returns the launches
    and the shapes of the wire-order accumulation for the kernel
    figures."""
    from repro_torch import tree
    from repro_torch.core import arena as arena_mod
    from repro_torch.core import sparse, transports
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import topk_compact as tk
    from repro_torch.mesh import AXES, RankMesh
    from repro_torch.models import transformer

    def mk(shape, s):
        return make_grads(torch, tree, transformer, cfg, shape, s)

    def reset():
        for k in qt.launches:
            qt.launches[k] = 0
        for k in sa.launches:
            sa.launches[k] = 0
        qt.wire_launches = tk.launches = 0

    def counts():
        return dict(qt.launches, wire_order=qt.wire_launches, **sa.launches,
                    topk_compact=tk.launches)
    found, profiled = {}, set()
    shapes = [tuple(p.shape) for p in tree.flatten(transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)))[0]]
    print(f"wire lossy reductions: {cfg.name} at published widths, "
          f"{LAYERS} layers, 8 ranks, two steps each with the state")
    for name, shape, kw in WIRE_LOSSY_RUNS:
        mesh = RankMesh(shape, AXES)
        config = FlareConfig(**{"axes": AXES, **kw})
        int8 = config.compression == "int8"
        red = GradReducer(config, mesh)
        meta = [torch.empty((*shape, *p), device="meta") for p in shapes]
        grp = arena_mod.build_plan(meta, config.bucket_bytes,
                                   pad_multiple=red._pad_multiple(8),
                                   lead_dims=2).groups[0]
        t = transports.from_config(config, mesh, torch.float32)
        hier = (t._use_hierarchy() and len(config.axes) > 1 if int8
                else t._hier())
        nb = grp.num_buckets
        spy = WireSparseSpy(sparse, transports, [0, nb // 2, nb - 1])
        wire_rec = Recorder(qt, "dequant_accum_slots",
                            lambda q, s, qblock=QBLOCK, wire_order=False: (
                                tuple(q.shape), wire_order))
        # -- two steps on the kernels, the counters read around them ------
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset()
        with contextlib.ExitStack() as stack:
            for ptc in ([wire_rec.patch()] if int8 else spy.patches()):
                stack.enter_context(ptc)
            g = mk(shape, seed)
            r1, st1 = red(g)
            del g
            d1 = digest(torch, tree.flatten(r1)[0] + tree.flatten(st1)[0])
            g = mk(shape, seed + 1)
            r2, st2 = red(g, st1)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = counts()
        d2 = digest(torch, tree.flatten(r2)[0] + tree.flatten(st2)[0])
        del r2, st2
        need = (("quantize", "dequantize", "wire_order") if int8
                else ("sparse_accum_slots",))
        for k in need:
            check(got[k] > 0, f"wire {name} on {shape}: no {k} launch")
        # -- step 1 against fp64 ---------------------------------------------
        if int8:
            rounds = 4 if len(config.axes) > 1 else 2
            worst = check_quant_bound(
                torch, grp, tree.flatten(mk(shape, seed))[0],
                tree.flatten(r1)[0], mesh, rounds)
            bound = (f"step 1 within {worst:.3f} of the int8 bound "
                     f"({rounds} quantizations on each element's path)")
        else:
            worst, nchecked = check_sparse_kept(torch, spy.kept,
                                                sparse.SENTINEL)
            spy.kept = None
            bound = (f"on {nchecked} buckets x 8 ranks exactly k kept, no "
                     f"dropped magnitude above a kept one, fp64 error <= "
                     f"{worst:.3f} of 8·2^-24·Σ|kept|")
        del r1
        # -- time: five reductions with the state ---------------------------
        ms, runs = timed(torch, lambda: red(g, st1), 5)
        if ("int8" if int8 else "sparse") not in profiled:
            profiled.add("int8" if int8 else "sparse")
            phase_profile(torch, lambda: red(g, st1), card,
                          f"one wire {name} reduction on {shape} with a "
                          "state")
        del g, st1
        torch.cuda.empty_cache()
        # -- the plain twin, held through the digests -----------------------
        before = counts()
        patches = (plain_quant_patches(qt, ops) if int8
                   else plain_sparse_patches(sa, tk, ops))
        g = mk(shape, seed)
        p1, pst = run_plain(patches, lambda: red(g))
        del g
        check(digest(torch, tree.flatten(p1)[0] + tree.flatten(pst)[0])
              == d1, f"wire {name}: step 1 != the plain twin")
        del p1
        g = mk(shape, seed + 1)
        p2, pst = run_plain(patches, lambda: red(g, pst))
        del g
        check(digest(torch, tree.flatten(p2)[0] + tree.flatten(pst)[0])
              == d2, f"wire {name}: step 2 != the plain twin")
        check(counts() == before, f"wire {name}: the plain twin launched")
        del p2, pst
        torch.cuda.empty_cache()
        # -- a reduced arena: batched == per bucket, card == CPU ------------
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        small = grp.pack(tree.flatten(mk(shape, seed))[0])[
            ..., :SMALL_BUCKETS, :SMALL_S].clone()
        ef = torch.randn(small.shape, generator=gen, device="cuda") * 1e-3
        ext = [min(e, SMALL_S) for e in grp.valid_extents[:SMALL_BUCKETS]]
        st = torch.arange(SMALL_BUCKETS, device="cuda")
        outs = [transports.from_config(config, mesh, torch.float32,
                                       batched=b)(small.clone(), ef, st, ext)
                for b in (True, False)]
        cpu = t(small.cpu(), ef.cpu(), st.cpu(), ext)
        for o, what in ((outs[1], "per bucket"), (cpu, "the CPU")):
            check(same_bits(outs[0][0].cpu(), o[0].cpu())
                  and same_bits(outs[0][1].cpu(), o[1].cpu()),
                  f"wire {name}: batched on the card != {what}")
        del small, ef, outs, cpu
        torch.cuda.empty_cache()
        sizes = dict(zip(AXES, shape))
        z = grp.num_buckets * grp.bucket_elems
        if int8:
            wire = int8_wire_bytes(z, sizes, config.axes, hier)
        else:
            ks = [sparse.sparse_k(config.sparse_k_frac, e)
                  for e in grp.valid_extents]
            wire = sparse_wire_bytes(sparse, ks, grp.bucket_elems, sizes,
                                     config.axes, hier,
                                     config.density_threshold)
        print(f"wire {name} on {shape} over {config.axes} "
              f"({'hierarchical' if hier else 'flat'}): arena B={nb} "
              f"S={grp.bucket_elems}; launches over two steps "
              f"{ {k: v for k, v in got.items() if v} }; {bound}; both "
              "steps' results and state bitwise == the plain twin "
              "(digests); batched == per bucket and card == CPU on "
              f"{SMALL_BUCKETS} buckets of {SMALL_S}; ms with a state "
              f"(median of 5, {card}): {ms:.3f} (runs "
              f"{[round(x, 3) for x in runs]}); peak device memory "
              f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}; wire "
              f"bytes per rank {wire / 1e9:.3f} GB")
        if name == "int8 hierarchical":
            step1 = wire_rec.seen[:len(wire_rec.seen) // 2]
            found = {"launches": got["wire_order"],
                     "shapes": [q for q, order in step1 if order]}
    return found


def find_plan(dataplane, pk, counts, start=0, **rates):
    """The first seed from ``start`` whose plan survives the default retry
    budget on these level shapes and makes every kind of fault happen
    (a retransmission, a duplicate, a corrupted delivery, a reordered
    round), as the reference's chaos group searches."""
    import numpy as np
    for seed in range(start, start + 50):
        plan = pk.FaultPlan(seed=seed, **rates)
        if not dataplane.plan_survives(plan, counts):
            continue
        sch = [x for x in dataplane.fault_schedules(plan, counts)
               if x is not None]
        if (sum(x.retransmits for x in sch) and sum(x.duplicates for x in sch)
                and sum(x.corrupt_rejected for x in sch)
                and any(not np.array_equal(q, np.sort(q))
                        for x in sch for q in x.perms)):
            return plan
    raise RuntimeError(f"no surviving plan with every fault on {counts}")


def phase_lossy_fabric(torch, card, total_mem, cfg, seed, clean) -> dict:
    """Phase 14: the in-network reduction over a lossy fabric (module
    docstring, item 14).  ``clean`` holds the fault-free figures of
    phases 2-4 (median ms, peak bytes).  Returns the kernels' launches
    on the lossy paths."""
    import dataclasses

    import numpy as np

    from repro_torch import tree
    from repro_torch.core import arena as arena_mod, sparse, transports
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.launch import train as launch
    from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
    from repro_torch.models import transformer
    from repro_torch.perfmodel import switch_model as sm
    from repro_torch.switch import dataplane, packets as pk

    t_phase = time.perf_counter()
    mesh, flat = RankMesh(TWO_LEVEL, AXES), RankMesh(FLAT, AXES)
    mk = lambda s, shape=mesh.shape: make_grads(torch, tree, transformer,
                                                cfg, shape, s)
    fanins = [l.fanin for l in dataplane._levels(mesh, AXES)]
    g = mk(seed)
    like = [torch.empty(l.shape[2:], device="meta")
            for l in tree.flatten(g)[0]]
    del g
    torch.cuda.empty_cache()
    runs = {"dense": dict(reproducible=True), "int8": dict(
        compression="int8"), "sparse": dict(sparse_k_frac=FABRIC_SPARSE)}
    launched = {}

    def group_of(red):
        return arena_mod.build_plan(
            like, red.config.bucket_bytes, pad_multiple=red._pad_multiple(8),
            lead_dims=0).groups[0]

    def counts_of(mode, grp, fan=fanins):
        ks = [sparse.sparse_k(FABRIC_SPARSE, e) for e in grp.valid_extents]
        return dataplane.level_packet_counts(
            fan, grp.num_buckets, grp.bucket_elems, torch.float32, mode=mode,
            block=QBLOCK, k_max=max(ks) if mode == "sparse" else None)

    # -- the plans, and the schedules' host time cold and cached ------------
    plans, counts, host = {}, {}, {}
    for mode, kw in runs.items():
        red = GradReducer(FlareConfig(axes=AXES, transport="innetwork", **kw),
                          mesh)
        counts[mode] = counts_of(mode, group_of(red))
        plans[mode] = find_plan(dataplane, pk, counts[mode], **FABRIC_RATES)
        dataplane._schedules.cache_clear()
        dataplane._admission_folds.cache_clear()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            for x in dataplane.fault_schedules(plans[mode], counts[mode]):
                dataplane._admission_folds(x)
            times.append((time.perf_counter() - t0) * 1e3)
        host[mode] = times
        sch = dataplane.fault_schedules(plans[mode], counts[mode])
        model = [sm.model_lossy(plans[mode].drop, plans[mode].corrupt, p * n)
                 for p, n in counts[mode]]
        print(f"lossy fabric {mode}: levels (P, n) {counts[mode]}, plan "
              f"{plans[mode]}; schedules and admission folds on the host "
              f"{times[0]:.1f} ms cold, {times[1]:.3f} ms cached; per level "
              f"rounds {[x.rounds for x in sch]}, retransmits "
              f"{[x.retransmits for x in sch]} (model_lossy "
              f"{[round(m.retransmits, 1) for m in model]}), duplicates "
              f"{[x.duplicates for x in sch]}, corrupt "
              f"{[x.corrupt_rejected for x in sch]}, wait rounds "
              f"{[x.wait_rounds for x in sch]}, reordered rounds "
              f"{[int(sum(not np.array_equal(q, np.sort(q)) for q in x.perms)) for x in sch]}"
              f"; model survival {[round(m.survival, 4) for m in model]}")

    # -- dense reproducible at full width ------------------------------------
    kw = runs["dense"]
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  fault_plan=plans["dense"], **kw), mesh)
    ref = GradReducer(FlareConfig(axes=AXES, transport="innetwork", **kw),
                      mesh)
    grads = mk(seed)
    want, _ = ref(grads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.launches = 0
    got, _ = red(grads)
    torch.cuda.synchronize()
    launched["tree_reduce_slots"] = tr.launches
    check(tr.launches > 0, "the lossy dense path launched no fold")
    check(trees_same_bits(got, want), "lossy dense != the fault-free run")
    del got, want
    ms, all_ms = timed(torch, lambda: red(grads), 5)
    peak = torch.cuda.max_memory_allocated()
    print(f"lossy fabric dense reproducible on {mesh.shape}: tree_reduce_slots "
          f"launches {launched['tree_reduce_slots']}; bitwise == the "
          f"fault-free run; ms (median of 5, {card}) {ms:.3f} (runs "
          f"{[round(t, 3) for t in all_ms]}), fault-free "
          f"{clean['dense'][0]:.3f}; peak {peak / 2**30:.2f} GiB (fault-free "
          f"{clean['dense'][1] / 2**30:.2f}) of {total_mem / 2**30:.1f}")

    # the traced counters against the static schedules
    grp = group_of(red)
    arena = grp.pack(tree.flatten(grads)[0])
    del grads
    _, st = dataplane.switch_allreduce_dense(
        arena, mesh, AXES, reproducible=True, fault_plan=plans["dense"],
        with_fault_stats=True)
    sch = dataplane.fault_schedules(plans["dense"], counts["dense"])
    want_st = {"retransmits": sum(x.retransmits for x in sch),
               "duplicates_dropped": sum(x.duplicates for x in sch),
               "corrupt_rejected": sum(x.corrupt_rejected for x in sch),
               "delivered": sum(p * n for p, n in counts["dense"])}
    for k, v in want_st.items():
        check(bool((st[k] == v).all()), f"traced {k} {st[k].tolist()} != "
              f"the static schedules' {v}")
    model = [sm.model_lossy(plans["dense"].drop, plans["dense"].corrupt, p * n)
             for p, n in counts["dense"]]
    c = dataplane.plan_counters(AXES, mesh.shape, grp.num_buckets,
                                grp.bucket_elems, torch.float32,
                                reproducible=True)
    print(f"lossy fabric dense counters, every rank: {want_st} == the static "
          f"schedules' sums; model_lossy at the same P·n expects "
          f"retransmits {sum(m.retransmits for m in model):.1f}, retry "
          f"rounds {[round(m.retry_rounds, 3) for m in model]}, survival "
          f"{np.prod([m.survival for m in model]):.4f}; plan_counters "
          f"{c}; model_point {c.model_point(grp.num_buckets * grp.bucket_elems * 4)}")
    del arena, st
    torch.cuda.empty_cache()

    # the flat (1, 8) mesh
    fgrads = mk(seed, flat.shape)
    fred = GradReducer(FlareConfig(axes=AXES, transport="innetwork", **kw),
                       flat)
    fcounts = counts_of("dense", group_of(fred), [8])
    fplan = find_plan(dataplane, pk, fcounts, **FABRIC_RATES)
    fwant, _ = fred(fgrads)
    tr.launches = 0
    fgot, _ = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                      fault_plan=fplan, **kw), flat)(fgrads)
    torch.cuda.synchronize()
    check(tr.launches > 0, "the flat lossy path launched no fold")
    check(trees_same_bits(fgot, fwant), "flat lossy dense != fault-free")
    print(f"lossy fabric dense on {flat.shape}: levels {fcounts}, plan seed "
          f"{fplan.seed}; launches {tr.launches}; bitwise == fault-free")
    del fgrads, fwant, fgot
    torch.cuda.empty_cache()

    # -- int8 and sparse, two steps with the state, through digests ---------
    for mode, kernels in (("int8", ("quantize", "dequantize",
                                    "dequant_accum_slots")),
                          ("sparse", ("sparse_accum_slots",))):
        kw = runs[mode]
        ref = GradReducer(FlareConfig(axes=AXES, transport="innetwork", **kw),
                          mesh)
        red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                      fault_plan=plans[mode], **kw), mesh)

        def two(r):
            g = mk(seed)
            r1, st = r(g)
            g = mk(seed + 1)
            r2, st = r(g, st)
            del g
            d = [digest(torch, tree.flatten(x)[0]) for x in (r1, r2, st)]
            return d, st
        want, st = two(ref)
        del st
        torch.cuda.empty_cache()
        counters = qt.launches if mode == "int8" else sa.launches
        for k in counters:
            counters[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, st = two(red)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            launched[k] = counters[k]
            check(counters[k] > 0, f"the lossy {mode} path launched no {k}")
        check(got == want, f"lossy {mode}: results or state != the fault-free "
              f"run's (digests {got} vs {want})")
        g = mk(seed + 1)
        ms, all_ms = timed(torch, lambda: red(g, st), 5)
        print(f"lossy fabric {mode} on {mesh.shape}, two steps: launches "
              f"{ {k: launched[k] for k in kernels} }; results and state "
              f"bitwise == the fault-free run's (digests {got}); ms with a "
              f"state (median of 5, {card}) {ms:.3f} (runs "
              f"{[round(t, 3) for t in all_ms]}), fault-free "
              f"{clean[mode][0]:.3f}; peak {peak / 2**30:.2f} GiB "
              f"(fault-free {clean[mode][1] / 2**30:.2f})")
        del g, st
        torch.cuda.empty_cache()

    # -- the per-packet plane on a reduced arena, card == CPU ----------------
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    small = torch.randn((*mesh.shape, SMALL_BUCKETS, SMALL_S), generator=gen,
                        device="cuda")
    ks = [sparse.sparse_k(FABRIC_SPARSE, SMALL_S)] * SMALL_BUCKETS

    def sparse_plane(x, m, a, **k):
        out = dataplane.switch_allreduce_sparse(x, m, a, ks, **k)
        return (out[0], out[-1]) if k.get("with_fault_stats") else out[0]
    planes = {"dense": (dataplane.switch_allreduce_dense,
                        dict(reproducible=True)),
              "int8": (dataplane.switch_allreduce_int8, {}),
              "sparse": (sparse_plane, {})}
    for mode, (plane, pkw) in planes.items():
        grp_counts = dataplane.level_packet_counts(
            fanins, SMALL_BUCKETS, SMALL_S, torch.float32, mode=mode,
            block=QBLOCK, k_max=ks[0])
        plan = find_plan(dataplane, pk, grp_counts, start=plans[mode].seed,
                         **FABRIC_RATES)
        outs = [plane(small, mesh, AXES, fault_plan=plan,
                      with_fault_stats=True, batched=bt,
                      arrival_perms=None if bt else level_perms(
                          dataplane, mesh, AXES, 9), **pkw)
                for bt in (True, False)]
        cpu = plane(small.cpu(), mesh, AXES, fault_plan=plan,
                    with_fault_stats=True, **pkw)
        base = plane(small, mesh, AXES, **pkw)
        check(same_bits(outs[0][0], outs[1][0]), f"reduced {mode}: batched "
              "!= per-packet under faults and arrival permutations")
        check(same_bits(outs[0][0], base), f"reduced {mode}: lossy != the "
              "fault-free plane")
        check(same_bits(outs[0][0].cpu(), cpu[0]), f"reduced {mode}: card "
              "!= CPU")
        check(all(torch.equal(outs[0][-1][k], o[-1][k].to(outs[0][-1][k]))
                  for o in (outs[1], cpu) for k in outs[0][-1]),
              f"reduced {mode}: fault counters differ between the planes")
        print(f"lossy fabric {mode} on a {tuple(small.shape)} arena: levels "
              f"{grp_counts}, plan seed {plan.seed}: per-packet (under "
              "arrival permutations) == batched == fault-free, card == CPU, "
              f"counters equal {({k: int(v[0, 0]) for k, v in outs[0][-1].items()})}")
    del outs, cpu, base

    # -- a doomed plan degrades to the wire ----------------------------------
    doomed = pk.FaultPlan(seed=0, drop=0.9,
                          retry=pk.RetryPolicy(max_retries=0))
    check(not dataplane.plan_survives(doomed, counts["dense"]),
          "the doomed plan survives")
    grads = mk(seed)
    kw = runs["dense"]
    want, _ = GradReducer(FlareConfig(axes=AXES, transport="innetwork", **kw),
                          mesh)(grads)
    tr.launches = 0
    got, _ = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                     fault_plan=doomed, **kw), mesh)(grads)
    torch.cuda.synchronize()
    check(tr.launches == 0, "the degraded reduction ran the switch's fold")
    check(trees_same_bits(got, want), "degraded dense != the in-network "
          "fault-free result")
    del want
    wire, _ = GradReducer(FlareConfig(axes=AXES, algorithm="fixed_tree",
                                      reproducible=True), mesh)(grads)
    check(trees_same_bits(got, wire), "degraded dense != the wire fixed tree")
    del grads, got, wire
    torch.cuda.empty_cache()
    staggers = torch.zeros(SMALL_BUCKETS, dtype=torch.int32, device="cuda")
    for mode in ("int8", "sparse"):
        t = transports.from_config(FlareConfig(
            axes=AXES, transport="innetwork", fault_plan=doomed,
            **runs[mode]), mesh, torch.float32)
        wire_t = t._degrade()
        got = t(small.clone(), None, staggers, (SMALL_S,) * SMALL_BUCKETS)
        want = wire_t(small.clone(), None, staggers,
                      (SMALL_S,) * SMALL_BUCKETS)
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
              f"degraded {mode} != {type(wire_t).__name__}")
    print(f"lossy fabric, a doomed plan ({doomed}): plan_survives False; "
          "dense reproducible at full width degrades to the wire, bitwise "
          "== the in-network fault-free result == the wire fixed_tree; int8 "
          "and sparse on the reduced arena bitwise == the wire transport "
          "_degrade builds (Int8Transport, SparseTransport)")
    del small, got, want, t, wire_t
    torch.cuda.empty_cache()

    # -- the launcher's training step with --fault-rate ----------------------
    torch.cuda.reset_peak_memory_stats()
    run = launch.setup(FABRIC_TRAIN_FLAGS, n_layers=TRAIN_LAYERS,
                       dtype=torch.bfloat16)
    check(run.step.reducer.config.fault_plan == pk.FaultPlan(
        seed=1, drop=0.01), "the launcher built another plan")
    steps, losses = [], []

    def one():
        t0 = time.perf_counter()
        losses.append(float(run.train_step()["loss"]))
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    one()                                      # warm-up
    fa.launches = fa.tc_launches = 0
    for _ in range(FABRIC_STEPS):
        one()
    torch.cuda.synchronize()
    launched["flash_attention"], tc = fa.launches, fa.tc_launches
    check(all(map(math.isfinite, losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"losses do not fall: {losses}")
    check(fa.launches == FABRIC_STEPS * 2 * TRAIN_LAYERS
          and fa.tc_launches == fa.launches, f"flash launches {fa.launches} "
          f"({fa.tc_launches} tensor-core) over {FABRIC_STEPS} steps")
    red_in = []
    real_call = GradReducer.__call__

    def spy(self, grads, state=None):
        out = real_call(self, grads, state)
        red_in.append(([x.clone() for x in grads],
                       [o.clone() for o in out[0]]))
        return out
    with mock.patch.object(GradReducer, "__call__", spy):
        run.train_step()
    torch.cuda.synchronize()
    check(len(red_in) == 1, "the replay captured no reduction")
    grads, reduced = red_in[0]
    lossy_t = run.step.reducer._transport(torch.float32, batched=True)
    again, _ = run.step.reducer(grads)
    plain, _ = GradReducer(dataclasses.replace(run.step.reducer.config,
                                               fault_plan=None),
                           run.step.mesh)(grads)
    check(all(same_bits(a, b) for a, b in zip(reduced, again)),
          "the step's reduced gradients != their replay under the plan")
    check(all(same_bits(a, b) for a, b in zip(reduced, plain)),
          "the step's reduced gradients != the fault-free reduction's")
    print(f"lossy fabric training step ({' '.join(FABRIC_TRAIN_FLAGS)}, "
          f"{TRAIN_LAYERS} layers): losses (warm-up, then {FABRIC_STEPS} "
          f"steps) {[round(x, 4) for x in losses]}; step ms (median of "
          f"{FABRIC_STEPS}, {card}) {statistics.median(steps[1:]):.1f} (runs "
          f"{[round(t, 1) for t in steps[1:]]}); flash launches "
          f"{launched['flash_attention']} ({tc} tensor-core); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the plan "
          f"{type(lossy_t).__name__}({lossy_t.fault_plan}); one step's "
          f"{len(grads)} per-rank gradient leaves replayed with and without "
          "the plan: bitwise")
    del run, red_in, grads, reduced, again, plain, lossy_t
    torch.cuda.empty_cache()
    print(f"lossy fabric phase: {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launched}")
    return launched


def phase_shared_switch(torch, card, total_mem, cfg, seed) -> dict:
    """Phase 15: the shared switch (module docstring, item 15).  Returns
    the kernels' launches on the ``--tenants 3`` path."""
    import contextlib
    import io

    from repro_torch import tree
    from repro_torch.core import arena as arena_mod, sparse, transports
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.launch import train as launch
    from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
    from repro_torch.models import transformer
    from repro_torch.runtime import AdmissionError, SessionManager, sessions
    from repro_torch.switch import dataplane

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels_of = {"dense": ("tree_reduce_slots",),
                  "int8": ("quantize", "dequant_accum_slots", "dequantize"),
                  "sparse": ("sparse_accum_slots",)}

    def zero_counters():
        tr.launches = fa.launches = fa.tc_launches = 0
        for c in (qt.launches, sa.launches):
            for k in c:
                c[k] = 0

    def counters():
        return {"tree_reduce_slots": tr.launches,
                "quantize": qt.launches["quantize"],
                "dequant_accum_slots": qt.launches["dequant_accum_slots"],
                "dequantize": qt.launches["dequantize"],
                "sparse_accum_slots": sa.launches["sparse_accum_slots"],
                "flash_attention": fa.launches}

    def transport(mesh, kw, mgr, name):
        return transports.from_config(
            FlareConfig(axes=AXES, transport="innetwork", **kw), mesh,
            torch.float32, manager=mgr, tenant=name)

    def admits(shape, name, b, s, kw):
        t = transport(RankMesh(shape, AXES), kw,
                      SessionManager(AXES, shape), name)
        try:
            t.attach(b, s, torch.float32, (s,) * b)
            return True
        except AdmissionError:
            return False

    # -- at scale: shared == solo == the manager-less plane --------------------
    for shape in (TWO_LEVEL, FLAT):
        mesh = RankMesh(shape, AXES)
        tenants = []
        for name, (b, s), kw in SHARED_TENANTS:
            while b > 1 and not admits(shape, name, b, s, kw):
                b //= 2
            check(admits(shape, name, b, s, kw), f"{name} {b}x{s} is not "
                  f"admitted on {shape}")
            tenants.append((name, b, s, kw))
        gen = torch.Generator(device="cuda").manual_seed(seed + 15)
        zeros = torch.zeros(max(b for _, b, _, _ in tenants),
                            dtype=torch.int32, device="cuda")
        for name, b, s, kw in tenants:
            x = torch.randn((*shape, b, s), generator=gen, device="cuda")
            ext = (s,) * b

            def run(t):
                # the lossy transports consume their input: a copy each
                return t(x.clone(), None, zeros[:b], ext)[0]
            plain = transport(mesh, kw, None, None)
            solo_mgr = SessionManager(AXES, shape, seed=7)
            solo_t = transport(mesh, kw, solo_mgr, name)
            want = run(plain)
            solo = run(solo_t)
            check(solo_mgr.arrival_perms(name) is None, "a solo tenant got "
                  "arrival permutations")
            check(same_bits(solo, want), f"{name} on {shape}: solo under a "
                  "manager != the manager-less plane")
            del want
            shared_ts = []
            for mseed in (7, 8):
                mgr = SessionManager(AXES, shape, seed=mseed)
                for n2, b2, s2, kw2 in tenants:
                    transport(mesh, kw2, mgr, n2).attach(
                        b2, s2, torch.float32, (s2,) * b2)
                check(len(mgr.active()) == 3, f"{[x.tenant for x in mgr.active()]}")
                t = transport(mesh, kw, mgr, name)
                draws = sessions._perm_draw.cache_info().misses
                torch.cuda.synchronize()
                zero_counters()
                got = run(t)
                torch.cuda.synchronize()
                at_scale = {k: counters()[k] for k in kernels_of[name]}
                drawn = sessions._perm_draw.cache_info().misses - draws
                check(all(at_scale.values()), f"{name} on {shape}: the "
                      f"shared reduction launched {at_scale}")
                check(same_bits(got, solo), f"{name} on {shape}: shared "
                      f"(manager seed {mseed}) != solo")
                del got
                shared_ts.append((mgr, t))
            mgr, t = shared_ts[0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            solo_ms, solo_all = timed(torch, lambda: run(solo_t), 5)
            solo_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            shared_ms, shared_all = timed(torch, lambda: run(t), 5)
            shared_peak = torch.cuda.max_memory_allocated()
            # the permutations this tenant's levels would draw, by hand
            sess = mgr.session(name)
            fanins = [l.fanin for l in dataplane._levels(mesh, AXES)]
            counts = dataplane.level_packet_counts(
                fanins, b, s, torch.float32, mode=sess.mode, block=QBLOCK,
                k_max=sess.k)
            perms = mgr.arrival_perms(name)
            host = []
            sessions._perm_draw.cache_clear()
            for _ in range(2):
                t0 = time.perf_counter()
                for i, (p, n) in enumerate(counts):
                    perms[i](p, n)
                host.append((time.perf_counter() - t0) * 1e3)
            print(f"shared switch at scale, {name} {b}x{s} on {shape}: "
                  f"demand {sess.demand_bytes} B of {mgr.bytes_per_session}; "
                  f"shared (manager seeds 7, 8) == solo == manager-less, "
                  f"bitwise; launches {at_scale}; permutations the batched "
                  f"plane drew: {drawn}; "
                  f"ms (median of 5, a copy of the input included, {card}) "
                  f"shared {shared_ms:.3f} (runs "
                  f"{[round(v, 3) for v in shared_all]}), solo {solo_ms:.3f} "
                  f"(runs {[round(v, 3) for v in solo_all]}); peak shared "
                  f"{shared_peak / 2**30:.3f} GiB, solo "
                  f"{solo_peak / 2**30:.3f}; the levels' arrival "
                  f"permutations {counts} on the host {host[0]:.3f} ms "
                  f"cold, {host[1]:.4f} ms cached")
            del x, solo, shared_ts, mgr, t, solo_t, plain
            torch.cuda.empty_cache()

    # the 4-layer gradient arena is refused: the host-fallback signal
    g = make_grads(torch, tree, transformer, cfg, (1, 1), seed)
    like = [torch.empty(l.shape[2:], device="meta")
            for l in tree.flatten(g)[0]]
    del g
    torch.cuda.empty_cache()
    red = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                  reproducible=True), RankMesh(TWO_LEVEL))
    grp = arena_mod.build_plan(like, red.config.bucket_bytes,
                               pad_multiple=red._pad_multiple(8),
                               lead_dims=0).groups[0]
    mgr = SessionManager(AXES, TWO_LEVEL)
    try:
        transport(RankMesh(TWO_LEVEL), {"reproducible": True}, mgr,
                  "arena").attach(grp.num_buckets, grp.bucket_elems,
                                  torch.float32, grp.valid_extents)
        refused = None
    except AdmissionError as e:
        refused = str(e)
    check(refused is not None, "the 4-layer arena was admitted")
    print(f"shared switch: the {LAYERS}-layer gradient arena "
          f"{grp.num_buckets}x{grp.bucket_elems} raises AdmissionError: "
          f"{refused}")

    # -- the launcher's --tenants 3 path ---------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shared = launch.setup_tenants(TENANT_FLAGS, n_layers=TENANT_LAYERS,
                                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mgr = shared.manager
    check([x.tenant for x in mgr.active()] == [
        f"job{k}/float32" for k in range(3)], "the jobs are not registered "
        f"before their first step: {[x.tenant for x in mgr.active()]}")
    runs = [(name, kind, run) for name, kind, run in shared.jobs]
    losses = {name: [] for name, _, _ in runs}
    step_ms = {name: [] for name, _, _ in runs}
    captured = {}
    real_call = GradReducer.__call__

    def spy(self, grads, state=None):
        g_in = [x.clone() for x in grads]
        s_in = None if state is None else [x.clone() for x in state]
        out = real_call(self, grads, state)
        captured[self.tenant] = (self, g_in, s_in,
                                 [o.clone() for o in out[0]],
                                 None if out[1] is None
                                 else [o.clone() for o in out[1]])
        return out

    def one_step(spying=False):
        for name, _, run in runs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (mock.patch.object(GradReducer, "__call__", spy)
                  if spying else contextlib.nullcontext()):
                losses[name].append(float(run.train_step()["loss"]))
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t) * 1e3)
    one_step()                                 # warm-up
    zero_counters()
    for i in range(TENANT_STEPS):
        one_step(spying=(i == 0))
    torch.cuda.synchronize()
    launched = counters()
    peak = torch.cuda.max_memory_allocated()
    # the int8 tenant's norm-leaf arena is below the §6.4 switchover: its
    # switches fold in the tree design (dequantize, then the fixed tree),
    # so dequant_accum_slots launches only at scale above
    for k, v in launched.items():
        check(v > 0 or k == "dequant_accum_slots",
              f"the --tenants 3 path launched no {k}")
    check(fa.tc_launches == fa.launches == 3 * TENANT_STEPS * 2
          * TENANT_LAYERS, f"flash launches {fa.launches} ({fa.tc_launches} "
          "tensor-core)")
    for name, ls in losses.items():
        check(all(map(math.isfinite, ls)), f"{name}: a loss is not finite "
              f"{ls}")
        check(ls[-1] < ls[0], f"{name}: losses do not fall {ls}")
    print(f"shared switch training ({' '.join(TENANT_FLAGS)}, "
          f"{TENANT_LAYERS} layers, bf16 compute): set up in {setup_s:.1f} "
          f"s; losses (warm-up, then {TENANT_STEPS} steps) "
          f"{ {n: [round(x, 4) for x in v] for n, v in losses.items()} }; "
          f"step ms ({card}) "
          f"{ {n: [round(x, 1) for x in v[1:]] for n, v in step_ms.items()} } "
          f"(warm-up {[round(v[0], 1) for v in step_ms.values()]}); "
          f"launches over {TENANT_STEPS} steps of every job {launched}; "
          f"peak {peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}")

    # each tenant's reduction bitwise a manager-less one of the same leaves
    check(sorted(captured) == [f"job{k}" for k in range(3)],
          f"captured {sorted(captured)}")
    for tenant, (red, g_in, s_in, out, s_out) in sorted(captured.items()):
        alone = GradReducer(red.config, red.mesh)
        got, st = alone([x.clone() for x in g_in],
                        None if s_in is None else [x.clone() for x in s_in])
        check(all(same_bits(a, b) for a, b in zip(got, out)),
              f"{tenant}: shared reduction != the manager-less one")
        check((st is None) == (s_out is None) and (st is None or all(
            same_bits(a, b) for a, b in zip(st, s_out))),
              f"{tenant}: shared state != the manager-less one")
    report = str(mgr.report())
    print(report)
    check(mgr.report().sessions == 3 and report.count("job") == 3,
          "the report does not name three sessions")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = shared.replan()
    line = buf.getvalue().strip()
    print(line)
    check(line.startswith("congestion replan: replanned="), "no replan line")
    red, g_in, s_in, out, _ = captured["job0"]
    again, _ = red([x.clone() for x in g_in])
    check(all(same_bits(a, b) for a, b in zip(again, out)),
          "the reproducible tenant's bits changed after the replan")
    print(mgr.report())
    print(f"shared switch: replan {res.reason!r}, epoch {mgr._epoch}; "
          f"job0's reduction after it bitwise the same; every tenant's "
          f"first timed step bitwise a manager-less GradReducer; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del shared, runs, captured, red, g_in, out, again
    torch.cuda.empty_cache()
    return launched


def phase_ft_obs(torch, card, total_mem, seed) -> dict:
    """Phase 16: checkpoints, recovery and the flight recorder (module
    docstring, item 16).  Returns the kernels' launches on its paths."""
    import io
    import os
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.core import arena as arena_mod, topology, transports
    from repro_torch.core.engine import FlareConfig
    from repro_torch.data import pipeline
    from repro_torch.ft import CheckpointManager, Coordinator
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.launch import train as launch
    from repro_torch.mesh import AXES, RankMesh
    from repro_torch.obs import Telemetry, counting_clock, timeline
    from repro_torch.runtime import SessionManager
    from repro_torch.switch import dataplane
    from repro_torch.switch import packets as pk

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launched = {}

    def zero_counters():
        tr.launches = fa.launches = fa.tc_launches = 0
        for c in (qt.launches, sa.launches):
            for k in c:
                c[k] = 0

    def counters():
        return {"tree_reduce_slots": tr.launches,
                "quantize": qt.launches["quantize"],
                "dequant_accum_slots": qt.launches["dequant_accum_slots"],
                "dequantize": qt.launches["dequantize"],
                "sparse_accum_slots": sa.launches["sparse_accum_slots"],
                "flash_attention": fa.launches}

    # every run the launcher builds, kept to compare with the next one
    runs = []
    real_setup = launch.setup

    def keep_setup(argv=None, **kw):
        runs.append(real_setup(argv, **kw))
        return runs[-1]

    times = {"save": [], "wait": [], "restore": []}

    def timed_method(name, real):
        def f(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(self, *a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return f

    def main(argv, extra_patches=()):
        """The launcher's ``main`` at ``CKPT_LAYERS``; its output is
        echoed and returned with the losses."""
        buf = io.StringIO()
        with contextlib.ExitStack() as st:
            st.enter_context(mock.patch.object(launch, "setup", keep_setup))
            for obj, name, fn in (
                    (CheckpointManager, "save", CheckpointManager.save),
                    (CheckpointManager, "wait", CheckpointManager.wait),
                    (CheckpointManager, "restore",
                     CheckpointManager.restore)):
                st.enter_context(mock.patch.object(
                    obj, name, timed_method(name, fn)))
            for patch in extra_patches:
                st.enter_context(patch)
            st.enter_context(contextlib.redirect_stdout(buf))
            losses = launch.main(argv, n_layers=CKPT_LAYERS)
        print(buf.getvalue(), end="")
        return losses, buf.getvalue()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        ck = os.path.join(tmp, "ck")
        usage = shutil.disk_usage(tmp)
        print(f"checkpoints in a temporary directory: "
              f"{usage.free / 1e9:.1f} GB free of {usage.total / 1e9:.1f}")
        flags = [*TRAIN_FLAGS, "--ckpt-dir", ck]

        # -- 1. checkpoint, then resume -------------------------------------
        zero_counters()
        saved, _ = main([*flags, "--steps", "2", "--ckpt-every", "2"])
        torch.cuda.synchronize()
        launched["checkpoint"] = counters()
        run1 = runs.pop()
        check(all(map(math.isfinite, saved)), f"losses {saved}")
        check(fa.launches == fa.tc_launches == 2 * 2 * CKPT_LAYERS
              and tr.launches > 0, f"the checkpointed run's launches "
              f"{launched['checkpoint']}")
        step_dir = os.path.join(ck, "step_000002")
        check(CheckpointManager(ck).all_steps() == [2], "no step 2")
        on_disk = sum(os.path.getsize(os.path.join(step_dir, f))
                      for f in os.listdir(step_dir))
        manifest = json.load(open(os.path.join(step_dir, "manifest.json")))
        n_params = sum(math.prod(s) for n, s in zip(
            manifest["names"], manifest["shapes"]) if n.startswith("['p']"))
        save_s, wait_s = times["save"][0], times["wait"][-1]
        print(f"checkpoint of {run1.cfg.name} at published widths, "
              f"{CKPT_LAYERS} layers ({n_params} parameters; p, m and v in "
              f"fp32): {on_disk} bytes on disk in {len(manifest['names'])} "
              f"leaves; save's host copy {save_s * 1e3:.1f} ms "
              f"({on_disk / save_s / 1e9:.2f} GB/s), the write until "
              f"wait() returns {wait_s * 1e3:.1f} ms "
              f"({on_disk / wait_s / 1e9:.2f} GB/s) ({card})")

        def same_state(a, b) -> bool:
            la = tree.flatten(a)[0]
            lb = tree.flatten(b)[0]
            return len(la) == len(lb) and all(
                same_bits(x, y) for x, y in zip(la, lb))

        real_load = launch.Run.load_state
        loaded = {}

        def load_against_run1(self, state):
            real_load(self, state)
            loaded["ranks"] = (same_state(self.params, run1.params)
                               and same_state(self.opt, run1.opt))

        resumed, out = main([*flags, "--steps", "3", "--resume"], [
            mock.patch.object(launch.Run, "load_state", load_against_run1)])
        runs.clear()
        restore_s = times["restore"][-1]
        check("resumed from step 2" in out, "no 'resumed from step 2'")
        check(loaded.get("ranks") is True, "the restored parameters and "
              "optimizer state are not bitwise the saved run's on every "
              "rank")
        print(f"restore {restore_s * 1e3:.1f} ms "
              f"({on_disk / restore_s / 1e9:.2f} GB/s) ({card}); the "
              f"restored state bitwise the saved run's on every rank")

        # -- 2. elastic restart onto the survivors ------------------------
        clock = [0.0]
        coord = Coordinator(8, timeout_s=5, clock=lambda: clock[0])
        clock[0] = 8.0
        for h in range(7):
            coord.heartbeat(h)
        clock[0] = 12.0
        check(coord.check() == {7}, f"failed hosts {coord.failed}")
        plan = coord.plan(model=1, hosts_per_pod=4)
        check(plan.world == 4, f"re-mesh world {plan.world}")
        mesh_flag = f"{plan.new_pod}x{plan.new_data}x{plan.model}"
        global_saved = run1.state()

        def load_against_global(self, state):
            real_load(self, state)
            loaded["global"] = same_state(self.state(), global_saved)

        elastic_flags = [mesh_flag if f == "2x4x1" else f for f in flags]
        elastic, out = main([*elastic_flags, "--steps", "3", "--resume"], [
            mock.patch.object(launch.Run, "load_state", load_against_global)])
        runs.clear()
        del global_saved
        check("resumed from step 2" in out and loaded.get("global") is True,
              "the elastic restart's unshard_params is not bitwise the "
              "saved global leaves")
        check(all(map(math.isfinite, elastic)), f"elastic loss {elastic}")

        # the saved run on a fresh stream: the resumed step's loss
        run1.stream = pipeline.synthetic_batches(
            run1.cfg, run1.args.batch, run1.args.seq, seed=1,
            device=torch.device("cuda"))
        again = float(run1.train_step()["loss"])
        check(again == resumed[0], f"resumed loss {resumed[0]!r} != the "
              f"saved run's {again!r} on the same state and batch")
        print(f"resume: step 2's loss {resumed[0]!r} bitwise the saved "
              f"run's on batch 0 of a fresh stream; elastic restart: hosts "
              f"{sorted(coord.failed)} failed, re-mesh to --mesh "
              f"{mesh_flag} (world {plan.world}), its global leaves "
              f"bitwise the saved ones, loss {elastic[0]:.4f}")
        del run1
        torch.cuda.empty_cache()

        # -- 3. the flight recorder: the same step with and without ---------
        tpath, mpath = os.path.join(tmp, "t.json"), os.path.join(tmp, "m.json")
        step_ms = {False: [], True: []}
        seen = {}
        real_step = launch.Run.train_step
        for traced in (False, True):
            def timed_step(self, batch=None, traced=traced):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = real_step(self, batch)
                torch.cuda.synchronize()
                step_ms[traced].append((time.perf_counter() - t0) * 1e3)
                return m
            argv = [*TRAIN_FLAGS, "--steps", str(1 + OBS_STEPS)]
            if traced:
                argv += ["--trace-out", tpath, "--metrics-out", mpath]
            losses, _ = main(argv, [mock.patch.object(launch.Run,
                                                      "train_step",
                                                      timed_step)])
            run = runs.pop()
            seen[traced] = (losses, digest(torch, tree.flatten(run.params)[0]
                                           + tree.flatten(run.opt)[0]))
            if traced:
                red = run.step.reducer
                rep = [p for p, d in zip(tree.flatten(run.params)[0],
                                         tree.flatten(run.step.dims)[0])
                       if d < 0]
                aplan = arena_mod.build_plan(
                    rep, red.config.bucket_bytes,
                    pad_multiple=red._pad_multiple(red._world()),
                    lead_dims=red.mesh.ndim)
                (group,) = aplan.groups
                pc = dataplane.plan_counters(
                    red.config.axes, tuple(red.mesh.axis_size(a)
                                           for a in red.config.axes),
                    group.num_buckets, group.bucket_elems, group.dtype,
                    reproducible=True)
            del run
            torch.cuda.empty_cache()
        check(seen[False] == seen[True], "telemetry changed the bits: "
              f"losses {seen[False][0]} vs {seen[True][0]}")
        metrics = json.load(open(mpath))
        for i, lvl in enumerate(pc.levels):
            pre = f"switch.solo.l{i + 1}"
            got = tuple(metrics[f"{pre}.{k}"]["value"] for k in (
                "ingress_packets", "egress_packets", "combines"))
            check(got == (lvl.ingress_packets, lvl.egress_packets,
                          lvl.combines), f"{pre}: {got} after "
                  f"{1 + OBS_STEPS} steps, plan_counters gives "
                  f"{(lvl.ingress_packets, lvl.egress_packets, lvl.combines)}")
        check(metrics["switch.solo.total_combines"]["value"]
              == pc.total_combines, "total_combines")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", mpath, tpath],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        check(cli.returncode == 0 and "== per-tenant ==" in cli.stdout
              and "spans on" in cli.stdout, f"the report CLI: {cli.stderr}")
        without = statistics.median(step_ms[False][1:])
        with_ = statistics.median(step_ms[True][1:])
        print(f"flight recorder ({CKPT_LAYERS} layers): losses, parameters "
              f"and optimizer state bitwise the same with and without "
              f"--trace-out/--metrics-out; step ms (median of {OBS_STEPS}, "
              f"{card}) {with_:.1f} with, {without:.1f} without, ratio "
              f"{with_ / without:.4f} (runs {[round(t, 1) for t in step_ms[True]]}"
              f" vs {[round(t, 1) for t in step_ms[False]]}, warm-up first); "
              f"switch.* counters plan_counters' after {1 + OBS_STEPS} steps "
              f"(recorded once); the report CLI:\n{cli.stdout.strip()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 4. the obs group at phase 15's dense shape, twice ------------------
    mesh = RankMesh((2, 4))
    b, s = SHARED_TENANTS[0][1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn((2, 4, b, s), generator=gen, device="cuda") * 100
    counts = dataplane.level_packet_counts([4, 2], b, s, torch.float32)
    fplan = None
    for fseed in range(200):
        cand = pk.FaultPlan(seed=fseed, drop=0.05, duplicate=0.2)
        scheds = [x for x in dataplane.fault_schedules(cand, counts)
                  if x is not None]
        if (dataplane.plan_survives(cand, counts)
                and sum(x.retransmits for x in scheds) > 0):
            fplan = cand
            break
    check(fplan is not None, f"no surviving fault seed for {counts}")

    def obs_run(with_tm):
        tm = Telemetry.create(clock=counting_clock()) if with_tm else None
        mgr = SessionManager(AXES, (2, 4), seed=7, telemetry=tm)
        outs = {}
        for tenant, kw in (("det", dict(reproducible=True)),
                           ("lossy", dict(fault_plan=fplan))):
            t = transports.from_config(
                FlareConfig(axes=AXES, transport="innetwork", telemetry=tm,
                            **kw), mesh, torch.float32, manager=mgr,
                tenant=tenant)
            outs[tenant], _ = t(xs.clone(), None, torch.zeros(
                b, dtype=torch.int32, device="cuda"), (s,) * b)
        if tm is not None:
            mgr.schedule()
            timeline.manager_tracks(tm.tracer, mgr)
        return tm, outs
    zero_counters()
    tm1, out1 = obs_run(True)
    tm2, out2 = obs_run(True)
    _, bare = obs_run(False)
    launched["obs group"] = counters()
    check(tm1.trace_json() == tm2.trace_json()
          and tm1.metrics_json() == tm2.metrics_json(),
          "the obs group's exports differ between two runs")
    check(all(same_bits(out1[t], out2[t]) and same_bits(out1[t], bare[t])
              for t in out1), "the obs group's bits changed")
    check(tr.launches > 0, "the obs group launched no tree_reduce_slots")
    retrans = json.loads(tm1.metrics_json())["tenant.lossy.retransmits"]
    print(f"obs group at ({b}, {s}) on (2, 4): two runs under a counting "
          f"clock export byte-identical trace ({len(tm1.trace_json())} B) "
          f"and metrics ({len(tm1.metrics_json())} B) JSON; bits the same "
          f"without telemetry; the lossy tenant's plan (seed {fplan.seed}) "
          f"retransmits {retrans['value']} packets")
    del xs, out1, out2, bare

    # -- 5. a switch fails under the shared switch's tenants ----------------
    xs = {}
    for name, (b, s), _ in SHARED_TENANTS:
        xs[name] = torch.randn((2, 4, b, s), generator=gen,
                               device="cuda") * 100
    nm = topology.NetworkManager()
    lease = nm.request(8, radix=2)
    mgr = SessionManager(AXES, (2, 4))
    mgr.rebind(lease.tree)

    def reduce_all(names):
        outs = {}
        for name, (b, s), kw in SHARED_TENANTS:
            if name not in names:
                continue
            t = transports.from_config(
                FlareConfig(axes=AXES, transport="innetwork", **kw), mesh,
                torch.float32, manager=mgr, tenant=name)
            outs[name], _ = t(xs[name].clone(), None, torch.zeros(
                b, dtype=torch.int32, device="cuda"), (s,) * b)
        return outs
    zero_counters()
    names = [n for n, _, _ in SHARED_TENANTS]
    before = reduce_all(names)
    epoch = mgr._epoch
    new = Coordinator(8, network=nm).switch_failure(
        lease, lease.tree.levels[1][0], runtime=mgr)
    check(new is not None and mgr.tree is new.tree
          and mgr._epoch == epoch + 1, "the switch failure did not rebind")
    readmitted = sorted(x.tenant for x in mgr.active())
    # the reference's manager re-admits all three at these arenas
    # (tests/test_torch_ft.py::
    # test_switch_failure_drill_at_the_chips_shapes_matches_jax)
    check(readmitted == sorted(names) and mgr.evictions == [],
          f"re-admitted {readmitted}, evicted {mgr.evictions}")
    after = reduce_all(readmitted)
    torch.cuda.synchronize()
    launched["switch failure"] = counters()
    for name in readmitted:
        check(same_bits(before[name], after[name]),
              f"{name}: the reduction changed after the switch failure")
    for k, v in launched["switch failure"].items():
        check(v > 0 or k == "flash_attention",
              f"the switch-failure drill launched no {k}")
    nm2 = topology.NetworkManager()
    lease2 = nm2.request(4, radix=4)
    gone = Coordinator(4, network=nm2).switch_failure(
        lease2, lease2.tree.root.node_id, runtime=mgr)
    check(gone is None and mgr.active() == () and nm2.active() == [],
          "a root without a sibling must drain every session")
    print(f"switch failure under {len(names)} tenants "
          f"({', '.join(f'{n} {bs[0]}x{bs[1]}' for n, bs, _ in SHARED_TENANTS)}"
          f") on a radix-2 lease: leaf switch {lease.tree.levels[1][0]} "
          f"failed, fan-in {lease.tree.radix} -> {new.tree.radix}, all "
          f"re-admitted (epoch {mgr._epoch}), each reduction bitwise as "
          f"before; a root without a sibling drains them all")
    del xs, before, after
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 16 launches {launched}; peak {peak / 2**30:.2f} GiB of "
          f"{total_mem / 2**30:.1f}; phase {time.perf_counter() - t_phase:.1f}"
          f" s ({card})")
    return launched


def phase_health(torch, card, total_mem, seed) -> dict:
    """Phase 17: the fabric health plane (module docstring, item 17).
    Returns the kernels' launches of its reductions."""
    import os
    import tempfile

    from repro_torch.core import transports
    from repro_torch.core.engine import FlareConfig
    from repro_torch.ft import coordinator
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.launch import train as launch
    from repro_torch.mesh import AXES, TWO_LEVEL, RankMesh
    from repro_torch.obs import (HealthMonitor, SLOPolicy, SLORule,
                                 Telemetry, counting_clock, timeline)
    from repro_torch.runtime import CongestionMonitor, SessionManager
    from repro_torch.switch import dataplane
    from repro_torch.switch import packets as pk

    import io

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = RankMesh(TWO_LEVEL, AXES)
    _, (b, s), _ = SHARED_TENANTS[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    xs = torch.randn((*TWO_LEVEL, b, s), generator=gen, device="cuda") * 100
    zeros = torch.zeros(b, dtype=torch.int32, device="cuda")
    counts = dataplane.level_packet_counts([TWO_LEVEL[1], TWO_LEVEL[0]], b,
                                           s, torch.float32)
    plan = find_plan(dataplane, pk, counts, **FABRIC_RATES)
    scheds = [x for x in dataplane.fault_schedules(plan, counts)
              if x is not None]
    drift = (SLORule("congestion_drift", "warning", "replan"),)
    storm = (SLORule("fault_storm", "warning", "recover_session"),)

    def reduce_tenants(mgr, tm):
        outs = {}
        for tenant, kw in (("canary", dict(reproducible=True)),
                           ("lossy", dict(fault_plan=plan))):
            t = transports.from_config(
                FlareConfig(axes=AXES, transport="innetwork", telemetry=tm,
                            **kw), mesh, torch.float32, manager=mgr,
                tenant=tenant)
            outs[tenant], _ = t(xs.clone(), None, zeros, (s,) * b)
        return outs

    def one_run(rules):
        tm = Telemetry.create(clock=counting_clock())
        mgr = SessionManager(AXES, TWO_LEVEL, seed=7, telemetry=tm)
        outs = reduce_tenants(mgr, tm)
        mgr.schedule()
        timeline.manager_tracks(tm.tracer, mgr)
        mon = CongestionMonitor(mgr, registry=tm.registry)
        mon.inject(*HEALTH_HOT)
        hm = HealthMonitor(tm, manager=mgr, monitor=mon,
                           clock=counting_clock())
        pol = SLOPolicy(mgr, monitor=mon, rules=rules) if rules else None
        polls = [hm.watch(1, policy=pol) for _ in range(3)]
        return dict(tm=tm, mgr=mgr, mon=mon, hm=hm, outs=outs, polls=polls)

    tr.launches = 0
    pol = one_run(drift)
    torch.cuda.synchronize()
    launched = {"tree_reduce_slots": tr.launches}
    check(tr.launches > 0, "the health phase's reductions launched no "
          "tree_reduce_slots")
    (raised1, taken1), *later = pol["polls"]
    storms = [i for i in raised1 if i.detector == "fault_storm"]
    check(len(storms) == 1 and storms[0].tenant == "lossy",
          f"poll 1 raised {[(i.detector, i.tenant) for i in raised1]}")
    ev = dict(storms[0].evidence)
    sums = {"retransmits": sum(x.retransmits for x in scheds),
            "retry_rounds": sum(max(0, x.rounds - 1) for x in scheds),
            "duplicates": sum(x.duplicates for x in scheds),
            "corrupt_rejected": sum(x.corrupt_rejected for x in scheds)}
    for k, v in sums.items():
        got = ev[f"tenant.lossy.{k}"]
        check(got == v and int(got) == v, f"fault_storm evidence {k} {got} "
              f"!= the static schedules' {v}")
    drifts = [i for i in raised1 if i.detector == "congestion_drift"]
    check(len(drifts) == 1 and [r.action for r in taken1] == ["replan"]
          and taken1[0].applied, f"poll 1: drift {drifts}, taken {taken1}")
    for raised, taken in later:
        check([i.detector for i in raised] == ["fault_storm"] and taken == (),
              f"a later poll raised {[i.detector for i in raised]} and took "
              f"{taken}")
    # the manual twin: the same run without a policy, then the manual call
    man = one_run(None)
    res_man = man["mgr"].replan(man["mon"], threshold=0.5, hysteresis=0.05)
    res_pol = taken1[0].result
    check((res_pol.replanned, res_pol.reason, res_pol.improvement_x)
          == (res_man.replanned, res_man.reason, res_man.improvement_x)
          and pol["mgr"].tree.nodes == man["mgr"].tree.nodes
          and pol["mgr"]._epoch == man["mgr"]._epoch
          and [x.tenant for x in pol["mgr"].active()]
          == [x.tenant for x in man["mgr"].active()],
          f"the policy's replan {res_pol} != the manual {res_man}")
    after_pol = reduce_tenants(pol["mgr"], pol["tm"])
    after_man = reduce_tenants(man["mgr"], man["tm"])
    for t in after_pol:
        check(same_bits(pol["outs"][t], man["outs"][t]),
              f"{t}: the two runs' first reductions differ")
        check(same_bits(after_pol[t], after_man[t]),
              f"{t}: the policy's and the manual replan's next reductions "
              "differ")
    check(same_bits(after_pol["canary"], pol["outs"]["canary"]),
          "the canary's bits changed across the replan")
    # determinism and the mirrors
    again = one_run(drift)
    check(again["hm"].incidents_json() == pol["hm"].incidents_json(),
          "two watched runs export different incident logs")
    reg = pol["tm"].registry
    by_sev = {}
    for i in pol["hm"].incidents:
        by_sev[i.severity] = by_sev.get(i.severity, 0) + 1
    instants = [e for e in pol["tm"].tracer.events
                if e["name"] == "health.incident"]
    check(all(reg.value(f"health.incidents.{k}") == v
              for k, v in by_sev.items())
          and len(instants) == len(pol["hm"].incidents)
          and all(e["track"] == "health" for e in instants),
          "the incident mirrors disagree with the log")
    # recover_session: the lossy tenant drains, as the manual recovery does
    rec = one_run(storm)
    rec_man = one_run(None)
    check(coordinator.recover_session_failure(rec_man["mgr"], "lossy"),
          "the manual recovery drained nothing")
    (_, rtaken), *_ = rec["polls"]
    check([(r.action, r.applied) for r in rtaken] == [
        ("recover_session", True)], f"recover_session took {rtaken}")
    check([x.tenant for x in rec["mgr"].active()] == ["canary"]
          == [x.tenant for x in rec_man["mgr"].active()],
          "recover_session left other sessions than the manual recovery")
    a_rec = reduce_tenants(rec["mgr"], rec["tm"])
    a_man = reduce_tenants(rec_man["mgr"], rec_man["tm"])
    for t in a_rec:
        check(same_bits(a_rec[t], a_man[t]), f"{t}: after recover_session "
              "the reduction differs from the manually recovered twin's")
    torch.cuda.synchronize()
    launched["tree_reduce_slots"] = tr.launches
    # the host cost of one poll (a live monitor observes first)
    hm = HealthMonitor(pol["tm"], manager=pol["mgr"], monitor=pol["mon"],
                       clock=counting_clock())
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        hm.poll()
    poll_us = (time.perf_counter() - t0) / n * 1e6
    print(f"health plane at ({b}, {s}) on (2, 4): plan seed {plan.seed} "
          f"({FABRIC_RATES}); poll 1 raised "
          f"{[(i.detector, i.severity, i.tenant) for i in raised1]}, "
          f"evidence {sums} == the static schedules' sums; the policy's "
          f"replan (replanned={res_pol.replanned}, reason "
          f"{res_pol.reason!r}, improvement {res_pol.improvement_x:.3f}) "
          f"== the manual twin's, each tenant's next reduction bitwise the "
          f"twin's, the canary's bitwise its first; polls 2-3 quiet; "
          f"recover_session drains the lossy tenant bitwise as the manual "
          f"recovery; two runs' incident logs byte-identical "
          f"({len(pol['hm'].incidents_json())} B); mirrors agree; one poll "
          f"{poll_us:.1f} us on the host (mean of {n}, {card})")
    del xs, pol, man, again, rec, rec_man, after_pol, after_man, a_rec, a_man
    torch.cuda.empty_cache()

    # the launcher's health pass, before its artifacts
    tmp = tempfile.mkdtemp(prefix="chip_smoke_health_")
    try:
        path = os.path.join(tmp, "incidents.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = launch.main([*TENANT_FLAGS, "--steps", "1",
                                  "--health-policy", "auto",
                                  "--incidents-out", path],
                                 n_layers=HEALTH_LAYERS)
        out = buf.getvalue()
        check(all(math.isfinite(x) for row in losses for x in row),
              f"launcher losses {losses}")
        check("== health ==" in out and f"incidents -> {path}" in out,
              "the launcher printed no health pass")
        log = json.loads(open(path).read())
        worst = max((["info", "warning", "critical"].index(r["severity"])
                     for r in log), default=-1)
        env = dict(os.environ, PYTHONPATH=str(SRC))
        rep = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                              "--incidents", path, "--fail-on", "critical"],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        check("== incidents ==" in rep.stdout,
              f"the report CLI did not render the log: {rep.stderr[-300:]}")
        check(rep.returncode == (1 if worst >= 2 else 0),
              f"--fail-on critical exited {rep.returncode} for a log whose "
              f"worst severity is {worst}")
        health_out = out[out.index("== health =="):].strip()
        print(f"launcher ({' '.join(TENANT_FLAGS)} --steps 1 --health-policy "
              f"auto, {HEALTH_LAYERS} layers): {len(log)} incidents; the "
              f"report CLI exits {rep.returncode} under --fail-on critical; "
              f"its health pass:\n{health_out}")
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    torch.cuda.empty_cache()
    print(f"phase 17 launches {launched}; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return launched


def phase_serve(torch, card, total_mem, seed) -> None:
    """Phase 18: serving TinyLlama-1.1B (module docstring, item 18)."""
    from repro_torch import tree
    from repro_torch.configs import tinyllama_1_1b as tl
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tl.CONFIG

    # -- (a) the main path: launch.serve at the reference's defaults --------
    served_at_defaults(torch, card, "tinyllama-1.1b", seed)

    # -- (b) at scale: prefill, a grown cache, lockstep decode --------------
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    params = tree.map_leaves(lambda t: t.to(cfg.dtype), model.init(gen))
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    serve_at_scale(torch, card, total_mem, model, params, prompts,
                   SERVE_CACHE, SERVE_STEPS, "serving at scale")
    del params, prompts
    torch.cuda.empty_cache()

    print(f"phase 18: phase {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_gemma_serve(torch, card, total_mem, seed) -> dict:
    """Phase 20: serving gemma2-2b at all 26 layers (module docstring,
    item 20)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = gemma2_2b.CONFIG

    # -- (a) launch.serve --arch gemma2-2b at the reference's defaults -------
    served_at_defaults(torch, card, "gemma2-2b", seed)

    # -- (b) prompts past the window, decode past them ----------------------
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    params = rules.cast_params(model.init(gen), cfg.dtype)
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (GEMMA_SERVE_B,
                                           GEMMA_SERVE_PROMPT),
                            generator=gen, device="cuda")
    got = serve_at_scale(torch, card, total_mem, model, params, prompts,
                         GEMMA_SERVE_CACHE, GEMMA_SERVE_STEPS,
                         "gemma2-2b serving")
    # the local layers' window hid keys: opening it moves the logits by
    # more than the kernel-vs-plain tolerance, so that comparison would
    # catch a kernel that ignored the window
    with torch.inference_mode():
        opened, _ = get_model(cfg.scaled(window=0)).prefill(
            params, {"tokens": prompts})
    scale = float(got["logits"][0].abs().max())
    moved = float((opened[:, -1].float() - got["logits"][0]).abs().max())
    check(moved > SERVE_LOGIT_TOL * scale, f"gemma2-2b: opening the window "
          f"moves the logits by {moved}, within {SERVE_LOGIT_TOL} of {scale}")
    print(f"gemma2-2b: opening the local layers' window moves the last "
          f"prefill logits by up to {moved:.3f}, {moved / scale:.3e} of "
          f"max|logit| {scale:.3f} (the kernel-vs-plain tolerance is "
          f"{SERVE_LOGIT_TOL}; the kernel run's own worst {got['worst']:.3e})")
    del params, prompts, opened, got["logits"]
    torch.cuda.empty_cache()
    print(f"phase 20: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def layerwise_params(model, gen) -> dict:
    """The model's parameters in its compute dtype (``KEEP_F32`` leaves in
    fp32), drawn one layer at a time into the stacks (``launch.serve``'s
    draw): the fp32 draw of the whole stack would not fit beside them."""
    from repro_torch.sharding import rules
    return model.init(gen, cast=lambda t: rules.cast_params(
        t, model.cfg.dtype))


def phase_qwen_serve(torch, card, total_mem, seed) -> dict:
    """Phase 21: serving qwen3-moe-235b-a22b at published widths
    (module docstring, item 21)."""
    from repro_torch import tree
    from repro_torch.configs import qwen3_moe_235b_a22b as qwen
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.registry import get_model
    from repro_torch.serve import BatchedServer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = qwen.CONFIG.scaled(n_layers=QWEN_SERVE_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    t0 = time.perf_counter()
    params = layerwise_params(model, gen)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    print(f"qwen3-moe-235b-a22b at published widths, {cfg.n_layers} of 94 "
          f"layers: {nbytes / 1e9:.2f} GB of bf16 parameters (router fp32), "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (QWEN_SERVE_B, QWEN_SERVE_PROMPT),
                            generator=gen, device="cuda")
    got = serve_at_scale(torch, card, total_mem, model, params, prompts,
                         QWEN_SERVE_CACHE, QWEN_SERVE_STEPS,
                         "qwen3 serving (gather combine)")
    # the scatter_ar combine, teacher-forced on the gather run's tokens
    # and expert choices
    ar = serve_at_scale(torch, card, total_mem,
                        get_model(cfg.scaled(moe_combine="scatter_ar")),
                        params, prompts, QWEN_SERVE_CACHE, QWEN_SERVE_STEPS,
                        "qwen3 serving (scatter_ar combine)",
                        feed=got["toks"], routes=got["routes"])
    worst, near, mism = compare_logits(ar["logits"], got["logits"])
    check(worst <= SERVE_LOGIT_TOL and mism == 0,
          f"qwen3: scatter_ar vs gather logits {worst}, {mism} tokens "
          "differ outside a near tie")
    print(f"qwen3 combines: scatter_ar's logits within {worst:.3e} of "
          f"max|logit| of gather's (tolerance {SERVE_LOGIT_TOL}), greedy "
          f"tokens equal outside {near} near ties")
    # the slot server on the same model
    srv = BatchedServer(model, params, slots=SERVER_SLOTS,
                        max_len=SERVER_MAX_LEN)
    rng = torch.Generator().manual_seed(seed)
    reqs = [srv.submit(torch.randint(0, cfg.vocab, (n,),
                                     generator=rng).numpy(), max_new=8)
            for n in (3, 5, 2, 7)]
    fa.launches = fa.decode_launches = 0
    with path_flash("phase 21 BatchedServer"):
        steps = srv.run()
    torch.cuda.synchronize()
    check(all(r.done and len(r.out) == 8 for r in reqs)
          and fa.launches > 0 and fa.launches % cfg.n_layers == 0,
          f"qwen3 BatchedServer: {fa.launches} flash launches")
    print(f"qwen3 BatchedServer: 4 requests of 8 tokens in {steps} steps, "
          f"flash launches {fa.launches} ({cfg.n_layers} a decode call, "
          f"{fa.decode_launches} on the decode kernel)")
    del params, prompts, srv, got["logits"], got["routes"], ar
    torch.cuda.empty_cache()
    print(f"phase 21: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def served_at_defaults(torch, card, arch: str, seed: int) -> None:
    """``launch.serve --arch ARCH`` at the reference's defaults (8
    requests, ``SERVER_SLOTS`` slots, ``max_len`` ``SERVER_MAX_LEN``,
    ``max_new`` 16), the flash counter set to 0 just before and read just
    after: ``flash_per_call(cfg, "decode")`` launches a decode call, all
    on the decode kernel, each launch's shape recorded (``path_flash``)."""
    import io

    from repro_torch import configs
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry

    cfg = configs.load(arch).CONFIG
    family = registry._FAMILIES[cfg.family]
    per_call = flash_per_call(cfg, "decode")
    calls = []
    real_decode = family.decode_step

    def counting_decode(*a, **k):
        calls.append(1)
        return real_decode(*a, **k)
    buf = io.StringIO()
    fa.launches = fa.decode_launches = 0
    with mock.patch.object(family, "decode_step", counting_decode), \
            contextlib.redirect_stdout(buf), \
            (path_flash(f"launch.serve --arch {arch}") if per_call
             else contextlib.nullcontext()):
        reqs = launch_serve.main(["--arch", arch, "--seed", str(seed)])
    torch.cuda.synchronize()
    served = (fa.launches, fa.decode_launches)
    print(buf.getvalue(), end="")
    check(served[0] == served[1] == per_call * len(calls) and calls,
          f"launch.serve --arch {arch}: flash launches {served} for "
          f"{len(calls)} decode calls of {per_call}")
    check(len(reqs) == 8 and all(r.done and len(r.out) == 16 for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          f"launch.serve --arch {arch} did not finish its requests")
    print(f"launch.serve --arch {arch} ({cfg.n_layers} layers, bf16, "
          f"{card}): {len(calls)} decode calls, flash launches {served[0]} "
          f"({served[1]} on the decode kernel) = {per_call} a call")
    del reqs
    torch.cuda.empty_cache()


def compare_logits(got: list, want: list) -> tuple[float, int, int]:
    """Step logits ``got`` against ``want``: the worst error as a share of
    each step's max|logit|, the near ties of ``want`` (top two within
    ``SERVE_LOGIT_TOL`` of it) and the greedy tokens that differ outside
    them."""
    worst, near, mism = 0.0, 0, 0
    for lg, lw in zip(got, want):
        scale = float(lw.abs().max())
        worst = max(worst, float((lg - lw).abs().max()) / scale)
        top2 = lw.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= SERVE_LOGIT_TOL * scale
        near += int(tie.sum())
        mism += int(((lg.argmax(-1) != lw.argmax(-1)) & ~tie).sum())
    return worst, near, mism


def phase_deepseek_serve(torch, card, total_mem, seed) -> dict:
    """Phase 23: deepseek-v2-lite served at all 27 layers (module
    docstring, item 23)."""
    from repro_torch import tree
    from repro_torch.configs import deepseek_v2_lite_16b as ds
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models import base
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = ds.CONFIG
    served_at_defaults(torch, card, "deepseek-v2-lite-16b", seed)

    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    t0 = time.perf_counter()
    params = layerwise_params(model, gen)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    print(f"deepseek-v2-lite-16b at published widths and all {cfg.n_layers} "
          f"layers: {nbytes / 1e9:.2f} GB of bf16 parameters (router fp32), "
          f"drawn a layer at a time in {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab, (DS_SERVE_B, DS_SERVE_PROMPT),
                            generator=gen, device="cuda")
    got = serve_at_scale(torch, card, total_mem, model, params, prompts,
                         DS_SERVE_CACHE, DS_SERVE_STEPS,
                         "deepseek-v2-lite serving (expanded MLA)")

    # -- the absorbed decode against the expanded one on the same cache:
    # each step from one cache state, the absorbed step on a copy of it,
    # both fed the kernel run's token and forced on its expert choices
    absorbed = get_model(cfg.scaled(mla_absorbed=True))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    routes = got["routes"]
    replay = routes[:n_moe]
    for i in range(DS_SERVE_STEPS):
        step = routes[(i + 1) * n_moe:(i + 2) * n_moe]
        replay = replay + step + step
    abs_logits, exp_logits, abs_ms, exp_ms, flips = [], [], [], [], [0, 0]

    def timed_step(m, tok, cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.decode(params, tok, cache)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    with torch.inference_mode(), routing(base, [], replay, flips):
        _, cache = model.prefill(params, {"tokens": prompts})
        pad = DS_SERVE_CACHE - DS_SERVE_PROMPT
        for name in ("dense", "moe"):
            cache[name] = {k: torch.cat([v, v.new_zeros(
                v.shape[:2] + (pad,) + v.shape[3:])], 2)
                for k, v in cache[name].items()}
        for i in range(DS_SERVE_STEPS):
            tok = got["toks"][i][:, None]
            twin = {k: ({n: t.clone() for n, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in cache.items()}
            before = fa.launches
            (la, _), ms = timed_step(absorbed, tok, twin)
            check(fa.launches == before, "an absorbed step launched flash")
            abs_ms.append(ms)
            (le, cache), ms = timed_step(model, tok, cache)
            exp_ms.append(ms)
            abs_logits.append(la[:, -1].float())
            exp_logits.append(le[:, -1].float())
            del twin
    abs_steps = [compare_logits([a], [e])[0]
                 for a, e in zip(abs_logits, exp_logits)]
    worst, near, mism = compare_logits(abs_logits, exp_logits)
    check(worst <= MLA_ABSORBED_TOL and mism == 0,
          f"deepseek absorbed vs expanded decode: logits {worst}, {mism} "
          "tokens differ outside a near tie")
    abs_med, exp_med = statistics.median(abs_ms), statistics.median(exp_ms)
    print(f"deepseek-v2-lite decode, absorbed MLA (latent-space fp32 "
          f"products over the compressed cache, no flash) vs expanded, "
          f"{DS_SERVE_STEPS} steps each from the same cache, fed the kernel "
          f"run's tokens and forced on its expert choices: logits within "
          f"{worst:.3e} of max|logit| (tolerance {MLA_ABSORBED_TOL:.4f}), "
          f"greedy "
          f"tokens equal outside {near} near ties; decode step ms (median, "
          f"{card}) absorbed {abs_med:.2f} vs expanded {exp_med:.2f} (whose "
          f"steps re-expand all {DS_SERVE_CACHE} cache rows of every "
          f"layer); per step {min(abs_steps):.3e} to {max(abs_steps):.3e}, "
          f"median {statistics.median(abs_steps):.3e}")

    # -- the fp32 witness: the same steps in fp32 from the final cache
    probe = params["layers"]["attn"]["w_dkv"][-1].clone()
    del params, prompts, replay, got["logits"]
    torch.cuda.empty_cache()
    witness = mla_fp32_witness(torch, card, cfg, seed + 23, cache,
                               got["toks"], routes[n_moe:], abs_logits,
                               exp_logits, probe)
    del cache, abs_logits, exp_logits, routes, got["routes"], probe
    torch.cuda.empty_cache()
    print(f"phase 23: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(got, absorbed_ms=abs_med, expanded_ms=exp_med, **witness)


def mla_fp32_witness(torch, card, cfg, seed, cache, toks, routes,
                     abs_logits, exp_logits, probe) -> dict:
    """Phase 23's witness for ``MLA_ABSORBED_TOL``: the decode steps the
    bf16 absorbed and expanded decodes took, each from the same cache,
    taken again in fp32 by both decodes, on the bf16 run's weights
    (``seed``'s draw, rounded to bf16 and held in fp32: one draw order, so
    ``probe``, a bf16 leaf of that run, must come out equal) and its
    final cache upcast (exact; step ``i`` writes its own row at ``pos`` and
    attends over the rows below it), with the plain attention (the fp32
    kernel takes no ``(192, 128)``), forced on the bf16 run's tokens and
    expert choices.  The fp32 decodes must agree within ``MLA_FP32_TOL``,
    and each bf16 decode must lie within ``SERVE_LOGIT_TOL`` of the fp32
    expanded one, tokens equal outside its near ties.  Returns the worst
    errors."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops
    from repro_torch.models import base
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = cfg.scaled(dtype=torch.float32)
    expanded = get_model(cfg32)
    absorbed = get_model(cfg32.scaled(mla_absorbed=True))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = expanded.init(gen, cast=lambda t: tree.map_leaves(
        lambda x: x.float(), rules.cast_params(t, torch.bfloat16)))
    check(torch.equal(params["layers"]["attn"]["w_dkv"][-1],
                      probe.float()),
          "the fp32 witness's weights are not the bf16 run's")
    names = sorted(set(cache) - {"pos"})
    cache32 = {n: {k: t.float() for k, t in cache[n].items()}
               for n in names}
    n_moe = cfg.n_layers - cfg.first_dense_layers
    replay = []
    for i in range(len(toks)):
        step = routes[i * n_moe:(i + 1) * n_moe]
        replay = replay + step + step
    f_exp, f_abs, flips = [], [], [0, 0]
    before = fa.launches
    with torch.inference_mode(), routing(base, [], replay, flips), \
            mock.patch.object(ops, "attention", plain_attention):
        for i, tok in enumerate(toks):
            for m, out in ((expanded, f_exp), (absorbed, f_abs)):
                twin = {n: {k: t.clone() for k, t in cache32[n].items()}
                        for n in names}
                twin["pos"] = DS_SERVE_PROMPT + i
                lg, _ = m.decode(params, tok[:, None], twin)
                out.append(lg[:, -1].float())
                del twin, lg
    torch.cuda.synchronize()
    check(fa.launches == before, "the fp32 witness launched the kernel")
    peak = torch.cuda.max_memory_allocated()
    del params, cache32
    torch.cuda.empty_cache()

    def steps(got):
        return [compare_logits([g], [w])[0] for g, w in zip(got, f_exp)]
    same, _, mism = compare_logits(f_abs, f_exp)
    check(same <= MLA_FP32_TOL and mism == 0, f"deepseek fp32 absorbed vs "
          f"expanded decode: logits {same}, {mism} tokens differ outside a "
          "near tie")
    e_exp, near, mism_e = compare_logits(exp_logits, f_exp)
    e_abs, _, mism_a = compare_logits(abs_logits, f_exp)
    check(e_exp <= SERVE_LOGIT_TOL and e_abs <= SERVE_LOGIT_TOL
          and mism_e == mism_a == 0, f"deepseek bf16 decodes vs fp32: "
          f"expanded {e_exp} ({mism_e} tokens), absorbed {e_abs} ({mism_a} "
          f"tokens), beyond {SERVE_LOGIT_TOL}")
    se, sa = steps(exp_logits), steps(abs_logits)
    print(f"deepseek-v2-lite fp32 witness ({len(toks)} steps of "
          f"{toks[0].shape[0]} rows, {cfg.n_layers} layers, the bf16 run's "
          f"weights and cache in fp32, plain attention, forced on its "
          f"tokens and expert choices; {card}): fp32 absorbed vs fp32 "
          f"expanded within {same:.3e} of max|logit| (tolerance "
          f"{MLA_FP32_TOL}); against the fp32 expanded decode, bf16 "
          f"expanded within {e_exp:.3e} (per step median "
          f"{statistics.median(se):.3e}, max {max(se):.3e}) and bf16 "
          f"absorbed within {e_abs:.3e} (median "
          f"{statistics.median(sa):.3e}, max {max(sa):.3e}) (tolerance "
          f"{SERVE_LOGIT_TOL}), greedy tokens equal outside {near} fp32 "
          f"near ties; hypot of the two {math.hypot(e_exp, e_abs):.3e}; "
          f"the fp32 run's own expert choices would differ in {flips[0]} "
          f"of {flips[1]} router rows; peak {peak / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(fp32_same=same, fp32_exp=e_exp, fp32_abs=e_abs)


def phase_vlm_serve(torch, card, total_mem, seed) -> dict:
    """Phase 24: llama-3.2-vision served at published widths, cut to
    ``VLM_SERVE_GROUPS`` groups (module docstring, item 24)."""
    from repro_torch import tree
    from repro_torch.configs import llama32_vision_90b as vlm
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.registry import get_model
    from repro_torch.serve import BatchedServer

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = vlm.CONFIG.scaled(
        n_layers=VLM_SERVE_GROUPS * vlm.CONFIG.cross_attn_every)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 24)
    t0 = time.perf_counter()
    params = layerwise_params(model, gen)
    # the tanh gates, 0 at init (where the cross layers add nothing),
    # drawn from the seed in [0.3, 1)
    cross = params["cross_layers"]
    for k in ("gate_attn", "gate_mlp"):
        cross[k] = (0.3 + 0.7 * torch.rand(cross[k].shape, generator=gen,
                                           device="cuda")).to(cfg.dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    print(f"llama-3.2-vision-90b at published widths, {VLM_SERVE_GROUPS} "
          f"of 20 groups ({cfg.n_layers} of 100 layers: "
          f"{params['layers']['ln1'].shape[0]} self, "
          f"{cross['ln1'].shape[0]} cross): {nbytes / 1e9:.2f} GB of bf16 "
          f"parameters, drawn a layer at a time in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = next(pipeline.synthetic_batches(
        cfg, VLM_SERVE_B, VLM_SERVE_PROMPT, seed=seed, train=False,
        device="cuda", prefetch=False))
    ve = batch["vision_embeds"]
    check(ve.dtype == torch.float32 and ve.shape == (
        VLM_SERVE_B, cfg.vision_tokens, cfg.d_model),
        f"vision_embeds {ve.dtype} {tuple(ve.shape)}")
    got = serve_at_scale(torch, card, total_mem, model, params,
                         batch["tokens"], VLM_SERVE_CACHE, VLM_SERVE_STEPS,
                         "llama-3.2-vision serving", extra={
                             "vision_embeds": ve},
                         fp32_launches=VLM_SERVE_GROUPS)
    # the cross layers matter: with their gates closed the last prefill
    # logits move by more than the kernel-vs-plain tolerance
    shut = dict(params, cross_layers=dict(cross, **{
        k: torch.zeros_like(cross[k]) for k in ("gate_attn", "gate_mlp")}))
    with torch.inference_mode():
        closed, _ = model.prefill(shut, batch)
    scale = float(got["logits"][0].abs().max())
    moved = float((closed[:, -1].float() - got["logits"][0]).abs().max())
    check(moved > SERVE_LOGIT_TOL * scale, f"vlm: closing the gates moves "
          f"the logits by {moved}, within {SERVE_LOGIT_TOL} of {scale}")
    print(f"llama-3.2-vision: closing the cross layers' gates moves the last "
          f"prefill logits by up to {moved:.3f}, {moved / scale:.3e} of "
          f"max|logit| {scale:.3f} (the kernel-vs-plain tolerance is "
          f"{SERVE_LOGIT_TOL})")
    del shut, closed, got["logits"], batch, ve
    torch.cuda.empty_cache()

    # the slot server against the zero cross cache (it passes no vision
    # embeddings, as the reference's does)
    srv = BatchedServer(model, params, slots=SERVER_SLOTS,
                        max_len=SERVER_MAX_LEN)
    rng = torch.Generator().manual_seed(seed)
    reqs = [srv.submit(torch.randint(0, cfg.vocab, (n,),
                                     generator=rng).numpy(), max_new=8)
            for n in (3, 5, 2, 7)]
    fa.launches = fa.decode_launches = 0
    with path_flash("phase 24 BatchedServer"):
        steps = srv.run()
    torch.cuda.synchronize()
    check(all(r.done and len(r.out) == 8 for r in reqs)
          and fa.launches > 0 and fa.launches % cfg.n_layers == 0
          and fa.decode_launches == fa.launches
          and not any(t.any() for t in srv.cache["cross"].values()),
          f"vlm BatchedServer: {fa.launches} flash launches "
          f"({fa.decode_launches} on the decode kernel)")
    print(f"llama-3.2-vision BatchedServer: 4 requests of 8 tokens in {steps} "
          f"steps against the zero cross cache, flash launches "
          f"{fa.launches} ({cfg.n_layers} a decode call, all "
          f"{fa.decode_launches} on the decode kernel)")
    del params, srv, cross
    torch.cuda.empty_cache()
    print(f"phase 24: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def phase_whisper_serve(torch, card, total_mem, seed) -> dict:
    """Phase 26: whisper-medium served at all 24 + 24 layers (module
    docstring, item 26)."""
    from repro_torch import tree
    from repro_torch.configs import whisper_medium as wsp
    from repro_torch.data import pipeline
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = wsp.CONFIG
    served_at_defaults(torch, card, "whisper-medium", seed)

    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 26)
    t0 = time.perf_counter()
    params = layerwise_params(model, gen)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    print(f"whisper-medium at published widths and all {cfg.encoder_layers}"
          f" + {cfg.n_layers} layers: {nbytes / 1e9:.2f} GB of bf16 "
          f"parameters, drawn a layer at a time in "
          f"{time.perf_counter() - t0:.1f} s")
    stream = pipeline.synthetic_batches(
        cfg, WSP_SERVE_B, WSP_SERVE_PROMPT, seed=seed, train=False,
        device="cuda", prefetch=False)
    batch = next(stream)
    frames = batch["enc_frames"]
    check(frames.dtype == torch.float32 and frames.shape == (
        WSP_SERVE_B, cfg.encoder_tokens, cfg.d_model),
        f"enc_frames {frames.dtype} {tuple(frames.shape)}")
    got = serve_at_scale(torch, card, total_mem, model, params,
                         batch["tokens"], WSP_SERVE_CACHE, WSP_SERVE_STEPS,
                         "whisper-medium serving",
                         extra={"enc_frames": frames},
                         grown={"dec": ("k", "v")})
    # the cross-attention reads the frames: other frames (the stream's
    # next draw) move the last prefill logits by more than the
    # kernel-vs-plain tolerance
    other = next(stream)["enc_frames"]
    with torch.inference_mode():
        moved_logits, _ = model.prefill(params, {"tokens": batch["tokens"],
                                                 "enc_frames": other})
    scale = float(got["logits"][0].abs().max())
    moved = float((moved_logits[:, -1].float() - got["logits"][0]).abs().max())
    check(moved > SERVE_LOGIT_TOL * scale, f"whisper: other frames move the "
          f"logits by {moved}, within {SERVE_LOGIT_TOL} of {scale}")
    print(f"whisper-medium: other frames move the last prefill logits by up "
          f"to {moved:.3f}, {moved / scale:.3e} of max|logit| {scale:.3f} "
          f"(the kernel-vs-plain tolerance is {SERVE_LOGIT_TOL}; the kernel "
          f"run's own worst {got['worst']:.3e})")
    del params, batch, frames, other, moved_logits, got["logits"]
    torch.cuda.empty_cache()
    print(f"phase 26: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def phase_mamba_serve(torch, card, total_mem, seed) -> dict:
    """Phase 28: mamba2-370m served at all 48 layers (module docstring,
    item 28)."""
    from repro_torch import tree
    from repro_torch.configs import mamba2_370m as mamba
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    served_at_defaults(torch, card, "mamba2-370m", seed)

    # -- (b) fp32: the chunked prefill against the recurrent feed -----------
    cfg = mamba.CONFIG.scaled(dtype=torch.float32,
                              n_layers=MAMBA_FEED_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab, (MAMBA_FEED_B, MAMBA_FEED_PROMPT),
                         generator=gen, device="cuda")
    check(MAMBA_FEED_PROMPT % cfg.ssm_chunk == 0, "the prompt is not whole "
          "chunks")
    fa.launches = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked, cp = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        cache = model.init_cache(MAMBA_FEED_B, 0, device="cuda")
        t0 = time.perf_counter()
        for t in range(MAMBA_FEED_PROMPT):
            fed, cache = model.decode(params, toks[:, t:t + 1], cache)
        torch.cuda.synchronize()
        feed_ms = (time.perf_counter() - t0) * 1e3
    rel = float((chunked[:, -1] - fed[:, -1]).abs().max()
                / chunked.abs().max())
    srel = max(float((cache["layers"][k] - cp["layers"][k]).abs().max()
                     / cp["layers"][k].abs().max()) for k in cp["layers"])
    check(fa.launches == 0, f"mamba2 launched flash {fa.launches} times")
    check(cp["pos"] == cache["pos"] == MAMBA_FEED_PROMPT,
          f"mamba2 positions {cp['pos']} {cache['pos']}")
    check(rel <= MAMBA_FEED_TOL, f"mamba2 chunked vs recurrent: {rel}")
    state = sum(t[:, 0].numel() * t.element_size()
                for t in cache["layers"].values())
    print(f"mamba2-370m fp32 at published widths, {cfg.n_layers} of "
          f"{mamba.CONFIG.n_layers} layers: chunked prefill "
          f"of {MAMBA_FEED_B} x {MAMBA_FEED_PROMPT} ({pre_ms:.1f} ms) against "
          f"the same tokens fed one at a time through decode_step "
          f"({MAMBA_FEED_PROMPT} recurrent steps, {feed_ms:.0f} ms): last "
          f"logits within {rel:.3e} of max|logit| (tolerance "
          f"{MAMBA_FEED_TOL}), states within {srel:.3e} of their largest; "
          f"decode state {state // cfg.n_layers} bytes a layer a sequence "
          f"in fp32, whatever its length  [{card}]")
    del params, toks, chunked, cp, cache, fed
    torch.cuda.empty_cache()

    # -- (c) bf16 at a batch of 16: prefill and lockstep decode -------------
    cfg = mamba.CONFIG
    model = get_model(cfg)
    params = layerwise_params(model, gen)
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    state = sum(t[:, 0].numel() * t.element_size() for t in
                model.init_cache(1, 0, device="meta")["layers"].values())
    print(f"mamba2-370m bf16 at all {cfg.n_layers} layers: {nbytes / 1e9:.3f}"
          f" GB of parameters (A_log, D and dt_bias fp32); decode state "
          f"{state} bytes a sequence (conv windows bf16, SSM state fp32)")
    prompts = torch.randint(0, cfg.vocab, (MAMBA_SERVE_B,
                                           MAMBA_SERVE_PROMPT),
                            generator=gen, device="cuda")
    got = serve_at_scale(torch, card, total_mem, model, params, prompts,
                         MAMBA_SERVE_PROMPT, MAMBA_SERVE_STEPS,
                         "mamba2-370m serving", grown={})
    del params, prompts, got["logits"]
    torch.cuda.empty_cache()
    print(f"phase 28: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def phase_zamba_serve(torch, card, total_mem, seed) -> dict:
    """Phase 30: zamba2-1.2b served (module docstring, item 30)."""
    from repro_torch import tree
    from repro_torch.configs import zamba2_1_2b as zamba
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    served_at_defaults(torch, card, "zamba2-1.2b", seed)

    # -- (b) fp32: the chunked prefill against the recurrent feed -----------
    cfg = zamba.CONFIG.scaled(dtype=torch.float32,
                              n_layers=ZAMBA_FEED_LAYERS)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab, (ZAMBA_FEED_B, ZAMBA_FEED_PROMPT),
                         generator=gen, device="cuda")
    check(ZAMBA_FEED_PROMPT % cfg.ssm_chunk == 0, "the prompt is not whole "
          "chunks")
    groups = flash_per_call(cfg, "decode")
    fa.launches = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked, cp = model.prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        pre_launches = fa.launches
        cache = model.init_cache(ZAMBA_FEED_B, ZAMBA_FEED_PROMPT,
                                 device="cuda")
        cache["pos"] = 0
        t0 = time.perf_counter()
        for t in range(ZAMBA_FEED_PROMPT):
            fed, cache = model.decode(params, toks[:, t:t + 1], cache)
        torch.cuda.synchronize()
        feed_ms = (time.perf_counter() - t0) * 1e3
    rel = float((chunked[:, -1] - fed[:, -1]).abs().max()
                / chunked.abs().max())
    srel = max(float((cache["mamba"][k] - cp["mamba"][k]).abs().max()
                     / cp["mamba"][k].abs().max()) for k in cp["mamba"])
    krel = max(float((cache["attn"][k] - cp["attn"][k]).abs().max()
                     / cp["attn"][k].abs().max()) for k in cp["attn"])
    check(pre_launches == groups and fa.launches == groups * (
        ZAMBA_FEED_PROMPT + 1), f"zamba2 flash launches {pre_launches}, "
        f"{fa.launches}: want {groups} a call")
    check(cp["pos"] == cache["pos"] == ZAMBA_FEED_PROMPT,
          f"zamba2 positions {cp['pos']} {cache['pos']}")
    check(rel <= ZAMBA_FEED_TOL, f"zamba2 chunked vs recurrent: {rel}")
    print(f"zamba2-1.2b fp32 at published widths, {cfg.n_layers} of "
          f"{zamba.CONFIG.n_layers} layers ({groups} groups): chunked "
          f"prefill of {ZAMBA_FEED_B} x {ZAMBA_FEED_PROMPT} ({pre_ms:.1f} ms)"
          f" against the same tokens fed one at a time through decode_step "
          f"({ZAMBA_FEED_PROMPT} recurrent steps, {feed_ms:.0f} ms): last "
          f"logits within {rel:.3e} of max|logit| (tolerance "
          f"{ZAMBA_FEED_TOL}), mamba states within {srel:.3e} and the shared"
          f" block's K/V within {krel:.3e} of their largest; flash "
          f"{groups} launches a call (fp32, three TF32 products on the "
          f"tensor cores)  [{card}]")
    del params, toks, chunked, cp, cache, fed
    torch.cuda.empty_cache()

    # -- (c) bf16 at all 38 layers: prefill and lockstep decode ------------
    cfg = zamba.CONFIG
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    params = layerwise_params(model, gen)
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.flatten(params)[0])
    meta = model.init_cache(1, ZAMBA_SERVE_CACHE, device="meta")
    state = sum(t[:, 0].numel() * t.element_size()
                for t in meta["mamba"].values())
    kv = sum(t[:, 0].numel() * t.element_size()
             for t in meta["attn"].values()) // ZAMBA_SERVE_CACHE
    print(f"zamba2-1.2b bf16 at all {cfg.n_layers} layers: "
          f"{nbytes / 1e9:.3f} GB of parameters; a sequence's cache: "
          f"{state} bytes of mamba state, whatever its length, and "
          f"{kv} bytes of the shared block's K/V a position "
          f"({flash_per_call(cfg, 'decode')} groups)")
    prompts = torch.randint(0, cfg.vocab, (ZAMBA_SERVE_B,
                                           ZAMBA_SERVE_PROMPT),
                            generator=gen, device="cuda")
    got = serve_at_scale(torch, card, total_mem, model, params, prompts,
                         ZAMBA_SERVE_CACHE, ZAMBA_SERVE_STEPS,
                         "zamba2-1.2b serving", grown={"attn": ("k", "v")},
                         tol=ZAMBA_SERVE_TOL)
    probe = params["layers"]["wz"][-1]
    del params
    torch.cuda.empty_cache()
    zamba_fp32_witness(torch, card, cfg, seed + 300, prompts, got, probe)
    del prompts, got["logits"], got["plain_logits"]
    torch.cuda.empty_cache()
    print(f"phase 30: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return got


def zamba_fp32_witness(torch, card, cfg, seed, prompts, got, probe) -> None:
    """Phase 30's witness for ``ZAMBA_SERVE_TOL``: the serving run's
    prefill and decode steps taken again in fp32, on the bf16 run's
    weights (``seed``'s draw rounded to bf16 and held in fp32: one draw
    order, so ``probe``, a bf16 leaf of that run, must come out equal),
    with the plain attention, teacher-forced on the kernel run's tokens.
    Against it the kernel run's bf16 logits must lie within
    ``ZAMBA_WITNESS_RATIO`` times the plain run's error (plus 1e-3 of
    max|logit|): the bf16 pipeline's own error is the mamba stack's, and
    the kernel may add to it no more than the plain attention does."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import rules

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg.scaled(dtype=torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, cast=lambda t: tree.map_leaves(
        lambda x: x.float(), rules.cast_params(t, torch.bfloat16)))
    check(torch.equal(params["layers"]["wz"][-1], probe.float()),
          "the fp32 witness's weights are not the bf16 run's")
    pad = ZAMBA_SERVE_CACHE - prompts.shape[1]
    f32 = []
    before = fa.launches
    with torch.inference_mode(), \
            mock.patch.object(ops, "attention", plain_attention):
        logits, cache = model.prefill(params, {"tokens": prompts})
        cache["attn"] = {k: torch.cat([v, v.new_zeros(
            v.shape[:2] + (pad,) + v.shape[3:])], 2)
            for k, v in cache["attn"].items()}
        for tok in got["toks"]:
            f32.append(logits[:, -1].float())
            logits, cache = model.decode(params, tok[:, None], cache)
    torch.cuda.synchronize()
    check(fa.launches == before, "the fp32 witness launched the kernel")
    peak = torch.cuda.max_memory_allocated()
    del params, cache, logits
    torch.cuda.empty_cache()
    e_kern, near, mism_k = compare_logits(got["logits"], f32)
    e_plain, _, mism_p = compare_logits(got["plain_logits"], f32)
    check(e_kern <= ZAMBA_WITNESS_RATIO * e_plain + 1e-3, f"zamba2 bf16 "
          f"runs vs fp32: kernel {e_kern}, plain {e_plain}")
    print(f"zamba2-1.2b fp32 witness ({len(f32)} steps of "
          f"{prompts.shape[0]} rows after the prefill, {cfg.n_layers} "
          f"layers, the bf16 run's weights in fp32, plain attention, forced "
          f"on its tokens; {card}): the kernel run's bf16 logits within "
          f"{e_kern:.3e} of max|logit|, the plain run's within "
          f"{e_plain:.3e} (the kernel's within {ZAMBA_WITNESS_RATIO} times "
          f"the plain's and 1e-3); hypot {math.hypot(e_kern, e_plain):.3e}"
          f" against the two runs' {got['worst']:.3e} apart (tolerance "
          f"{ZAMBA_SERVE_TOL:.4g}); greedy tokens differing from fp32 "
          f"outside its {near} near ties: kernel {mism_k}, plain {mism_p}; "
          f"peak "
          f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")


def steps_of(torch, flags, layers, n, *, dtype=None, record=None,
             replay=None, drops=None) -> dict:
    """``n`` steps of the launcher's job (``flags``, depth ``layers``,
    ``dtype`` the compute dtype, bf16 by default): a warm-up step, then
    ``n - 1`` timed ones.  ``record`` collects the MoE router's expert
    choices, ``replay`` forces them (``routing``), ``drops`` collects the
    dropped choices (``counting_drops``).  Returns the losses, gradient
    norms, the timed steps' median and the peak."""
    from repro_torch.launch import train as launch
    from repro_torch.models import base

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = launch.setup(flags, n_layers=layers,
                       dtype=dtype or torch.bfloat16)
    losses, norms, ms = [], [], []
    flips = [0, 0]
    with (routing(base, record if record is not None else [], replay,
                  flips) if record is not None or replay is not None
          else contextlib.nullcontext()), \
            (counting_drops(drops) if drops is not None
             else contextlib.nullcontext()):
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = run.train_step()
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    out = dict(losses=losses, norms=norms, peak=peak, flips=flips,
               step_ms=statistics.median(ms[1:]) if n > 1 else ms[0],
               mesh=dict(zip(run.mesh.axes, run.mesh.shape)),
               name=run.cfg.name)
    del run
    torch.cuda.empty_cache()
    return out


def fp32_wide_steps(torch, card) -> dict:
    """Phase 31's fp32 steps of gemma2-2b and deepseek-v2-lite on
    ``2x2x1`` (module docstring, item 31): every backward launch, at (256,
    256) and (192, 128), on the TF32 wgmma kernels, against a twin of the
    same steps with the plain backward patched in (deepseek's forced onto
    the first run's expert choices).  Returns each pair's launches."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ref

    def plain_bwd_of(q, k, v, o, lse, do, **kw):
        return ref.flash_attention_bwd(q, k, v, lse, do, **kw)

    wide = {}
    for label, arch, pair in (("gemma2-2b", "gemma2-2b", (256, 256)),
                              ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b",
                               (192, 128))):
        flags = DP_TRAIN_FLAGS + ["--arch", arch]
        routes = [] if arch.startswith("deepseek") else None
        fa.bwd_launches = fa.bwd_tf32_launches = 0
        plain_bwd = []
        with counting_plain_bwd(plain_bwd), path_bwd("phase 31 fp32"):
            a = steps_of(torch, flags, WIDE_FP32_LAYERS, 2,
                         dtype=torch.float32, record=routes)
        bwd, tf32 = fa.bwd_launches, fa.bwd_tf32_launches
        check(bwd > 0 and tf32 == bwd and not plain_bwd,
              f"{label} fp32 steps: backward launches {bwd}, on the TF32 "
              f"wgmma kernels {tf32}, plain backward calls {len(plain_bwd)}")
        with mock.patch.object(fa, "attention_bwd", plain_bwd_of):
            b = steps_of(torch, flags, WIDE_FP32_LAYERS, 2,
                         dtype=torch.float32, replay=routes)
        check(fa.bwd_launches == bwd, f"{label}: the plain twin launched "
              "the backward kernel")
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            a["losses"] + a["norms"], b["losses"] + b["norms"]))
        check(all(map(math.isfinite, a["losses"] + a["norms"]))
              and rel <= TP_FP32_TOL,
              f"{label} fp32 kernel vs plain backward: {rel}")
        wide[pair] = bwd
        print(f"{label} fp32 at {WIDE_FP32_LAYERS} layers on 2x2x1, 2 "
              f"steps, backward at {pair}: {bwd} backward launches, all on "
              f"the TF32 wgmma kernels, no plain backward call; losses "
              f"{a['losses']} norms {a['norms']}; with the plain backward "
              f"losses {b['losses']} norms {b['norms']}; worst relative "
              f"{rel:.2e} (tolerance {TP_FP32_TOL})"
              + (f"; the twin forced on the first run's expert choices, its "
                 f"own differing in {b['flips'][0]} of {b['flips'][1]} "
                 f"router rows" if routes is not None else "")
              + f"; step {a['step_ms']:.1f} ms (plain backward "
              f"{b['step_ms']:.1f}), peaks {a['peak'] / 2**30:.2f} and "
              f"{b['peak'] / 2**30:.2f} GiB [{card}]")
    return wide


def phase_tensor_parallel(torch, card, total_mem, tr) -> dict:
    """Phase 31: tensor and expert parallelism over ``model`` (module
    docstring, item 31)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    tp = phase_train(torch, card, total_mem, tr, TP_TRAIN_FLAGS,
                     TRAIN_LAYERS, phase=31)
    dp = steps_of(torch, DP_TRAIN_FLAGS, TRAIN_LAYERS, 6)
    check(all(map(math.isfinite, dp["losses"])) and
          dp["losses"][-1] < dp["losses"][1], f"2x2x1: {dp['losses']}")
    first = abs(tp["loss1"] - dp["losses"][0]) / abs(dp["losses"][0])
    check(first <= TP_BF16_TOL, f"2x2x2 vs 2x2x1 warm-up loss: {first}")
    print(f"TinyLlama-1.1B at {TRAIN_LAYERS} layers, global batch 4 x "
          f"4096, bf16 ({card}): mesh 2x2x2 step {tp['step_ms']:.1f} ms, "
          f"peak {tp['peak'] / 2**30:.2f} GiB; mesh 2x2x1 step "
          f"{dp['step_ms']:.1f} ms, peak {dp['peak'] / 2**30:.2f} GiB "
          f"(losses {[round(x, 4) for x in dp['losses']]}); warm-up losses "
          f"{tp['loss1']:.5f} and {dp['losses'][0]:.5f}, {first:.2e} apart")

    # -- fp32: 2x2x2 against 2x2x1 ----------------------------------------
    # the fp32 backward kernels' main path: every backward launch of these
    # steps (hd 64) on the TF32 wgmma kernels, none on mma.sync or the plain
    from repro_torch.kernels import flash_attn as fa
    fa.bwd_launches = fa.bwd_tf32_launches = 0
    plain_bwd: list = []
    for label, flags, layers in (
            ("tinyllama-1.1b", [], COMPARE_LAYERS),
            ("zamba2-1.2b", ["--arch", "zamba2-1.2b"], ZAMBA_TP_LAYERS)):
        with counting_plain_bwd(plain_bwd):
            a = steps_of(torch, TP_TRAIN_FLAGS + flags, layers, 2,
                         dtype=torch.float32)
            b = steps_of(torch, DP_TRAIN_FLAGS + flags, layers, 2,
                         dtype=torch.float32)
        rel = max(abs(x - y) / abs(y) for x, y in zip(
            a["losses"] + a["norms"], b["losses"] + b["norms"]))
        check(rel <= TP_FP32_TOL, f"{label} fp32 2x2x2 vs 2x2x1: {rel}")
        print(f"{label} fp32 at {layers} layers, 2 steps: 2x2x2 losses "
              f"{a['losses']} norms {a['norms']}; 2x2x1 losses "
              f"{b['losses']} norms {b['norms']}; worst relative "
              f"{rel:.2e} (tolerance {TP_FP32_TOL}); peaks "
              f"{a['peak'] / 2**30:.2f} and {b['peak'] / 2**30:.2f} GiB "
              f"[{card}]")
    fp32_bwd, tf32_bwd = fa.bwd_launches, fa.bwd_tf32_launches
    check(fp32_bwd > 0 and tf32_bwd == fp32_bwd and not plain_bwd,
          f"fp32 steps: backward launches {fp32_bwd}, on the TF32 wgmma "
          f"kernels {tf32_bwd}, plain backward calls {len(plain_bwd)}")
    print(f"fp32 steps: {fp32_bwd} backward launches, all on "
          f"flash_bwd_dkdv_tf32_kernel and flash_bwd_dq_tf32_kernel")

    wide = fp32_wide_steps(torch, card)

    # -- deepseek's experts split over model, bf16 -----------------------
    ds = ["--arch", "deepseek-v2-lite-16b"]
    routes: list = []
    dp_drops: list = []
    tp_drops: list = []
    b = steps_of(torch, DP_TRAIN_FLAGS + ds, DEEPSEEK_TRAIN_LAYERS, 2,
                 record=routes, drops=dp_drops)
    forced = [r.unsqueeze(2).expand(*r.shape[:2], 2, *r.shape[2:])
              for r in routes]
    a = steps_of(torch, TP_TRAIN_FLAGS + ds, DEEPSEEK_TRAIN_LAYERS, 2,
                 replay=forced, drops=tp_drops)
    rel = max(abs(x - y) / abs(y) for x, y in zip(
        a["losses"] + a["norms"], b["losses"] + b["norms"]))
    share = [sum(d for d, _ in x) / sum(n for _, n in x)
             for x in (tp_drops, dp_drops)]
    check(rel <= TP_BF16_TOL, f"deepseek 2x2x2 vs 2x2x1: {rel}")
    check(tp_drops and share[0] == share[1],
          f"deepseek dropped-choice shares {share}")
    print(f"deepseek-v2-lite-16b bf16 at {DEEPSEEK_TRAIN_LAYERS} layers, 2 "
          f"steps, 32 experts a model rank on 2x2x2: losses {a['losses']} "
          f"norms {a['norms']}; 2x2x1 losses {b['losses']} norms "
          f"{b['norms']}; worst relative {rel:.2e} (tolerance "
          f"{TP_BF16_TOL}); the 2x2x2 step forced on the 2x2x1 step's "
          f"expert choices, its own differing in {a['flips'][0]} of "
          f"{a['flips'][1]} router rows; dropped-choice share "
          f"{share[0]:.4%} on both ({len(tp_drops)} router calls); step "
          f"{a['step_ms']:.1f} and {b['step_ms']:.1f} ms, peaks "
          f"{a['peak'] / 2**30:.2f} and {b['peak'] / 2**30:.2f} GiB "
          f"[{card}]")
    print(f"phase 31: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(tp, dp_step_ms=dp["step_ms"], dp_peak=dp["peak"],
                fp32_bwd_launches=tf32_bwd, wide_fp32_bwd_launches=wide)


def phase_dryrun(torch, card, wire: dict) -> None:
    """Phase 32: the dry-run's train tracer against the card (module
    docstring, item 32); ``wire`` is phase 10's measured step."""
    from repro_torch.launch import dryrun, step_analysis

    t_phase = time.perf_counter()
    stats, secs, mcfg = dryrun.trace_flags(
        WIRE_TRAIN_FLAGS, n_layers=TRAIN_LAYERS, dtype=torch.bfloat16)
    terms = step_analysis.roofline_terms(stats.flops, stats.bytes_accessed,
                                         stats.total_wire_bytes, 1)
    pred, meas = stats.peak_bytes, wire["peak"]
    rel = (pred - meas) / meas
    step_s = wire["step_ms"] / 1e3
    flash = stats.kernels.get("flash_attention", {})
    print(f"dry-run of the wire step ({' '.join(WIRE_TRAIN_FLAGS)}, "
          f"{TRAIN_LAYERS} layers, mesh {dict(zip(mcfg.axes, mcfg.shape))}) "
          f"on meta in {secs:.1f} s: predicted peak {pred / 2**30:.2f} GiB "
          f"(arguments {stats.argument_bytes / 2**30:.2f} GiB) vs the card's "
          f"{meas / 2**30:.2f} GiB, {rel:+.2%} (tolerance "
          f"{DRYRUN_PEAK_TOL:.0%}) [{card}]")
    print(f"dry-run counts, the whole program on one card: flops "
          f"{stats.flops:.4e} (flash {flash.get('flops', 0):.4e} in "
          f"{flash.get('launches', 0)} launches), bytes accessed "
          f"{stats.bytes_accessed:.4e} (2 x written), wire bytes "
          f"{stats.total_wire_bytes:.4e}; roofline on the H100 data sheet: "
          f"compute {terms['compute_s'] * 1e3:.1f} ms, memory "
          f"{terms['memory_s'] * 1e3:.1f} ms, collective "
          f"{terms['collective_s'] * 1e3:.1f} ms, dominant "
          f"{terms['dominant']}; the measured step {wire['step_ms']:.1f} "
          f"ms is {step_s / terms['compute_s']:.2f} x the compute term "
          f"(compute term {terms['compute_s'] / step_s:.2%} of the step), "
          f"{step_s / terms['memory_s']:.2f} x the memory term")
    check(abs(rel) <= DRYRUN_PEAK_TOL, f"dry-run peak {pred} vs the card's "
          f"{meas}: {rel:+.2%}")
    check(flash.get("launches") == 2 * TRAIN_LAYERS,
          f"the dry-run counted {flash.get('launches')} flash launches, "
          f"the card made {2 * TRAIN_LAYERS} a step")
    print(f"phase 32: phase {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_head_split(torch, card) -> dict:
    """Phase 33: gemma2-2b's query heads split over ``model`` (module
    docstring, item 33)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attn as fa

    t_phase = time.perf_counter()
    fa.launches = fa.tc_launches = 0
    a = steps_of(torch, ["--mesh", "1x1x16", *HEAD_SPLIT_FLAGS],
                 HEAD_SPLIT_LAYERS, HEAD_SPLIT_STEPS)
    launches, tc = fa.launches, fa.tc_launches
    b = steps_of(torch, ["--mesh", "1x1x1", *HEAD_SPLIT_FLAGS],
                 HEAD_SPLIT_LAYERS, HEAD_SPLIT_STEPS)
    want = HEAD_SPLIT_STEPS * flash_per_call(
        configs.load("gemma2-2b").CONFIG.scaled(n_layers=HEAD_SPLIT_LAYERS),
        "train")
    rel = max(abs(x - y) / abs(y) for x, y in zip(
        a["losses"] + a["norms"], b["losses"] + b["norms"]))
    print(f"gemma2-2b at published widths, {HEAD_SPLIT_LAYERS} layers, one "
          f"sequence of 4096, bf16: 8 query heads split over 16 model ranks "
          f"(mesh {a['mesh']}) losses {a['losses']} norms {a['norms']}, "
          f"step {a['step_ms']:.1f} ms, peak {a['peak'] / 2**30:.2f} GiB, "
          f"flash launches {launches} ({tc} on the tensor cores, hd 256); "
          f"one rank (mesh {b['mesh']}) losses {b['losses']} norms "
          f"{b['norms']}, step {b['step_ms']:.1f} ms, peak "
          f"{b['peak'] / 2**30:.2f} GiB; worst relative {rel:.2e} "
          f"(tolerance {TP_BF16_TOL}) [{card}]")
    check(all(map(math.isfinite, a["losses"] + a["norms"])),
          f"1x1x16: {a['losses']} {a['norms']}")
    check(launches == want and tc == launches, f"flash launches {launches} "
          f"({tc} tensor-core) over {HEAD_SPLIT_STEPS} steps, want {want}")
    check(rel <= TP_BF16_TOL, f"gemma2-2b 1x1x16 vs 1x1x1: {rel}")
    print(f"phase 33: phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return dict(split=a, one=b, launches=launches)


def _example(name: str):
    """An ``examples_torch`` module, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(torch, card) -> None:
    """Phase 34: the four examples on the card (module docstring, item
    34)."""
    import tempfile

    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa

    def reset():
        fa.launches = 0
        for d in (qt.launches, sa.launches):
            for k in d:
                d[k] = 0

    t_phase = time.perf_counter()
    reset()
    t = time.perf_counter()
    out = _example("quickstart").main([])
    print(f"examples: quickstart {time.perf_counter() - t:.1f} s; int8 "
          f"launches {dict(qt.launches)}, sparse {dict(sa.launches)} "
          f"[{card}]")
    check(all(out[a] <= 1e-4 for a in ("ring", "rhd", "fixed_tree",
                                       "two_level", "psum", "auto")),
          f"quickstart collectives: {out}")
    check(out["f3_bitwise"] and 0 < out["nnz"] < 1 << 16
          and out["int8_rel_err"] < 0.02 and out["incidents"],
          f"quickstart: {out}")
    check(all(qt.launches[k] > 0 for k in ("quantize", "dequantize",
                                           "dequant_accum_slots")),
          f"quickstart's int8 mode launched {qt.launches}")

    reset()
    t = time.perf_counter()
    out = _example("sparse_allreduce_demo").main([])
    print(f"examples: sparse_allreduce_demo {time.perf_counter() - t:.1f} "
          f"s; int8 launches {dict(qt.launches)}, sparse "
          f"{dict(sa.launches)}, flash {fa.launches} [{card}]")
    for name, r in out.items():
        check(all(map(math.isfinite, r["losses"]))
              and r["losses"][-1] < r["losses"][0],
              f"sparse_allreduce_demo {name}: {r['losses']}")
    check(qt.launches["quantize"] > 0 and sa.launches["sparse_accum_slots"]
          > 0 and fa.launches > 0, "sparse_allreduce_demo launched "
          f"{qt.launches} {sa.launches} flash {fa.launches}")

    reset()
    with tempfile.TemporaryDirectory() as ck:
        t = time.perf_counter()
        out = _example("train_e2e").main(["--ckpt", ck])
        print(f"examples: train_e2e {time.perf_counter() - t:.1f} s, "
              f"{out['tok_s']:.0f} tok/s, flash launches {fa.launches} "
              f"[{card}]")
    losses = out["losses"]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
          and out["steps"] == [100, 200] and fa.launches > 0,
          f"train_e2e: losses {losses[0]} → {losses[-1]}, checkpoints "
          f"{out['steps']}, flash {fa.launches}")

    reset()
    t = time.perf_counter()
    reqs = _example("serve_batched").main([])
    print(f"examples: serve_batched {time.perf_counter() - t:.1f} s, flash "
          f"launches {fa.launches} [{card}]")
    check(len(reqs) == 10 and all(r.done and r.out for r in reqs)
          and fa.launches > 0, "serve_batched left a request unanswered")
    torch.cuda.empty_cache()
    print(f"phase 34: phase {time.perf_counter() - t_phase:.1f} s ({card})")


def partial_vs_plain(torch, fa, ref, launch: tuple, label: str, *,
                     got=None, plain=None) -> tuple:
    """One partial flash launch ``(q, k, v, kw)`` (its ``got`` output if
    given) against its plain version, ``ref.flash_attention_partial`` (or
    ``flash_attention_bshd`` without ``shards``; ``plain`` if given), on
    the same inputs: the output within :func:`flash_err`'s bound, the
    log-sum-exp within 3e-5 on every row that sees a key, and every
    keyless row exact in both (``o = 0``, ``lse = -inf``).  Returns (the
    output's worst error, the log-sum-exp's, the keyless rows)."""
    q, k, v, kw = launch
    o, lse = got or fa.attention_fwd(q, k, v, **kw)
    po, plse = plain or (ref.flash_attention_partial(q, k, v, **kw)
                         if kw.get("shards")
                         else ref.flash_attention_bshd(q, k, v, **kw))
    torch.cuda.synchronize()
    none = torch.isinf(plse)
    check(torch.equal(torch.isinf(lse), none)
          and not bool(o.movedim(-2, -3)[none].any())
          and not bool(po.movedim(-2, -3)[none].any()),
          f"{label}: keyless rows are not o = 0, lse = -inf")
    err = flash_err(torch, o, po, v)
    lerr = float((lse[~none] - plse[~none]).abs().max())
    check(lerr <= 3e-5, f"{label}: partial flash lse {lerr} > 3e-5")
    return err, lerr, int(none.sum())


def phase_flash_partial_vs_plain(torch, ref, fa) -> None:
    """Phase 7's partial launches (module docstring, item 7): the flash
    kernel over a sequence split (``shards=``) against its plain version,
    ``ref.flash_attention_partial``; then the decode kernel's partial
    launches over longer shards."""
    gen = torch.Generator(device="cuda").manual_seed(35)
    n, b, sk, h, kv, shards = 8, 2, 96, 8, 2, 4
    # Sq, q_offset, kv_len, causal, cap, window over 4 shards of 96 keys
    cases = ((1, 150, 151, True, 0.0, 0), (3, 250, 253, True, 30.0, 100),
             (1, 383, 384, True, 50.0, 0), (5, 0, 200, False, 0.0, 0),
             (128, 90, 240, True, 0.0, 0), (1, 10, 11, True, 30.0, 8))
    dims = [(name, d) for name in ("bfloat16", "float32")
            for d in fa.TC_DIMS]
    worst, keyless, count, twice = {}, 0, 0, 0
    before = (fa.partial_launches, fa.tc_launches, fa.decode_launches,
              fa.fp32_launches, fa.decode_mma_launches)
    for name, (hd, vd) in dims:
        dt = getattr(torch, name)
        k = torch.randn((n, 2, b, sk, kv, hd), generator=gen,
                        device="cuda").to(dt)[:, 1]
        v = torch.randn((n, 2, b, sk, kv, vd), generator=gen,
                        device="cuda").to(dt)[:, 1]
        for sq, off, kvl, causal, cap, win in cases:
            q = torch.randn((n, b, sq, h, hd), generator=gen,
                            device="cuda").to(dt)
            kw = dict(shards=shards, causal=causal, attn_cap=cap,
                      window=win, q_offset=off, kv_len=kvl,
                      scale=hd ** -0.5)
            label = f"partial flash {name} ({hd}, {vd}) {(sq, off, kvl)}"
            got = None
            if name == "float32" and not fa.decodes(h, kv, sq):
                got = fa.attention_fwd(q, k, v, **kw)
                again = fa.attention_fwd(q, k, v, **kw)
                check(same_bits(got[0], again[0])
                      and same_bits(got[1], again[1]),
                      f"{label}: the same launch gave other bits")
                twice += 1
            err, _, none = partial_vs_plain(torch, fa, ref, (q, k, v, kw),
                                            label, got=got)
            worst[name] = max(worst.get(name, 0.0), err)
            keyless += none
            count += 1
    decoded = sum(fa.decodes(h, kv, c[0]) for c in cases)
    check(fa.partial_launches - before[0] == count + twice
          and fa.tc_launches - before[1]
          == len(fa.TC_DIMS) * (len(cases) - decoded)
          and fa.fp32_launches - before[3] == 2 * twice
          == 2 * len(fa.TC_DIMS) * (len(cases) - decoded)
          and fa.decode_launches - before[2] == len(dims) * decoded
          and fa.decode_mma_launches - before[4]
          == len(fa.TC_DIMS) * decoded,
          "partial flash: launch counters")
    print(f"flash partial launches vs plain (ref.flash_attention_partial): "
          f"{count} launches over 4 shards of 96 keys (2 data x 4 model "
          f"ranks x 2 rows, GQA 8/2, the keys a strided layer slice; "
          f"{len(dims) * decoded} of them on the decode kernel), bf16 "
          f"at {list(fa.TC_DIMS)} worst {worst['bfloat16']:.3e} (one ulp), "
          f"fp32 at the same worst {worst['float32']:.3e} (3e-5; each "
          f"fp32 one outside the decode kernel twice, the same bits); "
          f"{keyless} keyless rows o = 0, lse = -inf in both")
    # the decode kernel's partial launches at G 1 and 48 over shards of
    # 1024 keys (one layer's slice of a cache), both dtypes at every
    # TC_DIMS pair (MLA's strided v at (192, 128)): Sq, q_offset, kv_len,
    # causal, cap, window
    n, b, sk, kv = 8, 2, 1024, 2
    dec, keyless, count, splits = {}, 0, 0, set()
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for hd, vd in fa.TC_DIMS:
            k = torch.randn((n, 2, b, sk, kv, hd), generator=gen,
                            device="cuda").to(dt)[:, 1]
            wide = 256 if (hd, vd) == (192, 128) else vd
            v = torch.randn((n, 2, b, sk, kv, wide), generator=gen,
                            device="cuda").to(dt)[:, 1][..., wide - vd:]
            for g, off, kvl, causal, cap, win in (
                    (1, 2600, 2601, True, 0.0, 0),
                    (48, 3000, 3001, True, 50.0, 500),
                    (48, 0, 3500, False, 0.0, 0)):
                q = torch.randn((n, b, 1, g * kv, hd), generator=gen,
                                device="cuda").to(dt)
                kw = dict(shards=4, causal=causal, attn_cap=cap, window=win,
                          q_offset=off, kv_len=kvl, scale=hd ** -0.5)
                err, _, none, plan = decode_vs_plain(
                    torch, fa, ref, q, k, v, kw,
                    f"partial decode {name} ({hd}, {vd}) G {g} {(off, kvl)}")
                dec[name] = max(dec.get(name, 0.0), err)
                keyless += none
                splits.add(plan.splits)
                count += 1
    check(keyless > 0 and max(splits) > 1, "partial decode: no keyless row "
          "or no launch of many splits")
    print(f"flash decode kernel partial launches vs plain: {count} launches "
          f"over 4 shards of 1024 keys at G 1 and 48, {min(splits)} to "
          f"{max(splits)} splits, fp32 worst {dec['float32']:.3e}, bf16 "
          f"worst {dec['bfloat16']:.3e}; {keyless} keyless rows o = 0, "
          "lse = -inf in both")


def grown(torch, cache: dict, cache_len: int) -> dict:
    """A prefill's cache with every K/V entry grown along its sequence to
    ``cache_len`` positions (zeros past the prompts; new tensors)."""
    out = dict(cache)
    for name in set(cache) - {"pos"}:
        out[name] = {k: torch.cat([v, v.new_zeros(
            v.shape[:2] + (cache_len - v.shape[2],) + v.shape[3:])], 2)
            for k, v in cache[name].items()}
    return out


def steps_timed(torch, step, toks) -> tuple:
    """``step(token)`` for each column of ``toks`` (teacher-forced),
    synchronised: the last-position fp32 logits and the ms of each."""
    logits, ms = [], []
    for i in range(toks.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(toks[:, i:i + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[:, -1].float())
    return logits, ms


def rel_err(got: list, want: list) -> float:
    """The worst |got − want| over each pair, as a share of the pair's
    max|want|."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


def sharded_decode(torch, card, model, params, cache, toks, mesh: tuple,
                   cache_len: int, label: str, *, want: list,
                   tol: float = SERVE_LOGIT_TOL, prompts=None,
                   want_prefill=None, want_cache=None,
                   cache_tol: float = SHARD_CACHE_TOL,
                   dryrun_pos: int | None = None) -> dict:
    """``make_serve_fns`` on ``(pod, data, model)`` = ``mesh``: with
    ``prompts``, the sharded prefill against ``want_prefill`` /
    ``want_cache`` (the unsharded one's logits and cache, within ``tol``
    and ``cache_tol``); then the
    sharded decode of ``toks`` teacher-forced from the global ``cache``
    (placed by ``shard_cache``), the flash counters set to 0 just before
    and read just after, each step's logits against ``want`` within
    ``tol``.  A cache split over its sequence launches one partial flash
    a layer a step, and the recorded launches must leave some shard
    keyless.  With ``dryrun_pos`` the dry-run's trace of one decode step
    at that position on ``meta`` must predict the card's peak for it
    within ``DRYRUN_PEAK_TOL``.  Returns the figures and the last step's
    last partial launch and, where a layer has a window, its last
    windowed one (their tensors, ``launches``: to hold them against the
    plain version and to time the first)."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.sharding import rules

    cfg = model.cfg
    b = toks.shape[0]
    mc = rules.MeshCfg(("pod", "data", "model"), mesh)
    prefill_fn, decode_fn, layout = make_serve_fns(
        model, mc, cache_batch=b, cache_len=cache_len)
    sp = layout.shard_params(params)
    seq = bool(layout.seq_split)
    out = dict(mesh="x".join(map(str, mesh)), seq_split=seq)
    if prompts is not None:
        logits, pc = prefill_fn(sp, {"tokens": prompts})
        out["prefill_err"] = rel_err([logits[:, -1].float()],
                                     [want_prefill[:, -1].float()])
        got = tree.flatten(layout.unshard_cache(pc))[0]
        out["cache_err"] = max(
            float((a.float() - w.float()).abs().max())
            / float(w.float().abs().max())
            for a, w in zip(got, tree.flatten(want_cache)[0])
            if isinstance(a, torch.Tensor))
        check(out["prefill_err"] <= tol, f"{label} {out['mesh']}: prefill "
              f"logits {out['prefill_err']} of max|logit| from unsharded")
        check(out["cache_err"] <= cache_tol, f"{label} {out['mesh']}: "
              f"prefill cache {out['cache_err']} from unsharded")
        del logits, pc, got
    torch.cuda.empty_cache()
    scache = layout.shard_cache(cache)
    rec, keyless = {}, []
    real = fa.attention_fwd

    def record(q, k, v, **kw):
        if kw.get("shards"):
            rec["last"] = (q, k, v, kw)
            if kw["window"]:
                rec["window"] = (q, k, v, kw)
            keyless.append(sum(m * k.shape[2] >= kw["kv_len"]
                               for m in range(kw["shards"])))
        return real(q, k, v, **kw)

    def step(tok):
        nonlocal scache
        logits, scache = decode_fn(sp, tok, scache)
        return logits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.tc_launches = fa.partial_launches = 0
    fa.decode_launches = 0
    with mock.patch.object(fa, "attention_fwd", record):
        logits, ms = steps_timed(torch, step, toks)
    n = toks.shape[1]
    layers = flash_per_call(cfg, "decode")
    out.update(launches=fa.launches, partial=fa.partial_launches,
               tc=fa.tc_launches, decode=fa.decode_launches, step_ms=ms,
               peak=torch.cuda.max_memory_allocated(),
               err=rel_err(logits, want),
               recorded=[rec[k] for k in ("last", "window") if k in rec],
               keyless=min(keyless) if keyless else 0)
    check(out["launches"] == layers * n
          and out["tc"] == 0 and out["decode"] == out["launches"]
          and out["partial"] == (out["launches"] if seq else 0),
          f"{label} {out['mesh']}: flash launches {out['launches']} "
          f"({out['partial']} partial, {out['decode']} on the decode "
          f"kernel, {out['tc']} tensor-core) over {n} steps of {layers} "
          f"layers")
    check(not seq or out["keyless"] >= 1, f"{label} {out['mesh']}: no "
          "partial launch left a shard keyless")
    check(out["err"] <= tol, f"{label} {out['mesh']}: decode logits "
          f"{out['err']} of max|logit| from the unsharded decode's")
    if dryrun_pos is not None:
        out.update(dryrun_peak(torch, model, mc, decode_fn, sp, scache,
                               toks[:, :1], cache_len, dryrun_pos))
    del scache, sp
    torch.cuda.empty_cache()
    return out


def dryrun_peak(torch, model, mc, decode_fn, sp, scache, tok,
                cache_len: int, pos: int) -> dict:
    """The dry-run's predicted peak of one sharded decode step at ``pos``
    (``make_serve_fns`` on ``meta``, ``step_analysis.analyze``) against the
    card's: the step's arguments (parameters, cache, tokens) and the most
    it allocates above them.  Checked within ``DRYRUN_PEAK_TOL``."""
    from repro_torch.launch import step_analysis
    from repro_torch.models.registry import abstract_params
    from repro_torch.serve.engine import make_serve_fns

    b = tok.shape[0]
    _, df, lay = make_serve_fns(model, mc, cache_batch=b,
                                cache_len=cache_len, device="meta")
    p = lay.shard_params(abstract_params(model))
    c = lay.shard_cache(model.init_cache(b, cache_len, device="meta"))
    c["pos"] = pos
    t0 = time.perf_counter()
    stats, _ = step_analysis.analyze(df, p, torch.empty(
        tok.shape, dtype=tok.dtype, device="meta"), c)
    secs = time.perf_counter() - t0
    scache["pos"] = pos
    args = sum(step_analysis._storages(step_analysis._tensors(
        (sp, scache, tok))).values())
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    decode_fn(sp, tok, scache)
    torch.cuda.synchronize()
    meas = args + torch.cuda.max_memory_allocated() - base_alloc
    rel = (stats.peak_bytes - meas) / meas
    check(abs(rel) <= DRYRUN_PEAK_TOL, f"dry-run decode peak "
          f"{stats.peak_bytes} vs the card's {meas}: {rel:+.2%}")
    return dict(dry_peak=stats.peak_bytes, dry_args=stats.argument_bytes,
                card_peak=meas, card_args=args, dry_rel=rel, dry_s=secs,
                dry_flash=stats.kernels.get("flash_attention", {}))


def partial_figures(torch, card, recorded: list, label: str) -> dict:
    """The main path's recorded partial launches (``recorded``: the last
    step's last one, and its last windowed one where a layer has a
    window) each held against the plain version on the same inputs at
    their own shapes (:func:`partial_vs_plain`); then the first one's
    time (CUDA events) against its bound (bytes at 3.35 TB/s or flops at
    the bf16 peak, the larger) and against
    ``scaled_dot_product_attention`` over the same shard's keys with the
    boolean mask of each row's visible keys (its output only: a keyless
    row's is NaN there), and the plain version's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ref

    checked = []
    for launch in recorded:
        kw = launch[3]
        err, lerr, none = partial_vs_plain(
            torch, fa, ref, launch, f"{label} partial launch at q "
            f"{tuple(launch[0].shape)}, window {kw['window']}")
        checked.append(dict(window=kw["window"], err=err, lse_err=lerr,
                            keyless=none, shape=tuple(launch[0].shape)))
    q, k, v, kw = recorded[0]
    n, b, sq, h, hd = q.shape
    sk, kvh, vd = k.shape[2], k.shape[3], v.shape[-1]
    shards = kw["shards"]
    ms = cuda_ms(lambda: fa.attention_fwd(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: ref.flash_attention_partial(q, k, v, **kw), 3)
    nbytes = fa.bytes_moved(q, k, v, kw["kv_len"], window=kw["window"],
                            q_offset=kw["q_offset"], shards=shards)
    flops = fa.flops(n * b, h, sq, sk, hd, causal=kw["causal"],
                     window=kw["window"], vd=vd, q_offset=kw["q_offset"],
                     kv_len=kw["kv_len"], shards=shards)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    qt = q.reshape(n * b, sq, h, hd).transpose(1, 2)
    kt, vt = (t.reshape(n * b, sk, kvh, t.shape[-1]).transpose(1, 2)
              for t in (k, v))
    dev = q.device
    kpos = ((torch.arange(n, device=dev) % shards) * sk).repeat_interleave(
        b)[:, None, None] + torch.arange(sk, device=dev)
    qpos = (kw["q_offset"] + torch.arange(sq, device=dev))[None, :, None]
    mask = kpos < kw["kv_len"]
    if kw["causal"]:
        mask = mask & (kpos <= qpos)
        if kw["window"]:
            mask = mask & (kpos > qpos - kw["window"])
    mask = mask[:, None]
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True), 20)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=l_ms,
                bytes=nbytes, flops=flops, checked=checked,
                shape=(tuple(q.shape), tuple(k.shape), kw["q_offset"],
                       kw["kv_len"]))


def print_sharded(card, label: str, runs: list, plain: dict, fig: dict,
                  phase: int, t_phase: float) -> None:
    """Phases 35–36's figures: decode step medians, peaks, launches a
    step, the partial launch's time."""
    for r in runs:
        n = len(r["step_ms"])
        print(f"{label} on {r['mesh']} ("
              f"{'sequence' if r['seq_split'] else 'KV heads'} split over "
              f"model): decode step ms (median of {n}, {card}) "
              f"{statistics.median(r['step_ms']):.2f} (first "
              f"{r['step_ms'][0]:.2f}); flash launches a step "
              f"{r['launches'] // n} ({r['partial'] // n} partial, "
              f"{r['decode'] // n} on the decode kernel); peak "
              f"{r['peak'] / 2**30:.2f} GiB; logits within {r['err']:.3e} "
              f"of max|logit| of the unsharded steps"
              + (f"; keyless shards a partial launch >= {r['keyless']}"
                 if r["seq_split"] else "")
              + (f"; prefill logits {r['prefill_err']:.3e}, cache "
                 f"{r['cache_err']:.3e} of its largest"
                 if "prefill_err" in r else ""))
        if "dry_peak" in r:
            print(f"{label} on {r['mesh']}: the dry-run's trace of one "
                  f"decode step on meta ({r['dry_s']:.1f} s) predicts a peak "
                  f"of {r['dry_peak'] / 2**30:.3f} GiB (arguments "
                  f"{r['dry_args'] / 2**30:.3f}, flash "
                  f"{r['dry_flash'].get('launches', 0)} launches) against "
                  f"the card's {r['card_peak'] / 2**30:.3f} GiB (arguments "
                  f"{r['card_args'] / 2**30:.3f}): {r['dry_rel']:+.2%} "
                  f"(tolerance {DRYRUN_PEAK_TOL:.0%})")
    print(f"{label} unsharded: decode step ms (median of "
          f"{len(plain['step_ms'])}, {card}) "
          f"{statistics.median(plain['step_ms']):.2f}; peak "
          f"{plain['peak'] / 2**30:.2f} GiB")
    (qs, ks, off, kvl) = fig["shape"]
    print(f"{label}: the partial flash launch q {qs} k {ks} (a layer's "
          f"strided slice) at position {off}, kv_len {kvl}: "
          f"{fig['ms']:.4f} ms against its bound {fig['bound_ms']:.4f} ms "
          f"({fig['bytes'] / 1e6:.2f} MB, {fig['flops'] / 1e9:.3f} GFLOP; "
          f"{fig['bound_ms'] / fig['ms']:.1%}), plain "
          f"{fig['plain_ms']:.3f} ms, library scaled_dot_product_attention "
          f"with the boolean mask over the same shard's keys "
          f"{fig['library_ms']:.4f} ms  [{card}]")
    for c in fig["checked"]:
        print(f"{label}: the recorded partial launch q {c['shape']} "
              f"(window {c['window']}) against its plain version "
              f"(ref.flash_attention_partial) on the same inputs: output "
              f"{c['err']:.3e} (one bf16 ulp), lse {c['lse_err']:.3e} "
              f"(3e-5), {c['keyless']} keyless rows o = 0, lse = -inf in "
              f"both")
    print(f"phase {phase}: phase {time.perf_counter() - t_phase:.1f} s "
          f"({card})")


def unsharded_run(torch, model, params, cache, toks) -> dict:
    """The unsharded decode of ``toks`` teacher-forced on ``cache`` (a
    copy: the global cache is placed again for each layout)."""
    from repro_torch import tree
    c = tree.map_leaves(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, cache)

    def step(tok):
        nonlocal c
        with torch.no_grad():
            logits, c = model.decode(params, tok, c)
        return logits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, ms = steps_timed(torch, step, toks)
    peak = torch.cuda.max_memory_allocated()
    del c
    torch.cuda.empty_cache()
    return dict(logits=logits, step_ms=ms, peak=peak)


def phase_sharded_serve(torch, card, seed) -> dict:
    """Phase 35: TinyLlama-1.1B served sharded (module docstring, item
    35)."""
    from repro_torch.configs import tinyllama_1_1b as tl
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = tl.CONFIG
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 35)
    params = layerwise_params(model, gen)
    prompts = torch.randint(0, cfg.vocab, (SHARD_B, SHARD_PROMPT),
                            generator=gen, device="cuda")
    with torch.no_grad():
        want_prefill, want_cache = model.prefill(params, {"tokens": prompts})
        cache = grown(torch, model.prefill(
            params, {"tokens": prompts[:, :SHARD_POS]})[1], SHARD_CACHE)
    toks = prompts[:, SHARD_POS:SHARD_POS + SHARD_STEPS]
    plain = unsharded_run(torch, model, params, cache, toks)
    runs = []
    for mesh in SHARD_MESHES:
        runs.append(sharded_decode(
            torch, card, model, params, cache, toks, mesh, SHARD_CACHE,
            "TinyLlama-1.1B sharded serving", want=plain["logits"],
            prompts=prompts, want_prefill=want_prefill,
            want_cache=want_cache,
            dryrun_pos=SHARD_POS if mesh == SHARD_MESHES[0] else None))
        if mesh == SHARD_MESHES[0]:
            fig = partial_figures(torch, card, runs[-1]["recorded"],
                                  "TinyLlama 1x2x8")
        runs[-1]["recorded"] = None
    check(runs[0]["seq_split"] and not runs[1]["seq_split"]
          and runs[0]["keyless"] >= 3, f"phase 35's layouts: "
          f"{[(r['mesh'], r['seq_split'], r['keyless']) for r in runs]}")
    del params, cache, want_cache, plain["logits"]
    torch.cuda.empty_cache()

    # -- (c) the fp32 witness at SHARD_FP32_LAYERS layers --------------------
    cfg32 = cfg.scaled(n_layers=SHARD_FP32_LAYERS, dtype=torch.float32)
    m32 = get_model(cfg32)
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(seed + 36))
    short = prompts[:, :SHARD_POS]
    with torch.no_grad():
        w32, wc32 = m32.prefill(p32, {"tokens": short})
    c32 = grown(torch, wc32, SHARD_CACHE)
    t32 = toks[:, :SHARD_FP32_STEPS]
    plain32 = unsharded_run(torch, m32, p32, c32, t32)
    worst32 = []
    for mesh in SHARD_MESHES:
        r = sharded_decode(torch, card, m32, p32, c32, t32, mesh,
                           SHARD_CACHE, "TinyLlama fp32 witness",
                           want=plain32["logits"], tol=SHARD_FP32_TOL,
                           prompts=short, want_prefill=w32, want_cache=wc32,
                           cache_tol=SHARD_FP32_TOL)
        worst32.append((r["mesh"], r["prefill_err"], r["err"]))
    print(f"TinyLlama fp32 witness at {SHARD_FP32_LAYERS} layers (prefill of "
          f"{SHARD_B} x {SHARD_POS}, {SHARD_FP32_STEPS} decode steps): "
          f"sharded against unsharded, prefill / decode logits within "
          f"{[(m, f'{a:.2e}', f'{b:.2e}') for m, a, b in worst32]} of "
          f"max|logit| (tolerance {SHARD_FP32_TOL})")
    del p32, c32, wc32
    torch.cuda.empty_cache()
    print_sharded(card, "TinyLlama-1.1B (22 layers, bf16, global batch "
                  f"{SHARD_B}, cache {SHARD_CACHE}, {SHARD_STEPS} steps "
                  f"from {SHARD_POS})", runs, plain, fig, 35, t_phase)
    return dict(runs=runs, plain=plain, fig=fig,
                partial=sum(r["partial"] for r in runs))


def phase_gemma_sharded(torch, card, seed) -> dict:
    """Phase 36: gemma2-2b served sharded on ``1x1x8`` (module docstring,
    item 36)."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.models.registry import get_model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = gemma2_2b.CONFIG
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 36)
    params = layerwise_params(model, gen)
    prompts = torch.randint(0, cfg.vocab, (GEMMA_SHARD_B, GEMMA_SHARD_POS
                                           + GEMMA_SHARD_STEPS),
                            generator=gen, device="cuda")
    with torch.no_grad():
        cache = grown(torch, model.prefill(
            params, {"tokens": prompts[:, :GEMMA_SHARD_POS]})[1],
            GEMMA_SHARD_CACHE)
    toks = prompts[:, GEMMA_SHARD_POS:]
    plain = unsharded_run(torch, model, params, cache, toks)
    run = sharded_decode(torch, card, model, params, cache, toks,
                         GEMMA_SHARD_MESH, GEMMA_SHARD_CACHE,
                         "gemma2-2b sharded serving", want=plain["logits"])
    sl = GEMMA_SHARD_CACHE // GEMMA_SHARD_MESH[2]
    last = GEMMA_SHARD_POS + GEMMA_SHARD_STEPS
    check(run["seq_split"] and run["keyless"] >= 3
          and GEMMA_SHARD_POS - cfg.window + 1 < sl
          and 4 * sl < last <= 5 * sl, f"phase 36's masks across shards: "
          f"{run['keyless']} keyless, window from "
          f"{GEMMA_SHARD_POS - cfg.window + 1}, kv_len to {last}")
    check(len(run["recorded"]) == 2, "phase 36 recorded no windowed "
          "partial launch")
    fig = partial_figures(torch, card, run["recorded"], "gemma2-2b 1x1x8")
    run["recorded"] = None
    del params, cache
    torch.cuda.empty_cache()
    print_sharded(card, "gemma2-2b (26 layers, bf16, global batch "
                  f"{GEMMA_SHARD_B}, cache {GEMMA_SHARD_CACHE}, "
                  f"{GEMMA_SHARD_STEPS} steps from {GEMMA_SHARD_POS}, window "
                  f"{cfg.window}, caps {cfg.attn_softcap} / "
                  f"{cfg.logit_softcap})", [run], plain, fig, 36, t_phase)
    return dict(runs=[run], plain=plain, fig=fig, partial=run["partial"])


def plain_attention(q, k, v, *, causal=True, scale=None, attn_cap=0.0,
                    window=0, q_offset=0, kv_len=None):
    """``ops.attention``'s signature over the plain version (no kernel)."""
    from repro_torch.kernels import ref
    return ref.flash_attention_bshd(
        q, k, v, causal=causal, scale=scale, attn_cap=attn_cap,
        window=window, q_offset=q_offset, kv_len=kv_len)[0]


def routing(base, calls: list, replay: list | None = None,
            flips: list | None = None):
    """Patch the MoE router's top-k (``base._top_k``): record each call's
    expert choices in ``calls``; with ``replay`` (another run's
    ``calls``), take those choices instead, gate values from this run's
    probabilities, and count in ``flips`` the rows whose own choice
    differed, and all rows."""
    real = base._top_k
    want = iter(replay) if replay is not None else None

    def top_k(x, k):
        vals, idx = real(x, k)
        if want is not None:
            forced = next(want)
            flips[0] += int((idx.sort(-1).values != forced.sort(-1).values
                             ).any(-1).sum())
            flips[1] += idx[..., 0].numel()
            idx = forced
            vals = x.gather(-1, idx)
        calls.append(idx)
        return vals, idx
    return mock.patch.object(base, "_top_k", top_k)


def serve_at_scale(torch, card, total_mem, model, params, prompts,
                   cache_len: int, steps: int, label: str, *,
                   feed=None, routes=None, extra=None,
                   fp32_launches: int = 0, grown=None,
                   tol: float = SERVE_LOGIT_TOL) -> dict:
    """Prefill ``prompts`` (``(B, S)`` on the card), grow the cache to
    ``cache_len`` positions, then ``steps`` lockstep greedy decode steps,
    the flash counter read around each (one launch a layer a step, all on
    the decode kernel; the prefill's on the tensor cores but for
    ``fp32_launches``); the same steps with the plain attention patched in,
    teacher-forced on the kernel's tokens: logits within
    ``SERVE_LOGIT_TOL`` of max|logit|, greedy tokens equal except where
    the plain run's top two lie within it (counted).  An MoE model's
    plain run is teacher-forced on the kernel run's expert choices too
    (``routing``): a bf16 ulp of attention may flip a router's top-k,
    which moves a token's logits by far more than the ulp; the flips the
    plain run would have made are counted.  ``feed`` and ``routes`` force
    the kernel run's tokens and expert choices too.  ``extra`` joins the
    prompts in the prefill's batch (the VLM's ``vision_embeds``), and
    ``fp32_launches`` of a call's launches go to the fp32 kernel (the
    VLM's cross layers over fp32 K/V).  The flash launches a call are
    ``flash_per_call``'s.  ``grown`` names the cache entries and their
    tensors that grow along dim 2 (whisper's self ``k``/``v``, not its
    cross K/V over the encoder's keys; none of mamba2's state); by
    default every entry but the VLM's cross one.  Prints the median
    prefill (of 3) and decode step times, the peak and a profile of one
    decode step; returns the figures and the kernel run's step logits,
    tokens and expert choices."""
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops
    from repro_torch.models import base

    layers = model.cfg.n_layers
    per_step = flash_per_call(model.cfg, "decode")
    per_prefill = flash_per_call(model.cfg, "prefill")
    b, s = prompts.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    batch = {"tokens": prompts, **(extra or {})}

    def grow(cache):
        pad = cache_len - s
        names = grown if grown is not None else {
            name: tuple(cache[name]) for name in set(cache) - {"pos", "cross"}}
        for name, keys in names.items():
            cache[name] = {k: (torch.cat([v, v.new_zeros(
                v.shape[:2] + (pad,) + v.shape[3:])], 2) if k in keys else v)
                for k, v in cache[name].items()}
        return cache

    def run(feed=None):
        logits_all, toks, step_ms, launches = [], [], [], []
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            cache = grow(cache)
            for i in range(steps):
                logits_all.append(logits[:, -1].float())
                tok = logits[:, -1].argmax(-1) if feed is None else feed[i]
                toks.append(tok)
                before = fa.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode(params, tok[:, None], cache)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(fa.launches - before)
        return dict(logits=logits_all, toks=toks, prefill_ms=prefill_ms,
                    step_ms=step_ms, launches=launches, pos=cache["pos"],
                    cache=cache)

    moe = model.cfg.is_moe
    kern_routes, kern_flips, flips = [], [0, 0], [0, 0]
    fa.launches = fa.tc_launches = fa.decode_launches = fa.fp32_launches = 0
    with (routing(base, kern_routes, routes, kern_flips) if moe
          else contextlib.nullcontext()), \
            (path_flash(label) if per_step else contextlib.nullcontext()):
        kern = run(feed)
    kern_launches, kern_fp32 = fa.launches, fa.fp32_launches
    check(all(n == per_step for n in kern["launches"]),
          f"{label}: decode steps launched flash {kern['launches']} times, "
          f"want {per_step} each")
    tc_launches, decode_launches = fa.tc_launches, fa.decode_launches
    check(kern_launches == per_prefill + per_step * steps
          and tc_launches == per_prefill - fp32_launches
          and kern_fp32 == fp32_launches
          and decode_launches == per_step * steps,
          f"{label}: flash launches {kern_launches} ({tc_launches} "
          f"bf16 and {kern_fp32} fp32 on the tensor cores, "
          f"{decode_launches} on the decode kernel, want {fp32_launches} "
          "of the prefill's on the fp32 kernel and every decode step's on "
          "the decode kernel)")
    check(kern["pos"] == s + steps, f"{label}: pos {kern['pos']}")
    prefills = [kern["prefill_ms"]]
    for _ in range(2):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, c = model.prefill(params, batch)
            torch.cuda.synchronize()
            prefills.append((time.perf_counter() - t0) * 1e3)
        del c
    peak = torch.cuda.max_memory_allocated()
    cache, tok = kern.pop("cache"), kern["toks"][-1][:, None]

    def one_step():
        with torch.inference_mode():
            model.decode(params, tok, cache)     # rewrites one position
    phase_profile(torch, one_step, card,
                  f"one decode step ({label}: {b} rows, {layers} layers, "
                  f"at position {s + steps})")
    del cache
    fa.launches = 0
    with mock.patch.object(ops, "attention", plain_attention), \
            (routing(base, [], kern_routes, flips) if moe
             else contextlib.nullcontext()):
        plain = run(feed=kern["toks"])
    check(fa.launches == 0, f"{label}: the plain run launched the kernel")
    worst, near, mism = compare_logits(kern["logits"], plain["logits"])
    check(worst <= tol, f"{label}: decode logits {worst} of "
          f"max|logit| from the plain run's, beyond {tol}")
    check(mism == 0, f"{label}: {mism} greedy tokens differ outside a near "
          "tie")
    ptoks = sum(int((lk.argmax(-1) != lp.argmax(-1)).sum())
                for lk, lp in zip(kern["logits"], plain["logits"]))
    dec_ms = statistics.median(kern["step_ms"])
    pre_ms = statistics.median(prefills)
    print(f"{label} ({b} prompts of {s}, cache {cache_len}, {steps} "
          f"lockstep steps, {layers} layers bf16): prefill ms (median of "
          f"3, {card}) {pre_ms:.1f} (runs {[round(x, 1) for x in prefills]})"
          f"; decode step ms (median of {steps}) {dec_ms:.2f} (first "
          f"{kern['step_ms'][0]:.2f}, last {kern['step_ms'][-1]:.2f}); "
          f"{b * 1e3 / dec_ms:.1f} tok/s decoding; flash launches "
          f"{kern_launches} ({per_prefill} in the prefill, {per_step} a "
          f"step, {decode_launches} on the decode kernel"
          + (f", {fp32_launches} of a call's fp32"
             if fp32_launches else "")
          + f"); peak {peak / 2**30:.2f} GiB "
          f"of {total_mem / 2**30:.1f}; against the plain attention "
          f"teacher-forced: logits within {worst:.3e} of max|logit| "
          f"(tolerance {tol}), greedy tokens differing {ptoks} "
          f"of {b * steps}, {near} plain-run near ties within the tolerance"
          + (f"; the plain run's own expert choices would differ in "
             f"{flips[0]} of {flips[1]} router rows" if moe else "")
          + (f" (this run's own from the forced ones in {kern_flips[0]} of "
             f"{kern_flips[1]})" if routes is not None else ""))
    return dict(pre_ms=pre_ms, dec_ms=dec_ms, peak=peak, worst=worst,
                launches=kern_launches, fp32_launches=kern_fp32,
                logits=kern["logits"],
                plain_logits=plain["logits"], toks=kern["toks"],
                routes=kern_routes, step_ms=kern["step_ms"])


def flash_figures(torch, card, case: dict) -> dict:
    """The flash kernel's line: phase 7's figures at the training path's
    launch (``case``), with the library time of
    ``scaled_dot_product_attention`` in its fastest form there (causal
    without a mask, the KV heads repeated)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(6)
    (b, s, h, hd), (_, _, kv, _), _ = case_shapes(
        FLASH_MODEL_CASES["tinyllama train"])
    q = torch.randn((b, h, s, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, kv, s, hd), generator=gen, device="cuda")
            .bfloat16().repeat_interleave(h // kv, dim=1) for _ in range(2))
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 5)
    print(f"flash_attention at the training path's launch: {case['ms']:.3f}"
          f" ms against library scaled_dot_product_attention causal, no "
          f"mask, {l_ms:.3f} ms  [{card}]")
    return dict(case, library_ms=l_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import tree
    from repro_torch.configs import tinyllama_1_1b as tl
    from repro_torch.core import arena as arena_mod, sparse
    from repro_torch.core.engine import FlareConfig, GradReducer
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sparse_accum as sa
    from repro_torch.kernels import topk_compact as tk
    from repro_torch.kernels import tree_reduce as tr
    from repro_torch.mesh import AXES, FLAT, TWO_LEVEL, RankMesh
    from repro_torch.models import base, transformer
    from repro_torch.switch import dataplane

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    total_mem = torch.cuda.get_device_properties(0).total_memory

    phase_build(kb, [tr.SOURCE, qt.SOURCE, sa.SOURCE, fa.SOURCE,
                     fa.BWD_SOURCE])
    # phase 37 first, while this process holds next to nothing on the card
    # (eight processes share it)
    print(json.dumps({"processes": phase_processes(
        torch, card, tl.CONFIG.scaled(n_layers=LAYERS), args.seed)}))
    phase_kernel_vs_plain(torch, ops)
    phase_quant_vs_plain(torch, ops, qt)
    phase_sparse_vs_plain(torch, ops, tk, sa, sparse)
    phase_flash_vs_plain(torch, ops, ref, fa, base)
    flash_cases = phase_flash_model_cases(torch, fa, ref, card)
    phase_flash_partial_vs_plain(torch, ref, fa)
    bwd_cases = phase_flash_bwd(torch, fa, ref, card)

    # -- the dense main path: (2, 4) mesh, full width -----------------------
    cfg = tl.CONFIG.scaled(n_layers=LAYERS)
    mesh = RankMesh(TWO_LEVEL, AXES)
    innet = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                    reproducible=True), mesh)
    wire = GradReducer(FlareConfig(axes=AXES, algorithm="fixed_tree",
                                   reproducible=True), mesh)
    grads = make_grads(torch, tree, transformer, cfg, mesh.shape, args.seed)
    # the tree's shapes without its storage, for the arena plans below
    params_like = tree.map_leaves(
        lambda g: torch.empty(g.shape, device="meta"), grads)
    leaves = tree.flatten(grads)[0]
    n_params = sum(l[0, 0].numel() for l in leaves)
    print(f"model: {cfg.name} at published widths, {LAYERS} of "
          f"{tl.CONFIG.n_layers} layers, {n_params} fp32 parameters "
          f"({n_params * 4 / 1e9:.3f} GB per rank), mesh {mesh.shape}")

    tree_rec = Recorder(tr, "tree_reduce_slots",
                        lambda x: (tuple(x.shape), x.stride(), x.dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.launches = tr.flat_launches = 0
    with tree_rec.patch():
        out, _ = innet(grads)
    torch.cuda.synchronize()
    launches = {"tree_reduce_slots": tr.launches,
                "tree_reduce": tr.flat_launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches["tree_reduce_slots"] > 0,
          "the main path launched no tree_reduce kernel")
    out_leaves = tree.flatten(out)[0]
    print(f"main path: GradReducer innetwork reproducible on {mesh.shape}: "
          f"tree_reduce_slots launches {launches['tree_reduce_slots']}, "
          f"shapes {[s for s, _, _ in tree_rec.seen]}")

    with mock.patch.object(ops, "tree_reduce_slots",
                           ops.tree_reduce_slots_plain):
        before = tr.launches
        plain, _ = innet(grads)
        check(tr.launches == before, "the plain-fold run launched the kernel")
    plain_leaves = tree.flatten(plain)[0]
    check(all(same_bits(a, b) for a, b in zip(out_leaves, plain_leaves)),
          "kernel reduction != plain-fold reduction")
    del plain, plain_leaves
    wired, _ = wire(grads)
    check(all(same_bits(a, b) for a, b in zip(out_leaves,
                                               tree.flatten(wired)[0])),
          "in-network fixed tree != wire fixed tree")
    del wired
    worst = check_against_fp64(torch, leaves, out_leaves, 2)
    print("main path checks: bitwise == plain fold, bitwise == wire "
          f"fixed_tree, every rank identical; fp64 error <= "
          f"{worst:.3f} of the 3-level bound")

    # -- whole-reduction time (host clock around synchronised runs) ---------
    del out, out_leaves
    red_ms, red_all = timed(torch, lambda: innet(grads), 5)
    with mock.patch.object(ops, "tree_reduce_slots",
                           ops.tree_reduce_slots_plain):
        plain_red_ms, _ = timed(torch, lambda: innet(grads), 3)
    wire_ms, _ = timed(torch, lambda: wire(grads), 3)
    print(f"reduction ms (median of 5, {card}): innetwork kernel "
          f"{red_ms:.3f} (runs {[round(t, 3) for t in red_all]}); same with "
          f"plain fold {plain_red_ms:.3f}; wire fixed_tree {wire_ms:.3f}; "
          f"peak device memory {peak / 2**30:.2f} GiB of "
          f"{total_mem / 2**30:.1f}")

    phase_profile(torch, lambda: innet(grads), card,
                  "one dense reproducible reduction")

    # -- the flat (1, 8) mesh ---------------------------------------------
    flat = RankMesh(FLAT, AXES)
    fgrads = tree.map_leaves(lambda g: g.reshape(1, 8, *g.shape[2:]), grads)
    tr.launches = 0
    fout, _ = GradReducer(FlareConfig(axes=AXES, transport="innetwork",
                                      reproducible=True), flat)(fgrads)
    torch.cuda.synchronize()
    flat_launches = tr.launches
    check(flat_launches > 0, "the flat mesh launched no kernel")
    fwire, _ = GradReducer(FlareConfig(axes=AXES, algorithm="fixed_tree",
                                       reproducible=True), flat)(fgrads)
    check(trees_same_bits(fout, fwire),
          "flat mesh: in-network != wire fixed tree")
    print(f"flat mesh {flat.shape}: launches {flat_launches}, bitwise == "
          "wire fixed_tree")
    del fout, fwire, fgrads, grads, leaves
    torch.cuda.empty_cache()

    # -- the int8 main path: (2, 4) mesh, full width, two steps -------------
    int8_cfg = FlareConfig(axes=AXES, transport="innetwork",
                           compression="int8")
    red8 = GradReducer(int8_cfg, mesh)
    mk = lambda seed, shape=mesh.shape: make_grads(
        torch, tree, transformer, cfg, shape, seed)
    recs = {
        "quantize": Recorder(qt, "quantize", lambda x, qblock=QBLOCK: (
            tuple(x.shape), x.stride(), x.dtype, qblock)),
        "dequantize": Recorder(qt, "dequantize", lambda q, s, qblock=QBLOCK,
                               out_dtype=torch.float32, minuend=None,
                               out=None: (
            tuple(q.shape), minuend.dtype if minuend is not None
            else out_dtype, minuend is not None, out is not None
            and out is minuend)),
        "dequant_accum_slots": Recorder(qt, "dequant_accum_slots",
                                        lambda q, s, qblock=QBLOCK,
                                        wire_order=False: (
            tuple(q.shape), q.stride(), s.stride())),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in qt.launches:
        qt.launches[k] = 0
    g = mk(args.seed)
    r1, st1 = red8(g)                          # step 1: no state yet
    del g
    g = mk(args.seed + 1)
    with recs["quantize"].patch(), recs["dequantize"].patch(), \
            recs["dequant_accum_slots"].patch():
        r2, st2 = red8(g, st1)                 # step 2: the state carried
    del g, st1
    torch.cuda.synchronize()
    for k in ("quantize", "dequantize", "dequant_accum_slots",
              "dequant_accum"):
        launches[k] = qt.launches[k]
    peak8 = torch.cuda.max_memory_allocated()
    for k in ("quantize", "dequantize", "dequant_accum_slots"):
        check(launches[k] > 0, f"the int8 main path launched no {k} kernel")
    plan8 = arena_mod.build_plan(
        tree.flatten(r1)[0], int8_cfg.bucket_bytes,
        pad_multiple=red8._pad_multiple(8), lead_dims=2)
    grp = plan8.groups[0]
    per_step = {k: len(r.seen) for k, r in recs.items()}
    print(f"int8 main path: GradReducer innetwork int8 on {mesh.shape}, two "
          f"steps: arena B={grp.num_buckets} S={grp.bucket_elems}; launches "
          f"{ {k: launches[k] for k in recs} } (per step {per_step}); "
          f"designs {[dataplane.resolve_design(grp.bucket_elems)]}; peak "
          f"device memory {peak8 / 2**30:.2f} GiB of {total_mem / 2**30:.1f}")
    for k, r in recs.items():
        print(f"  {k} launches of step 2: {r.seen}")

    g = mk(args.seed)
    worst8 = check_quant_bound(torch, grp, tree.flatten(g)[0],
                               tree.flatten(r1)[0], mesh)
    del g

    def plain_steps(red, shape):
        patches = plain_quant_patches(qt, ops)
        before = dict(qt.launches)
        g = mk(args.seed, shape)
        p1, pst = run_plain(patches, lambda: red(g))
        g = mk(args.seed + 1, shape)
        p2, pst = run_plain(patches, lambda: red(g, pst))
        check(qt.launches == before, "the plain run launched a kernel")
        return p1, p2, pst

    p1, p2, pst2 = plain_steps(red8, mesh.shape)
    check(trees_same_bits(r1, p1), "int8 step 1 != plain twin")
    check(trees_same_bits(r2, p2), "int8 step 2 != plain twin")
    check(trees_same_bits(st2, pst2), "int8 state != plain twin")
    del p1, p2, pst2, r1
    print("int8 main path checks: both steps' results and the state bitwise "
          "== the plain twin (all four int8 entries on their plain "
          f"versions), at {LAYERS} layers; step 1 error <= {worst8:.3f} of "
          "the quantization bound")

    g = mk(args.seed + 1)
    red8_ms, red8_all = timed(torch, lambda: red8(g, st2), 5)
    print(f"int8 reduction ms with a state (median of 5, {card}): "
          f"{red8_ms:.3f} (runs {[round(t, 3) for t in red8_all]}); dense "
          f"reproducible {red_ms:.3f}; peak device memory int8 "
          f"{peak8 / 2**30:.2f} GiB, dense {peak / 2**30:.2f} GiB")
    phase_profile(torch, lambda: red8(g, st2), card,
                  "one int8 reduction with a state")
    del g, r2, st2
    torch.cuda.empty_cache()

    # the flat (1, 8) mesh, one step, against its plain twin
    fred8 = GradReducer(int8_cfg, flat)
    for k in qt.launches:
        qt.launches[k] = 0
    g = mk(args.seed, flat.shape)
    f1 = fred8(g)[0]                # the state, an arena, is not kept
    del g
    torch.cuda.synchronize()
    flat8 = dict(qt.launches)
    check(flat8["dequant_accum_slots"] > 0, "flat int8 launched no fold")
    patches = plain_quant_patches(qt, ops)
    g = mk(args.seed, flat.shape)
    pf1 = run_plain(patches, lambda: fred8(g))[0]
    del g
    check(trees_same_bits(f1, pf1), "flat int8 != plain twin")
    print(f"int8 flat mesh {flat.shape}: launches {flat8}, bitwise == "
          "plain twin")
    del f1, pf1
    torch.cuda.empty_cache()

    # the multi and tree designs on a reduced arena
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    arena = torch.randn((*mesh.shape, 6, 300_000), generator=gen,
                        device="cuda")
    for design in ("multi", "tree"):
        tr.launches = 0
        got = dataplane.switch_allreduce_int8(arena, mesh, AXES,
                                              design=design)
        torch.cuda.synchronize()
        twin = run_plain(plain_quant_patches(qt, ops) + [mock.patch.object(
            tr, "tree_reduce_slots", lambda x: ops.tree_reduce_slots_plain(
                x))], lambda: dataplane.switch_allreduce_int8(
                    arena, mesh, AXES, design=design))
        check(same_bits(got, twin), f"int8 {design} design != plain twin")
        per = dataplane.switch_allreduce_int8(arena, mesh, AXES,
                                              design=design, batched=False)
        check(same_bits(got, per), f"int8 {design}: batched != per-packet")
        print(f"int8 design {design} on a (2, 4, 6, 300000) arena: bitwise "
              "== plain twin and == the per-packet plane"
              + (f"; tree_reduce launches {tr.launches}"
                 if design == "tree" else ""))
    del arena, got, twin, per
    torch.cuda.empty_cache()

    # -- the sparse main path (§7): (2, 4) mesh, full width, two steps -------
    sparse_runs = {}
    for frac in SPARSE_FRACS:
        cfg_s = FlareConfig(axes=AXES, transport="innetwork",
                            sparse_k_frac=frac)
        reds = GradReducer(cfg_s, mesh)
        plan_s = arena_mod.build_plan(
            tree.flatten(params_like)[0], cfg_s.bucket_bytes,
            pad_multiple=reds._pad_multiple(8), lead_dims=2)
        grp_s = plan_s.groups[0]
        nb = grp_s.num_buckets
        spy = SparseSpy(dataplane, [0, nb // 2, nb - 1])
        rec = Recorder(sa, "sparse_accum_slots",
                       lambda i, v, size, indices_sorted=False: (
                           tuple(i.shape), i.stride(), size, indices_sorted))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in sa.launches:
            sa.launches[k] = 0
        tk.launches = 0
        with spy.patch(), rec.patch():
            g = mk(args.seed)
            r1, st1 = reds(g)                      # step 1: no state yet
            g = mk(args.seed + 1)
            r2, st2 = reds(g, st1)                 # step 2: the state carried
            del g, st1
        torch.cuda.synchronize()
        got_launches = dict(sa.launches, topk_compact=tk.launches)
        peak_s = torch.cuda.max_memory_allocated()
        check(got_launches["sparse_accum_slots"] > 0,
              f"the sparse main path (f={frac}) launched no "
              "sparse_accum_slots kernel")
        ks = [sparse.sparse_k(frac, e) for e in grp_s.valid_extents]
        print(f"sparse main path f={frac}: GradReducer innetwork sparse on "
              f"{mesh.shape}, two steps: arena B={nb} S={grp_s.bucket_elems}"
              f", k {min(ks)}..{max(ks)}; launches {got_launches}; "
              f"sparse_accum_slots launches {rec.seen}; collisions per "
              f"step (rank 0) {[int(c[0, 0]) for c in spy.collisions]}; "
              f"peak device memory {peak_s / 2**30:.2f} GiB of "
              f"{total_mem / 2**30:.1f}; per step, GiB allocated as the "
              f"plane starts and the peak so far as it returns "
              f"{[(round(a / 2**30, 2), round(b / 2**30, 2))
                  for a, b in spy.memory]}  [{card}]")
        worst_s, nchecked = check_sparse_kept(torch, spy.kept,
                                              sparse.SENTINEL)
        spy.kept = None

        # the same two steps with every sparse kernel on its plain version
        twin = SparseSpy(dataplane, [0])
        before = dict(sa.launches)
        with twin.patch():
            g = mk(args.seed)
            p1, pst = run_plain(plain_sparse_patches(sa, tk, ops),
                                lambda: reds(g))
            g = mk(args.seed + 1)
            p2, pst = run_plain(plain_sparse_patches(sa, tk, ops),
                                lambda: reds(g, pst))
            del g
        check(sa.launches == before, "the plain run launched a kernel")
        check(trees_same_bits(r1, p1), f"sparse f={frac} step 1 != plain")
        check(trees_same_bits(r2, p2), f"sparse f={frac} step 2 != plain")
        check(trees_same_bits(st2, pst), f"sparse f={frac} state != plain")
        check(all(torch.equal(a, b) for a, b in zip(spy.collisions,
                                                    twin.collisions)),
              f"sparse f={frac} collisions != plain")
        del p1, p2, pst, r1, twin
        torch.cuda.empty_cache()

        # the plane itself under per-level arrival permutations
        g = mk(args.seed)
        arena = grp_s.pack(tree.flatten(g)[0])
        del g
        base = dataplane.switch_allreduce_sparse(arena, mesh, AXES, ks)[0]
        perm = dataplane.switch_allreduce_sparse(
            arena, mesh, AXES, ks,
            arrival_perms=level_perms(dataplane, mesh, AXES, 5))[0]
        check(same_bits(base, perm), f"sparse f={frac}: arrival order "
              "changed the bits")
        del arena, base, perm
        torch.cuda.empty_cache()
        print(f"sparse main path f={frac} checks: both steps' results, the "
              "state and the collision counts bitwise == the plain twin; "
              f"on {nchecked} buckets x 8 ranks exactly k selected, no "
              "unselected magnitude above a selected one, fp64 error <= "
              f"{worst_s:.3f} of 8·2^-24·Σ|selected|; bitwise the same "
              "under per-level arrival permutations")

        g = mk(args.seed + 1)
        ms_s, all_s = timed(torch, lambda: reds(g, st2), 5)
        print(f"sparse reduction f={frac} ms with a state (median of 5, "
              f"{card}): {ms_s:.3f} (runs {[round(t, 3) for t in all_s]}); "
              f"sparse_accum_slots launches per reduction "
              f"{len(rec.seen) // 2}; peak {peak_s / 2**30:.2f} GiB")
        phase_profile(torch, lambda: reds(g, st2), card,
                      f"one sparse reduction (f={frac}) with a state")
        cap = Capture(sa, "sparse_accum_slots")
        with cap.patch():
            reds(g, st2)
        torch.cuda.synchronize()
        sparse_runs[frac] = {"launches": got_launches, "seen": cap.seen,
                             "ms": ms_s, "peak": peak_s}
        del g, r2, st2, cap
        torch.cuda.empty_cache()

    # the per-packet plane, the flat mesh and a densify before level 1, on
    # a reduced arena, against the batched plane on kernels and on plain
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    small = torch.randn((8, 6, 100_000), generator=gen, device="cuda")
    small[..., 5, 60_000:] = 0.0                  # a padded bucket tail
    small_cases = []
    for m in (mesh, flat):
        x = small.reshape(*m.shape, 6, 100_000)
        for frac in (0.01, 0.05, 0.1):
            ks = [sparse.sparse_k(frac, 100_000)] * 5 + [
                sparse.sparse_k(frac, 60_000)]
            runs = [dataplane.switch_allreduce_sparse(
                x, m, AXES, ks, with_stats=True, batched=bt,
                arrival_perms=level_perms(dataplane, m, AXES, 9) if not bt
                else None) for bt in (True, False)]
            runs.append(run_plain(plain_sparse_patches(sa, tk, ops),
                                  lambda: dataplane.switch_allreduce_sparse(
                                      x, m, AXES, ks, with_stats=True)))
            for r in runs[1:]:
                check(same_bits(r[0], runs[0][0]) and torch.equal(
                    r[2]["collisions"], runs[0][2]["collisions"]),
                      f"reduced arena {m.shape} f={frac}: planes disagree")
            small_cases.append(f"{m.shape} f={frac}")
    del small, x, runs
    torch.cuda.empty_cache()
    print(f"sparse planes on a (8, 6, 100000) arena: batched == per-packet "
          f"under arrival permutations == plain twin, results and "
          f"collisions bitwise, for {small_cases} (on (2, 4): root, "
          "mid-tree and leaf densify; on (1, 8): root and leaf)")

    # -- the SparCML sparsifier: blockwise_sparsify → sparse_accum ---------
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 4)
    xs = torch.randn(1 << 28, generator=gen, device="cuda")
    xs[: 1 << 20] = 0.0                            # all-zero blocks
    tk.launches = 0
    for k in sa.launches:
        sa.launches[k] = 0
    vs, gs = ops.blockwise_sparsify(xs, SPARCML_K)
    dense = ops.sparse_accum(gs, vs, xs.numel())
    torch.cuda.synchronize()
    launches["topk_compact"] = tk.launches
    launches["sparse_accum"] = sa.launches["sparse_accum"]
    check(launches["topk_compact"] > 0 and launches["sparse_accum"] > 0,
          "the sparsifier's round trip launched no kernel")
    pvs, pgs = run_plain(plain_sparse_patches(sa, tk, ops),
                         lambda: ops.blockwise_sparsify(xs, SPARCML_K))
    check(same_bits(vs, pvs) and torch.equal(gs, pgs),
          "blockwise_sparsify != plain")
    check(same_bits(dense, ops.sparse_accum_slots_plain(
        gs[None], vs[None], xs.numel())[0]), "round trip != plain")
    blocks = xs.view(-1, 512).abs().amax(dim=1)
    kept = gs >= 0
    check(int((dense != 0).sum()) == int(kept.sum()) == int(
        (blocks > 0).sum()), "the round trip lost or added entries")
    check(bool((vs[kept].abs() >= blocks[kept] * (1 - 2.0**-23)).all()),
          "a block's selected value is not its largest")
    def round_trip():
        v, g = ops.blockwise_sparsify(xs, SPARCML_K)
        return ops.sparse_accum(g, v, xs.numel())

    trip_ms = cuda_ms(round_trip, 10)
    print(f"sparsifier round trip on 2^28 fp32, k={SPARCML_K} a block of "
          f"512: launches topk_compact {launches['topk_compact']}, "
          f"sparse_accum {launches['sparse_accum']}; {int(kept.sum())} "
          "entries kept, each its block's largest magnitude; bitwise == "
          f"plain; {trip_ms:.3f} ms a round trip (blockwise_sparsify + "
          f"sparse_accum, CUDA events)  [{card}]")
    del pvs, pgs, blocks, kept, dense
    torch.cuda.empty_cache()

    # -- each kernel at the main paths' shapes --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    figures = {}

    def account(name, nbytes, k_ms, p_ms, l_ms, err, what):
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f = figures.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                      "bound_ms": 0.0, "library_ms": None,
                                      "max_abs_err": 0.0})
        f["ms"] += k_ms
        f["plain_ms"] += p_ms
        f["bound_ms"] += b_ms
        if l_ms is not None:
            f["library_ms"] = (f["library_ms"] or 0.0) + l_ms
        f["max_abs_err"] = max(f["max_abs_err"], err)
        lib = "" if l_ms is None else f"; library {l_ms:.3f} ms"
        print(f"{name} {what}: {k_ms:.3f} ms, {nbytes} bytes, bound "
              f"{b_ms:.3f} ms ({b_ms / k_ms:.1%} of the bound), "
              f"{nbytes / k_ms / 1e6:.0f} GB/s; plain {p_ms:.3f} ms{lib}  "
              f"[{card}]")

    def err_of(a, b):
        """Largest |a - b|, in pieces so that the fp64 copies stay small."""
        a, b = a.reshape(-1), b.reshape(-1)
        return max(float((a[i:i + (1 << 26)].double()
                          - b[i:i + (1 << 26)].double()).abs().max())
                   for i in range(0, a.numel(), 1 << 26))

    for shape, stride, dtype in tree_rec.seen:
        span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        x = torch.randn(span, generator=gen, device="cuda").to(
            dtype).as_strided(shape, stride)
        got, want = ops.tree_reduce_slots(x), ops.tree_reduce_slots_plain(x)
        check(same_bits(got, want), f"kernel != plain at {shape}")
        err = err_of(got, want)
        del got, want
        account("tree_reduce_slots", tr.bytes_moved(x),
                cuda_ms(lambda: ops.tree_reduce_slots(x), 10),
                cuda_ms(lambda: ops.tree_reduce_slots_plain(x), 5),
                cuda_ms(lambda: x.sum(1, dtype=torch.float32), 5), err,
                f"{shape} stride {stride}")
        del x
    # the flat form, off the main paths: one launch at a (4, 2^26) stack
    x = torch.randn((4, 1 << 26), generator=gen, device="cuda")
    got = ops.tree_reduce(x)
    want = ops.tree_reduce_slots_plain(x.reshape(1, 4, 1, -1)).reshape(-1)
    check(same_bits(got, want), "flat tree_reduce != plain at (4, 2^26)")
    account("tree_reduce", tr.bytes_moved(x.reshape(1, 4, 1, -1)),
            cuda_ms(lambda: ops.tree_reduce(x), 10),
            cuda_ms(lambda: ops.tree_reduce_slots_plain(
                x.reshape(1, 4, 1, -1)), 5),
            cuda_ms(lambda: x.sum(0, dtype=torch.float32), 5),
            err_of(got, want), "(4, 67108864), off the main paths")
    del x, got, want
    torch.cuda.empty_cache()

    for shape, stride, dtype, qblock in recs["quantize"].seen:
        span = 1 + sum((n - 1) * s for n, s in zip(shape, stride))
        x = torch.randn(span, generator=gen, device="cuda").to(
            dtype).as_strided(shape, stride)
        got, want = qt.quantize(x, qblock), ops.quantize_plain(x, qblock)
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
              f"quantize != plain at {shape}")
        err = max(err_of(got[0], want[0]), err_of(got[1], want[1]))
        del got, want
        account("quantize", qt.quantize_bytes(x, qblock),
                cuda_ms(lambda: qt.quantize(x, qblock), 5),
                cuda_ms(lambda: ops.quantize_plain(x, qblock), 2), None, err,
                f"{shape} stride {stride}")
        del x
        torch.cuda.empty_cache()
    for shape, dtype, residual, _ in recs["dequantize"].seen:
        n = 1
        for d in shape:
            n *= d
        q = torch.randint(-127, 128, (n,), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((n // QBLOCK,), generator=gen, device="cuda") + 0.5
        v = (torch.randn((n,), generator=gen, device="cuda").to(dtype)
             if residual else None)
        o = torch.empty((n,), dtype=dtype, device="cuda")
        got = qt.dequantize(q, s, QBLOCK, dtype, minuend=v)
        want = ops.dequantize_plain(q, s, QBLOCK, dtype, minuend=v)
        check(same_bits(got, want), f"dequantize != plain at {shape}")
        err = err_of(got, want)
        del got, want
        qv, sv = q.view(-1, QBLOCK), s.unsqueeze(-1)
        if residual:
            lib = lambda: torch.addcmul(v.view(-1, QBLOCK), qv, sv, value=-1)
        else:
            lib = lambda: torch.mul(qv, sv)
        account("dequantize", qt.dequantize_bytes(q, QBLOCK, dtype, residual),
                cuda_ms(lambda: qt.dequantize(q, s, QBLOCK, dtype, minuend=v,
                                              out=o), 5),
                cuda_ms(lambda: ops.dequantize_plain(q, s, QBLOCK, dtype,
                                                     minuend=v, out=o), 2),
                cuda_ms(lib, 5), err,
                f"{shape}{' residual' if residual else ''}")
        del q, s, v, o, qv, sv
        torch.cuda.empty_cache()
    for shape, qstride, sstride in recs["dequant_accum_slots"].seen:
        g_, p_, s_, e_ = shape
        qspan = 1 + sum((n - 1) * st for n, st in zip(shape, qstride))
        sshape = (g_, p_, s_, e_ // QBLOCK)
        sspan = 1 + sum((n - 1) * st for n, st in zip(sshape, sstride))
        q = torch.randint(-127, 128, (qspan,), generator=gen, device="cuda",
                          dtype=torch.int8).as_strided(shape, qstride)
        s = (torch.rand((sspan,), generator=gen, device="cuda") + 0.5
             ).as_strided(sshape, sstride)
        got = qt.dequant_accum_slots(q, s, QBLOCK)
        want = ops.dequant_accum_slots_plain(q, s, QBLOCK)
        check(same_bits(got, want), f"dequant_accum_slots != plain {shape}")
        err = err_of(got, want)
        del got, want
        account("dequant_accum_slots", qt.dequant_accum_bytes(q, QBLOCK),
                cuda_ms(lambda: qt.dequant_accum_slots(q, s, QBLOCK), 10),
                cuda_ms(lambda: ops.dequant_accum_slots_plain(q, s, QBLOCK),
                        2), None, err, f"{shape} stride {qstride}")
        del q, s
        torch.cuda.empty_cache()
    # and in the switch's order off the paths: one launch at (4, 2^28)
    q = torch.randint(-127, 128, (4, 1 << 28), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((4, (1 << 28) // QBLOCK), generator=gen,
                   device="cuda") + 0.5
    got, want = qt.dequant_accum(q, s, QBLOCK), ops.dequant_accum_plain(q, s)
    check(same_bits(got, want), "dequant_accum != plain at (4, 2^28)")
    account("dequant_accum (off the path)", qt.dequant_accum_bytes(
                q.reshape(1, 4, -1, QBLOCK), QBLOCK),
            cuda_ms(lambda: qt.dequant_accum(q, s, QBLOCK), 10),
            cuda_ms(lambda: ops.dequant_accum_plain(q, s), 2), None,
            err_of(got, want), "(4, 268435456), the switch's order")
    del q, s, got, want
    torch.cuda.empty_cache()

    # the sparse path's densify, on exactly the lists each fraction gave it
    launches["sparse_accum_slots"] = 0
    for frac, run in sparse_runs.items():
        launches["sparse_accum_slots"] += run["launches"][
            "sparse_accum_slots"]
        for (i, v, size, *rest), kw, _ in run["seen"]:
            srt = kw.get("indices_sorted", rest[0] if rest else False)
            got = sa.sparse_accum_slots(i, v, size, srt)
            want = ops.sparse_accum_slots_plain(i, v, size)
            check(same_bits(got, want), f"sparse_accum_slots != plain at "
                  f"{tuple(i.shape)}")
            err = err_of(got, want)
            del got, want
            g_, b_, e_ = i.shape
            ok = (i >= 0) & (i < size)
            flat_i = (torch.arange(g_ * b_, device="cuda").view(g_, b_, 1)
                      * size + i)[ok]
            flat_v = v[ok].float()
            buf = torch.empty(g_ * b_ * size, device="cuda")
            account("sparse_accum_slots", sa.sparse_accum_bytes(i, v, size),
                    cuda_ms(lambda: sa.sparse_accum_slots(i, v, size, srt),
                            10),
                    cuda_ms(lambda: ops.sparse_accum_slots_plain(i, v, size),
                            2),
                    cuda_ms(lambda: buf.zero_().index_put_(
                        (flat_i,), flat_v, accumulate=True), 5), err,
                    f"f={frac} {tuple(i.shape)} sorted={srt}, "
                    f"{int(ok.sum())} entries; library index_put_ "
                    "accumulate into a zeroed buffer, -1 entries removed")
            del flat_i, flat_v, buf, ok
        # the loop's names hold the last captured lists and result
        # (3.2 GiB at f = 0.05): free them with the captures
        del run["seen"], i, v, _
        torch.cuda.empty_cache()

    # the sparsifier's kernels at the round trip's shapes (2^28, k = 1);
    # topk_compact also at k = 8 and 64 (off the path: printed, not in the
    # JSON line, whose figure is the path's k)
    xb = xs.view(-1, 512)
    for k in (SPARCML_K, 8, 64):
        got = tk.topk_compact(xs, k)
        want = ops.topk_compact_plain(xs, k)
        check(same_bits(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"topk_compact != plain at 2^28, k={k}")
        err = err_of(got[0], want[0])
        del got, want
        account("topk_compact" if k == SPARCML_K
                else "topk_compact (off the path)",
                tk.topk_bytes(xs, k, 512),
                cuda_ms(lambda: tk.topk_compact(xs, k), 10),
                cuda_ms(lambda: ops.topk_compact_plain(xs, k), 2),
                cuda_ms(lambda: torch.topk(xb.abs(), k, dim=1), 5), err,
                f"(2^28,) k={k} block 512; library torch.topk per block "
                "(the same set, not the same order)")
    ok = gs >= 0
    gi, gv = gs[ok].long(), vs[ok]
    buf = torch.empty(xs.numel(), device="cuda")
    got = sa.sparse_accum(gs, vs, xs.numel())
    want = ops.sparse_accum_slots_plain(gs[None], vs[None], xs.numel())[0]
    check(same_bits(got, want), "flat sparse_accum != plain at 2^28")
    err = err_of(got, want)
    del got, want
    account("sparse_accum", sa.sparse_accum_bytes(gs, vs, xs.numel()),
            cuda_ms(lambda: sa.sparse_accum(gs, vs, xs.numel()), 10),
            cuda_ms(lambda: ops.sparse_accum_slots_plain(
                gs[None], vs[None], xs.numel()), 2),
            cuda_ms(lambda: buf.zero_().index_put_((gi,), gv,
                                                   accumulate=True), 5),
            err, f"({gs.numel()},) unsorted into 2^28, {int(ok.sum())} "
            "entries; library index_put_ accumulate into a zeroed buffer, "
            "-1 entries removed")
    del xs, xb, vs, gs, gi, gv, buf, ok
    torch.cuda.empty_cache()

    # -- the wire dense reductions: every schedule at full width ---------------
    phase_wire_reductions(torch, card, total_mem, cfg, args.seed)
    # -- the wire int8 and sparse reductions ---------------------------------
    lossy = phase_wire_lossy(torch, card, total_mem, cfg, args.seed)
    launches["dequant_accum"] = lossy["launches"]
    # the flat form in the wire's order, at the shapes the wire int8
    # reduction gave it (its every rank's and bucket's (P, n) stack in
    # one launch of the slot entry)
    for shape in lossy["shapes"]:
        g_, p_, s_, e_ = shape
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((g_, p_, s_, e_ // QBLOCK), generator=gen,
                       device="cuda") + 0.5
        got = qt.dequant_accum_slots(q, s, QBLOCK, wire_order=True)
        want = ops.dequant_accum_slots_plain(q, s, QBLOCK, wire_order=True)
        check(same_bits(got, want), f"wire-order dequant_accum != plain at "
              f"{shape}")
        err = err_of(got, want)
        del got, want
        account("dequant_accum", qt.dequant_accum_bytes(q, QBLOCK),
                cuda_ms(lambda: qt.dequant_accum_slots(q, s, QBLOCK, True),
                        10),
                cuda_ms(lambda: ops.dequant_accum_slots_plain(q, s, QBLOCK,
                                                              True), 2),
                None, err, f"{shape}, the wire order")
        del q, s
        torch.cuda.empty_cache()

    # -- the training step: the main path end to end ---------------------------
    trained = phase_train(torch, card, total_mem, tr)
    # -- and on the wire, the launcher's default --------------------------------
    dense_wire = phase_wire_train(torch, card, total_mem, trained)
    # -- on the wire with a lossy transport, and the remat policies ----------
    phase_lossy_train(torch, card, total_mem, dense_wire)
    phase_remat(torch, card, total_mem)
    # -- the in-network reduction over a lossy fabric --------------------------
    phase_lossy_fabric(torch, card, total_mem, cfg, args.seed, {
        "dense": (red_ms, peak), "int8": (red8_ms, peak8),
        "sparse": (sparse_runs[FABRIC_SPARSE]["ms"],
                   sparse_runs[FABRIC_SPARSE]["peak"])})
    # -- the shared switch: three tenants ------------------------------------
    phase_shared_switch(torch, card, total_mem, cfg, args.seed)
    # -- checkpoints, recovery and the flight recorder -----------------------
    phase_ft_obs(torch, card, total_mem, args.seed)
    # -- the health plane, and serving ---------------------------------------
    phase_health(torch, card, total_mem, args.seed)
    # phases 18-36 under decode_gate: every bf16 decode launch on
    # flash_decode_mma_kernel, its counter set to 0 here and read at the end
    fa.decode_mma_launches = 0
    gated = {}
    with decode_gate("phase 18", gated):
        phase_serve(torch, card, total_mem, args.seed)
    # -- the other decoder-only models: gemma2 trained and served, qwen3 ----
    with decode_gate("phase 19", gated):
        phase_train(torch, card, total_mem, tr, GEMMA_TRAIN_FLAGS,
                    GEMMA_TRAIN_LAYERS, phase=19)
    with decode_gate("phase 20", gated):
        phase_gemma_serve(torch, card, total_mem, args.seed)
    with decode_gate("phase 21", gated):
        phase_qwen_serve(torch, card, total_mem, args.seed)
    # -- the rest of the transformer: deepseek trained and served, the VLM --
    with decode_gate("phase 22", gated):
        phase_train(torch, card, total_mem, tr, DEEPSEEK_TRAIN_FLAGS,
                    DEEPSEEK_TRAIN_LAYERS, phase=22)
    with decode_gate("phase 23", gated):
        phase_deepseek_serve(torch, card, total_mem, args.seed)
    with decode_gate("phase 24", gated):
        vlm = phase_vlm_serve(torch, card, total_mem, args.seed)
    # -- the encoder-decoder and the attention-free model --------------------
    with decode_gate("phase 25", gated):
        phase_train(torch, card, total_mem, tr, WHISPER_TRAIN_FLAGS,
                    WHISPER_TRAIN_LAYERS, phase=25)
    with decode_gate("phase 26", gated):
        phase_whisper_serve(torch, card, total_mem, args.seed)
    with decode_gate("phase 27", gated):
        phase_train(torch, card, total_mem, tr, MAMBA_TRAIN_FLAGS,
                    MAMBA_TRAIN_LAYERS, phase=27)
    with decode_gate("phase 28", gated):
        phase_mamba_serve(torch, card, total_mem, args.seed)
    # -- the hybrid: zamba2 trained and served ------------------------------
    with decode_gate("phase 29", gated):
        phase_train(torch, card, total_mem, tr, ZAMBA_TRAIN_FLAGS,
                    ZAMBA_TRAIN_LAYERS, phase=29,
                    compare_layers=ZAMBA_COMPARE_LAYERS)
    with decode_gate("phase 30", gated):
        phase_zamba_serve(torch, card, total_mem, args.seed)
    # -- tensor and expert parallelism over model ---------------------------
    with decode_gate("phase 31", gated):
        tp = phase_tensor_parallel(torch, card, total_mem, tr)
    # -- the dry-run against the card, a head split, the examples ----------
    with decode_gate("phases 32-34", gated):
        phase_dryrun(torch, card, dense_wire)
        phase_head_split(torch, card)
        phase_examples(torch, card)
    # -- sharded serving: a sequence-split cache over model ------------------
    with decode_gate("phase 35", gated):
        sharded = phase_sharded_serve(torch, card, args.seed)
    with decode_gate("phase 36", gated):
        gemma_sharded = phase_gemma_sharded(torch, card, args.seed)
    launches["flash_decode_mma_kernel"] = fa.decode_mma_launches
    check_decode_gates(gated, launches["flash_decode_mma_kernel"])
    check_path_flash(torch)
    check_path_bwd(torch)
    # the backward kernel: its launches those of phase 9's 5 steps, its
    # figures phase 7's at the path's launch, against SDPA's backward
    launches["flash_attention_bwd"] = trained["bwd_launches"]
    figures["flash_attention_bwd"] = bwd_cases["tinyllama train"]
    # its two bf16 kernels on the tensor cores, each launched once a
    # backward: phase 7's figures at the path's launch, each kernel's
    # device time by the profiler beside its own bound and the error of
    # the gradients it writes; the plain backward computes all three
    for part, grads in (("flash_bwd_dkdv_wgmma", ("dk", "dv")),
                        ("flash_bwd_dq_wgmma", ("dq",))):
        tl = bwd_cases["tinyllama train"]
        check(part in tl["kernels_ms"], f"the profiler saw no {part} "
              f"kernel in the path's backward launch: {tl['kernels_ms']}")
        launches[f"{part}_kernel"] = trained["bwd_launches"]
        figures[f"{part}_kernel"] = dict(
            ms=tl["kernels_ms"][part], bound_ms=tl["kernel_bounds_ms"][part],
            plain_ms=tl["plain_ms"], library_ms=None,
            max_abs_err=max(tl["errs"][g] for g in grads))
    # the fp32 dK/dV and dQ kernels (three TF32 products on wgmma): their
    # launches those of phase 31's fp32 steps, their figures phase 7's at
    # TinyLlama's fp32 launch on 2x2x2
    for part, grads in (("flash_bwd_dkdv_tf32", ("dk", "dv")),
                        ("flash_bwd_dq_tf32", ("dq",))):
        tl = bwd_cases["tinyllama fp32 2x2x2"]
        check(part in tl["kernels_ms"], f"the profiler saw no {part} "
              f"kernel in the fp32 backward launch: {tl['kernels_ms']}")
        launches[f"{part}_kernel"] = tp["fp32_bwd_launches"]
        figures[f"{part}_kernel"] = dict(
            ms=tl["kernels_ms"][part], bound_ms=tl["kernel_bounds_ms"][part],
            plain_ms=tl["plain_ms"], library_ms=None,
            max_abs_err=max(tl["errs"][g] for g in grads))
    # the same fp32 kernels at the wide pairs, on a line of their own:
    # their launches those of phase 31's gemma2-2b and deepseek fp32
    # steps, their figures phase 7's at those steps' launches
    wide = {}
    for case, pair in (("gemma2 fp32 train global", (256, 256)),
                       ("deepseek fp32 train", (192, 128))):
        tl = bwd_cases[case]
        for part, grads in (("flash_bwd_dkdv_tf32", ("dk", "dv")),
                            ("flash_bwd_dq_tf32", ("dq",))):
            check(part in tl["kernels_ms"], f"the profiler saw no {part} "
                  f"kernel in {case}'s backward: {tl['kernels_ms']}")
            wide[f"{part}_kernel {pair}"] = dict(
                launches=tp["wide_fp32_bwd_launches"][pair],
                ms=tl["kernels_ms"][part],
                bound_ms=tl["kernel_bounds_ms"][part],
                plain_ms=tl["plain_ms"], library_ms=None,
                max_abs_err=max(tl["errs"][g] for g in grads),
                backward_ms=tl["ms"], backward_bound_ms=tl["bound_ms"],
                sdpa_backward_ms=tl["library_ms"])
    print(json.dumps({"fp32_backward_wide_pairs": wide}))
    # D (flash_bwd_dot_kernel), once a backward: its launches those of
    # phase 9's 5 steps, its figures the profiler's at the path's launch
    tl = bwd_cases["tinyllama train"]
    check("flash_bwd_dot" in tl["kernels_ms"], "the profiler saw no D "
          f"kernel in the path's backward launch: {tl['kernels_ms']}")
    launches["flash_bwd_dot_kernel"] = trained["bwd_launches"]
    figures["flash_bwd_dot_kernel"] = dict(
        ms=tl["kernels_ms"]["flash_bwd_dot"],
        bound_ms=tl["kernel_bounds_ms"]["flash_bwd_dot"],
        plain_ms=tl["dot_plain_ms"], library_ms=None,
        max_abs_err=tl["dot_err"])
    # the bf16 decode kernel: its launches those of phases 18-36, its
    # figures phase 7's at TinyLlama's decode, against SDPA
    check(flash_cases["tinyllama decode"]["route"] == "decode",
          "TinyLlama's decode launch is not on a decode kernel")
    figures["flash_decode_mma_kernel"] = flash_cases["tinyllama decode"]
    launches["flash_attention"] = (trained["launches"] + sharded["partial"]
                                   + gemma_sharded["partial"])
    figures["flash_attention"] = flash_figures(
        torch, card, flash_cases["tinyllama train"])
    # the fp32 kernel: its launches those of the VLM's serving run (its
    # prefill's cross layers over the fp32 vision embeddings), its figures
    # phase 7's at that launch, against SDPA in fp32
    launches["flash_fwd_tf32_kernel"] = vlm["fp32_launches"]
    figures["flash_fwd_tf32_kernel"] = flash_cases["vlm cross prefill fp32"]
    check(launches["flash_fwd_tf32_kernel"] > 0,
          "the VLM's serving run launched no fp32 flash kernel")

    print("kernel figures are per reduction: the sum over one reduction's "
          "launches (one step of the int8 path; for sparse_accum_slots one "
          "step at each sparse fraction; for dequant_accum one step of the "
          "hierarchical wire int8 reduction, its launches those of two); "
          "tree_reduce, sparse_accum and topk_compact are one launch each; "
          "flash_attention is one launch at the training path's shape, its "
          "launches those of 5 training steps and the partial launches of "
          "phases 35-36's sharded decode steps; flash_fwd_tf32_kernel (the "
          "fp32 flash forward, three TF32 products on the tensor cores) is "
          "one launch at the VLM's cross prefill, its launches those of "
          "the VLM's serving run, its library call SDPA in fp32; "
          "flash_attention_bwd (the backward of the training launches, "
          "which replaces XLA's autodiff of the reference's attend) is one "
          "backward at the training path's shape, its launches those of "
          "phase 9's 5 steps, its library call SDPA's backward; "
          "flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel are "
          "its bf16 dK/dV and dQ kernels in that launch (device time by "
          "the profiler, each against its own products' bound, plain_ms "
          "the whole plain backward, no single library call); "
          "flash_bwd_dkdv_tf32_kernel and flash_bwd_dq_tf32_kernel are its "
          "fp32 ones (three TF32 products on wgmma) at TinyLlama's fp32 "
          "launch on 2x2x2, their launches those of phase 31's fp32 steps; "
          "flash_bwd_dot_kernel is D = sum(dO * O) in that bf16 launch "
          "(device time by the profiler against its bytes; launched alone "
          "it is held against its plain fp32 sum, max_abs_err and "
          "plain_ms), its launches those of phase 9's 5 steps; "
          "flash_decode_mma_kernel (the bf16 decode kernel: mma.sync, a "
          "TMA ring, the splits joined in a cluster) is one launch at "
          "TinyLlama's decode (phase 7, against SDPA with the boolean "
          "mask), its launches every bf16 decode launch of phases 18-36")
    routes = [("tree_reduce_slots", "tree_reduce"),
              ("tree_reduce", "tree_reduce"), ("quantize", "quant"),
              ("dequantize", "quant"), ("dequant_accum_slots", "quant"),
              ("dequant_accum", "quant"), ("sparse_accum_slots", "sparse"),
              ("sparse_accum", "sparse"), ("topk_compact", "sparse"),
              ("flash_attention", "flash_attn"),
              ("flash_fwd_tf32_kernel", "flash_attn"),
              ("flash_attention_bwd", "flash_bwd"),
              ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd"),
              ("flash_bwd_dq_wgmma_kernel", "flash_bwd"),
              ("flash_bwd_dkdv_tf32_kernel", "flash_bwd"),
              ("flash_bwd_dq_tf32_kernel", "flash_bwd"),
              ("flash_bwd_dot_kernel", "flash_bwd"),
              ("flash_decode_mma_kernel", "flash_attn")]
    by_bytes = ("flash_bwd_dot_kernel", "flash_decode_mma_kernel")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=SOURCES[src],
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=figures[name]["max_abs_err"], ms=figures[name]["ms"],
        plain_ms=figures[name]["plain_ms"],
        bound_ms=figures[name]["bound_ms"],
        bound_by=("operations" if name.startswith("flash")
                  and name not in by_bytes else "bytes"),
        library_ms=figures[name]["library_ms"]) for name, src in routes]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
