#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--steps N] [--sweep-only]
    python3 chip_smoke.py --llava-only [--seed N]   # phase 12 alone
    python3 chip_smoke.py --training-only [--seed N]   # phase 13 alone
    python3 chip_smoke.py --whisper-only [--seed N]    # phase 14 alone
    python3 chip_smoke.py --zamba2-only [--seed N]     # phase 15 alone
    python3 chip_smoke.py --xlstm-only [--seed N]      # phase 16 alone
    python3 chip_smoke.py --sharded-only [--seed N]    # phases 4, 5, 17
    python3 chip_smoke.py --tp-only [--seed N]         # phase 18 alone
    python3 chip_smoke.py --mp-train-only [--seed N]   # phase 19 alone
    python3 chip_smoke.py --disagg-only [--seed N]     # phase 20 alone
    python3 chip_smoke.py --roofline-only [--seed N]   # phase 21 alone
    python3 chip_smoke.py --tp-heads-only [--seed N]   # phase 22 alone

Phases, one line each (a failed check raises and the run exits non-zero):

1. the card (``nvidia-smi`` name and power limit) -- exits 2 without CUDA;
2. the build of the hand-written kernels (one ``nvcc`` per source, in
   parallel; ptxas summary, and the registers and spills of the bf16 flash
   kernels, the flash backward's wgmma kernels, the bulk gather and the
   FusedMM ring, none of which may spill, nor may the four (q/k 192, v
   128) and the four (256, 256) flash instantiations), then ``cuobjdump
   -sass`` of the library: the 8 bf16 flash kernels, the (192, 128) and
   (256, 256) ones among them, and the 12 flash backward wgmma kernels
   (dK/dV and dQ at 64, 80, 128, causal or not) must hold wgmma
   (``HGMMA``) and TMA load (``UTMALDG``) instructions, the
   bulk gather and every FusedMM ring kernel bulk copies (``UBLKCP``), and
   each flash kernel's KV tile, by dtype and q/k width, must be
   ``kv_tile``'s;
3. each kernel against its plain PyTorch version on the card over a sweep
   (SLS: add/max/min, weights with (x)=mul/add, bf16, empty segments,
   seg_base; gather: block_rows=4, E=5/96/2048, uniform, all-equal and
   Zipf ids, both variants; FusedMM: identity/relu, f32/bf16,
   E=5/8/64/100/128/520/1024, empty segments and segments longer than the
   ring, zero segments, both variants; flash attention: causal or not, GQA
   groups 1/4/16, (q/k, v) widths (64, 64), (80, 80), (112, 112), (128,
   128), (192, 128) and (256, 256), S=256, a ragged 200 and 200 queries
   over 328
   keys, f32/bf16, then sliding windows of 1, 100, 128, 129, 1024 and
   Sq - 1 keys at widths 80, 128 and 256 over 1300 keys and 200 queries
   over 328, where a window of Sk or more must give the bits of none;
   tables not 16-byte aligned; bf16 held by
   ``kernels.agreement.check_bf16``), the block gather's backward on the
   streams a token stream produces (one id repeated, all distinct, the last
   id, Zipf heads, roff; 1 to 30,000 ids into 9 to 262,144 blocks): the
   transposition kernel's order and ptrs equal to the argsort path's, the
   backward bit-equal to the parent's composition (argsort path +
   ``sls_kernel``), the bf16 flash kernel over 300
   causal cases of few-key rows (the six width pairs, with no window and
   windows of 1, 100, 128 and 129), and a small mixed program through the
   executor against the repo's numpy oracle (``program_reference``);
4. DLRM-DCNv2's sparse arch (26 SLS tables, dim 128, 2048 samples a step,
   rows capped at 10M per table, uniform ids) through
   ``executor_for(...).step`` for ``--steps`` steps, every op held against
   its plain per-op version, then the fused SLS unit's kernel against its
   plain version at that shape, and the times of the kernel, the plain
   version and ``F.embedding_bag``;
5. the same for DeepSeek-V2-Lite's step lookups (8 x 2048 tokens: token
   embedding, label gather, MoE dispatch, fused into one gather unit; the
   steps must run the bulk variant and its grouping pass once each a
   step), with ``torch.index_select`` as the library call, a contiguous
   ``copy_`` of the output's bytes as the rate the card streams, and the
   fused unit again on a realistic stream (Zipf(1.05) token ids, labels
   shifted by one, MoE dispatch a permutation of the capacity slots); the
   rows variant timed beside the bulk one on both streams;
6. GNN message passing at ogbn-products sizes (2,449,029 nodes, 123,718,280
   CSR entries, 100 fp32 features; a synthetic graph) as one ``fusedmm``
   program through ``executor_for(...).step``, fresh features each step
   (the steps must run the rows variant once each: at 400-byte rows it is
   faster than the ring), every output held against the plain version in
   chunks of segments, and the FusedMM kernel's time against its bound,
   against every neighbour row read from HBM, against ``F.embedding_bag``
   over the same reads and against a contiguous copy; both variants timed
   at that width and at other widths of the same graph;
7. chatglm3-6b (28 layers, full width, bf16, random weights) through
   ``LM.prefill`` over 4 x 4096 tokens: flash attention in every layer; in
   one more prefill every layer's kernel output is held against the plain
   version on that layer's own q, k, v (``check_bf16``), and the last
   hidden state against a prefill with plain attention; the kernel's time
   beside ``scaled_dot_product_attention``, also at one prefill_32k
   sequence; then stablelm-3b (32 layers, head dim 80, full width, bf16,
   random weights; chatglm3-6b freed first) over the same 4 x 4096
   tokens: flash at D = 80 in every layer, layer 0's kernel output held
   against the plain version, the kernel's time beside its bound and
   ``scaled_dot_product_attention``;
8. chatglm3-6b served (full width and depth, bf16, random weights):
   ``DecodeServer(batch_slots=8, max_len=512, prefill_chunk=16,
   pipeline=True)`` answers 16 requests (prompts of 32-64 uniform ids, 32
   new tokens each) through the server's CUDA graphs of the decode
   micro-step and the slot reset (``runtime.server.WaveGraph``), every
   decode-embed wave through the block gather (bulk variant and its
   grouping pass once a wave).  Checked: every request ends ok with 32
   tokens; a drive at ``prefill_chunk=1`` emits the same tokens with
   bit-identical final logits; the latest-admitted request served alone
   emits the same tokens; one request's teacher-forced decode logits agree
   with ``LM.forward`` (the flash prefill path) within phase 7's
   relative-L2 bound, with the same argmax wherever the top-2 margin
   exceeds that bound times the row's RMS; the group's outputs with
   ``backend="cuda"`` equal ``backend="torch"`` and ``embed[tokens]`` bit
   for bit; and the same 16 requests through a graph server and an eager
   server (``LM.wave_step`` / ``LM.reset_slots``) stepped in turn: every
   wave's logits, every cache leaf after every iteration and every token
   the same bits.  Printed: tokens/s, TTFT and per-token p50/p99, waves,
   host ms per wave and per micro-step (graph and eager, and the eager
   baseline beside them), device ms of one captured micro-step (CUDA
   events), the device busy share and top device operations
   (torch.profiler), peak device memory.  Then stablelm-3b served the
   same way (8 requests, 16 new tokens each), held to the eager wave the
   same way;
9. DeepSeek-V2-Lite (27 layers of MLA + MoE, full width, bf16, random
   weights; built once, stablelm-3b freed first): ``LM.prefill`` over the
   same 4 x 4096 tokens, a flash launch at (q/k 192, v 128) and an MoE
   un-dispatch gather in every layer, every layer's flash output held
   against the plain version on its own q, k, v (``check_bf16``) and its
   gather against the plain gather bit for bit, the last hidden state
   against a prefill with plain attention and the routing pinned to the
   kernel prefill's within a fixed bound that two planted faults (one
   layer's attention at the wrong scale, one KV tile's values lost) must
   exceed (and the routing decisions plain attention takes differently on
   its own), the flash kernel's time beside its bound, the plain version
   and ``scaled_dot_product_attention`` (each backend timed, or its
   refusal printed), the un-dispatch gather's (both variants) beside
   ``index_select`` and its bytes bound; then the model served as
   stablelm-3b is (8 requests, 16 new tokens), both pipeline members
   (decode-embed and MoE un-dispatch) fed every wave, the un-dispatch
   member held against the stock-op backend, the drive in lockstep with
   the eager wave, bit for bit, every gather launched eagerly there held
   against the plain gather bit for bit, and the gathers of every
   replayed micro-step counted in the device trace (the
   ``prefill_chunk=1`` check of phase 8 does not hold for an MoE model,
   in the reference either);
10. gemma3-4b (34 layers: 29 ``dense_local`` with a 1024-token window and
   5 ``dense``, head dim 256, vocab 262,144; full width, bf16, random
   weights): ``LM.prefill`` over 4 x 4096 tokens, 29 windowed and 5 causal
   (256, 256) flash launches, every layer's flash output held against the
   plain version on its own q, k, v, the last hidden state against plain
   attention (``PREFILL_REL_L2``); a planted fault (the local layer's
   kernel run with no window) must fail that layer's check, and a window
   off by one is read; the local and the global layer's flash time beside
   its bound, the plain version and ``scaled_dot_product_attention`` (the
   local one with an explicit band mask: the default backend and each
   that takes it); then served: ``DecodeServer(batch_slots=8,
   max_len=1536, prefill_chunk=16, pipeline=True)``, 8 requests of
   1024-1280 prompt tokens and 16 new tokens in a closed batch, through
   the captured wave, the decode-embed gather once a wave, and graph ==
   eager bit for bit (logits and every cache leaf) on the waves where the
   slots' caches pass the window and the first wave that decodes past it;
11. h2o-danube-1.8b (24 ``dense_local`` layers, window 4096, head dim 80;
   full width, bf16): ``LM.prefill`` over one 16384-token sequence,
   checked as phase 10's, and a layer's flash time at the true width;
12. llava-next-34b (60 layers, d_model 7168, 33.98 B parameters, 63.3 GiB
   in bf16) in a fresh process of this script with the card freed:
   ``LM.prefill`` over one 4096-token sequence with 576
   ``frontend_embeds`` rows spliced in, checked as phase 10's, the splice
   required to move the last hidden state, peak memory;
13. training (``phase_training``; ``--training-only`` runs it alone after
   the build): h2o-danube-1.8b at full width and TRAIN_LAYERS of its 24
   layers, one 8192-token sequence a step, lr 3e-4, 6 steps under ``run_supervised`` with a checkpoint every
   3 steps and a failure injected at step 4.  Checked: every loss finite,
   the restart's step-3 loss bit-equal to the first attempt's, the state
   restored from step 2's checkpoint equal leaf for leaf to the saved
   one, the flash backward launched in every layer of every step, every
   launch on the ``wgmma`` variant, and, on layer 0's captured q, k, v
   and dO, held against its variant's plain version (``plain_backward``:
   P and dS rounded to bf16, as the wgmma kernels take them;
   ``check_bf16``) and bit-equal to itself, a nonzero gradient for every
   parameter.  Printed: step ms and tokens/s, the device busy share of a
   profiled step, peak memory, checkpoint bytes and save / restore
   seconds, the backward's time (the wgmma kernels, and the SIMT ones on
   the same tensors through the wrapper's launch path, their gradients
   held against the SIMT variant's plain version, fp32 P and dS, by
   ``check_bf16``) beside its bound,
   the plain version and ``scaled_dot_product_attention``'s backward
   (``is_causal`` and a band mask, each its backward alone on a kept
   graph).  Then a reduced MoE model trained 3 steps on the card: the
   un-dispatch gather's backward (the transposition kernel and the sparse
   ``ember_sls`` variant), held against ``index_add_``, and timed apart
   there and at DeepSeek-V2-Lite's un-dispatch prefill shape; every
   training step also runs the token embedding's deterministic backward
   (one transposition and one ``ember_sls`` launch a step), timed apart at
   danube's shape.  At each shape (``_gather_backward_parts``): order and
   ptrs equal to the argsort path's, the backward bit-equal to the
   parent's composition, the sum held against ``ref.sls``, and the times
   of the wrapper, its two kernels, the parent's composition and its
   parts, ``index_add_`` and ``F.embedding_bag``;
14. whisper-large-v3 (``phase_whisper``; ``--whisper-only`` runs it alone
   after the build): 32 ``enc_dense`` and 32 ``xdec`` layers at full
   width (d_model 1280, 20 heads of 64, bf16, random weights).  Prefill:
   8 clips of 1500 frames and as many tokens through ``LM.prefill``, 32
   encoder, 32 causal self and 32 cross flash launches, each held against
   the plain version on its own q, k, v, the last hidden state against
   plain attention (``PREFILL_REL_L2``), the encoder's, a cross and a self
   layer's flash time beside its bound and SDPA.  Serving: encoded once,
   then ``LM.wave_step(batch_ctx=)`` over a 4-token prompt and 16 greedy
   tokens a slot into caches of 448 (the cross-attention at Sq = 1 in
   every layer of every micro-step); the drive at chunk 1 must give the
   same tokens and bit-identical final logits, a micro-step's cross
   launches are held against the plain version, every wave's logits hold
   to the same decode with plain attention on the drive's tokens within
   ``PREFILL_REL_L2``; tokens/s, a
   micro-step's time and the share of it the cross K/V projections take
   (torch.profiler).  Training: the Trainer over 1 x 1500 tokens and
   frames, 3 steps, twice from one seed: losses and every parameter
   bit-equal between the runs, 96 backward launches a step, all wgmma,
   one transposition and one sparse ``ember_sls`` launch a step (the
   embedding's backward), the encoder's layer-0 backward against
   ``plain_backward``, a nonzero gradient for every parameter; step ms,
   tokens/s, busy share, peak memory, the embedding's backward timed apart
   as in phase 13;
15. zamba2-7b (``phase_zamba2``; ``--zamba2-only`` runs it alone after the
   build): 81 layers at full width (68 ``mamba``, 13 ``shared_attn``
   sharing one attention and MLP set; d_model 3584, 32 heads of 112,
   ssm_state 64; bf16, random weights).  Prefill: 4 x 4096 tokens through
   ``LM.prefill``, 13 flash launches at (112, 112) (the (128, 128) kernel
   on zero-padded columns), each held against the plain version, the last
   hidden state against plain attention (``PREFILL_REL_L2``), a planted
   fault (the first shared layer's attention with its scale left out)
   required above that bound and to fail its layer's check; the device
   time by class (GEMMs, flash, the SSD scan, elementwise; torch.profiler)
   and one layer's SSD scan timed alone; the shared layer's flash time
   beside its bound and SDPA (each backend).  Serving: 8 requests of 256
   or 320 prompt tokens, 32 new tokens each, closed batch, through
   ``DecodeServer(batch_slots=8, max_len=512, prefill_chunk=16,
   pipeline=True)``'s captured waves: every request ok, the gather once a
   wave, ``prefill_chunk=1`` the same tokens and bit-identical logits,
   graph == eager in lockstep over the prompts' first quarters (logits and
   every cache leaf, the mamba state and conv window included); tokens/s,
   a captured micro-step's
   device ms against its weight bound, its device operations.  Forward
   == decode: each prompt's last-token logits from the chunked forward
   against the captured decode replay's within
   ``ZAMBA_FWD_DECODE_REL_L2``, which two planted decode faults (a mamba
   layer's decay skipped, another's conv window shifted by one) must
   exceed;
16. xlstm-1.3b (``phase_xlstm``; ``--xlstm-only`` runs it alone after the
   build): XLSTM_LAYERS of its 48 layers at full width (3 ``mlstm`` to
   1 ``slstm``; d_model 2048, 4 heads of 512, chunk 256; bf16, random
   weights), no attention.
   The first super-block in fp32 on the card against the CPU (1 x 512
   tokens, then 16 decode steps: hidden states, logits and every cache
   leaf within ``XLSTM_CARD_CPU_REL_L2``).  Prefill: 4 x 4096 tokens
   through ``LM.prefill`` (no hand-written kernel on it: the embedding's
   forward is ``index_select``), ms and peak memory; one layer of each
   kind at its shapes under torch.profiler, by class (GEMMs, the mLSTM
   scans, the sLSTM recurrence, elementwise), and alone the two scans of
   an mlstm layer and the 4096-step loop of an slstm layer.  Serving: as
   phase 15 (8 requests of 256 or 320 prompt tokens, 32 new tokens,
   captured waves, the gather once a wave, chunk 1 == whole and graph ==
   eager bit for bit over the prompts' first quarters, every cache leaf),
   a captured micro-step against its bound (the weights read once and
   the recurrent caches read and written once).  Training: the Trainer
   on 1 x 512 tokens, XLSTM_TRAIN_LAYERS of the 48 layers, 2 steps,
   twice from one seed,
   losses and
   parameters bit-equal, one
   transposition and one sparse ``ember_sls`` launch a step, a nonzero
   gradient for every parameter.  Forward == decode: the chunked
   forward's last-token logits and every layer's final state against the
   captured decode replay's, read in bf16 and held in fp32 within
   ``XLSTM_FWD_DECODE_REL_L2``, above which two planted decode faults
   (an mlstm layer's normaliser ``n`` left unupdated, an slstm layer's
   recurrent term dropped) must land;
17. the vocab-sharded executor (``phase_sharded``, run right after phase
   5, which it takes its tables, steps and outputs from;
   ``--sharded-only`` runs phases 4, 5 and 17): two ranks spawned into a
   gloo group over a file store, both on ``cuda:0``, the parent's tables
   reaching them by CUDA IPC, each building only its local table.  First
   a finding, printed: which gloo collectives take CUDA tensors
   directly.  A 1-wide mesh (data 2, model 1) is phase 4's single-device
   step bit for bit.  Then DLRM-DCNv2 at full width over 2 vocab shards,
   ``exchange="host"`` with replicated outputs and ``"collective"`` with
   owned ones, every op's whole output (owned slices all-gathered) within
   ``SHARDED_REL_L2`` (relative L2) of phase 4's; a Zipf(1.05) stream
   with a hot slab from a one-step warm-up trace and an
   ``AdaptiveHotConfig``, then one ``swap_hot_slab`` to a drifted
   stream's head, held against the plain per-op SLS before and after, the
   hot share above and the wire bytes a step below the uniform stream's,
   the slab epoch and hot set equal on both ranks; DeepSeek-V2-Lite's
   lookups (phase 5's first ``SHARDED_DEEPSEEK_STEPS`` steps) in both
   exchanges, bit for bit.  Each rank's local table at most half the
   stack plus its hot slab (and a pad row a slot).  The local
   ``ember_sls`` pool, the ``ember_transpose`` lattice rebuild and the
   local block gather at the sharded path's shapes held against their
   plain versions.  Printed per rank and drive: step ms (host clock,
   synchronised), the collectives' calls, staged MB and ms, the
   ``exchange_*`` statistics, the launches, compile seconds, local table
   GB, peak memory and the card's;
18. tensor and expert parallelism of the LM (``phase_tp``; ``--tp-only``
   runs phases 1, 2 and 18): two ranks spawned into a gloo group, both on
   ``cuda:0``, each building its slices of ``LM(cfg, seed,
   shard=ShardCtx(mesh))`` from the phase's seed.  chatglm3-6b at full
   width: the 2 x 512 prefill's last hidden state within TP_REL_L2 of the
   single device's, the first layer's flash output on the rank's heads
   (16 query heads over one KV head) against the plain version, the
   teacher-forced micro-steps' logits within TP_REL_L2, and a
   DecodeServer on each rank (eager: gloo collectives are staged through
   the host) whose tokens are equal on both ranks, counted against the
   single device's, its executor vocab-sharded over 2; the masked
   lookup's block gather against the plain gather.  qwen3-moe-235b-a22b's
   widths at TP_MOE_LAYERS layers: the seq-split prefill against
   ``moe_ffn_ep_plain`` and the replicated-token micro-steps against the
   single device, routing pinned to the ranks', the routing decisions
   that differ unpinned counted.  Printed per rank: prefill and
   micro-step ms, collectives and staged MB, peak GiB, beside the card;
   and the ``[18 tp predicted]`` block written before the first run;
19. model-parallel training (``phase_mp_train``; ``--mp-train-only`` runs
   phases 1, 2 and 19): (a) h2o-danube-1.8b at full width and MP_DEPTH
   of its 24 layers over
   two gloo ranks (mesh (1, 2)) sharing the card, each building its half
   of ``LM(cfg, seed)``, MP_STEPS trainer steps of 1 x TRAIN_SEQ tokens
   (phase 13's shape): step 0's loss against the single device's on the
   same batch (MP_LOSS_REL), the gradients of MP_GRAD_LEAVES (the ranks'
   slices joined) within TRAIN_GRAD_REL_L2 of the single device's, the
   ranks' losses bit-equal, the flash backward all ``wgmma`` and the
   gather backward ``sparse``; on rank 0 the flash forward and backward
   at a rank's shapes (16 query heads over 4 KV heads) and the masked
   lookup's gather and its backward on the rank's 16,000 rows held to
   their plain versions and timed beside their bounds, SDPA's backward
   and ``index_add_``.  (b) its widths at MP_LAYERS layers over four
   ranks (mesh (2, 2), ZeRO-1 ``in_shardings``), global batch MP_BATCH x
   MP_SEQ, under ``run_supervised`` (a sharded checkpoint every
   MP_SUP_EVERY steps, a failure at MP_SUP_FAIL): the restart's step-2
   loss bit-equal to the first attempt's, the 4-rank checkpoint restored
   onto one device equal to the ranks' joined state leaf for leaf, and
   with ``shardings=`` onto a (1, 2) mesh each rank's slice.  Printed:
   step ms, collectives, staged MB and their ms a step, peak GiB a rank,
   launches by kernel and variant, beside the card; and the ``[19 mp
   predicted]`` block written before the first run;
20. the disaggregated embedding tier and serving artifacts
   (``phase_disagg``; ``--disagg-only`` runs phases 1, 2 and 20):
   chatglm3-6b at full width and depth served with phase 8's settings,
   DISAGG_REQUESTS requests, in process (a) and with its decode-embed
   member over ``ServicePool(2, device="cuda")`` (b), interleaved: every
   request ok with the same tokens, every wave's replica outputs == the
   in-process group's == ``embed[tokens]`` bit for bit (the replicas' bulk
   gather held to its plain version), one bulk gather and one grouping
   pass a disagg wave in the replicas (read from their pings, which must
   name the card and no JAX module), ``rpc_steps`` > 0, no stale step; a
   replica killed mid-drive (no request fails, no wave fault, the respawn
   re-warms its tables and its compile from the artifacts); every replica
   dark (``degrade_policy="fail"`` raises ``ServiceUnavailable``,
   ``"stale"`` serves the same bits locally); two server boots from one
   ``artifact_dir`` (fresh, then loaded; the same tokens).  Printed:
   tokens/s and per-token p50/p99 of each drive, the wire bytes a wave,
   the replicas' peak memory, the recovery seconds, each boot's time to
   first token, beside the card; and the ``[20 disagg predicted]`` block
   written before the first run;
21. the dry run and the roofline (``phase_roofline``; ``--roofline-only``
   runs phases 1, 2 and 21): the ``[21 roofline predicted]`` block
   (ROOFLINE_PREDICTED and each recorded time's share of its analytic
   bound, from ``roofline/analysis.py``), written before the first run;
   (a) chatglm3-6b at full width and ROOFLINE_A_LAYERS layers, 1 x
   ROOFLINE_A_SEQ, its prefill and one training step (remat "dots")
   counted by the dry run on meta over a 1 x 1 mesh and run on the card
   under the same FLOP counter: the ``mm``-family FLOPs equal, and the cost
   pass's attention FLOPs equal to ``analytic_flops``'s attention term;
   (b) h2o-danube-1.8b at full width and ROOFLINE_B_LAYERS layers, 1 x
   TRAIN_SEQ, one step under remat none, dots and full: the loss and every
   gradient bit-equal, dots and full peaking below none, each step's time
   and peak beside the dry run's predicted peak (ROOFLINE_PEAK_BAND);
   (c) the measured times of phases 7, 7 stablelm, 12 and 13 over their
   cells' roofline bounds, with ``model_flops`` and ``analytic_flops``;
   every line beside the card's name and power limit;
22. the attention kinds over any model axis (``phase_tp_heads``;
   ``--tp-heads-only`` runs phases 1, 2 and 22), gloo ranks sharing the
   card, each building its slices of ``LM(cfg, seed, shard=)`` by the head
   plan: (a) chatglm3-6b at full width and depth over four ranks (8 query
   heads over a copy of one KV head a rank): the TPH_PREFILL prefill's
   last hidden state and TPH_TF_STEPS teacher-forced micro-steps' logits
   within TP_REL_L2 of the single device's, the first layer's flash on the
   rank's heads against the plain version, TPH_REQUESTS served requests
   with the same tokens on every rank, and one training step at
   TPH_TRAIN_LAYERS layers: the loss (MP_LOSS_REL) and every gradient, the
   ranks' slices joined by the plan (TRAIN_GRAD_REL_L2), against the
   single device's, every KV copy's gradient and stepped parameter
   bit-equal across its group; (b) DeepSeek-V2-Lite at full width and
   TPH_DS_LAYERS layers over two ranks: the first MLA layer's forward and
   a decode micro-step against the single device's, the prefill against
   ``moe_ffn_ep_plain`` and the micro-steps against the single device with
   the routing pinned to the ranks' (phase 18's way), and a served drive
   equal on both ranks, then one training step (a ``TrainStep`` of 1 x
   TPH_DS_PREFILL[1] tokens, AdamW's step included) on the same ranks: the
   loss (MP_LOSS_REL) and every gradient, the ranks' slices joined by the
   plan (TRAIN_GRAD_REL_L2), against one process running each MoE layer as
   ``moe_ffn_ep_plain(n=2)`` with the routing pinned to the ranks', the
   leaves whole on both ranks bit-equal in gradient and stepped
   parameter, the step's launches of the un-dispatch gather, its
   backward (transposition, sparse sum) and the (192, 128) SIMT flash
   backward required, and the step's first un-dispatch gather's and
   first masked lookup's backward (their ids, rows and captured
   cotangents) held to ``index_add_`` in fp32 (``check_bf16``); a second,
   warm step is timed beside the first, each split into
   ``loss_and_grads`` and ``apply_``; (c) whisper-large-v3 at full width and depth over
   two ranks: the 1 x TPH_WHISPER_FRAMES encoder + decoder forward and
   decode micro-steps with the encoder context against the single
   device's, and one training step at TPH_WHISPER_TRAIN_LAYERS + the same
   encoder layers held as (a)'s; (d) zamba2-7b at full width and
   TPH_ZAMBA_LAYERS layers over the same two ranks (16 of its 32 SSM
   heads and 16 of its 32 attention heads a rank, each mamba layer's B | C
   columns copied): an fp32 1 x TPH_ZAMBA_F32_SEQ prefill whose every
   layer, fed one process's input to it, is within TPH_ZAMBA_F32_REL_L2 of
   one process's (the run-through within TPH_ZAMBA_F32_FREE_REL_L2, its
   reading after each layer printed beside the chaos floor), an fp32
   served drive whose tokens equal one process's, a timed bf16 TPH_PREFILL
   prefill (its distance from one process printed), and the rank's f32
   and bf16 flash calls at (112, 112) held to the plain version, their
   launches and the masked lookup's block gather (with its grouping pass)
   required.  Rank 0 times the flash layer at each
   new shape (chatglm3-6b's 8 over 1 KV head, MLA's (192, 128) on 8 heads,
   whisper's encoder (64, 64) on 10, not causal, zamba2's (112, 112) on
   16) beside the plain version,
   the bound and SDPA, and MLA's (192, 128) SIMT flash backward at the
   rank's shape beside its bound, the plain backward and SDPA's.  Printed per rank: step and forward ms, collectives
   and staged MB, peak GiB, beside the card; and the ``[22 tp heads
   predicted]`` block written before the first run;
23. one JSON line listing the kernels with the kernel (variant) that
   ran on the main path, its launches there (the gather's include the
   served waves of every model and DeepSeek's un-dispatch gathers,
   flash's the stablelm-3b, DeepSeek, gemma3-4b, h2o-danube-1.8b and
   llava-next-34b prefills, the training steps and whisper's prefill,
   served micro-steps and training steps, zamba2-7b's prefill and
   served waves, and xlstm-1.3b's served waves, with flash's
   ``instances``: the launches by dtype, widths, causal and window; sls's
   DLRM's and the gather backwards' that ran ``sls_kernel``), the flash
   backward (``flash_attention_bwd``, its launches by instance: danube's
   and whisper's), the gather backward's transposition
   (``gather_transpose``) and sparse sum (``sls_sparse``), each with its
   launches in the danube, reduced MoE, whisper and xlstm trainings and
   its times at the five shapes, error, times and bounds; phase 17's
   launches as ``sharded_launches`` of ``sls``, ``block_gather`` and
   ``gather_transpose`` (counted in ``launches`` too); phase 18's as
   ``tp_launches`` of ``flash_attention`` and ``block_gather`` (counted in
   ``launches`` too), with the flash kernel's time at the rank's shapes;
   phase 19's as ``mp_launches`` of ``flash_attention``,
   ``flash_attention_bwd``, ``block_gather``, ``gather_transpose`` and
   ``sls_sparse`` (counted in ``launches`` too), with the flash backward's
   and the gather backward's times at a rank's shapes; phase 20's replica
   gathers as ``disagg_launches`` of ``block_gather`` (counted in
   ``launches`` too); phase 21's as ``roofline_launches`` of
   ``flash_attention`` and ``flash_attention_bwd`` and ``roofline`` in the
   ``launches_by_training`` of ``gather_transpose`` and ``sls_sparse``
   (counted in ``launches`` too); phase 22's as ``tp_heads_launches`` of
   ``flash_attention``, ``flash_attention_bwd`` and ``block_gather`` and
   ``tp_heads`` in the ``launches_by_training`` of ``gather_transpose`` and
   ``sls_sparse`` (counted in ``launches`` too; DeepSeek's training step
   among them), with the flash layers' times at the ranks' new shapes
   (``tp_heads_flash_layers``) and the MLA backward's
   (``tp_heads_mla_bwd`` of ``flash_attention_bwd``);
24. ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# DLRM-DCNv2, the MLPerf Training "recommendation" benchmark (torchrec
# examples/dlrm_v2, Criteo 1TB multi-hot): rows per table and multi-hot
# sizes as published; the one cut is rows <= 10M per table (hash-mod, as
# --max-ind-range does), so the stacked tables fit one 80 GB card.
DLRM_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
             40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
             40000000, 40000000, 40000000, 590152, 12973, 108, 36)
DLRM_MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                  12, 100, 27, 10, 3, 1, 1)
DLRM_DIM = 128
# phase 17: DLRM's Zipf stream (the exponent of ROADMAP's locality runs),
# its two heads (the rank -> row multipliers of two streams: primes that
# divide no table size), the hot slab a table and the relative L2 bound
# of the sharded outputs against the single device (fp32 sums in another
# order)
SHARDED_ZIPF = 1.05
SHARDED_HEAD_A, SHARDED_HEAD_B = 1_000_003, 2_000_003
SHARDED_SLAB_BYTES = 16 << 20
SHARDED_ZIPF_STEPS = 3
SHARDED_DEEPSEEK_STEPS = 2
SHARDED_REL_L2 = 2e-5
# phase 18: tensor and expert parallelism over two gloo ranks on the card.
# chatglm3-6b at full width: a 2 x 512 prefill (each of its 57 activation
# collectives stages 16 MB of fp32 partials through the host), teacher-
# forced micro-steps (TP_TF_PROMPT prompt tokens, then the single
# device's argmax) and TP_REQUESTS requests of TP_PROMPT_MIN..MAX prompt
# tokens served per rank; qwen3-moe-235b-a22b's widths at TP_MOE_LAYERS of
# its 94 layers (9.66 GB of experts; the model fits no card): a 1 x 256
# prefill and TP_MOE_DECODE micro-steps.  bf16 over 28 random layers: the
# hidden state and logits are held at ROADMAP's bf16 bound
TP_PREFILL = (2, 512)
TP_SLOTS, TP_MAX_LEN = 4, 128
TP_TF_PROMPT, TP_TF_STEPS = 8, 16
# (8 new tokens a request: 16 took ~20 s of eager, host-bound waves, cut
# so that phase 19 fits the script's time; prompts of 32-48 tokens, from
# 64-96, whose eager prefill waves took most of the 20 s left, cut so
# that phase 20 fits)
TP_REQUESTS, TP_PROMPT_MIN, TP_PROMPT_MAX, TP_NEW_TOKENS = 4, 32, 48, 8
TP_MOE_LAYERS, TP_MOE_PREFILL, TP_MOE_DECODE = 2, (1, 256), 4
TP_REL_L2 = 5e-2
# written before the first run on the card (PERF.md, its tensor-parallel
# findings): each staged all-reduce of the prefill's 16 MB fp32 partials
# ~10-20 ms (two 16 MB copies over PCIe-class host paths and a gloo sum
# over loopback), 57 of them; a micro-step's 58 collectives of <= 64 KB
# ~0.5-1 ms each
TP_PREDICTED = {"chatglm3 2x512 prefill": "~1,000-2,000 ms (collectives "
                                          "> 90 %)",
                "chatglm3 micro-step": "~40-70 ms (eager, collectives "
                                       "> 80 %)",
                "qwen3-moe 1x256 prefill": "~100-300 ms",
                "qwen3-moe micro-step": "~10-30 ms",
                "prefill relative L2": "~5e-3 (fp32 row-parallel sums)",
                "peak a rank": "~7 GiB chatglm3, ~8 GiB qwen3-moe"}
# model-parallel training: (a) h2o-danube-1.8b at full width and
# MP_DEPTH of its 24 layers over two ranks (mesh (1, 2)), MP_STEPS steps
# of 1 x TRAIN_SEQ (all 24 until its steps and the single device's were
# cut with phase 13's, so that phase 20 fits);
# (b) its widths at MP_LAYERS layers over four ranks (mesh (2, 2), ZeRO-1),
# a global batch of MP_BATCH x MP_SEQ, MP_SUP_STEPS steps under
# run_supervised, a checkpoint every MP_SUP_EVERY, a failure at MP_SUP_FAIL
# (the restart resumes from step 1 and reruns step 2)
MP_STEPS, MP_DEPTH = 2, 3          # 6 before phase 21 was added
MP_LAYERS, MP_BATCH, MP_SEQ = 2, 2, 2048
MP_SUP_STEPS, MP_SUP_EVERY, MP_SUP_FAIL = 4, 2, 3
# step 0's loss against the single device's (relative): bf16 over the
# layers, the ranks' fp32 partial sums rounded once where the single
# device's GEMM rounds once
MP_LOSS_REL = 1e-2
MP_GRAD_LEAVES = ("embed", "final_norm") + tuple(
    f"blocks.{li}.{n}" for li in (0, MP_DEPTH - 1)
    for n in ("norm1", "attn.wq", "attn.wo", "mlp.wi_gate"))
# written before the first run on the card (PERF.md, the model-parallel
# training findings): a step of (a) stages 24 layers x 4 fp32 all-reduces
# of 84 MB (the two row-parallel sums forward, the two entries' gradients
# backward) plus the lookup and the loss's dx, ~8.2 GB of payload at the
# ~1.6 ms a MB the tensor-parallel prefill's staged collectives took
MP_PREDICTED = {"danube 1x8192 step over 2 ranks": "~10-15 s, > 90 % in "
                                                   "staged collectives",
                "staged payload a step": "~8.2 GB",
                "peak a rank": "~18-28 GiB",
                "step-0 loss vs the single device": "~1e-3 relative",
                "gradients vs the single device": "~1e-2 relative L2",
                "2-layer (2, 2) ZeRO-1 step (2 x 2048)": "~1-2 s"}
# the attention kinds over any model axis (phase 22), gloo ranks sharing
# the card: (a) chatglm3-6b at full width and depth over four ranks (its 2
# KV heads each copied on 2 ranks, 8 query heads a rank): a TPH_PREFILL
# prefill, TPH_TF_STEPS teacher-forced micro-steps, TPH_REQUESTS served
# requests, and one training step of 1 x TPH_TRAIN_SEQ at TPH_TRAIN_LAYERS
# of its 28 layers; (b) DeepSeek-V2-Lite at full width and TPH_DS_LAYERS of
# its 27 layers over two ranks (8 of its 16 MLA heads a rank, the latent
# whole): one MLA layer's forward and decode micro-step, a TPH_DS_PREFILL
# prefill and TPH_DS_DECODE micro-steps with the routing pinned (phase
# 18's way), TPH_DS_REQUESTS served requests; (c) whisper-large-v3 at full
# width and depth over two ranks (10 of its 20 heads a rank): a 1 x
# TPH_WHISPER_FRAMES encoder + decoder forward, TPH_WHISPER_DECODE decode
# micro-steps with the encoder context, and one training step of 1 x
# TPH_WHISPER_TRAIN_SEQ at TPH_WHISPER_TRAIN_LAYERS encoder and decoder
# layers
TPH_PREFILL = (2, 512)
TPH_WARM_TOKENS = 16               # a warm-up prefill's, before the counts
TPH_TF_PROMPT, TPH_TF_STEPS = 2, 8
TPH_SLOTS, TPH_MAX_LEN = 2, 64
TPH_REQUESTS, TPH_PROMPT, TPH_NEW_TOKENS = 2, 8, 8
TPH_TRAIN_LAYERS, TPH_TRAIN_SEQ = 4, 512
TPH_DS_LAYERS, TPH_DS_PREFILL, TPH_DS_DECODE = 4, (1, 256), 4
TPH_DS_REQUESTS, TPH_DS_NEW_TOKENS = 2, 8
TPH_WHISPER_FRAMES, TPH_WHISPER_DECODE = 1500, 2
TPH_WHISPER_TRAIN_LAYERS, TPH_WHISPER_TRAIN_SEQ = 4, 256
# (d) zamba2-7b at full width over the same two ranks (16 of its 32 SSM
# heads and 16 of its 32 attention heads a rank, B | C copied): two
# super-blocks, so 10 mamba layers and 2 occurrences of the shared set
TPH_ZAMBA_LAYERS = 12
TPH_ZAMBA_F32_SEQ = 512
#: each layer of the fp32 prefill over two ranks against one process on
#: the same weights (TF32 off), fed the one process's input to that layer,
#: and the final norm and logits fed its last layer's output
TPH_ZAMBA_F32_REL_L2 = 1e-4
#: the fp32 prefill run through, ranks against one process: a layer's
#: ~4e-6 arithmetic gap (the rank's GEMM shapes) grows x1.4-2.8 a mamba
#: layer at random init, as the reference's own forward-vs-decode gap
#: does (ROADMAP.md, caveat (g)); a fault reads O(0.1-1)
TPH_ZAMBA_F32_FREE_REL_L2 = 1e-2
#: the chaos floor: one process's fp32 prefill against itself with the
#: first layer's input perturbed by this relative amount
TPH_ZAMBA_FLOOR_EPS = 1e-6
#: the f32 flash kernel against its plain version on the captured q, k, v
#: (the kernel tests' f32 bound, elementwise)
TPH_FLASH_F32_TOL = 2e-5
# written before the first run on the card (PERF.md, the head plan's
# findings): four ranks stage 56 all-reduces of the prefill's 16 MB fp32
# partials through the host; a rank's layer holds 8 query heads over one
# KV head (a quarter of phase 7's flash work at the same S)
TPH_PREDICTED = {"chatglm3 2x512 prefill over 4 ranks": "~2,000-4,000 ms "
                                                        "(collectives > 90 %)",
                 "chatglm3 micro-step over 4 ranks": "~80-150 ms",
                 "chatglm3 4-layer 1x512 training step": "~1-3 s",
                 "prefill relative L2 vs the single device": "~5e-3-2e-2",
                 "DeepSeek 4-layer 1x256 prefill over 2": "~200-500 ms",
                 "whisper 1x1500 forward over 2": "~1,500-3,000 ms",
                 "flash, chatglm3 rank layer (2x512, 8 over 1 KV head)":
                     "~0.05-0.1 ms",
                 "flash, MLA rank layer (1x256, 8 heads, 192/128)":
                     "~0.02-0.05 ms",
                 "flash, whisper encoder rank layer (1x1500, 10 heads)":
                     "~0.05-0.1 ms",
                 "peak a rank": "~4-5 GiB chatglm3, ~5 GiB DeepSeek, "
                                "~3 GiB whisper"}
# written before the first run of (b)'s training step on the card (PERF.md,
# the expert-parallel training findings): a rank holds ~2.6 GB of bf16
# weights, as much again of gradients and two fp32 moments (~10.4 GB);
# each layer stages 4 all-to-alls of a (64, 16, 2048) bf16 buffer (4 MB)
# and one fp32 all-reduce of the FFN input, router and shared experts'
# gradients (~69 MB), at the ~1.6 ms a MB of the staged collectives
TPH_PREDICTED.update({
    "DeepSeek 4-layer 1x256 training step over 2": "~0.5-1.5 s, > 70 % in "
                                                   "staged collectives",
    "DeepSeek training peak a rank": "~16-18 GiB",
    "DeepSeek training loss vs one process (pinned)": "~1e-3 relative",
    "DeepSeek training gradients vs one process": "~1e-2 relative L2",
    "flash backward, MLA rank layer (1x256, 8 heads, 192/128), SIMT":
        "~0.1-0.5 ms, < 2 % of its bound, slower than SDPA's backward"})
# written before the first run of the warm step and the gather backward
# checks: the first step pays first-use costs (the backward's cuBLAS
# shapes, the SIMT backward's module, the allocator growing to the peak,
# pinned staging buffers for the larger payloads); each un-dispatch slot
# is read by at most one (token, k), so its backward sums nothing
TPH_PREDICTED.update({
    "DeepSeek warm training step over 2": "~0.8-1.2 s on a host like the "
                                          "first step's ~1.7 s, "
                                          "collectives ~0.5-0.8 s of it",
    "DeepSeek AdamW.apply_ a rank (~1.3 G bf16 params, fp32 moments)":
        "~30-150 ms in either step",
    "DeepSeek un-dispatch gather backward vs index_add_": "bit-equal",
    "DeepSeek masked lookup backward vs index_add_": "<= 1 % of elements "
                                                     "differing"})
# written before the first run of (d) on the card (PERF.md, the zamba2
# over a mesh findings): a rank holds ~2.2 GB of fp32 weights (half of the
# 4.4 GB), then ~1.1 GB in bf16; a bf16 2 x 512 prefill stages 15
# all-reduces (the embed lookup, 10 mamba out-projections, 2 x 2 of the
# shared attention and MLP) of ~14.7 MB fp32 partials, ~220 MB, at the
# ~1.6 ms a MB of the staged collectives; the rank's GEMMs are ~1 TFLOP
TPH_PREDICTED.update({
    "zamba2 12-layer fp32 1x512 prefill vs one process": "~1e-6-1e-5 "
                                                         "relative L2",
    "zamba2 12-layer bf16 2x512 prefill over 2": "~300-600 ms, > 80 % in "
                                                  "15 staged collectives "
                                                  "(~220 MB)",
    "zamba2 bf16 prefill vs one process": "~1e-2 relative L2",
    "zamba2 fp32 served tokens": "equal to one process's",
    "zamba2 peak a rank": "~3-5 GiB",
    "flash, zamba2 rank layer (2x512, 16 heads, 112/112), bf16":
        "~0.03-0.08 ms",
    "zamba2 part of phase 22": "~25-40 s"})
DLRM_BATCH = 2048
DLRM_ROW_CAP = 10_000_000

# ogbn-products (OGB, Hu et al. 2020): nodes, directed CSR entries (61,859,140
# undirected edges, both directions), node feature width.  The graph here is
# synthetic: Poisson degrees of the same mean, uniform neighbours.
OGBN_NODES = 2_449_029
OGBN_DIRECTED_EDGES = 123_718_280
OGBN_FEATURES = 100
GNN_CHECK_SEGMENTS = 100_000   # plain-version check in chunks of segments
# ring vs rows variant on the same graph at other fp32 widths: where the
# ring overtakes (kernels.sls.FUSEDMM_RING_MIN_ROW_BYTES)
GNN_SWEEP_WIDTHS = ((32, 64, 128, 160, 192, 240, 256, 272, 320, 384, 448,
                     512, 520, 768, 1024),        # fp32
                    (256, 512, 640, 1040))        # bf16

# chatglm3-6b prefill: 4 prompts x 4096 tokens (cut from launch/steps.py's
# prefill_32k, 32 x 32768), and one prefill_32k sequence for the kernel alone
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
PREFILLS = 3                   # timed prefills
LONG_SEQ = 32768

# the kernels that move rows by cp.async.bulk, with their instantiations
# (gather: one; FusedMM ring: 2 dtypes x 2 f x 6 words per lane), and the
# SASS of a bulk copy
BULK_KERNELS = {"gather_bulk_kernel": 1, "fusedmm_ring_kernel": 24}
# the gather backward's kernels: the transposition's (the one-block
# sort at 2, 4 and 8 items a thread, the tiled passes' histogram and
# scatter, ptrs) and the sparse sum's (its plan, f32 and bf16)
GATHER_BWD_KERNELS = {"transpose_block_kernel": 3,
                      "transpose_hist_kernel": 1,
                      "transpose_scatter_kernel": 1,
                      "transpose_ptrs_kernel": 1, "sls_sparse_kernel": 2,
                      "sls_sparse_plan_kernel": 1}
BULK_COPY_SASS = "UBLKCP"

# chatglm3-6b served: DecodeServer(batch_slots=8, max_len=512,
# prefill_chunk=16, pipeline=True), 16 requests of uniform 32-64 prompt
# tokens and uniform ids, 32 new tokens each, no EOS.  The prompts, also
# those of phases 8 stablelm, 9 and 20, were 32-128 tokens until phase 21
# was added: the drives' prefill micro-steps set their length, and the
# graph == eager lockstep of phases 8 and 9 runs each eagerly (~44 and
# ~98 ms of host time a micro-step)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK = 8, 512, 16
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 32
SERVE_PROMPT_LEN = (32, 64)
# stablelm-3b served the same way, a shorter drive: one generation of 8
# slots, 16 new tokens each
STABLELM_REQUESTS, STABLELM_NEW_TOKENS = 8, 16
# gemma3-4b served across its 1024-token window: long-prompt chat at small
# batch (a system prompt plus history past the window), 8 requests of
# uniform 1024-1280 prompt tokens, 16 new tokens each, in a closed batch
GEMMA_MAX_LEN = 1536
GEMMA_PROMPT_LEN = (1024, 1280)
GEMMA_REQUESTS, GEMMA_NEW_TOKENS = 8, 16
# h2o-danube-1.8b prefilled over one sequence of 16384 tokens: four of its
# 4096-token windows, where the band keeps a quarter of a late row's keys
DANUBE_SEQ = 16384
# llava-next-34b: one 4096-token prefill, the first 576 positions its
# frontend_embeds (configs/llava_next_34b.py VISION_TOKENS)
LLAVA_SEQ = 4096
# training: h2o-danube-1.8b at full width on one 8192-token sequence a step
# (the band of its 4096-token window cuts keys in the backward too), 6
# steps, a checkpoint every 3 (after step 2 and step 5), a failure injected
# before step 4: the restart resumes from step 2 and reruns step 3.  On
# TRAIN_LAYERS of its 24 layers: the two checkpoints' writes and the
# restore (17.5 GB each at 24 layers, 9.2 GB at 12) took ~110 s of the
# script's time at 24 layers, cut so that phase 20 fits with room for a
# slow machine; the widths are whole
TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8192, 6, 3, 4
TRAIN_LAYERS = 3                   # 6 before phase 21 was added
TRAIN_CKPT_STEP = TRAIN_CKPT_EVERY - 1
TRAIN_LR = 3e-4
# the eager served path the captured wave is compared with: the same
# chatglm3-6b drive served eagerly (PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W)
EAGER_BASELINE = {"host_ms_micro_step": 42.84, "device_ms_micro_step": 9.15,
              "busy_pct": 21.2, "ms_decode_wave": 38.79,
              "tokens_per_s": 33.7, "ttft_p50_s": 7.33, "ttft_p99_s": 14.01,
              "per_token_p50_ms": 43.37, "per_token_p99_ms": 933.36}

# H100 SXM (NVIDIA data sheet, dense, 700 W): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
# torch.profiler can lose device records: one H100 run traced 646 of a
# served drive's 3,637 gathers, where every other run of the same drive
# traced them all, and a profile in a process that profiled before has
# missed the first kernels of a short call.  So a profiled drive waits
# PROFILE_PAD_S on an idle device before and after it, inside the profile;
# and as the profiler adds no record, a drive whose trace a check counts is
# traced again, up to PROFILE_TRIES times, until the count is the check's
PROFILE_TRIES, PROFILE_PAD_S = 3, 1.0
FP32_FLOPS = 67e12           # outside the tensor cores
BF16_TC_FLOPS = 989e12

# tolerances of kernel vs plain version (the same fp32 arithmetic in
# another order: up to ~130 standard-normal terms per sum)
TOL_SUM_F32 = dict(rtol=1e-5, atol=2e-4)
# fusedmm: fp32 dots of up to 520 terms feed each scale, then sums of ~10
# scaled rows, each in another order than the plain version's
TOL_FMM_F32 = dict(rtol=1e-4, atol=1e-3)
# attention: the same recurrence over the same 64-key tiles, fp32 sums in
# another order; outputs are convex combinations of unit-normal values
TOL_ATTN_F32 = dict(rtol=1e-5, atol=1e-5)
# the fp32 log-sum-exp the forward saves for the backward, vs the plain
# version's over the same KV tiles (as the card tests hold it)
TOL_LSE_F32 = dict(rtol=1e-5, atol=1e-5)
# the gradient of every parameter of a full-width training step through
# the kernels vs through the plain attention backward and logits product:
# the issue's bf16 tolerance, as relative L2 per leaf (both paths round the
# same bf16 backward; a wrong formula moves a leaf by O(1))
TRAIN_GRAD_REL_L2 = 5e-2
# few-key causal rows of bf16 flash attention: cases of q (2, 200, 16, D)
# over k (2, 200, 1, D) and v (2, 200, 1, Dv), (D, Dv) cycling over
# FLASH_STRESS_DIMS.  A row near the
# start attends to a few keys, where a p rounded to the other side of a
# bf16 step (scores summed in another order) moves the output the most
FLASH_STRESS_CASES = 300
FLASH_STRESS_DIMS = ((128, 128), (64, 64), (80, 80), (192, 128), (256, 256),
                     (112, 112))
# the windows the stress cases cycle through (None: causal only); at 200
# keys a window of 1024 masks nothing, so the sweep takes 1024 at 1300
FLASH_STRESS_WINDOWS = (None, 1, 100, 128, 129)
# the flash kernel's (q/k width, v width) pairs, and its bf16 wgmma
# instantiations: 4 pairs ((80, 80) and (112, 112) run (128, 128)) x causal
# or not; the (192, 128) and (256, 256) ones by their mangled template
# arguments
FLASH_DIMS = ((64, 64), (80, 80), (112, 112), (128, 128), (192, 128),
              (256, 256))
FLASH_WGMMA_KERNELS = 8
FLASH_WIDE_INSTANCES = {"(192, 128)": "ILi192ELi128E",
                        "(256, 256)": "ILi256ELi256E"}
# the flash backward's wgmma kernels: bf16 at (64, 64), (80, 80) and
# (128, 128), causal or not, each a dK/dV and a dQ kernel
FLASH_BWD_WGMMA_KERNELS = {"flash_bwd_dkdv_wgmma_kernel": 6,
                           "flash_bwd_dq_wgmma_kernel": 6}
# the sliding-window sweep: windows that are and are not a multiple of
# either KV tile (64, 128), gemma3-4b's 1024, and one short of Sq (the band
# cuts one key of the last row); at q/k widths 80, 128 and 256
FLASH_WINDOWS = (1, 100, 128, 129, 1024)
FLASH_WINDOW_DIMS = ((80, 80), (128, 128), (256, 256))
# bf16 kernel outputs vs plain: kernels.agreement.check_bf16 (one bf16 step
# per element, <= 1 % of elements differing, relative L2 <= 2^-9).
# scaled_dot_product_attention rounds p against the running max of its own
# tiles, so it may differ from the kernel by a bf16 step in many elements:
# held to a relative L2 below one bf16 step
LIBRARY_REL_L2_BF16 = 2 ** -7
# ogbn-products message passing: each output sums ~50 terms s * x[j] with
# s ~ N(0, 100), so outputs are ~70 in size; 1e-2 is 1.4e-4 of that scale
TOL_GNN = dict(rtol=1e-4, atol=1e-2)
# last hidden state of the chatglm3 prefill, kernel vs plain attention:
# single bf16 steps in a few attention outputs are amplified by the bf16
# GEMMs and norms of 28 layers, so this end-to-end bound catches only a
# gross fault; the per-layer check_bf16 of every attention output is the
# precise one
PREFILL_REL_L2 = 5e-2
# DeepSeek-V2-Lite's random weights follow the reference's init, whose
# experts' fan-in scale is E^-1/2 (the leading dim of (E, D, F)): an expert
# output is ~90x its input's RMS, so the residual stream is the MoE
# layers' outputs and a rounding step of attention grows through the 27
# gated (quadratic) products.  Its end-to-end bound (last hidden state,
# kernel vs plain attention, routing pinned) is fixed between the sound
# readings on the H100 (the kernel 0.0647; two plain versions that differ
# only in their KV chunk 0.0777) and a planted fault (layer 0's attention
# at the v width's scale: 0.993), which the phase runs and requires above
# it.  A lost KV tile in a middle layer reads 0.0647 there too: only the
# per-layer check_bf16, the precise check, sees it
DEEPSEEK_PREFILL_REL_L2 = 0.15
# the keys whose values one planted fault loses: the second 128-key tile
FAULT_KEYS = (128, 256)
# DeepSeek-V2-Lite's MoE un-dispatch at the prefill shape (phase 9, layer
# 0 of 4 x 4096 tokens): 98,304 rows of d_model 2048 bf16 (4 KiB) gathered
# from a 122,944-row capacity buffer, 94,270 of them distinct; the gather
# backward's parts are timed there on synthetic slots with those counts
DS_UNDISPATCH_ROWS, DS_UNDISPATCH_BUFFER = 98_304, 122_944
DS_UNDISPATCH_DISTINCT, DS_D_MODEL = 94_270, 2048
# whisper-large-v3 (phase 14): 8 clips of its published enc_seq, 1500
# frames (a 30-second window), prefilled with as many decoder tokens (the
# reference's encoder runs its rotary at the decoder's positions); served:
# encoded once, a 4-token prompt, then 16 greedy tokens a slot (60 until
# cut so that phase 20 fits, 30 until phase 21 was added: the
# eager drives and the plain-attention decode beside them are host-bound) into caches of 448 positions,
# whisper's decoder context (arXiv:2212.04356); trained on 1 x 1500 tokens
# and frames a step, 3 steps, twice from one seed
WHISPER_BATCH, WHISPER_FRAMES = 8, 1500
WHISPER_PROMPT, WHISPER_NEW_TOKENS, WHISPER_MAX_LEN = 4, 16, 448
WHISPER_TRAIN_STEPS = 3
# zamba2-7b (phase 15): the prefill phases' 4 x 4096 tokens (13 shared_attn
# launches at head dim 112); served: 8 requests of 256 or 320 prompt tokens
# (multiples of 64, so the forward's pick_chunk keeps whole chunks) and 32
# new tokens each in a closed batch, through the server settings of phase 8
ZAMBA_PROMPT_CHUNKS = (4, 5)          # prompt lengths, in 64-token units
ZAMBA_REQUESTS, ZAMBA_NEW_TOKENS = 8, 32
# the graph == eager lockstep of phases 15 and 16 serves the prompts' first
# quarters (64 or 80 tokens) and LOCKSTEP_NEW_TOKENS new tokens: an eager
# micro-step of these models takes ~77 ms (xlstm-1.3b) or more of host time
# on the H100's host, so the whole drive's ~350 would take 30 s or more
LOCKSTEP_NEW_TOKENS = 8
# zamba2-7b's random weights (the reference's init) make its 81-layer stack
# chaotic in bf16: each mamba layer multiplies two projections (y * silu(z)),
# so a bf16 step in one layer's output grows with depth. Two plain attentions
# that differ only in their KV chunk move the last hidden state by 0.57
# relative L2 at d_model 256 and full depth (a CPU probe).  On the H100
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6) the kernel read 0.274 against
# plain attention there (every layer within check_bf16), plain attention over
# 64- against 128-key chunks 0.257, and the first shared layer's attention
# with its scale left out 1.213.  So, as for DeepSeek-V2-Lite, the last
# hidden state is held to a fixed bound between the sound readings and that
# fault, and the precise end-to-end check is the hidden state after the first
# shared_attn layer (six layers in), within PREFILL_REL_L2 (the kernel
# 0.00027 there, the fault 0.130)
ZAMBA_PREFILL_REL_L2 = 0.6
# forward == decode at full width (the reference's own invariant, its
# test_recurrent_forward_matches_decode, which runs in f32): the chunked
# forward's logits at each served prompt's last token against the captured
# decode replay's there, relative L2 over the 8 x 32,000 logits.  In bf16 the
# two paths round at other points (the SSD's fp32 chunk sums against a bf16
# state stepped 256-320 times) and the chaos above makes the logits unrelated
# at full depth (1.28 at d_model 256 on the CPU, 0.09 at 6 layers; 1.114 on
# the H100): read, not held.  It is held on the same model in fp32, built
# from the same seed after the bf16 one is freed, where two planted decode
# faults must exceed the bound.  The first fp32 reading was 0.00329, the
# faults 1.265 and 1.414; the bound is 6x that reading
ZAMBA_FWD_DECODE_REL_L2 = 2e-2
# xlstm-1.3b (phase 16): the first super-block (three mlstm layers and an
# slstm layer at full width) in fp32 on the card against the CPU over 1 x
# 512 tokens, then 16 decode steps; the prefill phases' 4 x 4096 tokens;
# served as phase 15 serves zamba2-7b: 8 requests of 256 or 320 prompt
# tokens (pick_chunk(320, 256) = 64, so the forward's two chunk paths both
# run) and 32 new tokens each, closed batch (the lockstep: as phase 15's,
# LOCKSTEP_NEW_TOKENS); trained on
# 1 x 512 tokens a step, lr TRAIN_LR, 2 steps, twice from one seed (a
# 2048-token step took ~40 s, nearly all of it the host issuing the sLSTM
# loop's forward and backward; with phase 17 the script neared its 20
# minutes and 1024 tokens halved the loop; for phase 19 the steps take
# 512 tokens and 24 of the 48 layers, a quarter of the loop again; for
# phase 20, XLSTM_TRAIN_LAYERS = 12, for phase 21 4 (one super-block): its
# length and the sLSTM layers' count set the step's time, the widths are
# whole).  The phase's model runs XLSTM_LAYERS of the 48 layers (all 48
# before phase 21 was added, then 24; the prefill's sLSTM loop is
# host-bound, ~28 s over 48 layers on a slow host).  The sLSTM layers are profiled over a window of
# XLSTM_WINDOW steps and scaled to the whole loop: every step issues the
# same kernels, and a whole layer's ~100,000 kernels take minutes to read
# under the profiler
XLSTM_BLOCK_SEQ, XLSTM_BLOCK_DECODE = 512, 16
XLSTM_PROMPT_CHUNKS = (4, 5)          # prompt lengths, in 64-token units
XLSTM_REQUESTS, XLSTM_NEW_TOKENS = 8, 32
XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_LAYERS = 512, 2, 4
XLSTM_LAYERS = 12
XLSTM_WINDOW = 256
# the first super-block on the card against the CPU in fp32: the relative
# L2 of the hidden states, of each decode step's logits and of every cache
# leaf after the decode.  fp32 sums of up to 8,192 terms in another order
# move them by ~1e-6; one product taken in TF32 (a 10-bit mantissa), a gate
# layout reordered or a leaf in another dtype by 1e-3 or more
XLSTM_CARD_CPU_REL_L2 = 1e-4
# forward == decode at full width (the reference's invariant, its
# test_recurrent_forward_matches_decode, which runs in f32), as phase 15
# holds it for zamba2-7b: each served prompt's last-token logits from the
# chunked forward against the captured decode replay's, and beside them
# every recurrent layer's final state (the forward's scans' and sLSTM
# loop's against the decode's cache leaves: C, n; h, c, n, m), the largest
# relative L2 of any layer's leaf.  Held in fp32 on the model rebuilt from
# the same seed, read in bf16 (0.0382 logits, 0.0653 state on the H100).
# The first fp32 reading was 4.729e-06 (logits) and 8.125e-06 (state,
# layer 22's C); the planted faults read 1 (n left unupdated: the state;
# its logits 8.1e-4, since at the reference's init |n.q| rarely reaches the
# clamp at 1) and 0.1205 (rh dropped); the bound is 6x the first reading
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, xlstm-1.3b's findings)
XLSTM_FWD_DECODE_REL_L2 = 5e-5


# phase 20: the disaggregated tier.  chatglm3-6b at full width and depth
# served with phase 8's settings, DISAGG_REQUESTS requests (one closed
# batch of the 8 slots) of DISAGG_NEW_TOKENS new tokens, in-process and
# over ServicePool(2, device="cuda"), DISAGG_ROUNDS rounds interleaved; a
# replica killed after serving iteration DISAGG_KILL_AT of a third drive
DISAGG_REQUESTS, DISAGG_NEW_TOKENS, DISAGG_ROUNDS = 8, 16, 2
DISAGG_KILL_AT = 6
DISAGG_RPC_TIMEOUT_S, DISAGG_REVIVE_S = 60.0, 120.0
# written before the first run on the card (PERF.md, the disaggregated
# tier's findings): a wave's reply is 8 slots x 2 ops x 4,096 x 2 B; a
# captured micro-step 8.424 device ms (PERF.md section 5)
DISAGG_PREDICTED = {
    "wire bytes a wave": "request < 1 KB, reply ~131.5 KB",
    "(b) against (a)": "per-token p50 within +0.2..+1.5 ms of (a)'s ~10 ms, "
                       "tokens/s 85-100 % of (a)'s (the hop overlaps the "
                       "next LM wave; its copy back does not)",
    "bind": "~1-3 s: 532.7 MB to each replica over loopback + the warm "
            "artifact's write",
    "respawn recovery": "~8-15 s (a process reaching the card, reading the "
                        "532.7 MB warm checkpoint, loading the artifact)",
    "replica peak": "~0.55-1.1 GB (the table, once or briefly twice at a "
                    "rebind)",
    "artifact boot vs fresh": "time to first token within 10 ms: the "
                              "program compiles in milliseconds, the boot "
                              "is the graph capture",
    "phase 20": "~45-75 s"}


# phase 21: the dry run and the roofline.  (a) chatglm3-6b at full width
# and ROOFLINE_A_LAYERS of its 28 layers, 1 x ROOFLINE_A_SEQ tokens: the
# prefill and one training step, counted on meta (a 1 x 1 mesh) and on the
# card; (b) h2o-danube-1.8b at full width and ROOFLINE_B_LAYERS of its 24,
# 1 x TRAIN_SEQ tokens, one training step under each remat policy
ROOFLINE_A_LAYERS, ROOFLINE_A_SEQ = 2, 4096
ROOFLINE_B_LAYERS = 4
# written before the first run on the card: the band of the dry run's
# predicted peak (argument + peak temporary bytes on meta) over the card's
# max_memory_allocated for (b)'s steps.  The count misses the caching
# allocator's 512-byte rounding and the kernels' own scratch (the flash
# backward's rows, the transposition's and the sparse sum's buffers: a few
# MB against ~4-12 GB), so within a few percent
ROOFLINE_PEAK_BAND = (0.95, 1.05)
# (c): the one-card cells an earlier phase times, (arch, batch, seq, kind,
# layers, the key of that phase's time, its time in PERF.md sections 5-6:
# NVIDIA H100 80GB HBM3, 700.00 W); phase 13 trains TRAIN_LAYERS of
# danube's 24 layers (the recorded time is the 24-layer step's)
ROOFLINE_CELLS = (
    ("chatglm3-6b", 4, 4096, "prefill", None, "chatglm3_prefill_ms", 410.19),
    ("stablelm-3b", 4, 4096, "prefill", None, "stablelm_prefill_ms", 249.61),
    ("llava-next-34b", 1, 4096, "prefill", None, "llava_prefill_ms", 544.77),
    ("h2o-danube-1.8b", 1, 8192, "train", 24, None, 514.6),
    ("h2o-danube-1.8b", 1, 8192, "train", TRAIN_LAYERS, "training_step_ms",
     None))
ROOFLINE_PREDICTED = {
    "(a) mm FLOPs": "the dry run's count == the card's FlopCounterMode "
                    "count, exactly (the same aten products; the kernels "
                    "count nowhere)",
    "(a) attention FLOPs": "the cost pass's dense attention == "
                           "analytic_flops's attention term, exactly",
    "(b) remat": "loss and gradients bit-equal; peak none > dots > full "
                 "(dry: ~11.6, ~9.6, ~8.1 GB with the 3.6 GB of arguments)",
    "(b) predicted / measured peak": f"{ROOFLINE_PEAK_BAND[0]}-"
                                     f"{ROOFLINE_PEAK_BAND[1]}",
    "(b) step time": "dots ~ none + 10-20 % (the forward's elementwise work "
                     "and the flash forward again), full ~ none + 30-40 %",
    "(c) danube at TRAIN_LAYERS": "~20-25 % of bound (the 24-layer step "
                                  "reached 22 %)",
    "phase 21": "~25-45 s"}


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def max_err(got, want) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def check_close(got, want, what: str, rtol: float = 0.0,
                atol: float = 0.0) -> float:
    """Hold ``got`` against ``want`` elementwise (exact when both tolerances
    are 0); returns the max absolute error."""
    import torch
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {got.dtype}{tuple(got.shape)} vs "
            f"{want.dtype}{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    g, w = got.float(), want.float()
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(got, want)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} elements off, max abs err {err:.3g} "
            f"(rtol={rtol}, atol={atol})")
    return err


def _worst(acc: dict, a: dict) -> None:
    """Fold one check_bf16 result into the running worst of a sweep."""
    for key, val in a.items():
        acc[key] = max(acc.get(key, 0.0), val)


def _bf16_summary(a: dict) -> str:
    if not a:
        return "no cases"
    return (f"max abs {a['max_abs']:.3g} ({a['worst']:.3g} x its one-step "
            f"tol), <= {100 * a['share_differing']:.3g}% of elements "
            f"differing, relative L2 <= {a['rel_l2']:.3g}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def median_ms(fn, iters: int, reps: int = 3) -> float:
    """The median of ``reps`` timings of ``time_ms(fn, iters)``: a timing
    of a few short calls can take a stall of the allocator or the clock."""
    return float(np.median([time_ms(fn, iters) for _ in range(reps)]))


def plain_attention(q, k, v, **kw):
    """The flash kernel's plain version over the kernel's own KV tiles
    (``kv_tile`` of its dtype and q/k width), so p rounds against the same
    running max."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import kv_tile
    return ref.attention(q, k, v,
                         **{**kw, "chunk": kv_tile(q.dtype, q.shape[3])})


def free_cuda() -> None:
    import torch
    from repro_torch.core.executor import clear_executor_cache
    clear_executor_cache()
    gc.collect()
    # tensors that phase 17's ranks held by CUDA IPC stay allocated here
    # until collected, after the ranks have let them go
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 1-2: the card and the build
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {torch.cuda.device_count()} device(s)")
    return name, card


def _ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's report, by mangled kernel name: (registers, spill-store
    bytes)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = (int(regs.group(1)) if regs else 0,
                     int(spill.group(1)) if spill else 0)
    return out


def _sass_counts(lib: Path, kernel: str, ops: tuple) -> tuple:
    """``cuobjdump -sass`` of the library: the number of functions whose
    name holds ``kernel``, and of their instructions starting with each of
    ``ops``."""
    from repro_torch.kernels import _build
    sass = subprocess.run([_build.cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    n_fn, counts = 0, dict.fromkeys(ops, 0)
    for part in sass.split("Function : ")[1:]:
        if kernel not in part.split("\n", 1)[0]:
            continue
        n_fn += 1
        for op in ops:
            counts[op] += len(re.findall(rf"\b{op}\b", part))
    return n_fn, counts


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.kernels.sls import DTYPES
    t0 = time.perf_counter()
    _build.library()
    rec = _build.build_record()
    where = rec.path.relative_to(REPO)
    if not rec.built:
        print(f"[2 build] loaded an earlier build (no nvcc run) in "
              f"{time.perf_counter() - t0:.2f} s; {where}")
    else:
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", rec.log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             rec.log)]
        (rec.path.parent / "ptxas.log").write_text(rec.log)
        print(f"[2 build] nvcc {rec.seconds:.2f} s (load "
              f"{time.perf_counter() - t0:.2f} s): {len(regs)} kernels, max "
              f"{max(regs, default=0)} registers, {max(spills, default=0)} "
              f"bytes spill stores; {where}")
        wgmma = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                 if "flash_wgmma_kernel" in k}
        flash_log = rec.log.split("== ember_flash_attention.cu\n")[-1]
        warnings = sorted({ln.strip() for ln in flash_log.split("\n== ")[0]
                           .splitlines() if "warning" in ln.lower()})
        print(f"[2 build flash] bf16 wgmma kernels (registers, spill-store "
              f"bytes): {sorted(wgmma.values())}; ptxas warnings on the "
              f"flash source: {warnings or 'none'}")
        require(len(wgmma) == FLASH_WGMMA_KERNELS and
                all(s == 0 for _, s in wgmma.values()),
                "the bf16 flash kernels must build without spills")
        for dims, inst in FLASH_WIDE_INSTANCES.items():
            got = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                   if inst in k}
            print(f"[2 build flash {dims}] the {dims} instantiations (bf16 "
                  f"wgmma and f32 scalar, causal or not; registers, "
                  f"spill-store bytes): {sorted(got.values())}")
            require(len(got) == 4 and all(s == 0 for _, s in got.values()),
                    f"the {dims} flash kernels must build without spills")
        for kernel, n_want in FLASH_BWD_WGMMA_KERNELS.items():
            got = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                   if kernel in k}
            print(f"[2 build {kernel}] bf16 at 64, 80, 128, causal or not "
                  f"(registers, spill-store bytes): {sorted(got.values())}")
            spilled = sorted(k for k, (_, s) in got.items() if s)
            require(len(got) == n_want and not spilled,
                    f"the {kernel} instantiations must build without spills "
                    f"({len(got)} built; spilling: {spilled})")
        for kernel, n_want in {**BULK_KERNELS,
                               **GATHER_BWD_KERNELS}.items():
            got = {k: v for k, v in _ptxas_by_kernel(rec.log).items()
                   if kernel in k}
            print(f"[2 build {kernel}] (registers, spill-store bytes): "
                  f"{sorted(set(got.values()))}")
            spilled = sorted(k for k, (_, s) in got.items() if s)
            require(len(got) == n_want and not spilled,
                    f"the {kernel} instantiations must build without spills "
                    f"({len(got)} built; spilling: {spilled})")
    # proof that the bf16 flash kernel runs on the tensor cores and TMA
    n_fn, ops = _sass_counts(rec.path, "flash_wgmma_kernel",
                             ("HGMMA", "UTMALDG", "UTMASTG"))
    print(f"[2 sass] bf16 flash kernels ({n_fn} instantiations, cuobjdump "
          f"-sass): {ops['HGMMA']} HGMMA, {ops['UTMALDG']} UTMALDG (TMA "
          f"loads), {ops['UTMASTG']} UTMASTG (TMA stores)")
    require(n_fn == FLASH_WGMMA_KERNELS and ops["HGMMA"] > 0 and
            ops["UTMALDG"] > 0,
            "the bf16 flash kernel must hold wgmma (HGMMA) and TMA loads "
            "(UTMALDG)")
    for dims, inst in FLASH_WIDE_INSTANCES.items():
        n_fn, ops = _sass_counts(rec.path, "flash_wgmma_kernel" + inst,
                                 ("HGMMA", "UTMALDG", "UTMASTG"))
        print(f"[2 sass] bf16 flash kernels at {dims} ({n_fn} "
              f"instantiations): {ops['HGMMA']} HGMMA, {ops['UTMALDG']} "
              f"UTMALDG, {ops['UTMASTG']} UTMASTG")
        require(n_fn == 2 and ops["HGMMA"] > 0 and ops["UTMALDG"] > 0,
                f"the {dims} bf16 flash kernel must hold wgmma (HGMMA) and "
                f"TMA loads (UTMALDG)")
    # proof that the flash backward's wgmma variant runs on the tensor
    # cores and TMA
    for kernel, n_want in FLASH_BWD_WGMMA_KERNELS.items():
        n_fn, ops = _sass_counts(rec.path, kernel, ("HGMMA", "UTMALDG"))
        print(f"[2 sass] {kernel} ({n_fn} instantiations): {ops['HGMMA']} "
              f"HGMMA, {ops['UTMALDG']} UTMALDG (TMA loads)")
        require(n_fn == n_want and ops["HGMMA"] > 0 and ops["UTMALDG"] > 0,
                f"the flash backward's {kernel} must hold wgmma (HGMMA) and "
                f"TMA loads (UTMALDG)")
    # proof that the row-streaming kernels move rows by bulk copies
    for kernel, n_want in BULK_KERNELS.items():
        n_fn, ops = _sass_counts(rec.path, kernel, (BULK_COPY_SASS,))
        print(f"[2 sass] {kernel} ({n_fn} instantiations): "
              f"{ops[BULK_COPY_SASS]} {BULK_COPY_SASS} (cp.async.bulk)")
        require(n_fn == n_want and ops[BULK_COPY_SASS] >= n_fn,
                f"every {kernel} must hold bulk copies ({BULK_COPY_SASS})")
    # every flash check holds the kernel to the plain version over kv_tile
    # keys: the library's own tiles must be those
    tiles = {(dt, d): _build.library().ember_flash_kv_tile(code, d)
             for dt, code in DTYPES.items() for d, _ in FLASH_DIMS}
    print("[2 kv tile] flash KV tiles of the library (dtype, q/k width): " +
          ", ".join(f"{str(dt)[6:]} {d}: {t} (kv_tile {kv_tile(dt, d)})"
                    for (dt, d), t in tiles.items()))
    require(all(t == kv_tile(dt, d) for (dt, d), t in tiles.items()),
            "kv_tile must be the flash kernels' own KV tiles")


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain versions over a sweep, small program vs oracle
# ---------------------------------------------------------------------------

def _csr(rng, segs: int, rows: int, avg: float, pad: int = 0):
    lens = rng.poisson(avg, segs)
    lens[::4] = 0                      # empty segments
    ptrs = np.zeros(segs + 1, np.int32)
    np.cumsum(lens, out=ptrs[1:])
    nnz = int(ptrs[-1])
    idxs = np.zeros(nnz + pad, np.int32)   # capacity padding: never read
    idxs[:nnz] = rng.integers(0, rows, nnz)
    return ptrs, idxs


def _ids(rng, kind: str, n: int, g: int) -> np.ndarray:
    """g lookup ids below n: uniform, all one block, or a Zipf(1.05) head."""
    if kind == "equal":
        return np.full(g, n // 2, np.int32)
    if kind == "zipf":
        return (np.minimum(rng.zipf(1.05, g), n) - 1).astype(np.int32)
    return rng.integers(0, n, g).astype(np.int32)


def _variant_delta(kernel: str, before: dict) -> dict:
    from repro_torch.kernels import ops as kops
    after = kops.variant_launch_counts()[kernel]
    return {k: after[k] - before[k] for k in after}


def phase_sweep(seed: int) -> dict:
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gather_before = kops.variant_launch_counts()["block_gather"]
    errs = {"sls_sum_f32": 0.0, "sls_maxmin": 0.0, "gather": 0.0}
    bf16 = {}
    n_sls = n_gather = 0
    for dtype in (torch.float32, torch.bfloat16):
        for emb in (5, 96, 128):
            rows, segs = 300, 37
            table = torch.from_numpy(
                rng.standard_normal((rows, emb)).astype(np.float32)
            ).to(dev, dtype)
            for add in ("add", "max", "min"):
                for weighting in (None, "mul", "add"):
                    for based in (False, True):
                        ptrs, idxs = _csr(rng, segs, rows // 2, 5, pad=7)
                        w = None
                        if weighting:
                            w = torch.from_numpy(rng.standard_normal(
                                len(idxs)).astype(np.float32)).to(dev, dtype)
                        base = None
                        if based:
                            base = torch.from_numpy(rng.integers(
                                0, rows // 2, segs).astype(np.int32)).to(dev)
                        args = (table, torch.from_numpy(ptrs).to(dev),
                                torch.from_numpy(idxs).to(dev), w)
                        kw = dict(num_segments=segs, add_op=add,
                                  mul_op=weighting or "mul", seg_base=base)
                        got = kops.sls(*args, **kw)
                        want = ref.sls(*args, **kw)
                        what = (f"sls {dtype} E={emb} {add}/{weighting} "
                                f"seg_base={based}")
                        if dtype == torch.bfloat16:
                            _worst(bf16, check_bf16(got, want, what))
                            n_sls += 1
                            continue
                        if add == "add":
                            key, tol = "sls_sum_f32", TOL_SUM_F32
                        else:
                            key, tol = "sls_maxmin", {}
                        errs[key] = max(errs[key],
                                        check_close(got, want, what, **tol))
                        n_sls += 1
        for emb in (5, 96, 2048):
            for block_rows in (1, 4):
                n_blk, g = 50, 64
                table = torch.from_numpy(rng.standard_normal(
                    (n_blk * block_rows, emb)).astype(np.float32)).to(dev,
                                                                     dtype)
                for ids in ("uniform", "equal", "zipf"):
                    idxs = torch.from_numpy(_ids(rng, ids, n_blk // 2, g)
                                            ).to(dev)
                    for roff in (None, torch.from_numpy(rng.integers(
                            0, n_blk // 2, g).astype(np.int32)).to(dev)):
                        got = kops.block_gather(table, idxs,
                                                block_rows=block_rows,
                                                roff=roff)
                        want = ref.block_gather(table, idxs,
                                                block_rows=block_rows,
                                                roff=roff)
                        check_close(got, want, f"gather {dtype} E={emb} "
                                    f"R={block_rows} {ids} ids "
                                    f"roff={roff is not None}")
                        n_gather += 1
    # tables one element into a flat buffer (not 16-byte aligned): the
    # kernels take one element per access
    n_unaligned = 0
    for emb in (8, 64):
        rows, segs = 300, 37
        flat = torch.from_numpy(rng.standard_normal(rows * emb + 1)
                                .astype(np.float32)).to(dev)
        table = flat[1:].view(rows, emb)
        require(table.data_ptr() % 16 != 0, "unaligned view is aligned")
        ptrs, idxs = _csr(rng, segs, rows, 5)
        args = (table, torch.from_numpy(ptrs).to(dev),
                torch.from_numpy(idxs).to(dev))
        errs["sls_sum_f32"] = max(errs["sls_sum_f32"], check_close(
            kops.sls(*args, num_segments=segs),
            ref.sls(*args, num_segments=segs),
            f"sls unaligned E={emb}", **TOL_SUM_F32))
        check_close(kops.block_gather(table, args[2]),
                    ref.block_gather(table, args[2]),
                    f"gather unaligned E={emb}")
        n_unaligned += 1
    # degenerate launches: no segments, an all-empty batch, an empty gather
    t = torch.randn(10, 8, device=dev)
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    require(kops.sls(t, torch.zeros(1, dtype=torch.int32, device=dev), z,
                     num_segments=0).shape == (0, 8), "sls with 0 segments")
    empty = kops.sls(t, torch.zeros(4, dtype=torch.int32, device=dev), z,
                     num_segments=3, add_op="max")
    require(bool((empty == 0).all()), "all-empty max segments must be 0")
    require(kops.block_gather(t, z).shape == (0, 1, 8), "empty gather")
    torch.cuda.synchronize()
    variants = _variant_delta("block_gather", gather_before)
    require(variants["bulk"] > 0 and variants["rows"] > 0 and
            variants["group"] == variants["bulk"],
            f"the gather sweep must run both variants: {variants}")
    print(f"[3 sweep] sls {n_sls} cases: max abs err sum/f32 "
          f"{errs['sls_sum_f32']:.3g} (tol rtol=1e-5 atol=2e-4), max/min "
          f"{errs['sls_maxmin']:.3g} (exact), bf16 {_bf16_summary(bf16)}; "
          f"gather {n_gather} cases bit-exact (uniform, all-equal and Zipf "
          f"ids; variant launches {variants}); {n_unaligned} unaligned "
          f"tables (sls + gather) ok; empty launches ok")
    return errs


def phase_sweep_transpose(seed: int) -> None:
    """The gather backward's two kernels on the streams a token stream
    produces (one id repeated, all distinct, the last id, a Zipf head,
    rebased by roff, G = 1), on the one-block and the tiled transposition
    and one to three radix passes: order and ptrs equal to the argsort
    path's, the backward bit-equal to the parent's composition in f32 and
    bf16, through the sum variant kernel_variant picks."""
    import torch
    from repro_torch.kernels import gather as kgather, ops as kops, ref
    from repro_torch.kernels.sls import launch_variant
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    before = kops.variant_launch_counts()["sls"]
    cases = 0
    for kind, n, g, based in (("equal", 600, 400, False),
                              ("distinct", 5000, 5000, False),
                              ("last", 1000, 777, True),
                              ("zipf", 51968, 1500, False),
                              ("zipf", 256, 3000, False),
                              ("uniform", 9, 1, False),
                              ("zipf", 262144, 8192, True),
                              ("equal", 40000, 20000, False),
                              ("zipf", 122944, 30000, True)):
        span = n - n // 3 if based else n
        if kind == "distinct":
            ids = rng.permutation(span)[:g].astype(np.int32)
        elif kind == "last":
            ids = rng.integers(0, span, g).astype(np.int32)
            ids[::3] = span - 1
        else:
            ids = _ids(rng, kind, span, g)
        idxs = torch.from_numpy(ids).to(dev)
        roff = torch.from_numpy(rng.integers(0, n // 3, g).astype(
            np.int32)).to(dev) if based else None
        order, ptrs = kgather.transposed_lookups(idxs, roff, n)
        want = ref.transposed_lookups(idxs, roff, n)
        require(torch.equal(order, want[0]) and torch.equal(ptrs, want[1]),
                f"transposition of {g} {kind} ids into {n} blocks "
                f"(roff={based}) differs from the argsort path")
        for dtype, emb in ((torch.float32, 256), (torch.bfloat16, 1280)):
            dout = torch.randn((g, 1, emb), device=dev).to(dtype)
            got = kops.block_gather_backward(dout, idxs, n, roff=roff)
            rows = dout.reshape(g, emb)
            parent = torch.empty_like(got)
            launch_variant("rows", rows, want[1], want[0], parent)
            require(torch.equal(got, parent),
                    f"gather backward of {g} {kind} ids into {n} rows of "
                    f"{emb} {dtype} (roff={based}) is not the parent "
                    "composition's bits")
            cases += 1
    torch.cuda.synchronize()
    variants = _variant_delta("sls", before)
    require(variants["sparse"] > 0,
            f"the gather backward sweep must run the sparse sum: {variants}")
    print(f"[3 sweep gather backward] {cases} cases (equal, distinct, last-"
          f"id, Zipf and uniform ids; G = 1 to 30,000 into 9 to 262,144 "
          f"blocks; roff): the transposition kernel's order and ptrs equal "
          f"to the argsort path's, the backward bit-equal to the parent's "
          f"composition (sum variants {variants})")


def phase_sweep_fusedmm(seed: int) -> None:
    """FusedMM against its plain version: identity/relu, f32/bf16, E = 5,
    8, 64, 100, 128, 520, 1024, through the wrapper and through each
    variant that takes the shape (the ring: whole 16-byte units up to 4 KB;
    the rows variant: every width here), empty segments, segments longer
    than the ring, an unaligned table, zero segments."""
    import torch
    from repro_torch.kernels import fusedmm as kfusedmm, ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.sls import FUSEDMM_RING_MAX_ROW_BYTES
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    err_f32, bf16 = 0.0, {}
    n = 0
    before = kops.variant_launch_counts()["fusedmm"]
    for dtype in (torch.float32, torch.bfloat16):
        for emb in (5, 8, 64, 100, 128, 520, 1024):
            rows = 400
            x = torch.from_numpy(rng.standard_normal((rows, emb)).astype(
                np.float32)).to(dev, dtype)
            row_bytes = emb * x.element_size()
            variants = ["wrapper", "rows"]
            if row_bytes % 16 == 0 and row_bytes <= FUSEDMM_RING_MAX_ROW_BYTES:
                variants.append("ring")
            for fn in ("identity", "relu"):
                # mean degree 7, or 40: more rows than the ring's stages
                ptrs, idxs = _csr(rng, rows, rows, 7 if fn == "identity"
                                  else 40, pad=5)
                args = (x, torch.from_numpy(ptrs).to(dev),
                        torch.from_numpy(idxs).to(dev))
                want = ref.fusedmm(*args, num_segments=rows, fn=fn)
                empty = torch.from_numpy(np.diff(ptrs) == 0).to(dev)
                for variant in variants:
                    if variant == "wrapper":
                        got = kops.fusedmm(*args, num_segments=rows, fn=fn)
                    else:
                        got = torch.empty_like(want)
                        kfusedmm.launch_variant(variant, *args, got, fn=fn)
                    what = f"fusedmm {dtype} E={emb} {fn} ({variant})"
                    if dtype == torch.float32:
                        err_f32 = max(err_f32, check_close(got, want, what,
                                                           **TOL_FMM_F32))
                    else:
                        _worst(bf16, check_bf16(got, want, what))
                    require(bool((got[empty] == 0).all()),
                            "fusedmm empty segments must be 0")
                    n += 1
    flat = torch.from_numpy(rng.standard_normal(300 * 64 + 1).astype(
        np.float32)).to(dev)
    x = flat[1:].view(300, 64)
    require(x.data_ptr() % 16 != 0, "unaligned view is aligned")
    ptrs, idxs = _csr(rng, 300, 300, 7)
    args = (x, torch.from_numpy(ptrs).to(dev), torch.from_numpy(idxs).to(dev))
    err_f32 = max(err_f32, check_close(
        kops.fusedmm(*args, num_segments=300),
        ref.fusedmm(*args, num_segments=300), "fusedmm unaligned",
        **TOL_FMM_F32))
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    require(kops.fusedmm(x, torch.zeros(1, dtype=torch.int32, device=dev), z,
                         num_segments=0).shape == (0, 64),
            "fusedmm with 0 segments")
    torch.cuda.synchronize()
    variants = _variant_delta("fusedmm", before)
    require(variants["ring"] > 0 and variants["rows"] > 0,
            f"the fusedmm sweep must run both variants: {variants}")
    print(f"[3 sweep fusedmm] {n} cases (wrapper, rows and ring) + 1 "
          f"unaligned table: max abs err "
          f"f32 {err_f32:.3g} (tol rtol=1e-4 atol=1e-3), bf16 "
          f"{_bf16_summary(bf16)}; variant launches {variants}; zero "
          f"segments ok")


def phase_sweep_flash(seed: int) -> None:
    """Flash attention against its plain version over the kernel's own KV
    tiles (``kv_tile``: 128 keys in bf16, 64 at q/k width 256, 64 in f32):
    causal or not, GQA groups 1, 4, 16, (q/k, v) widths (64, 64), (80, 80)
    (the 128 kernel, padded), (128, 128), (192, 128) (MLA) and (256, 256),
    S 256, a ragged 200 and 200 queries over 328 keys, f32 and bf16; then
    the sliding window (``FLASH_WINDOWS`` and Sq - 1) at widths 80, 128
    and 256, causal or not, over a ragged 1300 keys and 200 queries over
    328 keys, where a window of Sk or more must give the bits of none."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    err_f32, bf16 = 0.0, {}
    n = n_win = 0

    def held(q, k, v, what, **kw):
        got = kops.attention(q, k, v, **kw)
        want = plain_attention(q, k, v, **kw)
        if q.dtype == torch.float32:
            return max(err_f32, check_close(got, want, what, **TOL_ATTN_F32))
        _worst(bf16, check_bf16(got, want, what))
        return err_f32

    def qkv(b, sq, sk, h, hkv, d, dv, dtype):
        return (torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, sq, h, d), (b, sk, hkv, d),
                              (b, sk, hkv, dv)))
    for dtype in (torch.float32, torch.bfloat16):
        for d, dv in FLASH_DIMS:
            for h, hkv in ((4, 4), (8, 2), (16, 1)):
                for sq, sk in ((256, 256), (200, 200), (200, 328)):
                    q, k, v = qkv(2, sq, sk, h, hkv, d, dv, dtype)
                    for causal in (True, False):
                        err_f32 = held(q, k, v, f"flash {dtype} D={d}/{dv} "
                                       f"H={h}/{hkv} Sq={sq} Sk={sk} "
                                       f"causal={causal}", causal=causal)
                        n += 1
        for d, dv in FLASH_WINDOW_DIMS:
            for sq, sk in ((1300, 1300), (200, 328)):
                q, k, v = qkv(1, sq, sk, 8, 2, d, dv, dtype)
                for causal in (True, False):
                    for w in FLASH_WINDOWS + (sq - 1,):
                        err_f32 = held(q, k, v, f"flash {dtype} D={d}/{dv} "
                                       f"Sq={sq} Sk={sk} causal={causal} "
                                       f"window={w}", causal=causal,
                                       window=w)
                        n_win += 1
                    none = kops.attention(q, k, v, causal=causal)
                    for w in (sk, 10 ** 6):
                        require(torch.equal(kops.attention(
                            q, k, v, causal=causal, window=w), none),
                            f"flash {dtype} D={d}/{dv} Sq={sq} Sk={sk}: "
                            f"window {w} >= Sk differs from no window")
    torch.cuda.synchronize()
    print(f"[3 sweep flash] {n} cases, and {n_win} with a window "
          f"({', '.join(map(str, FLASH_WINDOWS))}, Sq - 1) at widths "
          f"{', '.join(str(d) for d, _ in FLASH_WINDOW_DIMS)}: max abs err "
          f"f32 {err_f32:.3g} (tol rtol=1e-5 atol=1e-5), bf16 "
          f"{_bf16_summary(bf16)}; a window of Sk or more gives the bits of "
          f"none")


def phase_stress_flash(seed: int) -> None:
    """The bf16 flash kernel against its plain version (over ``kv_tile``
    keys) in ``FLASH_STRESS_CASES`` causal cases of few-key rows, the
    (q/k, v) widths ``FLASH_STRESS_DIMS`` crossed with the windows
    ``FLASH_STRESS_WINDOWS``: every case must pass ``check_bf16``.  Prints
    the worst readings over all cases and the elements off by more than 1.5
    bf16 steps of their own size (a p rounded across a step)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import (BF16_ATOL, BF16_RTOL,
                                               bf16_agreement, check_bf16)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    worst, fails, off = {}, [], 0
    n_dims = len(FLASH_STRESS_DIMS)
    for i in range(FLASH_STRESS_CASES):
        d, dv = FLASH_STRESS_DIMS[i % n_dims]
        window = FLASH_STRESS_WINDOWS[(i // n_dims) %
                                      len(FLASH_STRESS_WINDOWS)]
        q, k, v = (torch.randn((2, 200, h, w), generator=g,
                               device=dev).bfloat16()
                   for h, w in ((16, d), (1, d), (1, dv)))
        got = kops.attention(q, k, v, causal=True, window=window)
        want = plain_attention(q, k, v, causal=True, window=window)
        _worst(worst, bf16_agreement(got, want))
        w = want.float().abs().clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(w))) * 2 ** -7
        off += int(((got.float() - want.float()).abs() > 1.5 * step).sum())
        try:
            check_bf16(got, want, f"flash stress case {i} (D={d}/{dv}, "
                       f"window {window})")
        except AssertionError as e:
            ratio = (got.float() - want.float()).abs() / (
                BF16_ATOL + BF16_RTOL * want.float().abs())
            row = int(ratio.amax(dim=(0, 2, 3)).argmax())
            fails.append(f"{e}; worst element in query row {row}")
    print(f"[3 stress flash] {FLASH_STRESS_CASES} causal bf16 cases (2 x 200 "
          f"x 16/1 heads, (D, Dv) "
          f"{', '.join(map(str, FLASH_STRESS_DIMS))} x windows "
          f"{', '.join(map(str, FLASH_STRESS_WINDOWS))}): "
          f"{len(fails)} fail check_bf16; "
          f"{_bf16_summary(worst)}; {off} elements off by > 1.5 bf16 steps")
    require(not fails, "; ".join(fails[:3]))


def phase_small_program(seed: int) -> None:
    """A mixed program (weighted + unweighted + kg fused CSR, a fused gather
    over a shared table, an spmm singleton, a max-semiring singleton)
    through the executor on the card, against the numpy oracle."""
    from repro_torch.convert import program_inputs_to_torch
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import (EmbeddingOp, EmbeddingProgram,
                                      Semiring, make_program_inputs,
                                      program_reference)
    prog = EmbeddingProgram("smoke-mixed", (
        ("w", EmbeddingOp("sls", 50, 90, 96, avg_lookups=3, weighted=True)),
        ("u", EmbeddingOp("sls", 40, 70, 96, avg_lookups=2)),
        ("k", EmbeddingOp("kg", 60, 110, 96)),
        ("g1", EmbeddingOp("gather", 60, 200, 96)),
        ("g2", EmbeddingOp("gather", 60, 200, 96)),
        ("solo", EmbeddingOp("spmm", 30, 50, 5, avg_lookups=2)),
        ("mx", EmbeddingOp("sls", 30, 40, 128, avg_lookups=3,
                           semiring=Semiring("max"))),
    ), shared_tables=(("g1", "g2"),))
    host = make_program_inputs(prog, seed=seed)
    ins = program_inputs_to_torch(host, "cuda")
    got = executor_for(prog, "O3").step(ins)
    worst = 0.0
    for name, want in program_reference(prog, host).items():
        g = got[name].cpu().numpy()
        require(g.shape == want.shape and np.isfinite(g).all(),
                f"small program {name}: shape {g.shape} vs {want.shape}")
        require(np.allclose(g, want, rtol=1e-4, atol=1e-4),
                f"small program {name}: disagrees with the numpy oracle")
        worst = max(worst, float(np.abs(g - want).max()))
    print(f"[3 oracle] {len(prog.ops)}-op mixed program through the executor "
          f"== numpy program_reference (max abs err {worst:.3g}, tol 1e-4)")


# ---------------------------------------------------------------------------
# Phase 4: DLRM-DCNv2 sparse arch
# ---------------------------------------------------------------------------

def dlrm_program():
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    return EmbeddingProgram("dlrm-dcnv2", tuple(
        (f"f{i}", EmbeddingOp("sls", DLRM_BATCH, min(rows, DLRM_ROW_CAP),
                              DLRM_DIM, avg_lookups=hot))
        for i, (rows, hot) in enumerate(zip(DLRM_ROWS, DLRM_MULTI_HOT))))


def _time_steps(ex, steps):
    """Drive the executor one step at a time (submit, then wait on the
    step's result): host clock for the whole step and for ``submit`` alone
    (host-side validation, packing, copies and launches)."""
    import torch
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    outs, times, submit = [], [], []
    for ins in steps:
        t0 = time.perf_counter()
        h = ex.submit(ins)
        t1 = time.perf_counter()
        out = h.result()
        ex.drain()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        submit.append(t1 - t0)
        outs.append(out)
    return outs, times, submit, kops.launch_counts()


def _device_time(fn, wall: list = None) -> list:
    """Device time by kernel and copy of one call of ``fn`` under
    torch.profiler: [(name, microseconds)], largest first.  ``wall``, if
    given, gets the host ms of that call (synchronised), the profiler's
    own processing after it left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if wall is not None:
            wall.append((time.perf_counter() - t0) * 1e3)
    return sorted(((e.key, e.self_device_time_total)
                   for e in tp.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda kv: -kv[1])


def _busy(dev: list, wall_ms: float, top: int = 5) -> str:
    if not dev:
        return "device time not measured (the profiler saw no CUDA events)"
    busy_ms = sum(us for _, us in dev) / 1e3
    return (f"device busy {busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.1f}% "
            f"of the {wall_ms:.3f} ms step (idle "
            f"{100 - 100 * busy_ms / wall_ms:.1f}%): " +
            ", ".join(f"{k[:40]} {us / 1e3:.4f} ms" for k, us in dev[:top]))


def _host_top(fn, top: int = 5) -> str:
    """One call of ``fn`` under cProfile: the host functions with the most
    own time, and their call counts."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.runcall(fn)
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return ", ".join(f"{f[2]} {tt * 1e3:.2f} ms ({nc} calls)"
                     for f, (_, nc, tt, _, _) in rows)


def _where_the_time_goes(ex, ins, step_ms: float, top: int = 5) -> str:
    """Two more steps, one under cProfile (the host functions with the most
    own time) and one under torch.profiler (device time by kernel and copy,
    and its share of the unprofiled ``step_ms``)."""
    host = _host_top(lambda: ex.step(ins), top)
    device = _busy(_device_time(lambda: ex.step(ins)), step_ms, top)
    return f"host (cProfile, own time): {host}; {device}"


def _unique_rows(idxs: np.ndarray, roff: np.ndarray, ptrs=None) -> int:
    if ptrs is not None:
        seg = np.repeat(np.arange(len(ptrs) - 1), np.diff(ptrs))
        rows = idxs[:len(seg)].astype(np.int64) + roff[seg]
    else:
        rows = idxs.astype(np.int64) + roff
    return int(np.unique(rows).size)


def phase_dlrm(seed: int, n_steps: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.executor import executor_for
    from repro_torch.kernels import ops as kops, ref
    torch.cuda.reset_peak_memory_stats()
    prog = dlrm_program()
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    units = ex.compiled.units
    require(len(units) == 1 and len(units[0].names) == len(DLRM_ROWS),
            f"DLRM should fuse into one unit, got {len(units)}")
    g = torch.Generator(device="cuda").manual_seed(seed)
    tables = [torch.randn((op.num_embeddings, DLRM_DIM), generator=g,
                          device="cuda") for _, op in prog.ops]
    stacked_rows = sum(t.shape[0] for t in tables)
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        ins = {}
        for (name, op), table, hot in zip(prog.ops, tables, DLRM_MULTI_HOT):
            ins[name] = {
                "table": table,
                "ptrs": np.arange(0, DLRM_BATCH * hot + 1, hot,
                                  dtype=np.int32),
                "idxs": rng.integers(0, op.num_embeddings,
                                     DLRM_BATCH * hot).astype(np.int32)}
        steps.append(ins)
    outs, times, submit, counts = _time_steps(ex, steps)
    variants = kops.variant_launch_counts()["sls"]
    require(counts["sls"] == n_steps and
            variants == {"rows": n_steps, "sparse": 0},
            f"DLRM main path launched sls {counts['sls']} times ({variants})"
            f", expected {n_steps}, all sls_kernel")
    worst = 0.0
    for ins, out in zip(steps, outs):
        for name, _ in prog.ops:
            s = ins[name]
            want = ref.sls(s["table"], torch.from_numpy(s["ptrs"]).cuda(),
                           torch.from_numpy(s["idxs"]).cuda(),
                           num_segments=DLRM_BATCH)
            worst = max(worst, check_close(out[name], want,
                                           f"DLRM step op {name}",
                                           **TOL_SUM_F32))
    lookups = sum(len(s["idxs"]) for s in steps[-1].values())
    print(f"[4 dlrm] {n_steps} steps of {len(prog.ops)} tables -> 1 fused "
          f"SLS unit, {stacked_rows} stacked rows x {DLRM_DIM} fp32 "
          f"({stacked_rows * DLRM_DIM * 4 / 1e9:.2f} GB), batch {DLRM_BATCH}, "
          f"uniform ids: "
          f"{lookups} lookups/step ({lookups * DLRM_DIM * 4 / 1e6:.1f} MB of "
          f"rows); sls launches {counts['sls']}; compile {compile_s:.2f} s; "
          f"step 1 (binds + stacks) {times[0] * 1e3:.2f} ms, steps 2-"
          f"{n_steps} mean {np.mean(times[1:]) * 1e3:.3f} ms "
          f"(host clock + synchronize; submit alone "
          f"{np.mean(submit[1:]) * 1e3:.3f} ms); every op == plain per-op "
          f"SLS (max abs err {worst:.3g})")
    print(f"[4 dlrm where] "
          f"{_where_the_time_goes(ex, steps[-1], np.mean(times[1:]) * 1e3)}")
    # the fused unit's kernel at the main path's shape vs its plain version
    u = ex._units[0]
    fused = u.plan.fused_index_inputs(steps[-1])
    dev_in = {k: torch.from_numpy(np.ascontiguousarray(fused[k])).cuda()
              for k in ("ptrs", "idxs", "roff")}
    args = (u.table, dev_in["ptrs"], dev_in["idxs"])
    kw = dict(num_segments=u.plan.num_segments, seg_base=dev_in["roff"])
    got = kops.sls(*args, **kw)
    err = check_close(got, ref.sls(*args, **kw), "fused DLRM SLS unit",
                      **TOL_SUM_F32)
    seg = torch.repeat_interleave(
        torch.arange(u.plan.num_segments, device="cuda"),
        (dev_in["ptrs"][1:] - dev_in["ptrs"][:-1]).long())
    gidx = dev_in["idxs"].long() + dev_in["roff"].long()[seg]
    offsets = dev_in["ptrs"][:-1].long()

    def library():
        return F.embedding_bag(gidx, u.table, offsets, mode="sum")
    check_close(library(), got, "F.embedding_bag vs kernel", **TOL_SUM_F32)
    ms = time_ms(lambda: kops.sls(*args, **kw), 50)
    plain_ms = time_ms(lambda: ref.sls(*args, **kw), 10)
    library_ms = time_ms(library, 50)
    nnz, segs = int(fused["ptrs"][-1]), u.plan.num_segments
    uniq = _unique_rows(fused["idxs"], fused["roff"], fused["ptrs"])
    nbytes = (uniq * DLRM_DIM * 4 + (segs + 1) * 4 + nnz * 4 + segs * 4 +
              segs * DLRM_DIM * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[4 dlrm kernel] fused SLS {segs} segments, {nnz} lookups "
          f"({uniq} distinct rows): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; kernel at "
          f"{nbytes / ms / 1e6:.0f} GB/s); max abs err {err:.3g} vs plain; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    result = {"name": "sls", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_kernels.cu",
              "replaces": "src/repro/kernels/sls.py:67",
              "variant": "sls_kernel",
              "launches": counts["sls"], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": library_ms, "held_against_plain": True}
    # phase 17 takes the tables, the steps and their outputs; the stacked
    # table goes with the executor
    keep = {"prog": prog, "steps": steps, "outs": outs,
            "compile_s": compile_s}
    del ex, u, tables, args, kw, got, dev_in, gidx, seg
    free_cuda()
    return result, keep


# ---------------------------------------------------------------------------
# Phase 5: DeepSeek-V2-Lite LM step lookups
# ---------------------------------------------------------------------------

def phase_deepseek(seed: int, n_steps: int, card: str) -> dict:
    import torch
    from repro_torch.configs.deepseek_v2_lite_16b import config
    from repro_torch.core.executor import executor_for
    from repro_torch.kernels import _build, gather as kgather, ops as kops, ref
    from repro_torch.models.lm import embedding_program
    torch.cuda.reset_peak_memory_stats()
    cfg = config()
    batch, seq = 8, 2048
    prog = embedding_program(cfg, batch, seq)
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    units = ex.compiled.units
    require(len(units) == 1 and len(units[0].names) == 3,
            f"DeepSeek step lookups should fuse into one unit, got "
            f"{len(units)}")
    ops = dict(prog.ops)
    g = torch.Generator(device="cuda").manual_seed(seed)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=g,
                        device="cuda")
    capacity = torch.randn((ops["moe_dispatch"].num_embeddings, cfg.d_model),
                           generator=g, device="cuda")
    tables = {"tok_embed": embed, "label_gather": embed,
              "moe_dispatch": capacity}
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        steps.append({name: {"table": tables[name],
                             "idxs": rng.integers(
                                 0, op.num_embeddings if name == "moe_dispatch"
                                 else cfg.vocab_size,
                                 op.num_segments).astype(np.int32)}
                      for name, op in prog.ops})
    outs, times, submit, counts = _time_steps(ex, steps)
    variants = kops.variant_launch_counts()["block_gather"]
    require(counts["block_gather"] == n_steps and
            variants == {"bulk": n_steps, "group": n_steps, "rows": 0},
            f"DeepSeek main path launched block_gather "
            f"{counts['block_gather']} times ({variants}), expected the bulk "
            f"variant and its grouping pass {n_steps} times each")
    for ins, out in zip(steps, outs):
        for name, _ in prog.ops:
            s = ins[name]
            check_close(out[name], ref.block_gather(
                s["table"], torch.from_numpy(s["idxs"]).cuda()),
                f"DeepSeek step op {name}")
    u = ex._units[0]
    segs = u.plan.num_segments
    print(f"[5 deepseek] {cfg.name} {batch}x{seq} tokens (uniform ids): "
          f"{n_steps} steps of "
          f"{len(prog.ops)} gathers -> 1 fused gather unit, {segs} rows out "
          f"of a {u.table.shape[0]}-row stacked table x {cfg.d_model} fp32 "
          f"({u.table.numel() * 4 / 1e9:.2f} GB); block_gather launches "
          f"{counts['block_gather']} (bulk {variants['bulk']}, grouping "
          f"pass {variants['group']}); compile {compile_s:.2f} s; step 1 "
          f"{times[0] * 1e3:.2f} ms, steps 2-{n_steps} mean "
          f"{np.mean(times[1:]) * 1e3:.3f} ms (submit alone "
          f"{np.mean(submit[1:]) * 1e3:.3f} ms); every op == plain per-op "
          f"gather (bit-exact)")
    print(f"[5 deepseek where] "
          f"{_where_the_time_goes(ex, steps[-1], np.mean(times[1:]) * 1e3)}")
    row_bytes = cfg.d_model * 4
    lib = _build.library()

    def fused_gather(step):
        """The fused unit's kernel at one step's ids, held bit-exact to the
        plain version, index_select and the rows variant: (idxs, roff, max
        abs error, the kernel's ms, index_select's ms, the rows variant's
        ms, distinct rows, the bytes that must move, the bound in ms)."""
        fused = u.plan.fused_index_inputs(step)
        idxs = torch.from_numpy(np.ascontiguousarray(fused["idxs"])).cuda()
        roff = torch.from_numpy(np.ascontiguousarray(fused["roff"])).cuda()
        got = kops.block_gather(u.table, idxs, roff=roff)
        err = check_close(got, ref.block_gather(u.table, idxs, roff=roff),
                          "fused DeepSeek gather unit")
        rows = idxs.long() + roff.long()
        check_close(torch.index_select(u.table, 0, rows), got[:, 0],
                    "torch.index_select vs kernel")
        # the rows variant (the kernel before the bulk one), launched as the
        # wrapper launches it, on the same inputs
        rows_out = torch.empty_like(got)

        def rows_variant():
            kgather.launch_variant("rows", u.table, idxs, rows_out, roff=roff)
        rows_variant()
        check_close(rows_out, got, "gather rows variant vs bulk")
        ms = time_ms(lambda: kops.block_gather(u.table, idxs, roff=roff), 50)
        library_ms = time_ms(lambda: torch.index_select(u.table, 0, rows), 50)
        rows_ms = time_ms(rows_variant, 50)
        uniq = _unique_rows(fused["idxs"], fused["roff"])
        nbytes = uniq * row_bytes + segs * 8 + segs * row_bytes
        return (idxs, roff, err, ms, library_ms, rows_ms, uniq, nbytes,
                nbytes / HBM_BYTES_PER_S * 1e3)

    idxs, roff, err, ms, library_ms, rows_ms, uniq, nbytes, bound_ms = \
        fused_gather(steps[-1])
    plain_ms = time_ms(lambda: ref.block_gather(u.table, idxs, roff=roff), 20)
    scratch = torch.empty(lib.ember_gather_scratch_bytes(segs),
                          dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    group_ms = time_ms(lambda: lib.ember_gather_group(
        idxs.data_ptr(), roff.data_ptr(), scratch.data_ptr(), segs, stream),
        50)
    src = torch.empty((segs, cfg.d_model), device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), 50)
    copy_bytes = 2 * src.numel() * 4
    del scratch, src, dst
    peak = torch.cuda.max_memory_allocated()
    print(f"[5 deepseek kernel] fused gather {segs} rows ({uniq} distinct): "
          f"kernel {ms:.4f} ms (bulk variant; its grouping pass alone "
          f"{group_ms:.4f} ms; the rows variant {rows_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, torch.index_select {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s; "
          f"kernel at {nbytes / ms / 1e6:.0f} GB/s); bit-exact vs plain; "
          f"dst.copy_(src) of the output's {copy_bytes / 2e9:.3f} GB "
          f"{copy_ms:.4f} ms ({copy_bytes / copy_ms / 1e9:.3f} TB/s read + "
          f"written); peak device memory {peak / 2**30:.2f} GiB; {card}")
    # a realistic id stream: Zipf(1.05) token ids over the vocabulary, the
    # labels the same tokens shifted by one, the MoE dispatch a random
    # permutation of the capacity slots, each filled once
    zipf = np.arange(1, cfg.vocab_size + 1, dtype=np.float64) ** -1.05
    token_of_rank = rng.permutation(cfg.vocab_size)
    stream_ids = token_of_rank[rng.choice(cfg.vocab_size, batch * seq + 1,
                                          p=zipf / zipf.sum())]
    real = {"tok_embed": stream_ids[:-1],
            "label_gather": stream_ids[1:],
            "moe_dispatch": rng.permutation(
                ops["moe_dispatch"].num_embeddings)[
                    :ops["moe_dispatch"].num_segments]}
    real_step = {name: {"table": tables[name],
                        "idxs": real[name].astype(np.int32)}
                 for name, _ in prog.ops}
    _, _, _, z_ms, z_library_ms, z_rows_ms, z_uniq, z_bytes, z_bound_ms = \
        fused_gather(real_step)
    print(f"[5 deepseek zipf] the same unit on a realistic stream (Zipf(1.05) "
          f"token ids, labels shifted by one, MoE dispatch a permutation of "
          f"the capacity slots): {segs} rows ({z_uniq} distinct): kernel "
          f"{z_ms:.4f} ms (bulk variant; the rows variant {z_rows_ms:.4f} "
          f"ms), torch.index_select {z_library_ms:.4f} ms, bound "
          f"{z_bound_ms:.4f} ms ({z_bytes / 1e6:.1f} MB); bit-exact vs plain; "
          f"{card}")
    result = {"name": "block_gather", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_kernels.cu",
              "replaces": "src/repro/kernels/gather.py:32",
              "variant": "gather_bulk_kernel",
              "launches": variants["bulk"],
              "group_launches": variants["group"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes", "library_ms": library_ms,
              "group_ms": group_ms, "rows_variant_ms": rows_ms,
              "copy_ms": copy_ms,
              "zipf_ms": z_ms, "zipf_library_ms": z_library_ms,
              "zipf_rows_variant_ms": z_rows_ms,
              "zipf_bound_ms": z_bound_ms, "held_against_plain": True}
    keep = {"prog": prog, "steps": steps, "outs": outs}
    del ex, u, tables, embed, capacity, idxs, roff, real_step
    free_cuda()
    return result, keep


# ---------------------------------------------------------------------------
# Phase 17: the vocab-sharded executor, two ranks on the card
# ---------------------------------------------------------------------------

def _zipf_ids(rng, rows: int, n: int, mult: int) -> np.ndarray:
    """``n`` ids of a ``rows``-row table, Zipf(SHARDED_ZIPF)-distributed
    over ranks (the continuous power law's inverse CDF, floored), rank r
    mapped to row ``(r * mult) % rows`` (a bijection: ``mult`` is a prime
    that divides no table size), so the head lies spread over the rows."""
    a = 1.0 - SHARDED_ZIPF
    u = rng.random(n)
    x = (1.0 + u * ((rows + 1.0) ** a - 1.0)) ** (1.0 / a)
    r = np.minimum(np.floor(x).astype(np.int64) - 1, rows - 1)
    return ((r * mult) % rows).astype(np.int32)


def _zipf_steps(prog, rng, n_steps: int, mult: int) -> list:
    """DLRM steps (ids only) on a Zipf stream with head ``mult``."""
    out = []
    for _ in range(n_steps):
        out.append({name: {
            "ptrs": np.arange(0, DLRM_BATCH * hot + 1, hot, dtype=np.int32),
            "idxs": _zipf_ids(rng, op.num_embeddings, DLRM_BATCH * hot,
                              mult)}
            for (name, op), hot in zip(prog.ops, DLRM_MULTI_HOT)})
    return out


def _rel_l2(got, want) -> float:
    import torch
    norm = torch.linalg.vector_norm
    d = norm(got.float() - want.float(), dtype=torch.float64)
    return float(d / norm(want.float(), dtype=torch.float64).clamp_min(
        1e-30))


def _gloo_takes_cuda() -> dict:
    """Whether gloo takes CUDA tensors directly, by collective: each is
    called once on a small tensor of the card in a group of its own (a
    refusal raises on every rank alike, before anything is sent) and its
    result checked.  A finding printed beside the run; the executor stages
    every gloo collective through the host whatever it says."""
    import datetime
    import torch
    import torch.distributed as dist
    g = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=30))
    n, r = dist.get_world_size(g), dist.get_rank(g)
    x = torch.arange(2 * n, dtype=torch.float32, device="cuda") + 10 * r
    calls = {
        "all_to_all_single": lambda: _a2a(x, g),
        "all_reduce": lambda: _ar(x, g),
        "reduce_scatter": lambda: _rs(x, g),
        "all_gather": lambda: _ag(x, g)}
    out = {}
    for name, call in calls.items():
        try:
            got = call().cpu()
        except RuntimeError as e:          # the finding: gloo refused it
            out[name] = "refuses: " + str(e).splitlines()[0][:80]
            continue
        out[name] = "takes" if torch.equal(got, _gloo_expected(
            name, n, r)) else "takes (wrong result)"
    dist.destroy_process_group(g)
    return out


def _a2a(x, g):
    import torch.distributed as dist
    o = x.new_empty(x.shape)
    dist.all_to_all_single(o, x, group=g)
    return o


def _ar(x, g):
    import torch.distributed as dist
    o = x.clone()
    dist.all_reduce(o, group=g)
    return o


def _rs(x, g):
    import torch.distributed as dist
    o = x.new_empty(x.numel() // dist.get_world_size(g))
    (getattr(dist, "reduce_scatter_single", None) or
     dist.reduce_scatter_tensor)(o, x, group=g)
    return o


def _ag(x, g):
    import torch.distributed as dist
    o = x.new_empty(x.numel() * dist.get_world_size(g))
    (getattr(dist, "all_gather_single", None) or
     dist.all_gather_into_tensor)(o, x, group=g)
    return o


def _gloo_expected(name: str, n: int, r: int):
    import torch
    xs = [torch.arange(2 * n, dtype=torch.float32) + 10 * k
          for k in range(n)]
    if name == "all_to_all_single":
        return torch.cat([xs[k][2 * r:2 * r + 2] for k in range(n)])
    if name == "all_reduce":
        return sum(xs)
    if name == "reduce_scatter":
        return sum(xs)[2 * r:2 * r + 2]
    return torch.cat(xs)


class _LastCall:
    """A kernel wrapper that keeps its last call's arguments and result
    (the shapes the sharded path gives it).  Its other attributes are the
    wrapped function's (a wrapper counts its launches on itself, by its
    module-level name)."""

    def __init__(self, fn):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "last", None)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        if name in ("fn", "last"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.fn, name, value)

    def __call__(self, *a, **kw):
        out = self.fn(*a, **kw)
        self.last = (a, kw, out)
        return out


def _sharded_drive(ex, steps, want, want_fn=None) -> dict:
    """Drive ``ex`` over ``steps`` (launch counts zeroed first), each
    step's whole outputs held against ``want[k]`` (or ``want_fn(k)``): the
    worst relative L2 and whether every output was bit-equal, the host ms
    of each step (synchronised), the collectives' share of the steps, and
    the launches."""
    import torch
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    st = ex.stats
    rel, equal, times = 0.0, True, []
    coll = {"collectives": 0, "staged_bytes": 0, "collective_ms": 0.0}
    stats0 = {k: st[k] for k in (
        "exchange_index_bytes", "exchange_row_bytes", "hot_lookups",
        "cold_lookups", "host_syncs", "spilled_lookups")}
    for k, ins in enumerate(steps):
        before = {key: st[key] for key in coll}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = ex.step(ins)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for key in coll:
            coll[key] += st[key] - before[key]
        full = ex.full_outputs(outs)
        ref_k = want[k] if want_fn is None else want_fn(k)
        for name, w in ref_k.items():
            g = full[name].reshape(w.shape)
            rel = max(rel, _rel_l2(g, w))
            equal = equal and torch.equal(g, w)
    counts = kops.launch_counts()
    stats = {k: st[k] - stats0[k] for k in stats0}
    return {"rel_l2": rel, "bit_equal": equal, "ms": times,
            "collective": coll,
            "sls": counts["sls"],
            "sls_rows": kops.variant_launch_counts()["sls"]["rows"],
            "gather": counts["block_gather"],
            "gather_group": kops.variant_launch_counts()[
                "block_gather"]["group"],
            "transpose": kops.backward_launch_counts()["gather_transpose"],
            "stats": stats}


def _sharded_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of phase 17 (a spawned process sharing the card): the
    DLRM-DCNv2 and DeepSeek-V2-Lite drives of :func:`phase_sharded` through
    ``executor_for(..., mesh=...)``, every output held against phases 4
    and 5 (or the plain per-op SLS on the Zipf stream), and the kernels at
    the sharded path's shapes held against their plain versions.  Returns
    plain numbers."""
    import torch
    from repro_torch.core.access_plan import canonical_hot
    from repro_torch.core.executor import executor_for
    from repro_torch.data.locality import AdaptiveHotConfig
    from repro_torch.kernels import gather as kgather, ops as kops, ref
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats()
    out = {"gloo_cuda": _gloo_takes_cuda()}
    dl, ds = job["dlrm"], job["deepseek"]
    prog, steps, want = dl["prog"], dl["steps"], dl["outs"]
    stacked_bytes = sum(op.num_embeddings * op.emb_len * 4
                        for _, op in prog.ops)
    # a 1-wide model axis is the single-device executor: rank 0 holds it
    # bit for bit against phase 4's first step
    mesh1 = make_host_mesh(1)
    if rank == 0:
        ex = executor_for(prog, "O3", mesh=mesh1)
        got = ex.step(steps[0])
        out["one_wide"] = {"shards": ex.shards, "bit_equal": all(
            torch.equal(got[n], want[0][n]) for n in want[0])}
        del ex, got
        free_cuda()      # the executor's closures make a cycle: collect it
    mesh = make_host_mesh(world)
    # the kernels' last calls on the sharded path, for the checks below
    wrapped = {"sls": _LastCall(kops.sls),
               "block_gather": _LastCall(kops.block_gather),
               "transpose": _LastCall(kgather.transposed_lookups)}
    kops.sls, kops.block_gather = wrapped["sls"], wrapped["block_gather"]
    kgather.transposed_lookups = wrapped["transpose"]
    runs = {}
    for mode, repl in (("host", True), ("collective", False)):
        for w in wrapped.values():
            w.last = None        # it holds the last executor's table
        t0 = time.perf_counter()
        ex = executor_for(prog, "O3", mesh=mesh, exchange=mode,
                          replicate_outputs=repl)
        compile_s = time.perf_counter() - t0
        run = _sharded_drive(ex, steps, want)
        run.update(compile_s=compile_s,
                   local_bytes=ex._units[0].table.numel() * 4,
                   slab_bytes=ex._units[0].plan.hot_slab_bytes,
                   slots=len(ex._units[0].plan.slots),
                   wire_per_step=run["stats"]["exchange_index_bytes"] /
                   len(steps),
                   hot_share=ex.access_plan_stats()["hot_traffic_fraction"])
        runs[f"dlrm_{mode}"] = run
        del ex
        free_cuda()
    checks = {}
    a, kw, got = wrapped["sls"].last
    checks["sls"] = {
        "shape": f"{kw['num_segments']} segments, "
                 f"{int(a[1][-1])} lookups of {a[2].numel()}",
        "err": max_err(got, ref.sls(*a, **kw)),
        "ms": time_ms(lambda: wrapped["sls"].fn(*a, **kw), 20),
        "plain_ms": time_ms(lambda: ref.sls(*a, **kw), 5)}
    check_close(got, ref.sls(*a, **kw), "sharded local SLS pool",
                **TOL_SUM_F32)
    a, kw, (order, ptrs) = wrapped["transpose"].last
    p_order, p_ptrs = ref.transposed_lookups(*a, **kw)
    require(torch.equal(order, p_order) and torch.equal(ptrs, p_ptrs),
            "sharded lattice rebuild: ember_transpose != the plain one")
    checks["transpose"] = {
        "shape": f"{a[0].numel()} received slots, {a[2]} segments + "
                 "sentinel",
        "ms": time_ms(lambda: wrapped["transpose"].fn(*a, **kw), 20),
        "plain_ms": time_ms(lambda: ref.transposed_lookups(*a, **kw), 5)}
    for w in wrapped.values():
        w.last = None
    free_cuda()
    # the Zipf stream: a hot slab from a warm-up trace, then one swap to
    # the head of a drifted stream
    z = job["zipf"]
    cfg = AdaptiveHotConfig(window_steps=4, num_windows=2,
                            min_swap_interval=1 << 20)
    tables = {name: steps[0][name]["table"] for name, _ in prog.ops}

    def plain(zsteps):
        def want_fn(k):
            return {name: ref.sls(tables[name],
                                  torch.from_numpy(s["ptrs"]).cuda(),
                                  torch.from_numpy(s["idxs"]).cuda(),
                                  num_segments=DLRM_BATCH)
                    for name, s in zsteps[k].items()}
        return want_fn

    def with_tables(zsteps):
        return [{name: {**s, "table": tables[name]}
                 for name, s in st.items()} for st in zsteps]
    ex = executor_for(prog, "O3", mesh=mesh, hot_rows=z["hot_a"],
                      adaptive=cfg)
    za, zb = with_tables(z["steps_a"]), with_tables(z["steps_b"])
    run = _sharded_drive(ex, za, None, plain(za))
    run.update(wire_per_step=run["stats"]["exchange_index_bytes"] / len(za),
               hot_share=ex.window_stats()["hot_traffic_fraction"],
               local_bytes=ex._units[0].table.numel() * 4,
               slab_bytes=ex._units[0].plan.hot_slab_bytes,
               slots=len(ex._units[0].plan.slots))
    runs["zipf_a"] = run
    t0 = time.perf_counter()
    swapped = ex.swap_hot_slab(z["hot_b"])
    swap_s = time.perf_counter() - t0
    run = _sharded_drive(ex, zb, None, plain(zb))
    run.update(wire_per_step=run["stats"]["exchange_index_bytes"] / len(zb),
               hot_share=ex.window_stats()["hot_traffic_fraction"],
               swapped=swapped, swap_s=swap_s, epoch=ex.slab_epoch,
               hot_digest=hashlib.sha256(repr(canonical_hot(
                   ex.hot_rows)).encode()).hexdigest()[:16],
               local_bytes=ex._units[0].table.numel() * 4,
               slab_bytes=ex._units[0].plan.hot_slab_bytes,
               slots=len(ex._units[0].plan.slots))
    runs["zipf_b"] = run
    for w in wrapped.values():
        w.last = None
    del ex
    free_cuda()
    # DeepSeek-V2-Lite's fused gather unit, both exchanges, bit for bit
    for mode, repl in (("host", True), ("collective", False)):
        ex = executor_for(ds["prog"], "O3", mesh=mesh, exchange=mode,
                          replicate_outputs=repl)
        runs[f"deepseek_{mode}"] = _sharded_drive(ex, ds["steps"],
                                                  ds["outs"])
        del ex
        free_cuda()
    a, kw, got = wrapped["block_gather"].last
    require(torch.equal(got, ref.block_gather(*a, **kw)),
            "sharded local block gather != the plain gather")
    checks["block_gather"] = {"shape": f"{a[1].numel()} blocks"}
    kops.sls, kops.block_gather = wrapped["sls"].fn, \
        wrapped["block_gather"].fn
    kgather.transposed_lookups = wrapped["transpose"].fn
    free, total = torch.cuda.mem_get_info()
    out.update(runs=runs, checks=checks, stacked_bytes=stacked_bytes,
               peak=torch.cuda.max_memory_allocated(), card_total=total,
               card_used=total - free)
    return out


def _free_after_sharded() -> None:
    """Free phases 4 and 5's tables once the ranks have let them go, and
    require it: the phases after need the card (phase 12 all of it)."""
    import torch
    free_cuda()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    print(f"[17 sharded after] this process holds {held / 2**30:.2f} GiB; "
          f"the card {(total - free) / 2**30:.2f} of {total / 2**30:.2f} "
          f"GiB in use")
    require(held < 1 << 30, f"phase 17 left {held / 2**30:.2f} GiB "
            "allocated (tables shared with the ranks not released)")


def phase_sharded(seed: int, n_steps: int, card: str, dlrm: dict,
                  deepseek: dict) -> dict:
    """Phase 17: two ranks on the one card (spawned, a gloo group over a
    file store) drive phase 4's DLRM-DCNv2 steps and phase 5's
    DeepSeek-V2-Lite lookups through the vocab-sharded executor; the
    tables reach the ranks by CUDA IPC and each builds only its local
    table.  Returns the sharded launches by kernel."""
    from repro_torch.core import access_plan as ap
    from repro_torch.core.cost_model import FusionBudget
    from repro_torch.data.locality import classify_hot_from_counts
    from repro_torch.launch.mesh import run_ranks
    prog = dlrm["prog"]
    rng = np.random.default_rng(seed + 17)
    t0 = time.perf_counter()
    warm = _zipf_steps(prog, rng, 1, SHARDED_HEAD_A)[0]
    hot_a = ap.hot_rows_from_traces(
        prog, {n: s["idxs"] for n, s in warm.items()},
        FusionBudget(shards=2, hot_slab_bytes=SHARDED_SLAB_BYTES))
    warm_b = _zipf_steps(prog, rng, 1, SHARDED_HEAD_B)[0]
    hot_b = {}
    for name, op in prog.ops:
        if name in hot_a:
            counts = np.bincount(warm_b[name]["idxs"],
                                 minlength=op.num_embeddings)
            hot_b[name] = tuple(int(i) for i in classify_hot_from_counts(
                counts, len(hot_a[name]),
                prev_hot=np.asarray(hot_a[name])))
    zipf = {"hot_a": hot_a, "hot_b": hot_b,
            "steps_a": _zipf_steps(prog, rng, SHARDED_ZIPF_STEPS,
                                   SHARDED_HEAD_A),
            "steps_b": _zipf_steps(prog, rng, SHARDED_ZIPF_STEPS,
                                   SHARDED_HEAD_B)}
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # DeepSeek's replicated output is 1.07 GB a step, staged through the
    # host twice: the first SHARDED_DEEPSEEK_STEPS of phase 5's steps
    ds = {"prog": deepseek["prog"],
          "steps": deepseek["steps"][:SHARDED_DEEPSEEK_STEPS],
          "outs": deepseek["outs"][:SHARDED_DEEPSEEK_STEPS]}
    ranks = run_ranks(_sharded_rank, 2, ({
        "dlrm": {k: dlrm[k] for k in ("prog", "steps", "outs")},
        "deepseek": ds, "zipf": zipf},), timeout_s=600)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    require(r0["one_wide"] == {"shards": 1, "bit_equal": True},
            f"a 1-wide mesh is not phase 4's single-device step: "
            f"{r0['one_wide']}")
    print(f"[17 sharded setup] gloo on CUDA tensors, directly: "
          f"{r0['gloo_cuda']} (the executor stages every gloo collective "
          f"through pinned host buffers); Zipf({SHARDED_ZIPF}) streams and "
          f"hot slabs {setup_s:.2f} s on the host; 2 ranks spawned, run "
          f"and joined in {ranks_s:.1f} s; a 1-wide mesh == phase 4's "
          f"step bit for bit; {card}")
    hot_slab = {}
    for rank, res in enumerate(ranks):
        runs = res["runs"]
        for key, run in runs.items():
            st, coll, ms = run["stats"], run["collective"], run["ms"]
            if key.startswith("deepseek"):
                require(run["bit_equal"], f"rank {rank} {key}: DeepSeek "
                        "lookups differ from phase 5's bits")
            else:
                require(run["rel_l2"] <= SHARDED_REL_L2,
                        f"rank {rank} {key}: relative L2 {run['rel_l2']:.3g}"
                        f" > {SHARDED_REL_L2} against the single device")
            extra = ""
            if "local_bytes" in run:
                half = res["stacked_bytes"] / 2
                limit = half + run["slab_bytes"] + run["slots"] * \
                    DLRM_DIM * 4
                require(run["local_bytes"] <= limit,
                        f"rank {rank} {key}: local table "
                        f"{run['local_bytes']} B > half the stack + slab")
                extra = (f"; local table {run['local_bytes'] / 1e9:.3f} GB "
                         f"of the {res['stacked_bytes'] / 1e9:.3f} GB stack "
                         f"({run['local_bytes'] / res['stacked_bytes']:.4f};"
                         f" hot slab {run['slab_bytes'] / 1e9:.4f} GB)")
                hot_slab[key] = run["slab_bytes"]
            if "compile_s" in run:
                extra += f"; compile {run['compile_s']:.2f} s"
            if "swapped" in run:
                extra += (f"; swap_hot_slab {run['swapped']} in "
                          f"{run['swap_s']:.3f} s, slab epoch {run['epoch']}")
            print(f"[17 sharded {key} rank {rank}] {len(ms)} steps: step 1 "
                  f"{ms[0]:.2f} ms, steps 2-{len(ms)} mean "
                  f"{np.mean(ms[1:]):.3f} ms (host clock, synchronised); "
                  f"worst relative L2 {run['rel_l2']:.3g} (bit-equal "
                  f"{run['bit_equal']}); {coll['collectives']} collectives, "
                  f"{coll['staged_bytes'] / 1e6:.2f} MB staged, "
                  f"{coll['collective_ms']:.2f} ms; exchange_index_bytes "
                  f"{st['exchange_index_bytes']}, exchange_row_bytes "
                  f"{st['exchange_row_bytes']}, hot/cold lookups "
                  f"{st['hot_lookups']}/{st['cold_lookups']}, host_syncs "
                  f"{st['host_syncs']}, spilled {st['spilled_lookups']}; "
                  f"launches: ember_sls {run['sls']}, block gather "
                  f"{run['gather']} (grouping {run['gather_group']}), "
                  f"ember_transpose {run['transpose']}{extra}")
        print(f"[17 sharded memory rank {rank}] peak "
              f"{res['peak'] / 2**30:.2f} GiB allocated by the rank; card "
              f"{res['card_used'] / 2**30:.2f} of "
              f"{res['card_total'] / 2**30:.2f} GiB in use by every process "
              f"at the rank's end")
    for key in ("zipf_a", "zipf_b"):
        require(all(r["runs"][key]["hot_share"] >
                    r["runs"]["dlrm_collective"]["hot_share"] and
                    r["runs"][key]["wire_per_step"] <
                    r["runs"]["dlrm_collective"]["wire_per_step"]
                    for r in ranks),
                f"{key}: the hot slab did not cut the wire volume")
    zb = [r["runs"]["zipf_b"] for r in ranks]
    require(all(z["swapped"] for z in zb) and
            zb[0]["epoch"] == zb[1]["epoch"] == 1 and
            zb[0]["hot_digest"] == zb[1]["hot_digest"],
            f"the ranks disagree on the swap: {zb}")
    c = r0["checks"]
    print(f"[17 sharded kernels] at the sharded path's shapes on rank 0: "
          f"ember_sls ({c['sls']['shape']}) {c['sls']['ms']:.4f} ms, plain "
          f"{c['sls']['plain_ms']:.4f} ms, max abs err "
          f"{c['sls']['err']:.3g}; ember_transpose "
          f"({c['transpose']['shape']}) {c['transpose']['ms']:.4f} ms, "
          f"plain {c['transpose']['plain_ms']:.4f} ms, order and ptrs "
          f"equal; block gather ({c['block_gather']['shape']}) bit-equal; "
          f"Zipf hot share {zb[0]['hot_share']:.4f} after the swap against "
          f"{r0['runs']['zipf_a']['hot_share']:.4f} before and 0 uniform; "
          f"wire bytes/step {r0['runs']['zipf_a']['wire_per_step']:.0f} "
          f"(Zipf) against {r0['runs']['dlrm_collective']['wire_per_step']:.0f}"
          f" (uniform); {card}")
    launches = {k: sum(r["runs"][run][k] for r in ranks
                       for run in r["runs"])
                for k in ("sls", "gather", "transpose")}
    require(all(launches.values()),
            f"a kernel of the sharded path never launched: {launches}")
    return {"launches": launches, "sls_err": c["sls"]["err"],
            "sls_ms": c["sls"]["ms"], "sls_plain_ms": c["sls"]["plain_ms"],
            "transpose_ms": c["transpose"]["ms"],
            "transpose_plain_ms": c["transpose"]["plain_ms"],
            "sls_shape": c["sls"]["shape"],
            "transpose_shape": c["transpose"]["shape"]}


# ---------------------------------------------------------------------------
# Phase 6: GNN message passing (FusedMM) at ogbn-products scale
# ---------------------------------------------------------------------------

def _fusedmm_plain_in_chunks(x, ptrs, idxs, out=None, what: str = ""):
    """The plain version over every segment, CHUNK segments at a time (at
    full size its gathered neighbour rows alone would be 49.5 GB).  Holds
    ``out`` against it when given; returns the max abs error."""
    from repro_torch.kernels import ref
    n = ptrs.numel() - 1
    err = 0.0
    for lo in range(0, n, GNN_CHECK_SEGMENTS):
        hi = min(lo + GNN_CHECK_SEGMENTS, n)
        want = ref.fusedmm(x, ptrs[lo:hi + 1], idxs, num_segments=hi - lo,
                           first_segment=lo)
        if out is not None:
            err = max(err, check_close(out[lo:hi], want,
                                       f"{what} segments {lo}:{hi}",
                                       **TOL_GNN))
    return err


def _fusedmm_variants_ms(x, ptrs, idxs, iters: int) -> dict:
    """Both FusedMM variants on x, each launched as the wrapper launches it:
    the rows variant held to the ring (TOL_GNN, or check_bf16) in chunks of
    segments, then each timed (ms)."""
    import torch
    from repro_torch.kernels import fusedmm as kfusedmm
    from repro_torch.kernels.agreement import check_bf16
    n = ptrs.numel() - 1
    outs = {v: torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
            for v in ("ring", "rows")}
    for v, out in outs.items():
        kfusedmm.launch_variant(v, x, ptrs, idxs, out)
    for lo in range(0, n, GNN_CHECK_SEGMENTS):
        got = outs["rows"][lo:lo + GNN_CHECK_SEGMENTS]
        want = outs["ring"][lo:lo + GNN_CHECK_SEGMENTS]
        what = (f"fusedmm rows variant vs ring ({x.dtype}, E={x.shape[1]}, "
                f"segments from {lo})")
        if x.dtype == torch.bfloat16:
            check_bf16(got, want, what)
        else:
            check_close(got, want, what, **TOL_GNN)
    return {v: time_ms(lambda v=v, out=out: kfusedmm.launch_variant(
        v, x, ptrs, idxs, out), iters) for v, out in outs.items()}


def phase_gnn(seed: int, n_steps: int, card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.executor import executor_for
    from repro_torch.core.ops import EmbeddingOp, EmbeddingProgram
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.sls import kernel_variant
    torch.cuda.reset_peak_memory_stats()
    n, e = OGBN_NODES, OGBN_FEATURES
    prog = EmbeddingProgram("ogbn-products-mp", (
        ("mp", EmbeddingOp("fusedmm", n, n, e,
                           avg_lookups=round(OGBN_DIRECTED_EDGES / n))),))
    t0 = time.perf_counter()
    ex = executor_for(prog, "O3")
    compile_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    ptrs = np.zeros(n + 1, np.int32)
    np.cumsum(rng.poisson(OGBN_DIRECTED_EDGES / n, n), out=ptrs[1:])
    nnz = int(ptrs[-1])
    idxs = rng.integers(0, n, nnz, dtype=np.int32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn((n, e), generator=g, device="cuda")
          for _ in range(n_steps)]          # fresh features every step
    steps = [{"mp": {"x": x, "ptrs": ptrs, "idxs": idxs}} for x in xs]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    outs, times, submit, counts = _time_steps(ex, steps)
    variants = kops.variant_launch_counts()["fusedmm"]
    # at 400-byte rows the rows variant is the faster (the ring takes rows
    # from kernels.sls.FUSEDMM_RING_MIN_ROW_BYTES on; [6 gnn widths] below)
    variant = kernel_variant("fusedmm", e, 4, True)
    require(counts["fusedmm"] == n_steps and variant == "rows" and
            variants == {"ring": 0, "rows": n_steps},
            f"GNN main path launched fusedmm {counts['fusedmm']} times "
            f"({variants}), expected the rows variant {n_steps} times")
    require(ex.stats["table_rebinds"] == n_steps - 1,
            "fresh x every step must rebind the dense operand")
    dptrs = torch.from_numpy(ptrs).cuda()
    didxs = torch.from_numpy(idxs).cuda()
    err = 0.0
    for i, (x, out) in enumerate(zip(xs, outs)):
        err = max(err, _fusedmm_plain_in_chunks(x, dptrs, didxs, out["mp"],
                                                f"GNN step {i}"))
    step_ms = np.mean(times[1:]) * 1e3
    print(f"[6 gnn] ogbn-products sizes, synthetic graph (Poisson degrees, "
          f"mean {OGBN_DIRECTED_EDGES / n:.2f}, uniform neighbours): {n} "
          f"nodes, {nnz} CSR entries, {e} fp32 features; {n_steps} steps of "
          f"1 fusedmm unit, fresh x each step; fusedmm launches "
          f"{counts['fusedmm']} ({variant} variant {variants[variant]}); "
          f"compile {compile_s:.2f} s, data {data_s:.2f} "
          f"s; step 1 {times[0] * 1e3:.2f} ms, steps 2-{n_steps} mean "
          f"{step_ms:.3f} ms (submit alone {np.mean(submit[1:]) * 1e3:.3f} "
          f"ms; pinned staging {ex.pool.stats['bytes'] / 1e9:.2f} GB); every "
          f"step == plain version in chunks of {GNN_CHECK_SEGMENTS} segments "
          f"(max abs err {err:.3g}, tol rtol=1e-4 atol=1e-2)")
    print(f"[6 gnn where] {_where_the_time_goes(ex, steps[-1], step_ms)}")
    x = xs[-1]

    def kernel():
        return kops.fusedmm(x, dptrs, didxs, num_segments=n)
    ms = time_ms(kernel, 10)
    # both variants on the same inputs, and at other row widths of the same
    # graph: where the ring overtakes the rows variant
    both = _fusedmm_variants_ms(x, dptrs, didxs, 10)
    widths = {}
    for dtype, sweep in zip((torch.float32, torch.bfloat16),
                            GNN_SWEEP_WIDTHS):
        for width in sweep:
            xw = torch.randn((n, width), generator=g, device="cuda").to(dtype)
            widths[dtype, width] = _fusedmm_variants_ms(xw, dptrs, didxs, 5)
            del xw
    t0 = time.perf_counter()
    _fusedmm_plain_in_chunks(x, dptrs, didxs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes = n * e * 4 + nnz * 4 + (n + 1) * 4 + n * e * 4
    flops = 4 * e * nnz          # dot + axpy per neighbour row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    # on this graph (uniform neighbours, L2 holds ~5 % of x) nearly every
    # neighbour row comes from HBM: its bytes, and the 32-byte sectors a row
    # at its alignment in x touches
    row = e * 4
    no_l2_ms = nnz * row / HBM_BYTES_PER_S * 1e3
    sectors = np.mean([(j * row % 32 + row + 31) // 32 for j in range(32)])
    sectors_ms = nnz * sectors * 32 / HBM_BYTES_PER_S * 1e3
    # yardsticks: the same scattered reads without the dot (not the same
    # function), and the rate a contiguous copy streams on this card
    lidx = didxs.long()
    offsets = dptrs[:-1].long()

    def same_reads():
        return F.embedding_bag(lidx, x, offsets, mode="sum")
    bag_ms = time_ms(same_reads, 5)
    del lidx, offsets
    dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: dst.copy_(x), 20)
    copy_tbs = 2 * x.numel() * 4 / copy_ms / 1e9
    del dst
    peak = torch.cuda.max_memory_allocated()
    print(f"[6 gnn kernel] fusedmm {n} segments, {nnz} lookups of {row} B "
          f"rows: kernel {ms:.4f} ms ({variant} variant; rows "
          f"{both['rows']:.4f} ms, ring {both['ring']:.4f} ms), plain "
          f"{plain_ms:.1f} ms (in chunks, "
          f"host clock), library none (no single PyTorch call computes "
          f"FusedMM); bound {bound_ms:.4f} ms = max(bytes once "
          f"{nbytes / 1e9:.3f} GB / 3.35 TB/s = {bytes_ms:.4f} ms, "
          f"{flops / 1e9:.2f} GFLOP / 67 TFLOP/s fp32 = {flops_ms:.4f} ms); "
          f"on this graph every neighbour row from HBM "
          f"({nnz * row / 1e9:.1f} GB) would take {no_l2_ms:.2f} ms, "
          f"{sectors_ms:.2f} ms in the {sectors:.2f} 32-byte sectors a row "
          f"touches (kernel at {nnz * row / ms / 1e9:.3f} TB/s of row "
          f"bytes); F.embedding_bag(mode='sum') over the same ptrs/idxs and "
          f"x (the same scattered reads without the dot, not the same "
          f"function) {bag_ms:.4f} ms; dst.copy_(x) of {x.numel() * 4 / 1e9:.3f}"
          f" GB {copy_ms:.4f} ms ({copy_tbs:.3f} TB/s read + written); peak "
          f"device memory {peak / 2**30:.2f} GiB; {card}")
    print("[6 gnn widths] the same graph at other widths, ring vs rows "
          "variant (ms): " + ", ".join(
              f"{str(dt)[6:]} E={w} ({w * dt.itemsize} B) {t['ring']:.4f} vs "
              f"{t['rows']:.4f}" for (dt, w), t in widths.items()) +
          f"; {card}")
    result = {"name": "fusedmm", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_fusedmm.cu",
              "replaces": "src/repro/kernels/fusedmm.py:41",
              "variant": "fusedmm_kernel",
              "launches": variants[variant], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
              "library_ms": None, "rows_variant_ms": both["rows"],
              "ring_variant_ms": both["ring"],
              "ring_vs_rows_ms_by_width": {
                  f"{str(dt)[6:]} E={w}": [t["ring"], t["rows"]]
                  for (dt, w), t in widths.items()},
              "hbm_rows_ms": no_l2_ms,
              "hbm_sectors_ms": sectors_ms, "same_reads_bag_ms": bag_ms,
              "copy_tb_per_s": copy_tbs, "held_against_plain": True}
    del ex, xs, steps, outs, x, dptrs, didxs
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 7: chatglm3-6b prefill (flash attention in every layer)
# ---------------------------------------------------------------------------

class _OpSwap:
    """Route one of the model's entry points through ``fn`` while active:
    ``kernels.ops.<name>`` by default (which the model modules look up at
    each call: ``attention``, ``block_gather``), or ``<module>.<name>``
    (``models.moe.route``): a plain version for a whole-prefill comparison,
    a recorder of a layer's inputs, or a replay of recorded decisions."""

    def __init__(self, name: str, fn, module=None):
        self.name, self.fn, self.module = name, fn, module

    def __enter__(self):
        if self.module is None:
            from repro_torch.kernels import ops as kops
            self.module = kops
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)
        return False


def phase_chatglm3(seed: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()

    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    times, last = [], None
    for _ in range(PREFILLS):
        t0 = time.perf_counter()
        last = model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = kops.launch_counts()
    instances = dict(kops.flash_attention_cuda.instances)
    require(counts["flash_attention"] == PREFILLS * cfg.num_layers,
            f"chatglm3 prefill launched flash_attention "
            f"{counts['flash_attention']} times, expected "
            f"{PREFILLS * cfg.num_layers}")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "prefill output")
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)

    plain = plain_attention

    # one more prefill through the kernel, every layer's attention output
    # held against the plain version on that layer's own q, k, v
    per_layer, first = [], []

    def held(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        per_layer.append(check_bf16(
            out, plain(q, k, v, **kw),
            f"flash kernel on layer {len(per_layer)}'s q, k, v"))
        if not first:
            first.append((q, k, v, kw))
        return out
    with _OpSwap("attention", held):
        model.prefill(tokens)
    require(len(per_layer) == cfg.num_layers, "one attention call per layer")
    layers = {}
    for a in per_layer:
        _worst(layers, a)
    err = layers["max_abs"]

    with _OpSwap("attention", plain):
        plain_last = model.prefill(tokens)
    diff = (last.float() - plain_last.float())
    rel_l2 = float(diff.norm() / plain_last.float().norm())
    require(rel_l2 <= PREFILL_REL_L2 and bool(torch.isfinite(diff).all()),
            f"prefill with the kernel vs plain attention: relative L2 "
            f"{rel_l2:.3g} > {PREFILL_REL_L2}")

    q, k, v, kw = first.pop()
    b, s, h, d = q.shape
    hkv = k.shape[2]

    def kernel():
        return kops.attention(q, k, v, causal=True)
    ms = time_ms(kernel, 10)
    plain_ms = time_ms(lambda: ref.attention(q, k, v, **kw), 2, warmup=1)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = bf16_agreement(library().transpose(1, 2), kernel())
    require(lib["rel_l2"] <= LIBRARY_REL_L2_BF16,
            f"scaled_dot_product_attention vs kernel: relative L2 "
            f"{lib['rel_l2']:.3g} > 2^-7")
    library_ms = time_ms(library, 10)
    flops = 2 * b * h * s * s * d        # causal QK^T and PV
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / BF16_TC_FLOPS >=
                nbytes / HBM_BYTES_PER_S else "bytes")
    del q, k, v, qt, kt, vt

    # one sequence of prefill_32k, the kernel alone
    g = torch.Generator(device="cuda").manual_seed(seed)
    ql = torch.randn((1, LONG_SEQ, h, d), generator=g,
                     device="cuda").bfloat16()
    kl = torch.randn((1, LONG_SEQ, hkv, d), generator=g,
                     device="cuda").bfloat16()
    vl = torch.randn((1, LONG_SEQ, hkv, d), generator=g,
                     device="cuda").bfloat16()
    long_ms = time_ms(lambda: kops.attention(ql, kl, vl, causal=True), 3,
                      warmup=1)
    qlt = ql.transpose(1, 2)
    klt = kl.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vlt = vl.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    long_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qlt, klt, vlt, is_causal=True), 3, warmup=1)
    long_bound_ms = 2 * h * LONG_SEQ ** 2 * d / BF16_TC_FLOPS * 1e3
    del ql, kl, vl, qlt, klt, vlt
    peak = torch.cuda.max_memory_allocated()
    print(f"[7 chatglm3 prefill] {cfg.name} {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
          f"KV, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, {n_params} "
          f"params (random, seed {seed}; init {init_s:.2f} s); "
          f"{PREFILL_BATCH} x {PREFILL_SEQ} uniform token ids: prefill mean "
          f"{prefill_ms:.2f} ms over {PREFILLS} (host clock + synchronize); "
          f"flash_attention launches {counts['flash_attention']}; "
          f"{_busy(dev, prefill_ms)}; attention kernels "
          f"{attn_us / 1e3:.2f} ms of it; every layer's kernel output == "
          f"plain on its own q, k, v ({cfg.num_layers} layers: "
          f"{_bf16_summary(layers)}); last hidden state == prefill with "
          f"plain attention (relative L2 {rel_l2:.3g}, max abs "
          f"{float(diff.abs().max()):.3g}, tol relative L2 "
          f"{PREFILL_REL_L2}); peak device memory {peak / 2**30:.2f} GiB")
    print(f"[7 chatglm3 kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, Hkv={hkv}, D={d}, causal, bf16): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention (KV heads "
          f"expanded beforehand) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s; kernel at "
          f"{flops / ms / 1e9:.1f} TFLOP/s; vs the library: "
          f"{_bf16_summary(lib)}); prefill_32k sequence (B=1, "
          f"S={LONG_SEQ}): kernel {long_ms:.3f} ms, "
          f"scaled_dot_product_attention {long_lib_ms:.3f} ms, bound "
          f"{long_bound_ms:.3f} ms")
    result = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:65",
              "variant": "flash_wgmma_kernel",
              "launches": counts["flash_attention"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "held_against_plain": True, "instances": instances,
              "chatglm3_prefill_ms": prefill_ms}
    del model, tokens, last, plain_last, diff, per_layer
    free_cuda()
    return result


def phase_stablelm_prefill(seed: int) -> dict:
    """stablelm-3b (head dim 80: the flash kernels' 128-wide instantiation
    on zero-padded columns) through ``LM.prefill`` over the chatglm3
    prefill's 4 x 4096 tokens: one prefill on the main path (a flash
    launch in every layer), more timed; layer 0's kernel output held
    against the plain version on its own q, k, v; the kernel's time at
    that layer's shapes beside its bound at the true width, the plain
    version and ``scaled_dot_product_attention``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("stablelm-3b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    # the main path: one prefill, launches counted from 0
    kops.reset_launch_counts()
    times = []
    t0 = time.perf_counter()
    last = model.prefill(tokens)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    launches = kops.launch_counts()["flash_attention"]
    instances = dict(kops.flash_attention_cuda.instances)
    require(launches == cfg.num_layers,
            f"stablelm-3b prefill launched flash_attention {launches} times, "
            f"expected {cfg.num_layers}")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "stablelm-3b prefill output")
    for _ in range(PREFILLS - 1):
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)

    # layer 0's q, k, v from one more prefill through the kernel
    first = []

    def record(q, k, v, **kw):
        if not first:
            first.append((q, k, v, kw))
        return kops.flash_attention_cuda(q, k, v, **kw)
    with _OpSwap("attention", record):
        again = model.prefill(tokens)
    require(torch.equal(again, last), "stablelm-3b prefill is not repeatable")
    q, k, v, kw = first.pop()
    b, s, h, d = q.shape
    hkv = k.shape[2]
    require(d == 80, f"stablelm-3b head dim {d}, expected 80")

    layer0 = check_bf16(kops.attention(q, k, v, causal=True),
                        plain_attention(q, k, v, **kw),
                        "flash kernel on stablelm-3b layer 0's q, k, v")
    t = _flash_layer(q, k, v, kw, "stablelm-3b layer at D = 80")
    ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
    flops, lib, bound_ms = t["flops"], t["library"], t["bound_ms"]
    peak = torch.cuda.max_memory_allocated()
    print(f"[7 stablelm-3b prefill] {cfg.name} {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV, head dim {d}, rotary {cfg.rotary_pct}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, {n_params} params "
          f"(random, seed {seed}; init {init_s:.2f} s); {PREFILL_BATCH} x "
          f"{PREFILL_SEQ} uniform token ids: prefill mean {prefill_ms:.2f} ms "
          f"over {PREFILLS} (host clock + synchronize); flash_attention "
          f"launches {launches} in the first; {_busy(dev, prefill_ms)}; "
          f"attention kernels {attn_us / 1e3:.2f} ms of it; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[7 stablelm-3b kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, Hkv={hkv}, D={d} on the 128-wide kernel, causal, bf16): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at the true width at "
          f"989 TFLOP/s; kernel at {flops / ms / 1e9:.1f} TFLOP/s of true-"
          f"width work); layer 0 kernel == plain ({_bf16_summary(layer0)}); "
          f"vs the library: {_bf16_summary(lib)}")
    result = {"launches": launches, "instances": instances,
              "d80_ms": ms, "d80_plain_ms": plain_ms,
              "d80_bound_ms": bound_ms, "d80_library_ms": library_ms,
              "d80_max_abs_err": layer0["max_abs"],
              "stablelm_prefill_ms": prefill_ms}
    del model, tokens, last, again, q, k, v
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 8: chatglm3-6b and stablelm-3b served through DecodeServer
# ---------------------------------------------------------------------------

def _percentiles(xs) -> str:
    a = np.asarray(xs, np.float64) * 1e3
    return (f"p50 {np.percentile(a, 50):.2f} ms, p99 "
            f"{np.percentile(a, 99):.2f} ms")


def _serve_drive(model, prompts, chunk: int,
                 new_tokens: int = SERVE_NEW_TOKENS,
                 max_len: int = SERVE_MAX_LEN) -> dict:
    """Serve ``prompts`` (``new_tokens`` each, no EOS) through a fresh
    DecodeServer on the card (its captured wave) of ``max_len`` positions,
    one serving iteration at a time.  Returns the server, the requests,
    the wall seconds, each request's logits row of its last wave
    (``final``), and per iteration
    its wave kind, micro-steps and host seconds (the whole iteration: the
    wave, the pipeline feed and the argmax read back; and the server's
    wave alone, issuing the wave's work)."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    srv = DecodeServer(model, batch_slots=SERVE_SLOTS, max_len=max_len,
                       prefill_chunk=chunk, pipeline=True)
    require(isinstance(srv._wave, WaveGraph),
            "a server on the card must run its captured wave")
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    index = {id(r): i for i, r in enumerate(reqs)}
    out = {"srv": srv, "reqs": reqs, "final": {}, "iters": []}
    wave = srv._wave
    issued = []

    def spy(tokens, lens, caches):
        t0 = time.perf_counter()
        logits, caches = wave(tokens, lens, caches)
        issued.append((int(lens.max()), time.perf_counter() - t0))
        for i, req in enumerate(srv.active):
            if req is not None and lens[i] > 0:
                out["final"][index[id(req)]] = logits[i]
        return logits, caches
    srv._wave = spy
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    while srv.queue or any(r is not None for r in srv.active):
        pre = srv.serve_stats["prefill_waves"]
        t1 = time.perf_counter()
        srv.step()
        kind = ("prefill" if srv.serve_stats["prefill_waves"] > pre
                else "decode")
        micro, issue_s = issued[-1]
        out["iters"].append((kind, micro, time.perf_counter() - t1,
                             issue_s))
    srv.run_until_drained()          # drains the group, final stats
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    srv._wave = wave
    return out


def _lockstep_drive(model, prompts, new_tokens: int, gather=None) -> dict:
    """Serve ``prompts`` through two servers stepped in turn: one replays
    its captured graphs, the other runs ``LM.wave_step`` and
    ``LM.reset_slots`` eagerly on its own caches.  After every serving
    iteration the two waves' logits and every cache leaf must be the same
    bits, and at the end every request's tokens.  ``gather``, if given,
    stands in for ``kernels.ops.block_gather`` once both servers are built
    (their graphs hold the kernel as served): every gather launched
    eagerly, in the eager wave and in both servers' pipeline members, runs
    through it.  Returns the servers, the waves, the micro-steps, the
    leaves compared and each server's host seconds inside its waves."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request
    servers = {n: DecodeServer(model, batch_slots=SERVE_SLOTS,
                               max_len=SERVE_MAX_LEN,
                               prefill_chunk=SERVE_CHUNK, pipeline=True)
               for n in ("graph", "eager")}
    servers["eager"]._wave = model.wave_step
    servers["eager"]._reset = model.reset_slots
    last, host, micro = {}, {"graph": 0.0, "eager": 0.0}, []
    for name, srv in servers.items():
        def spy(tokens, lens, caches, wave=srv._wave, name=name):
            t0 = time.perf_counter()
            logits, caches = wave(tokens, lens, caches)
            host[name] += time.perf_counter() - t0
            last[name] = logits
            if name == "graph":
                micro.append(int(lens.max()))
            return logits, caches
        srv._wave = spy
    reqs = {n: [Request(prompt=p.copy(), max_new_tokens=new_tokens)
                for p in prompts] for n in servers}
    for n, srv in servers.items():
        for r in reqs[n]:
            srv.submit(r)
    graph, eager = servers["graph"], servers["eager"]
    waves = leaves = 0
    with (_OpSwap("block_gather", gather) if gather is not None
          else contextlib.nullcontext()):
        while graph.queue or any(r is not None for r in graph.active):
            graph.step()
            eager.step()
            waves += 1
            require(torch.equal(last["graph"], last["eager"]),
                    f"wave {waves}: the graph's logits differ from the "
                    f"eager wave's")
            for layer, (cg, ce) in enumerate(zip(graph.caches,
                                                 eager.caches)):
                for k in cg:
                    require(torch.equal(cg[k], ce[k]),
                            f"after wave {waves}: cache leaf {k} of layer "
                            f"{layer} differs between graph and eager")
                    leaves += 1
    require(not eager.queue and all(r is None for r in eager.active) and
            eager.serve_stats["waves"] == waves,
            "the eager server's schedule differs from the graph server's")
    for i, (g, e) in enumerate(zip(reqs["graph"], reqs["eager"])):
        require(g.status == e.status == "ok" and g.out == e.out and
                len(g.out) == new_tokens,
                f"request {i}: graph drive emitted {g.out[:6]}... "
                f"({g.status}), eager {e.out[:6]}... ({e.status})")
    return {"servers": servers, "waves": waves, "micro_steps": sum(micro),
            "leaves": leaves, "host_s": host, "reqs": reqs["graph"]}


def _graph_device_ms(srv, iters: int = 20) -> dict:
    """Device ms of one replay of each captured micro-step (CUDA events;
    the masked form with every slot active), on a drained server's caches,
    which the replays overwrite."""
    import torch
    wave = srv._wave
    with torch.inference_mode():         # the buffers are inference tensors
        wave.active.fill_(True)
    return {"unmasked": time_ms(wave.graphs["micro-step"].replay, iters),
            "masked": time_ms(wave.graphs["masked micro-step"].replay,
                              iters)}


def _graph_issue_ms(srv, iters: int = 20) -> float:
    """Host ms to issue one replay of the captured micro-step onto an idle
    device (synchronised before each): the launch alone, without waiting
    for room in the device's queue, which a running drive's issue time
    includes."""
    import torch
    replay = srv._wave.graphs["micro-step"].replay
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / iters


def _drive_metrics(main: dict, new_tokens: int) -> dict:
    reqs, wall, iters = main["reqs"], main["wall"], main["iters"]
    micro_steps = sum(m for _, m, _, _ in iters)
    return {
        "tokens_per_s": len(reqs) * new_tokens / wall,
        "ttft": [r.t_first - r.t_submit for r in reqs],
        "per_token": [b - a for r in reqs
                      for a, b in zip(r.token_times, r.token_times[1:])],
        "decode_ms": [dt * 1e3 for k, _, dt, _ in iters if k == "decode"],
        "prefill_ms": [dt * 1e3 for k, _, dt, _ in iters if k == "prefill"],
        "micro_steps": micro_steps,
        "issue_ms": sum(i for _, _, _, i in iters) * 1e3}


def _require_served(main: dict, new_tokens: int, counts: dict,
                    variants: dict) -> None:
    """(a) every request ok with its tokens; (f) the decode-embed gather
    once a wave: bulk variant + grouping pass."""
    srv, reqs = main["srv"], main["reqs"]
    waves = srv.serve_stats["waves"]
    require(all(r.status == "ok" and len(r.out) == new_tokens
                for r in reqs),
            f"served: not every request ended ok with {new_tokens} tokens: "
            f"{[(r.status, len(r.out)) for r in reqs]}")
    require(variants == {"bulk": waves, "group": waves, "rows": 0} and
            counts["block_gather"] == waves,
            f"served {waves} waves but block_gather launched "
            f"{counts['block_gather']} times ({variants})")
    gs = srv.compile_stats["pipeline_group"]
    require(gs["waves"] == waves, f"pipeline group saw {gs['waves']} waves "
            f"of {waves}")


def _profiled_drive(model, prompts, new_tokens: int, tally=None,
                    want=None) -> dict:
    """Device busy share over a drive: the same drive again (the same
    waves: with no deadline the schedule does not depend on time) under
    torch.profiler, device events only, summed from the raw events.
    Returns the device time by name (ns, largest first), the number of
    device operations and of each by name (replays of a captured graph
    included), the busy ms and the profiled drive's wall s (its idle pads
    left out).  With
    ``tally`` (counts by name -> what a check reads) and ``want``, a trace
    whose tally is not ``want`` is taken again, up to PROFILE_TRIES drives;
    ``short`` lists the tallies of the traces set aside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    short = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        tp = profile(activities=[ProfilerActivity.CUDA])
        tp.start()
        time.sleep(PROFILE_PAD_S)
        wall = _serve_drive(model, prompts, SERVE_CHUNK, new_tokens)["wall"]
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        tp.stop()
        by_name: dict = {}
        count: dict = {}
        for e in tp.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                by_name[e.name()] = by_name.get(e.name(), 0) + \
                    e.duration_ns()
                count[e.name()] = count.get(e.name(), 0) + 1
        if tally is None or tally(count) == want:
            break
        short.append(tally(count))
    return {"dev": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "launches": sum(count.values()), "count": count,
            "busy_ms": sum(by_name.values()) / 1e6, "wall": wall,
            "short": short}


def phase_serving(seed: int, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import embedding_engine as ee
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("chatglm3-6b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, SERVE_REQUESTS)]
    # warm-up: cuBLAS handles, the allocator, the gather library
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK)

    # the main path: the served drive, launches counted from 0
    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    srv, reqs, wall, final = (main["srv"], main["reqs"], main["wall"],
                              main["final"])
    st = srv.serve_stats
    waves = st["waves"]
    _require_served(main, SERVE_NEW_TOKENS, counts, variants)   # (a), (f)
    m = _drive_metrics(main, SERVE_NEW_TOKENS)
    micro_steps = m["micro_steps"]
    capture_s = _capture_seconds(model)

    # (b) chunked prefill == whole prompt: a drive at prefill_chunk=1
    chunk1 = _serve_drive(model, prompts, 1)
    reqs1, final1 = chunk1["reqs"], chunk1["final"]
    for i, (r, r1) in enumerate(zip(reqs, reqs1)):
        require(r.out == r1.out, f"request {i}: prefill_chunk=1 emitted "
                f"{r1.out[:6]}... vs {r.out[:6]}...")
        require(torch.equal(final[i], final1[i]),
                f"request {i}: last-wave logits differ between "
                f"prefill_chunk={SERVE_CHUNK} and 1")

    # (c) staggered admission == solo decode: the latest-admitted request
    late = max(range(SERVE_REQUESTS), key=lambda i: reqs[i].admitted_wave)
    solo = _serve_drive(model, [prompts[late]], SERVE_CHUNK)["reqs"]
    require(solo[0].out == reqs[late].out,
            f"request {late} (admitted at wave "
            f"{reqs[late].admitted_wave}) alone emitted {solo[0].out[:6]}... "
            f"vs {reqs[late].out[:6]}...")

    # (d) decode agrees with prefill: request 0 teacher-forced through the
    # decode path, position by position, against LM.forward (flash)
    seq = np.concatenate([prompts[0], np.asarray(reqs[0].out, np.int32)])
    n_prompt = len(prompts[0])
    caches = model.init_caches(1, SERVE_MAX_LEN)
    dec = []
    with torch.inference_mode():
        for t in range(len(seq)):
            lg, caches = model.decode_step(
                torch.tensor([[int(seq[t])]], device=model.device), caches)
            if t >= n_prompt - 1:
                dec.append(lg[0, 0])
        dec = torch.stack(dec)
        hidden = model(torch.from_numpy(seq[None]).long().to(model.device))
        fwd = ee.logits(hidden, model.embed)[0, n_prompt - 1:,
                                             :cfg.vocab_size]
    rel_l2 = float((dec - fwd).norm() / fwd.norm())
    require(rel_l2 <= PREFILL_REL_L2 and bool(torch.isfinite(dec).all()),
            f"decode vs prefill logits: relative L2 {rel_l2:.3g} > "
            f"{PREFILL_REL_L2}")
    top2 = fwd.topk(2, dim=-1).values
    rms = fwd.square().mean(-1).sqrt()
    clear = (top2[:, 0] - top2[:, 1]) > PREFILL_REL_L2 * rms
    same = dec.argmax(-1) == fwd.argmax(-1)
    require(bool(same[clear].all()),
            f"decode vs prefill: argmax differs at positions "
            f"{torch.nonzero(clear & ~same).flatten().tolist()} whose top-2 "
            f"margin exceeds {PREFILL_REL_L2} x the row's RMS")

    # (e) the group's outputs, kernel vs stock op vs embed[tokens]
    toks = np.asarray([r.out[-1] for r in reqs[:SERVE_SLOTS]], np.int32)
    name = srv.pipeline_group.names[0]
    wave = {name: {"tok_embed": {"table": model.embed, "idxs": toks},
                   "label_gather": {"table": model.embed, "idxs": toks}}}
    got = srv.pipeline_group.submit_wave(wave)[name].result()
    stock = model.embedding_pipeline(SERVE_SLOTS, 1, backend="torch")
    other = stock.submit_wave(wave)[name].result()
    want = model.embed[torch.from_numpy(toks).long().to(model.device)]
    for n in got:
        require(torch.equal(got[n], other[n]) and
                torch.equal(got[n][:, 0], want),
                f"decode-embed {n}: backend cuda vs torch vs embed[tokens]")

    # (g) the captured wave == the eager wave, bit for bit, wave by wave
    lock = _lockstep_drive(model, prompts, SERVE_NEW_TOKENS)
    for i, (r, r2) in enumerate(zip(reqs, lock["reqs"])):
        require(r.out == r2.out, f"request {i}: the lockstep drive emitted "
                f"{r2.out[:6]}... vs the main drive's {r.out[:6]}...")
    graph_dev = _graph_device_ms(srv)

    prof = _profiled_drive(model, prompts, SERVE_NEW_TOKENS)
    dev, launches, busy_ms, prof_wall = (prof["dev"], prof["launches"],
                                         prof["busy_ms"], prof["wall"])
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    step_bytes = n_params * 2          # every bf16 weight once a micro-step
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    c = EAGER_BASELINE
    ttft, per_token = m["ttft"], m["per_token"]
    lock_ms = {n: t * 1e3 / lock["micro_steps"]
               for n, t in lock["host_s"].items()}
    print(f"[8 chatglm3 serving] {cfg.name} {cfg.num_layers} layers, "
          f"{n_params} params, bf16 (random, seed {seed}; init "
          f"{init_s:.2f} s); DecodeServer(batch_slots={SERVE_SLOTS}, "
          f"max_len={SERVE_MAX_LEN}, prefill_chunk={SERVE_CHUNK}, "
          f"pipeline=True), captured wave (3 CUDA graphs built in "
          f"{capture_s:.2f} s with the server): {SERVE_REQUESTS} requests "
          f"(prompts {lo}-{hi} tokens, {sum(len(p) for p in prompts)} in "
          f"all), {SERVE_NEW_TOKENS} new tokens each, all ok; {waves} waves "
          f"({st['prefill_waves']} prefill, {st['decode_waves']} decode) in "
          f"{wall:.2f} s: {m['tokens_per_s']:.1f} generated tokens/s "
          f"(eager baseline {c['tokens_per_s']}); TTFT "
          f"{_percentiles(ttft)} (eager baseline p50 "
          f"{c['ttft_p50_s'] * 1e3:.0f} ms, p99 {c['ttft_p99_s'] * 1e3:.0f} "
          f"ms); per token {_percentiles(per_token)} (eager baseline p50 "
          f"{c['per_token_p50_ms']}, p99 {c['per_token_p99_ms']} ms); "
          f"block_gather launches {counts['block_gather']} (bulk "
          f"{variants['bulk']}, grouping pass {variants['group']}) = one "
          f"a wave; peak device memory {peak / 2**30:.2f} GiB; {card}")
    print(f"[8 serving where] {micro_steps} micro-steps in {waves} waves; "
          f"host ms issuing them (the captured wave: a copy, a mask and a "
          f"replay a micro-step) {m['issue_ms']:.1f} of the "
          f"{wall * 1e3:.1f} ms drive = {m['issue_ms'] / waves:.2f} ms a "
          f"wave, {m['issue_ms'] / micro_steps:.3f} ms a micro-step (eager "
          f"baseline {c['host_ms_micro_step']}); in the lockstep drive (same "
          f"call) graph {lock_ms['graph']:.3f} vs eager "
          f"{lock_ms['eager']:.2f} host ms a micro-step; device ms of one "
          f"captured micro-step "
          f"(CUDA events, 20 replays) unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"(eager baseline: {c['device_ms_micro_step']} ms of kernels); a "
          f"prefill wave's whole iteration {np.mean(m['prefill_ms']):.2f} "
          f"ms ({len(m['prefill_ms'])} waves); ms per decode wave (wave, "
          f"pipeline feed, argmax read back) mean "
          f"{np.mean(m['decode_ms']):.2f}, p50 "
          f"{np.percentile(m['decode_ms'], 50):.2f} (eager baseline "
          f"{c['ms_decode_wave']}), against {bound_ms:.2f} ms to read every "
          f"weight once at 3.35 TB/s; the drive under torch.profiler: " +
          ("device time not measured (the profiler saw no CUDA events)"
           if not dev else
           f"{launches} device operations = {launches / micro_steps:.0f} a "
           f"micro-step, device busy {busy_ms:.1f} ms = "
           f"{busy_ms / micro_steps:.2f} ms a micro-step = "
           f"{100 * busy_ms / (wall * 1e3):.1f}% of the unprofiled drive's "
           f"{wall * 1e3:.1f} ms (idle "
           f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%; eager baseline "
           f"{c['busy_pct']}% busy; "
           f"{100 * busy_ms / (prof_wall * 1e3):.1f}% of the "
           f"{prof_wall * 1e3:.1f} ms it took under the profiler); top: " +
           ", ".join(f"{k[:40]} {ns / 1e6:.2f} ms" for k, ns in dev[:6])))
    print(f"[8 serving checks] prefill_chunk=1 drive: the same tokens, "
          f"bit-identical last-wave logits ({SERVE_REQUESTS} requests); "
          f"request {late} (admitted at wave {reqs[late].admitted_wave}) "
          f"served alone: the same {SERVE_NEW_TOKENS} tokens; request 0 "
          f"teacher-forced ({len(seq)} tokens): decode vs LM.forward logits "
          f"relative L2 {rel_l2:.3g} (tol {PREFILL_REL_L2}), argmax equal "
          f"at {int(same.sum())}/{len(same)} positions ({int(clear.sum())} "
          f"with a clear top-2 margin, all equal); decode-embed group "
          f"backend cuda == torch == embed[tokens] bit for bit; graph vs "
          f"eager wave in lockstep: {lock['waves']} waves, "
          f"{lock['micro_steps']} micro-steps, every wave's logits and "
          f"every cache leaf after every iteration ({lock['leaves']} "
          f"comparisons) the same bits, the same tokens as the main drive")
    result = {"launches": variants["bulk"],
              "group_launches": variants["group"], "waves": waves,
              "tokens_per_s": m["tokens_per_s"]}
    del model, main, srv, reqs, chunk1, reqs1, final, final1, solo, caches
    del dec, fwd, hidden, stock, got, other, want, prof, lock
    free_cuda()
    return result


def _capture_seconds(model) -> float:
    """Host seconds to build a server on the card: its caches and the
    capture of its three graphs (warm-up and the zeroing reset included)."""
    import torch
    from repro_torch.runtime.server import WaveGraph
    caches = model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    WaveGraph(model, caches)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serving_stablelm(seed: int, card: str) -> dict:
    """stablelm-3b (head dim 80, MHA, partial rotary) served through the
    captured wave: a shorter drive (one generation of 8 slots, 16 new
    tokens each), every request ok, the gather once a wave, and the drive
    in lockstep with the eager wave, bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("stablelm-3b")
    model = LM(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, STABLELM_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 STABLELM_NEW_TOKENS)              # warm-up

    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, STABLELM_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    _require_served(main, STABLELM_NEW_TOKENS, counts, variants)
    m = _drive_metrics(main, STABLELM_NEW_TOKENS)
    lock = _lockstep_drive(model, prompts, STABLELM_NEW_TOKENS)
    for i, (r, r2) in enumerate(zip(main["reqs"], lock["reqs"])):
        require(r.out == r2.out, f"stablelm-3b request {i}: the lockstep "
                f"drive emitted {r2.out[:6]}... vs {r.out[:6]}...")
    graph_dev = _graph_device_ms(main["srv"])
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    bound_ms = n_params * 2 / HBM_BYTES_PER_S * 1e3
    waves = main["srv"].serve_stats["waves"]
    print(f"[8 stablelm-3b serving] {cfg.name} {cfg.num_layers} layers, head "
          f"dim {cfg.hd}, {n_params} params, bf16 (random, seed {seed}); the "
          f"same server settings, captured wave: {STABLELM_REQUESTS} requests "
          f"(prompts {lo}-{hi} tokens), {STABLELM_NEW_TOKENS} new tokens "
          f"each, all ok; {waves} waves, {m['micro_steps']} micro-steps in "
          f"{main['wall']:.2f} s: {m['tokens_per_s']:.1f} generated "
          f"tokens/s; TTFT {_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} (lockstep: graph "
          f"{lock['host_s']['graph'] * 1e3 / lock['micro_steps']:.3f} vs "
          f"eager {lock['host_s']['eager'] * 1e3 / lock['micro_steps']:.2f}"
          f"); device ms of one captured micro-step unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"against {bound_ms:.2f} ms to read every weight once; ms per "
          f"decode wave mean {np.mean(m['decode_ms']):.2f}; block_gather "
          f"launches {counts['block_gather']} = one a wave; graph vs eager "
          f"in lockstep: {lock['waves']} waves, every wave's logits and "
          f"every cache leaf after every iteration ({lock['leaves']} "
          f"comparisons) the same bits, the same tokens; "
          f"peak device memory {peak / 2**30:.2f} GiB; {card}")
    result = {"launches": variants["bulk"],
              "group_launches": variants["group"], "waves": waves,
              "tokens_per_s": m["tokens_per_s"]}
    del model, main, lock
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 9: DeepSeek-V2-Lite (MLA + MoE) prefilled and served
# ---------------------------------------------------------------------------

def _sdpa_backends(library) -> dict:
    """Each scaled_dot_product_attention backend that takes the call, timed
    alone (ms), or why it refuses it (a backend may refuse a value width
    other than the q/k width)."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                library()
                torch.cuda.synchronize()
                out[be.name] = time_ms(library, 10)
        except RuntimeError as e:
            out[be.name] = "refused: " + (str(e).strip().splitlines()
                                          or ["(no message)"])[0][:90]
    return out


def _deepseek_prefill(model, seed: int, card: str) -> dict:
    """``LM.prefill`` of DeepSeek-V2-Lite over 4 x 4096 tokens: one prefill
    on the main path (a flash launch at (192, 128) and an un-dispatch
    gather in every layer), more timed; the flash output held against the
    plain version on its own q, k, v and the un-dispatch
    gather against ``ref.block_gather`` bit for bit, in every layer; the
    last hidden state against a prefill with plain attention and the
    routing pinned to the kernel prefill's, within a fixed bound that a
    planted fault must exceed, and, with its own routing, how many routing
    decisions it takes differently; the flash kernel's time a layer beside
    its bound, the plain version and ``scaled_dot_product_attention``; the
    un-dispatch gather's (both variants) beside ``index_select`` and its
    bytes bound."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.kernels.flash_attention import kv_tile
    from repro_torch.kernels.gather import launch_variant
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe import capacity_of, route
    cfg = model.cfg
    n_layers = cfg.num_layers
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    cap = capacity_of(cfg, PREFILL_BATCH * PREFILL_SEQ)
    torch.cuda.reset_peak_memory_stats()
    model.prefill(tokens)          # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    # the main path: one prefill, launches counted from 0
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    last = model.prefill(tokens)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    counts = kops.launch_counts()
    instances = dict(kops.flash_attention_cuda.instances)
    variants = kops.variant_launch_counts()["block_gather"]
    require(counts["flash_attention"] == n_layers and
            counts["block_gather"] == n_layers and
            variants == {"bulk": n_layers, "group": n_layers, "rows": 0},
            f"DeepSeek-V2-Lite prefill launched flash_attention "
            f"{counts['flash_attention']} and block_gather "
            f"{counts['block_gather']} times ({variants}), expected "
            f"{n_layers} each (bulk variant)")
    require(last.shape == (PREFILL_BATCH, 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "DeepSeek prefill output")
    for _ in range(PREFILLS - 1):
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = float(np.mean(times)) * 1e3
    dev = _device_time(lambda: model.prefill(tokens))
    attn_us = sum(us for k, us in dev if "flash" in k)
    gather_us = sum(us for k, us in dev if "gather_bulk" in k or
                    "group_" in k)

    # one more prefill through the kernels: every layer's flash output held
    # against the plain version on that layer's own q, k, v, every layer's
    # un-dispatch gather against the plain gather bit for bit, and every
    # layer's routing (top-k expert ids) recorded
    per_layer, first, gathers = [], {}, []
    routing = {"kernel": [], "plain": []}

    plain = plain_attention

    def held(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        per_layer.append(check_bf16(
            out, plain(q, k, v, **kw),
            f"flash kernel on DeepSeek layer {len(per_layer)}'s q, k, v"))
        first.setdefault("attention", (q, k, v, kw))
        return out

    def held_gather(table, idxs, **kw):
        out = kops.block_gather_cuda(table, idxs, **kw)
        gathers.append(check_close(
            out, ref.block_gather(table, idxs),
            f"un-dispatch gather on DeepSeek layer {len(gathers)}"))
        first.setdefault("gather", (table, idxs))
        return out

    def recorder(run):
        def record_route(x2d, router, k):
            probs, topw, tope = route(x2d, router, k)
            routing[run].append(tope)
            return probs, topw, tope
        return record_route

    def pinned_route(x2d, router, k):
        """The kernel prefill's top-k experts of this layer, weighted by
        this prefill's own probabilities (renormalised as ``route`` does)."""
        probs, _, _ = route(x2d, router, k)
        tope = routing["kernel"][pinned_route.layer]
        pinned_route.layer += 1
        topw = probs.gather(-1, tope)
        return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), tope
    pinned_route.layer = 0

    with _OpSwap("attention", held), _OpSwap("block_gather", held_gather), \
            _OpSwap("route", recorder("kernel"), moe_mod):
        again = model.prefill(tokens)
    require(torch.equal(again, last), "DeepSeek prefill is not repeatable")
    require(len(per_layer) == len(gathers) == n_layers,
            "one flash and one un-dispatch gather a layer")
    layers = {}
    for a in per_layer:
        _worst(layers, a)
    # the last hidden state against a prefill with plain attention and the
    # routing pinned to the kernel prefill's (the held comparison); the
    # same against plain attention over half its KV chunk (a summation
    # order the kernel does not use: this model's own amplification of a
    # rounding step of attention); the kernel prefill with one layer's
    # attention faulted (what the bound must catch); and with plain
    # attention and its own routing (how far such a step moves the routing)
    def plain_half(q, k, v, **kw):
        half = kv_tile(q.dtype, q.shape[3]) // 2
        return ref.attention(q, k, v, **{**kw, "chunk": half})

    caught = {}

    def faulted(layer, fault, name):
        """The kernel in every layer; in ``layer`` on faulted inputs, its
        output then held as the per-layer check holds it (against the plain
        version on the true q, k, v), which must reject it."""
        def attn(q, k, v, **kw):
            attn.calls += 1
            if attn.calls - 1 != layer:
                return kops.flash_attention_cuda(q, k, v, **kw)
            out = kops.flash_attention_cuda(*fault(q, k, v), **kw)
            want = plain(q, k, v, **kw)
            try:
                check_bf16(out, want, name)
            except AssertionError:
                caught[name] = bf16_agreement(out, want)
            return out
        attn.calls = 0
        return attn

    def lost_values(q, k, v):
        v = v.clone()
        v[:, FAULT_KEYS[0]:FAULT_KEYS[1]] = 0
        return q, k, v
    mid = n_layers // 2
    # the end-to-end check must catch the first fault; the second it cannot
    # see (PERF.md), and only the per-layer check catches it
    faults = {"layer 0 at scale 128^-1/2 (the v width's, not the q/k "
              "width's)": (0, lambda q, k, v: (
                  q * (q.shape[-1] / v.shape[-1]) ** 0.5, k, v)),
              f"layer {mid} with the values of keys {FAULT_KEYS[0]}-"
              f"{FAULT_KEYS[1] - 1} lost (one KV tile's V load dropped)":
              (mid, lost_values)}
    runs = {"plain": plain, "plain_half": plain_half,
            **{name: faulted(layer, fault, name)
               for name, (layer, fault) in faults.items()}}
    pinned = {}
    for name, fn in runs.items():
        pinned_route.layer = 0
        with _OpSwap("attention", fn), \
                _OpSwap("route", pinned_route, moe_mod):
            pinned[name] = model.prefill(tokens)
        require(pinned_route.layer == n_layers,
                "routing pinned in every layer")
    with _OpSwap("attention", plain), \
            _OpSwap("route", recorder("plain"), moe_mod):
        free_last = model.prefill(tokens)

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())
    plain_last = pinned.pop("plain")
    diff = last.float() - plain_last.float()
    rel_l2 = rel(last, plain_last)
    floor = rel(pinned.pop("plain_half"), plain_last)
    fault_rel = {name: rel(x, plain_last) for name, x in pinned.items()}
    free_rel_l2 = rel(last, free_last)
    bound = DEEPSEEK_PREFILL_REL_L2
    flips = [int((a != b).sum()) for a, b in zip(routing["kernel"],
                                                 routing["plain"])]
    last_rows = torch.arange(PREFILL_BATCH, device=last.device) * \
        PREFILL_SEQ + PREFILL_SEQ - 1
    last_flips = sum(int((a[last_rows] != b[last_rows]).sum())
                     for a, b in zip(routing["kernel"], routing["plain"]))
    expert_rms = float(first["gather"][0].float().square().mean().sqrt())
    print(f"[9 deepseek checks] every layer's flash output == plain on its "
          f"own q, k, v ({n_layers} layers: {_bf16_summary(layers)}); every "
          f"layer's un-dispatch gather == plain bit for bit; last hidden "
          f"state vs a prefill with plain attention and the routing pinned "
          f"to the kernel prefill's: relative L2 {rel_l2:.4g} (max abs "
          f"{float(diff.abs().max()):.3g}), against a tol of {bound}; the "
          f"same between plain attention over "
          f"{kv_tile(torch.bfloat16, 192)}- and "
          f"{kv_tile(torch.bfloat16, 192) // 2}-key chunks: {floor:.4g}; "
          f"planted faults, routing pinned (the first required above the "
          f"tol; each required to fail its layer's check_bf16): " +
          "; ".join(f"{k}: {v:.4g} (that layer's output relative L2 "
                    f"{caught[k]['rel_l2']:.3g} from plain)"
                    if caught.get(k) else f"{k}: {v:.4g} (passed check_bf16)"
                    for k, v in fault_rel.items()) +
          f"; with plain attention and its own "
          f"routing: relative L2 {free_rel_l2:.3g}, {sum(flips)} of "
          f"{n_layers * routing['kernel'][0].numel()} routing decisions "
          f"differ ({last_flips} at the last positions; by layer {flips}); "
          f"layer 0's expert outputs (its un-dispatch table) have RMS "
          f"{expert_rms:.4g} for inputs of RMS 1")
    require(rel_l2 <= bound and bool(torch.isfinite(diff).all()),
            f"DeepSeek prefill with the kernel vs plain attention (routing "
            f"pinned): relative L2 {rel_l2:.4g} > {bound}")
    gross = next(iter(fault_rel))
    require(fault_rel[gross] > bound, f"DeepSeek prefill with {gross}: "
            f"relative L2 {fault_rel[gross]:.4g} <= {bound}, the end-to-end "
            f"check misses it")
    for name in fault_rel:
        require(caught.get(name) is not None, f"DeepSeek prefill with "
                f"{name}: that layer's output passed check_bf16")

    # layer 0: flash at (192, 128)
    q, k, v, kw = first.pop("attention")
    b, s, h, d = q.shape
    dv = v.shape[3]
    require((d, dv) == (cfg.hd + cfg.rope_head_dim, cfg.hd) == (192, 128),
            f"DeepSeek MLA widths (q/k {d}, v {dv}), expected (192, 128)")

    t = _flash_layer(q, k, v, kw, "DeepSeek MLA layer at (192, 128)")
    ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
    backends, flops, lib = t["backends"], t["flops"], t["library"]
    bound_ms, bound_by = t["bound_ms"], t["bound_by"]
    del q, k, v

    # layer 0: the MoE un-dispatch gather
    table, idxs = first.pop("gather")
    got = kops.block_gather(table, idxs)
    g_err = max(gathers)
    check_close(got[:, 0], table.index_select(0, idxs.long()),
                "un-dispatch gather vs index_select")
    g_ms = time_ms(lambda: kops.block_gather(table, idxs), 50)
    # the variant kernel_variant does not pick here, on the same stream
    by_rows = torch.empty_like(got)
    launch_variant("rows", table, idxs, by_rows)
    check_close(by_rows, got, "un-dispatch gather, rows vs bulk variant")
    g_rows_ms = time_ms(lambda: launch_variant("rows", table, idxs, by_rows),
                        50)
    g_plain_ms = time_ms(lambda: ref.block_gather(table, idxs), 20)
    rows = idxs.long()
    g_library_ms = time_ms(lambda: table.index_select(0, rows), 50)
    row_bytes = table.shape[1] * table.element_size()
    uniq = int(torch.unique(rows).numel())
    g_bytes = uniq * row_bytes + idxs.numel() * 4 + idxs.numel() * row_bytes
    g_bound_ms = g_bytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[9 deepseek prefill] {cfg.name} {n_layers} layers (mla + MoE: "
          f"{cfg.num_experts} routed experts top-{cfg.experts_per_tok} + "
          f"{cfg.num_shared_experts} shared), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, q/k {d} v {dv}, latent {cfg.kv_lora_rank}"
          f", bf16 (random, seed {seed}); {PREFILL_BATCH} x {PREFILL_SEQ} "
          f"uniform token ids, capacity {cap} per expert: prefill mean "
          f"{prefill_ms:.2f} ms over {PREFILLS} (host clock + synchronize); "
          f"flash_attention launches {counts['flash_attention']} and "
          f"un-dispatch block_gather launches {counts['block_gather']} "
          f"(bulk {variants['bulk']}, grouping pass {variants['group']}) in "
          f"the first; {_busy(dev, prefill_ms)}; flash kernels "
          f"{attn_us / 1e3:.2f} ms and un-dispatch gathers "
          f"{gather_us / 1e3:.2f} ms of it; peak device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    print(f"[9 deepseek kernel] flash attention per layer (B={b}, S={s}, "
          f"H={h}, MHA, q/k {d}, v {dv}, causal, bf16): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms (by backend: " +
          ", ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else
                    f"{k} {v}" for k, v in backends.items()) +
          f"), bound {bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s; kernel at {flops / ms / 1e9:.1f} TFLOP/s); vs the "
          f"library: {_bf16_summary(lib)}; {card}")
    print(f"[9 deepseek undispatch] layer 0's MoE un-dispatch out_buf[slot] "
          f"({idxs.numel()} rows of {row_bytes} B from a "
          f"{table.shape[0]}-row capacity buffer, {uniq} distinct): kernel "
          f"{g_ms:.4f} ms (bulk variant with its grouping pass; the rows "
          f"variant on the same stream {g_rows_ms:.4f} ms), plain "
          f"{g_plain_ms:.4f} ms, index_select {g_library_ms:.4f} ms, bound "
          f"{g_bound_ms:.4f} ms ({g_bytes / 1e6:.1f} MB at 3.35 TB/s); "
          f"bit-exact vs plain and index_select; {card}")
    result = {"flash_launches": counts["flash_attention"],
              "flash_instances": instances,
              "gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "mla_ms": ms, "mla_plain_ms": plain_ms,
              "mla_bound_ms": bound_ms, "mla_bound_by": bound_by,
              "mla_library_ms": library_ms,
              "mla_library_backends": backends,
              "mla_max_abs_err": layers["max_abs"],
              "deepseek_prefill_ms": prefill_ms,
              "undispatch_ms": g_ms, "undispatch_rows_ms": g_rows_ms,
              "undispatch_plain_ms": g_plain_ms,
              "undispatch_library_ms": g_library_ms,
              "undispatch_bound_ms": g_bound_ms,
              "undispatch_max_abs_err": g_err}
    del tokens, last, again, pinned, plain_last, free_last, diff, routing
    del table
    del idxs, got, rows, by_rows
    free_cuda()
    return result


def _deepseek_serving(model, seed: int, card: str) -> dict:
    """DeepSeek-V2-Lite served through the captured wave with the stablelm-3b
    settings (8 requests, 16 new tokens): every request ok; every wave
    feeds both pipeline members (decode-embed and MoE un-dispatch) once;
    the un-dispatch member's output held against the stock-op backend and
    indexing; the drive in lockstep with the eager wave, bit for bit, with
    every gather launched eagerly there (one a layer in every eager
    micro-step, both members every wave) held against the plain gather bit
    for bit; the gathers the replayed micro-steps launch (one a layer)
    counted in the device trace.  The prefill_chunk=1 drive of phase 8 is
    not carried over: in an MoE model the tokens depend on the chunking, in
    the reference too (ROADMAP.md, reference caveat (c))."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    cfg = model.cfg
    n_layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 3)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, STABLELM_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 STABLELM_NEW_TOKENS)              # warm-up

    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, STABLELM_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    srv, reqs = main["srv"], main["reqs"]
    waves = srv.serve_stats["waves"]
    m = _drive_metrics(main, STABLELM_NEW_TOKENS)
    require(all(r.status == "ok" and len(r.out) == STABLELM_NEW_TOKENS
                for r in reqs),
            f"DeepSeek served: not every request ended ok: "
            f"{[(r.status, len(r.out)) for r in reqs]}")
    names = srv.pipeline_group.names
    gs = srv.compile_stats["pipeline_group"]
    require(len(names) == 2 and
            gs["submitted"] == {n: waves for n in names},
            f"DeepSeek pipeline group {names} fed {gs['submitted']} in "
            f"{waves} waves, expected both members once a wave")
    # the wrapper counts what its Python launches: one gather a wave for
    # each member, and one a layer in each of the two micro-step bodies,
    # run eagerly by the capture's warm-up and recorded by the capture
    want = 2 * waves + 4 * n_layers
    require(counts["block_gather"] == want and
            variants == {"bulk": want, "group": want, "rows": 0},
            f"DeepSeek served {waves} waves: block_gather counted "
            f"{counts['block_gather']} launches ({variants}), expected "
            f"{want}")

    # (e) the un-dispatch member's output, kernel vs stock op vs indexing,
    # on a random table of the capacity buffer's shape and the server's
    # stream for the last token
    undisp = names[1]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    table = torch.randn(tuple(srv._cap_buf.shape), generator=gen,
                        device=model.device).to(srv._cap_buf.dtype)
    tok0 = int(reqs[0].out[-1])
    idxs = ((np.arange(srv._undisp_segments, dtype=np.int64) * (tok0 + 1))
            % srv._undisp_rows).astype(np.int32)
    wave = {undisp: {"moe_undispatch": {"table": table, "idxs": idxs}}}
    got = srv.pipeline_group.submit_wave(wave)[undisp].result()
    stock = model.embedding_pipeline(SERVE_SLOTS, 1, backend="torch")
    other = stock.submit_wave(wave)[undisp].result()
    indexed = table[torch.from_numpy(idxs).long().to(model.device)]
    require(torch.equal(got["moe_undispatch"], other["moe_undispatch"]) and
            torch.equal(got["moe_undispatch"][:, 0], indexed),
            "MoE un-dispatch member: backend cuda vs torch vs "
            "table[idxs]")

    # (g) graph == eager in lockstep, every eagerly launched gather held
    held = []

    def held_gather(table, idxs, **kw):
        out = kops.block_gather_cuda(table, idxs, **kw)
        plain = ref.block_gather(table, idxs, **kw)
        bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
        held.append((table.data_ptr(), int(table.shape[0]), idxs,
                     (out.view(bits) != plain.view(bits)).sum()))
        return out
    lock = _lockstep_drive(model, prompts, STABLELM_NEW_TOKENS,
                           gather=held_gather)
    for i, (r, r2) in enumerate(zip(reqs, lock["reqs"])):
        require(r.out == r2.out, f"DeepSeek request {i}: the lockstep drive "
                f"emitted {r2.out[:6]}... vs {r.out[:6]}...")
    torch.cuda.synchronize()
    members = {model.embed.data_ptr(): "decode-embed"}
    for s_ in lock["servers"].values():
        members[s_._cap_buf.data_ptr()] = "un-dispatch member"
    n_held, n_diff, in_model = {}, {}, []
    for ptr, rows, idxs_, ndiff in held:
        kind = members.get(ptr, "in-model un-dispatch")
        n_held[kind] = n_held.get(kind, 0) + 1
        n_diff[kind] = n_diff.get(kind, 0) + int(ndiff)
        if kind == "in-model un-dispatch":
            in_model.append((idxs_.numel(), rows,
                             int(torch.unique(idxs_).numel())))
    want_held = {"decode-embed": 2 * lock["waves"],
                 "un-dispatch member": 2 * lock["waves"],
                 "in-model un-dispatch": n_layers * lock["micro_steps"]}
    require(n_held == want_held and not any(n_diff.values()),
            f"DeepSeek lockstep drive: gathers held against the plain "
            f"gather {n_held}, elements differing {n_diff}; expected "
            f"{want_held} and none differing")
    slots = {(g, r) for g, r, _ in in_model}
    distinct = [u for _, _, u in in_model]
    del held, table, got, other, indexed, stock
    graph_dev = _graph_device_ms(srv)
    issue_ms = _graph_issue_ms(srv)
    # the same drive again under the profiler: every gather that ran on the
    # device, the replayed micro-steps' one a layer included, and the
    # warm-up's (the capture launches nothing)
    in_graph = n_layers * m["micro_steps"]
    want_traced = 2 * waves + in_graph + 2 * n_layers
    want = {"gather_bulk_kernel": want_traced,
            "group_insert_kernel": want_traced, "gather_kernel": 0}

    def tally(count: dict) -> dict:
        return {k: sum(n for name, n in count.items() if k in name)
                for k in want}
    prof = _profiled_drive(model, prompts, STABLELM_NEW_TOKENS, tally, want)
    traced = tally(prof["count"])
    require(traced == want,
            f"DeepSeek served {waves} waves, {m['micro_steps']} micro-steps: "
            f"the device trace holds {traced} gathers ({len(prof['short'])} "
            f"of the drive's traces short: {prof['short']}), expected "
            f"{want_traced} bulk gathers, each with its grouping pass")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    wall = main["wall"]
    busy_ms = prof["busy_ms"]
    print(f"[9 deepseek serving] {cfg.name} {n_layers} layers, {n_params} "
          f"params ({w_bytes / 1e9:.2f} GB), bf16 (random, seed {seed}); "
          f"DecodeServer(batch_slots={SERVE_SLOTS}, max_len={SERVE_MAX_LEN}, "
          f"prefill_chunk={SERVE_CHUNK}, pipeline=True), captured wave: "
          f"{STABLELM_REQUESTS} requests (prompts {lo}-{hi} tokens, "
          f"{sum(len(p) for p in prompts)} in all), {STABLELM_NEW_TOKENS} new "
          f"tokens each, all ok; {waves} waves "
          f"({srv.serve_stats['prefill_waves']} prefill), "
          f"{m['micro_steps']} micro-steps in {wall:.2f} s: "
          f"{m['tokens_per_s']:.1f} generated tokens/s; TTFT "
          f"{_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; pipeline members {names} fed "
          f"{gs['submitted']}; block_gather launches counted by the "
          f"wrapper {counts['block_gather']} = {waves} decode-embed + "
          f"{waves} un-dispatch member + {2 * n_layers} in the capture's "
          f"warm-up + {2 * n_layers} recorded by the two micro-step "
          f"captures; in the device trace of the same drive "
          f"{traced['gather_bulk_kernel']} bulk gathers (grouping passes "
          f"{traced['group_insert_kernel']}) = {2 * waves} for the members "
          f"+ {in_graph} in the replayed micro-steps ({n_layers} a "
          f"micro-step) + {2 * n_layers} in the warm-up (traces "
          f"set aside as short: {prof['short']}); peak device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    print(f"[9 deepseek serving checks] un-dispatch member: backend cuda == "
          f"torch == table[idxs] bit for bit ({srv._undisp_segments} rows "
          f"of a random ({srv._undisp_rows}, {cfg.d_model}) table); in the "
          f"lockstep drive every gather launched eagerly == the plain gather "
          f"bit for bit: {n_held} (count by kind), the in-model "
          f"un-dispatch at (slots, capacity rows) {sorted(slots)} with "
          f"{min(distinct)}-{max(distinct)} distinct slots (mean "
          f"{np.mean(distinct):.1f}); graph vs eager in lockstep: "
          f"{lock['waves']} waves, {lock['micro_steps']} micro-steps, every "
          f"wave's logits and every cache leaf after every iteration "
          f"({lock['leaves']} comparisons) the same bits, the same tokens")
    print(f"[9 deepseek serving where] host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} in the drive (lockstep: "
          f"graph {lock['host_s']['graph'] * 1e3 / lock['micro_steps']:.3f}"
          f" vs eager "
          f"{lock['host_s']['eager'] * 1e3 / lock['micro_steps']:.2f}), "
          f"{issue_ms:.3f} to issue one replay onto an idle device; device ms of one captured micro-step (CUDA events, 20 "
          f"replays) unmasked {graph_dev['unmasked']:.3f}, masked "
          f"{graph_dev['masked']:.3f}, against {bound_ms:.2f} ms to read "
          f"every weight once at 3.35 TB/s (every expert of every layer: the "
          f"reference's all-expert products); ms per decode wave mean "
          f"{np.mean(m['decode_ms']):.2f}; the drive under torch.profiler: " +
          ("device time not measured (the profiler saw no CUDA events)"
           if not prof["dev"] else
           f"{prof['launches']} device operations = "
           f"{prof['launches'] / m['micro_steps']:.0f} a micro-step, device "
           f"busy {busy_ms:.1f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of "
           f"the unprofiled drive's {wall * 1e3:.1f} ms (idle "
           f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%) and "
           f"{100 * busy_ms / (prof['wall'] * 1e3):.1f}% of the "
           f"{prof['wall'] * 1e3:.1f} ms it took under the profiler; top: " +
           ", ".join(f"{k[:40]} {ns / 1e6:.2f} ms"
                     for k, ns in prof["dev"][:6])))
    result = {"gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "traced_launches": traced["gather_bulk_kernel"],
              "traced_group_launches": traced["group_insert_kernel"],
              "waves": waves,
              "tokens_per_s": m["tokens_per_s"],
              "device_ms_micro_step": graph_dev["unmasked"],
              "issue_ms_micro_step": issue_ms,
              "bound_ms_micro_step": bound_ms,
              "traces_short": len(prof["short"])}
    del main, srv, reqs, lock, prof
    free_cuda()
    return result


def phase_deepseek_lm(seed: int, card: str) -> dict:
    """DeepSeek-V2-Lite (27 layers, full width, bf16, random weights) built
    once on the card, prefilled (``_deepseek_prefill``) and served
    (``_deepseek_serving``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    print(f"[9 deepseek build] {cfg.name}: "
          f"{sum(p.numel() for p in model.parameters())} params built on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    prefill = _deepseek_prefill(model, seed, card)
    serving = _deepseek_serving(model, seed, card)
    del model
    free_cuda()
    return {"prefill": prefill, "serving": serving}


# ---------------------------------------------------------------------------
# Phases 10-12: the rest of the dense family -- gemma3-4b, h2o-danube-1.8b
# (the sliding window) and llava-next-34b (the vision-stub front end)
# ---------------------------------------------------------------------------

def _flash_bound(q, k, v, window, causal: bool = True) -> tuple:
    """The least time of one flash call on these tensors: the (query, key)
    pairs its band keeps (causal: key <= query, query - key < window; not
    causal: every key), 2 (D + Dv) FLOP each, at the bf16 tensor-core
    peak, against q, k and v read and o written once at the HBM rate.
    Returns (ms, "operations" or "bytes", FLOP)."""
    b, s, h, d = q.shape
    dv = v.shape[3]
    if causal:
        keep = np.arange(1, s + 1, dtype=np.int64)
        if window is not None:
            keep = np.minimum(keep, window)
    else:
        keep = np.full(s, k.shape[1], dtype=np.int64)
    flops = 2 * b * h * int(keep.sum()) * (d + dv)
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv) * \
        q.element_size()
    t_ops, t_bytes = flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def _flash_layer(q, k, v, kw: dict, what: str) -> dict:
    """One layer's flash call timed at its own shapes: the kernel, the plain
    version, and ``scaled_dot_product_attention`` on the same tensors (KV
    heads expanded beforehand) with ``is_causal`` or, for a window, an
    explicit band mask -- the default backend and each backend that takes
    the call; the library held to the kernel below one bf16 step (relative
    L2), and the bound of ``_flash_bound``.  A call that is not causal
    (``kw["causal"]`` False: an encoder's or a cross-attention) runs
    the library with neither flag nor mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import bf16_agreement
    window = kw.get("window")
    causal = kw.get("causal", True)
    s, g = q.shape[1], q.shape[2] // k.shape[2]

    def kernel():
        return kops.attention(q, k, v, causal=causal, window=window)
    ms = time_ms(kernel, 10)
    plain_ms = time_ms(lambda: plain_attention(q, k, v, **kw), 2, warmup=1)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    if window is None:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    else:
        pos = torch.arange(s, device=q.device)
        band = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=band)
    lib = bf16_agreement(library().transpose(1, 2), kernel())
    require(lib["rel_l2"] <= LIBRARY_REL_L2_BF16,
            f"{what}: scaled_dot_product_attention vs kernel: relative L2 "
            f"{lib['rel_l2']:.3g} > 2^-7")
    library_ms = time_ms(library, 10)
    backends = _sdpa_backends(library)
    bound_ms, bound_by, flops = _flash_bound(q, k, v, window, causal)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "backends": backends, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "library": lib}


def _flash_layer_line(tag: str, what: str, q, k, t: dict, card: str) -> str:
    b, s, h, d = q.shape
    backends = ", ".join(f"{n} {v:.4f} ms" if isinstance(v, float)
                         else f"{n} {v}" for n, v in t["backends"].items())
    return (f"[{tag}] {what} (B={b}, S={s}, H={h}, Hkv={k.shape[2]}, "
            f"D={d}, bf16): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention (default "
            f"backend) {t['library_ms']:.4f} ms (by backend: {backends}), "
            f"bound {t['bound_ms']:.4f} ms ({t['flops'] / 1e9:.1f} GFLOP at "
            f"989 TFLOP/s, by {t['bound_by']}; kernel at "
            f"{t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound); library vs "
            f"kernel: {_bf16_summary(t['library'])}; {card}")


def _attention_layers(cfg) -> int:
    """Flash launches in one forward of ``cfg``: a decoder layer's
    self-attention (every kind but the recurrent ``mamba``, ``mlstm`` and
    ``slstm``), an ``xdec`` layer's cross-attention besides, and each
    encoder layer's."""
    from repro_torch.models.lm import layer_kinds
    kinds = layer_kinds(cfg)
    recurrent = sum(kinds.count(k) for k in ("mamba", "mlstm", "slstm"))
    return len(kinds) - recurrent + kinds.count("xdec") + cfg.enc_layers


def _checked_prefill(model, tokens, what: str, fe=None, enc=None,
                     bound: float = PREFILL_REL_L2) -> dict:
    """``LM.prefill`` on the card, as every prefill phase checks it: a
    warm-up, then the main path (launches and flash instances counted from
    0), more timed prefills and one under torch.profiler; one more through
    the kernel with every layer's flash output held against the plain
    version on that layer's own q, k, v (``check_bf16``), recording the
    first layer without a window ("global"), the first with one ("local"),
    and, where calls are not causal, the first before any causal one
    ("encoder") and the first after one ("cross"); and the last hidden
    state against a prefill with plain attention within
    ``bound`` (``PREFILL_REL_L2`` unless the model's depth amplifies a
    rounding step past it: zamba2-7b).  ``fe`` are a vision-stub model's
    frontend_embeds, ``enc`` an encoder-decoder model's enc_embeds."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    cfg = model.cfg
    n_attn = _attention_layers(cfg)
    model.prefill(tokens, fe, enc)     # warm-up (cuBLAS, the allocator)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    last = model.prefill(tokens, fe, enc)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = kops.launch_counts()["flash_attention"]
    instances = dict(kops.flash_attention_cuda.instances)
    require(launches == n_attn,
            f"{what} prefill launched flash_attention {launches} times, "
            f"expected {n_attn}")
    require(last.shape == (tokens.shape[0], 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), f"{what} prefill output")
    for _ in range(PREFILLS - 1):
        t0 = time.perf_counter()
        model.prefill(tokens, fe, enc)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = float(np.mean(times)) * 1e3
    profiled = []
    dev = _device_time(lambda: model.prefill(tokens, fe, enc), profiled)
    per_layer, layers = [], {}

    def held(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        per_layer.append(check_bf16(
            out, plain_attention(q, k, v, **kw),
            f"flash kernel on {what} layer {len(per_layer)}'s q, k, v"))
        if kw.get("causal", True):
            kind = "global" if kw.get("window") is None else "local"
        else:
            kind = "cross" if "global" in layers else "encoder"
        layers.setdefault(kind, (q, k, v, kw))
        return out
    with _OpSwap("attention", held):
        again = model.prefill(tokens, fe, enc)
    require(torch.equal(again, last), f"{what} prefill is not repeatable")
    require(len(per_layer) == n_attn, "one attention call a layer")
    worst = {}
    for a in per_layer:
        _worst(worst, a)
    with _OpSwap("attention", plain_attention):
        plain_last = model.prefill(tokens, fe, enc)
    diff = last.float() - plain_last.float()
    rel_l2 = float(diff.norm() / plain_last.float().norm())
    require(rel_l2 <= bound and bool(torch.isfinite(diff).all()),
            f"{what} prefill with the kernel vs plain attention: relative "
            f"L2 {rel_l2:.3g} > {bound}")
    return {"last": last, "bound": bound, "launches": launches, "instances": instances,
            "prefill_ms": prefill_ms, "dev": dev, "layers": layers,
            "profiled_ms": profiled[0],
            "per_layer": worst, "rel_l2": rel_l2,
            "attn_ms": sum(us for n, us in dev if "flash" in n) / 1e3}


def _prefill_line(tag: str, model, tokens, run: dict, extra: str,
                  init_s: float) -> str:
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    return (f"[{tag}] {cfg.name} {cfg.num_layers} layers "
            f"({extra}), d_model {cfg.d_model}, {cfg.num_heads} heads / "
            f"{cfg.num_kv_heads} KV, head dim {cfg.hd}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}, bf16, {n_params} params (random; init "
            f"{init_s:.2f} s); {tokens.shape[0]} x {tokens.shape[1]} uniform "
            f"token ids: prefill mean {run['prefill_ms']:.2f} ms over "
            f"{PREFILLS} (host clock + synchronize); flash launches "
            f"{run['launches']} in the first ({run['instances']}); "
            f"{_busy(run['dev'], run['prefill_ms'])}; busy "
            f"{sum(us for _, us in run['dev']) / 10 / run['profiled_ms']:.1f}"
            f"% of the {run['profiled_ms']:.2f} ms the profiled prefill "
            f"took; attention kernels "
            f"{run['attn_ms']:.2f} ms of it; every layer's kernel output == "
            f"plain on its own q, k, v ({_bf16_summary(run['per_layer'])}); "
            f"last hidden state == prefill with plain attention (relative L2 "
            f"{run['rel_l2']:.3g}, tol {run['bound']})")


def _window_crossing_drive(model, prompts, new_tokens: int,
                           max_len: int) -> dict:
    """Serve ``prompts`` through a graph server whose waves are checked
    against the eager wave where the window bites: before each wave in
    which some slot's cache passes position ``cfg.sliding_window`` and
    before the first wave in which every active slot decodes past it,
    every cache leaf is cloned, and after the graph's wave ``LM.wave_step``
    runs the same tokens on the clones: its logits and every leaf must be
    the same bits.  Returns the requests and the checked waves."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request
    window = model.cfg.sliding_window
    srv = DecodeServer(model, batch_slots=SERVE_SLOTS, max_len=max_len,
                       prefill_chunk=SERVE_CHUNK, pipeline=True)
    wave = srv._wave
    checked = {"crossing": [], "decode": []}
    n = {"wave": 0, "leaves": 0}

    def compare(tokens, lens, caches, logits, clones, kind):
        want, _ = model.wave_step(tokens, lens, clones)
        require(torch.equal(logits, want),
                f"wave {n['wave']} ({kind}): the graph's logits differ from "
                f"the eager wave's")
        for layer, (cg, ce) in enumerate(zip(caches, clones)):
            for key in cg:
                require(torch.equal(cg[key], ce[key]),
                        f"wave {n['wave']} ({kind}): cache leaf {key} of "
                        f"layer {layer} differs between graph and eager")
                n["leaves"] += 1
        checked[kind].append(n["wave"])

    def spy(tokens, lens, caches):
        n["wave"] += 1
        lens_h = np.asarray(lens)
        before = caches[0]["len"].cpu().numpy()
        kind = None
        if ((before <= window) & (before + lens_h > window)).any():
            kind = "crossing"
        elif not checked["decode"] and lens_h.max() == 1 and \
                (before[lens_h > 0] > window).all():
            kind = "decode"
        clones = None if kind is None else \
            [{k: t.clone() for k, t in c.items()} for c in caches]
        logits, caches = wave(tokens, lens, caches)
        if kind is not None:
            compare(tokens, lens, caches, logits, clones, kind)
        return logits, caches
    srv._wave = spy
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    require(checked["crossing"] and checked["decode"],
            f"the drive never crossed the window of {window} ({checked})")
    return {"reqs": reqs, "checked": checked, "leaves": n["leaves"]}


def phase_gemma3(seed: int, card: str) -> dict:
    """gemma3-4b (34 layers: 29 dense_local with a 1024-token window and 5
    dense, head dim 256, full width, bf16, random weights) through
    ``LM.prefill`` over 4 x 4096 tokens (``_checked_prefill``), the planted
    no-window fault, and the local and global layers' flash times; then
    served: 8 requests of 1024-1280 prompt tokens, 16 new tokens each, in a
    closed batch, through the captured wave, with graph == eager bit for
    bit on the waves where the window bites (``_window_crossing_drive``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma3-4b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed + 10)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    run = _checked_prefill(model, tokens, cfg.name)
    want = {f"bfloat16 256/256 causal window {cfg.sliding_window}": 29,
            "bfloat16 256/256 causal": 5}
    require(run["instances"] == want,
            f"gemma3-4b prefill flash instances {run['instances']}, "
            f"expected {want}")
    print(_prefill_line("10 gemma3 prefill", model, tokens, run,
                        f"29 dense_local, window {cfg.sliding_window}, and "
                        f"5 dense", init_s))

    # the planted fault: the local layer's kernel with no window against
    # the windowed plain version; and a window off by one, read only
    q, k, v, kw = run["layers"]["local"]
    want_local = plain_attention(q, k, v, **kw)
    try:
        check_bf16(kops.attention(q, k, v, causal=True), want_local,
                   "no window")
        caught = False
    except AssertionError:
        caught = True
    nowin = bf16_agreement(kops.attention(q, k, v, causal=True), want_local)
    require(caught, f"the kernel with no window passed the local layer's "
            f"check ({_bf16_summary(nowin)})")
    off = {w: bf16_agreement(kops.attention(q, k, v, causal=True, window=w),
                             want_local)
           for w in (cfg.sliding_window - 1, cfg.sliding_window + 1)}
    print(f"[10 gemma3 fault] the local layer's kernel with no window vs the "
          f"windowed plain version fails check_bf16 as it must "
          f"({_bf16_summary(nowin)}); a window off by one reads " +
          "; ".join(f"{w}: {_bf16_summary(a)}" for w, a in off.items()))
    times = {}
    for kind in ("local", "global"):
        q, k, v, kw = run["layers"][kind]
        times[kind] = _flash_layer(q, k, v, kw, f"gemma3-4b {kind} layer")
        print(_flash_layer_line(
            f"10 gemma3 {kind} kernel",
            f"flash attention a {kind} layer" +
            (f" (window {kw['window']})" if kind == "local" else
             " (causal)"), q, k, times[kind], card))
    del q, k, v, want_local
    run["layers"].clear()
    prefill_ms, launches = run["prefill_ms"], run["launches"]
    instances = run["instances"]
    del run

    # served across the window
    lo, hi = GEMMA_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, GEMMA_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 GEMMA_NEW_TOKENS, max_len=GEMMA_MAX_LEN)     # warm-up
    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, GEMMA_NEW_TOKENS,
                        max_len=GEMMA_MAX_LEN)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    _require_served(main, GEMMA_NEW_TOKENS, counts, variants)
    m = _drive_metrics(main, GEMMA_NEW_TOKENS)
    graph_dev = _graph_device_ms(main["srv"])
    waves = main["srv"].serve_stats["waves"]
    del main["srv"]
    cross = _window_crossing_drive(model, prompts, GEMMA_NEW_TOKENS,
                                   GEMMA_MAX_LEN)
    for i, (r, r2) in enumerate(zip(main["reqs"], cross["reqs"])):
        require(r.out == r2.out, f"gemma3-4b request {i}: the checked drive "
                f"emitted {r2.out[:6]}... vs {r.out[:6]}...")
    peak = torch.cuda.max_memory_allocated()
    bound_ms = n_params * 2 / HBM_BYTES_PER_S * 1e3
    print(f"[10 gemma3 serving] DecodeServer(batch_slots={SERVE_SLOTS}, "
          f"max_len={GEMMA_MAX_LEN}, prefill_chunk={SERVE_CHUNK}, "
          f"pipeline=True), captured wave: {GEMMA_REQUESTS} requests "
          f"(prompts {lo}-{hi} tokens, "
          f"{sum(len(p) for p in prompts)} in all; closed batch), "
          f"{GEMMA_NEW_TOKENS} new tokens each, all ok; {waves} waves, "
          f"{m['micro_steps']} micro-steps in {main['wall']:.2f} s: "
          f"{m['tokens_per_s']:.1f} generated tokens/s; TTFT "
          f"{_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f}; device ms of one "
          f"captured micro-step unmasked {graph_dev['unmasked']:.3f}, "
          f"masked {graph_dev['masked']:.3f} against {bound_ms:.2f} ms to "
          f"read every weight once ({n_params * 2 / 1e9:.2f} GB at 3.35 "
          f"TB/s); ms per decode wave mean {np.mean(m['decode_ms']):.2f}; "
          f"block_gather launches {counts['block_gather']} = one a wave "
          f"(rows of {cfg.d_model * 2} B from {cfg.padded_vocab}); graph vs "
          f"eager where the window bites: waves {cross['checked']}, logits "
          f"and every cache leaf ({cross['leaves']} comparisons) the same "
          f"bits, the same tokens as the main drive; peak device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    result = {"flash_launches": launches, "flash_instances": instances,
              "gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "gemma3_prefill_ms": prefill_ms,
              "gemma3_tokens_per_s": m["tokens_per_s"]}
    for kind, t in times.items():
        result.update({f"gemma3_{kind}_{key}": t[key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")})
    del model, main, cross, tokens
    free_cuda()
    return result


def phase_danube(seed: int, card: str) -> dict:
    """h2o-danube-1.8b (24 dense_local layers, window 4096, head dim 80 on
    the padded kernel, full width, bf16, random weights) through
    ``LM.prefill`` over one sequence of 16384 tokens, where the window
    keeps a quarter of the causal pairs of the last rows
    (``_checked_prefill``), and a layer's flash time at its true width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("h2o-danube-1.8b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 11)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, DANUBE_SEQ))).cuda()
    run = _checked_prefill(model, tokens, cfg.name)
    want = {f"bfloat16 80/80 causal window {cfg.sliding_window}":
            cfg.num_layers}
    require(run["instances"] == want,
            f"h2o-danube-1.8b prefill flash instances {run['instances']}, "
            f"expected {want}")
    print(_prefill_line("11 danube prefill", model, tokens, run,
                        f"dense_local, window {cfg.sliding_window}", init_s))
    q, k, v, kw = run["layers"]["local"]
    t = _flash_layer(q, k, v, kw, "h2o-danube-1.8b layer")
    print(_flash_layer_line(
        "11 danube kernel", f"flash attention a layer (window "
        f"{kw['window']}; D=80 on the 128-wide kernel, bound at the true "
        f"width)", q, k, t, card) +
        f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    result = {"flash_launches": run["launches"],
              "flash_instances": run["instances"],
              "danube_prefill_ms": run["prefill_ms"]}
    result.update({f"danube_{key}": t[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms")})
    del model, run, q, k, v, tokens
    free_cuda()
    return result


def phase_llava(seed: int, card: str) -> dict:
    """llava-next-34b (60 dense layers, d_model 7168, 56 heads over 8 KV
    heads, full width, bf16, random weights: 63.3 GiB) through
    ``LM.prefill`` over one 4096-token sequence with 576 frontend_embeds
    rows spliced over its first positions, as ``launch/steps.py`` shapes
    them (``_checked_prefill``); the splice must move the last hidden
    state; a layer's flash time.  Run alone in a fresh process
    (``--llava-only``), after every earlier phase has freed the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.llava_next_34b import VISION_TOKENS
    from repro_torch.models.lm import LM
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llava-next-34b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 12)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, LLAVA_SEQ))).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    fe = torch.randn((1, VISION_TOKENS, cfg.d_model), generator=g,
                     device="cuda").to(cfg.torch_dtype)
    run = _checked_prefill(model, tokens, cfg.name, fe)
    text_only = model.prefill(tokens)
    moved = float((run["last"].float() - text_only.float()).norm() /
                  text_only.float().norm())
    require(moved > PREFILL_REL_L2, f"the {VISION_TOKENS} spliced rows moved "
            f"the last hidden state by only {moved:.3g} (relative L2)")
    print(_prefill_line("12 llava prefill", model, tokens, run,
                        f"dense, {VISION_TOKENS} frontend_embeds rows "
                        f"spliced through frontend_proj", init_s) +
          f"; the splice moves the last hidden state by {moved:.3g} "
          f"(relative L2 against text only); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    q, k, v, kw = run["layers"]["global"]
    t = _flash_layer(q, k, v, kw, "llava-next-34b layer")
    print(_flash_layer_line("12 llava kernel", "flash attention a layer "
                            "(causal)", q, k, t, card))
    result = {"flash_launches": run["launches"],
              "flash_instances": run["instances"],
              "llava_prefill_ms": run["prefill_ms"],
              "llava_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    result.update({f"llava_{key}": t[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms")})
    return result


def phase_llava_subprocess(seed: int, card: str) -> dict:
    """Phase 12 in a fresh process of this script (``--llava-only``), with
    this one's tensors freed first: the 63.3 GiB model needs the card to
    itself.  Its lines are printed here; its result comes back on a line
    ``LLAVA {json}``."""
    import torch
    free_cuda()
    torch.cuda.synchronize()
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--llava-only", "--seed", str(seed)],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(REPO))
    result = None
    for line in r.stdout.splitlines():
        if line.startswith("LLAVA "):
            result = json.loads(line[len("LLAVA "):])
        else:
            print(line)
    require(r.returncode == 0 and result is not None,
            f"phase 12 (llava-next-34b) exited {r.returncode}: "
            f"{r.stderr[-3000:]}")
    return result


# ---------------------------------------------------------------------------
# Phase 13: training
# ---------------------------------------------------------------------------

def _flash_bwd_bound(q, v, window, causal: bool = True) -> tuple:
    """The least time of one flash backward on these tensors: the five
    products of each kept (query, key) pair (causal: the band; not causal:
    every key) -- S, dK, dQ at the q/k width,
    dP, dV at the v width: 2 (3 D + 2 Dv) FLOP, 10 D at equal widths --
    at the bf16 tensor-core peak, against q, k, v, o, dO and lse read and
    dq, dk, dv written once at the HBM rate.  Returns (ms, "operations" or
    "bytes", FLOP)."""
    b, s, h, d = q.shape
    dv = v.shape[3]
    hkv = v.shape[2]
    if causal:
        keep = np.arange(1, s + 1, dtype=np.int64)
        if window is not None:
            keep = np.minimum(keep, window)
    else:
        keep = np.full(s, v.shape[1], dtype=np.int64)
    flops = 2 * b * h * int(keep.sum()) * (3 * d + 2 * dv)
    nbytes = (2 * (b * s * h * d + b * s * hkv * (d + dv)) +   # q,k,v; dq,dk,dv
              2 * b * s * h * dv) * q.element_size() + b * h * s * 4
    t_ops, t_bytes = flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def _sdpa_backward_ms(q, k, v, do, window, causal: bool = True) -> dict:
    """scaled_dot_product_attention's backward on the same tensors (KV
    heads expanded beforehand): one forward with its graph kept, then
    ``torch.autograd.grad(..., retain_graph=True)`` alone timed three times
    over (the median, and the three under ``<case>_reps``); causal, with
    ``is_causal`` (the whole causal triangle) and with an explicit band mask
    (the same function as the kernel's); not causal, with no mask."""
    import torch
    import torch.nn.functional as F
    s, g = q.shape[1], q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).detach()
              .requires_grad_() for t in (k, v))
    dot = do.transpose(1, 2)
    if causal:
        pos = torch.arange(s, device=q.device)
        band = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
        cases = (("is_causal", {"is_causal": True}),
                 ("band_mask", {"attn_mask": band}))
    else:
        cases = (("no_mask", {}),)
    out = {}
    for name, kw in cases:
        try:
            o = F.scaled_dot_product_attention(qt, kt, vt, **kw)

            def backward():
                return torch.autograd.grad(o, (qt, kt, vt), dot,
                                           retain_graph=True)
            reps = [time_ms(backward, 5, warmup=2) for _ in range(3)]
            out[name] = float(np.median(reps))
            out[f"{name}_reps"] = reps
            del o
        except RuntimeError as e:     # a backend may refuse; printed
            out[name] = "refused: " + str(e).strip().splitlines()[0][:90]
    return out


def _check_flash_backward(q, k, v, do, window, what: str,
                          causal: bool = True) -> dict:
    """The forward with its lse and the backward kernel on one layer's q,
    k, v and dO (captured in a training step).  The forward's o against the
    plain version's (check_bf16) and its lse (fp32, TOL_LSE_F32); the
    backward against its variant's plain version (``plain_backward``: P and
    dS rounded to bf16 for wgmma) on the same o and lse (check_bf16 per
    gradient), and bit-equal twice; the chain -- kernel forward then kernel
    backward -- against the same plain backward from the plain forward's
    own o and lse, held to check_bf16's relative-L2 and
    elementwise bounds (not its share of differing elements: o and o_plain
    differ by a bf16 step in up to 1 % of elements, and delta = rowsum(dO o)
    carries that into every dq and dk of the row)."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import (BF16_MAX_REL_L2,
                                               bf16_agreement, check_bf16)
    from repro_torch.kernels.flash_attention import kv_tile, plain_backward
    o, lse = kops.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    o_plain, lse_plain = ref.attention(q, k, v, causal=causal, window=window,
                                       chunk=kv_tile(q.dtype, q.shape[3]),
                                       return_lse=True)
    fwd = check_bf16(o, o_plain, f"{what}: the forward's o")
    lse_err = check_close(lse, lse_plain, f"{what}: the forward's lse",
                          **TOL_LSE_F32)
    got = kops.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                        window=window)
    again = kops.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                          window=window)
    require(all(bool((a == b).all()) for a, b in zip(got, again)),
            f"{what}: two backward calls differ")
    want = plain_backward(q, k, v, o, do, lse, causal=causal, window=window)
    worst: dict = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _worst(worst, check_bf16(a, w, f"{what} {name}"))
    del want
    chain: dict = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, plain_backward(
            q, k, v, o_plain, do, lse_plain, causal=causal, window=window)):
        agree = bf16_agreement(a, w)
        require(bool(torch.isfinite(a).all()) and agree["worst"] <= 1 and
                agree["rel_l2"] <= BF16_MAX_REL_L2,
                f"{what} {name} from the kernel forward vs the plain "
                f"forward's o and lse: {_bf16_summary(agree)}")
        _worst(chain, agree)
    return {"agreement": worst, "forward": fwd, "lse_max_abs_err": lse_err,
            "chain": chain, "o": o, "lse": lse,
            "max_abs_err": max(worst["max_abs"], fwd["max_abs"], lse_err)}


class _PlainBackward:
    """The training step's attention with the kernel forward (saving its
    lse) and the backward's plain version (``plain_backward``) as its
    backward, for :func:`_gradient_witness`."""

    def __init__(self):
        import torch
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.flash_attention import plain_backward

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, window):
                o, lse = kops.flash_attention_cuda(q, k, v, causal=causal,
                                                   window=window,
                                                   return_lse=True)
                ctx.save_for_backward(q, k, v, o, lse)
                ctx.causal, ctx.window = causal, window
                return o

            @staticmethod
            def backward(ctx, do):
                q, k, v, o, lse = ctx.saved_tensors
                return (*plain_backward(
                    q, k, v, o, do.contiguous(), lse, causal=ctx.causal,
                    window=ctx.window), None, None)
        self.fn = Fn

    def __call__(self, q, k, v, *, causal=True, window=None, chunk=512):
        return self.fn.apply(q, k, v, causal, window)


def _plain_logits(x, table):
    """The logits product in fp32 through autograd (TF32 off): the plain
    version of ``Bf16Logits`` -- bf16 products are exact in fp32, and the
    casts' backward rounds each fp32 gradient to its operand's dtype once,
    as ``Bf16Logits.backward`` does."""
    import torch
    x2 = x.reshape(1, -1, x.shape[-1])
    return torch.bmm(x2.float(), table.t()[None].float()).view(
        *x.shape[:-1], table.shape[0])


def _gradient_witness(lm, batch, grads: dict) -> dict:
    """The gradient of every parameter at full width, the kernel path's
    (``grads``, from the step just run through FlashAttention and
    Bf16Logits) against one step through the plain attention backward
    (``plain_backward``) and the plain logits product: relative L2
    per leaf, each held to TRAIN_GRAD_REL_L2.  Returns the worst leaf, the
    median and both losses."""
    from repro_torch.core import embedding_engine as ee
    for p in lm.parameters():
        p.grad = None
    with _OpSwap("attention", _PlainBackward()), \
            _OpSwap("logits", _plain_logits, ee):
        loss = lm.loss(batch["tokens"], batch["labels"])
        loss.backward()
    rel = {}
    for name, p in lm.named_parameters():
        want = p.grad.float()
        rel[name] = float((grads[name].float() - want).norm() /
                          want.norm().clamp_min(1e-30))
    for p in lm.parameters():
        p.grad = None
    worst = max(rel, key=rel.get)
    require(rel[worst] <= TRAIN_GRAD_REL_L2,
            f"training: the gradient of {worst} through the kernels is "
            f"{rel[worst]:.3g} (relative L2) from the plain attention "
            f"backward's and logits product's (limit {TRAIN_GRAD_REL_L2})")
    return {"worst_leaf": worst, "worst_rel_l2": rel[worst],
            "median_rel_l2": float(np.median(list(rel.values()))),
            "leaves": len(rel), "plain_loss": loss.item()}


class _Capture:
    """Route layer 0's attention through the autograd Function while
    keeping its q, k, v and, once the backward reaches it, its dO."""

    def __init__(self):
        self.seen = {}

    def __call__(self, q, k, v, **kw):
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, **kw)
        if not self.seen:
            self.seen.update(q=q.detach(), k=k.detach(), v=v.detach(),
                             window=kw.get("window"),
                             causal=kw.get("causal", True))
            out.register_hook(lambda g: self.seen.setdefault(
                "do", g.detach().contiguous()))
        return out


def phase_training(seed: int, card: str) -> dict:
    """h2o-danube-1.8b trained at full width (TRAIN_LAYERS of its 24
    dense_local layers, d_model 2560, 32 heads over 8 KV heads, head dim
    80, window 4096, bf16; random from ``seed``) on one 8192-token
    sequence a step (SyntheticTokens), lr 3e-4, for 6 steps under
    ``run_supervised``: a checkpoint every 3 steps, a failure injected at
    step 4, the restart from step 2's checkpoint.  Checked: every loss
    finite; the restart's step-3 loss bit-equal to the first attempt's;
    the state the restart restored from step 2's checkpoint equal leaf for
    leaf to the host copy that save wrote; the flash backward launched in every layer of every
    step (the main path's count) and, on layer 0's captured q, k, v and dO,
    held against plain_backward (check_bf16), bit-equal twice, all on the
    wgmma variant; the
    loss's gradient reaching every parameter (none None, none all zero).
    Then a reduced MoE model trained on the card (the un-dispatch gather's
    backward on ember_sls), its gather backward held against index_add_."""
    import torch
    from repro_torch.checkpoint.ckpt import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             run_supervised)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              num_layers=TRAIN_LAYERS)
    ckpt_dir = REPO / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    n_params = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    state_bytes = n_params * (2 + 4 + 4)         # bf16 params, fp32 mu, nu
    free = shutil.disk_usage(ckpt_dir).free
    require(free > 2.2 * state_bytes,
            f"training phase: {free / 1e9:.1f} GB free under {ckpt_dir}, "
            f"two checkpoints of {state_bytes / 1e9:.1f} GB need more")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ, global_batch=1))
    attempts, step_ms, kept, trainers = [], [], {}, []
    io = {"snapshot": {}, "stack": [], "written": []}

    class Recorded(Trainer):
        """The trainer, timing each step (host clock, synchronised) and
        its restore, keeping the host copy that step 2's save wrote."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            save = self.ckpt.save
            gc_ = self.ckpt._gc

            def keep_and_save(step, tree, transform=None):
                t0 = time.perf_counter()

                def tf(host):
                    io["stack"].append(time.perf_counter())
                    if step == TRAIN_CKPT_STEP and "host" not in kept:
                        kept["host"] = host
                    return transform(host)
                save(step, tree, tf)
                io["snapshot"][step] = time.perf_counter() - t0

            def timed_gc():            # runs right after the write
                io["written"].append(time.perf_counter())
                gc_()
            self.ckpt.save, self.ckpt._gc = keep_and_save, timed_gc

        def _restore(self, state):
            t0 = time.perf_counter()
            step = super()._restore(state)
            torch.cuda.synchronize()
            io["restore"] = time.perf_counter() - t0
            # what the restart restored, leaf for leaf, against the host
            # copy that step 2's save wrote
            saved = tree_flatten_with_path(kept["host"])
            live = dict(tree_flatten_with_path(state))
            io["equal"] = step == TRAIN_CKPT_STEP and \
                len(saved) == len(live) and all(
                    torch.equal(live[p].cpu(), t) for p, t in saved)
            return step

        def __call__(self, state, batch):
            t0 = time.perf_counter()
            loss = super().__call__(state, batch)
            torch.cuda.synchronize()
            step_ms.append((len(attempts) - 1, (time.perf_counter() - t0) *
                            1e3))
            return loss

        def run(self, **kw):
            attempt = []
            attempts.append(attempt)
            return super().run(on_step=lambda s, l: attempt.append((s, l)),
                               **kw)

    def make():
        trainers.clear()
        trainers.append(Recorded(LM(cfg, seed=seed), data, TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=str(ckpt_dir), lr=TRAIN_LR)))
        return trainers[0]

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_supervised(make, failure_schedule={TRAIN_FAIL_AT})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kops.backward_launch_counts()
    variants = kops.variant_launch_counts()["flash_attention_bwd"]
    sls_variants = kops.variant_launch_counts()["sls"]
    fwd_counts = kops.launch_counts()
    instances = dict(kops.flash_attention_bwd_cuda.instances)
    fwd_instances = dict(kops.flash_attention_cuda.instances)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps_run = sum(len(a) for a in attempts)
    require(out["restarts"] == 1 and out["final_step"] == TRAIN_STEPS - 1 and
            [s for s, _ in attempts[0]] == list(range(TRAIN_FAIL_AT)) and
            [s for s, _ in attempts[1]] ==
            list(range(TRAIN_CKPT_STEP + 1, TRAIN_STEPS)),
            f"training: attempts ran steps "
            f"{[[s for s, _ in a] for a in attempts]}, restarts "
            f"{out['restarts']}")
    losses = [l for a in attempts for _, l in a]
    require(all(np.isfinite(losses)), f"training losses {losses}")
    first3 = dict(attempts[0])[TRAIN_CKPT_STEP + 1]
    again3 = dict(attempts[1])[TRAIN_CKPT_STEP + 1]
    require(first3 == again3, f"training: step {TRAIN_CKPT_STEP + 1} after "
            f"the restart gave loss {again3!r}, the first attempt {first3!r}")
    want = {f"bfloat16 80/80 causal window {cfg.sliding_window}":
            steps_run * cfg.num_layers}
    require(counts["flash_attention_bwd"] == steps_run * cfg.num_layers and
            instances == want and
            fwd_counts["flash_attention"] == steps_run * cfg.num_layers,
            f"training launched the flash backward {instances} and the "
            f"forward {fwd_counts['flash_attention']} times in {steps_run} "
            f"steps, expected {want}")
    require(variants == {"wgmma": steps_run * cfg.num_layers, "simt": 0},
            f"training ran the flash backward's variants {variants}: all "
            f"{steps_run * cfg.num_layers} launches must be wgmma")
    require(counts["block_gather_bwd"] == steps_run and
            fwd_counts["sls"] == steps_run and
            counts["gather_transpose"] == steps_run and
            sls_variants == {"rows": 0, "sparse": steps_run},
            f"training: the token embedding's backward ran "
            f"{counts['block_gather_bwd']} times ({fwd_counts['sls']} "
            f"ember_sls launches, by variant {sls_variants}; "
            f"{counts['gather_transpose']} transpositions) in {steps_run} "
            f"steps, expected one a step, each on the transposition kernel "
            f"and the sparse sum")
    require(io.get("equal") is True, "training: the state the restart "
            f"restored from step {TRAIN_CKPT_STEP}'s checkpoint differs from "
            "the saved one")
    trainer = trainers[0]
    step_dir = ckpt_dir / f"step_{TRAIN_CKPT_STEP:09d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    kept.clear()
    save_s = [w - s for s, w in zip(io["stack"], io["written"])]
    first_ms = [ms for a, ms in step_ms if a == 0]
    mean_ms = float(np.mean(first_ms[1:TRAIN_CKPT_STEP + 2]))

    # one more forward/backward: every parameter reached; layer 0's q, k,
    # v and dO captured for the kernel check and timing
    lm = trainer.lm
    batch = trainer.local_batch(trainer.data.batch_at(0))
    cap = _Capture()
    with _OpSwap("attention", cap):
        for p in lm.parameters():
            p.grad = None
        kernel_loss = lm.loss(batch["tokens"], batch["labels"])
        kernel_loss.backward()
    missing = [k for k, p in lm.named_parameters() if p.grad is None]
    zero = [k for k, p in lm.named_parameters()
            if p.grad is not None and not bool(p.grad.any())]
    require(not missing and not zero, f"training: no gradient for {missing}, "
            f"an all-zero one for {zero}")
    # the same step's gradients through the plain attention backward and
    # logits product: every leaf within TRAIN_GRAD_REL_L2
    grads = {k: p.grad for k, p in lm.named_parameters()}
    witness = _gradient_witness(lm, batch, grads)
    witness["kernel_loss"] = kernel_loss.item()
    del grads, kernel_loss
    q, k, v, do, window = (cap.seen[n] for n in ("q", "k", "v", "do",
                                                 "window"))
    chk = _check_flash_backward(q, k, v, do, window, "danube layer 0 "
                                "flash backward")
    o, lse = chk["o"], chk["lse"]

    # device busy share over one profiled step (it updates the weights)
    state = {"params": dict(lm.named_parameters()),
             "opt": out["state"]["opt"], "ef": None}
    prof_wall = []
    dev = _device_time(lambda: trainer(state, batch), prof_wall)
    busy = _busy(dev, prof_wall[0])
    out = state = None

    # the backward kernels' time (the wgmma variant the path runs, and the
    # SIMT one through the wrapper's own launch path) beside the bound, the
    # plain version and SDPA's backward
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.flash_attention import (launch_backward,
                                                     plain_backward)
    ms = time_ms(lambda: kops.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, window=window), 20, warmup=2)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    simt_ms = time_ms(lambda: launch_backward(
        "simt", q, k, v, o, do, lse, grads, causal=True, window=window), 2,
        warmup=1)
    # what the timed SIMT launches wrote, against their own plain version
    simt: dict = {}
    for name, a, w in zip(("dq", "dk", "dv"), grads, plain_backward(
            q, k, v, o, do, lse, window=window, variant="simt")):
        _worst(simt, check_bf16(a, w, f"danube layer 0 flash backward, "
                                f"SIMT {name}"))
    del grads
    plain_ms = time_ms(lambda: plain_backward(
        q, k, v, o, do, lse, window=window), 1, warmup=1)
    sdpa = _sdpa_backward_ms(q, k, v, do, window)
    # the token embedding's deterministic backward at this step's shape,
    # timed apart beside index_add_ (what index_select's stock backward
    # runs, with atomics)
    emb = _gather_backward_parts(
        torch.randn((TRAIN_SEQ, 1, cfg.d_model), device="cuda").bfloat16(),
        batch["tokens"].reshape(-1).to(torch.int32), cfg.padded_vocab, 10)
    bound_ms, bound_by, flops = _flash_bwd_bound(q, v, window)
    fwd_bound_ms = _flash_bound(q, k, v, window)[0]
    print(f"[13 training] h2o-danube-1.8b trained at full width and "
          f"{cfg.num_layers} of its 24 layers ({n_params:,}"
          f" parameters, bf16; 1 x {TRAIN_SEQ} tokens a step, lr {TRAIN_LR},"
          f" run_supervised with a checkpoint every {TRAIN_CKPT_EVERY} steps "
          f"and a failure at step {TRAIN_FAIL_AT}): losses by attempt "
          f"{[[round(l, 4) for _, l in a] for a in attempts]}; the restart's "
          f"step-{TRAIN_CKPT_STEP + 1} loss {again3!r} == the first "
          f"attempt's, bit for bit; step ms (host clock, synchronised) over "
          f"steps 1-{TRAIN_CKPT_STEP + 1}: {mean_ms:.1f} "
          f"({', '.join(f'{m:.1f}' for m in first_ms)} for steps "
          f"0-{len(first_ms) - 1}), {TRAIN_SEQ / mean_ms * 1e3:.0f} tokens/s;"
          f" {wall_s:.1f} s for the whole supervised run; peak device memory "
          f"{peak_gib:.2f} GiB; {card}")
    print(f"[13 checkpoint] step {TRAIN_CKPT_STEP}: {ckpt_bytes:,} bytes; "
          f"host snapshot at the save {io['snapshot'][TRAIN_CKPT_STEP]:.2f}"
          f" s, background stack + write "
          f"{', '.join(f'{x:.1f}' for x in save_s)} s (steps "
          f"{TRAIN_CKPT_STEP}, {TRAIN_STEPS - 1}); restore into the restarted "
          f"trainer {io['restore']:.1f} s, equal leaf for leaf to the state "
          f"the save copied")
    print(f"[13 gradients] every one of {len(dict(lm.named_parameters()))} "
          f"parameters got a nonzero gradient; flash backward launches on "
          f"the path {counts['flash_attention_bwd']} ({instances}; by "
          f"variant {variants}); layer 0's backward vs its plain version "
          f"(P and dS rounded to bf16): "
          f"{_bf16_summary(chk['agreement'])}; two calls bit-equal; its "
          f"forward's o vs the plain version's {_bf16_summary(chk['forward'])}"
          f", lse max abs err {chk['lse_max_abs_err']:.3g} (rtol "
          f"{TOL_LSE_F32['rtol']}, atol {TOL_LSE_F32['atol']}); forward then "
          f"backward vs the plain forward's o and lse then the plain "
          f"backward: {_bf16_summary(chk['chain'])}")
    print(f"[13 gradient witness] the same step through the plain attention "
          f"backward (plain_backward in all {cfg.num_layers} layers) "
          f"and the plain fp32 logits product: loss {witness['plain_loss']!r}"
          f" vs the kernels' {witness['kernel_loss']!r}; relative L2 of the "
          f"kernel path's gradient per leaf, worst {witness['worst_rel_l2']:.3g}"
          f" ({witness['worst_leaf']}), median "
          f"{witness['median_rel_l2']:.3g} over {witness['leaves']} leaves "
          f"(limit {TRAIN_GRAD_REL_L2}); {card}")
    print(f"[13 step profile] {busy}")
    print(f"[13 embedding backward] the token embedding's gradient (Take: "
          f"{TRAIN_SEQ} ids into {cfg.padded_vocab} rows of {cfg.d_model} "
          f"bf16), {counts['gather_transpose']} transposition and "
          f"{sls_variants['sparse']} sparse ember_sls launches in the "
          f"supervised run, one a step: {_parts_line(emb)}; {card}")
    sdpa_txt = ", ".join(f"{n} {v:.4f} ms" if isinstance(v, float)
                         else f"{n} {v}" for n, v in sdpa.items())
    b_, s_, h_, d_ = q.shape
    print(f"[13 flash backward] a danube layer (B={b_}, S={s_}, H={h_}, "
          f"Hkv={k.shape[2]}, D={d_}, window {window}, {q.dtype}): wgmma "
          f"kernels {ms:.4f} ms, the SIMT kernels on the same tensors "
          f"{simt_ms:.4f} ms (vs their plain version, fp32 P and dS: "
          f"{_bf16_summary(simt)}), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention's backward "
          f"alone on a kept graph (median of three timings, then the three) "
          f"{sdpa_txt}; bound {bound_ms:.4f} ms "
          f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s, by {bound_by}; kernel at "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.2f}% of its "
          f"bound); the forward's bound {fwd_bound_ms:.4f} ms; {card}")
    library_ms = sdpa["band_mask"] if isinstance(sdpa["band_mask"], float) \
        else None
    result = {"name": "flash_attention_bwd", "route": "cuda",
              "source": "src/repro_torch/csrc/ember_flash_backward.cu",
              "replaces": "src/repro/models/attention.py:52 (jax.grad of "
                          "blockwise_attention, the function the forward "
                          "kernel src/repro/kernels/flash_attention.py:65 "
                          "replaces)",
              "variant": "wgmma: flash_bwd_dkdv_wgmma_kernel + "
                         "flash_bwd_dq_wgmma_kernel",
              "launches": counts["flash_attention_bwd"],
              "variants": variants, "simt_ms": simt_ms,
              "simt_max_abs_err": simt["max_abs"],
              "simt_worst_rel_l2": simt["rel_l2"],
              "max_abs_err": max(chk["max_abs_err"], simt["max_abs"]),
              "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": library_ms,
              "library": "scaled_dot_product_attention backward, band mask",
              "sdpa_is_causal_ms": sdpa["is_causal"],
              "held_against_plain": True, "instances": instances,
              "forward_lse_max_abs_err": chk["lse_max_abs_err"],
              "chain_rel_l2": chk["chain"]["rel_l2"],
              "training_grad_worst_rel_l2": witness["worst_rel_l2"],
              "training_grad_worst_leaf": witness["worst_leaf"],
              "training_step_ms": mean_ms,
              "training_tokens_per_s": TRAIN_SEQ / mean_ms * 1e3,
              "training_peak_gib": peak_gib,
              "training_forward_launches": fwd_counts["flash_attention"],
              "training_forward_instances": fwd_instances,
              "checkpoint_bytes": ckpt_bytes, "restore_s": io["restore"],
              "save_s": save_s,
              "embedding_backward_launches": counts["block_gather_bwd"],
              "embedding_backward_transposes": counts["gather_transpose"],
              "embedding_backward_sparse": sls_variants["sparse"],
              "embedding_backward_split": emb}
    del lm, trainer, q, k, v, do, o, lse, chk, cap, batch
    trainers.clear()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_cuda()
    result["gather"] = _moe_training(seed, card)
    return result


def _parent_gather_backward(rows, idxs, n: int):
    """The block gather's backward as the parent commit composed it: the
    argsort transposition (``ref.transposed_lookups``) and one launch of
    ``sls_kernel`` (the rows variant) over rows (G, W) into (n, W)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sls import launch_variant
    order, ptrs = ref.transposed_lookups(idxs, None, n)
    out = torch.empty((n, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    launch_variant("rows", rows, ptrs, order, out)
    return out


def _gather_backward_parts(dout, idxs, n: int, iters: int) -> dict:
    """The block gather's backward on the card at one shape (dout (G, 1, E)
    into n rows), checked and timed on the same inputs.  Checked: the
    transposition kernel's order and ptrs equal to the argsort path's; the
    wrapper's result bit-equal to the parent's composition (argsort path +
    ``sls_kernel``); the sum variant that runs against its plain version
    (``ref.sls`` on the same CSR: TOL_SUM_F32 in f32, ``check_bf16`` in
    bf16).  Timed: the wrapper (``block_gather_backward``), its
    transposition (``ember_transpose``) and its sum launch alone, the
    parent's composition and its two parts (the argsort path and
    ``sls_kernel`` on that CSR), the plain versions, ``index_add_`` (one
    PyTorch call for the whole function, in dout's dtype) and
    ``F.embedding_bag`` (one for the sum over the CSR), each the median of
    three timings; the bytes bounds of the function and of each part."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gather as kgather, ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.sls import kernel_variant, launch_variant
    g, emb = dout.shape[0], dout.shape[2]
    rows = dout.reshape(g, -1)
    order, ptrs = kgather.transposed_lookups(idxs, None, n)
    p_order, p_ptrs = ref.transposed_lookups(idxs, None, n)
    require(torch.equal(order, p_order) and torch.equal(ptrs, p_ptrs),
            f"the transposition kernel's order and ptrs differ from the "
            f"argsort path's ({g} ids into {n} rows)")
    got = kops.block_gather_backward(dout, idxs, n)
    parent = _parent_gather_backward(rows, idxs, n)
    require(torch.equal(got, parent), f"the gather backward ({g} ids into "
            f"{n} rows of {emb} {dout.dtype}) is not the parent "
            "composition's bits")
    variant = kernel_variant("sls", emb, dout.element_size(), True,
                             num_segments=n, lookups=g, plain_sum=True)
    summed = torch.empty((n, emb), dtype=dout.dtype, device=dout.device)
    launch_variant(variant, rows, ptrs, order, summed)
    plain_sum = ref.sls(rows, ptrs, order, num_segments=n)
    what = f"the {variant} sum ({g} ids into {n} rows) vs ref.sls"
    if dout.dtype == torch.float32:
        err = check_close(summed, plain_sum, what, **TOL_SUM_F32)
    else:
        err = check_bf16(summed, plain_sum, what)["max_abs"]
    ids64, offsets = order.long(), ptrs[:-1].long()

    def library():
        return torch.zeros((n, emb), dtype=dout.dtype,
                           device=dout.device).index_add_(
            0, idxs.long(), dout.view(-1, emb))

    def out():
        return torch.empty((n, emb), dtype=dout.dtype, device=dout.device)
    size = dout.element_size()
    ints = (g + n + 1) * 4
    nbytes = (dout.numel() + n * emb) * size + g * 4
    return {"ms": median_ms(lambda: kops.block_gather_backward(
                dout, idxs, n), iters),
            "transpose_ms": median_ms(lambda: kgather.transposed_lookups(
                idxs, None, n), iters),
            "sum_ms": median_ms(lambda: launch_variant(
                variant, rows, ptrs, order, out()), iters),
            "parent_ms": median_ms(lambda: _parent_gather_backward(
                rows, idxs, n), iters),
            "csr_ms": median_ms(lambda: ref.transposed_lookups(
                idxs, None, n), iters),
            "sls_ms": median_ms(lambda: launch_variant(
                "rows", rows, ptrs, order, out()), iters),
            "plain_ms": median_ms(lambda: ref.block_gather_backward(
                dout, idxs, n), iters),
            "sum_plain_ms": median_ms(lambda: ref.sls(
                rows, ptrs, order, num_segments=n), iters),
            "index_add_ms": median_ms(library, iters),
            "embedding_bag_ms": median_ms(lambda: F.embedding_bag(
                ids64, rows, offsets, mode="sum"), iters),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "transpose_bound_ms": (g * 4 + ints) / HBM_BYTES_PER_S * 1e3,
            "sum_bound_ms": ((g + n) * emb * size + ints) / HBM_BYTES_PER_S
            * 1e3,
            "sum_variant": variant, "sum_max_abs_err": err,
            "ids": g, "rows": n, "distinct": int((ptrs[1:] > ptrs[:-1])
                                                .sum()),
            "hottest": int((ptrs[1:] - ptrs[:-1]).max())}


def _parts_line(p: dict) -> str:
    return (f"{p['ids']:,} ids into {p['rows']:,} rows ({p['distinct']:,} "
            f"distinct, the hottest {p['hottest']:,} times): the wrapper "
            f"{p['ms']:.4f} ms = the transposition kernel "
            f"{p['transpose_ms']:.4f} ms (bound {p['transpose_bound_ms']:.5f}"
            f") + the {p['sum_variant']} sum {p['sum_ms']:.4f} ms (bound "
            f"{p['sum_bound_ms']:.5f}, "
            f"{100 * p['sum_bound_ms'] / p['sum_ms']:.1f}% of it; vs "
            f"ref.sls max abs err {p['sum_max_abs_err']:.3g}); "
            f"bit-equal to the parent's composition {p['parent_ms']:.4f} ms "
            f"= argsort + bincount + cumsum {p['csr_ms']:.4f} + sls_kernel "
            f"{p['sls_ms']:.4f}; index_add_ {p['index_add_ms']:.4f} ms "
            f"(the wrapper {p['index_add_ms'] / p['ms']:.2f}x as fast); "
            f"F.embedding_bag over the CSR {p['embedding_bag_ms']:.4f} ms; "
            f"plain {p['plain_ms']:.4f} ms (sum alone {p['sum_plain_ms']:.4f}"
            f"); bound {p['bound_ms']:.5f} ms (bytes)")


def _moe_training(seed: int, card: str) -> dict:
    """A reduced MoE model (DeepSeek-V2-Lite's kinds at d_model 256, heads
    of q/k 192 and v 128, 8 experts; f32) trained for 3 steps on the card
    through the Trainer: the MoE un-dispatch gather's backward
    (``block_gather_backward`` on ember_sls) in every layer of every step;
    one layer's gather backward held against index_add_ and timed."""
    import dataclasses
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(
        get_reduced("deepseek-v2-lite-16b"), d_model=256, num_heads=2,
        num_kv_heads=2, head_dim=128, rope_head_dim=64, kv_lora_rank=64,
        d_ff=256)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                      global_batch=4))
    ckpt_dir = REPO / "build" / "moe_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer = Trainer(LM(cfg, seed=seed), data, TrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(ckpt_dir)))
    kops.reset_launch_counts()
    out = trainer.run()
    torch.cuda.synchronize()
    counts = kops.backward_launch_counts()
    sls_launches = kops.launch_counts()["sls"]
    sls_variants = kops.variant_launch_counts()["sls"]
    # a step: each layer's un-dispatch (no more lookups than capacity
    # slots: the sparse sum) and the token embedding's backward (4 x 256
    # tokens into a 256-row vocabulary: the rows kernel)
    undispatch = 3 * cfg.num_layers
    require(counts["block_gather_bwd"] == 3 * (cfg.num_layers + 1) and
            sls_launches == counts["block_gather_bwd"] and
            counts["gather_transpose"] == counts["block_gather_bwd"] and
            sls_variants == {"rows": 3, "sparse": undispatch} and
            all(np.isfinite(out["losses"])),
            f"MoE training: gather backward {counts['block_gather_bwd']}, "
            f"transpositions {counts['gather_transpose']}, ember_sls "
            f"{sls_launches} launches by variant {sls_variants}, losses "
            f"{out['losses']}")
    seen = {}

    def capture(table, idxs, **kw):
        from repro_torch.kernels.gather import block_gather
        got = block_gather(table, idxs, **kw)
        if not seen:
            seen.update(n=table.shape[0], idxs=idxs)
            got.register_hook(lambda g: seen.setdefault(
                "dout", g.detach().contiguous()))
        return got
    batch = trainer.local_batch(trainer.data.batch_at(0))
    with _OpSwap("block_gather", capture):
        trainer.lm.loss(batch["tokens"], batch["labels"]).backward()
    dout, idxs, n = seen["dout"], seen["idxs"], seen["n"]
    got = kops.block_gather_backward(dout, idxs, n)
    want = ref.block_gather_backward(dout, idxs, n)
    err = check_close(got, want, "MoE un-dispatch gather backward vs "
                      "index_add_", **TOL_SUM_F32)
    parts = _gather_backward_parts(dout, idxs, n, 20)
    ms, library_ms = parts["ms"], parts["index_add_ms"]
    plain_ms = time_ms(lambda: ref.block_gather_backward(dout, idxs, n), 20)
    bound_ms = parts["bound_ms"]
    print(f"[13 moe training] a reduced MoE model ({cfg.num_layers} mla "
          f"layers, d_model {cfg.d_model}, {cfg.num_experts} experts, f32; "
          f"4 x 256 tokens) trained 3 steps on the card: losses "
          f"{[round(x, 4) for x in out['losses']]}; the un-dispatch gathers' "
          f"and the token embedding's backward launched the transposition "
          f"{counts['gather_transpose']} times and ember_sls "
          f"{counts['block_gather_bwd']} times (by variant {sls_variants}); "
          f"one layer's ({tuple(dout.shape)} into {n} rows) vs index_add_ max "
          f"abs err {err:.3g}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes); "
          f"{card}")
    print(f"[13 gather backward split] {_parts_line(parts)}; {card}")
    # the same split at DeepSeek-V2-Lite's un-dispatch prefill shape:
    # 98,304 rows of 4 KiB (bf16, d_model 2048) from its 122,944-row
    # capacity buffer, 94,270 of the slots distinct (phase 9's layer 0)
    rng = np.random.default_rng(seed)
    slots = rng.permutation(DS_UNDISPATCH_BUFFER)[:DS_UNDISPATCH_DISTINCT]
    slots = np.concatenate([slots, rng.choice(
        slots, DS_UNDISPATCH_ROWS - DS_UNDISPATCH_DISTINCT)])
    ds_idxs = torch.from_numpy(rng.permutation(slots).astype(np.int32)).cuda()
    ds_dout = torch.randn((DS_UNDISPATCH_ROWS, 1, DS_D_MODEL),
                          device="cuda").bfloat16()
    ds_agree = check_bf16(
        kops.block_gather_backward(ds_dout, ds_idxs, DS_UNDISPATCH_BUFFER),
        ref.block_gather_backward(ds_dout, ds_idxs, DS_UNDISPATCH_BUFFER),
        "DeepSeek-V2-Lite un-dispatch gather backward vs index_add_")
    ds_parts = _gather_backward_parts(ds_dout, ds_idxs, DS_UNDISPATCH_BUFFER,
                                      10)
    print(f"[13 gather backward split] DeepSeek-V2-Lite un-dispatch prefill "
          f"shape, synthetic slots ({DS_UNDISPATCH_ROWS:,} rows of "
          f"{DS_D_MODEL} bf16 into {DS_UNDISPATCH_BUFFER:,}, "
          f"{DS_UNDISPATCH_DISTINCT:,} distinct; vs index_add_ in fp32 "
          f"{_bf16_summary(ds_agree)}): {_parts_line(ds_parts)}; {card}")
    result = {"gather_backward_launches": counts["block_gather_bwd"],
              "gather_backward_transposes": counts["gather_transpose"],
              "gather_backward_sparse": sls_variants["sparse"],
              "gather_backward_ms": ms, "gather_backward_plain_ms": plain_ms,
              "gather_backward_library_ms": library_ms,
              "gather_backward_bound_ms": bound_ms,
              "gather_backward_max_abs_err": err,
              "gather_backward_split": parts,
              "gather_backward_deepseek_split": ds_parts}
    del ds_dout, ds_idxs
    del trainer, out, dout, idxs, got, want, batch
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# Phase 14: whisper-large-v3
# ---------------------------------------------------------------------------

def _gather_backward_kernels(sls: dict, training: dict, wt: dict,
                             xt: dict) -> list:
    """The gather backward's share of the kernels line: the rows variant's
    backward launches (the reduced MoE's token embedding) onto ``sls``,
    and the entries of the transposition kernel and the sparse sum, their
    launches from the danube, reduced MoE, whisper and xlstm trainings,
    their times at danube's shape and the splits at all five shapes."""
    moe = training.pop("gather")
    splits = {"danube_embedding": training.pop("embedding_backward_split"),
              "whisper_embedding": wt.pop("embedding_backward_split"),
              "xlstm_embedding": xt.pop("embedding_backward_split"),
              "moe_undispatch": moe.pop("gather_backward_split"),
              "deepseek_undispatch": moe.pop(
                  "gather_backward_deepseek_split")}
    bwd = {"danube": training.pop("embedding_backward_launches"),
           "moe": moe.pop("gather_backward_launches"),
           "whisper": wt.pop("sls_launches"),
           "xlstm": xt.pop("sls_launches")}
    transposes = {"danube": training.pop("embedding_backward_transposes"),
                  "moe": moe.pop("gather_backward_transposes"),
                  "whisper": wt.pop("transposes"),
                  "xlstm": xt.pop("transposes")}
    sparse = {"danube": training.pop("embedding_backward_sparse"),
              "moe": moe.pop("gather_backward_sparse"),
              "whisper": wt.pop("sparse_launches"),
              "xlstm": xt.pop("sparse_launches")}
    sls["gather_backward_launches"] = sum(bwd.values()) - \
        sum(sparse.values())
    sls["launches"] += sls["gather_backward_launches"]
    danube = splits["danube_embedding"]
    transpose = {
        "name": "gather_transpose", "route": "cuda",
        "source": "src/repro_torch/csrc/ember_transpose.cu",
        "replaces": "src/repro/kernels/gather.py:32 (the lookups' "
                    "transposition in the gradient of block_gather_pallas, "
                    "jax.grad of jnp.take)",
        "launches": sum(transposes.values()),
        "launches_by_training": transposes, "max_abs_err": 0.0,
        "ms": danube["transpose_ms"], "plain_ms": danube["csr_ms"],
        "bound_ms": danube["transpose_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "held_against_plain": True,
        "by_shape": {k: {f: v[f] for f in ("transpose_ms", "csr_ms",
                                           "transpose_bound_ms")}
                     for k, v in splits.items()}}
    summed = {
        "name": "sls_sparse", "route": "cuda",
        "source": "src/repro_torch/csrc/ember_kernels.cu",
        "replaces": "src/repro/kernels/sls.py:67",
        "variant": "sparse: sls_sparse_plan_kernel + sls_sparse_kernel",
        "launches": sum(sparse.values()), "launches_by_training": sparse,
        "max_abs_err": max(v["sum_max_abs_err"] for v in splits.values()),
        "ms": danube["sum_ms"], "plain_ms": danube["sum_plain_ms"],
        "bound_ms": danube["sum_bound_ms"], "bound_by": "bytes",
        "library_ms": danube["embedding_bag_ms"],
        "library": "F.embedding_bag(mode='sum') over the same CSR",
        "held_against_plain": True, "backward_by_shape": splits}
    summed.update(moe)
    summed.update({f"xlstm_training_{k}": v for k, v in xt.items()})
    return [transpose, summed]


def _whisper_prefill_flops(cfg, b: int, s: int) -> float:
    """The work of one whisper prefill over b x s tokens and as many frames:
    frontend_proj, each encoder layer's four projections and MLP, each
    decoder layer's eight projections (self and cross) and MLP, and the
    attention pairs (every pair in the encoder and the cross layers, the
    causal triangle in the self layers), 2 FLOP a multiply-add."""
    d, f, hd, h = cfg.d_model, cfg.d_ff, cfg.hd, cfg.num_heads
    t = b * s
    gemm = 2 * t * (d * d + cfg.enc_layers * (4 * d * d + 3 * d * f) +
                    cfg.num_layers * (8 * d * d + 3 * d * f))
    pairs = (cfg.enc_layers + cfg.num_layers) * s * s + \
        cfg.num_layers * s * (s + 1) // 2
    return gemm + 2 * b * h * pairs * 2 * hd


def _cross_kv_share(model, tok, caches, ctx) -> dict:
    """One decode micro-step under torch.profiler (shapes recorded): its
    device time, and the device time of the cross-attention's K and V
    projections -- the products whose first operand is every slot's
    encoder output, (B * Sf, D) -- which the reference recomputes every
    micro-step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    enc = ctx["enc_out"]
    rows = [enc.shape[0] * enc.shape[1], enc.shape[2]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as tp:
        t0 = time.perf_counter()
        model.decode_step(tok, caches, batch_ctx=ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(e.self_device_time_total for e in tp.key_averages()
                  if e.device_type == DeviceType.CUDA)
    kv_us, kv_n = 0.0, 0
    for e in tp.key_averages(group_by_input_shape=True):
        if e.key == "aten::mm" and e.input_shapes and \
                list(e.input_shapes[0]) == rows:
            kv_us += e.device_time_total
            kv_n += e.count
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall_ms,
            "kv_ms": kv_us / 1e3, "kv_products": kv_n}


def _whisper_serving(model, enc, seed: int, card: str) -> dict:
    """Encode once, then serve the 8 clips: ``LM.wave_step(batch_ctx=)``
    over a WHISPER_PROMPT-token prompt, then greedy tokens one wave each
    into caches of WHISPER_MAX_LEN.  Checked: the drive at chunk 1 gives
    the same tokens and bit-identical final logits; one micro-step's
    cross-attention kernel launches (Sq = 1 over every frame) against the
    plain version; every wave's logits within PREFILL_REL_L2 of the same
    decode with plain attention, teacher-forced on the drive's tokens."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    cfg = model.cfg
    b = enc.shape[0]
    with torch.inference_mode():
        enc_out = model._encode(enc)
    ctx = {"enc_out": enc_out}
    rng = np.random.default_rng(seed + 15)
    prompts = rng.integers(0, cfg.vocab_size,
                           (b, WHISPER_PROMPT)).astype(np.int32)
    ones = np.ones(b, np.int32)

    def drive(chunk, new=WHISPER_NEW_TOKENS):
        caches = model.init_caches(b, WHISPER_MAX_LEN)
        t0 = time.perf_counter()
        for c0 in range(0, WHISPER_PROMPT, chunk):
            part = prompts[:, c0:c0 + chunk]
            logits, _ = model.wave_step(
                part, np.full(b, part.shape[1], np.int32), caches,
                batch_ctx=ctx)
        out, waves = [], [logits]
        for i in range(new):
            nxt = logits.argmax(-1).cpu().numpy().astype(np.int32)
            out.append(nxt[:, 0])
            if i == 0:
                t1 = time.perf_counter()
            if i + 1 < new:
                logits, _ = model.wave_step(nxt, ones, caches, batch_ctx=ctx)
                waves.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"tokens": np.stack(out, 1), "logits": logits,
                "waves": torch.cat(waves, 1), "caches": caches,
                "first_s": t1 - t0, "decode_s": t2 - t1}

    drive(WHISPER_PROMPT, new=2)       # warm-up
    kops.reset_launch_counts()
    main = drive(WHISPER_PROMPT)
    launches = kops.launch_counts()["flash_attention"]
    instances = dict(kops.flash_attention_cuda.instances)
    micro = WHISPER_PROMPT + WHISPER_NEW_TOKENS - 1
    want = {"bfloat16 64/64": micro * cfg.num_layers}
    require(instances == want and launches == micro * cfg.num_layers,
            f"whisper serving launched flash {instances}, expected {want}: "
            f"one cross-attention a layer a micro-step")
    one = drive(1)
    require(np.array_equal(one["tokens"], main["tokens"]) and
            torch.equal(one["logits"], main["logits"]),
            "whisper serving: the drive at chunk 1 differs from the "
            "whole-prompt drive")
    tokens_per_s = b * (WHISPER_NEW_TOKENS - 1) / main["decode_s"]
    # one micro-step, on copies of the drive's caches
    tok = torch.from_numpy(main["tokens"][:, -1:]).cuda().long()

    def copies():
        return [{k: t.clone() for k, t in c.items()} for c in main["caches"]]
    spare = copies()
    step_ms = time_ms(lambda: model.decode_step(tok, spare, batch_ctx=ctx), 10)
    share = _cross_kv_share(model, tok, copies(), ctx)
    spare = copies()
    host = _host_top(lambda: model.decode_step(tok, spare, batch_ctx=ctx), 6)
    held, seen = [], {}

    def hold(q, k, v, **kw):
        out = kops.flash_attention_cuda(q, k, v, **kw)
        held.append(check_bf16(out, plain_attention(q, k, v, **kw),
                               f"whisper decode cross-attention layer "
                               f"{len(held)} (Sq = 1)"))
        seen.setdefault("qkv", (q, k, v, kw))
        return out
    with _OpSwap("attention", hold):
        model.decode_step(tok, copies(), batch_ctx=ctx)
    require(len(held) == cfg.num_layers, "one cross-attention a layer")
    worst = {}
    for a in held:
        _worst(worst, a)
    q, k, v, kw = seen["qkv"]
    t = _flash_layer(q, k, v, kw, "whisper decode cross layer")
    print(_flash_layer_line("14 whisper decode kernel", "flash attention, a "
                            "decode step's cross-attention (one query row "
                            "a slot over every frame)", q, k, t, card))
    # the drive's tokens through the same decode with plain attention,
    # teacher-forced: its logits at the prompt's last token and after
    # every decode wave against the drive's
    seq = np.concatenate([prompts, main["tokens"][:, :-1]], 1)
    caches = model.init_caches(b, WHISPER_MAX_LEN)
    rows = []
    with _OpSwap("attention", plain_attention):
        for i in range(seq.shape[1]):
            lg, _ = model.decode_step(
                torch.from_numpy(seq[:, i:i + 1]).cuda().long(), caches,
                batch_ctx=ctx)
            rows.append(lg)
    del caches
    plain_logits = torch.cat(rows[WHISPER_PROMPT - 1:], 1)
    kernel_logits = main["waves"]
    rel = float((kernel_logits - plain_logits).norm() / plain_logits.norm())
    require(rel <= PREFILL_REL_L2 and
            bool(torch.isfinite(kernel_logits).all()),
            f"whisper decode logits with the kernel vs plain attention: "
            f"relative L2 {rel:.3g} > {PREFILL_REL_L2}")
    print(f"[14 whisper serving] encoded once ({tuple(enc_out.shape)}), then "
          f"{b} slots: a {WHISPER_PROMPT}-token prompt and "
          f"{WHISPER_NEW_TOKENS} greedy tokens each through "
          f"LM.wave_step(batch_ctx=) into caches of {WHISPER_MAX_LEN} "
          f"(eager; {micro} micro-steps, {launches} cross-attention "
          f"launches): {tokens_per_s:.1f} tokens/s over the "
          f"{WHISPER_NEW_TOKENS - 1} decode waves ({main['decode_s']:.3f} s;"
          f" prompt wave and first token {main['first_s'] * 1e3:.1f} ms); "
          f"a micro-step {step_ms:.3f} ms (CUDA events over 10), device busy"
          f" {share['busy_ms']:.3f} ms of the {share['wall_ms']:.3f} ms one "
          f"profiled micro-step took, of it the cross K/V projections "
          f"({share['kv_products']} products of ({b * enc_out.shape[1]}, "
          f"{cfg.d_model}) rows) {share['kv_ms']:.3f} ms = "
          f"{100 * share['kv_ms'] / max(share['busy_ms'], 1e-9):.1f}%; host "
          f"own time of a micro-step (cProfile): {host}; the "
          f"drive at chunk 1: same tokens, bit-identical final logits; the "
          f"cross-attention kernel at Sq = 1 vs plain in every layer: "
          f"{_bf16_summary(worst)}; the drive's logits of all "
          f"{kernel_logits.shape[1]} waves vs plain attention on its tokens "
          f"(teacher-forced): relative L2 {rel:.3g} (tol {PREFILL_REL_L2}); "
          f"{card}")
    return {"launches": launches, "instances": instances,
            "tokens_per_s": tokens_per_s, "micro_step_ms": step_ms,
            "micro_step_busy_ms": share["busy_ms"],
            "cross_kv_ms": share["kv_ms"],
            "cross_kv_share": share["kv_ms"] / max(share["busy_ms"], 1e-9),
            "decode_rel_l2": rel,
            "decode_kernel": {key: t[key] for key in
                              ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")},
            "decode_max_abs_err": worst["max_abs"]}


def _whisper_training(seed: int, card: str) -> dict:
    """whisper-large-v3 trained at full width through the Trainer: 1 x
    WHISPER_FRAMES tokens and as many frames a step, lr TRAIN_LR,
    WHISPER_TRAIN_STEPS steps, twice from one seed, its checkpoint save a
    no-op (phase 13 covers checkpoints).  Checked: every loss finite, the
    two runs' losses and final parameters bit-equal (the token embedding's
    gradient on ember_sls: no atomics), every step's 96 backward launches
    on wgmma, one ember_sls launch a step; then the encoder's layer-0
    backward against plain_backward (check_bf16) and a nonzero gradient
    for every parameter.  Printed: step ms, tokens/s, the busy share of a
    profiled step, peak memory, the encoder layer's backward beside its
    bound and SDPA's, the embedding's backward beside index_add_."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import plain_backward
    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = get_config("whisper-large-v3")
    n_attn = _attention_layers(cfg)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=WHISPER_FRAMES, global_batch=1,
        modality=cfg.modality, d_model=cfg.d_model, enc_seq=WHISPER_FRAMES))
    ckpt_dir = REPO / "build" / "whisper_train"
    step_ms: list = []

    class Timed(Trainer):
        def __call__(self, state, batch):
            t0 = time.perf_counter()
            loss = super().__call__(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return loss

    def train():
        trainer = Timed(LM(cfg, seed=seed), data, TrainerConfig(
            total_steps=WHISPER_TRAIN_STEPS, ckpt_every=WHISPER_TRAIN_STEPS,
            ckpt_dir=str(ckpt_dir), lr=TRAIN_LR))
        trainer.ckpt.save = lambda *a, **kw: None
        return trainer, trainer.run()

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    trainer, out = train()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    counts = kops.backward_launch_counts()
    fwd = kops.launch_counts()
    variants = kops.variant_launch_counts()["flash_attention_bwd"]
    sls_variants = kops.variant_launch_counts()["sls"]
    bwd_instances = dict(kops.flash_attention_bwd_cuda.instances)
    fwd_instances = dict(kops.flash_attention_cuda.instances)
    steps = WHISPER_TRAIN_STEPS
    losses = out["losses"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"whisper training losses {losses}")
    require(fwd["flash_attention"] == steps * n_attn and
            counts["flash_attention_bwd"] == steps * n_attn and
            variants == {"wgmma": steps * n_attn, "simt": 0},
            f"whisper training: flash {fwd['flash_attention']} forward, "
            f"{counts['flash_attention_bwd']} backward launches ({variants})"
            f" in {steps} steps, expected {n_attn} a step, all wgmma")
    require(counts["block_gather_bwd"] == steps and fwd["sls"] == steps and
            counts["gather_transpose"] == steps and
            sls_variants == {"rows": 0, "sparse": steps},
            f"whisper training: the token embedding's backward ran "
            f"{counts['block_gather_bwd']} times ({fwd['sls']} ember_sls "
            f"launches by variant {sls_variants}, "
            f"{counts['gather_transpose']} transpositions) in {steps} steps, "
            f"expected one a step on the transposition and the sparse sum")
    lm = trainer.lm
    final = {k: p.detach().clone() for k, p in lm.named_parameters()}
    # every parameter reached; the encoder's layer 0 (the first attention
    # call of a forward) captured for the backward check
    batch = trainer.local_batch(trainer.data.batch_at(0))
    cap = _Capture()
    with _OpSwap("attention", cap):
        for p in lm.parameters():
            p.grad = None
        lm.loss(batch["tokens"], batch["labels"], None,
                batch["enc_embeds"]).backward()
    missing = [k for k, p in lm.named_parameters() if p.grad is None]
    zero = [k for k, p in lm.named_parameters()
            if p.grad is not None and not bool(p.grad.any())]
    require(not missing and not zero, f"whisper training: no gradient for "
            f"{missing}, an all-zero one for {zero}")
    for p in lm.parameters():
        p.grad = None
    q, k, v, do = (cap.seen[n] for n in ("q", "k", "v", "do"))
    require(cap.seen["causal"] is False, "the first attention call is not "
            "the encoder's")
    chk = _check_flash_backward(q, k, v, do, None, "whisper encoder layer 0 "
                                "flash backward", causal=False)
    o, lse = chk["o"], chk["lse"]
    bwd_ms = time_ms(lambda: kops.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, causal=False), 20, warmup=2)
    bwd_plain_ms = time_ms(lambda: plain_backward(
        q, k, v, o, do, lse, causal=False), 1, warmup=1)
    sdpa = _sdpa_backward_ms(q, k, v, do, None, causal=False)
    bound_ms, bound_by, flops = _flash_bwd_bound(q, v, None, causal=False)
    emb = _gather_backward_parts(
        torch.randn((WHISPER_FRAMES, 1, cfg.d_model), device="cuda").bfloat16(),
        batch["tokens"].reshape(-1).to(torch.int32), cfg.padded_vocab, 20)
    state = {"params": dict(lm.named_parameters()),
             "opt": out["state"]["opt"], "ef": None}
    prof_wall = []
    dev = _device_time(lambda: trainer(state, batch), prof_wall)
    busy = _busy(dev, prof_wall[0])
    host = _host_top(lambda: trainer(state, batch), 6)
    first_ms = list(step_ms)
    chk_agree, chk_err = chk["agreement"], chk["max_abs_err"]
    b_, s_, h_, d_ = q.shape
    del trainer, out, state, lm, cap, batch, chk, o, lse, q, k, v, do
    free_cuda()
    trainer, again = train()
    require(again["losses"] == losses, f"whisper training: the second run's "
            f"losses {again['losses']} differ from the first's {losses}")
    differ = [k for k, p in trainer.lm.named_parameters()
              if not torch.equal(p.detach(), final[k])]
    require(not differ, f"whisper training: {len(differ)} parameters differ "
            f"between two runs from one seed, e.g. {differ[:3]}")
    n_params = len(final)
    del trainer, again, final
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_cuda()
    mean_ms = float(np.mean(first_ms[1:steps]))
    sdpa_ms = sdpa["no_mask"]
    print(f"[14 whisper training] whisper-large-v3 trained at full width "
          f"(bf16, 1 x {WHISPER_FRAMES} tokens and frames a step, lr "
          f"{TRAIN_LR}, {steps} steps, twice from seed {seed}): losses "
          f"{[round(x, 4) for x in losses]}, the second run's and all "
          f"{n_params} parameters after it bit-equal to the first's; step "
          f"ms (host clock, synchronised) {', '.join(f'{m:.1f}' for m in first_ms)}"
          f" (mean of steps 1-{steps - 1} {mean_ms:.1f}), "
          f"{WHISPER_FRAMES / mean_ms * 1e3:.0f} tokens/s; peak device memory "
          f"{peak_gib:.2f} GiB; flash {fwd['flash_attention']} forward and "
          f"{counts['flash_attention_bwd']} backward launches ({variants}); "
          f"the transposition {counts['gather_transpose']} and ember_sls "
          f"{fwd['sls']} launches ({sls_variants}; the token embedding's "
          f"backward, one a step); every parameter got a nonzero gradient; "
          f"{card}")
    print(f"[14 whisper step profile] {busy}; host own time of a step "
          f"(cProfile): {host}")
    print(f"[14 whisper flash backward] the encoder's layer 0 (B={b_}, "
          f"S={s_}, H={h_}, D={d_}, not causal, bf16) vs plain_backward: "
          f"{_bf16_summary(chk_agree)}; two calls bit-equal; wgmma kernels "
          f"{bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention's backward alone on a kept graph "
          f"(median of {sdpa.get('no_mask_reps')}) "
          f"{sdpa_ms if isinstance(sdpa_ms, str) else f'{sdpa_ms:.4f} ms'}; "
          f"bound {bound_ms:.4f} ms ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s,"
          f" by {bound_by}; {100 * bound_ms / bwd_ms:.2f}% of its bound); "
          f"{card}")
    print(f"[14 whisper embedding backward] the token embedding's gradient "
          f"({WHISPER_FRAMES} ids into {cfg.padded_vocab} rows of "
          f"{cfg.d_model} bf16): {_parts_line(emb)}; {card}")
    return {"flash_launches": fwd["flash_attention"],
            "flash_instances": fwd_instances,
            "bwd_launches": counts["flash_attention_bwd"],
            "bwd_instances": bwd_instances,
            "sls_launches": fwd["sls"],
            "transposes": counts["gather_transpose"],
            "sparse_launches": sls_variants["sparse"],
            "step_ms": mean_ms,
            "tokens_per_s": WHISPER_FRAMES / mean_ms * 1e3,
            "peak_gib": peak_gib, "bwd_ms": bwd_ms,
            "bwd_plain_ms": bwd_plain_ms,
            "bwd_library_ms": sdpa_ms if isinstance(sdpa_ms, float) else None,
            "bwd_bound_ms": bound_ms, "bwd_max_abs_err": chk_err,
            "embedding_backward_split": emb}


def phase_whisper(seed: int, card: str) -> dict:
    """whisper-large-v3 at full width and depth (32 enc_dense and 32 xdec
    layers, d_model 1280, 20 heads of 64, vocab 51,866; bf16, random
    weights from ``seed``): the prefill over WHISPER_BATCH clips of
    WHISPER_FRAMES frames and as many tokens (``_checked_prefill``: 32
    encoder, 32 self and 32 cross launches, each held against the plain
    version), the encoder's, a cross and a self layer's flash time beside
    its bound and SDPA; then served (``_whisper_serving``) and trained
    (``_whisper_training``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-large-v3")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 14)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_FRAMES))).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    enc = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model),
                      generator=g, device="cuda").to(cfg.torch_dtype)
    run = _checked_prefill(model, tokens, cfg.name, enc=enc)
    want = {"bfloat16 64/64": cfg.enc_layers + cfg.num_layers,
            "bfloat16 64/64 causal": cfg.num_layers}
    require(run["instances"] == want, f"whisper prefill flash instances "
            f"{run['instances']}, expected {want}")
    flops = _whisper_prefill_flops(cfg, WHISPER_BATCH, WHISPER_FRAMES)
    print(_prefill_line("14 whisper prefill", model, tokens, run,
                        f"xdec, after {cfg.enc_layers} enc_dense layers over "
                        f"{WHISPER_FRAMES} frames a clip", init_s) +
          f"; {flops / 1e12:.1f} TFLOP, bound "
          f"{flops / BF16_TC_FLOPS * 1e3:.1f} ms at 989 TFLOP/s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    result = {"prefill_launches": run["launches"],
              "prefill_instances": run["instances"],
              "whisper_prefill_ms": run["prefill_ms"],
              "whisper_prefill_bound_ms": flops / BF16_TC_FLOPS * 1e3}
    for kind, what in (("encoder", "an encoder layer (not causal)"),
                       ("cross", "a cross layer (1500 tokens over 1500 "
                                 "frames)"),
                       ("global", "a decoder self layer (causal)")):
        q, k, v, kw = run["layers"][kind]
        t = _flash_layer(q, k, v, kw, f"whisper {kind} layer")
        print(_flash_layer_line(f"14 whisper {kind} kernel",
                                f"flash attention, {what}", q, k, t, card))
        result.update({f"whisper_{kind}_{key}": t[key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")})
    del run, q, k, v
    t1 = time.perf_counter()
    serving = _whisper_serving(model, enc, seed, card)
    del model, enc, tokens
    free_cuda()
    t2 = time.perf_counter()
    training = _whisper_training(seed, card)
    print(f"[14 whisper time] wall seconds: prefill part {t1 - t0:.1f}, "
          f"serving part {t2 - t1:.1f}, training part "
          f"{time.perf_counter() - t2:.1f}")
    return {"prefill": result, "serving": serving, "training": training}


# ---------------------------------------------------------------------------
# Phase 15: zamba2-7b (mamba + shared attention) prefilled and served
# ---------------------------------------------------------------------------

def _gemm_kernel(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))


def _device_classes(fn, ranges: dict) -> dict:
    """One call of ``fn`` under torch.profiler, its device time split by
    class: each class of ``ranges`` (name -> (module, function): every
    kernel launched inside that function, which runs here inside a
    record_function range of the name; a kernel is matched to its launch
    by the profiler's correlation id, and the launch to the range by its
    host time), ``flash`` (the attention kernel), ``gemm`` (cuBLAS /
    CUTLASS products outside the ranges) and ``elementwise`` (the rest:
    norms, the conv, the gates, casts, copies).  ``fn`` runs twice under
    the profiler and only the second call, inside a range of its own, is
    read: a profile started in a process that profiled before missed most
    of a short call's kernels (an mlstm layer's 182 read as 67 on the
    H100).  Returns ms by class, the calls of each range, the device
    kernels and the read call's wall ms.  Only for calls of up to a few
    hundred thousand kernels: the events are read one by one in Python
    (about 5 s a million)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, inner):
        def call(*args, **kw):
            with record_function(name):
                return inner(*args, **kw)
        return call
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (module, attr) in ranges.items():
            stack.enter_context(_OpSwap(
                attr, ranged(name, getattr(module, attr)), module))
        tp = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        fn()
        torch.cuda.synchronize()
        with record_function("read"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = list(tp.profiler.kineto_results.events())
    # the host's ranges (the device timeline carries a copy of each range
    # as an annotation, later in time: neither a range nor a kernel here)
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == DeviceType.CPU
            and e.name() in ("read", *ranges)]
    (read0, read1, _), = [h for h in host if h[2] == "read"]
    spans = sorted(h for h in host if h[2] != "read" and h[0] >= read0)
    starts = np.array([a for a, _, _ in spans], np.int64)

    def range_of(t: int):
        i = int(np.searchsorted(starts, t, side="right")) - 1
        return spans[i][2] if i >= 0 and t < spans[i][1] else ""
    launched = {}          # correlation id -> range ("" for none)
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith("cu") \
                and e.correlation_id() and read0 <= e.start_ns() < read1:
            launched[e.correlation_id()] = range_of(e.start_ns())
    ms = dict.fromkeys(("gemm", "flash", *ranges, "elementwise"), 0.0)
    kernels = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0 or \
                e.correlation_id() not in launched:
            continue
        kernels += 1
        kind = launched[e.correlation_id()] or (
            "flash" if "flash" in e.name() else
            "gemm" if _gemm_kernel(e.name()) else "elementwise")
        ms[kind] += e.duration_ns() / 1e6
    return {"ms": ms, "wall_ms": wall, "kernels": kernels,
            "calls": {n: sum(1 for s in spans if s[2] == n)
                      for n in ranges}}


def _ssd_layer_ms(model, tokens) -> tuple:
    """One mamba layer's SSD scan (``_ssd_chunked``) at the prefill's
    shapes, timed alone by CUDA events on the inputs the first mamba layer
    gave it, and the fp32 FLOP of its products."""
    import torch
    from repro_torch.models import ssm
    seen = []
    inner = ssm._ssd_chunked

    def record(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return inner(*args, **kw)
    with _OpSwap("_ssd_chunked", record, ssm):
        model.prefill(tokens)
    args, kw = seen[0]
    x, chunk = args[0], args[5]
    b, s, h, p = x.shape
    n = args[3].shape[-1]
    # the intra-chunk C.B^T, its weights times x, each chunk's state and
    # the inter-chunk readout: 2 b s L h n + 2 b s L h p + 2 * 2 b s h p n
    flops = 2 * b * s * chunk * h * (n + p) + 4 * b * s * h * p * n
    ms = time_ms(lambda: inner(*args, **kw), 5, warmup=1)
    del seen
    torch.cuda.synchronize()
    return ms, flops


def _fwd_decode(model, srv, prompts, faults: bool = True) -> dict:
    """Forward == decode at full width: each prompt's logits at its last
    token from the chunked forward (``LM.forward``, prompts of one length
    batched) against the logits the server's captured wave gives there when
    it replays the prompts from zeroed caches (one wave of every prompt,
    ragged, through the graphs).  Then the same replay with a planted
    decode fault in one mamba layer (its parameters edited in place, which
    the graphs read): the decay skipped (``A_log`` = -inf: exp(dt A) = 1)
    in the middle mamba layer, and the conv window shifted by one (the taps
    read one input earlier: ``conv_w`` = [w1, w2, w3, 0]) in the first.
    Returns the relative L2 of each (``faults=False``: of the sound
    replay alone, and the replay again)."""
    import torch
    from repro_torch.core import embedding_engine as ee
    from repro_torch.models.lm import layer_kinds
    cfg = model.cfg
    lens = np.array([len(p) for p in prompts], np.int64)
    toks = np.zeros((len(prompts), int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    fwd = torch.empty((len(prompts), 1, cfg.vocab_size), device="cuda")
    with torch.inference_mode():
        for n in sorted(set(lens.tolist())):
            rows = np.flatnonzero(lens == n)
            hidden = model(torch.from_numpy(toks[rows, :n]).cuda())
            fwd[torch.from_numpy(rows).cuda()] = ee.logits(
                hidden[:, -1:], model.embed)[..., :cfg.vocab_size]
    wave = srv._wave

    def decode():
        wave.reset_slots(srv.caches, np.zeros(len(prompts), bool))
        logits, _ = wave(toks, lens, srv.caches)
        return logits

    def rel(x):
        return float((x - fwd).norm() / fwd.norm())
    out = {"rel_l2": rel(decode())}
    mamba = [i for i, k in enumerate(layer_kinds(cfg)) if k == "mamba"]
    mid, first = mamba[len(mamba) // 2], mamba[0]
    planted = {f"layer {mid}'s decay skipped": (mid, "A_log", lambda w: (
                  torch.full_like(w, float("-inf")))),
              f"layer {first}'s conv window shifted by one": (
                  first, "conv_w", lambda w: torch.cat(
                      [w[1:], torch.zeros_like(w[:1])]))}
    for name, (layer, key, edit) in (planted if faults else {}).items():
        param = model.blocks[layer].mamba[key]
        saved = param.detach().clone()
        with torch.no_grad():
            param.copy_(edit(saved))
        try:
            out[name] = rel(decode())
        finally:
            with torch.no_grad():
                param.copy_(saved)
    again = rel(decode())
    require(again == out["rel_l2"], "the replay after the planted faults "
            f"differs from the first ({again} vs {out['rel_l2']})")
    return out


def _graph_kernel_count(srv) -> int:
    """Device operations in one replay of the captured micro-step
    (torch.profiler, device events only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    replay = srv._wave.graphs["micro-step"].replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        replay()
        torch.cuda.synchronize()
    return sum(1 for e in tp.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)


def _first_shared_output(model):
    """A forward hook on the first ``shared_attn`` layer keeping its output
    hidden state: ``with _first_shared_output(model) as kept`` then
    ``kept[-1]``."""
    from repro_torch.models.lm import layer_kinds
    layer = layer_kinds(model.cfg).index("shared_attn")

    @contextlib.contextmanager
    def hooked():
        kept = []
        h = model.blocks[layer].register_forward_hook(
            lambda mod, args, out: kept.append(out[0].detach().clone()))
        try:
            yield kept
        finally:
            h.remove()
    return hooked()


def _rel(x, y) -> float:
    return float((x.float() - y.float()).norm() / y.float().norm())


def _zamba2_prefill_faults(model, tokens, run: dict) -> dict:
    """The prefill's end-to-end checks beside ``_checked_prefill``'s: the
    hidden state after the first shared_attn layer, kernel against plain
    attention, within ``PREFILL_REL_L2``; the chaos floor (plain attention
    over 128- against 64-key chunks, last hidden state); and the first
    shared layer's attention planted wrong -- its scale left out (required
    above both bounds and to fail check_bf16) and the padded width's scale
    128^-1/2 (read)."""
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import bf16_agreement, check_bf16
    def plain64(q, k, v, **kw):
        return ref.attention(q, k, v, **{**kw, "chunk": 64})
    with _first_shared_output(model) as kept:
        model.prefill(tokens)
        with _OpSwap("attention", plain_attention):
            plain_last = model.prefill(tokens)
        with _OpSwap("attention", plain64):
            floor_last = model.prefill(tokens)
    first_kernel, first_plain, first_64 = kept
    out = {"first_rel_l2": _rel(first_kernel, first_plain),
           "floor_first": _rel(first_64, first_plain),
           "floor_last": _rel(floor_last, plain_last), "faults": {}}
    require(out["first_rel_l2"] <= PREFILL_REL_L2,
            f"zamba2-7b: the hidden state after the first shared layer, "
            f"kernel vs plain attention: relative L2 "
            f"{out['first_rel_l2']:.3g} > {PREFILL_REL_L2}")
    q, k, v, kw = run["layers"]["global"]
    want = plain_attention(q, k, v, **kw)
    d = q.shape[-1]
    for name, factor in (("scale left out", d ** 0.5),
                         ("the padded width's scale 128^-1/2",
                          (d / 128) ** 0.5)):
        def faulted(q_, k_, v_, **kw_):
            faulted.calls += 1
            if faulted.calls == 1:
                q_ = q_ * factor
            return kops.flash_attention_cuda(q_, k_, v_, **kw_)
        faulted.calls = 0
        with _first_shared_output(model) as kept, \
                _OpSwap("attention", faulted):
            bad = model.prefill(tokens)
        out["faults"][name] = {
            "first": _rel(kept[0], first_plain),
            "last": _rel(bad, plain_last),
            "layer": bf16_agreement(kops.attention(q * factor, k, v, **kw),
                                    want)}
    caught = True
    try:
        check_bf16(kops.attention(q * d ** 0.5, k, v, **kw), want,
                   "scale left out")
        caught = False
    except AssertionError:
        pass
    f = out["faults"]["scale left out"]
    require(caught and f["first"] > PREFILL_REL_L2 and
            f["last"] > run["bound"],
            f"zamba2-7b: the first shared layer's attention with its scale "
            f"left out: relative L2 {f['first']:.4g} after that layer (tol "
            f"{PREFILL_REL_L2}), {f['last']:.4g} at the last hidden state "
            f"(tol {run['bound']}); its layer check caught it: {caught}")
    return out


def phase_zamba2(seed: int, card: str) -> dict:
    """zamba2-7b at full width and depth (81 layers: 68 ``mamba``, 13
    ``shared_attn`` sharing one attention and MLP set; d_model 3584, 32
    heads of 112, ssm_state 64, chunk 256; bf16, random weights from
    ``seed``): the prefill over 4 x 4096 tokens (``_checked_prefill``: 13
    flash launches at (112, 112), each held against the plain version;
    the last hidden state within ``ZAMBA_PREFILL_REL_L2``), the hidden
    state after the first shared layer within ``PREFILL_REL_L2``, the
    planted faults (``_zamba2_prefill_faults``), the device time by class,
    the flash layer's time beside its bound and SDPA; then served
    (``DecodeServer``, captured waves: graph == eager and chunk 1 == whole
    bit for bit, the gather once a wave); forward == decode read in bf16,
    then held on the model rebuilt in fp32 with two planted decode faults
    (``_zamba2_fp32``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(seed + 15)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    run = _checked_prefill(model, tokens, cfg.name,
                           bound=ZAMBA_PREFILL_REL_L2)
    n_shared = _attention_layers(cfg)
    want = {"bfloat16 112/112 causal": n_shared}
    require(run["instances"] == want, f"zamba2-7b prefill flash instances "
            f"{run['instances']}, expected {want}")
    prefill_peak = torch.cuda.max_memory_allocated()
    print(_prefill_line("15 zamba2 prefill", model, tokens, run,
                        f"{cfg.num_layers - n_shared} mamba and {n_shared} "
                        f"shared_attn, one shared set", init_s) +
          f"; peak device memory {prefill_peak / 2**30:.2f} GiB; {card}")
    ends = _zamba2_prefill_faults(model, tokens, run)
    print(f"[15 zamba2 checks] the hidden state after the first shared layer "
          f"(six layers in), kernel vs plain attention: relative L2 "
          f"{ends['first_rel_l2']:.4g} (tol {PREFILL_REL_L2}); plain "
          f"attention over 64- vs 128-key chunks: {ends['floor_first']:.4g} "
          f"there, {ends['floor_last']:.4g} at the last hidden state (the "
          f"depth's amplification; kernel vs plain there "
          f"{run['rel_l2']:.4g}, tol {ZAMBA_PREFILL_REL_L2}); the first "
          f"shared layer's attention planted wrong (after that layer / at "
          f"the last hidden state / that layer's output): " + "; ".join(
              f"{k}: {v['first']:.4g} / {v['last']:.4g} / "
              f"{_bf16_summary(v['layer'])}"
              for k, v in ends["faults"].items()) +
          " (the first required above both tols and to fail check_bf16)")
    q, k, v, kw = run["layers"]["global"]
    t = _flash_layer(q, k, v, kw, "zamba2-7b shared layer")
    print(_flash_layer_line("15 zamba2 kernel", "flash attention a shared "
                            "layer (causal, the (128, 128) kernel on 112 "
                            "columns)", q, k, t, card))
    del q, k, v
    run["layers"].clear()
    from repro_torch.models import ssm
    classes = _device_classes(lambda: model.prefill(tokens),
                              {"ssd": (ssm, "_ssd_chunked")})
    ssd_ms, ssd_flops = _ssd_layer_ms(model, tokens)
    busy = sum(classes["ms"].values())
    n_mamba = cfg.num_layers - n_shared
    print(f"[15 zamba2 where] one more prefill under torch.profiler "
          f"({classes['wall_ms']:.2f} ms with the profiler): device "
          f"{busy:.2f} ms = {100 * busy / classes['wall_ms']:.1f}% busy; by "
          f"class " + ", ".join(
              f"{k} {v:.2f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
              for k, v in sorted(classes["ms"].items(),
                                 key=lambda kv: -kv[1])) +
          f" ({classes['calls']['ssd']} SSD scans); one layer's SSD scan "
          f"alone "
          f"(CUDA events) {ssd_ms:.3f} ms, x {n_mamba} = "
          f"{ssd_ms * n_mamba:.1f} ms a prefill ({ssd_flops / 1e9:.1f} "
          f"GFLOP of fp32 products a layer, "
          f"{ssd_flops / FP32_FLOPS * 1e3:.3f} ms at 67 TFLOP/s); {card}")
    prefill_ms, launches = run["prefill_ms"], run["launches"]
    instances = run["instances"]
    del run
    t1 = time.perf_counter()

    # served: 8 requests of 256 or 320 prompt tokens, a closed batch
    prompts = [rng.integers(0, cfg.vocab_size, int(n) * 64).astype(np.int32)
               for n in rng.integers(ZAMBA_PROMPT_CHUNKS[0],
                                     ZAMBA_PROMPT_CHUNKS[1] + 1,
                                     ZAMBA_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 ZAMBA_NEW_TOKENS)                      # warm-up
    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, ZAMBA_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    _require_served(main, ZAMBA_NEW_TOKENS, counts, variants)
    m = _drive_metrics(main, ZAMBA_NEW_TOKENS)
    srv = main["srv"]
    waves = srv.serve_stats["waves"]
    chunk1 = _serve_drive(model, prompts, 1, ZAMBA_NEW_TOKENS)
    for i, (r, r1) in enumerate(zip(main["reqs"], chunk1["reqs"])):
        require(r.out == r1.out, f"zamba2-7b request {i}: prefill_chunk=1 "
                f"emitted {r1.out[:6]}... vs {r.out[:6]}...")
        require(torch.equal(main["final"][i], chunk1["final"][i]),
                f"zamba2-7b request {i}: last-wave logits differ between "
                f"prefill_chunk={SERVE_CHUNK} and 1")
    del chunk1
    lock = _lockstep_drive(model, [p[:len(p) // 4] for p in prompts],
                           LOCKSTEP_NEW_TOKENS)
    lock_ms = {n: v * 1e3 / lock["micro_steps"]
               for n, v in lock["host_s"].items()}
    lock_waves, lock_micro, lock_leaves = (lock["waves"], lock["micro_steps"],
                                           lock["leaves"])
    del lock
    graph_dev = _graph_device_ms(srv)
    kernels_a_step = _graph_kernel_count(srv)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[15 zamba2 serving] DecodeServer(batch_slots={SERVE_SLOTS}, "
          f"max_len={SERVE_MAX_LEN}, prefill_chunk={SERVE_CHUNK}, "
          f"pipeline=True), captured wave: {ZAMBA_REQUESTS} requests "
          f"(prompts of {sorted(len(p) for p in prompts)} tokens; closed "
          f"batch), {ZAMBA_NEW_TOKENS} new tokens each, all ok; {waves} "
          f"waves, {m['micro_steps']} micro-steps in {main['wall']:.2f} s: "
          f"{m['tokens_per_s']:.1f} generated tokens/s; TTFT "
          f"{_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} (lockstep: graph "
          f"{lock_ms['graph']:.3f} vs eager {lock_ms['eager']:.2f}); device "
          f"ms of one captured micro-step (CUDA events, 20 replays) unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"against {bound_ms:.3f} ms to read every weight once "
          f"({weight_bytes / 1e9:.2f} GB at 3.35 TB/s; "
          f"{100 * bound_ms / graph_dev['unmasked']:.1f}% of it); "
          f"{kernels_a_step} device operations a replayed micro-step; ms per "
          f"decode wave mean {np.mean(m['decode_ms']):.2f}; block_gather "
          f"launches {counts['block_gather']} = one a wave (rows of "
          f"{cfg.d_model * 2} B from {cfg.padded_vocab}); prefill_chunk=1: "
          f"the same tokens and bit-identical last-wave logits; graph vs "
          f"eager in lockstep (the prompts' first quarters, "
          f"{LOCKSTEP_NEW_TOKENS} new tokens): {lock_waves} waves, "
          f"{lock_micro} micro-steps, every wave's logits and every cache "
          f"leaf (the mamba state and conv window included) after every "
          f"iteration "
          f"({lock_leaves} comparisons) the same bits, the same tokens; "
          f"peak device memory {peak / 2**30:.2f} GiB; {card}")
    # read in bf16 (the depth's amplification makes it no check), so its
    # planted faults' replays are left to the fp32 model's held check
    bf16_fd = _fwd_decode(model, srv, prompts, faults=False)
    del model, main, srv, tokens
    free_cuda()
    t2 = time.perf_counter()
    f32 = _zamba2_fp32(seed, prompts)
    fd = f32["fwd_decode"]
    rel_l2 = fd.pop("rel_l2")
    print(f"[15 zamba2 forward == decode] {ZAMBA_REQUESTS} prompts, the "
          f"chunked forward's logits at each prompt's last token against "
          f"the captured decode replay's (relative L2): bf16 (read: the "
          f"depth's amplification) {bf16_fd.pop('rel_l2'):.4g}"
          f"; fp32 (the same seed, {f32['weight_bytes'] / 1e9:.2f} GB; the "
          f"reference's invariant) {rel_l2:.4g} (tol "
          f"{ZAMBA_FWD_DECODE_REL_L2}), planted faults (required above "
          f"it): " + "; ".join(f"{k}: {v:.4g}" for k, v in fd.items()) +
          f"; fp32 forward, kernel vs plain attention, last hidden state "
          f"{f32['prefill_rel_l2']:.4g} (tol {PREFILL_REL_L2}), with the "
          f"first shared layer's scale left out {f32['fault_rel_l2']:.4g}")
    require(rel_l2 <= ZAMBA_FWD_DECODE_REL_L2 and
            all(v > ZAMBA_FWD_DECODE_REL_L2 for v in fd.values()),
            f"zamba2-7b forward == decode in fp32: relative L2 {rel_l2:.4g}, "
            f"planted faults {fd}, tol {ZAMBA_FWD_DECODE_REL_L2}")
    print(f"[15 zamba2 time] wall seconds: prefill part {t1 - t_start:.1f}, "
          f"serving part {t2 - t1:.1f}, fp32 part "
          f"{time.perf_counter() - t2:.1f}")
    result = {"flash_launches": launches + f32["flash_launches"],
              "flash_instances": dict(collections.Counter(instances) +
                                      collections.Counter(
                                          f32["flash_instances"])),
              "gather_launches": variants["bulk"],
              "gather_group_launches": variants["group"],
              "zamba2_prefill_ms": prefill_ms,
              "zamba2_tokens_per_s": m["tokens_per_s"],
              "zamba2_micro_step_ms": graph_dev["unmasked"],
              "zamba2_micro_step_bound_ms": bound_ms,
              "zamba2_fwd_decode_rel_l2": rel_l2}
    result.update({f"zamba2_{key}": t[key] for key in
                   ("ms", "plain_ms", "library_ms", "bound_ms")})
    return result


def _zamba2_fp32(seed: int, prompts) -> dict:
    """zamba2-7b rebuilt in fp32 from the same seed (22.4 GB; the bf16
    model freed first): the prompts' forward (the f32 flash kernel at
    (112, 112), counted) against plain attention, last hidden state within
    ``PREFILL_REL_L2``, and with the first shared layer's scale left out
    above it; then forward == decode through a server's captured wave
    (``_fwd_decode``) within ``ZAMBA_FWD_DECODE_REL_L2``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer
    cfg = dataclasses.replace(get_config("zamba2-7b"), dtype="float32")
    model = LM(cfg, seed=seed)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    toks = torch.from_numpy(np.stack([p[:256] for p in prompts]).astype(
        np.int64)).cuda()
    kops.reset_launch_counts()
    with torch.inference_mode():
        last = model.prefill(toks)
    launches = kops.launch_counts()["flash_attention"]
    instances = dict(kops.flash_attention_cuda.instances)
    require(instances == {"float32 112/112 causal": _attention_layers(cfg)},
            f"zamba2-7b fp32 forward flash instances {instances}")
    with _OpSwap("attention", plain_attention):
        plain_last = model.prefill(toks)
    d = cfg.hd

    def faulted(q_, k_, v_, **kw_):
        faulted.calls += 1
        if faulted.calls == 1:
            q_ = q_ * d ** 0.5
        return kops.flash_attention_cuda(q_, k_, v_, **kw_)
    faulted.calls = 0
    with _OpSwap("attention", faulted):
        bad = model.prefill(toks)
    out = {"prefill_rel_l2": _rel(last, plain_last),
           "fault_rel_l2": _rel(bad, plain_last),
           "flash_launches": launches, "flash_instances": instances,
           "weight_bytes": weight_bytes}
    require(out["prefill_rel_l2"] <= PREFILL_REL_L2 <
            out["fault_rel_l2"], f"zamba2-7b fp32 forward vs plain "
            f"attention: relative L2 {out['prefill_rel_l2']:.4g}, with the "
            f"scale left out {out['fault_rel_l2']:.4g}, tol {PREFILL_REL_L2}")
    srv = DecodeServer(model, batch_slots=len(prompts),
                       max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
    out["fwd_decode"] = _fwd_decode(model, srv, prompts)
    del model, srv
    free_cuda()
    return out

# ---------------------------------------------------------------------------
# Phase 16: xlstm-1.3b (mlstm + slstm) prefilled, served and trained
# ---------------------------------------------------------------------------

def _xlstm_card_vs_cpu(seed: int) -> dict:
    """The first super-block of xlstm-1.3b (three mlstm layers and one
    slstm layer at full width, with the embedding and the final norm) in
    fp32 from one set of weights on the card and on the CPU: the hidden
    states over 1 x XLSTM_BLOCK_SEQ tokens (two chunks of 256), then
    XLSTM_BLOCK_DECODE decode steps of the next tokens from empty caches,
    each step's logits and every cache leaf after them (dtype for dtype),
    each within XLSTM_CARD_CPU_REL_L2.  No kernel check covers this path:
    it is what shows a product in TF32, a reordered gate layout or a leaf
    in the wrong dtype on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=4,
                              dtype="float32")
    host = LM(cfg, device="cpu", seed=seed)
    card = LM(cfg, seed=seed)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(seed + 16)
    n = XLSTM_BLOCK_SEQ
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, n + XLSTM_BLOCK_DECODE)))
    with torch.inference_mode():
        want = host(tokens[:, :n])
        got = card(tokens[:, :n].cuda()).cpu()
    out = {"hidden": _rel(got, want), "logits": 0.0, "leaves": {}}
    hc, cc = host.init_caches(1, 16), card.init_caches(1, 16)
    for t in range(XLSTM_BLOCK_DECODE):
        tok = tokens[:, n + t:n + t + 1]
        hl, hc = host.decode_step(tok, hc)
        cl, cc = card.decode_step(tok.cuda(), cc)
        out["logits"] = max(out["logits"], _rel(cl.cpu(), hl))
    for i, (h_, c_) in enumerate(zip(hc, cc)):
        for k in h_:
            require(c_[k].dtype == h_[k].dtype, f"xlstm layer {i}'s cache "
                    f"leaf {k}: {c_[k].dtype} on the card, {h_[k].dtype} "
                    f"on the CPU")
            out["leaves"][f"{i}.{k}"] = _rel(c_[k].cpu(), h_[k])
    worst = max(out["hidden"], out["logits"], *out["leaves"].values())
    require(worst <= XLSTM_CARD_CPU_REL_L2 and np.isfinite(worst),
            f"xlstm-1.3b's first super-block in fp32, card vs CPU: hidden "
            f"{out['hidden']:.3g}, logits {out['logits']:.3g}, leaves "
            f"{out['leaves']}, tol {XLSTM_CARD_CPU_REL_L2}")
    out["worst"], out["d_model"] = worst, cfg.d_model
    del host, card
    free_cuda()
    return out


def _xlstm_prefill_flops(cfg, tokens: int) -> float:
    """The GEMMs of an xlstm prefill over ``tokens`` tokens: each mlstm
    layer's five (d, d) products, each slstm layer's ``w_in`` (d, 4d),
    ``wo`` (d, d) and the recurrent product (h heads of (hd, 4hd)), 2 FLOP
    a multiply-add (the gates' (d, 2h) product and the scans' chunk
    products not counted)."""
    from repro_torch.models.lm import layer_kinds
    d = cfg.d_model
    kinds = layer_kinds(cfg)
    per_token = kinds.count("mlstm") * 5 * d * d + \
        kinds.count("slstm") * (5 * d * d + 4 * d * d // cfg.num_heads)
    return 2.0 * tokens * per_token


def _scaled_classes(run: dict, factor: float) -> dict:
    """A ``_device_classes`` reading of a window scaled to the whole call
    (``factor`` = whole / window): device ms by class, kernels, wall ms."""
    run["ms"] = {k: v * factor for k, v in run["ms"].items()}
    run["kernels"] = int(run["kernels"] * factor)
    run["wall_ms"] *= factor
    return run


def _recorded(module, name: str):
    """``with _recorded(module, name) as seen``: every call of
    ``module.<name>`` runs as it is and appends ``(args, kwargs, result)``
    to ``seen``."""
    inner = getattr(module, name)
    seen = []

    def record(*args, **kw):
        out = inner(*args, **kw)
        seen.append((args, kw, out))
        return out

    @contextlib.contextmanager
    def swapped():
        with _OpSwap(name, record, module):
            yield seen
    return swapped()


def _xlstm_prefill(model, tokens, card: str) -> dict:
    """xlstm-1.3b's prefill on the card: a warm-up over 256 tokens, then
    the main path, ``LM.prefill`` over ``tokens`` (host clock,
    synchronised; peak memory), its last hidden state finite; the first
    mlstm and the first slstm layer's inputs kept from it.  Where the time
    goes, one layer of each kind on those inputs under torch.profiler, its
    device time by class (``mlstm_scan``: the two ``gated_linear_scan``
    calls; ``slstm``: the recurrence's loop, ``_slstm_scan``; GEMMs;
    elementwise): the mlstm layer at the prefill's shapes, the slstm layer
    over its first XLSTM_WINDOW positions, scaled by S / XLSTM_WINDOW
    (each step of the loop and each token of its projections issue the
    same work); and alone by CUDA events the mlstm layer's two scans and
    the slstm layer's whole loop.  (A whole prefill launches about a
    million kernels: read under the profiler it would take minutes.)"""
    import torch
    from repro_torch.models import xlstm
    from repro_torch.models.lm import layer_kinds
    cfg = model.cfg
    kinds = layer_kinds(cfg)
    first = {k: kinds.index(k) for k in ("mlstm", "slstm")}
    model.prefill(tokens[:, :256])             # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inputs = {}

    def keep(kind):
        def hook(mod, args):       # returns None: the input is unchanged
            inputs.setdefault(kind, args[0])
        return hook
    hooks = [model.blocks[i].register_forward_pre_hook(keep(k))
             for k, i in first.items()]
    try:
        t0 = time.perf_counter()
        last = model.prefill(tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated()
    require(last.shape == (tokens.shape[0], 1, cfg.d_model) and
            bool(torch.isfinite(last).all()), "xlstm-1.3b prefill output")
    mblk, sblk = (model.blocks[first[k]] for k in ("mlstm", "slstm"))
    s = tokens.shape[1]
    with torch.inference_mode():
        layer = {
            "mlstm": _device_classes(
                lambda: mblk(inputs["mlstm"], None),
                {"mlstm_scan": (xlstm, "gated_linear_scan")}),
            "slstm": _scaled_classes(_device_classes(
                lambda: sblk(inputs["slstm"][:, :XLSTM_WINDOW], None),
                {"slstm": (xlstm, "_slstm_scan")}), s / XLSTM_WINDOW)}
        with _recorded(xlstm, "gated_linear_scan") as scans, \
                _recorded(xlstm, "_slstm_scan") as loops:
            mblk(inputs["mlstm"], None)
            sblk(inputs["slstm"], None)
        scan, loop = xlstm.gated_linear_scan, xlstm._slstm_scan
        scans_ms = time_ms(lambda: [scan(*a, **kw) for a, kw, _ in scans],
                           3, warmup=1)
        (args, kw, _), = loops
        loop_ms = time_ms(lambda: loop(*args, **kw), 1, warmup=0)
    x = scans[0][0][0]
    b, s, h, p = x.shape
    chunk = scans[0][0][5]
    # the two scans' products: C.B^T and the intra-chunk weights times x
    # (each scan), each chunk's state and the inter-chunk readout (p = hd
    # for the numerator, 1 for the denominator)
    scan_flops = sum(2 * b * s * chunk * h * (p_ + p) + 4 * b * s * h * p_ * p
                     for p_ in (p, 1))
    del scans, loops, inputs, args, kw, x
    counts = {"mlstm": kinds.count("mlstm"), "slstm": kinds.count("slstm")}
    by_class = collections.Counter()
    for kind, n in counts.items():
        for c, v in layer[kind]["ms"].items():
            by_class[c] += n * v
    by_class.pop("flash", None)
    flops = _xlstm_prefill_flops(cfg, tokens.numel())
    return {"prefill_ms": prefill_ms, "peak": peak, "layer": layer,
            "by_class": dict(by_class), "device_ms": sum(by_class.values()),
            "scans_ms": scans_ms, "scan_flops": scan_flops,
            "loop_ms": loop_ms, "counts": counts, "flops": flops}


def _xlstm_states(model, toks, lens) -> tuple:
    """The chunked forward of the prompts (``toks`` rows ragged-right by
    ``lens``; prompts of one length batched): each prompt's logits at its
    last token, and every recurrent layer's final state in its cache's
    layout -- an mlstm layer's ``C`` and ``n`` from its two scans' final
    states, an slstm layer's ``h``, ``c``, ``n``, ``m`` from its loop's
    final carry -- one row a prompt."""
    import torch
    from repro_torch.core import embedding_engine as ee
    from repro_torch.models import xlstm
    from repro_torch.models.lm import layer_kinds
    cfg = model.cfg
    kinds = layer_kinds(cfg)
    fwd = torch.empty((len(lens), 1, cfg.vocab_size), device=model.device)
    states = [{} for _ in kinds]
    with torch.inference_mode():
        for n in sorted(set(lens.tolist())):
            rows = torch.from_numpy(np.flatnonzero(lens == n)).cuda()
            with _recorded(xlstm, "gated_linear_scan") as scans, \
                    _recorded(xlstm, "_slstm_scan") as loops:
                hidden = model(torch.from_numpy(toks[lens == n, :n]).cuda())
            fwd[rows] = ee.logits(hidden[:, -1:],
                                  model.embed)[..., :cfg.vocab_size]
            scans, loops = iter(scans), iter(loops)
            for layer, kind in enumerate(kinds):
                if kind == "mlstm":
                    new = {"C": next(scans)[2][1], "n": next(scans)[2][1]}
                else:
                    new = dict(zip("hcnm", next(loops)[2][1]))
                for k, t in new.items():
                    if k not in states[layer]:
                        states[layer][k] = torch.empty(
                            (len(lens),) + t.shape[1:], dtype=t.dtype,
                            device=t.device)
                    states[layer][k][rows] = t
    return fwd, states


def _xlstm_fwd_decode(model, srv, prompts, faults: bool = True) -> dict:
    """Forward == decode at full width: each prompt's last-token logits and
    every recurrent layer's final state from the chunked forward
    (``_xlstm_states``) against the logits and the cache leaves that the
    server's captured wave leaves when it replays the prompts from zeroed
    caches (one wave of every prompt, ragged): the relative L2 of the
    logits and the largest of any layer's leaf.  With ``faults``, the same
    replay with a planted decode fault in one layer: the middle mlstm
    layer's decode leaving the normaliser ``n`` unupdated (a code fault:
    the layer's decode patched, then a wave captured anew on caches of its
    own), and the middle slstm layer's decode without its recurrent term
    ``rh`` (``r`` zeroed in place for the replay, which the graphs read)."""
    import torch
    from repro_torch.models.lm import layer_kinds
    from repro_torch.runtime.server import WaveGraph
    cfg = model.cfg
    kinds = layer_kinds(cfg)
    lens = np.array([len(p) for p in prompts], np.int64)
    toks = np.zeros((len(prompts), int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    fwd, states = _xlstm_states(model, toks, lens)

    def rel(logits, caches) -> dict:
        leaves = {f"{i}.{k}": _rel(c[k][:len(prompts)], states[i][k])
                  for i, c in enumerate(caches) for k in c}
        worst = max(leaves, key=leaves.get)
        return {"logits": _rel(logits, fwd), "state": leaves[worst],
                "state_at": worst,
                "worst": max(_rel(logits, fwd), leaves[worst])}

    def replay(wave, caches):
        wave.reset_slots(caches, np.zeros(len(prompts), bool))
        logits, _ = wave(toks, lens, caches)
        return rel(logits, caches)

    def graph():
        return replay(srv._wave, srv.caches)
    out = {"sound": graph()}
    if not faults:
        return out
    mlstm = [i for i, k in enumerate(kinds) if k == "mlstm"]
    slstm = [i for i, k in enumerate(kinds) if k == "slstm"]
    m_mid, s_mid = mlstm[len(mlstm) // 2], slstm[len(slstm) // 2]
    blk = model.blocks[m_mid]

    def stale_n(x, cache, active=None, ctx=None, decode=blk.decode):
        n = cache["n"].clone()
        y = decode(x, cache, active, ctx)
        cache["n"].copy_(n)
        return y
    caches = model.init_caches(len(prompts), SERVE_MAX_LEN)
    blk.decode = stale_n
    try:
        out[f"layer {m_mid}'s mlstm decode leaving n unupdated"] = replay(
            WaveGraph(model, caches), caches)
    finally:
        del blk.decode
    del caches
    r = model.blocks[s_mid].slstm["r"]
    saved = r.detach().clone()
    with torch.no_grad():
        r.zero_()
    try:
        out[f"layer {s_mid}'s slstm decode without rh"] = graph()
    finally:
        with torch.no_grad():
            r.copy_(saved)
    again = graph()
    require(again == out["sound"], f"the replay after the planted faults "
            f"differs from the first ({again} vs {out['sound']})")
    return out


def _fwd_decode_line(fd: dict) -> str:
    return "; ".join(f"{k}: logits {v['logits']:.4g}, state {v['state']:.4g}"
                     f" (layer.leaf {v['state_at']})" for k, v in fd.items())


def _xlstm_fp32(seed: int, prompts) -> dict:
    """xlstm-1.3b rebuilt in fp32 from the same seed (4.64 GB; the bf16
    model freed first): forward == decode through a server's captured wave
    (``_xlstm_fwd_decode``), held within XLSTM_FWD_DECODE_REL_L2 with both
    planted faults above it."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32",
                              num_layers=XLSTM_LAYERS)
    model = LM(cfg, seed=seed)
    srv = DecodeServer(model, batch_slots=len(prompts),
                       max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
    out = _xlstm_fwd_decode(model, srv, prompts)
    del model, srv
    free_cuda()
    return out


def _xlstm_training(seed: int, card: str) -> dict:
    """xlstm-1.3b trained at full width and XLSTM_TRAIN_LAYERS of its 48
    layers through the Trainer: 1 x XLSTM_TRAIN_SEQ tokens a step, lr TRAIN_LR, XLSTM_TRAIN_STEPS steps,
    twice from one seed, its checkpoint save a no-op (phase 13 covers
    checkpoints).  Checked: every loss finite, the two runs' losses and
    final parameters bit-equal, no flash launch, one transposition and one
    sparse ember_sls launch a step (the token embedding's backward), a
    nonzero gradient for every parameter in the first step (read by a hook
    as each gradient lands: a step takes seconds, so none is run for the
    check alone).  Printed: step ms, tokens/s, peak memory; one mlstm
    layer's forward and backward at the step's shapes and one slstm
    layer's over XLSTM_WINDOW positions, scaled, under torch.profiler (the
    layers' device time, a lower bound of the step's busy share); the
    embedding's backward timed apart as in phase 13."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM, layer_kinds
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              num_layers=XLSTM_TRAIN_LAYERS)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=XLSTM_TRAIN_SEQ,
                                      global_batch=1))
    ckpt_dir = REPO / "build" / "xlstm_train"
    step_ms: list = []
    steps = XLSTM_TRAIN_STEPS

    class Timed(Trainer):
        def __call__(self, state, batch):
            t0 = time.perf_counter()
            loss = super().__call__(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return loss

    def train(nonzero=None):
        trainer = Timed(LM(cfg, seed=seed), data, TrainerConfig(
            total_steps=steps, ckpt_every=steps, ckpt_dir=str(ckpt_dir),
            lr=TRAIN_LR))
        trainer.ckpt.save = lambda *a, **kw: None
        hooks = []
        if nonzero is not None:        # the first step's gradients
            for name, p in trainer.lm.named_parameters():
                def landed(p, name=name):
                    if name not in nonzero:
                        nonzero[name] = bool(p.grad.any())
                hooks.append(p.register_post_accumulate_grad_hook(landed))
        try:
            return trainer, trainer.run()
        finally:
            for h in hooks:
                h.remove()

    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    nonzero = {}
    trainer, out = train(nonzero)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    counts = kops.backward_launch_counts()
    fwd = kops.launch_counts()
    sls_variants = kops.variant_launch_counts()["sls"]
    losses = out["losses"]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"xlstm training losses {losses}")
    require(fwd["flash_attention"] == counts["flash_attention_bwd"] == 0,
            f"xlstm training launched flash {fwd['flash_attention']} / "
            f"{counts['flash_attention_bwd']} times: it has no attention")
    require(counts["block_gather_bwd"] == steps and fwd["sls"] == steps and
            counts["gather_transpose"] == steps and
            sls_variants == {"rows": 0, "sparse": steps},
            f"xlstm training: the token embedding's backward ran "
            f"{counts['block_gather_bwd']} times ({fwd['sls']} ember_sls "
            f"launches by variant {sls_variants}, "
            f"{counts['gather_transpose']} transpositions) in {steps} steps, "
            f"expected one a step on the transposition and the sparse sum")
    lm = trainer.lm
    final = {k: p.detach().clone() for k, p in lm.named_parameters()}
    missing = [k for k, _ in lm.named_parameters() if k not in nonzero]
    zero = [k for k, v in nonzero.items() if not v]
    require(not missing and not zero, f"xlstm training: no gradient for "
            f"{missing}, an all-zero one for {zero}")
    batch = trainer.local_batch(trainer.data.batch_at(0))
    emb = _gather_backward_parts(
        torch.randn((XLSTM_TRAIN_SEQ, 1, cfg.d_model),
                    device=lm.device).bfloat16(),
        batch["tokens"].reshape(-1).to(torch.int32), cfg.padded_vocab, 20)
    kinds = layer_kinds(cfg)
    g = torch.Generator(device=lm.device).manual_seed(seed + 16)
    x = torch.randn((1, XLSTM_TRAIN_SEQ, cfg.d_model), generator=g,
                    device=lm.device).to(cfg.torch_dtype).requires_grad_()
    dy = torch.randn(x.shape, generator=g, device=lm.device).to(x.dtype)
    layer = {}
    for kind, n in (("mlstm", XLSTM_TRAIN_SEQ), ("slstm", XLSTM_WINDOW)):
        blk = lm.blocks[kinds.index(kind)]
        layer[kind] = _scaled_classes(_device_classes(
            lambda: blk(x[:, :n], None)[0].backward(dy[:, :n]), {}),
            XLSTM_TRAIN_SEQ / n)
        layer[kind]["count"] = kinds.count(kind)
        for p in blk.parameters():
            p.grad = None
    layers_ms = sum(v["count"] * sum(v["ms"].values())
                    for v in layer.values())
    first_ms = list(step_ms)
    n_params = len(final)
    del trainer, out, lm, batch, x, dy
    free_cuda()
    trainer, again = train()
    require(again["losses"] == losses, f"xlstm training: the second run's "
            f"losses {again['losses']} differ from the first's {losses}")
    differ = [k for k, p in trainer.lm.named_parameters()
              if not torch.equal(p.detach(), final[k])]
    require(not differ, f"xlstm training: {len(differ)} parameters differ "
            f"between two runs from one seed, e.g. {differ[:3]}")
    del trainer, again, final
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_cuda()
    mean_ms = float(np.mean(first_ms[1:steps]))
    print(f"[16 xlstm training] xlstm-1.3b trained at full width and "
          f"{cfg.num_layers} of its 48 layers (bf16, 1 x "
          f"{XLSTM_TRAIN_SEQ} tokens a step, lr {TRAIN_LR}, {steps} steps, "
          f"twice from seed {seed}): losses {[round(v, 4) for v in losses]},"
          f" the second run's and all {n_params} parameters after it "
          f"bit-equal to the first's; step ms (host clock, synchronised) "
          f"{', '.join(f'{m:.1f}' for m in first_ms)} (mean of steps "
          f"1-{steps - 1} {mean_ms:.1f}), "
          f"{XLSTM_TRAIN_SEQ / mean_ms * 1e3:.0f} tokens/s; peak device "
          f"memory {peak_gib:.2f} GiB; no flash launch; the transposition "
          f"{counts['gather_transpose']} and ember_sls {fwd['sls']} launches "
          f"({sls_variants}; the token embedding's backward, one a step); "
          f"every parameter got a nonzero gradient in the first step; "
          f"{card}")
    print(f"[16 xlstm step where] one layer of each kind, forward and "
          f"backward under torch.profiler (the slstm layer over "
          f"{XLSTM_WINDOW} of the {XLSTM_TRAIN_SEQ} positions, scaled): " +
          "; ".join(f"{k} {v['wall_ms']:.1f} ms with the profiler, device "
                    f"{sum(v['ms'].values()):.2f} ms ({v['kernels']} kernels"
                    f"), x {v['count']} layers" for k, v in layer.items()) +
          f"; the layers' device time {layers_ms:.1f} ms = "
          f"{100 * layers_ms / mean_ms:.1f}% of a step (a lower bound of its "
          f"busy share: the logits, the loss and AdamW not counted); {card}")
    print(f"[16 xlstm embedding backward] the token embedding's gradient "
          f"({XLSTM_TRAIN_SEQ} ids into {cfg.padded_vocab} rows of "
          f"{cfg.d_model} bf16): {_parts_line(emb)}; {card}")
    return {"sls_launches": fwd["sls"],
            "transposes": counts["gather_transpose"],
            "sparse_launches": sls_variants["sparse"],
            "step_ms": mean_ms,
            "tokens_per_s": XLSTM_TRAIN_SEQ / mean_ms * 1e3,
            "peak_gib": peak_gib, "layers_busy_share": layers_ms / mean_ms,
            "embedding_backward_split": emb}


def phase_xlstm(seed: int, card: str) -> dict:
    """xlstm-1.3b at full width and XLSTM_LAYERS of its 48 layers (3
    ``mlstm`` to 1 ``slstm``; d_model 2048, 4 heads of 512, chunk 256;
    bf16, random weights from ``seed``): the first super-block in fp32 on the card
    against the CPU (``_xlstm_card_vs_cpu``); the prefill over 4 x 4096
    tokens (``_xlstm_prefill``); served (``DecodeServer``, captured waves:
    graph == eager and chunk 1 == whole bit for bit, the gather once a
    wave); forward == decode read in bf16; trained (``_xlstm_training``);
    then forward == decode held on the model rebuilt in fp32, with two
    planted decode faults (``_xlstm_fp32``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    free_cuda()
    t_start = time.perf_counter()
    block = _xlstm_card_vs_cpu(seed)
    print(f"[16 xlstm card vs cpu] the first super-block (3 mlstm + 1 slstm "
          f"layers, d_model {block['d_model']}, fp32, one set of weights) "
          f"over 1 x "
          f"{XLSTM_BLOCK_SEQ} tokens, then {XLSTM_BLOCK_DECODE} decode "
          f"steps, card vs CPU (relative L2): hidden states "
          f"{block['hidden']:.3g}, logits (worst step) {block['logits']:.3g},"
          f" cache leaves after the decode " + ", ".join(
              f"{k} {v:.3g}" for k, v in block["leaves"].items()) +
          f" (tol {XLSTM_CARD_CPU_REL_L2}); TF32 off for the caller, and the "
          f"gates' product turns it off itself; {card}")
    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              num_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(seed + 16)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    pre = _xlstm_prefill(model, tokens, card)
    busy = pre["device_ms"]
    bound_ms = pre["flops"] / BF16_TC_FLOPS * 1e3
    print(f"[16 xlstm prefill] {cfg.name} {cfg.num_layers} layers "
          f"({pre['counts']['mlstm']} mlstm, {pre['counts']['slstm']} slstm),"
          f" d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.hd}, vocab "
          f"{cfg.vocab_size}, bf16, {n_params} params (random; init "
          f"{init_s:.2f} s); {PREFILL_BATCH} x {PREFILL_SEQ} uniform token "
          f"ids: prefill {pre['prefill_ms']:.2f} ms (host clock + "
          f"synchronize; no hand-written kernel on this path); peak device "
          f"memory {pre['peak'] / 2**30:.2f} GiB; GEMMs "
          f"{pre['flops'] / 1e12:.2f} TFLOP, bound {bound_ms:.2f} ms at 989 "
          f"TFLOP/s; {card}")
    print(f"[16 xlstm where] under torch.profiler, on the inputs the "
          f"prefill gave them, the first mlstm layer at the prefill's shapes "
          f"and the first slstm layer over {XLSTM_WINDOW} of its "
          f"{PREFILL_SEQ} positions, scaled: " +
          "; ".join(f"{k} layer {v['wall_ms']:.2f} ms with the profiler, "
                    f"device " + ", ".join(f"{c} {m:.2f}" for c, m in
                                           v["ms"].items() if m) +
                    f" ms ({v['kernels']} kernels)"
                    for k, v in pre["layer"].items()) +
          f"; x {pre['counts']['mlstm']} and {pre['counts']['slstm']} layers"
          f": device {busy:.1f} ms = {100 * busy / pre['prefill_ms']:.1f}% "
          f"busy of the prefill; by class " + ", ".join(
              f"{k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
              for k, v in sorted(pre["by_class"].items(),
                                 key=lambda kv: -kv[1])) +
          f"; alone (CUDA events): one mlstm layer's two scans "
          f"{pre['scans_ms']:.3f} ms ({pre['scan_flops'] / 1e9:.1f} GFLOP "
          f"of products, {pre['scan_flops'] / BF16_TC_FLOPS * 1e3:.3f} ms "
          f"at 989 TFLOP/s), one slstm layer's {PREFILL_SEQ}-step loop "
          f"{pre['loop_ms']:.1f} ms (x {pre['counts']['slstm']} = "
          f"{pre['loop_ms'] * pre['counts']['slstm']:.0f} ms a prefill); "
          f"{card}")
    t2 = time.perf_counter()

    # served: 8 requests of 256 or 320 prompt tokens, a closed batch
    torch.cuda.reset_peak_memory_stats()
    prompts = [rng.integers(0, cfg.vocab_size, int(n) * 64).astype(np.int32)
               for n in rng.integers(XLSTM_PROMPT_CHUNKS[0],
                                     XLSTM_PROMPT_CHUNKS[1] + 1,
                                     XLSTM_REQUESTS)]
    _serve_drive(model, [p[:8] for p in prompts[:2]], SERVE_CHUNK,
                 XLSTM_NEW_TOKENS)                      # warm-up
    kops.reset_launch_counts()
    main = _serve_drive(model, prompts, SERVE_CHUNK, XLSTM_NEW_TOKENS)
    counts = kops.launch_counts()
    variants = kops.variant_launch_counts()["block_gather"]
    _require_served(main, XLSTM_NEW_TOKENS, counts, variants)
    m = _drive_metrics(main, XLSTM_NEW_TOKENS)
    srv = main["srv"]
    waves = srv.serve_stats["waves"]
    chunk1 = _serve_drive(model, prompts, 1, XLSTM_NEW_TOKENS)
    for i, (r, r1) in enumerate(zip(main["reqs"], chunk1["reqs"])):
        require(r.out == r1.out, f"xlstm-1.3b request {i}: prefill_chunk=1 "
                f"emitted {r1.out[:6]}... vs {r.out[:6]}...")
        require(torch.equal(main["final"][i], chunk1["final"][i]),
                f"xlstm-1.3b request {i}: last-wave logits differ between "
                f"prefill_chunk={SERVE_CHUNK} and 1")
    del chunk1
    lock = _lockstep_drive(model, [p[:len(p) // 4] for p in prompts],
                           LOCKSTEP_NEW_TOKENS)
    lock_ms = {n: v * 1e3 / lock["micro_steps"]
               for n, v in lock["host_s"].items()}
    lock_waves, lock_micro, lock_leaves = (lock["waves"], lock["micro_steps"],
                                           lock["leaves"])
    del lock
    graph_dev = _graph_device_ms(srv)
    kernels_a_step = _graph_kernel_count(srv)
    cache_bytes = sum(t.numel() * t.element_size() for c in srv.caches
                      for t in c.values())
    micro_bound_ms = (weight_bytes + 2 * cache_bytes) / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[16 xlstm serving] DecodeServer(batch_slots={SERVE_SLOTS}, "
          f"max_len={SERVE_MAX_LEN}, prefill_chunk={SERVE_CHUNK}, "
          f"pipeline=True), captured wave: {XLSTM_REQUESTS} requests "
          f"(prompts of {sorted(len(p) for p in prompts)} tokens; closed "
          f"batch), {XLSTM_NEW_TOKENS} new tokens each, all ok; {waves} "
          f"waves, {m['micro_steps']} micro-steps in {main['wall']:.2f} s: "
          f"{m['tokens_per_s']:.1f} generated tokens/s; TTFT "
          f"{_percentiles(m['ttft'])}; per token "
          f"{_percentiles(m['per_token'])}; host ms a micro-step "
          f"{m['issue_ms'] / m['micro_steps']:.3f} (lockstep: graph "
          f"{lock_ms['graph']:.3f} vs eager {lock_ms['eager']:.2f}, over the "
          f"prompts' first quarters and {LOCKSTEP_NEW_TOKENS} new "
          f"tokens); device "
          f"ms of one captured micro-step (CUDA events, 20 replays) unmasked "
          f"{graph_dev['unmasked']:.3f}, masked {graph_dev['masked']:.3f} "
          f"against a {micro_bound_ms:.3f} ms bound (every weight read once, "
          f"{weight_bytes / 1e9:.2f} GB, and the recurrent caches read and "
          f"written once, 2 x {cache_bytes / 1e9:.2f} GB, at 3.35 TB/s; "
          f"{100 * micro_bound_ms / graph_dev['unmasked']:.1f}% of it); "
          f"{kernels_a_step} device operations a replayed micro-step; ms per "
          f"decode wave mean {np.mean(m['decode_ms']):.2f}; block_gather "
          f"launches {counts['block_gather']} = one a wave (rows of "
          f"{cfg.d_model * 2} B from {cfg.padded_vocab}); prefill_chunk=1: "
          f"the same tokens and bit-identical last-wave logits; graph vs "
          f"eager in lockstep (the prompts' first quarters): {lock_waves} "
          f"waves, {lock_micro} micro-steps, every wave's logits and every "
          f"cache leaf (C, n; h, c, n, m) after every iteration "
          f"({lock_leaves} comparisons) the same bits, the same tokens; peak "
          f"device memory "
          f"{peak / 2**30:.2f} GiB; {card}")
    bf16_fd = _xlstm_fwd_decode(model, srv, prompts, faults=False)
    del model, main, srv, tokens
    free_cuda()
    t3 = time.perf_counter()
    training = _xlstm_training(seed, card)
    t4 = time.perf_counter()
    fd = _xlstm_fp32(seed, prompts)
    sound = fd.pop("sound")
    print(f"[16 xlstm forward == decode] {XLSTM_REQUESTS} prompts, the "
          f"chunked forward's last-token logits and every recurrent layer's "
          f"final state against the captured decode replay's (relative L2; "
          f"state: the largest of any layer's leaf): bf16 (read) "
          f"{_fwd_decode_line(bf16_fd)}; fp32 (the same seed; the "
          f"reference's invariant) sound: logits {sound['logits']:.4g}, "
          f"state {sound['state']:.4g} (layer.leaf {sound['state_at']}; tol "
          f"{XLSTM_FWD_DECODE_REL_L2}), planted faults (required above it): "
          f"{_fwd_decode_line(fd)}")
    require(sound["worst"] <= XLSTM_FWD_DECODE_REL_L2 and
            all(v["worst"] > XLSTM_FWD_DECODE_REL_L2 for v in fd.values()),
            f"xlstm-1.3b forward == decode in fp32: {sound}, planted faults "
            f"{fd}, tol {XLSTM_FWD_DECODE_REL_L2}")
    print(f"[16 xlstm time] wall seconds: card vs cpu {t1 - t_start:.1f}, "
          f"prefill part {t2 - t1:.1f}, serving part {t3 - t2:.1f}, "
          f"training part {t4 - t3:.1f}, fp32 part "
          f"{time.perf_counter() - t4:.1f}; phase "
          f"{time.perf_counter() - t_start:.1f}")
    return {"gather_launches": variants["bulk"],
            "gather_group_launches": variants["group"],
            "training": training,
            "xlstm_prefill_ms": pre["prefill_ms"],
            "xlstm_tokens_per_s": m["tokens_per_s"],
            "xlstm_micro_step_ms": graph_dev["unmasked"],
            "xlstm_micro_step_bound_ms": micro_bound_ms,
            "xlstm_fwd_decode_rel_l2": sound["worst"]}


# ---------------------------------------------------------------------------
# Phase 18: tensor and expert parallelism over two gloo ranks on the card
# ---------------------------------------------------------------------------

def _tp_collectives(stats: dict, before: dict) -> dict:
    return {k: stats[k] - before[k] for k in before}


def _tp_chatglm3(rank: int, lm, job: dict, card_counts: list) -> dict:
    """Phase 18(a) on one rank: the first layer's flash call held to the
    plain version (this also warms the path up), then the counted main
    path: the 2 x 512 prefill, the teacher-forced micro-steps and the
    served drive."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.runtime.server import DecodeServer, Request
    out = {}
    tokens = torch.from_numpy(job["tokens"]).cuda()
    first = []

    def held(q, k, v, **kw):
        o = kops.flash_attention_cuda(q, k, v, **kw)
        if not first:
            first.append((q, k, v, kw, o))
        return o
    with _OpSwap("attention", held):
        lm.prefill(tokens)
    q, k, v, kw, fo = first.pop()
    out["flash"] = check_bf16(fo, plain_attention(q, k, v, **kw),
                              f"rank {rank}'s layer-0 flash on its heads")
    out["flash_shape"] = (tuple(q.shape), tuple(k.shape))
    out["flash_ms"] = time_ms(lambda: kops.attention(q, k, v, causal=True),
                              10)
    out["flash_plain_ms"] = time_ms(lambda: plain_attention(q, k, v, **kw),
                                    2, warmup=1)
    del q, k, v, fo
    stats = lm.collective_stats
    gather = _LastCall(kops.block_gather)
    kops.block_gather = gather
    kops.reset_launch_counts()
    c0 = dict(stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = lm.prefill(tokens)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_coll"] = _tp_collectives(stats, c0)
    out["last"] = last.float().cpu().numpy()
    tf = job["tf_tokens"]
    caches = lm.init_caches(tf.shape[0], tf.shape[1] + 1)
    logits, ms, c0 = [], [], dict(stats)
    for t in range(tf.shape[1]):
        tok = torch.from_numpy(tf[:, t:t + 1]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = lm.decode_step(tok, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.cpu().numpy())
    out["tf_logits"], out["step_ms"] = np.stack(logits), ms
    out["step_coll"] = {k: v / tf.shape[1] for k, v in
                        _tp_collectives(stats, c0).items()}
    del caches
    srv = DecodeServer(lm, batch_slots=TP_SLOTS, max_len=TP_MAX_LEN,
                       pipeline=False)
    reqs = [Request(prompt=p, max_new_tokens=TP_NEW_TOKENS)
            for p in job["prompts"]]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    out["serve_s"] = time.perf_counter() - t0
    out["served"] = [list(r.out) for r in reqs]
    out["statuses"] = [r.status for r in reqs]
    out["serve_stats"] = dict(srv.serve_stats)
    ex = srv.compile_stats["executor"]
    out["executor"] = {k: ex[k] for k in ("shards", "exchange",
                                          "replicate_outputs")}
    out["access_plans"] = "access_plans" in srv.compile_stats
    card_counts.append((kops.launch_counts(),
                        dict(kops.flash_attention_cuda.instances)))
    kops.block_gather = gather.fn
    a, kw, got = gather.last
    require(torch.equal(got, ref.block_gather(*a, **kw)),
            f"rank {rank}: the masked lookup's block gather != the plain "
            f"gather")
    out["gather_shape"] = f"{a[1].numel()} rows of {a[0].shape[0]}"
    del srv, reqs
    return out


def _tp_qwen3(rank: int, lm, job: dict, card_counts: list) -> dict:
    """Phase 18(b) on one rank: a warm-up prefill, then the counted main
    path -- the 1 x 256 prefill (seq-split: the all-to-all exchange) and
    the decode micro-steps (replicated tokens: the all-gather of the
    expert outputs) -- with every layer's routing recorded for the
    parent's pinned comparison."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe as moe_mod
    out = {}
    tokens = torch.from_numpy(job["moe_tokens"]).cuda()
    lm.prefill(tokens)                               # warm-up
    route, routes = moe_mod.route, []

    def record(x2d, router, k):
        probs, topw, tope = route(x2d, router, k)
        routes.append(tope)
        return probs, topw, tope
    stats = lm.collective_stats
    moe_mod.route = record
    try:
        kops.reset_launch_counts()
        c0 = dict(stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = lm.prefill(tokens)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill_coll"] = _tp_collectives(stats, c0)
        out["prefill_routes"] = [t.cpu().numpy() for t in routes]
        routes.clear()
        dec = job["moe_decode"]
        caches = lm.init_caches(dec.shape[0], dec.shape[1] + 1)
        logits, ms, c0 = [], [], dict(stats)
        for t in range(dec.shape[1]):
            tok = torch.from_numpy(dec[:, t:t + 1]).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = lm.decode_step(tok, caches)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.cpu().numpy())
        card_counts.append((kops.launch_counts(),
                            dict(kops.flash_attention_cuda.instances)))
    finally:
        moe_mod.route = route
    out["step_coll"] = {k: v / dec.shape[1] for k, v in
                        _tp_collectives(stats, c0).items()}
    out["decode_routes"] = [t.cpu().numpy() for t in routes]
    out["last"] = last.float().cpu().numpy()
    out["dec_logits"], out["step_ms"] = np.stack(logits), ms
    return out


def _tp_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of phase 18 (a spawned process sharing the card with the
    other): chatglm3-6b at full width, then qwen3-moe-235b-a22b's widths
    at TP_MOE_LAYERS layers, each built from the phase's seed with only
    this rank's slices kept.  Returns plain numbers and numpy arrays."""
    import collections as _c
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    torch.cuda.set_device(0)
    mesh = make_host_mesh(world)
    shard = ShardCtx(mesh)
    counts: list = []
    res = {}
    for key, cfg, drive in (
            ("chatglm3", get_config("chatglm3-6b"), _tp_chatglm3),
            ("qwen3", dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                          num_layers=TP_MOE_LAYERS),
             _tp_qwen3)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm = LM(cfg, seed=job["seed"], shard=shard)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held = sum(p.numel() * p.element_size() for p in lm.parameters())
        t0 = time.perf_counter()
        res[key] = drive(rank, lm, job, counts)
        res[key].update(init_s=init_s, held_bytes=held,
                        drive_s=time.perf_counter() - t0,
                        peak=torch.cuda.max_memory_allocated())
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    launches = _c.Counter()
    instances = _c.Counter()
    for c, inst in counts:
        launches.update({k: c[k] for k in ("flash_attention",
                                           "block_gather")})
        instances.update(inst)
    res["launches"], res["instances"] = dict(launches), dict(instances)
    return res


def _tp_parent_chatglm3(seed: int, job: dict) -> dict:
    """Phase 18(a)'s single device: the prefill, the teacher-forced
    micro-steps (their tokens: the prompt, then this model's own argmax)
    and the served drive, on ``LM(cfg, seed)``; freed before the ranks
    start."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import DecodeServer, Request
    cfg = get_config("chatglm3-6b")
    model = LM(cfg, seed=seed)
    want = {"last": model.prefill(torch.from_numpy(job["tokens"]).cuda())
            .float().cpu()}
    tf = job["tf_tokens"]
    caches = model.init_caches(tf.shape[0], tf.shape[1] + 1)
    logits = []
    for t in range(tf.shape[1]):
        if t >= TP_TF_PROMPT:             # teacher: this model's argmax
            tf[:, t] = logits[-1][:, 0].argmax(-1).numpy()
        lg, _ = model.decode_step(torch.from_numpy(tf[:, t:t + 1]).cuda(),
                                  caches)
        logits.append(lg.cpu())
    want["tf_logits"] = torch.stack(logits)
    srv = DecodeServer(model, batch_slots=TP_SLOTS, max_len=TP_MAX_LEN,
                       pipeline=False)
    reqs = [Request(prompt=p, max_new_tokens=TP_NEW_TOKENS)
            for p in job["prompts"]]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    want["served"] = [list(r.out) for r in reqs]
    del model, caches, srv
    free_cuda()
    return want


def _tp_parent_qwen3(seed: int, job: dict, ranks: list) -> dict:
    """Phase 18(b)'s plain versions on the full weights of
    qwen3-moe-235b-a22b's widths at TP_MOE_LAYERS layers
    (:func:`_tp_parent_moe`), freed after."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=TP_MOE_LAYERS)
    model = LM(cfg, seed=seed)
    out = _tp_parent_moe(model, "qwen3", job, ranks)
    del model
    free_cuda()
    return out


def _tp_parent_moe(model, key: str, job: dict, ranks: list) -> dict:
    """The plain versions of two expert-parallel ranks' MoE drive
    (``_tp_qwen3``; the ranks' results under ``key``) on ``model``, the
    single device's full weights, in this process: the prefill through
    ``moe_ffn_ep_plain`` (two ranks' seq-split semantics) and the decode
    micro-steps on the single device, each with the routing pinned to the
    ranks' (each layer's top-k experts, weighted by this run's own
    probabilities, as phase 9 pins them); and the routing decisions that
    differ when nothing is pinned, counted."""
    import torch
    from repro_torch.models import moe as moe_mod
    cfg = model.cfg
    route = moe_mod.route
    seen = []

    def replay(seq):
        def pinned(x2d, router, k):
            probs, _, own = route(x2d, router, k)
            tope = torch.from_numpy(seq[len(seen)]).to(x2d.device)
            seen.append(own)
            topw = probs.gather(-1, tope)
            return probs, topw / topw.sum(-1, keepdim=True).clamp_min(
                1e-9), tope
        return pinned

    def flips(got: list, want: list) -> int:
        return int(sum((np.sort(g.cpu().numpy(), -1) !=
                        np.sort(w, -1)).any(-1).sum()
                       for g, w in zip(got, want)))
    # seq-split: layer l's block r is rank r's routing of layer l
    r0, r1 = (r[key] for r in ranks)
    seq = [x for pair in zip(r0["prefill_routes"], r1["prefill_routes"])
           for x in pair]
    for blk in model.blocks:
        blk._ffn = (lambda h, b=blk:
                    moe_mod.moe_ffn_ep_plain(b.moe, h, cfg, 2))
    tokens = torch.from_numpy(job["moe_tokens"]).cuda()
    try:
        moe_mod.route = replay(seq)
        last = model.prefill(tokens).float().cpu()
        prefill_flips = flips(seen, seq)
        seen.clear()
    finally:
        moe_mod.route = route
        for blk in model.blocks:
            del blk._ffn
    dec = job["moe_decode"]
    caches = model.init_caches(dec.shape[0], dec.shape[1] + 1)
    logits = []
    try:
        moe_mod.route = replay(r0["decode_routes"])
        for t in range(dec.shape[1]):
            lg, _ = model.decode_step(torch.from_numpy(dec[:, t:t + 1])
                                      .cuda(), caches)
            logits.append(lg.cpu())
        decode_flips = flips(seen, r0["decode_routes"])
    finally:
        moe_mod.route = route
    n_dec = sum(len(x) for x in r0["decode_routes"])
    n_pre = sum(len(x) for x in seq)
    del caches
    return {"last": last, "dec_logits": torch.stack(logits),
            "prefill_flips": prefill_flips, "prefill_tokens": n_pre,
            "decode_flips": decode_flips, "decode_tokens": n_dec}


def phase_tp(seed: int, card: str) -> dict:
    """Phase 18: tensor and expert parallelism of the LM over two gloo
    ranks sharing the one card (spawned, a file store; every activation
    collective staged through pinned host memory).  (a) chatglm3-6b at
    full width: each rank builds its half of ``LM(cfg, seed)``; the
    2 x 512 prefill's last hidden state against the single device's, the
    first layer's flash output on the rank's heads against the plain
    version, TP_TF_STEPS teacher-forced micro-steps' logits against the
    single device's, and a DecodeServer per rank serving the same
    TP_REQUESTS requests (tokens equal on both ranks; how many equal the
    single device's is counted).  (b) qwen3-moe-235b-a22b's widths at
    TP_MOE_LAYERS layers (the model fits no card): the 1 x 256 prefill on
    the seq-split expert-parallel path against ``moe_ffn_ep_plain`` on the
    full weights, and TP_MOE_DECODE micro-steps on the replicated-token
    path against the single device, the routing pinned to the ranks'.
    Returns the launches by kernel and the flash instances."""
    from repro_torch.launch.mesh import run_ranks
    print("[18 tp predicted] written before the first run on the card "
          "(PERF.md): " + "; ".join(f"{k} {v}"
                                          for k, v in TP_PREDICTED.items()))
    rng = np.random.default_rng(seed + 18)
    from repro_torch.configs import get_config
    vocab = get_config("chatglm3-6b").vocab_size
    tf = np.zeros((TP_SLOTS, TP_TF_STEPS), np.int64)
    tf[:, :TP_TF_PROMPT] = rng.integers(0, vocab, (TP_SLOTS, TP_TF_PROMPT))
    job = {"seed": seed,
           "tokens": rng.integers(0, vocab, TP_PREFILL).astype(np.int64),
           "tf_tokens": tf,
           "prompts": [rng.integers(0, vocab, int(n)).astype(np.int32)
                       for n in rng.integers(TP_PROMPT_MIN, TP_PROMPT_MAX + 1,
                                             TP_REQUESTS)]}
    moe_vocab = get_config("qwen3-moe-235b-a22b").vocab_size
    job["moe_tokens"] = rng.integers(0, moe_vocab, TP_MOE_PREFILL).astype(
        np.int64)
    job["moe_decode"] = rng.integers(0, moe_vocab,
                                     (TP_SLOTS, TP_MOE_DECODE)).astype(
                                         np.int64)
    t0 = time.perf_counter()
    want = _tp_parent_chatglm3(seed, job)
    parent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(_tp_rank, 2, (job,), timeout_s=900)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_want = _tp_parent_qwen3(seed, job, ranks)
    moe_parent_s = time.perf_counter() - t0
    import torch
    # (a) chatglm3-6b
    a0, a1 = (r["chatglm3"] for r in ranks)
    require(a0["served"] == a1["served"],
            "chatglm3-6b: the two ranks served different tokens")
    require(np.array_equal(a0["last"], a1["last"]) and
            np.array_equal(a0["tf_logits"], a1["tf_logits"]),
            "chatglm3-6b: the ranks' outputs differ")
    agree = sum(x == y for g, w in zip(a0["served"], want["served"])
                for x, y in zip(g, w))
    total = sum(len(w) for w in want["served"])
    for rank, r in enumerate((a0, a1)):
        rel = _rel_l2(torch.from_numpy(r["last"]), want["last"])
        require(rel <= TP_REL_L2, f"chatglm3-6b rank {rank}: prefill "
                f"relative L2 {rel:.4g} > {TP_REL_L2} against the single "
                f"device")
        tf_rel = [_rel_l2(torch.from_numpy(r["tf_logits"][t]),
                          want["tf_logits"][t])
                  for t in range(TP_TF_STEPS)]
        require(max(tf_rel) <= TP_REL_L2,
                f"chatglm3-6b rank {rank}: teacher-forced logits relative "
                f"L2 {max(tf_rel):.4g} > {TP_REL_L2}")
        require(r["executor"]["shards"] == 2 and r["access_plans"] and
                all(s == "ok" for s in r["statuses"]),
                f"chatglm3-6b rank {rank}: server {r['executor']}, "
                f"{r['statuses']}")
        require(not r["serve_stats"]["wave_graph"] and
                r["serve_stats"]["wave_graph_why"] == "gloo",
                "a gloo rank's server must run its wave eagerly")
        pc, sc = r["prefill_coll"], r["step_coll"]
        print(f"[18 tp chatglm3-6b rank {rank}] {r['held_bytes'] / 1e9:.3f} "
              f"GB of weights held (init {r['init_s']:.2f} s); 2 x 512 "
              f"prefill {r['prefill_ms']:.1f} ms (host clock, synchronised; "
              f"{pc['collectives']} collectives, "
              f"{pc['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{pc['collective_ms']:.1f} ms in them), last hidden state vs "
              f"the single device relative L2 {rel:.4g} (tol {TP_REL_L2}); "
              f"{TP_TF_STEPS} teacher-forced micro-steps of {TP_SLOTS} slots: "
              f"mean {np.mean(r['step_ms'][1:]):.2f} ms, first "
              f"{r['step_ms'][0]:.2f} ms ({sc['collectives']:.1f} "
              f"collectives, {sc['staged_bytes'] / 1e6:.3f} MB staged, "
              f"{sc['collective_ms']:.2f} ms a step), logits vs the single "
              f"device relative L2 <= {max(tf_rel):.4g}; layer 0 flash on "
              f"this rank's q {r['flash_shape'][0]} / k "
              f"{r['flash_shape'][1]}: {_bf16_summary(r['flash'])}, kernel "
              f"{r['flash_ms']:.4f} ms, plain {r['flash_plain_ms']:.4f} ms; "
              f"served {TP_REQUESTS} requests x {TP_NEW_TOKENS} tokens in "
              f"{r['serve_s']:.2f} s, {r['serve_stats']['waves']} waves, "
              f"eager (gloo); executor {r['executor']}; peak "
              f"{r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[18 tp chatglm3-6b served] both ranks emitted the same "
          f"{total} tokens; {agree} of {total} equal the single device's "
          f"(its graph-served drive; bf16 near-ties may flip an argmax, "
          f"and a flip changes the rest of its request); the masked "
          f"lookup's block gather ({a0['gather_shape']}) == the plain "
          f"gather; parent {parent_s:.1f} s, ranks {ranks_s:.1f} s; {card}")
    # (b) qwen3-moe widths
    b0, b1 = (r["qwen3"] for r in ranks)
    require(np.array_equal(b0["last"], b1["last"]) and
            np.array_equal(b0["dec_logits"], b1["dec_logits"]),
            "qwen3-moe: the ranks' outputs differ")
    for rank, r in enumerate((b0, b1)):
        rel = _rel_l2(torch.from_numpy(r["last"]), moe_want["last"])
        require(rel <= TP_REL_L2, f"qwen3-moe rank {rank}: seq-split "
                f"prefill relative L2 {rel:.4g} > {TP_REL_L2} against "
                f"moe_ffn_ep_plain (routing pinned)")
        dec_rel = [_rel_l2(torch.from_numpy(r["dec_logits"][t]),
                           moe_want["dec_logits"][t])
                   for t in range(TP_MOE_DECODE)]
        require(max(dec_rel) <= TP_REL_L2,
                f"qwen3-moe rank {rank}: replicated-token decode relative "
                f"L2 {max(dec_rel):.4g} > {TP_REL_L2}")
        pc, sc = r["prefill_coll"], r["step_coll"]
        print(f"[18 tp qwen3-moe rank {rank}] widths of qwen3-moe-235b-a22b "
              f"at {TP_MOE_LAYERS} layers, {r['held_bytes'] / 1e9:.3f} GB "
              f"held (init {r['init_s']:.2f} s); 1 x 256 prefill, seq-split "
              f"(all-to-all) {r['prefill_ms']:.1f} ms ({pc['collectives']} "
              f"collectives, {pc['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{pc['collective_ms']:.1f} ms), vs moe_ffn_ep_plain relative "
              f"L2 {rel:.4g}; {TP_MOE_DECODE} decode micro-steps of "
              f"{TP_SLOTS} slots, replicated tokens (all-gather): mean "
              f"{np.mean(r['step_ms'][1:]):.2f} ms, first "
              f"{r['step_ms'][0]:.2f} ms ({sc['collectives']:.1f} "
              f"collectives, {sc['staged_bytes'] / 1e6:.3f} MB staged a "
              f"step), logits vs the single device relative L2 <= "
              f"{max(dec_rel):.4g}; peak {r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[18 tp qwen3-moe routing] pinned to the ranks' in the plain "
          f"runs; unpinned, {moe_want['prefill_flips']} of "
          f"{moe_want['prefill_tokens']} prefill token-layer top-"
          f"8 sets and {moe_want['decode_flips']} of "
          f"{moe_want['decode_tokens']} decode ones would differ; plain "
          f"runs {moe_parent_s:.1f} s; {card}")
    launches = collections.Counter()
    instances = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
        instances.update(r["instances"])
    require(launches["flash_attention"] > 0 and launches["block_gather"] > 0,
            f"a kernel of the tensor-parallel path never launched: "
            f"{dict(launches)}")
    require(sum(instances.values()) == launches["flash_attention"],
            f"tp flash instances {dict(instances)} != launches")
    print(f"[18 tp time] the single device's chatglm3-6b {parent_s:.1f} s; "
          f"the ranks spawned, run and joined {ranks_s:.1f} s (rank 0: "
          f"chatglm3-6b init {a0['init_s']:.1f} + drive {a0['drive_s']:.1f} "
          f"s, of it serving {a0['serve_s']:.1f} s; qwen3-moe init "
          f"{b0['init_s']:.1f} + drive {b0['drive_s']:.1f} s); the qwen3-moe "
          f"plain runs {moe_parent_s:.1f} s; {card}")
    print(f"[18 tp launches] both ranks' main paths: flash_attention "
          f"{launches['flash_attention']} ({dict(instances)}), block gather "
          f"{launches['block_gather']}; {card}")
    return {"flash_launches": launches["flash_attention"],
            "flash_instances": dict(instances),
            "gather_launches": launches["block_gather"],
            "tp_flash_ms": a0["flash_ms"],
            "tp_flash_plain_ms": a0["flash_plain_ms"],
            "tp_flash_max_abs_err": max(a0["flash"]["max_abs"],
                                        a1["flash"]["max_abs"])}


def _free_after_tp(before: int) -> None:
    """Require phase 18 to leave the card as it found it (< 1 GiB more
    allocated in this process than ``before``): its single-device models
    hold 12.5 and 11.2 GB."""
    import torch
    free_cuda()
    held = torch.cuda.memory_allocated()
    print(f"[18 tp after] this process holds {held / 2**30:.2f} GiB "
          f"({before / 2**30:.2f} before the phase)")
    require(held - before < 1 << 30, f"phase 18 left "
            f"{(held - before) / 2**30:.2f} GiB allocated")


# ---------------------------------------------------------------------------
# Phase 19: model-parallel training over gloo ranks on the card
# ---------------------------------------------------------------------------

def _mp_config():
    """h2o-danube-1.8b at full width and MP_DEPTH of its layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("h2o-danube-1.8b"),
                               num_layers=MP_DEPTH)


def _host_f32(t):
    return t.detach().float().cpu().numpy()


def _mp_counts(kops) -> dict:
    """The launches this process made since the last reset, by kernel and
    variant, for the main path's check."""
    fwd, bwd = kops.launch_counts(), kops.backward_launch_counts()
    var = kops.variant_launch_counts()
    return {"flash": fwd["flash_attention"], "gather": fwd["block_gather"],
            "flash_bwd": bwd["flash_attention_bwd"],
            "gather_bwd": bwd["block_gather_bwd"],
            "transpose": bwd["gather_transpose"],
            "bwd_variants": dict(var["flash_attention_bwd"]),
            "sls_variants": dict(var["sls"]),
            "instances": dict(kops.flash_attention_cuda.instances),
            "bwd_instances": dict(kops.flash_attention_bwd_cuda.instances)}


def _mp_rank_kernels(lm, tokens, window: int) -> dict:
    """Rank 0's kernel checks and times at a rank's shapes (its heads, its
    vocab rows): the flash forward and backward (random bf16 q, k, v, dO
    of layer shape) held to their plain versions, timed beside the bound,
    the plain backward and SDPA's; the masked lookup's block gather held
    to the plain gather; its backward on the rank's rows
    (``_gather_backward_parts``: the transposition and the sparse sum held
    to theirs, timed beside ``index_add_``)."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.flash_attention import plain_backward
    cfg, dev = lm.cfg, lm.device
    h, hkv = (lm.blocks[0].attn["wq"].shape[1] // cfg.hd,
              lm.blocks[0].attn["wk"].shape[1] // cfg.hd)
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v, do = (torch.randn((1, tokens.shape[1], n, cfg.hd), generator=g,
                               device=dev).bfloat16()
                   for n in (h, hkv, hkv, h))
    chk = _check_flash_backward(q, k, v, do, window, "a rank's layer flash "
                                "backward")
    o, lse = chk["o"], chk["lse"]
    ms = time_ms(lambda: kops.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, window=window), 20, warmup=2)
    plain_ms = time_ms(lambda: plain_backward(q, k, v, o, do, lse,
                                              window=window), 1, warmup=1)
    sdpa = _sdpa_backward_ms(q, k, v, do, window)
    bound_ms, bound_by, flops = _flash_bwd_bound(q, v, window)
    table = lm.embed.detach()
    v_local = table.shape[0]
    local = tokens.reshape(-1).long() - lm.tp.rank * v_local
    idx = local.clamp(0, v_local - 1).to(torch.int32)
    got = kops.block_gather_cuda(table, idx)
    require(torch.equal(got, ref.block_gather(table, idx)),
            "a rank's masked lookup gather != the plain gather")
    emb = _gather_backward_parts(
        torch.randn((idx.numel(), 1, cfg.d_model), generator=g,
                    device=dev).bfloat16(), idx, v_local, 10)
    return {"flash_bwd_ms": ms, "flash_bwd_plain_ms": plain_ms,
            "flash_bwd_sdpa": sdpa, "flash_bwd_bound_ms": bound_ms,
            "flash_bwd_bound_by": bound_by, "flash_bwd_flops": flops,
            "flash_bwd_agreement": chk["agreement"],
            "flash_bwd_max_abs_err": chk["max_abs_err"],
            "flash_shape": (tuple(q.shape), tuple(k.shape)),
            "gather_backward": emb}


def _mp_rank_a(rank: int, world: int, job: dict) -> dict:
    """Phase 19(a) on one rank: its half of h2o-danube-1.8b, MP_STEPS
    trainer steps (``Trainer.loss_and_grads`` then ``AdamW.apply_``, the
    trainer's step, ``TrainStep.__call__``) counted and timed, step 0's gradients of
    MP_GRAD_LEAVES kept; then (rank 0, the other rank waiting) the kernel
    checks at a rank's shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    marks = [("start", time.time())]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(world)
    cfg = _mp_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=job["seed"], shard=ShardCtx(mesh))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ, global_batch=1))
    tr = Trainer(lm, data, TrainerConfig(total_steps=MP_STEPS,
                                         ckpt_dir=job["ckpt"], lr=TRAIN_LR))
    state = tr.init_state()
    marks.append(("init", time.time()))
    stats = lm.collective_stats
    out = {"steps": [], "init_s": init_s,
           "held_bytes": sum(p.numel() * p.element_size()
                             for p in lm.parameters())}
    kops.reset_launch_counts()
    for step in range(MP_STEPS):
        batch = tr.local_batch(tr.data.batch_at(step))
        c0 = dict(stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(state["params"], batch)
        state["opt"] = tr.opt.apply_(state["params"], grads, state["opt"],
                                     tr.shards)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["steps"].append({"loss": float(loss), "ms": ms,
                             "coll": _tp_collectives(stats, c0)})
        if step == 0:
            out["grads"] = {k: _host_f32(grads[k]) for k in MP_GRAD_LEAVES}
        del grads, loss
    out["counts"] = _mp_counts(kops)
    out["peak"] = torch.cuda.max_memory_allocated()
    marks.append(("steps", time.time()))
    dist.barrier()
    if rank == 0:
        tokens = tr.local_batch(tr.data.batch_at(0))["tokens"]
        out["kernels"] = _mp_rank_kernels(lm, tokens, cfg.sliding_window)
    dist.barrier()
    marks.append(("kernels", time.time()))
    out["marks"] = marks
    return out


class _Attempts:
    """A Trainer subclass's record of each attempt's (step, loss)."""

    def __init__(self):
        self.runs: list = []

    def trainer(self, base):
        rec = self

        class Recorded(base):
            def run(self, **kw):
                attempt = []
                rec.runs.append(attempt)
                return super().run(on_step=lambda s, l: attempt.append(
                    (s, l)), **kw)
        return Recorded


def _digest(t) -> str:
    """The sha1 of a tensor's bytes (on the host)."""
    import torch
    return hashlib.sha1(t.detach().cpu().contiguous().view(torch.uint8)
                        .numpy()).hexdigest()


def _mp_rank_b(rank: int, world: int, job: dict) -> dict:
    """Phase 19(b) on one rank of the (2, 2) mesh: the 2-layer model's
    supervised run with ZeRO-1 ``in_shardings`` and sharded checkpoints,
    then the checks of the final checkpoint against every rank's slices
    (:func:`_mp_rank_restores`, their digests all-gathered); its attempts'
    losses, launches, the digest of every slice it holds and its place on
    the mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import mesh_index, train_specs
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.trainer import (Trainer, TrainerConfig,
                                             run_supervised)
    marks = [("start", time.time())]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(2)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                              num_layers=MP_LAYERS)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=MP_SEQ,
                                      global_batch=MP_BATCH))
    specs = train_specs(cfg, mesh, MP_BATCH, MP_SEQ, zero1=True)
    rec = _Attempts()
    made = []

    def make():
        made.clear()
        made.append(rec.trainer(Trainer)(
            LM(cfg, seed=job["seed"], shard=ShardCtx(mesh)), data,
            TrainerConfig(total_steps=MP_SUP_STEPS, ckpt_every=MP_SUP_EVERY,
                          ckpt_dir=job["ckpt"], lr=TRAIN_LR),
            in_shardings=specs))
        return made[0]
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    marks.append(("mesh", time.time()))
    out = run_supervised(make, failure_schedule={MP_SUP_FAIL})
    torch.cuda.synchronize()
    marks.append(("run", time.time()))
    counts = _mp_counts(kops)
    st = out["state"]
    held = {"params": st["params"], "mu": st["opt"].mu, "nu": st["opt"].nu}
    digest = {f"{w}/{k}": _digest(t)
              for w, tree in held.items() for k, t in tree.items()}
    everyone: list = [None] * world
    dist.all_gather_object(everyone, (mesh_index(mesh), digest))
    checks = _mp_rank_restores(rank, everyone, int(st["opt"].step), cfg,
                               specs, job["ckpt"])
    marks.append(("checks", time.time()))
    return {"attempts": rec.runs, "restarts": out["restarts"],
            "wall_s": marks[2][1] - marks[1][1], "counts": counts,
            "peak": torch.cuda.max_memory_allocated(),
            "index": mesh_index(mesh),
            "zero1": sorted(made[0].shards.zero1),
            "coll": dict(made[0].lm.collective_stats), "digest": digest,
            "checks": checks, "marks": marks}


def _mp_rank_restores(rank: int, everyone: list, step: int, cfg,
                      specs: tuple, ckpt: str) -> dict:
    """Checks of the (2, 2) run's last checkpoint against every rank's
    slices (``everyone``: each rank's mesh index and digests, in rank
    order).  Rank 0 restores it onto one device (no ``shardings``): every
    rank's block of every leaf (by its param or ZeRO-1 spec) has that
    rank's digest.  Ranks 0 and 1 (data coordinate 0) restore it with
    ``shardings=`` onto the (1, 2) rank at their model coordinate (the
    params' specs, no ZeRO-1): every leaf has the digest of the slice the
    rank holds, a ZeRO-1 moment's data blocks those of the data ranks at
    its model coordinate.  The other ranks check nothing here."""
    import torch
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.launch.sharding import local_shard, train_specs
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWState
    p_specs, o_specs, _ = specs
    sizes = {"data": 2, "model": 2}
    meta = {k: t.detach() for k, t in
            LM(cfg, device="meta").named_parameters()}

    def state_like(params):
        return {"params": params, "opt": AdamWState(
            torch.empty((), dtype=torch.int32, device="meta"),
            *({k: torch.empty(t.shape, device="meta")
               for k, t in params.items()} for _ in range(2))), "ef": None}

    def leaves(state):
        return (("params", state["params"]), ("mu", state["opt"].mu),
                ("nu", state["opt"].nu))
    out = {}
    if rank == 0:
        tree, got_step = restore_checkpoint(ckpt, train_state_to_reference(
            state_like(meta), cfg))
        full = train_state_from_reference(tree, cfg, "cpu")
        ok = [got_step == MP_SUP_STEPS - 1, int(full["opt"].step) == step]
        for w, got in leaves(full):
            spec = p_specs if w == "params" else o_specs.mu
            for k, t in got.items():
                ok += [_digest(local_shard(t, spec[k], sizes, index)) ==
                       dig[f"{w}/{k}"] for index, dig in everyone]
        out["one_device"] = (sum(ok), len(ok))
    if everyone[rank][0]["data"] == 0:
        m = everyone[rank][0]["model"]
        sizes12, index12 = {"data": 1, "model": 2}, {"data": 0, "model": m}
        p12 = train_specs(cfg, sizes12, MP_BATCH, MP_SEQ, zero1=False)[0]
        local = state_like({k: local_shard(t, p12[k], sizes12, index12)
                            for k, t in meta.items()})
        place = train_state_to_reference(local, cfg,
                                         shards=(p12, p12, sizes12, index12))
        tree, _ = restore_checkpoint(ckpt, place, shardings=place)
        ok = []
        for w, got in leaves(train_state_from_reference(tree, cfg, "cpu")):
            for k, t in got.items():
                for index, dig in everyone:
                    if index["model"] != m:
                        continue
                    if w != "params" and o_specs.mu[k] != p_specs[k]:
                        n = t.shape[0] // sizes["data"]   # ZeRO-1 rows
                        blk = t[index["data"] * n:(index["data"] + 1) * n]
                    elif index["data"]:
                        continue
                    else:
                        blk = t
                    ok.append(_digest(blk) == dig[f"{w}/{k}"])
        out["mesh12"] = (sum(ok), len(ok))
    return out


def _marks(marks: list, t0: float) -> str:
    """A rank's timeline: seconds from ``t0`` (the parent's clock before
    the spawn) at each mark."""
    return ", ".join(f"{name} {t - t0:.1f} s" for name, t in marks)


def _mp_single(seed: int, tokens, labels) -> dict:
    """Phase 19(a)'s single device: ``LM(cfg, seed)``'s loss and the
    gradients of MP_GRAD_LEAVES on step 0's batch; freed before the ranks
    start."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    lm = LM(_mp_config(), seed=seed).requires_grad_(True)
    loss = lm.loss(tokens.to(lm.device), labels.to(lm.device))
    loss.backward()
    params = dict(lm.named_parameters())
    want = {"loss": loss.item(), "grads": {
        k: params[k].grad.float().cpu() for k in MP_GRAD_LEAVES}}
    del lm, loss, params
    free_cuda()
    return want


def _mp_joined(ranks: list, what: str, name: str):
    """A leaf joined from the model-axis ranks' slices, along the dim its
    spec splits."""
    import torch
    from repro_torch.launch.sharding import concat_shards, param_spec
    parts = [torch.from_numpy(r[what][name]) for r in ranks]
    return concat_shards(parts, param_spec(name, parts[0].dim()))


def _mp_supervised_checks(ranks: list) -> dict:
    """Phase 19(b)'s checks of the ranks' results: the attempts, the
    restart's bit-equal step, the ranks' losses equal, the ranks that hold
    the same slice holding the same bits (digests), and every rank's
    checks of the checkpoint (:func:`_mp_rank_restores`) passed."""
    r0 = ranks[0]
    runs = [[s for s, _ in a] for a in r0["attempts"]]
    want_runs = [list(range(MP_SUP_FAIL)),
                 list(range(MP_SUP_EVERY, MP_SUP_STEPS))]
    require(r0["restarts"] == 1 and runs == want_runs,
            f"mp supervised: attempts ran {runs}, expected {want_runs}")
    for r in ranks[1:]:
        require(r["attempts"] == r0["attempts"],
                "mp supervised: the ranks' losses differ")
    again = dict(r0["attempts"][1])[MP_SUP_EVERY]
    first = dict(r0["attempts"][0])[MP_SUP_EVERY]
    require(again == first, f"mp supervised: step {MP_SUP_EVERY} after the "
            f"restart gave {again!r}, the first attempt {first!r}")
    zero1 = set(r0["zero1"])
    require(bool(zero1), "mp supervised: no ZeRO-1 leaf")
    for r, res in enumerate(ranks):
        d, m = divmod(r, 2)
        for key, dig in res["digest"].items():
            w, k = key.split("/", 1)
            same = ranks[d * 2] if w != "params" and k in zero1 else ranks[m]
            require(dig == same["digest"][key],
                    f"mp supervised: rank {r}'s {key} differs from the rank "
                    f"holding the same slice")
        for what, (ok, n) in res["checks"].items():
            require(ok == n, f"mp supervised: rank {r}'s {what} restore: "
                    f"{n - ok} of {n} blocks differ from the ranks' slices")
    require("one_device" in r0["checks"] and
            all("mesh12" in ranks[m]["checks"] for m in range(2)),
            "mp supervised: a restore check did not run")
    return {"leaves": r0["checks"]["one_device"][1],
            "restart_loss": again}


def phase_mp_train(seed: int, card: str) -> dict:
    """Phase 19: model-parallel training over gloo ranks sharing the card
    (spawned, a file store; every collective staged through pinned host
    memory), (a) h2o-danube-1.8b at full width and MP_DEPTH of its 24
    layers over two ranks,
    (b) its widths at MP_LAYERS layers over four, ZeRO-1 and a supervised
    restart from a sharded checkpoint (module docstring, 19).  Returns the
    launches by kernel and the times at a rank's shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import run_ranks
    print("[19 mp predicted] written before the first run on the card "
          "(PERF.md): " + "; ".join(f"{k} {v}"
                                          for k, v in MP_PREDICTED.items()))
    cfg = _mp_config()
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=TRAIN_SEQ,
                                       global_batch=1)).batch_at(0)
    t0 = time.perf_counter()
    want = _mp_single(seed, torch.from_numpy(batch["tokens"]),
                      torch.from_numpy(batch["labels"]))
    single_s = time.perf_counter() - t0
    ckpt = REPO / "build" / "mp_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0, t_a = time.perf_counter(), time.time()
    ranks = run_ranks(_mp_rank_a, 2, ({"seed": seed, "ckpt": str(ckpt)},),
                      timeout_s=900)
    ranks_s = time.perf_counter() - t0
    a0, a1 = ranks
    require([s["loss"] for s in a0["steps"]] ==
            [s["loss"] for s in a1["steps"]],
            f"mp danube: the ranks' losses differ: "
            f"{[s['loss'] for s in a0['steps']]} vs "
            f"{[s['loss'] for s in a1['steps']]}")
    loss0 = a0["steps"][0]["loss"]
    loss_rel = abs(loss0 - want["loss"]) / abs(want["loss"])
    require(np.isfinite([s["loss"] for s in a0["steps"]]).all() and
            loss_rel <= MP_LOSS_REL,
            f"mp danube: step 0's loss {loss0!r} vs the single device's "
            f"{want['loss']!r}: relative {loss_rel:.3g} > {MP_LOSS_REL}")
    rel = {}
    for k in MP_GRAD_LEAVES:
        got = _mp_joined(ranks, "grads", k)
        rel[k] = _rel_l2(got, want["grads"][k])
    worst = max(rel, key=rel.get)
    require(rel[worst] <= TRAIN_GRAD_REL_L2,
            f"mp danube: the gradient of {worst} (ranks joined) is "
            f"{rel[worst]:.3g} relative L2 from the single device's "
            f"(limit {TRAIN_GRAD_REL_L2})")
    n_steps = MP_STEPS
    launches = collections.Counter()
    for rank, r in enumerate(ranks):
        c = r["counts"]
        per = cfg.num_layers * n_steps
        require(c["flash"] == per and c["flash_bwd"] == per and
                c["bwd_variants"] == {"wgmma": per, "simt": 0},
                f"mp danube rank {rank}: flash {c['flash']}, its backward "
                f"{c['flash_bwd']} by variant {c['bwd_variants']}; expected "
                f"{per}, all wgmma")
        require(c["gather"] == n_steps and c["gather_bwd"] == n_steps and
                c["transpose"] == n_steps and
                c["sls_variants"] == {"rows": 0, "sparse": n_steps},
                f"mp danube rank {rank}: the masked lookup's gather "
                f"{c['gather']}, its backward {c['gather_bwd']} "
                f"({c['transpose']} transpositions, sums by variant "
                f"{c['sls_variants']}); expected {n_steps} each, sparse")
        launches.update({k: c[k] for k in ("flash", "gather", "flash_bwd",
                                            "transpose")})
        launches["sparse"] += c["sls_variants"]["sparse"]
        launches.update({f"instance {k}": v
                         for k, v in c["instances"].items()})
        launches.update({f"bwd instance {k}": v
                         for k, v in c["bwd_instances"].items()})
        steps = r["steps"]
        mean_ms = float(np.mean([s["ms"] for s in steps[1:]]))
        cl = steps[-1]["coll"]
        step_txt = ", ".join(f"{s['ms']:.1f}" for s in steps)
        print(f"[19 mp danube rank {rank}] h2o-danube-1.8b at full width "
              f"and {MP_DEPTH} of its 24 layers, this rank's half "
              f"({r['held_bytes'] / 1e9:.3f} GB "
              f"of weights held, init {r['init_s']:.1f} s); {n_steps} steps "
              f"of 1 x {TRAIN_SEQ}: losses "
              f"{[s['loss'] for s in steps]}, step ms (host clock, "
              f"synchronised) {step_txt}"
              f" (step {n_steps - 1}: {cl['collectives']} collectives, "
              f"{cl['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{cl['collective_ms']:.1f} ms in them, "
              f"{100 * cl['collective_ms'] / steps[-1]['ms']:.1f} %); "
              f"{TRAIN_SEQ / mean_ms * 1e3:.0f} tokens/s; peak "
              f"{r['peak'] / 2**30:.2f} GiB; launches flash {c['flash']} "
              f"{c['instances']}, backward {c['flash_bwd']} "
              f"{c['bwd_variants']}, gather {c['gather']}, its backward "
              f"{c['gather_bwd']} (sums {c['sls_variants']}); {card}")
    print(f"[19 mp danube vs single] step 0's loss {loss0!r} on both ranks "
          f"(bit-equal) vs the single device's {want['loss']!r}: relative "
          f"{loss_rel:.3g} (limit {MP_LOSS_REL}); gradients, the ranks' "
          f"slices joined, relative L2: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) +
          f" (limit {TRAIN_GRAD_REL_L2}); single device {single_s:.1f} s, "
          f"ranks {ranks_s:.1f} s (rank 0 from the spawn: "
          f"{_marks(a0['marks'], t_a)}); {card}")
    kr = a0["kernels"]
    sdpa = kr["flash_bwd_sdpa"]
    sdpa_txt = ", ".join(f"{n} {v:.4f} ms" if isinstance(v, float)
                         else f"{n} {v}" for n, v in sdpa.items()
                         if not n.endswith("_reps"))
    (b_, s_, h_, d_), kshape = kr["flash_shape"]
    print(f"[19 mp flash backward] a rank's layer (B={b_}, S={s_}, H={h_}, "
          f"Hkv={kshape[2]}, D={d_}, window {cfg.sliding_window}, bf16, "
          f"random): wgmma kernels {kr['flash_bwd_ms']:.4f} ms vs the plain "
          f"version {_bf16_summary(kr['flash_bwd_agreement'])}, plain "
          f"{kr['flash_bwd_plain_ms']:.4f} ms, SDPA's backward {sdpa_txt}; "
          f"bound {kr['flash_bwd_bound_ms']:.4f} ms "
          f"({kr['flash_bwd_flops'] / 1e9:.1f} GFLOP, by "
          f"{kr['flash_bwd_bound_by']}; "
          f"{100 * kr['flash_bwd_bound_ms'] / kr['flash_bwd_ms']:.2f}% of "
          f"it); {card}")
    print(f"[19 mp gather backward] the masked lookup's backward on rank "
          f"0's rows: {_parts_line(kr['gather_backward'])}; the masked "
          f"gather == the plain gather; {card}")
    # (b)
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    t_sup = time.time()
    sup = run_ranks(_mp_rank_b, 4, ({"seed": seed, "ckpt": str(ckpt)},),
                    timeout_s=900)
    sup_s = time.perf_counter() - t0
    checked = _mp_supervised_checks(sup)
    shutil.rmtree(ckpt, ignore_errors=True)
    for r in sup:
        c = r["counts"]
        require(c["flash"] > 0 and c["flash_bwd"] > 0 and c["gather"] > 0 and
                c["gather_bwd"] > 0 and c["bwd_variants"]["simt"] == 0,
                f"mp supervised: a kernel of the path never launched: {c}")
        launches.update({k: c[k] for k in ("flash", "gather", "flash_bwd",
                                            "transpose")})
        launches["sparse"] += c["sls_variants"]["sparse"]
        launches.update({f"instance {k}": v
                         for k, v in c["instances"].items()})
        launches.update({f"bwd instance {k}": v
                         for k, v in c["bwd_instances"].items()})
    b0 = sup[0]
    print(f"[19 mp supervised] h2o-danube-1.8b's widths at {MP_LAYERS} "
          f"layers over 4 ranks (mesh (2, 2), ZeRO-1 moments of "
          f"{len(b0['zero1'])} leaves), global batch {MP_BATCH} x {MP_SEQ}: "
          f"attempts {[[(s, round(l, 5)) for s, l in a] for a in b0['attempts']]}"
          f"; the restart's step-{MP_SUP_EVERY} loss "
          f"{checked['restart_loss']!r} == the first attempt's, bit for "
          f"bit, on all 4 ranks; the 4-rank checkpoint restored onto one "
          f"device == every rank's slices ({checked['leaves']} blocks, by "
          f"digest), and with shardings= onto each rank of a (1, 2) mesh "
          f"== its slice; "
          f"{b0['coll']['collectives']} collectives, "
          f"{b0['coll']['staged_bytes'] / 1e6:.1f} MB staged on the model "
          f"axis in the run; peak {max(r['peak'] for r in sup) / 2**30:.2f}"
          f" GiB a rank; ranks {sup_s:.1f} s (rank 0 from the spawn: "
          f"{_marks(b0['marks'], t_sup)}); {card}")
    inst = {k[9:]: v for k, v in launches.items()
            if k.startswith("instance ")}
    bwd_inst = {k[13:]: v for k, v in launches.items()
                if k.startswith("bwd instance ")}
    print(f"[19 mp launches] the ranks' main paths: flash_attention "
          f"{launches['flash']} ({inst}), flash_attention_bwd "
          f"{launches['flash_bwd']} ({bwd_inst}), block gather "
          f"{launches['gather']}, gather_transpose {launches['transpose']}, "
          f"sls_sparse {launches['sparse']}; {card}")
    return {"flash_launches": launches["flash"], "flash_instances": inst,
            "flash_bwd_launches": launches["flash_bwd"],
            "flash_bwd_instances": bwd_inst,
            "gather_launches": launches["gather"],
            "transpose_launches": launches["transpose"],
            "sparse_launches": launches["sparse"],
            "rank_flash_bwd_ms": kr["flash_bwd_ms"],
            "rank_flash_bwd_bound_ms": kr["flash_bwd_bound_ms"],
            "rank_flash_bwd_plain_ms": kr["flash_bwd_plain_ms"],
            "rank_flash_bwd_sdpa_band_ms": sdpa.get("band_mask"),
            "rank_flash_bwd_max_abs_err": kr["flash_bwd_max_abs_err"],
            "rank_gather_backward": kr["gather_backward"],
            "step_ms": [s["ms"] for s in a0["steps"]],
            "loss_rel": loss_rel, "grad_worst_rel_l2": rel[worst]}


def _free_after_mp(before: int) -> None:
    """Require phase 19 to leave the card as it found it (< 1 GiB more
    allocated in this process than ``before``)."""
    import torch
    free_cuda()
    held = torch.cuda.memory_allocated()
    print(f"[19 mp after] this process holds {held / 2**30:.2f} GiB "
          f"({before / 2**30:.2f} before the phase)")
    require(held - before < 1 << 30, f"phase 19 left "
            f"{(held - before) / 2**30:.2f} GiB allocated")


# ---------------------------------------------------------------------------
# Phase 20: the disaggregated embedding tier and serving artifacts
# ---------------------------------------------------------------------------

def _disagg_server_drive(model, prompts, new_tokens: int, kill=None,
                         **server_kw) -> dict:
    """Serve ``prompts`` through a fresh graph server of phase 8's settings
    (``server_kw``: the tier's or the artifact's knobs), one serving
    iteration at a time, recording every wave's decode-embed token stream
    and its handle.  ``kill = (iteration, fn)`` calls ``fn`` after that
    serving iteration (a replica killed mid-drive).  Returns the server,
    the requests, the boot seconds (the server's construction), the
    drive's wall seconds and per-iteration seconds, and the waves'
    ``(tokens, outputs)`` resolved after the drive."""
    import torch
    from repro_torch.runtime.server import DecodeServer, Request, WaveGraph
    t0 = time.perf_counter()
    srv = DecodeServer(model, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       prefill_chunk=SERVE_CHUNK, pipeline=True, **server_kw)
    t_boot = time.perf_counter()
    require(isinstance(srv._wave, WaveGraph),
            "a server on the card must run its captured wave")
    grp = srv.pipeline_group
    name = grp.names[0]
    recorded = []
    submit_wave = grp.submit_wave

    def spy(wave):
        hs = submit_wave(wave)
        recorded.append((wave[name]["tok_embed"]["idxs"].copy(), hs[name]))
        return hs
    grp.submit_wave = spy
    reqs = [Request(prompt=p.copy(), max_new_tokens=new_tokens)
            for p in prompts]
    for r in reqs:
        srv.submit(r)
    iters = []
    while srv.queue or any(r is not None for r in srv.active):
        t1 = time.perf_counter()
        srv.step()
        iters.append(time.perf_counter() - t1)
        if kill is not None and len(iters) == kill[0]:
            kill[1]()
    srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_boot
    waves = [(toks, h.result()) for toks, h in recorded]
    grp.submit_wave = submit_wave
    return {"srv": srv, "reqs": reqs, "name": name, "waves": waves,
            "boot_s": t_boot - t0, "wall": wall, "iters": iters,
            "ttft_boot_s": min(r.t_first for r in reqs) - t0}


def _disagg_metrics(run: dict, new_tokens: int) -> dict:
    reqs = run["reqs"]
    per_token = [b - a for r in reqs
                 for a, b in zip(r.token_times, r.token_times[1:])]
    return {"tokens_per_s": len(reqs) * new_tokens / run["wall"],
            "per_token": _percentiles(per_token),
            "ttft": _percentiles([r.t_first - r.t_submit for r in reqs])}


def _same_drive(run: dict, want: dict, what: str) -> None:
    """Every request ok with ``want``'s tokens, and every wave's
    decode-embed outputs ``want``'s bits."""
    for i, (r, w) in enumerate(zip(run["reqs"], want["reqs"])):
        require(r.status == "ok" and r.out == w.out,
                f"{what}: request {i} ended {r.status} with {r.out[:6]}... "
                f"vs {w.out[:6]}...")
    require(len(run["waves"]) == len(want["waves"]),
            f"{what}: {len(run['waves'])} waves vs {len(want['waves'])}")
    for k, ((toks, got), (wtoks, exp)) in enumerate(zip(run["waves"],
                                                        want["waves"])):
        require(np.array_equal(toks, wtoks), f"{what}: wave {k}'s tokens")
        for n in exp:
            require(got[n].dtype == exp[n].dtype and
                    got[n].device == exp[n].device and
                    bool((got[n] == exp[n]).all()),
                    f"{what}: wave {k}'s {n} differs from the in-process "
                    f"group's")


def _pings(pool) -> list:
    return [r.hb.call("ping")[0] for r in pool.replicas]


def _replica_gathers(pings: list) -> dict:
    """The replicas' block-gather launches by variant, summed."""
    total = collections.Counter()
    for p in pings:
        total.update(p["variant_launches"]["block_gather"])
    return dict(total)


def phase_disagg(seed: int, card: str) -> dict:
    """Phase 20 (``--disagg-only``): chatglm3-6b at full width and depth
    served through the disaggregated tier and booted from an artifact; the
    card freed after it."""
    t0 = time.perf_counter()
    result = _disagg_body(seed, card)
    free_cuda()
    print(f"[20 disagg time] phase {time.perf_counter() - t0:.1f} s")
    return result


def _disagg_body(seed: int, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import artifact as art
    from repro_torch.core.executor import clear_executor_cache, executor_for
    from repro_torch.core.pipeline import clear_compile_cache
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import LM
    from repro_torch.runtime.embedding_service import ServicePool
    from repro_torch.runtime.faults import ServiceUnavailable
    from repro_torch.runtime.rpc import frame_bytes
    print("[20 disagg predicted] (written before the first run on the card) "
          + "; ".join(f"{k}: {v}" for k, v in DISAGG_PREDICTED.items()))
    cfg = get_config("chatglm3-6b")
    model = LM(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lo, hi + 1, DISAGG_REQUESTS)]
    table_mb = model.embed.numel() * model.embed.element_size() / 1e6
    marks = {}
    t0 = time.perf_counter()
    pool = ServicePool(2, device="cuda", rpc_timeout_s=DISAGG_RPC_TIMEOUT_S,
                       backoff_s=0.05)
    marks["pool"] = time.perf_counter() - t0
    try:
        svc = {"service": "disagg", "service_pool": pool}
        # the warm-up (cuBLAS, the allocator, the kernels: the LM's waves
        # run in this process either way) is a disagg drive, whose first
        # wave binds (the table shipped to both replicas, the warm artifact
        # written)
        t0 = time.perf_counter()
        _disagg_server_drive(model, [p[:8] for p in prompts[:2]], 2, **svc)
        marks["bind drive"] = time.perf_counter() - t0
        name = f"{cfg.name}-decode-embed"
        ex = executor_for(model.decode_embed_program(SERVE_SLOTS),
                          device=model.device, backend="cuda",
                          index_policy="strict", **svc)
        require(ex.stats["table_stacks"] == 1 and ex.service == "disagg",
                f"the server's decode-embed member did not bind once: "
                f"{ex.stats}")

        # (a) in-process and (b) disaggregated, interleaved: a, b, a, b
        runs = {"a": [], "b": []}
        before = _replica_gathers(_pings(pool))
        kops.reset_launch_counts()
        for _ in range(DISAGG_ROUNDS):
            runs["a"].append(_disagg_server_drive(model, prompts,
                                                  DISAGG_NEW_TOKENS))
            runs["b"].append(_disagg_server_drive(model, prompts,
                                                  DISAGG_NEW_TOKENS, **svc))
        inproc = kops.variant_launch_counts()["block_gather"]
        pings = _pings(pool)
        after = _replica_gathers(pings)
        launches = {v: after.get(v, 0) - before.get(v, 0)
                    for v in ("bulk", "group", "rows")}
        a0 = runs["a"][0]
        waves = sum(len(r["waves"]) for r in runs["b"])
        for k, run in enumerate(runs["a"][1:] + runs["b"]):
            _same_drive(run, a0, f"drive {k + 1}")
        for toks, got in a0["waves"]:
            want = model.embed[torch.from_numpy(toks).long().to(
                model.device)]
            for n in got:
                require(bool((got[n][:, 0] == want).all()),
                        f"decode-embed {n} != embed[tokens]")
        require(launches == {"bulk": waves, "group": waves, "rows": 0},
                f"the replicas launched {launches} gathers for {waves} "
                f"disagg waves")
        require(inproc["bulk"] == sum(len(r["waves"]) for r in runs["a"]),
                f"the in-process drives launched {inproc}")
        require(ex.stats["rpc_steps"] > 0 and ex.stats["stale_steps"] == 0
                and ex.stats["degraded_failed_steps"] == 0,
                f"disagg executor stats {ex.stats}")
        for i, p in enumerate(pings):
            require(p["device"] == torch.cuda.get_device_name(0),
                    f"replica {i} runs on {p['device']}")
            require(p["variant_launches"]["block_gather"]["bulk"] > 0,
                    f"replica {i} launched no bulk gather")
            require(p["foreign_modules"] == [],
                    f"replica {i} imported {p['foreign_modules']}")
        toks, outs = runs["b"][0]["waves"][-1]
        streams = {"tok_embed/idxs": toks, "label_gather/idxs": toks}
        req_bytes = frame_bytes("step", {"client": "x", "seq": 1}, streams)
        reply_bytes = frame_bytes(
            "ok", {"ok": True, "seq": 1, "steps": 1},
            {n: t.cpu() for n, t in outs.items()})
        ma = [_disagg_metrics(r, DISAGG_NEW_TOKENS) for r in runs["a"]]
        mb = [_disagg_metrics(r, DISAGG_NEW_TOKENS) for r in runs["b"]]
        print(f"[20 disagg serving] {cfg.name} {cfg.num_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.padded_vocab}, bf16 "
              f"(random, seed {seed}); DecodeServer(batch_slots="
              f"{SERVE_SLOTS}, max_len={SERVE_MAX_LEN}, prefill_chunk="
              f"{SERVE_CHUNK}, pipeline=True), {DISAGG_REQUESTS} requests "
              f"(prompts {lo}-{hi}), {DISAGG_NEW_TOKENS} new tokens each, "
              f"all ok, the same tokens in every drive; interleaved "
              + "; ".join(f"({k}{i}) {m['tokens_per_s']:.1f} tokens/s, per "
                          f"token {m['per_token']}, TTFT {m['ttft']}"
                          for k, ms in (("a", ma), ("b", mb))
                          for i, m in enumerate(ms))
              + f"; (b) = ServicePool(2, device='cuda'): rpc_steps "
              f"{ex.stats['rpc_steps']}, stale_steps 0; wire bytes a wave: "
              f"request {req_bytes}, reply {reply_bytes}; {card}")
        print(f"[20 disagg replicas] the embed table {table_mb:.1f} MB "
              f"shipped once at bind to each replica and written once into "
              f"the warm artifact; pool of 2 up in {marks['pool']:.1f} s, "
              f"the binding drive {marks['bind drive']:.1f} s; the replicas' "
              f"gathers in the {DISAGG_ROUNDS} disagg drives: bulk "
              f"{launches['bulk']}, grouping pass {launches['group']} = one "
              f"a wave, outputs == the in-process group's == embed[tokens] "
              f"bit for bit; each replica: "
              + "; ".join(f"{p['device']}, {p['steps']} steps, gathers "
                          f"{p['variant_launches']['block_gather']}, peak "
                          f"{p['peak_bytes'] / 2**20:.1f} MiB, foreign "
                          f"modules {p['foreign_modules']}" for p in pings)
              + f"; {card}")

        # a replica killed mid-drive: no request fails, the respawn
        # re-warms its tables and its compile from the artifacts
        respawns = pool.stats()["respawns"]
        kill = _disagg_server_drive(
            model, prompts, DISAGG_NEW_TOKENS,
            kill=(DISAGG_KILL_AT, lambda: pool.kill_replica(0)), **svc)
        _same_drive(kill, a0, "the drive with a replica killed")
        faults = kill["srv"].serve_stats["wave_faults"]
        require(faults == 0, f"the failover surfaced in {faults} wave "
                f"fault(s): it must be transparent")
        t0 = time.perf_counter()
        while pool.replicas[0].state != "live":
            pool.heartbeat_once()
            time.sleep(0.05)
            require(time.perf_counter() - t0 < DISAGG_REVIVE_S,
                    f"replica 0 not back within {DISAGG_REVIVE_S} s")
        s = pool.stats()
        # a step pending on the victim fails over; a send to it retries
        require(s["respawns"] > respawns and
                s["failovers"] + s["retries"] > 0,
                f"the kill did not reroute and respawn: {s}")
        require(s["warm_sources"][-1] == "artifact" and
                s["compile_sources"][-1] == "artifact",
                f"the respawned replica re-warmed from "
                f"{s['warm_sources'][-1]}, compiled from "
                f"{s['compile_sources'][-1]}")
        revived = pool.replicas[0].hb.call("ping")[0]
        after_kill = _disagg_server_drive(model, prompts, DISAGG_NEW_TOKENS,
                                          **svc)
        _same_drive(after_kill, a0, "the drive after the revival")
        print(f"[20 disagg failover] replica 0 killed after serving "
              f"iteration {DISAGG_KILL_AT}: every request ok with the "
              f"in-process tokens and decode-embed bits, no wave fault "
              f"({s['failovers']} failovers, {s['retries']} retries); "
              f"respawned (pid {revived['pid']}) "
              f"warm_source {s['warm_sources'][-1]}, compile_source "
              f"{s['compile_sources'][-1]}, recovery "
              f"{s['recoveries_s'][-1]:.2f} s (dark to probed live); a drive "
              f"after it the same bits; {card}")

        # every replica dark: "fail" raises typed, "stale" serves locally
        stale = executor_for(model.decode_embed_program(SERVE_SLOTS),
                             device=model.device, backend="cuda",
                             index_policy="strict",
                             degrade_policy="stale", **svc)
        toks = np.asarray([r.out[-1] for r in a0["reqs"]], np.int32)
        wave = {"tok_embed": {"table": model.embed, "idxs": toks},
                "label_gather": {"table": model.embed, "idxs": toks}}
        want = model.embed[torch.from_numpy(toks).long().to(model.device)]
        t0 = time.perf_counter()
        got = stale.step(wave)             # binds: the table shipped again
        bind_s = time.perf_counter() - t0
        require(all(bool((got[n][:, 0] == want).all()) for n in got),
                "stale executor (live pool) != embed[tokens]")
        pool.auto_respawn = False
        for i in range(2):
            pool.kill_replica(i)
            pool.replicas[i].proc.wait(timeout=30)
        try:
            ex.step(wave)
            raise CheckFailed("a dark pool under degrade_policy='fail' "
                              "served a step")
        except ServiceUnavailable as e:
            failed = f"{type(e).__name__}: {str(e)[:160]}"
        require(ex.stats["degraded_failed_steps"] == 1,
                f"fail executor {ex.stats}")
        got = stale.step(wave)
        require(all(bool((got[n][:, 0] == want).all()) for n in got)
                and stale.stats["stale_steps"] == 1,
                f"stale executor on a dark pool: {stale.stats}")
        print(f"[20 disagg dark] both replicas killed, no respawn: "
              f"degrade_policy='fail' raised {failed}; 'stale' served the "
              f"wave on this process's card (the local table, the bulk "
              f"gather), == embed[tokens] bit for bit, stale_steps 1 (its "
              f"binding step, the table shipped to both replicas and the "
              f"warm artifact rewritten, {bind_s:.2f} s); {card}")
    finally:
        pool.close()

    # two boots from one artifact directory: fresh, then loaded
    adir = REPO / "build" / "disagg_artifact"
    shutil.rmtree(adir, ignore_errors=True)
    boots = []
    art.reset_artifact_stats()
    for _ in range(2):
        clear_executor_cache()
        clear_compile_cache()
        run = _disagg_server_drive(model, prompts, DISAGG_NEW_TOKENS,
                                   artifact_dir=str(adir))
        _same_drive(run, a0, "the artifact boot")
        boots.append(run)
    sources = [b["srv"].compile_stats["artifact"]["compile_source"]
               for b in boots]
    require(sources == ["fresh", "artifact"],
            f"artifact boots compiled from {sources}")
    stats = art.artifact_stats()
    require(stats["rejects"] == {}, f"artifact rejects {stats['rejects']}")
    print(f"[20 disagg artifact] two server boots with artifact_dir=: "
          f"compile_source {sources[0]} then {sources[1]} (loads "
          f"{stats['loads']}, saves {stats['saves']}, rejects none), the "
          f"same tokens and decode-embed bits as the in-process drive; "
          f"boot (the server built, its 3 graphs captured) "
          f"{boots[0]['boot_s']:.3f} / {boots[1]['boot_s']:.3f} s, time to "
          f"first token from the boot {boots[0]['ttft_boot_s']:.3f} / "
          f"{boots[1]['ttft_boot_s']:.3f} s; {card}")
    shutil.rmtree(adir, ignore_errors=True)
    return {"disagg_launches": launches["bulk"],
            "disagg_group_launches": launches["group"],
            "disagg_waves": waves,
            "disagg_replica_peak_mib": [round(p["peak_bytes"] / 2**20, 1)
                                        for p in pings],
            "disagg_wire_bytes": {"request": req_bytes,
                                  "reply": reply_bytes},
            "disagg_tokens_per_s": {"a": [round(m["tokens_per_s"], 1)
                                          for m in ma],
                                    "b": [round(m["tokens_per_s"], 1)
                                          for m in mb]}}


# ---------------------------------------------------------------------------
# Phase 21: the dry run and the roofline
# ---------------------------------------------------------------------------

def _card_mm_flops(fn, *args) -> tuple:
    """``fn(*args)`` on the card under the dry run's FLOP counter
    (``roofline.analysis.flop_counter``): its result and its FLOPs by
    aten op."""
    import torch
    from repro_torch.roofline import analysis
    with analysis.flop_counter() as fc:
        out = fn(*args)
    torch.cuda.synchronize()
    by_op = {str(k): int(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return out, by_op


def _fill_batch(batch: dict, host: dict) -> None:
    """Write the host arrays into a bundle's batch tensors on the card."""
    import torch
    for k, t in batch.items():
        t.copy_(torch.from_numpy(host[k]))


def _roofline_dry_vs_card(cfg, seed: int) -> dict:
    """(a): the prefill and one training step (remat "dots") of ``cfg`` on
    a 1 x 1 mesh, counted on meta by the dry run and on the card under the
    same FLOP counter: their ``mm``-family FLOPs must be equal; the cost
    pass's attention FLOPs (dense attention's products) must equal
    ``analytic_flops``'s attention term."""
    import torch
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import count_bundle
    from repro_torch.roofline import analysis
    one = DryMesh({"data": 1, "model": 1})
    seq = ROOFLINE_A_SEQ
    rng = np.random.default_rng(seed + 21)
    host = {k: rng.integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)
            for k in ("tokens", "labels")}
    out = {}
    for kind in ("prefill", "train"):
        def build(device="meta", remat="dots", cost_mode=False):
            if kind == "prefill":
                return steps.build_prefill_bundle(cfg, one, seq, 1,
                                                  cost_mode=cost_mode,
                                                  device=device)
            return steps.build_train_bundle(cfg, one, seq, 1, remat=remat,
                                            cost_mode=cost_mode,
                                            device=device)
        t0 = time.perf_counter()
        dry = count_bundle(build(), one)
        plain = count_bundle(build(remat="none"), one)
        cost = count_bundle(build(remat="none", cost_mode=True), one)
        dry_s = time.perf_counter() - t0
        card = build(device="cuda")
        _fill_batch(card.args[-1], host)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0 - dry_s
        res, by_op = _card_mm_flops(card.fn, *card.args)
        card_s = time.perf_counter() - t0 - dry_s - build_s
        require(bool(torch.isfinite(res.float()).all()),
                f"(a) {kind}: the card's result is not finite")
        card_mm = sum(n for op, n in by_op.items() if op in analysis.MM_OPS)
        require(card_mm == dry["mm_flops"],
                f"(a) {kind}: the dry run counted {dry['mm_flops']:.6g} mm "
                f"FLOPs, the card {card_mm:.6g} ({by_op})")
        attn = cost["mm_flops"] - plain["mm_flops"]
        want = analysis.analytic_flops(cfg, seq, 1, kind) - \
            analysis.model_flops(cfg, seq, 1, kind)
        require(attn == want,
                f"(a) {kind}: the cost pass's attention FLOPs {attn:.6g} != "
                f"analytic_flops's attention term {want:.6g}")
        out[kind] = {"mm_flops": card_mm, "card_by_op": by_op,
                     "dry_by_op": dry["flops_by_op"], "attention": attn,
                     "dry_s": dry_s, "build_s": build_s, "card_s": card_s}
        del card, res
        free_cuda()
    return out


def _roofline_remat(cfg, seed: int) -> dict:
    """(b): one training step of ``cfg`` (1 x TRAIN_SEQ) under each remat
    policy on the card: the loss and every gradient bit-equal to "none"'s,
    the step's time (host clock, synchronised, after a warm-up pass) and
    its peak (``max_memory_allocated`` above what the card held before the
    bundle was built) beside the dry run's predicted peak of the same step
    (argument + peak temporary bytes)."""
    import torch
    from repro_torch.core.shard_plan import DryMesh
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import count_bundle
    from repro_torch.models.lm import REMATS
    one = DryMesh({"data": 1, "model": 1})
    rng = np.random.default_rng(seed + 22)
    host = {k: rng.integers(0, cfg.vocab_size, (1, TRAIN_SEQ))
            .astype(np.int32) for k in ("tokens", "labels")}
    runs, ref, t_marks = {}, None, [time.perf_counter()]
    for remat in REMATS:
        mem = count_bundle(steps.build_train_bundle(
            cfg, one, TRAIN_SEQ, 1, remat=remat), one)["memory"]
        t_marks.append(time.perf_counter())
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        free_cuda()
        base = torch.cuda.memory_allocated()
        b = steps.build_train_bundle(cfg, one, TRAIN_SEQ, 1, remat=remat,
                                     device="cuda")
        step, (state, batch) = b.fn, b.args
        _fill_batch(batch, host)
        loss, grads = step.loss_and_grads(state["params"], batch)
        # held on the host: the next policy's peak is measured without them
        grads = {k: g.cpu() for k, g in grads.items()}
        if ref is None:
            ref = (loss.cpu(), grads)
        else:
            require(torch.equal(loss.cpu(), ref[0]),
                    f"(b) remat {remat!r}: loss {float(loss)!r} != none's "
                    f"{float(ref[0])!r}")
            bad = [k for k, g in grads.items() if not torch.equal(g, ref[1][k])]
            require(not bad, f"(b) remat {remat!r}: gradients differ from "
                             f"none's at {bad[:4]}")
        del grads
        t_marks.append(time.perf_counter())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        require(bool(torch.isfinite(loss)), f"(b) remat {remat!r}: loss")
        runs[remat] = {"step_ms": ms, "peak_bytes": peak,
                       "predicted_bytes": predicted,
                       "predicted_over_measured": predicted / peak}
        del b, step, state, batch, loss
        free_cuda()
        t_marks.append(time.perf_counter())
    del ref
    runs["marks_s"] = [round(b - a, 2) for a, b in zip(t_marks, t_marks[1:])]
    for remat in ("dots", "full"):
        require(runs[remat]["peak_bytes"] < runs["none"]["peak_bytes"],
                f"(b) remat {remat!r} peaked at {runs[remat]['peak_bytes']} "
                f"bytes, not below none's {runs['none']['peak_bytes']}")
    return runs


def _roofline_shares(measured: dict) -> list:
    """(c): each ROOFLINE_CELLS cell's roofline bound on one card (the
    analytic FLOPs and bytes, ``roofline_terms``) and the time it is held
    to: the recorded one (PERF.md) or this run's (``measured``, by key)."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis
    rows = []
    for arch, b, s, kind, layers, key, recorded in ROOFLINE_CELLS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        flops = analysis.analytic_flops(cfg, s, b, kind)
        r = analysis.roofline_terms(
            flops=flops, bytes_accessed=analysis.analytic_bytes_per_device(
                cfg, s, b, kind, n_data=1, n_model=1),
            collective_bytes=0.0, n_chips=1)
        rows.append({"cell": f"{arch} {cfg.num_layers} layers {b} x {s} "
                             f"{kind}", "key": key,
                     "model_flops": analysis.model_flops(cfg, s, b, kind),
                     "analytic_flops": flops,
                     "bound_ms": r["step_lower_bound_s"] * 1e3,
                     "bound_by": r["bottleneck"], "recorded_ms": recorded,
                     "measured_ms": (measured or {}).get(key)})
    return rows


def phase_roofline(seed: int, card: str, measured: dict = None) -> dict:
    """Phase 21: the dry run is the program on the card, remat keeps its
    bits and lowers its peak, and the measured steps' shares of their
    roofline bound (module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    for what, value in ROOFLINE_PREDICTED.items():
        print(f"[21 roofline predicted] {what}: {value}")
    shares = _roofline_shares(measured)
    for row in shares:
        if row["recorded_ms"] is not None:
            print(f"[21 roofline predicted] {row['cell']}: bound "
                  f"{row['bound_ms']:.2f} ms ({row['bound_by']}; "
                  f"analytic_flops {row['analytic_flops']:.4g}, model_flops "
                  f"{row['model_flops']:.4g}) against the recorded "
                  f"{row['recorded_ms']} ms: {row['recorded_ms'] / row['bound_ms']:.3f}"
                  f" x the bound, {100 * row['bound_ms'] / row['recorded_ms']:.1f}"
                  f" % of it (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W)")
    free_cuda()
    kops.reset_launch_counts()
    a_cfg = dataclasses.replace(get_config("chatglm3-6b"),
                                num_layers=ROOFLINE_A_LAYERS)
    a = _roofline_dry_vs_card(a_cfg, seed)
    b_cfg = dataclasses.replace(get_config("h2o-danube-1.8b"),
                                num_layers=ROOFLINE_B_LAYERS)
    b = _roofline_remat(b_cfg, seed)
    counts = _mp_counts(kops)
    for k in ("flash", "flash_bwd", "transpose", "gather_bwd"):
        require(counts[k] > 0, f"phase 21's main path launched no {k}")
    for kind, r in a.items():
        print(f"[21 roofline (a) {kind}] chatglm3-6b {ROOFLINE_A_LAYERS} of "
              f"28 layers, full width, 1 x {ROOFLINE_A_SEQ}: mm FLOPs dry "
              f"(meta, 1 x 1 mesh) == card {r['mm_flops']:.6g} (card by op "
              f"{r['card_by_op']}, dry {r['dry_by_op']}); attention (the cost "
              f"pass's dense products) {r['attention']:.6g} == analytic_flops"
              f"'s term; the three dry counts took {r['dry_s']:.2f} s, the "
              f"card's model {r['build_s']:.2f} s, its counted run "
              f"{r['card_s']:.2f} s; {card}")
    print(f"[21 roofline (b) time] seconds by part (dry count, card "
          f"build + bits, card step + free, by policy): {b.pop('marks_s')}")
    for remat, r in b.items():
        band = ROOFLINE_PEAK_BAND[0] <= r["predicted_over_measured"] <= \
            ROOFLINE_PEAK_BAND[1]
        print(f"[21 roofline (b) remat {remat}] h2o-danube-1.8b "
              f"{ROOFLINE_B_LAYERS} of 24 layers, full width, 1 x "
              f"{TRAIN_SEQ}: step {r['step_ms']:.2f} ms (host clock, "
              f"synchronised); peak {r['peak_bytes'] / 2**30:.3f} GiB "
              f"(max_memory_allocated); the dry run's {r['predicted_bytes'] / 2**30:.3f}"
              f" GiB: predicted / measured {r['predicted_over_measured']:.4f} "
              f"({'inside' if band else 'OUTSIDE'} the stated "
              f"{ROOFLINE_PEAK_BAND}); loss and every gradient bit-equal to "
              f"none's; {card}")
    for row in shares:
        if row["key"] is None:          # a recorded time only: predicted
            continue
        ms = row["measured_ms"]
        tail = (f"measured {ms:.2f} ms in this run: {ms / row['bound_ms']:.3f}"
                f" x the bound, {100 * row['bound_ms'] / ms:.1f} % of it"
                if ms else "not measured in this run (its phase did not run)")
        print(f"[21 roofline (c)] {row['cell']}: bound {row['bound_ms']:.2f}"
              f" ms ({row['bound_by']}; analytic_flops "
              f"{row['analytic_flops']:.4g}, model_flops "
              f"{row['model_flops']:.4g}); {tail}; {card}")
    return {"flash_launches": counts["flash"],
            "flash_instances": counts["instances"],
            "flash_bwd_launches": counts["flash_bwd"],
            "flash_bwd_instances": counts["bwd_instances"],
            "bwd_variants": counts["bwd_variants"],
            "transpose_launches": counts["transpose"],
            "sparse_launches": counts["sls_variants"]["sparse"],
            "rows_sls_launches": counts["sls_variants"]["rows"],
            "a": a, "b": b, "shares": shares}


# ---------------------------------------------------------------------------
# Phase 22: the attention kinds over any model axis -- the head plan's KV
# copies and uneven head counts, MLA and the encoder-decoder over gloo ranks
# ---------------------------------------------------------------------------

def _tph_grad_file(job: dict, part: str, rank: int) -> Path:
    return Path(job["dir"]) / f"grads_{part}_{rank}.pt"


def _tph_step(st, state: dict, local: dict, stats) -> tuple:
    """One ``TrainStep`` (``loss_and_grads``, then ``AdamW.apply_`` with
    its shards) on the host clock, the card synchronised around each part:
    ``(loss, grads, {"ms", "grads_ms", "apply_ms", "coll"})``."""
    import torch
    c0 = dict(stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = st.loss_and_grads(state["params"], local)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state["opt"] = st.opt.apply_(state["params"], grads, state["opt"],
                                 st.shards)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return loss, grads, {"ms": (t2 - t0) * 1e3, "grads_ms": (t1 - t0) * 1e3,
                         "apply_ms": (t2 - t1) * 1e3,
                         "coll": _tp_collectives(stats, c0)}


def _tph_step_txt(t: dict) -> str:
    """A :func:`_tph_step` record as text."""
    c = t["coll"]
    return (f"{t['ms']:.1f} ms (host clock, synchronised: loss_and_grads "
            f"{t['grads_ms']:.1f} ms, apply_ {t['apply_ms']:.1f} ms; "
            f"{c['collectives']} collectives, {c['staged_bytes'] / 1e6:.1f} "
            f"MB staged, {c['collective_ms']:.1f} ms in them)")


def _tph_train(rank: int, lm, job: dict, part: str, batch: dict,
               whole: bool = False, warm: bool = False) -> dict:
    """One training step of ``lm`` (a rank's slices) through the trainer's
    step (``TrainStep.loss_and_grads``: KV copies summed over their
    holders; ``AdamW.apply_`` with its shards; :func:`_tph_step`),
    counted; the gradients written to the phase's directory for the
    parent's comparison, and the digests of every copied leaf's gradient
    and stepped parameter (with ``whole``, of every leaf whole on every
    rank too).  With ``warm`` a second step on the same batch is timed
    (``out["warm"]``), after everything of the first is recorded."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.trainer import TrainStep
    seq = batch["tokens"].shape[1]
    st = TrainStep(lm, batch["tokens"].shape[0], seq, lr=TRAIN_LR)
    state = st.init_state()
    local = st.local_batch(batch)
    stats = lm.collective_stats
    kops.reset_launch_counts()
    loss, grads, timed = _tph_step(st, state, local, stats)
    out = dict(timed, loss=float(loss), counts=_mp_counts(kops),
               copies={k: (_digest(grads[k]), _digest(state["params"][k]))
                       for k in st._copies},
               repeat=sorted(st.shards.repeat))
    if whole:
        out["whole"] = {k: (_digest(grads[k]), _digest(p))
                        for k, p in state["params"].items()
                        if k not in st.shards.split}
    torch.save({k: g.detach().cpu() for k, g in grads.items()},
               _tph_grad_file(job, part, rank))
    del grads
    if warm:
        out["warm"] = _tph_step(st, state, local, stats)[2]
    del st, state, local
    return out


def _tph_held_flash(lm, run) -> tuple:
    """``run()`` with the model's first flash call recorded: its q, k, v,
    keywords and output (the call goes to the kernel as usual)."""
    from repro_torch.kernels import ops as kops
    first = []

    def held(q, k, v, **kw):
        o = kops.flash_attention_cuda(q, k, v, **kw)
        if not first:
            first.append((q, k, v, kw, o))
        return o
    with _OpSwap("attention", held):
        run()
    return first[0]


def _tph_rank_a(rank: int, world: int, job: dict) -> dict:
    """Phase 22(a) on one of four ranks: chatglm3-6b at full width and
    depth (2 query heads a rank over a copy of one KV head), its first
    layer's flash on the rank's heads held to the plain version, then the
    counted main path -- the prefill, the teacher-forced micro-steps, the
    served requests -- and one training step at TPH_TRAIN_LAYERS layers;
    rank 0 then times the flash layer at the rank's shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.server import DecodeServer, Request
    marks = [("start", time.time())]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(world)
    shard = ShardCtx(mesh)
    cfg = get_config("chatglm3-6b")
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, seed=job["seed"], shard=shard)
    attn = lm.blocks[0].attn
    out = {"held_bytes": sum(p.numel() * p.element_size()
                             for p in lm.parameters()),
           "heads": (attn["wq"].shape[1] // cfg.hd,
                     attn["wk"].shape[1] // cfg.hd)}
    tokens = torch.from_numpy(job["tokens"]).cuda()
    lm.prefill(tokens[:, :TPH_WARM_TOKENS])           # warm-up
    marks.append(("built", time.time()))
    stats = lm.collective_stats
    kops.reset_launch_counts()
    c0 = dict(stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill = []
    q, k, v, kw, fo = _tph_held_flash(
        lm, lambda: prefill.append(lm.prefill(tokens)))
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    last = prefill.pop()
    out["flash"] = check_bf16(fo, plain_attention(q, k, v, **kw),
                              f"rank {rank}'s chatglm3-6b layer-0 flash on "
                              f"its heads")
    layer = (q, k, v, kw)
    out["prefill_coll"] = _tp_collectives(stats, c0)
    out["last"] = last.float().cpu().numpy()
    tf = job["tf_tokens"]
    caches = lm.init_caches(tf.shape[0], tf.shape[1] + 1)
    logits, ms, c0 = [], [], dict(stats)
    for t in range(tf.shape[1]):
        tok = torch.from_numpy(tf[:, t:t + 1]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = lm.decode_step(tok, caches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.cpu().numpy())
    out["tf_logits"], out["step_ms"] = np.stack(logits), ms
    out["step_coll"] = {k_: v_ / tf.shape[1] for k_, v_ in
                        _tp_collectives(stats, c0).items()}
    out["cache_heads"] = caches[0]["k"].shape[1]
    del caches
    srv = DecodeServer(lm, batch_slots=TPH_SLOTS, max_len=TPH_MAX_LEN,
                       pipeline=False)
    reqs = [Request(prompt=p, max_new_tokens=TPH_NEW_TOKENS)
            for p in job["prompts"]]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    out["serve_s"] = time.perf_counter() - t0
    out["served"] = [list(r.out) for r in reqs]
    out["statuses"] = [r.status for r in reqs]
    out["counts"] = _mp_counts(kops)
    out["peak_serve"] = torch.cuda.max_memory_allocated()
    del srv, reqs, lm, attn, last, fo
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("served", time.time()))
    tcfg = dataclasses.replace(cfg, num_layers=TPH_TRAIN_LAYERS)
    lm = LM(tcfg, seed=job["seed"], shard=shard)
    out["train"] = _tph_train(rank, lm, job, "a", job["train_batch"])
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    out["peak"] = torch.cuda.max_memory_allocated()
    marks.append(("trained", time.time()))
    dist.barrier()
    if rank == 0:
        q, k, v, kw = layer
        out["flash_layer"] = _flash_layer(q, k, v, kw, "a rank's chatglm3-6b "
                                          "layer (8 query heads over 1 KV)")
        out["flash_shape"] = (tuple(q.shape), tuple(k.shape))
    del layer, q, k, v
    dist.barrier()
    marks.append(("timed", time.time()))
    out["marks"] = marks
    return out


def _tph_rank_bc(rank: int, world: int, job: dict) -> dict:
    """Phase 22(b), (c) and (d) on one of two ranks: DeepSeek-V2-Lite at full
    width and TPH_DS_LAYERS layers (its first MLA layer's forward and a
    decode micro-step on the job's inputs, then phase 18's MoE drive --
    the seq-split prefill and the replicated-token micro-steps, routing
    recorded -- and a served drive), then whisper-large-v3 at full width
    and depth (the 1 x TPH_WHISPER_FRAMES forward, decode micro-steps with
    the encoder context) and one training step at
    TPH_WHISPER_TRAIN_LAYERS encoder and decoder layers, then zamba2-7b at
    full width (:func:`_tph_zamba`); rank 0 then times the MLA, the whisper
    encoder and the zamba2 shared attention flash layers at the rank's
    shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import mla_decode, mla_forward
    from repro_torch.models.lm import LM, ShardCtx
    from repro_torch.runtime.server import DecodeServer, Request
    marks = [("start", time.time())]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(world)
    shard = ShardCtx(mesh)
    counts: list = []
    # (b) DeepSeek-V2-Lite
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=TPH_DS_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, seed=job["seed"], shard=shard)
    ds = {"held_bytes": sum(p.numel() * p.element_size()
                            for p in lm.parameters()),
          "heads": lm.blocks[0].attn["w_uk"].shape[1] // cfg.hd}
    x = torch.from_numpy(job["mla_x"]).cuda().bfloat16()
    s = x.shape[1]
    pos = torch.arange(s, dtype=torch.float32, device=x.device)[None]

    def first_mla_layer():
        ds["mla_fwd"] = mla_forward(lm.blocks[0].attn, x, cfg, positions=pos,
                                    tp=lm.tp).float().cpu().numpy()
    with torch.inference_mode():
        q, k, v, kw, fo = _tph_held_flash(lm, first_mla_layer)
        cache = {n: torch.from_numpy(job[f"mla_{n}"]).cuda().bfloat16()
                 for n in ("c", "kr")}
        cache["len"] = torch.full((1,), s - 1, dtype=torch.int32,
                                  device=x.device)
        ds["mla_dec"] = mla_decode(lm.blocks[0].attn, x[:, -1:], cfg, cache,
                                   tp=lm.tp).float().cpu().numpy()
    ds["flash"] = check_bf16(fo, plain_attention(q, k, v, **kw),
                             f"rank {rank}'s MLA layer-0 flash on its heads")
    mla_layer = (q, k, v, kw)
    del fo, cache
    moe_job = {"moe_tokens": job["ds_tokens"], "moe_decode": job["ds_decode"]}
    ds.update(_tp_qwen3(rank, lm, moe_job, counts))
    kops.reset_launch_counts()
    srv = DecodeServer(lm, batch_slots=TPH_SLOTS, max_len=TPH_MAX_LEN,
                       pipeline=False)
    reqs = [Request(prompt=p, max_new_tokens=TPH_DS_NEW_TOKENS)
            for p in job["ds_prompts"]]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    ds["serve_s"] = time.perf_counter() - t0
    ds["served"] = [list(r.out) for r in reqs]
    ds["statuses"] = [r.status for r in reqs]
    ds["serve_counts"] = _mp_counts(kops)
    ds["peak"] = torch.cuda.max_memory_allocated()
    del srv, reqs
    marks.append(("deepseek served", time.time()))
    ds["train"] = _tph_ds_train(rank, lm, job)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("deepseek", time.time()))
    # (c) whisper-large-v3
    wcfg = get_config("whisper-large-v3")
    torch.cuda.reset_peak_memory_stats()
    lm = LM(wcfg, seed=job["seed"], shard=shard)
    wh = {"held_bytes": sum(p.numel() * p.element_size()
                            for p in lm.parameters()),
          "heads": lm.blocks[0].attn["wq"].shape[1] // wcfg.hd}
    toks = torch.from_numpy(job["w_tokens"]).cuda()
    frames = torch.from_numpy(job["w_frames"]).cuda().bfloat16()
    stats = lm.collective_stats
    with torch.inference_mode():
        n = TPH_WARM_TOKENS                         # warm-up
        lm.forward(toks[:, :n], enc_embeds=frames[:, :n])
        kops.reset_launch_counts()
        c0 = dict(stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd = []
        q, k, v, kw, fo = _tph_held_flash(lm, lambda: fwd.append(
            lm.forward(toks, enc_embeds=frames)))
        torch.cuda.synchronize()
        wh["forward_ms"] = (time.perf_counter() - t0) * 1e3
        h = fwd.pop()
        wh["flash"] = check_bf16(fo, plain_attention(q, k, v, **kw),
                                 f"rank {rank}'s whisper encoder layer-0 "
                                 f"flash on its heads")
        enc_layer = (q, k, v, kw)
        del fo
        wh["forward_coll"] = _tp_collectives(stats, c0)
        wh["hidden"] = h.float().cpu().numpy()
        enc_out = lm._encode(frames)
        caches = lm.init_caches(1, TPH_WHISPER_DECODE + 1)
        logits, ms = [], []
        for t in range(TPH_WHISPER_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = lm.decode_step(toks[:, t:t + 1], caches,
                                   batch_ctx={"enc_out": enc_out})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.cpu().numpy())
        wh["dec_logits"], wh["step_ms"] = np.stack(logits), ms
    wh["counts"] = _mp_counts(kops)
    del lm, h, enc_out, caches
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(wcfg, num_layers=TPH_WHISPER_TRAIN_LAYERS,
                               enc_layers=TPH_WHISPER_TRAIN_LAYERS)
    lm = LM(tcfg, seed=job["seed"], shard=shard)
    wh["train"] = _tph_train(rank, lm, job, "c", job["w_train_batch"])
    wh["peak"] = torch.cuda.max_memory_allocated()
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("whisper", time.time()))
    # (d) zamba2-7b
    zb, zamba_layer = _tph_zamba(rank, shard, job)
    marks.append(("zamba2", time.time()))
    dist.barrier()
    out = {"deepseek": ds, "whisper": wh, "zamba2": zb, "marks": marks,
           "moe_counts": counts}
    if rank == 0:
        for key, (q, k, v, kw), what in (
                ("mla_layer", mla_layer, "a rank's DeepSeek MLA layer (8 "
                 "heads, q/k 192, v 128)"),
                ("enc_layer", enc_layer, "a rank's whisper encoder layer "
                 "(10 heads, not causal)"),
                ("zamba_layer", zamba_layer, "a rank's zamba2 shared "
                 "attention layer (16 heads of 112)")):
            out[key] = _flash_layer(q, k, v, kw, what)
            out[f"{key}_shape"] = (tuple(q.shape), tuple(k.shape))
        out["mla_bwd"] = _tph_flash_bwd(*mla_layer[:3], "a rank's DeepSeek "
                                        "MLA layer's flash backward")
    del mla_layer, enc_layer, zamba_layer, q, k, v
    dist.barrier()
    out["marks"].append(("timed", time.time()))
    return out


def _tph_ds_train(rank: int, lm, job: dict) -> dict:
    """Phase 22(b)'s training step on a rank: one ``TrainStep`` of its
    DeepSeek-V2-Lite slices on the job's 1 x TPH_DS_PREFILL[1] batch
    (:func:`_tph_train`: the seq-split expert path's all-to-alls and their
    transposes, the whole leaves' gradients summed over the axis), then a
    second, warm one timed; its peak memory; every MoE layer's routing in
    the first step recorded (the rank's block of tokens) for the parent's
    pinned single process.  The first step's first masked lookup and first
    un-dispatch gather are captured (the rank's table and ids, the
    cotangent their backward got), and after the step each backward is
    held to its plain version on those inputs (``check_bf16``)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.kernels.gather import block_gather
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import MoeBlock
    route, routes = moe_mod.route, []
    lookup_rows = lm.embed.shape[0]
    seen: dict = {}

    def record(x2d, router, k):
        probs, topw, tope = route(x2d, router, k)
        routes.append(tope.detach().cpu().numpy())
        return probs, topw, tope

    def capture(table, idxs, **kw):
        got = block_gather(table, idxs, **kw)
        kind = "lookup" if table.shape[0] == lookup_rows else "undispatch"
        if kind not in seen and got.requires_grad:
            c = seen[kind] = {"n": table.shape[0], "idxs": idxs}

            def keep(g):
                c.setdefault("dout", g.detach().contiguous())
            got.register_hook(keep)
        return got
    # one routing a MoE layer a forward: the first step's
    moe_layers = sum(isinstance(blk, MoeBlock) for blk in lm.blocks)
    torch.cuda.reset_peak_memory_stats()
    moe_mod.route = record
    try:
        with _OpSwap("block_gather", capture):
            out = _tph_train(rank, lm, job, "b", job["ds_train_batch"],
                             whole=True, warm=True)
    finally:
        moe_mod.route = route
    out["peak"] = torch.cuda.max_memory_allocated()
    out["routes"] = routes[:moe_layers]
    require(set(seen) == {"lookup", "undispatch"} and
            all("dout" in c for c in seen.values()),
            f"DeepSeek rank {rank}'s training step: captured {sorted(seen)}")
    out["gather_bwd"] = {}
    for kind, c in seen.items():
        dout, idxs, n = c["dout"], c["idxs"], c["n"]
        agree = check_bf16(
            kops.block_gather_backward(dout, idxs, n),
            ref.block_gather_backward(dout, idxs, n),
            f"DeepSeek rank {rank}'s {kind} gather backward "
            f"({idxs.numel()} ids into {n} rows) vs index_add_")
        out["gather_bwd"][kind] = dict(agree, ids=idxs.numel(), rows=n,
                                       dtype=str(dout.dtype))
    return out


def _tph_flash_bwd(q, k, v, what: str) -> dict:
    """The flash backward at a rank's layer shapes (its captured q, k, v,
    a random bf16 dO): held to its variant's plain version
    (``_check_flash_backward``), and timed beside its bound, the plain
    backward and SDPA's backward (the forward not in the timed call)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import (backward_variant,
                                                     plain_backward)
    q, k, v = (t.clone() for t in (q, k, v))      # out of inference mode
    g = torch.Generator(device=q.device).manual_seed(23)
    do = torch.randn(tuple(q.shape[:3]) + (v.shape[3],), generator=g,
                     device=q.device).bfloat16()
    chk = _check_flash_backward(q, k, v, do, None, what)
    o, lse = chk["o"], chk["lse"]
    ms = time_ms(lambda: kops.flash_attention_bwd_cuda(q, k, v, o, do, lse),
                 20, warmup=2)
    plain_ms = time_ms(lambda: plain_backward(q, k, v, o, do, lse), 2,
                       warmup=1)
    # a band as wide as the sequence is the causal triangle
    sdpa = _sdpa_backward_ms(q, k, v, do, q.shape[1])
    bound_ms, bound_by, flops = _flash_bwd_bound(q, v, None)
    return {"ms": ms, "plain_ms": plain_ms, "sdpa": sdpa,
            "library_ms": sdpa["is_causal"], "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops,
            "variant": backward_variant(q.dtype, q.shape[3], v.shape[3]),
            "agreement": chk["agreement"],
            "max_abs_err": chk["max_abs_err"],
            "shape": (tuple(q.shape), tuple(v.shape))}


def _tph_single_train(cfg, seed: int, batch: dict,
                      pinned: list = None) -> dict:
    """The single device's loss and every gradient of ``LM(cfg, seed)`` on
    ``batch`` (host arrays), on the host; the model freed.  With
    ``pinned`` (two ranks' routing records, each a list of their MoE
    layers' top-k experts) each MoE layer runs as ``moe_ffn_ep_plain(n=2)``
    -- two expert-parallel ranks' seq-split function, capacity per rank --
    with the routing pinned to the ranks' (their experts, weighted by this
    run's own probabilities), and ``flips`` counts the token-layer top-k
    sets that differ unpinned."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import LM
    lm = LM(cfg, seed=seed).requires_grad_(True)
    dev = lm.device
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)
    enc = batch.get("enc_embeds")
    if enc is not None:
        enc = torch.from_numpy(enc).to(dev).to(cfg.torch_dtype)
    route, seen = moe_mod.route, []
    if pinned is not None:
        seq = [x for pair in zip(*pinned) for x in pair]

        def replay(x2d, router, k):
            probs, _, own = route(x2d, router, k)
            tope = torch.from_numpy(seq[len(seen)]).to(x2d.device)
            seen.append(own.cpu().numpy())
            topw = probs.gather(-1, tope)
            return probs, topw / topw.sum(-1, keepdim=True).clamp_min(
                1e-9), tope
        for blk in lm.blocks:
            blk._ffn = (lambda h, b=blk:
                        moe_mod.moe_ffn_ep_plain(b.moe, h, cfg, 2))
        moe_mod.route = replay
    try:
        loss = lm.loss(tokens, labels, None, enc)
        loss.backward()
    finally:
        moe_mod.route = route
    want = {"loss": loss.item(),
            "grads": {k: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).detach().cpu()
                      for k, p in lm.named_parameters()}}
    if pinned is not None:
        want["flips"] = int(sum((np.sort(g, -1) != np.sort(w, -1)).any(-1)
                                .sum() for g, w in zip(seen, seq)))
        want["routed"] = int(sum(len(w) for w in seq))
    del lm, loss
    free_cuda()
    return want


def _tph_zamba_cfg(dtype: str = "bfloat16"):
    """zamba2-7b at full width and TPH_ZAMBA_LAYERS layers in ``dtype``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2-7b"),
                               num_layers=TPH_ZAMBA_LAYERS, dtype=dtype)


def _tph_zamba_fp32(model, tokens) -> dict:
    """``model``'s fp32 forward over ``tokens``: every layer's output
    hidden states (host), the last position's hidden state after the final
    norm and its logits over the whole vocab (a rank's vocab slice
    all-gathered over the model axis)."""
    import torch
    from repro_torch.core import embedding_engine as ee
    layers = []
    hooks = [b.register_forward_hook(
        lambda m, a, o: layers.append(o[0].float().cpu()))
        for b in model.blocks]
    try:
        with torch.inference_mode():
            h = model.forward(tokens)
            lg = ee.logits(h[:, -1:], model.embed)
            if model.tp is not None:
                lg = model.tp.gather(lg, lg.dim() - 1)
    finally:
        for hk in hooks:
            hk.remove()
    return {"layers": layers, "last": h[:, -1:].float().cpu(),
            "logits": lg[..., :model.cfg.vocab_size].float().cpu()}


def _tph_zamba_forced(lm, path: str) -> dict:
    """Each layer of the rank's fp32 model fed the one process's input to
    that layer (``path``, :func:`_tph_parent_zamba`'s), its output's
    relative L2 to the one process's; and the final norm and logits fed
    the one process's last layer output."""
    import torch
    from repro_torch.core import embedding_engine as ee
    from repro_torch.models.common import rms_norm
    want = torch.load(path)
    rel = []
    with torch.inference_mode():
        x = want["inputs"][0]
        dev = lm.device
        pos = torch.arange(x.shape[1], dtype=torch.float32,
                           device=dev)[None].expand(x.shape[0], -1)
        ctx = lm._shared_ctx()
        for blk, x, y in zip(lm.blocks, want["inputs"], want["outputs"]):
            got, _ = blk(x.to(dev), pos, ctx)
            rel.append(_rel(got.cpu(), y))
        h = rms_norm(want["last_layer"].to(dev), lm.final_norm,
                     lm.cfg.norm_eps)[:, -1:]
        lg = lm.tp.gather(ee.logits(h, lm.embed), 2)
    return {"layers": rel,
            "head": lg[..., :lm.cfg.vocab_size].float().cpu().numpy()}


def _tph_served(lm, prompts, new_tokens: int) -> tuple:
    """A served drive of ``prompts`` through ``DecodeServer`` (no
    pipeline): ``(tokens, statuses, seconds)``."""
    from repro_torch.runtime.server import DecodeServer, Request
    srv = DecodeServer(lm, batch_slots=TPH_SLOTS, max_len=TPH_MAX_LEN,
                       pipeline=False)
    reqs = [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    return ([list(r.out) for r in reqs], [r.status for r in reqs],
            time.perf_counter() - t0)


def _tph_zamba_counts(kops) -> dict:
    """``_mp_counts`` with the block gather's launches by variant."""
    c = _mp_counts(kops)
    c["gather_variants"] = dict(kops.variant_launch_counts()["block_gather"])
    return c


def _tph_zamba(rank: int, shard, job: dict) -> tuple:
    """Phase 22(d) on one of two ranks: zamba2-7b at full width and
    TPH_ZAMBA_LAYERS layers, 16 SSM heads and 16 attention heads a rank.
    (a) in fp32: the counted 1 x TPH_ZAMBA_F32_SEQ forward (every layer's
    output, the last hidden state and its logits kept for the parent's
    comparison), its first flash call (the shared attention's f32 kernel
    at (112, 112) on the rank's heads) held to the plain version; (c) the
    counted fp32 served drive; (b) rebuilt in bf16: the counted, timed
    TPH_PREFILL prefill (collectives, staged MB, peak) and its first flash
    call (the bf16 wgmma forward at (112, 112)) held to the plain version.
    Returns ``(results, the bf16 flash call's q, k, v, keywords)``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.agreement import check_bf16
    from repro_torch.models.lm import LM
    out = {"counts": {}}
    torch.cuda.reset_peak_memory_stats()
    lm = LM(_tph_zamba_cfg("float32"), seed=job["seed"], shard=shard)
    out["held"] = {"w_in": tuple(lm.blocks[0].mamba["w_in"].shape),
                   "ssm_heads": lm.blocks[0].mamba["A_log"].shape[0],
                   "attn_heads": lm.shared["attn"]["wq"].shape[1] //
                   lm.cfg.hd,
                   "bytes": sum(p.numel() * p.element_size()
                                for p in lm.parameters())}
    toks = torch.from_numpy(job["z_tokens"]).cuda()
    with torch.inference_mode():
        lm.prefill(toks[:, :TPH_WARM_TOKENS])           # warm-up
    kops.reset_launch_counts()
    run = []
    q, k, v, kw, fo = _tph_held_flash(
        lm, lambda: run.append(_tph_zamba_fp32(lm, toks)))
    out["counts"]["fp32 prefill"] = _tph_zamba_counts(kops)
    out["forced"] = _tph_zamba_forced(lm, job["z_layers"])
    plain = plain_attention(q, k, v, **kw)
    out["f32_flash"] = {
        "max_abs_err": float((fo - plain).abs().max()),
        "close": bool(torch.allclose(fo, plain, rtol=TPH_FLASH_F32_TOL,
                                     atol=TPH_FLASH_F32_TOL)),
        "shape": (tuple(q.shape), tuple(k.shape))}
    del q, k, v, fo, plain
    res = run.pop()
    out["fp32"] = {"last": res["last"].numpy(),
                   "logits": res["logits"].numpy(),
                   "layers": [t.numpy() for t in res["layers"]]
                   if rank == 0 else None,
                   "digest": _digest(torch.cat([res["last"].flatten(),
                                                res["logits"].flatten()]))}
    del res
    kops.reset_launch_counts()
    served, statuses, secs = _tph_served(lm, job["z_prompts"],
                                         TPH_NEW_TOKENS)
    out["counts"]["fp32 serving"] = _tph_zamba_counts(kops)
    out.update(served=served, statuses=statuses, serve_s=secs)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(_tph_zamba_cfg(), seed=job["seed"], shard=shard)
    toks = torch.from_numpy(job["z_tokens2"]).cuda()
    with torch.inference_mode():
        lm.prefill(toks[:, :TPH_WARM_TOKENS])           # warm-up
    stats = lm.collective_stats
    kops.reset_launch_counts()
    c0 = dict(stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = []
    q, k, v, kw, fo = _tph_held_flash(lm, lambda: pre.append(
        lm.prefill(toks)))
    torch.cuda.synchronize()
    out["bf16_ms"] = (time.perf_counter() - t0) * 1e3
    out["counts"]["bf16 prefill"] = _tph_zamba_counts(kops)
    out["bf16_coll"] = _tp_collectives(stats, c0)
    out["bf16_last"] = pre.pop().float().cpu().numpy()
    out["bf16_flash"] = check_bf16(fo, plain_attention(q, k, v, **kw),
                                   f"rank {rank}'s zamba2-7b shared "
                                   f"attention flash (bf16, 112/112) on its "
                                   f"heads")
    out["peak"] = torch.cuda.max_memory_allocated()
    del lm, fo
    gc.collect()
    torch.cuda.empty_cache()
    return out, (q, k, v, kw)


def _tph_parent_zamba(seed: int, job: dict) -> dict:
    """Phase 22(d)'s one process, before the ranks: zamba2-7b at
    TPH_ZAMBA_LAYERS layers in fp32 -- the 1 x TPH_ZAMBA_F32_SEQ forward
    (every layer's input and output, saved to ``job["z_layers"]`` for the
    ranks' layer-by-layer check; the last hidden state, its logits), the
    same forward with the first layer's input perturbed by
    TPH_ZAMBA_FLOOR_EPS (the chaos floor) and the served drive -- then in
    bf16 the TPH_PREFILL prefill, on the weights the ranks' slices are cut
    from."""
    import torch
    from repro_torch.models.lm import LM
    model = LM(_tph_zamba_cfg("float32"), seed=seed)
    toks = torch.from_numpy(job["z_tokens"]).cuda()
    first = []
    hook = model.blocks[0].register_forward_pre_hook(
        lambda m, a: first.append(a[0].float().cpu()))
    want = _tph_zamba_fp32(model, toks)
    hook.remove()
    torch.save({"inputs": first + want["layers"][:-1],
                "outputs": want["layers"],
                "last_layer": want["layers"][-1]}, job["z_layers"])
    g = torch.Generator(device="cuda").manual_seed(seed + 32)

    def perturb(m, a):
        x = a[0]
        noise = torch.randn(x.shape, generator=g, device=x.device)
        return (x + TPH_ZAMBA_FLOOR_EPS * x.norm() / noise.norm() * noise,
                ) + a[1:]
    hook = model.blocks[0].register_forward_pre_hook(perturb)
    floor = _tph_zamba_fp32(model, toks)
    hook.remove()
    want["floor"] = {"last": _rel(floor["last"], want["last"]),
                     "logits": _rel(floor["logits"], want["logits"]),
                     "layers": [_rel(a, b) for a, b in
                                zip(floor["layers"], want["layers"])]}
    want["served"], want["statuses"], _ = _tph_served(
        model, job["z_prompts"], TPH_NEW_TOKENS)
    del model
    free_cuda()
    model = LM(_tph_zamba_cfg(), seed=seed)
    want["bf16_last"] = model.prefill(torch.from_numpy(
        job["z_tokens2"]).cuda()).float().cpu()
    del model
    free_cuda()
    return want


def _tph_parent_a(seed: int, job: dict) -> dict:
    """Phase 22(a)'s single device: chatglm3-6b's prefill and teacher-
    forced micro-steps (their tokens: the prompt, then this model's
    argmax), freed before the ranks start; and the training step's loss
    and gradients at TPH_TRAIN_LAYERS layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config("chatglm3-6b")
    model = LM(cfg, seed=seed)
    want = {"last": model.prefill(torch.from_numpy(job["tokens"]).cuda())
            .float().cpu()}
    tf = job["tf_tokens"]
    caches = model.init_caches(tf.shape[0], tf.shape[1] + 1)
    logits = []
    for t in range(tf.shape[1]):
        if t >= TPH_TF_PROMPT:             # teacher: this model's argmax
            tf[:, t] = logits[-1][:, 0].argmax(-1).numpy()
        lg, _ = model.decode_step(torch.from_numpy(tf[:, t:t + 1]).cuda(),
                                  caches)
        logits.append(lg.cpu())
    want["tf_logits"] = torch.stack(logits)
    del model, caches
    free_cuda()
    want["train"] = _tph_single_train(
        dataclasses.replace(cfg, num_layers=TPH_TRAIN_LAYERS), seed,
        job["train_batch"])
    return want


def _tph_parent_bc(seed: int, job: dict, ranks: list) -> dict:
    """Phase 22(b) and (c)'s single device: DeepSeek-V2-Lite's first MLA
    layer on the job's inputs, the pinned MoE drive
    (:func:`_tp_parent_moe`) and the pinned training step's loss and
    gradients (:func:`_tph_single_train`); whisper-large-v3's forward and
    decode micro-steps; and its training step's loss and gradients."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.attention import mla_decode, mla_forward
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=TPH_DS_LAYERS)
    model = LM(cfg, seed=seed)
    x = torch.from_numpy(job["mla_x"]).cuda().bfloat16()
    s = x.shape[1]
    pos = torch.arange(s, dtype=torch.float32, device=x.device)[None]
    want = {}
    with torch.inference_mode():
        want["mla_fwd"] = mla_forward(model.blocks[0].attn, x, cfg,
                                      positions=pos).float().cpu()
        cache = {n: torch.from_numpy(job[f"mla_{n}"]).cuda().bfloat16()
                 for n in ("c", "kr")}
        cache["len"] = torch.full((1,), s - 1, dtype=torch.int32,
                                  device=x.device)
        want["mla_dec"] = mla_decode(model.blocks[0].attn, x[:, -1:], cfg,
                                     cache).float().cpu()
    moe_job = {"moe_tokens": job["ds_tokens"], "moe_decode": job["ds_decode"]}
    want["moe"] = _tp_parent_moe(model, "deepseek", moe_job, ranks)
    del model, cache
    free_cuda()
    want["ds_train"] = _tph_single_train(
        cfg, seed, job["ds_train_batch"],
        pinned=[r["deepseek"]["train"]["routes"] for r in ranks])
    wcfg = get_config("whisper-large-v3")
    model = LM(wcfg, seed=seed)
    toks = torch.from_numpy(job["w_tokens"]).cuda()
    frames = torch.from_numpy(job["w_frames"]).cuda().bfloat16()
    with torch.inference_mode():
        want["hidden"] = model.forward(toks, enc_embeds=frames).float().cpu()
        enc_out = model._encode(frames)
        caches = model.init_caches(1, TPH_WHISPER_DECODE + 1)
        want["dec_logits"] = torch.stack([model.decode_step(
            toks[:, t:t + 1], caches, batch_ctx={"enc_out": enc_out})[0].cpu()
            for t in range(TPH_WHISPER_DECODE)])
    del model, enc_out, caches
    free_cuda()
    want["train"] = _tph_single_train(
        dataclasses.replace(wcfg, num_layers=TPH_WHISPER_TRAIN_LAYERS,
                            enc_layers=TPH_WHISPER_TRAIN_LAYERS), seed,
        job["w_train_batch"])
    return want


def _tph_grads_check(cfg, job: dict, part: str, world: int, want: dict,
                     ranks: list, what: str) -> dict:
    """The training step's checks: the ranks' losses bit-equal and within
    MP_LOSS_REL of the single device's; every gradient, the ranks' slices
    (read back from the phase's directory) joined by the head plan, within
    TRAIN_GRAD_REL_L2 relative L2 of the single device's; every KV copy's
    gradient and stepped parameter the same bits on every rank of its
    group, and counted in the norm by its first rank only."""
    import torch
    from repro_torch.convert import lm_params_gathered
    from repro_torch.launch.sharding import head_plan
    losses = [r["loss"] for r in ranks]
    require(len(set(losses)) == 1, f"{what}: the ranks' losses differ: "
            f"{losses}")
    loss_rel = abs(losses[0] - want["loss"]) / abs(want["loss"])
    require(np.isfinite(losses[0]) and loss_rel <= MP_LOSS_REL,
            f"{what}: the loss {losses[0]!r} vs the single device's "
            f"{want['loss']!r}: relative {loss_rel:.3g} > {MP_LOSS_REL}")
    states = [torch.load(_tph_grad_file(job, part, r), mmap=True)
              for r in range(world)]
    joined = lm_params_gathered(states, cfg)
    require(set(joined) == set(want["grads"]),
            f"{what}: the joined gradients' leaves differ from the single "
            f"device's")
    rel = {k: _rel_l2(joined[k].cuda(), want["grads"][k].cuda())
           for k in joined}
    worst = max(rel, key=rel.get)
    require(rel[worst] <= TRAIN_GRAD_REL_L2,
            f"{what}: the gradient of {worst} (ranks joined) is "
            f"{rel[worst]:.3g} relative L2 from the single device's (limit "
            f"{TRAIN_GRAD_REL_L2})")
    copies = sorted(ranks[0]["copies"])
    for rank, r in enumerate(ranks):
        group = head_plan(cfg, world, rank).group
        for k in copies:
            if group:
                require(r["copies"][k] == ranks[group[0]]["copies"][k],
                        f"{what}: rank {rank}'s copy of {k} (gradient, "
                        f"stepped parameter) differs from rank {group[0]}'s")
        first = bool(group) and group[0] == rank
        require(all((k in r["repeat"]) != first for k in copies),
                f"{what}: rank {rank} counts a KV copy in the norm "
                f"{'not ' if first else ''}as its group's first holder")
        bad = sorted(k for k, d in r.get("whole", {}).items()
                     if d != ranks[0]["whole"][k])
        require(not bad, f"{what}: rank {rank}'s gradients or stepped "
                f"parameters of the leaves whole on every rank differ from "
                f"rank 0's at {bad[:4]}")
    for r in range(world):
        _tph_grad_file(job, part, r).unlink()
    return {"loss_rel": loss_rel, "worst": worst, "worst_rel": rel[worst],
            "leaves": len(rel), "copies": len(copies),
            "whole": len(ranks[0].get("whole", {})), "rel": rel}


def _tph_counts(counts: list) -> collections.Counter:
    """The launches of the main paths' counted drives (``_mp_counts``
    records), summed by kernel and instance."""
    total = collections.Counter()
    for c in counts:
        total.update({k: c[k] for k in ("flash", "gather", "flash_bwd",
                                        "transpose")})
        total["sparse"] += c["sls_variants"]["sparse"]
        total.update({f"variant {k}": v
                      for k, v in c["bwd_variants"].items()})
        total.update({f"instance {k}": v for k, v in c["instances"].items()})
        total.update({f"bwd instance {k}": v
                      for k, v in c["bwd_instances"].items()})
    return total


def _tph_zamba_checks(ranks: list, want: dict, card: str) -> dict:
    """Phase 22(d)'s checks and lines: each rank holds 16 SSM and 16
    attention heads; each fp32 layer fed the one process's input, and the
    final norm and logits fed its last layer's output, within
    TPH_ZAMBA_F32_REL_L2 of one process's; the fp32 prefill run through
    the same bits on both ranks and within TPH_ZAMBA_F32_FREE_REL_L2 (its
    reading after every layer printed beside the chaos floor: one process
    against itself with the first layer's input moved by
    TPH_ZAMBA_FLOOR_EPS); the fp32 served tokens equal
    one process's; the f32 and bf16 flash calls at (112, 112) held to the
    plain version; each counted drive launched the flash kernel at its
    instance and the masked lookup's block gather with its grouping pass.
    The bf16 prefill's distance from one process is printed, not bounded
    (bf16 is chaotic here: ROADMAP.md, reference caveat (g))."""
    import torch
    z = [r["zamba2"] for r in ranks]
    cfg = _tph_zamba_cfg()
    di, ns = 2 * cfg.d_model, cfg.ssm_state
    require(z[0]["fp32"]["digest"] == z[1]["fp32"]["digest"],
            "zamba2: the ranks' fp32 last hidden state and logits differ")
    layers = [_rel(torch.from_numpy(g), w) for g, w in
              zip(z[0]["fp32"]["layers"], want["layers"])]
    floor = want["floor"]
    out = {"layers_rel": layers, "floor": floor,
           "forced": [r["forced"]["layers"] for r in z]}
    for rank, r in enumerate(z):
        h = r["held"]
        require(h["ssm_heads"] == 16 and h["attn_heads"] == 16 and
                h["w_in"] == (cfg.d_model, di + 2 * ns + 16),
                f"zamba2 rank {rank} holds {h}: the plans give 16 SSM heads "
                f"(w_in {di} + {2 * ns} + 16 columns) and 16 attention heads")
        forced = r["forced"]["layers"] + [
            _rel(torch.from_numpy(r["forced"]["head"]), want["logits"])]
        require(max(forced) <= TPH_ZAMBA_F32_REL_L2,
                f"zamba2 rank {rank}: fp32 layers fed one process's inputs "
                f"(then the head) vs one process, relative L2 "
                f"{[f'{x:.3g}' for x in forced]} > {TPH_ZAMBA_F32_REL_L2}")
        rel = {"last": _rel(torch.from_numpy(r["fp32"]["last"]),
                            want["last"]),
               "logits": _rel(torch.from_numpy(r["fp32"]["logits"]),
                              want["logits"])}
        require(max(rel.values()) <= TPH_ZAMBA_F32_FREE_REL_L2,
                f"zamba2 rank {rank}: the fp32 prefill vs one process "
                f"{rel} > {TPH_ZAMBA_F32_FREE_REL_L2} (relative L2; by "
                f"layer {[f'{x:.3g}' for x in layers]})")
        require(r["served"] == want["served"] and
                all(st == "ok" for st in r["statuses"]),
                f"zamba2 rank {rank} served {r['served']} "
                f"({r['statuses']}), one process {want['served']}")
        f32 = r["f32_flash"]
        require(f32["close"], f"zamba2 rank {rank}: the f32 flash at "
                f"(112, 112) vs the plain version, max abs err "
                f"{f32['max_abs_err']:.3g} > {TPH_FLASH_F32_TOL}")
        c = r["counts"]
        for part, inst in (("fp32 prefill", "float32 112/112 causal"),
                           ("bf16 prefill", "bfloat16 112/112 causal")):
            require(c[part]["instances"] == {inst: 2} and
                    c[part]["gather_variants"]["bulk"] > 0 and
                    c[part]["gather_variants"]["group"] > 0,
                    f"zamba2 rank {rank}'s {part} launched {c[part]}: one "
                    f"{inst} flash a shared layer and the masked lookup's "
                    f"bulk gather with its grouping pass")
        require(c["fp32 serving"]["gather"] > 0,
                f"zamba2 rank {rank}'s served drive launched no gather")
        brel = _rel(torch.from_numpy(r["bf16_last"]), want["bf16_last"])
        require(np.isfinite(brel), f"zamba2 rank {rank}: bf16 prefill "
                f"relative L2 {brel}")
        bc = r["bf16_coll"]
        out[rank] = {"fp32_rel": rel, "bf16_rel": brel, "ms": r["bf16_ms"],
                     "coll": bc, "peak": r["peak"]}
        print(f"[22 tp heads zamba2 rank {rank}] zamba2-7b at full width "
              f"and {TPH_ZAMBA_LAYERS} of its 81 layers ({cfg.n_super} "
              f"super-blocks: 10 mamba, 2 shared attention), 16 of its 32 "
              f"SSM heads and 16 of its 32 attention heads a rank, w_in "
              f"{h['w_in']} (its x, z, dt and the copied B | C), "
              f"{h['bytes'] / 1e9:.3f} GB of fp32 weights held; fp32 1 x "
              f"{TPH_ZAMBA_F32_SEQ} forward vs one process, each layer fed "
              f"its input: <= {max(forced):.4g} relative L2 (tol "
              f"{TPH_ZAMBA_F32_REL_L2}), run through: last hidden state "
              f"{rel['last']:.4g}, last logits {rel['logits']:.4g} (tol "
              f"{TPH_ZAMBA_F32_FREE_REL_L2}); f32 flash "
              f"(112, 112) on its heads max abs err "
              f"{f32['max_abs_err']:.3g} vs plain (tol {TPH_FLASH_F32_TOL}); "
              f"fp32 served {TPH_REQUESTS} x {TPH_NEW_TOKENS} tokens in "
              f"{r['serve_s']:.2f} s, equal to one process's; bf16 "
              f"{TPH_PREFILL[0]} x {TPH_PREFILL[1]} prefill "
              f"{r['bf16_ms']:.1f} ms (host clock, synchronised; "
              f"{bc['collectives']} collectives, "
              f"{bc['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{bc['collective_ms']:.1f} ms in them) vs one process "
              f"{brel:.4g} relative L2 (printed, not bounded: caveat (g)); "
              f"bf16 flash (112, 112) {_bf16_summary(r['bf16_flash'])}; "
              f"launches {dict((k, v['instances']) for k, v in c.items())}, "
              f"block gather by variant "
              f"{dict((k, v['gather_variants']) for k, v in c.items())}; "
              f"peak {r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[22 tp heads zamba2 layers] the fp32 forward's hidden state "
          f"after each layer, relative L2 -- rank 0 run through vs one "
          f"process: " +
          ", ".join(f"{i} {x:.3g}" for i, x in enumerate(layers)) +
          "; rank 0 fed one process's input to each layer: " +
          ", ".join(f"{i} {x:.3g}" for i, x in
                    enumerate(z[0]["forced"]["layers"])) +
          f"; the chaos floor (one process vs itself, the first layer's "
          f"input moved by {TPH_ZAMBA_FLOOR_EPS:g} relative): " +
          ", ".join(f"{i} {x:.3g}" for i, x in enumerate(floor["layers"])) +
          f" (last hidden state {floor['last']:.3g}, logits "
          f"{floor['logits']:.3g}); {card}")
    return out


def phase_tp_heads(seed: int, card: str) -> dict:
    """Phase 22: the attention kinds over any model axis, gloo ranks
    sharing the one card (spawned, a file store; every collective staged
    through pinned host memory) -- (a) chatglm3-6b over four ranks (the
    head plan's KV copies), (b) DeepSeek-V2-Lite (MLA) and (c)
    whisper-large-v3 (the encoder-decoder) over two (module docstring,
    22).  Returns the launches by kernel and the flash layers' times at
    the ranks' shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import run_ranks
    print("[22 tp heads predicted] written before the first run on the card "
          "(PERF.md): " + "; ".join(f"{k} {v}"
                                          for k, v in TPH_PREDICTED.items()))
    rng = np.random.default_rng(seed + 22)
    glm = get_config("chatglm3-6b")
    tf = np.zeros((TPH_SLOTS, TPH_TF_STEPS), np.int64)
    tf[:, :TPH_TF_PROMPT] = rng.integers(0, glm.vocab_size,
                                         (TPH_SLOTS, TPH_TF_PROMPT))
    ddir = REPO / "build" / "tp_heads"
    shutil.rmtree(ddir, ignore_errors=True)
    ddir.mkdir(parents=True)

    def train_batch(cfg, seq):
        b = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq,
                                       global_batch=1)).batch_at(0)
        return {k: v.astype(np.int64) for k, v in b.items()}
    ds_cfg = get_config("deepseek-v2-lite-16b")
    wcfg = get_config("whisper-large-v3")
    s_mla = TPH_DS_PREFILL[1]
    w_batch = train_batch(wcfg, TPH_WHISPER_TRAIN_SEQ)
    w_batch["enc_embeds"] = rng.standard_normal(
        (1, TPH_WHISPER_TRAIN_SEQ, wcfg.d_model)).astype(np.float32)
    job = {"seed": seed, "dir": str(ddir),
           "tokens": rng.integers(0, glm.vocab_size,
                                  TPH_PREFILL).astype(np.int64),
           "tf_tokens": tf,
           "prompts": [rng.integers(0, glm.vocab_size, TPH_PROMPT)
                       .astype(np.int32) for _ in range(TPH_REQUESTS)],
           "train_batch": train_batch(glm, TPH_TRAIN_SEQ),
           "mla_x": rng.standard_normal((1, s_mla, ds_cfg.d_model))
           .astype(np.float32),
           "mla_c": rng.standard_normal((1, s_mla, ds_cfg.kv_lora_rank))
           .astype(np.float32),
           "mla_kr": rng.standard_normal((1, s_mla, ds_cfg.rope_head_dim))
           .astype(np.float32),
           "ds_tokens": rng.integers(0, ds_cfg.vocab_size,
                                     TPH_DS_PREFILL).astype(np.int64),
           "ds_decode": rng.integers(0, ds_cfg.vocab_size,
                                     (TPH_SLOTS, TPH_DS_DECODE))
           .astype(np.int64),
           "ds_prompts": [rng.integers(0, ds_cfg.vocab_size, TPH_PROMPT)
                          .astype(np.int32) for _ in range(TPH_DS_REQUESTS)],
           "ds_train_batch": train_batch(ds_cfg, TPH_DS_PREFILL[1]),
           "w_tokens": rng.integers(0, wcfg.vocab_size,
                                    (1, TPH_WHISPER_FRAMES)).astype(np.int64),
           "w_frames": rng.standard_normal(
               (1, TPH_WHISPER_FRAMES, wcfg.d_model)).astype(np.float32),
           "w_train_batch": w_batch}
    zcfg = _tph_zamba_cfg()
    job.update({"z_tokens": rng.integers(0, zcfg.vocab_size,
                                         (1, TPH_ZAMBA_F32_SEQ)),
                "z_tokens2": rng.integers(0, zcfg.vocab_size, TPH_PREFILL),
                "z_prompts": [rng.integers(0, zcfg.vocab_size, TPH_PROMPT)
                              .astype(np.int32)
                              for _ in range(TPH_REQUESTS)],
                "z_layers": str(ddir / "zamba2_layers.pt")})
    seconds = {}
    t0 = time.perf_counter()
    want_a = _tph_parent_a(seed, job)
    seconds["a single"] = time.perf_counter() - t0
    t0, t_a = time.perf_counter(), time.time()
    ranks_a = run_ranks(_tph_rank_a, 4, (job,), timeout_s=900)
    seconds["a ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_a = _tph_grads_check(
        dataclasses.replace(glm, num_layers=TPH_TRAIN_LAYERS), job, "a", 4,
        want_a["train"], [r["train"] for r in ranks_a],
        "22(a) chatglm3-6b training step")
    seconds["a checks"] = time.perf_counter() - t0
    # (a) chatglm3-6b over four ranks
    a0 = ranks_a[0]
    for rank, r in enumerate(ranks_a):
        require(r["heads"] == (8, 1) and r["cache_heads"] == 1,
                f"chatglm3-6b rank {rank}: {r['heads']} query / KV heads and "
                f"{r['cache_heads']} cached; the head plan gives 8 over 1")
        require(r["served"] == a0["served"] and
                np.array_equal(r["last"], a0["last"]) and
                np.array_equal(r["tf_logits"], a0["tf_logits"]),
                f"chatglm3-6b: rank {rank}'s outputs differ from rank 0's")
        require(all(st == "ok" for st in r["statuses"]),
                f"chatglm3-6b rank {rank}: served {r['statuses']}")
        rel = _rel_l2(torch.from_numpy(r["last"]), want_a["last"])
        require(rel <= TP_REL_L2, f"chatglm3-6b rank {rank}: prefill "
                f"relative L2 {rel:.4g} > {TP_REL_L2} against the single "
                f"device")
        tf_rel = max(_rel_l2(torch.from_numpy(r["tf_logits"][t]),
                             want_a["tf_logits"][t])
                     for t in range(TPH_TF_STEPS))
        require(tf_rel <= TP_REL_L2, f"chatglm3-6b rank {rank}: teacher-"
                f"forced logits relative L2 {tf_rel:.4g} > {TP_REL_L2}")
        pc, sc, tr = r["prefill_coll"], r["step_coll"], r["train"]
        print(f"[22 tp heads chatglm3-6b rank {rank}] 8 query heads over a "
              f"copy of KV head {rank // 2} (the head plan), "
              f"{r['held_bytes'] / 1e9:.3f} GB of weights held; "
              f"{TPH_PREFILL[0]} x {TPH_PREFILL[1]} prefill "
              f"{r['prefill_ms']:.1f} ms (host clock, synchronised; "
              f"{pc['collectives']} collectives, "
              f"{pc['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{pc['collective_ms']:.1f} ms in them), last hidden state vs "
              f"the single device relative L2 {rel:.4g} (tol {TP_REL_L2}); "
              f"{TPH_TF_STEPS} teacher-forced micro-steps of {TPH_SLOTS} "
              f"slots: mean {np.mean(r['step_ms'][1:]):.2f} ms "
              f"({sc['collectives']:.1f} collectives, "
              f"{sc['staged_bytes'] / 1e6:.3f} MB staged a step), logits "
              f"relative L2 <= {tf_rel:.4g}; layer-0 flash on its heads "
              f"{_bf16_summary(r['flash'])}; served {TPH_REQUESTS} x "
              f"{TPH_NEW_TOKENS} tokens in {r['serve_s']:.2f} s (eager, "
              f"gloo); training step at {TPH_TRAIN_LAYERS} layers, 1 x "
              f"{TPH_TRAIN_SEQ}: {tr['ms']:.1f} ms ({tr['coll']['collectives']}"
              f" collectives, {tr['coll']['staged_bytes'] / 1e6:.1f} MB "
              f"staged); peak {r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[22 tp heads chatglm3-6b training] loss on every rank "
          f"{a0['train']['loss']!r} vs the single device's "
          f"{want_a['train']['loss']!r} (relative {train_a['loss_rel']:.3g},"
          f" limit {MP_LOSS_REL}); every gradient ({train_a['leaves']} "
          f"leaves, the ranks' slices joined by the head plan) within "
          f"{train_a['worst_rel']:.3g} relative L2 of the single device's "
          f"(worst {train_a['worst']}, limit {TRAIN_GRAD_REL_L2}); the "
          f"{train_a['copies']} copied KV leaves' gradients and stepped "
          f"parameters bit-equal on each group's two ranks; the served "
          f"tokens equal on all four ranks; {card}")
    # (d)'s one process first: the ranks check their layers against it
    t0 = time.perf_counter()
    want_z = _tph_parent_zamba(seed, job)
    seconds["d single"] = time.perf_counter() - t0
    # (b), (c), (d): one spawn of two ranks
    t0, t_bc = time.perf_counter(), time.time()
    ranks_bc = run_ranks(_tph_rank_bc, 2, (job,), timeout_s=900)
    seconds["bc ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_bc = _tph_parent_bc(seed, job, ranks_bc)
    seconds["bc single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_c = _tph_grads_check(
        dataclasses.replace(wcfg, num_layers=TPH_WHISPER_TRAIN_LAYERS,
                            enc_layers=TPH_WHISPER_TRAIN_LAYERS), job, "c",
        2, want_bc["train"], [r["whisper"]["train"] for r in ranks_bc],
        "22(c) whisper-large-v3 training step")
    seconds["c checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_layers = dataclasses.replace(ds_cfg, num_layers=TPH_DS_LAYERS)
    train_b = _tph_grads_check(
        ds_layers, job, "b", 2, want_bc["ds_train"],
        [r["deepseek"]["train"] for r in ranks_bc],
        "22(b) DeepSeek-V2-Lite training step")
    seconds["b checks"] = time.perf_counter() - t0
    d0, d1 = (r["deepseek"] for r in ranks_bc)
    moe = want_bc["moe"]
    require(d0["served"] == d1["served"] and
            all(st == "ok" for st in d0["statuses"] + d1["statuses"]),
            f"DeepSeek: the ranks served {d0['served']} and {d1['served']}")
    for key in ("mla_fwd", "mla_dec", "last", "dec_logits"):
        require(np.array_equal(d0[key], d1[key]),
                f"DeepSeek: the ranks' {key} differ")
    for rank, r in enumerate((d0, d1)):
        require(r["heads"] == 8, f"DeepSeek rank {rank}: {r['heads']} heads")
        rel = {k: _rel_l2(torch.from_numpy(r[k]), want_bc[k])
               for k in ("mla_fwd", "mla_dec")}
        rel["prefill"] = _rel_l2(torch.from_numpy(r["last"]), moe["last"])
        rel["decode"] = max(_rel_l2(torch.from_numpy(r["dec_logits"][t]),
                                    moe["dec_logits"][t])
                            for t in range(TPH_DS_DECODE))
        bad = {k: v for k, v in rel.items() if v > TP_REL_L2}
        require(not bad, f"DeepSeek rank {rank}: relative L2 {bad} > "
                f"{TP_REL_L2} against the single device (the prefill "
                f"against moe_ffn_ep_plain, routing pinned)")
        pc, sc = r["prefill_coll"], r["step_coll"]
        print(f"[22 tp heads deepseek rank {rank}] DeepSeek-V2-Lite at full "
              f"width and {TPH_DS_LAYERS} of its 27 layers, 8 of its 16 MLA "
              f"heads a rank, the latent (w_dkv, w_kr, the cache) and the "
              f"shared experts whole, {r['held_bytes'] / 1e9:.3f} GB held; "
              f"one MLA layer's forward (1 x {s_mla}) and decode micro-step "
              f"vs the single device relative L2 {rel['mla_fwd']:.4g} and "
              f"{rel['mla_dec']:.4g}; layer-0 flash (192, 128) on its heads "
              f"{_bf16_summary(r['flash'])}; 1 x {TPH_DS_PREFILL[1]} prefill "
              f"{r['prefill_ms']:.1f} ms ({pc['collectives']} collectives, "
              f"{pc['staged_bytes'] / 1e6:.1f} MB staged) vs "
              f"moe_ffn_ep_plain {rel['prefill']:.4g}; {TPH_DS_DECODE} "
              f"micro-steps mean {np.mean(r['step_ms'][1:]):.2f} ms "
              f"({sc['staged_bytes'] / 1e6:.3f} MB staged a step), logits "
              f"vs the single device <= {rel['decode']:.4g} (tol "
              f"{TP_REL_L2}); served {TPH_DS_REQUESTS} x {TPH_DS_NEW_TOKENS} "
              f"tokens in {r['serve_s']:.2f} s, equal on both ranks; peak "
              f"{r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[22 tp heads deepseek routing] pinned to the ranks' in the "
          f"plain runs; unpinned, {moe['prefill_flips']} of "
          f"{moe['prefill_tokens']} prefill token-layer top-6 sets and "
          f"{moe['decode_flips']} of {moe['decode_tokens']} decode ones "
          f"would differ; {card}")
    dt = want_bc["ds_train"]
    for rank, r in enumerate((d0, d1)):
        tr, c = r["train"], r["train"]["counts"]
        require(c["gather"] > 0 and c["gather_bwd"] > 0 and
                c["transpose"] > 0 and c["sls_variants"]["sparse"] > 0 and
                c["flash_bwd"] > 0 and
                c["bwd_variants"] == {"wgmma": 0, "simt": c["flash_bwd"]} and
                c["bwd_instances"] == {"bfloat16 192/128 causal":
                                       c["flash_bwd"]},
                f"DeepSeek rank {rank}'s training step launched {c}: the "
                f"un-dispatch gather, its backward (transposition, sparse "
                f"sum) and the (192, 128) SIMT flash backward must all run")
        print(f"[22 tp heads deepseek training rank {rank}] one TrainStep "
              f"of 1 x {TPH_DS_PREFILL[1]} tokens at full width and "
              f"{TPH_DS_LAYERS} layers (the seq-split expert path, its "
              f"all-to-alls and their transposes; the whole leaves' "
              f"gradients summed over the axis; AdamW.apply_): first "
              f"step {_tph_step_txt(tr)}; the second, warm, on the same "
              f"batch {_tph_step_txt(tr['warm'])}; launches (first step): "
              f"block gather {c['gather']} (its backward {c['gather_bwd']}:"
              f" gather_transpose {c['transpose']}, sls_sparse "
              f"{c['sls_variants']['sparse']}), flash_attention "
              f"{c['instances']}, flash_attention_bwd {c['bwd_instances']} "
              f"(variants {c['bwd_variants']}); peak "
              f"{tr['peak'] / 2**30:.2f} GiB; {card}")
    ga = {kind: [r["train"]["gather_bwd"][kind] for r in (d0, d1)]
          for kind in ("undispatch", "lookup")}
    ga_txt = (f"the step's first un-dispatch gather's backward "
              f"({ga['undispatch'][0]['ids']} ids into the rank's "
              f"{ga['undispatch'][0]['rows']}-row buffer) and first masked "
              f"lookup's ({ga['lookup'][0]['ids']} ids into the rank's "
              f"{ga['lookup'][0]['rows']:,} vocab rows), "
              f"{ga['lookup'][0]['dtype']}, on their captured cotangents, "
              f"ember_transpose + the sparse ember_sls vs index_add_ in fp32: "
              + "; ".join(f"{kind} rank {i} {_bf16_summary(a)}"
                          for kind, pair in ga.items()
                          for i, a in enumerate(pair)))
    print(f"[22 tp heads deepseek training] loss on both ranks "
          f"{d0['train']['loss']!r} vs one process's "
          f"{dt['loss']!r} (each MoE layer moe_ffn_ep_plain(n=2), routing "
          f"pinned to the ranks'; relative {train_b['loss_rel']:.3g}, limit "
          f"{MP_LOSS_REL}); every gradient ({train_b['leaves']} leaves, the "
          f"ranks' slices joined by the plan) within "
          f"{train_b['worst_rel']:.3g} relative L2 (worst "
          f"{train_b['worst']}, limit {TRAIN_GRAD_REL_L2}; router "
          f"{train_b['rel']['blocks.0.moe.router']:.3g}, shared wi_gate "
          f"{train_b['rel']['blocks.0.moe.shared.wi_gate']:.3g}, w_dkv "
          f"{train_b['rel']['blocks.0.attn.w_dkv']:.3g}, experts' wi_gate "
          f"{train_b['rel']['blocks.0.moe.wi_gate']:.3g}); the "
          f"{train_b['whole']} leaves whole on both ranks bit-equal in "
          f"gradient and stepped parameter; unpinned, {dt['flips']} of "
          f"{dt['routed']} token-layer top-6 sets would differ; {ga_txt}; "
          f"{card}")
    mb = ranks_bc[0]["mla_bwd"]
    (b_, s_, h_, d_), (_, _, _, dv_) = mb["shape"]
    sdpa_txt = ", ".join(f"{n} {v:.4f} ms" if isinstance(v, float)
                         else f"{n} {v}" for n, v in mb["sdpa"].items()
                         if not n.endswith("_reps"))
    print(f"[22 tp heads flash backward mla] a rank's DeepSeek MLA layer "
          f"(B={b_}, S={s_}, H={h_}, q/k {d_}, v {dv_}, bf16, causal; the "
          f"{mb['variant']} kernels): {mb['ms']:.4f} ms, plain backward "
          f"{mb['plain_ms']:.4f} ms, scaled_dot_product_attention's "
          f"backward alone on a kept graph ({sdpa_txt}), bound "
          f"{mb['bound_ms']:.4f} ms ({mb['flops'] / 1e9:.3f} GFLOP, by "
          f"{mb['bound_by']}; {100 * mb['bound_ms'] / mb['ms']:.2f}% of it);"
          f" dq/dk/dv vs the plain backward {_bf16_summary(mb['agreement'])};"
          f" {card}")
    w0, w1 = (r["whisper"] for r in ranks_bc)
    for key in ("hidden", "dec_logits"):
        require(np.array_equal(w0[key], w1[key]),
                f"whisper: the ranks' {key} differ")
    for rank, r in enumerate((w0, w1)):
        require(r["heads"] == 10, f"whisper rank {rank}: {r['heads']} heads")
        rel = _rel_l2(torch.from_numpy(r["hidden"]), want_bc["hidden"])
        drel = max(_rel_l2(torch.from_numpy(r["dec_logits"][t]),
                           want_bc["dec_logits"][t])
                   for t in range(TPH_WHISPER_DECODE))
        require(rel <= TP_REL_L2 and drel <= TP_REL_L2,
                f"whisper rank {rank}: forward relative L2 {rel:.4g}, "
                f"decode {drel:.4g} > {TP_REL_L2} against the single device")
        fc, tr = r["forward_coll"], r["train"]
        print(f"[22 tp heads whisper rank {rank}] whisper-large-v3 at full "
              f"width and depth (32 + 32 layers), 10 of its 20 heads a rank "
              f"in every attention, {r['held_bytes'] / 1e9:.3f} GB held; the "
              f"1 x {TPH_WHISPER_FRAMES} encoder + decoder forward "
              f"{r['forward_ms']:.1f} ms ({fc['collectives']} collectives, "
              f"{fc['staged_bytes'] / 1e6:.1f} MB staged, "
              f"{fc['collective_ms']:.1f} ms in them) vs the single device "
              f"relative L2 {rel:.4g}; {TPH_WHISPER_DECODE} decode "
              f"micro-steps with the encoder context, {r['step_ms'][-1]:.2f} "
              f"ms the last, logits relative L2 <= {drel:.4g}; layer-0 "
              f"encoder flash {_bf16_summary(r['flash'])}; training step at "
              f"{TPH_WHISPER_TRAIN_LAYERS} + {TPH_WHISPER_TRAIN_LAYERS} "
              f"layers, 1 x {TPH_WHISPER_TRAIN_SEQ}: {tr['ms']:.1f} ms "
              f"({tr['coll']['collectives']} collectives); peak "
              f"{r['peak'] / 2**30:.2f} GiB; {card}")
    print(f"[22 tp heads whisper training] loss on both ranks "
          f"{w0['train']['loss']!r} vs the single device's "
          f"{want_bc['train']['loss']!r} (relative {train_c['loss_rel']:.3g}"
          f"); every gradient ({train_c['leaves']} leaves, the encoder's "
          f"and the cross-attention's among them) within "
          f"{train_c['worst_rel']:.3g} relative L2 (worst "
          f"{train_c['worst']}); {card}")
    zamba = _tph_zamba_checks(ranks_bc, want_z, card)
    counts = [c for r in ranks_a for c in (r["counts"], r["train"]["counts"])]
    for r in ranks_bc:
        counts += [r["deepseek"]["serve_counts"],
                   r["deepseek"]["train"]["counts"], r["whisper"]["counts"],
                   r["whisper"]["train"]["counts"],
                   *r["zamba2"]["counts"].values()]
    launches = _tph_counts(counts)
    for r in ranks_bc:
        for c, inst in r["moe_counts"]:
            launches.update({"flash": c["flash_attention"],
                             "gather": c["block_gather"]})
            launches.update({f"instance {k}": v for k, v in inst.items()})
    for k in ("flash", "gather", "flash_bwd", "transpose", "sparse"):
        require(launches[k] > 0, f"phase 22's main path launched no {k}")
    inst = {k[9:]: v for k, v in launches.items()
            if k.startswith("instance ")}
    bwd_inst = {k[13:]: v for k, v in launches.items()
                if k.startswith("bwd instance ")}
    require(sum(inst.values()) == launches["flash"],
            f"phase 22's flash instances {inst} != {launches['flash']}")
    times = {}
    for key, r, what in (("chatglm3", a0["flash_layer"], "chatglm3-6b"),
                         ("mla", ranks_bc[0]["mla_layer"], "DeepSeek MLA"),
                         ("whisper", ranks_bc[0]["enc_layer"],
                          "whisper encoder"),
                         ("zamba2", ranks_bc[0]["zamba_layer"],
                          "zamba2 shared attention")):
        shape = (a0["flash_shape"] if key == "chatglm3" else ranks_bc[0][
            {"mla": "mla", "whisper": "enc", "zamba2": "zamba"}[key] +
            "_layer_shape"])
        times[key] = {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by", "flops")}
        (b_, s_, h_, d_), kshape = shape
        backends = ", ".join(f"{n} {v:.4f} ms" if isinstance(v, float)
                             else f"{n} {v}"
                             for n, v in r["backends"].items())
        print(f"[22 tp heads flash {key}] a rank's {what} layer (B={b_}, "
              f"S={s_}, H={h_}, Hkv={kshape[2]}, D={d_}, bf16): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {r['library_ms']:.4f} ms (by "
              f"backend: {backends}), bound {r['bound_ms']:.4f} ms ("
              f"{r['flops'] / 1e9:.2f} GFLOP, by {r['bound_by']}; "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of it); {card}")
    print(f"[22 tp heads launches] the ranks' main paths: flash_attention "
          f"{launches['flash']} ({inst}), flash_attention_bwd "
          f"{launches['flash_bwd']} ({bwd_inst}), block gather "
          f"{launches['gather']}, gather_transpose {launches['transpose']}, "
          f"sls_sparse {launches['sparse']}; {card}")
    print(f"[22 tp heads time] seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + f" (rank 0 of (a) "
        f"from its spawn: {_marks(a0['marks'], t_a)}; rank 0 of (b, c): "
        f"{_marks(ranks_bc[0]['marks'], t_bc)}); {card}")
    zc = [c for r in ranks_bc for c in r["zamba2"]["counts"].values()]
    zgroups = sum(c["gather_variants"]["group"] for c in zc)
    zinst = collections.Counter()
    for c in zc:
        zinst.update(c["instances"])
    print(f"[22 tp heads zamba2 launches] the two ranks' counted zamba2 "
          f"drives (fp32 prefill, fp32 serving, bf16 prefill): "
          f"flash_attention {sum(c['flash'] for c in zc)} ({dict(zinst)}), "
          f"block gather {sum(c['gather'] for c in zc)} (its grouping pass "
          f"{zgroups}); {card}")
    shutil.rmtree(ddir, ignore_errors=True)
    return {"flash_launches": launches["flash"], "flash_instances": inst,
            "flash_bwd_launches": launches["flash_bwd"],
            "flash_bwd_instances": bwd_inst,
            "bwd_variants": {k[8:]: v for k, v in launches.items()
                             if k.startswith("variant ")},
            "gather_launches": launches["gather"],
            "transpose_launches": launches["transpose"],
            "sparse_launches": launches["sparse"],
            "flash_layers": times,
            "mla_bwd": {k: mb[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "flops",
                                           "max_abs_err")},
            "zamba2": {"flash_launches": sum(c["flash"] for c in zc),
                       "gather_launches": sum(c["gather"] for c in zc),
                       "gather_group_launches": zgroups,
                       "fp32_rel": [zamba[r]["fp32_rel"] for r in (0, 1)],
                       "bf16_rel": [zamba[r]["bf16_rel"] for r in (0, 1)],
                       "bf16_prefill_ms": [zamba[r]["ms"] for r in (0, 1)],
                       "layers_rel": zamba["layers_rel"],
                       "forced_rel": zamba["forced"],
                       "floor": zamba["floor"]},
            "ds_train": {"ms": [r["train"]["ms"] for r in (d0, d1)],
                         "warm_ms": [r["train"]["warm"]["ms"]
                                     for r in (d0, d1)],
                         "gather_bwd": ga,
                         "counts": [r["train"]["counts"] for r in (d0, d1)],
                         "loss_rel": train_b["loss_rel"],
                         "worst_rel": train_b["worst_rel"]}}


def _free_after_tp_heads(before: int) -> None:
    """Require phase 22 to leave the card as it found it (< 1 GiB more
    allocated in this process than ``before``)."""
    import torch
    free_cuda()
    held = torch.cuda.memory_allocated()
    print(f"[22 tp heads after] this process holds {held / 2**30:.2f} GiB "
          f"({before / 2**30:.2f} before the phase)")
    require(held - before < 1 << 30, f"phase 22 left "
            f"{(held - before) / 2**30:.2f} GiB allocated")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sweep-only", action="store_true",
                    help="stop after phase 3 (a quick kernel check)")
    ap.add_argument("--training-only", action="store_true",
                    help="run phases 1, 2 and 13 alone (the training "
                         "phase's lines, no JSON)")
    ap.add_argument("--whisper-only", action="store_true",
                    help="run phases 1, 2 and 14 alone (the whisper "
                         "phase's lines, no JSON)")
    ap.add_argument("--zamba2-only", action="store_true",
                    help="run phases 1, 2 and 15 alone (the zamba2 "
                         "phase's lines, no JSON)")
    ap.add_argument("--xlstm-only", action="store_true",
                    help="run phases 1, 2 and 16 alone (the xlstm "
                         "phase's lines, no JSON)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run phases 1, 2, 4, 5 and 17 alone (the sharded "
                         "executor's lines and the phases it takes its "
                         "tables from, no JSON)")
    ap.add_argument("--tp-only", action="store_true",
                    help="run phases 1, 2 and 18 alone (tensor and expert "
                         "parallelism over two ranks, no JSON)")
    ap.add_argument("--mp-train-only", action="store_true",
                    help="run phases 1, 2 and 19 alone (model-parallel "
                         "training over gloo ranks, no JSON)")
    ap.add_argument("--disagg-only", action="store_true",
                    help="run phases 1, 2 and 20 alone (the disaggregated "
                         "embedding tier and serving artifacts, no JSON)")
    ap.add_argument("--roofline-only", action="store_true",
                    help="run phases 1, 2 and 21 alone (the dry run and the "
                         "roofline; (c)'s measured times need the full run, "
                         "no JSON)")
    ap.add_argument("--tp-heads-only", action="store_true",
                    help="run phases 1, 2 and 22 alone (the attention kinds "
                         "over any model axis: the head plan, MLA and the "
                         "encoder-decoder over gloo ranks, no JSON)")
    ap.add_argument("--llava-only", action="store_true",
                    help="run phase 12 alone (the main run starts it in a "
                         "process of its own) and print its result as "
                         "'LLAVA {json}'")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              "run it from a checkout of the repo", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.llava_only:
        from repro_torch.kernels import _build
        _build.library()
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print("LLAVA " + json.dumps(phase_llava(args.seed, card)))
        return 0
    t0 = time.perf_counter()
    name, card = phase_device()
    phase_build()
    if args.sharded_only:
        phase_sharded(args.seed, args.steps, card,
                      phase_dlrm(args.seed, args.steps)[1],
                      phase_deepseek(args.seed, args.steps, card)[1])
        _free_after_sharded()
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.tp_only:
        before = torch.cuda.memory_allocated()
        phase_tp(args.seed, card)
        _free_after_tp(before)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.mp_train_only:
        before = torch.cuda.memory_allocated()
        phase_mp_train(args.seed, card)
        _free_after_mp(before)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.tp_heads_only:
        before = torch.cuda.memory_allocated()
        phase_tp_heads(args.seed, card)
        _free_after_tp_heads(before)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.disagg_only:
        phase_disagg(args.seed, card)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    if args.roofline_only:
        phase_roofline(args.seed, card)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    alone = (phase_training if args.training_only else
             phase_whisper if args.whisper_only else
             phase_zamba2 if args.zamba2_only else
             phase_xlstm if args.xlstm_only else None)
    if alone is not None:
        alone(args.seed, card)
        print(f"[time] {time.perf_counter() - t0:.1f} s")
        return 0
    phase_sweep(args.seed)
    phase_sweep_transpose(args.seed)
    phase_sweep_fusedmm(args.seed)
    phase_sweep_flash(args.seed)
    phase_stress_flash(args.seed)
    phase_small_program(args.seed)
    seconds = {"1-3": time.perf_counter() - t0}
    if args.sweep_only:
        return 0
    kernels, kept = [], {}
    for phase, run in (("4", lambda: phase_dlrm(args.seed, args.steps)),
                       ("5", lambda: phase_deepseek(args.seed, args.steps,
                                                    card))):
        t0 = time.perf_counter()
        result, kept[phase] = run()
        kernels.append(result)
        seconds[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = phase_sharded(args.seed, args.steps, card, kept.pop("4"),
                            kept.pop("5"))
    _free_after_sharded()
    seconds["17"] = time.perf_counter() - t0
    for phase, run in (("6", lambda: phase_gnn(args.seed, args.steps, card)),
                       ("7", lambda: phase_chatglm3(args.seed))):
        t0 = time.perf_counter()
        kernels.append(run())
        seconds[phase] = time.perf_counter() - t0
    later = {}
    for phase, run in (("7 stablelm", lambda: phase_stablelm_prefill(
                            args.seed)),
                       ("8", lambda: phase_serving(args.seed, card)),
                       ("8 stablelm", lambda: phase_serving_stablelm(
                           args.seed, card)),
                       ("9", lambda: phase_deepseek_lm(args.seed, card)),
                       ("10", lambda: phase_gemma3(args.seed, card)),
                       ("11", lambda: phase_danube(args.seed, card)),
                       ("12", lambda: phase_llava_subprocess(args.seed,
                                                             card)),
                       ("13", lambda: phase_training(args.seed, card)),
                       ("14", lambda: phase_whisper(args.seed, card)),
                       ("15", lambda: phase_zamba2(args.seed, card)),
                       ("16", lambda: phase_xlstm(args.seed, card))):
        t0 = time.perf_counter()
        later[phase] = run()
        seconds[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    tp = phase_tp(args.seed, card)
    _free_after_tp(before)
    seconds["18"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    mp = phase_mp_train(args.seed, card)
    _free_after_mp(before)
    seconds["19"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    disagg = phase_disagg(args.seed, card)
    seconds["20"] = time.perf_counter() - t0
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    instances = collections.Counter(flash.pop("instances"))
    prefill = later.pop("7 stablelm")
    flash["chatglm3_launches"] = flash["launches"]
    flash["stablelm_launches"] = prefill.pop("launches")
    flash["launches"] += flash["stablelm_launches"]
    instances.update(prefill.pop("instances"))
    flash.update(prefill)
    gather = next(k for k in kernels if k["name"] == "block_gather")
    gather["deepseek_launches"] = gather["launches"]
    for phase, key in (("8", "serving"), ("8 stablelm", "serving_stablelm")):
        gather[f"{key}_launches"] = later[phase]["launches"]
        gather[f"{key}_group_launches"] = later[phase]["group_launches"]
        gather["launches"] += later[phase]["launches"]
    ds_prefill = later["9"]["prefill"]
    ds_serving = later["9"]["serving"]
    flash["deepseek_launches"] = ds_prefill.pop("flash_launches")
    flash["launches"] += flash["deepseek_launches"]
    instances.update(ds_prefill.pop("flash_instances"))
    for key in [k for k in ds_prefill if k.startswith(("mla_", "deepseek_"))]:
        flash[key] = ds_prefill.pop(key)
    for key, run in (("deepseek_prefill", ds_prefill),
                     ("deepseek_serving", ds_serving)):
        gather[f"{key}_launches"] = run.pop("gather_launches")
        gather[f"{key}_group_launches"] = run.pop("gather_group_launches")
        gather["launches"] += gather[f"{key}_launches"]
    gather.update(ds_prefill)
    gather.update({f"deepseek_serving_{k}": v for k, v in ds_serving.items()})
    for phase, key in (("10", "gemma3"), ("11", "danube"), ("12", "llava"),
                       ("15", "zamba2")):
        run = later[phase]
        flash[f"{key}_launches"] = run.pop("flash_launches")
        flash["launches"] += flash[f"{key}_launches"]
        instances.update(run.pop("flash_instances"))
        if "gather_launches" in run:
            gather[f"{key}_serving_launches"] = run.pop("gather_launches")
            gather[f"{key}_serving_group_launches"] = run.pop(
                "gather_group_launches")
            gather["launches"] += gather[f"{key}_serving_launches"]
        flash.update(run)
    training = later["13"]
    flash["training_launches"] = training.pop("training_forward_launches")
    flash["launches"] += flash["training_launches"]
    instances.update(training.pop("training_forward_instances"))
    whisper = later["14"]
    for part in ("prefill", "serving"):
        run = whisper[part]
        flash[f"whisper_{part}_launches"] = run.pop(
            "launches" if part == "serving" else "prefill_launches")
        flash["launches"] += flash[f"whisper_{part}_launches"]
        instances.update(run.pop("instances" if part == "serving"
                                 else "prefill_instances"))
        flash.update({k if k.startswith("whisper_") else f"whisper_{k}": v
                      for k, v in run.items()})
    xlstm = later["16"]
    gather["xlstm_serving_launches"] = xlstm.pop("gather_launches")
    gather["xlstm_serving_group_launches"] = xlstm.pop(
        "gather_group_launches")
    gather["launches"] += gather["xlstm_serving_launches"]
    xt = xlstm.pop("training")
    gather.update(xlstm)
    wt = whisper["training"]
    flash["whisper_training_launches"] = wt.pop("flash_launches")
    flash["launches"] += flash["whisper_training_launches"]
    instances.update(wt.pop("flash_instances"))
    kernels.extend(_gather_backward_kernels(
        next(k for k in kernels if k["name"] == "sls"), training, wt, xt))
    training["danube_launches"] = training["launches"]
    training["whisper_launches"] = wt.pop("bwd_launches")
    training["launches"] += training["whisper_launches"]
    bwd_instances = collections.Counter(training["instances"])
    bwd_instances.update(wt.pop("bwd_instances"))
    training["instances"] = dict(bwd_instances)
    training.update({f"whisper_{k}": v for k, v in wt.items()})
    kernels.append(training)
    # phase 17's launches: the two ranks' sharded DLRM and DeepSeek drives
    for kname, key in (("sls", "sls"), ("block_gather", "gather"),
                       ("gather_transpose", "transpose")):
        k = next(k for k in kernels if k["name"] == kname)
        k["sharded_launches"] = sharded["launches"][key]
        k["launches"] += k["sharded_launches"]
    sls = next(k for k in kernels if k["name"] == "sls")
    sls.update({f"sharded_{k}": v for k, v in sharded.items()
                if k.startswith("sls_")})
    transpose = next(k for k in kernels if k["name"] == "gather_transpose")
    transpose.update({f"sharded_{k}": v for k, v in sharded.items()
                      if k.startswith("transpose_")})
    # phase 18's launches: the two ranks' tensor-parallel main paths
    flash["tp_launches"] = tp.pop("flash_launches")
    flash["launches"] += flash["tp_launches"]
    instances.update(tp.pop("flash_instances"))
    gather["tp_launches"] = tp.pop("gather_launches")
    gather["launches"] += gather["tp_launches"]
    flash.update(tp)
    # phase 19's launches: the ranks' model-parallel training steps
    flash["mp_launches"] = mp.pop("flash_launches")
    flash["launches"] += flash["mp_launches"]
    instances.update(mp.pop("flash_instances"))
    gather["mp_launches"] = mp.pop("gather_launches")
    gather["launches"] += gather["mp_launches"]
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    bwd["mp_launches"] = mp.pop("flash_bwd_launches")
    bwd["launches"] += bwd["mp_launches"]
    bwd["variants"]["wgmma"] += bwd["mp_launches"]
    bwd_instances = collections.Counter(bwd["instances"])
    bwd_instances.update(mp.pop("flash_bwd_instances"))
    bwd["instances"] = dict(bwd_instances)
    for kname, key in (("gather_transpose", "transpose_launches"),
                       ("sls_sparse", "sparse_launches")):
        k = next(k for k in kernels if k["name"] == kname)
        k["launches_by_training"]["mp"] = mp.pop(key)
        k["launches"] += k["launches_by_training"]["mp"]
    split = mp.pop("rank_gather_backward")
    for kname, keys in (("gather_transpose", ("transpose_ms", "csr_ms",
                                              "transpose_bound_ms")),
                        ("sls_sparse", ("sum_ms", "sum_plain_ms",
                                        "sum_bound_ms", "embedding_bag_ms",
                                        "ms", "index_add_ms", "bound_ms"))):
        k = next(k for k in kernels if k["name"] == kname)
        k["mp_rank_embedding"] = {f: split[f] for f in keys}
    bwd.update({f"mp_{k}": v for k, v in mp.items()})
    # phase 20's launches: the bulk gathers the replica processes ran for
    # the disaggregated drives (read from their pings)
    gather["disagg_launches"] = disagg.pop("disagg_launches")
    gather["launches"] += gather["disagg_launches"]
    gather.update(disagg)
    # phase 21 reads the earlier phases' times, then drives its own path
    t0 = time.perf_counter()
    roof = phase_roofline(args.seed, card, {
        "chatglm3_prefill_ms": flash["chatglm3_prefill_ms"],
        "stablelm_prefill_ms": flash["stablelm_prefill_ms"],
        "llava_prefill_ms": flash["llava_prefill_ms"],
        "training_step_ms": training["training_step_ms"]})
    seconds["21"] = time.perf_counter() - t0
    flash["roofline_launches"] = roof["flash_launches"]
    flash["launches"] += flash["roofline_launches"]
    instances.update(roof["flash_instances"])
    bwd["roofline_launches"] = roof["flash_bwd_launches"]
    bwd["launches"] += bwd["roofline_launches"]
    for variant, n in roof["bwd_variants"].items():
        bwd["variants"][variant] += n
    bwd_instances = collections.Counter(bwd["instances"])
    bwd_instances.update(roof["flash_bwd_instances"])
    bwd["instances"] = dict(bwd_instances)
    for kname, key in (("gather_transpose", "transpose_launches"),
                       ("sls_sparse", "sparse_launches")):
        k = next(k for k in kernels if k["name"] == kname)
        k["launches_by_training"]["roofline"] = roof[key]
        k["launches"] += roof[key]
    # phase 22: the attention kinds over any model axis
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    heads = phase_tp_heads(args.seed, card)
    _free_after_tp_heads(before)
    seconds["22"] = time.perf_counter() - t0
    flash["tp_heads_launches"] = heads.pop("flash_launches")
    flash["launches"] += flash["tp_heads_launches"]
    instances.update(heads.pop("flash_instances"))
    flash["tp_heads_flash_layers"] = heads.pop("flash_layers")
    flash["tp_heads_zamba2"] = heads.pop("zamba2")
    gather["tp_heads_launches"] = heads.pop("gather_launches")
    gather["launches"] += gather["tp_heads_launches"]
    bwd["tp_heads_launches"] = heads.pop("flash_bwd_launches")
    bwd["launches"] += bwd["tp_heads_launches"]
    bwd["tp_heads_mla_bwd"] = heads.pop("mla_bwd")
    bwd["tp_heads_deepseek_training"] = heads.pop("ds_train")
    for variant, n in heads.pop("bwd_variants").items():
        bwd["variants"][variant] += n
    bwd_instances = collections.Counter(bwd["instances"])
    bwd_instances.update(heads.pop("flash_bwd_instances"))
    bwd["instances"] = dict(bwd_instances)
    for kname, key in (("gather_transpose", "transpose_launches"),
                       ("sls_sparse", "sparse_launches")):
        k = next(k for k in kernels if k["name"] == kname)
        k["launches_by_training"]["tp_heads"] = heads.pop(key)
        k["launches"] += k["launches_by_training"]["tp_heads"]
    require(sum(instances.values()) == flash["launches"],
            f"flash launches by instance {dict(instances)} do not add up to "
            f"{flash['launches']}")
    flash["instances"] = dict(instances)
    print("[time] wall seconds by phase: " +
          ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
