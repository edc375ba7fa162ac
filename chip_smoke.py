#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (commefficient_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from csrc/ (one nvcc per source, all at once) and of the
   C++ host data plane (g++, beside them), timed; the flash source
   (``LATE_BUILDS``) compiles on while phase 2 and 3's kernels at
   ResNet9's d run, and its build is waited for and reported after them;
2. kernel parity at full width, every kernel against its plain PyTorch
   version, bitwise:
   - a seeded (6,568,640,) vector sketched into a 5 x 500,096 table
     (twice: the kernel is deterministic), then the fused unsketch + top-k
     at k=50,000, and a table with planted ties; the first port's count
     and select kernels (on no path: the radix below replaced them)
     against theirs;
   - the first port's plain count and select (on no path now) on
     an (8, 6,568,640) batch with per-row k of 50,000 / 25,000 / 1,
     planted ties across tiles and an all-zero row; its resid select on
     (err, v) at d with planted ties and with selected +-0.0; the
     estimates of the sketched table, which must also equal the fused
     selection's masked values where its mask is set;
   - the batched estimates of 8 tables (the sketched one, an all-zero one,
     seeded normals) at B = 8, 3 and 1, every table bitwise equal to the
     unbatched kernel and to the plain version, and the same over two
     runs;
   - the estimate-once histogram radix (est_hist, two digit_hist passes,
     the dense and the compact select) on the sketched table, planted
     ties, an all-zero table and one with +-0.0 and NaN cells: the stored
     estimates, each digit histogram, t and n_take (also against the count
     kernels' radix), the dense and compact outputs bitwise equal to the
     plain versions, and the same over two runs;
   - the per-row histogram radix of the dense streams (rows_hist x 3,
     then rows_select or rows_resid) on an (8, 6,568,640) batch with
     per-row k ``KK_RADIX`` (a k = 0 row; random, all-zero, planted-tie
     and NaN-bearing rows) and at B = 1 on true_topk's (err, v) with
     planted ties and with selected +-0.0: each pass's per-row histograms,
     t, n_take and the outputs bitwise equal to the plain versions, and
     the entry points' second runs equal to the first;
   - one sketch-mode server step with --server_fused auto against off:
     update, Vvelocity and Verror bitwise equal; then 10 alternating pairs
     of the two steps, timed;
   - the sparse re-sketch of the k survivors, three planted in one bucket
     as 1e8, 1, -1e8: the card's table bitwise the CPU's, over two runs;
   - the batched sketch on an (8, 6,568,640) batch (an all-zero row and a
     row of planted heavy coordinates among seeded ones) and on an offset
     slice of it, row by row bitwise equal to its plain version and to the
     unbatched kernel, and the same over two runs;
3. kernel times with CUDA events (median of 25), beside the plain
   versions, one PyTorch library call for the same work where there is
   one, and the bound computed from this run's bytes and operations; the
   whole recovery (new compact, new dense, old count x 9 + select) as 20
   alternating rounds, beside ``torch.topk`` of the squared estimates and
   ``estimates_batched`` + ``torch.topk``; the per-row radix's passes and
   selects, and its whole top-k at B = 8 and B = 1 against the first
   port's route (nibble glue, count_plain x 9, the select) and
   ``torch.topk`` of the squares, as 20 alternating rounds;
4. the main paths, each ``training.cv.train(args, max_rounds=3)`` at
   full width on Synthetic, ResNet9's (d = 6,568,640) with 8 workers and
   k=50,000 unless named, every launch counter set to 0 just before it
   and read just after:
   - sketch (the headline FetchSGD flags, 5 x 500k, virtual error and
     momentum 0.9, 32 images a worker): sketch 3 and the recovery's
     kernels: est_hist 3, digit_hist 6, radix_compact 3, segment_sum 3;
   - true_topk (virtual error, momentum 0.9): rows_hist 9, rows_resid 3;
   - local_topk (local error and momentum 0.9, 100 clients): rows_hist 9
     (8 rows a launch), rows_select 3;
   - sketch with --server_fused off: sketch 3, estimates_batched 3 (the
     reference's off branch runs the batched grid at B = 1), segment_sum
     3;
   - uncompressed (momentum 0.9) and fedavg (2 local epochs in chunks of
     16, lr decay 0.9): no kernel;
   - sketch_clip (the sketch flags + --max_grad_norm 1.0) and sketch_dp
     (+ --dp --dp_mode worker --l2_norm_clip 1.0 --noise_multiplier 1e-3):
     the per-worker sketch, sketch_batched 3 (the 8 clients' tables in one
     launch a round), the recovery's kernels, and no unbatched sketch;
   - uncompressed_dp_server (+ --dp --dp_mode server, the same clip and
     noise): no kernel;
   - fixup9_sketch (the sketch flags + --model FixupResNet9, d =
     6,568,673): the sketch path's kernels, and the rate the Fixup
     scalars moved at (update over recovered value) 0.1 times the
     convolutions' (the default --scalar_lr_factor);
   - fixup50_imagenet (the flags of examples/imagenet.sh on Synthetic's
     32 x 32 images and 10 classes: FixupResNet50, d = 23,475,516,
     uncompressed, iid, 7 workers of 64 images): no kernel;
   - sketch_bf16 (the sketch flags + --compute_dtype bfloat16: ResNet9's
     convolutions and head in bfloat16): the sketch path's kernels;
   - local_topk_down (the local_topk flags + --topk_down): each round's
     download top-k of the 8 clients' weight differences and their
     upload top-k, rows_hist 18 and rows_select 6;
   - sketch_microbatch (the sketch flags + --microbatch_size 8: the
     per-worker round, 4 chunks a client): the sketch path's kernels (the
     aggregate is sketched once a round, as in the reference);
   - local_topk_kdist (the local_topk flags + --client_k_dist
     uniform:0.25,1.0): local_topk's launches with 8 different per-row k
     a round; each transmit's support is min(k_i, nnz), k_i from
     ``cohort_client_ks`` of the round's ids; upload 4 k a client;
   - local_topk_offload (+ --client_state_offload: 100 clients' dense
     rows in host memory) and local_topk_sparse_offload (+ --client_state
     sparse: k index/value pairs a row, encoded and decoded on the card):
     local_topk's launches;
   - local_topk_sketched (local error, no momentum, --client_state
     sketched: a (3, 128) global sketch a client): rows_hist 18,
     rows_select 6 (the decode's top-k beside the transmit's),
     segment_sum 3 (the W tables of a round in one);
   - sketch_buckets (the sketch flags + --grad_buckets 4, which the
     planner cuts into 3 buckets at ResNet9's leaves): sketch 9 at
     128-aligned offsets and the recovery's kernels;
   - sketch_global (+ --sketch_scheme global, 5 x 500,000): segment_sum 6
     (the aggregate's sketch and the survivors' re-sketch), rows_hist 9,
     rows_select 3 (the B = 1 radix top-k of the global estimates);
   with finite losses and weights, each path's d, the upload bytes
   per client (exact, as float32 counters hold them) and its peak memory;
   then sketch_scan: the sketch flags with --scan_rounds 4 for 8 rounds
   (two windows; Synthetic at 512 images a class in a fresh dataset dir)
   against the same 8 rounds in the pipelined loop and in the blocking
   loop of earlier slices (weights, losses, bytes bitwise), no host sync
   inside a window (the CUDA sync debug mode, each sync with its frames),
   the three round periods, and 4 more rounds profiled as a window and
   as pipelined single rounds (wall against device busy); and
   cifar10_fetchsgd: examples/cifar10_fetchsgd.sh's flags (100 non-iid
   clients, --scan_rounds 8) on CIFAR-10 python pickles written from a
   seed at the real size, 16 rounds with the real transforms and one
   validation pass over 10,000 images: the sketch path's launches, exact
   bytes, the data feed's host time a batch beside the round period; run
   three times from one seed, with the C++ data plane (its pad-crop calls
   counted), with COMMEFFICIENT_NO_NATIVE=1 (the numpy stages, no
   native call) and with the C++ plane again, losses and weights bitwise
   equal; before it
   native_feed, on the host: the C++ pad-crop at that path's train batch
   (256 x 32 x 32 x 3, bitwise the numpy stages), RandomResizedCrop at an
   ImageNet batch (64 uint8 images of 256 x 256 x 3 to 224, within 2e-4,
   the RandomState equal afterwards) and the row gather of 64 rows of a
   np.memmap (bitwise), each timed against numpy with its thread count;
   then ``phase_offload_parity``: local_topk against local_topk_offload,
   sparse client state on the card against sparse offload, and sparse
   offload at depth 2 against the same run flushed after every round
   (losses, bytes, weights and every client's rows bitwise); true_topk
   against --grad_buckets 4 (bitwise); sketch against sketch_buckets
   (round 1's loss bitwise, round 1's table within the float32
   association bound of the whole, bytes exact);
   then the sketch path twice more from the same seed: per-round losses,
   weights, Vvelocity and Verror bitwise equal; and one ResNet9 forward
   and backward at its batch timed with cuDNN's deterministic mode off,
   then on;
   then the robustness layer (ROADMAP A10), each with its launches:
   buffered_lockstep (the sketch flags + --server_mode buffered, no fault
   model: losses, bytes, weights, Vvelocity and Verror bitwise that
   sketch run's); buffered_faults (+ FAULT_FLAGS: dropouts, crashes,
   chronic stragglers, alpha 0.5, M 4; 7 cohorts, which draw two dropouts
   and one crash, and the final flush, twice: bitwise, each apply one sketch and one recovery, the fault
   stats, applies and sim_time equal to a CPU replay of the same
   cohorts); quarantine (--client_quarantine, worker 0's images NaN in
   round 2: that contribution alone dropped, its client benched, no
   abort); sigkill_resume (6 rounds with --checkpoint_every_rounds 2 in
   this process, then the CLI in a child process SIGKILLed once its first
   step file exists and a second child with --resume auto: the export
   bitwise this process's, the kernels not rebuilt; a checkpoint's save
   and load timed at d = 6,568,640); finetune (--finetune from that
   export, 3 rounds, the second a middle round to time: only the
   head's 5,120 coordinates move); and, with
   the paths above, buffered_local_topk (the reference's preemption
   config for the buffered server at ResNet9's width); the one-card
   baselines of the mesh (A10b): local_topk's flags under FAULT_FLAGS,
   and with --client_quarantine and a NaN client, each offloaded and
   device-resident, bitwise;
5. a reference check on a small input: two rounds of a narrow ResNet9
   learner on CUDA (kernels) and on the CPU (plain versions) from the same
   weights and batches must agree, in sketch, true_topk and local_topk,
   and in sketch with --max_grad_norm and with DP (noise 0);
6. the flash attention kernels (the tensor-core forward, dq and dk/dv,
   and the first port's scalar ones, on no path) against
   their plain versions and each other at the GPT2 path's shape (BH 768
   = 64 sequences x 12 heads, T 256, D 64): float32 at dropout 0 and 0.1
   (O within 1e-5, dq/dk/dv within 1e-4 of their largest magnitude),
   float32 at dropout 0.1 at the gpt2_clip path's per-client shape (BH
   192 = 16 sequences x 12 heads; the same limits), bfloat16 (O within
   2e-2), and T 1100, D 128 at dropout 0.1 (three logical dropout tiles,
   a ragged end); every kernel run twice, bitwise equal; then the
   tensor-core forward, dq and dk/dv, the scalar ones, the port's whole
   backward (delta, dq, dk/dv) and ``scaled_dot_product_attention``'s
   forward and autograd backward as 20 alternating rounds, the plain
   versions beside them, each kernel with two bounds (3xTF32 on the
   tensor cores, float32 on the CUDA cores);
   then the checks of phase 2's first item, the radix parity and the
   server A/B, and the kernel and recovery times of phase 3 for sketch,
   count, select and the radix again at the GPT2 path's d = 124,051,201
   (a seeded vector into the same 5 x 500,096 table, k = 50,000; plain
   versions timed over 3 runs), and the batched sketch's check and times
   at that d with B = 4; the B = 1 resid top-k at that d (parity, passes,
   20 alternating rounds against the old route and ``torch.topk``); then
   the hardware-RNG dropout kernel against its
   plain version, bitwise: the GPT2 path's (64, 256, 768) float32 at rates
   0.1 and 0.5, the mc head's (64, 768), a (300, 1024) view with a partial
   logical block and a bfloat16 case, each twice; the reference's contract
   at (512, 1024), rate 0.1 (keep fraction within 5e-3 of 0.9, kept values
   exactly f32(1/0.9), the gradient of the sum equal to the output, a
   second seed differing in over 10%); its call against
   ``torch.nn.functional.dropout``'s as 20 alternating rounds at (64,
   256, 768) and at the mc head's (64, 768), each one's device time
   alone (200 launches back to back between one pair of events), the
   plain version and the bound;
7. ``download_counts`` (W comparison-and-count reductions) against the
   ``bincount`` formulation it replaced, at d = 124,051,201 with W = 4
   and d = 6,568,640 with W = 8 (random ``last_changed`` in [-2, 5], tied
   stale rounds, a client that never pulled; and at d = 124,051,201 as
   after 3 gpt2 rounds, all but 150,000 weights at -2): bitwise equal,
   both timed as 6 alternating pairs;
   the GPT2 path: ``training.gpt2.train(args, max_rounds=3)`` with the
   flags of ``examples/gpt2_personachat.sh`` on SyntheticPersona at
   GPT2-small's width (d = 124,051,201, ``--attn_impl blockwise``,
   sketch 5 x 500k, k = 50,000, 4 workers of 8 dialogs x 2 candidates x
   256 tokens): counters zeroed just before the rounds and read when the
   validation pass starts (flash_fwd, flash_bwd_dq, flash_bwd_dkv 36
   each, sketch 3 and the recovery's kernels), the validation pass's launches
   read apart (flash_fwd 12 per batch, nothing else); finite losses,
   weights and validation nll, exact upload bytes; round ms printed;
   then round 3's batch once more under ``torch.profiler``, its device
   time printed by kernel class beside its wall time, with the totals of
   the elementwise add and fill kernels; then the same with
   --max_grad_norm 1.0 (gpt2_clip): the per-worker path, one forward and
   backward per client, so flash_fwd, flash_bwd_dq, flash_bwd_dkv 144 each
   (12 layers x 4 clients x 3 rounds), sketch_batched 3, the recovery's
   kernels, and no unbatched sketch; its round 3 profiled in the same way; then
   gpt2_tpu_bits, the gpt2 flags with ``args.dropout_impl = "tpu_bits"``
   set on the parsed namespace (no CLI value selects it, as in the
   reference): gpt2's launches and hw_dropout 156 (26 sites a forward, 26
   a backward, 3 rounds), none in validation; profiled in the same way;
   then gpt2_t512 (--max_seq_len 512, where --fused_ce auto turns the
   vocab-chunked fused LM head on): gpt2's launches; and gpt2_microbatch
   (--microbatch_size 4: the per-worker round, 2 chunks of 4 dialogs a
   client): flash_fwd, flash_bwd_dq, flash_bwd_dkv 288 each (12 layers x
   4 clients x 2 chunks x 3 rounds), sketch 3, the recovery's kernels;
   and gpt2_local_topk_sparse_offload (examples/gpt2_personachat.sh's
   single-card flags: --mode local_topk --error_type local
   --local_momentum 0.9 --client_state sparse --client_state_offload, 64
   clients' rows as k pairs in host memory): flash_fwd, flash_bwd_dq,
   flash_bwd_dkv 144 each, rows_hist 9 and rows_select 3 (the (4, 124M)
   top-k), upload 4 k a client;
   each GPT2 path's profiled round runs no bincount (kernelHistogram1D),
   and its peak memory is printed;
   then the gpt2 path twice more from the same seed (ROADMAP C5b), the
   first run freed before the second: per-round losses, weights,
   Vvelocity and Verror bitwise equal; then gpt2_scan, the gpt2 flags
   with --scan_rounds 3 (one window): the gpt2 path's launches, no host
   sync inside the window, losses and weights bitwise the first of those
   runs; then gpt2_resume: 3 rounds with --checkpoint_every_rounds 2,
   then a fresh learner resumed from round 2's step file for round 3,
   losses and weights bitwise those 3 rounds (the torch generator, which
   dropout draws from, is in the checkpoint), and a checkpoint's save and
   load timed at d = 124,051,201; then gpt2_buffered (lock-step: bitwise
   the gpt2 path) and gpt2_quarantine (the per-worker path, 2 rounds);
   then the ``clients`` mesh (A12, ``parallel/``): mesh_nccl1 (the sketch
   flags with --mesh clients=1 through the launcher the CLI uses, a ring
   of one over NCCL: bitwise the sketch path), then one launch of 2 ranks
   sharing the card over gloo (``tools/mesh_run.py``): mesh_sketch
   (twice: the ranks bitwise every round, the runs bitwise, round 1's
   table against one process's within MESH_TABLE_SLACK times the
   distance of the same round's two half-batch gradients summed in one
   process, the trajectory against the sketch path's),
   mesh_local_topk_offload (offloaded rows bitwise the device-resident
   mesh rows; each rank's own arena shard read and written),
   mesh_buffered (lock-step bitwise the sync mesh; FAULT_FLAGS' schedule
   equal to its CPU replay), mesh_gpt2 (GPT2_FLAGS: the ranks' state
   bitwise, launches, peak and round time a rank) and the uninterrupted
   run of mesh_kill_resume (the reference's buffered_mesh arm), whose
   child is then SIGKILLed after its first step file and resumed with
   --resume auto: its export bitwise, and loadable in one process;
   then gpt2_moe, the gpt2 flags with
   --moe_experts 4 (each block's MLP a Switch FFN of 4 experts, capacity
   factor 1.25, aux weight 1e-2; d = 294,095,665) for 3 rounds, twice
   from one seed: the gpt2 path's launches, bitwise over the two runs,
   round 1's sketch of the aggregate and its recovery bitwise against
   their plain versions on the run's own inputs at that d, the aux term
   and the peak memory printed, and Block 0's MoE layer on the card
   against the CPU on 4,096 seeded tokens (assignments and keep mask
   equal but for counted near-ties, output within 1e-5 of its largest
   magnitude); then GPT2-small's loss and
   gradient on one full-width batch (32 dialogs x 2 candidates x 256
   tokens, float32, TF32 off) with the fused LM head against the
   materialized logits (loss within 1e-5 relative, gradient within 1e-4
   of its largest magnitude), and with remat against without (gradients
   bitwise equal, flash_fwd 24 against 12), each side's time and peak
   memory printed;
8. a reference check of a narrow GPT2 learner (2 layers) on CUDA (flash
   kernels) and on the CPU: two sketch rounds from the same weights and
   batches, losses within 1e-4 relative, bytes equal; at dropout 0, and
   with tpu_bits at dropout 0.1 (attention dropout on the output on both
   sides), where the card's dropout kernel and the CPU's plain version
   draw the same bits;
9. the serving and online stack (ROADMAP A11) at GPT2-small's width
   (d = 124,051,201, float32, blockwise attention, seeded weights):
   serve_gpt2, a burst of the first 32 prompts of the online loop's
   traffic (``online.build_traffic`` over the GPT2 entry point's
   SyntheticPersona at --max_seq_len 256; greedy, <= 24 new tokens)
   through a paged ``ContinuousBatchingServer`` of 8 slots with a 256-token
   prefill window, after a short warm-up burst, the counters zeroed just
   before it (flash_fwd 12 a prefill, nothing else), the flash forward
   held against its plain version on the burst's own prefill inputs,
   every reply token-identical to the request decoded alone by the
   dense-cache engine and the first 4 to ``sample_reply``'s full
   recompute; tokens/s, time to first token, ms a decode step, pages and
   memory above the burst's start printed, and 8 decode steps profiled;
   serve_variants on the same weights and prompts: speculation (k 4) with
   a 2-layer drafter cut from the target (its embeddings, first 2 blocks
   and head) and self-drafting, which must accept some drafts,
   ``--serve_disagg`` and ``--kv_quant none`` token-identical to the plain
   server, int8 and int4 pools holding at least 3x and 7x the users
   (their agreement with float32 and pool bytes printed); serve_online,
   the entry point's ``--serve_online`` (``ONLINE_FLAGS``) twice from one
   seed: at least 2 applies and 1 hot swap, rows_hist and rows_select
   launched by the cohorts, the flash kernels and the per-row top-k held
   against their plain versions on the first run's own inputs, the
   replies and final weights of the two runs equal;
10. A12's model axis (tensor parallelism, ``parallel/tp.py``):
   tp_flash_parity, each flash kernel (tensor-core and scalar) on a head
   slice with its head map bitwise the unsharded launch's rows of those
   heads, at the GPT2 shape at dropout 0 and 0.1, the identity map
   bitwise no map, and the slices within the flash limits of their plain
   versions; mesh_tp_gpt2, ``GPT2_FLAGS`` with ``--mesh
   clients=1,model=2`` for 3 rounds on 2 ranks sharing the card over gloo
   (d = 124,051,201 padded to 124,051,202, each rank storing half): the
   ranks' whole state bitwise every round, the gpt2 path's launches a
   rank, upload and download bytes exact, the losses within 1e-4 of the
   gpt2 path's, round 1's table bitwise the sum of the ranks' block
   sketches recomputed here and within ``TP_TABLE_SLACK`` times the
   distance its inputs explain (the TP gradient's deviation and the block
   split's reassociation) of the gpt2 path's table; serve_tp2,
   serve_gpt2's burst at tp = 2 on 2 ranks: replies token-identical to
   serve_gpt2's, flash_fwd 12 a prefill a rank, 24 all-reduces a decode
   step, a rank's pools half the model's; step ms, tokens/s and the pool
   bytes a rank printed.
11. A12 1b and the seq axis, in phase 10's launch (2 ranks sharing the
   card over gloo): mesh_seq_gpt2, ``GPT2_FLAGS`` with ``--attn_impl ring
   --mesh clients=1,seq=2`` and ``dropout_impl = "tpu_bits"`` for 3
   rounds, then 2 again: the ranks' state bitwise every round, the second
   run's state bitwise the first's after each round, the sketch, recovery and hw_dropout launches a rank, upload
   and download bytes exact, hw_dropout held against its plain version at
   a seq rank's shape (phase 6's parity), the ring traffic in GB a round
   a rank, the collectives' ms and the peak a rank printed;
   mesh_seq_parity, round 1 of the same at dropout 0 (on the model
   config) against one process's ``--attn_impl full`` round: loss within
   1e-5, the table within ``SEQ_TABLE_SLACK`` times what the aggregates'
   difference explains; mesh_tp_buffered, ``--server_mode buffered`` on
   ``clients=1,model=2``, bitwise mesh_tp_gpt2's rounds (lock-step is
   the sync round); mesh_tp_buckets, ``--grad_buckets 4`` there: round
   1's table bitwise the sketches of each rank's bucket pieces summed and
   within the two summation orders' rounding bound of mesh_tp_gpt2's; and
   mesh_tp_sparse_offload, gpt2_local_topk_sparse_offload's flags there,
   offloaded against device-resident rows, 2 rounds each, bitwise; the
   stage axis (GPipe, ``parallel/pp.py``): mesh_pp_gpt2, ``GPT2_FLAGS``
   with ``--mc_coef 0 --mesh clients=1,stage=2`` for 3 rounds (blocks 0-5
   on one rank, 6-11 on the other, 2 microbatches of 32 sequences): the
   ranks' state bitwise every round, the flash, sketch and recovery
   launches a rank (12 flash launches of each kind a round: 6 blocks x 2
   microbatches at BH 384), upload and download bytes exact, each rank's
   hops exactly its 2 activations or cotangents a round, the hops' and
   receive waits' ms, the all-reduce and the peak a rank printed beside
   the 1/3 bubble; mesh_pp_parity, round 1 of the same in 4
   microbatches at dropout 0 (on the model config) against one
   process's ``--mc_coef 0`` round: loss within 1e-5, the aggregate
   within ``PP_AGG_TOL`` of its largest coordinate, the table within
   ``PP_TABLE_SLACK`` times what the aggregates' difference explains.
12. A12's expert axis and MoE blocks on the model axis, in phase 10's
   launch, at ``EP_FLAGS`` (``GPT2_FLAGS`` with 4 experts at
   ``--local_batch_size 4``: d = 294,095,665): mesh_ep_gpt2, ``--mesh
   clients=1,expert=2`` for 3 rounds (each rank the whole model but
   experts 0-1 or 2-3 of every block): the ranks' whole state bitwise
   every round, the flash (12 a round each at BH 384), sketch and
   recovery launches a rank, exact upload bytes, the peak a rank and
   both ranks', the round ms and the expert group's collectives a round
   (the combine all-reduces, the f all-reduces, the gradient join)
   printed; mesh_ep_parity, round 1 of the same at dropout 0 (on the
   model config) against one process's round (``phase_ep_reference``):
   loss within ``EP_LOSS_RTOL``, the aggregate within ``EP_AGG_TOL`` of
   its largest coordinate, the table within ``EP_TABLE_SLACK`` times what
   the aggregates' difference explains, and whether aggregate and table
   are bitwise the one-process ones printed; mesh_tp_moe, ``--mesh
   clients=1,model=2`` for 2 rounds at dropout 0 (each MoE block whole
   on both model ranks): the ranks' state bitwise every round, flash at
   BH 192, round 1's loss within ``EP_LOSS_RTOL`` of the one-process
   round's and its table bitwise the ranks' block sketches summed and
   within ``check_mesh_tp_gpt2``'s limit of the one-process table; peak,
   round ms and collective GB a rank printed.

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository (the port's package not beside it), it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import replace

import numpy as np

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--virtual_momentum", "0.9", "--num_workers", "8",
            "--local_batch_size", "32", "--k", "50000", "--num_rows", "5",
            "--num_cols", "500000", "--dataset_name", "Synthetic",
            "--device", "cuda"]
D_RESNET9 = 6_568_640
K = 50_000
TABLE_FLOATS = 5 * 500_096
_BASE = ["--num_workers", "8", "--k", "50000", "--dataset_name",
         "Synthetic", "--device", "cuda"]
# the sketch server's recovery over 3 rounds: the estimate-once histogram
# radix (one est_hist and two digit_hist passes, the compact select) and
# the deterministic segmented sum of the survivors' re-sketch
RECOVERY = {"est_hist": 3, "digit_hist": 6, "radix_compact": 3,
            "segment_sum": 3}
# name: (flags, launches over 3 rounds, upload bytes per client)
PATHS = {
    "sketch": (HEADLINE, dict(RECOVERY, sketch=3), 4 * TABLE_FLOATS),
    "true_topk": (_BASE + ["--mode", "true_topk", "--error_type", "virtual",
                           "--virtual_momentum", "0.9",
                           "--local_batch_size", "32"],
                  {"rows_hist": 9, "rows_resid": 3}, 4 * D_RESNET9),
    "local_topk": (_BASE + ["--mode", "local_topk", "--error_type", "local",
                            "--local_momentum", "0.9", "--num_clients",
                            "100", "--local_batch_size", "32"],
                   {"rows_hist": 9, "rows_select": 3}, 4 * K),
    # the reference's off branch runs the batched estimates grid at B = 1
    "sketch_server_fused_off": (HEADLINE + ["--server_fused", "off"],
                                {"sketch": 3, "estimates_batched": 3,
                                 "segment_sum": 3}, 4 * TABLE_FLOATS),
    "uncompressed": (_BASE + ["--mode", "uncompressed",
                              "--virtual_momentum", "0.9",
                              "--local_batch_size", "32"], {},
                     4 * D_RESNET9),
    "fedavg": (_BASE + ["--mode", "fedavg", "--local_batch_size", "-1",
                        "--num_fedavg_epochs", "2", "--fedavg_batch_size",
                        "16", "--fedavg_lr_decay", "0.9"], {},
               4 * D_RESNET9),
}
DP_FLAGS = ["--l2_norm_clip", "1.0", "--noise_multiplier", "1e-3"]
# the per-worker sketch: the W clients' tables in one batched launch a
# round, and no sketch of the aggregate
PER_WORKER_SKETCH = dict(RECOVERY, sketch_batched=3)
PATHS.update({
    "sketch_clip": (HEADLINE + ["--max_grad_norm", "1.0"],
                    PER_WORKER_SKETCH, 4 * TABLE_FLOATS),
    "sketch_dp": (HEADLINE + ["--dp", "--dp_mode", "worker"] + DP_FLAGS,
                  PER_WORKER_SKETCH, 4 * TABLE_FLOATS),
    "uncompressed_dp_server": (PATHS["uncompressed"][0] + [
        "--dp", "--dp_mode", "server"] + DP_FLAGS, {}, 4 * D_RESNET9),
})
D_FIXUP9 = 6_568_673
D_FIXUP50 = 23_475_516   # a 10-class head: Synthetic's classes
# the flags of examples/imagenet.sh on Synthetic (32 x 32 images, 10
# classes, not ImageNet's)
IMAGENET_FLAGS = ["--model", "FixupResNet50", "--mode", "uncompressed",
                  "--iid", "--num_clients", "7", "--num_workers", "7",
                  "--local_batch_size", "64", "--valid_batch_size", "64",
                  "--virtual_momentum", "0.9", "--weight_decay", "1e-4",
                  "--lr_scale", "0.4", "--pivot_epoch", "5", "--num_epochs",
                  "24", "--dataset_name", "Synthetic", "--device", "cuda"]
PATHS.update({
    # the headline sketch flags on FixupResNet9, its scalars at the default
    # --scalar_lr_factor (0.1 for Fixup models)
    "fixup9_sketch": (HEADLINE + ["--model", "FixupResNet9"],
                      dict(RECOVERY, sketch=3), 4 * TABLE_FLOATS),
    # the Fixup bottlenecks and their scalar LR at full width; no kernel,
    # as in the reference
    "fixup50_imagenet": (IMAGENET_FLAGS, {}, 4 * D_FIXUP50),
})
PATHS.update({
    # ResNet9's convolutions and head in bfloat16 (the parameters, logits
    # and everything after them float32): the sketch path's kernels
    "sketch_bf16": (HEADLINE + ["--compute_dtype", "bfloat16"],
                    dict(RECOVERY, sketch=3), 4 * TABLE_FLOATS),
    # --topk_down: the W download top-ks of the (8, d) differences ride the
    # same per-row radix as the upload top-k, so each round runs rows_hist
    # 3 + rows_select 1 twice
    "local_topk_down": (PATHS["local_topk"][0] + ["--topk_down"],
                        {"rows_hist": 18, "rows_select": 6}, 4 * K),
    # microbatched clients (4 chunks of 8 a client) on the per-worker
    # round; no per-worker nonlinearity, so the aggregate is sketched once
    # a round, as in the reference
    "sketch_microbatch": (HEADLINE + ["--microbatch_size", "8"],
                          dict(RECOVERY, sketch=3), 4 * TABLE_FLOATS),
})
LOCAL_TOPK = {"rows_hist": 9, "rows_select": 3}
KDIST = "uniform:0.25,1.0"
PATHS.update({
    # each client keeps the first k_i of its top-k slots, k_i its own draw:
    # 8 different per-row k a round in the same rows_hist/rows_select
    # launches; the upload is still charged at k a client
    "local_topk_kdist": (PATHS["local_topk"][0] + ["--client_k_dist",
                                                   KDIST],
                         LOCAL_TOPK, 4 * K),
    # the 100 clients' dense rows (2 fields x 26.3 MB) in host memory:
    # gather-ahead and lazy writeback on the copy stream
    "local_topk_offload": (PATHS["local_topk"][0]
                           + ["--client_state_offload"], LOCAL_TOPK, 4 * K),
    # k index/value pairs a row (cap = k < d/2: truncating), encoded and
    # decoded on the card, the arena and the pending rows encoded
    "local_topk_sparse_offload": (PATHS["local_topk"][0] + [
        "--client_state", "sparse", "--client_state_offload"], LOCAL_TOPK,
        4 * K),
    # each client's error row as a (3, 128) global sketch: the W tables in
    # one segment_sum a round, their decode's top-k in the per-row radix
    # beside the transmit's
    "local_topk_sketched": (_BASE + [
        "--mode", "local_topk", "--error_type", "local", "--local_momentum",
        "0", "--num_clients", "100", "--local_batch_size", "32",
        "--client_state", "sketched"],
        {"rows_hist": 18, "rows_select": 6, "segment_sum": 3}, 4 * K),
    # the aggregate sketched bucket by bucket at 128-aligned offsets: the
    # reference's planner cuts ResNet9 into 3 buckets at K = 4 (two cuts
    # snap to one leaf boundary)
    "sketch_buckets": (HEADLINE + ["--grad_buckets", "4"],
                       dict(RECOVERY, sketch=9), 4 * TABLE_FLOATS),
    # the global scheme: the aggregate's sketch and the survivors'
    # re-sketch through segment_sum, the recovery as the global estimates
    # and the B = 1 radix top-k; a 5 x 500,000 table with no lane padding
    "sketch_global": (HEADLINE + ["--sketch_scheme", "global"],
                      {"segment_sum": 6, "rows_hist": 9, "rows_select": 3},
                      4 * 5 * 500_000),
})
# d of each path's model (ResNet9's elsewhere)
PATH_D = {"fixup9_sketch": D_FIXUP9, "fixup50_imagenet": D_FIXUP50}
# per-row k of the batched parity check: full, an all-zero row, contested
# ties at k/2, and k = 1
KK_ROWS = [K, K, K // 2, 1, K, K, K, K]
# per-row k of the per-row radix's check: KK_ROWS' values and a k = 0 row
KK_RADIX = [K, K, K // 2, 1, 0, K, K, K]
GPT2_FLAGS = ["--model", "gpt2", "--vocab_pad_to", "50262", "--attn_impl",
              "blockwise", "--mode", "sketch", "--error_type", "virtual",
              "--virtual_momentum", "0.9", "--num_workers", "4",
              "--local_batch_size", "8", "--k", "50000", "--num_rows", "5",
              "--num_cols", "500000", "--max_seq_len", "256", "--lr_scale",
              "0.04", "--weight_decay", "0", "--dataset_name",
              "SyntheticPersona", "--device", "cuda"]
D_GPT2 = 124_051_201
# name: (extra flags, attributes set on the parsed namespace, launches over
# 3 rounds). gpt2: 12 layers a round, the sketch of d = 124M one launch a
# round; gpt2_clip: the per-worker path, one forward and backward per
# client (12 layers x 4 clients a round), the 4 clients' tables in one
# batched launch a round; gpt2_tpu_bits: dropout_impl "tpu_bits", which no
# CLI value selects (as in the reference), so 26 hardware-RNG dropout
# sites a forward (the embedding, each layer's attention projection and
# MLP, the mc head; the attention probabilities stay in the flash
# kernels) and 26 in the backward
GPT2_SKETCH = dict(RECOVERY, flash_fwd=36, flash_bwd_dq=36,
                   flash_bwd_dkv=36, sketch=3)
GPT2_PATHS = {
    "gpt2": ([], {}, GPT2_SKETCH),
    "gpt2_clip": (["--max_grad_norm", "1.0"], {},
                  dict(RECOVERY, flash_fwd=144, flash_bwd_dq=144,
                       flash_bwd_dkv=144, sketch_batched=3)),
    "gpt2_tpu_bits": ([], {"dropout_impl": "tpu_bits"},
                      dict(GPT2_SKETCH, hw_dropout=156)),
    # T 512, where --fused_ce auto turns the vocab-chunked LM head on
    "gpt2_t512": (["--max_seq_len", "512"], {}, GPT2_SKETCH),
    # whole GPT2 clients in chunks of 4 dialogs on the per-worker round:
    # 12 layers x 4 clients x 2 chunks a round; the aggregate is sketched
    # once a round
    "gpt2_microbatch": (["--microbatch_size", "4"], {},
                        dict(RECOVERY, flash_fwd=288, flash_bwd_dq=288,
                             flash_bwd_dkv=288, sketch=3)),
    # examples/gpt2_personachat.sh's single-card setting: 64 clients' error
    # and momentum rows as k index/value pairs in host memory (64 x 2 x
    # 400 KB; dense rows on the card would take 2 x 65 x 496 MB), the
    # per-worker round (flash 12 layers x 4 clients a round) and the
    # (4, 124M) radix top-k
    "gpt2_local_topk_sparse_offload": (
        ["--mode", "local_topk", "--error_type", "local", "--local_momentum",
         "0.9", "--client_state", "sparse", "--client_state_offload",
         "--synthetic_personas", "64"], {},
        dict(LOCAL_TOPK, flash_fwd=144, flash_bwd_dq=144,
             flash_bwd_dkv=144)),
}
# upload bytes a client a round: the 5 x 500,096 table, or k floats
GPT2_UPLOAD = {name: 4 * (K if "local_topk" in name else TABLE_FLOATS)
               for name in GPT2_PATHS}
GPT2_WORKERS = 4
FLASH_SHAPE = (768, 256, 64)      # (BH, T, D) of the GPT2 path
# gpt2_clip runs the attention one client at a time: BH = 768 / 4 = 192
FLASH_SHAPE_CLIENT = (FLASH_SHAPE[0] // GPT2_WORKERS,) + FLASH_SHAPE[1:]
# gpt2_t512's training attention (T 512) and its validation batches of 8
# dialogs (dropout off); gpt2_microbatch's chunks of 4 dialogs
FLASH_SHAPE_T512 = (FLASH_SHAPE[0], 512, FLASH_SHAPE[2])
FLASH_SHAPE_T512_VAL = (FLASH_SHAPE_CLIENT[0], 512, FLASH_SHAPE[2])
FLASH_SHAPE_CHUNK = (FLASH_SHAPE[0] // 8,) + FLASH_SHAPE[1:]
# a stage rank's microbatch of 32 sequences (mesh_pp_gpt2), a model rank's
# 6 heads of 64 sequences: BH 384
FLASH_SHAPE_HALF = (FLASH_SHAPE[0] // 2,) + FLASH_SHAPE[1:]
FLASH_RATE = 0.1
# the hardware-RNG dropout's inputs on the GPT2 path: the (64, 256, 768)
# activations at every site but the mc head's (64, 768)
HW_SHAPE = (64, 256, 768)
# a seq rank's activations on mesh_seq_gpt2 (clients=1, seq=2)
SEQ_HW_SHAPE = (64, 128, 768)
HW_RATE = 0.1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor-core peak, dense
REPS = 25


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _time_ms(fn, reps=REPS, setup=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warmup;
    ``setup()`` runs before each call, outside the timed events."""
    import torch
    for _ in range(3):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(nbytes: float, ops: float):
    """(ms, kind): the larger of bytes over HBM rate and operations over
    the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# integer and float operations per (row, coordinate) of the tiled hash:
# the cubic sign polynomial (3 mul + 3 add), the murmur finalizer (2 mul,
# 3 shift, 3 xor), the low-bit test and the select (2); the window read's
# address (2); per (row, block) the two block mixes, modulo and mask (~25)
_OPS_SIGN = 16
_OPS_BLOCK = 25
_OPS_MEDIAN = {1: 0, 3: 4, 5: 10}


def _sketch_cost(cs, B=1):
    """B vectors of length d into B tables: each vector read and each
    table written once; the hashing once (the least the function needs:
    the rows of a batch could share it) plus one add per (batch row, row,
    coordinate)."""
    nbytes = B * (4 * cs.d + 4 * cs.r * cs.c_eff)
    ops = (cs.r * cs.d * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
           + B * cs.r * cs.d)
    return _bound(nbytes, ops)


def _sketch_design(cs, B=1):
    """(bytes, ms at the HBM rate) the kernel itself moves from device
    memory for B rows at most: x r times a row (each row's warps sweep it;
    fewer where the L2 keeps it between sweeps), the r packed window lists
    and the table once a row."""
    nbytes = B * (4 * cs.r * cs.d + 4 * cs.r * cs.nblocks
                  + 4 * cs.r * cs.c_eff)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _device_ms(fn, setup=None, n=20) -> float:
    """Device time of one ``fn()``: ``n`` calls back to back between one
    pair of CUDA events, over ``n``; with ``setup`` (a workspace restore)
    before each call, less the time of ``n`` setups alone."""
    if setup is None:
        return _back_to_back_ms(fn, n)

    def both():
        setup()
        fn()
    return _back_to_back_ms(both, n) - _back_to_back_ms(setup, n)


def _estimate_ops(cs):
    return (cs.d * (cs.r * (_OPS_SIGN + 3) + _OPS_MEDIAN[cs.r] + 1)
            + cs.r * cs.nblocks * _OPS_BLOCK)


def _count_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 4 * 16 + 4 * 16
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 32)


def _select_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 8 + 4 * cs.d + 4 * cs.d
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 4)


# operations a coordinate of the histogram radix, besides the estimate:
# the square, the key's clamp, the prefix test, the digit's shift and mask,
# and the warp-aggregated histogram add
_OPS_RADIX = 6


def _est_hist_cost(cs):
    """The table read and the (d,) estimates written once (plus the first
    digit's 2,048 counters); the estimates' operations and the first
    digit's."""
    return _bound(4 * cs.r * cs.c_eff + 4 * cs.d + 4 * 2048,
                  _estimate_ops(cs) + _OPS_RADIX * cs.d)


def _digit_hist_cost(cs):
    """One digit pass: the stored estimates read once."""
    return _bound(4 * cs.d + 4 * 2048, _OPS_RADIX * cs.d)


def _radix_select_cost(cs, dense):
    """The stored estimates read once; dense: the masked estimates and the
    int32 mask written, else the k values and int64 indices."""
    out = 8 * cs.d if dense else 12 * K
    return _bound(4 * cs.d + out, _OPS_RADIX * cs.d)


def _radix_design_bytes(cs, dense):
    """The bytes the design itself moves in one recovery: the table, the
    scratch written once and read by both digit passes and twice by the
    select (its counts, then the select pass), and the outputs."""
    out = 8 * cs.d if dense else 12 * K
    return 4 * cs.r * cs.c_eff + 5 * 4 * cs.d + out


def _count_plain_cost(rows, n):
    # per element: the square, 16 compares and 16 adds; 16 candidates
    # read and 16 counts written per row
    return _bound(4 * rows * n + 2 * 4 * 16 * rows, rows * n * 33)


def _select_plain_cost(rows, n):
    # the stream read, the masked stream written (no mask); per element
    # the square, two compares, the rank and the select
    return _bound(4 * rows * n * 2 + 12 * rows, rows * n * 6)


def _select_resid_cost(n):
    # (err, v) read, (update, velocity, error) written
    return _bound(4 * n * 5 + 12, n * 8)


def _estimates_cost(cs):
    return _bound(4 * cs.r * cs.c_eff + 4 * cs.d, _estimate_ops(cs))


def _estimates_batched_cost(cs, B):
    """B tables read and B (d,) vectors written once; the window hashes and
    signs once per coordinate for all tables, then r gathers and products
    and the median per (table, coordinate)."""
    ops = (cs.d * cs.r * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
           + B * cs.d * (cs.r + _OPS_MEDIAN[cs.r] + 1))
    return _bound(B * (4 * cs.r * cs.c_eff + 4 * cs.d), ops)


# operations of the hardware-RNG dropout an element: the position's two
# products and sum, the block seed's product and sum, the finalizer's three
# shifts, four xors and two products, the compare, the multiply and the
# select
_OPS_HW = 20


def _hw_dropout_cost(n, itemsize=4):
    """x read and the output written once; the hash an element."""
    return _bound(2 * itemsize * n, _OPS_HW * n)


#: sources first used by the GPT2 phases: their nvcc keeps compiling while
#: the kernel phases at ResNet9's d run (the flash source takes most of
#: the build's time), and ``phase_build_report`` waits for them
LATE_BUILDS = ("flash_attention",)


def phase_build():
    """Every CUDA source (one nvcc each, at once) and, beside them, the
    C++ host data plane (g++); waits for all but ``LATE_BUILDS``."""
    import threading

    from commefficient_tpu_torch import native
    from commefficient_tpu_torch.ops import cuda_lib
    host = {}

    def build_native():
        t = time.perf_counter()
        try:
            native.lib()
        except Exception as e:  # noqa: BLE001 - raised below, in order
            host["error"] = e
        host["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    thread = threading.Thread(target=build_native)
    thread.start()
    started = cuda_lib.start_builds()
    for name in cuda_lib.SOURCES:
        if name not in LATE_BUILDS:
            cuda_lib.wait_build(name)
    thread.join()
    if "error" in host:
        raise host["error"]
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(set(started) - set(LATE_BUILDS)) or 'nothing (cached)'}"
          f"; {[n for n in started if n in LATE_BUILDS]} compiling on; the "
          f"C++ data plane {native.lib_path().name} in {host['s']:.1f} s",
          flush=True)


def phase_build_report():
    """Wait for every build still running (``LATE_BUILDS``), then print
    each build's seconds and the compiler's register and spill listing."""
    from commefficient_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.build_all()
    print(f"build: waited {time.perf_counter() - t0:.1f} s for "
          f"{list(LATE_BUILDS)}; seconds a source "
          f"{ {k: round(v, 1) for k, v in cuda_lib.BUILD_SECONDS.items()} }",
          flush=True)
    for name in cuda_lib.SOURCES:
        log = cuda_lib.BUILD_DIR / f"{name}.log"
        if log.exists():
            kernel = "?"
            for line in log.read_text().splitlines():
                if "Function properties for" in line:
                    kernel = _demangle(line.split(" for ", 1)[1].strip())
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {name} {kernel}: {line.strip()}")


def _demangle(symbol: str) -> str:
    """A kernel's symbol as ``name<template arguments>`` where the machine
    has ``c++filt``, else as it is."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", out)
    return m.group(1) if m else (out or symbol)


def phase_parity(dev, d, errs):
    """Sketch, count, select and the fused unsketch + top-k against their
    plain versions, bitwise, at ``d`` with the main paths' 5 x 500k table
    and k; the largest error of each kernel goes into ``errs``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
                                                            sketch_vec_plain)
    cs = CountSketch(d, 500_000, 5, seed=42)
    rng = np.random.RandomState(0)
    x = (rng.randn(cs.d) * 1e-3).astype(np.float32)
    hot = rng.choice(cs.d, 2 * K, replace=False)
    x[hot] += rng.randn(2 * K).astype(np.float32)
    vec = torch.from_numpy(x).to(dev)
    del x, hot

    table = sketch_vec(cs, vec)
    again = sketch_vec(cs, vec)
    plain = sketch_vec_plain(cs, vec)
    torch.cuda.synchronize()
    if not _same_bits(table, again):
        raise AssertionError("sketch kernel differs between two runs")
    if not _same_bits(table, plain):
        raise AssertionError("sketch kernel != plain version, max abs err "
                             f"{_max_abs_err(table, plain)}")
    off = 1000   # a bucket-style slice placed at block 1000
    part = vec[off * 128: off * 128 + cs.d // 3].contiguous()
    if not _same_bits(sketch_vec(cs, part, off),
                      sketch_vec_plain(cs, part, off)):
        raise AssertionError("sketch kernel != plain version at an offset")
    errs["sketch"] = max(errs.get("sketch", 0.0), _max_abs_err(table, plain))
    del again, plain
    print(f"parity sketch: bitwise equal to plain at d={cs.d}, table "
          f"{cs.r}x{cs.c_eff}, deterministic over 2 runs, offset slice ok",
          flush=True)

    ties = torch.from_numpy(rng.choice(
        np.array([-3, -2, -1, 1, 2, 3], np.float32),
        size=(cs.r, cs.c_eff))).to(dev)
    for name, tab in (("sketched vector", table), ("planted ties", ties)):
        masked, mask = tk.unsketch_select(cs, tab, K)
        p_masked, p_mask = tk.unsketch_select_plain(cs, tab, K)
        if not (_same_bits(masked, p_masked) and _same_bits(mask, p_mask)):
            raise AssertionError(f"unsketch_select != plain ({name})")
        n_sel = int(mask.sum())
        if n_sel != K:
            raise AssertionError(f"selected {n_sel} != k={K} ({name})")
        # the two kernels on their own, at this table's radix candidates
        t, n_take = tk._radix_threshold(
            lambda c: tk.count_plain(cs, tab, c), K, dev)
        for cands in (tk._wrap_i32(torch.arange(16, device=dev) << 28),
                      tk._wrap_i32(t.long() + torch.arange(16, device=dev)
                                   - 8)):
            kc, pc = tk.count(cs, tab, cands), tk.count_plain(cs, tab, cands)
            if not torch.equal(kc, pc):
                raise AssertionError(f"count kernel {kc.tolist()} != plain "
                                     f"{pc.tolist()} ({name})")
            errs["count"] = max(errs.get("count", 0.0), _max_abs_err(kc, pc))
        ks = tk.select(cs, tab, t, n_take)
        ps = tk.select_plain(cs, tab, t, n_take)
        if not (_same_bits(ks[0], ps[0]) and _same_bits(ks[1], ps[1])):
            raise AssertionError(f"select kernel != plain ({name})")
        errs["select"] = max(errs.get("select", 0.0),
                             _max_abs_err(ks[0], ps[0]),
                             _max_abs_err(ks[1], ps[1]))
        print(f"parity unsketch_select ({name}, d={cs.d}): count, select "
              f"and the fused k={K} selection bitwise equal to plain; "
              f"threshold bits {int(t)}, ties taken {int(n_take)}",
              flush=True)
    return cs, vec, table


def _resid_inputs(dev, rng, sparse):
    """(g, vv, ve) at d: 2k ties at |err| = 6 (above all but ~2k normals
    at d = 6.57M, so k = 50k lands in them), or with only 0.6k nonzero
    coordinates and the rest +-0.0, so k selects zeros too."""
    import torch
    g, vv, ve = (rng.randn(D_RESNET9).astype(np.float32) for _ in range(3))
    if sparse:
        zero = rng.permutation(D_RESNET9)[3 * K // 5:]
        for a in (g, vv, ve):
            a[zero] = 0.0
            a[zero[::2]] = -0.0   # err = -0.0 + (-0.0 + 0.9 * -0.0)
    else:
        tie = rng.choice(D_RESNET9, 2 * K, replace=False)
        g[tie], vv[tie], ve[tie] = 6.0, 0.0, 0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (g, vv, ve))


def phase_parity_stream(dev, cs, table, errs):
    """The plain count and select (B = 8, per-row k), the resid select and
    the estimates."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (estimates,
                                                            estimates_plain)
    rng = np.random.RandomState(1)
    x = rng.randn(len(KK_ROWS), D_RESNET9).astype(np.float32)
    x[1] = 0.0                                     # every score ties at 0
    x[2, rng.choice(D_RESNET9, 3 * K, replace=False)] = 3.0
    xs = torch.from_numpy(x).to(dev)
    kk = torch.tensor(KK_ROWS, device=dev)
    t, n_take = tk._radix_threshold_batched(
        lambda c: tk.count_rows_plain(xs, c), kk, dev)
    errs["count_plain"] = errs["select_plain"] = 0.0
    for cands in (tk._wrap_i32(torch.arange(16, device=dev) << 28).expand(
            len(KK_ROWS), 16).contiguous(),
            tk._wrap_i32(t.long()[:, None] + torch.arange(16, device=dev)
                         - 8)):
        kc, pc = tk.count_rows(xs, cands), tk.count_rows_plain(xs, cands)
        if not torch.equal(kc, pc):
            raise AssertionError("count_plain kernel != plain version")
        errs["count_plain"] = max(errs["count_plain"], _max_abs_err(kc, pc))
    for with_mask in (True, False):
        ks = tk.select_rows(xs, t, n_take, with_mask)
        ps = tk.select_rows_plain(xs, t, n_take, with_mask)
        if not _same_bits(ks[0], ps[0]) or (
                with_mask and not _same_bits(ks[1], ps[1])):
            raise AssertionError("select_plain kernel != plain version")
        errs["select_plain"] = max(errs["select_plain"],
                                   _max_abs_err(ks[0], ps[0]))
    sums = ks[0].ne(0).sum(1).tolist()
    mask_sums = tk.select_rows(xs, t, n_take, True)[1].sum(1)
    if not torch.equal(mask_sums, kk):
        raise AssertionError(f"per-row selections {mask_sums.tolist()} "
                             f"!= kk {KK_ROWS}")
    if not _same_bits(tk.topk_select(xs, kk, K), ps[0]):
        raise AssertionError("topk_select != plain selection")
    print(f"parity count_plain/select_plain (8 x {D_RESNET9}, kk "
          f"{KK_ROWS}): bitwise equal to plain, with and without mask; "
          f"nonzeros kept {sums}, ties taken {n_take.tolist()}", flush=True)
    del ks, ps

    errs["select_resid"] = 0.0
    for name, sparse in (("planted ties", False), ("selected +-0.0", True)):
        g, vv, ve = _resid_inputs(dev, rng, sparse)
        v = g + 0.9 * vv
        err = ve + v
        t1, n1 = tk._radix_threshold(
            lambda c: tk.count_rows_plain(err[None], c[None])[0], K, dev)
        got = tk.select_resid(err, v, t1, n1)
        ref = tk.select_resid_plain(err, v, t1, n1)
        fused = tk.fused_true_topk(g, vv, ve, K, 0.9)
        for a, b, c in zip(got, ref, fused):
            if not (_same_bits(a, b) and _same_bits(c, b)):
                raise AssertionError(f"select_resid != plain ({name})")
            errs["select_resid"] = max(errs["select_resid"],
                                       _max_abs_err(a, b))
        upd = got[0]
        kept_neg0 = int(((upd == 0) & torch.signbit(upd)
                         & torch.signbit(got[2])).sum())
        if sparse and kept_neg0 == 0:
            raise AssertionError("no selected -0.0 kept its residual")
        print(f"parity select_resid ({name}): update, velocity, error "
              f"bitwise equal to plain and to fused_true_topk; ties taken "
              f"{int(n1)}, selected -0.0 kept {kept_neg0}", flush=True)
    inputs = {"xs": xs, "kk": kk, "t": t, "n_take": n_take, "err": err,
              "v": v, "t1": t1, "n1": n1}

    est = estimates(cs, table)
    p_est = estimates_plain(cs, table)
    masked, mask = tk.unsketch_select(cs, table, K)
    sel = mask.bool()
    if not _same_bits(est, p_est) or not _same_bits(masked[sel], est[sel]):
        raise AssertionError("estimates kernel != plain / fused selection")
    errs["estimates"] = _max_abs_err(est, p_est)
    print(f"parity estimates: bitwise equal to plain at d={cs.d}, and to "
          f"the fused selection's {int(sel.sum())} masked values",
          flush=True)
    return inputs


def phase_server_ab(dev, cs, table, pairs=10):
    """One sketch-mode server step with --server_fused auto against off:
    update, Vvelocity and Verror bitwise equal; then ``pairs`` alternating
    timings of the two steps (each the median of 5 CUDA-event timings)."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.server import (make_sketch,
                                                          server_update)
    from commefficient_tpu_torch.federated.state import ServerOptState
    rng = np.random.RandomState(2)
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=K, num_cols=cs.c,
                    num_rows=cs.r).finalize(cs.d)
    sketch = make_sketch(cfg)
    state = ServerOptState(*(torch.from_numpy(
        rng.randn(*cfg.transmit_shape).astype(np.float32)).to(dev)
        for _ in range(2)))
    cfgs = {f: replace(cfg, server_fused=f) for f in ("auto", "off")}
    (ua, sa), (uo, so) = (server_update(table, state, cfgs[f], 0.1, sketch)
                          for f in ("auto", "off"))
    if not (_same_bits(ua, uo) and _same_bits(sa.Vvelocity, so.Vvelocity)
            and _same_bits(sa.Verror, so.Verror)):
        raise AssertionError(f"server step (d={cs.d}): --server_fused auto "
                             "!= off")
    nonzeros = int(ua.ne(0).sum())
    del ua, sa, uo, so
    ms = {"auto": [], "off": []}
    for i in range(pairs):
        for f in (("auto", "off") if i % 2 == 0 else ("off", "auto")):
            ms[f].append(_time_ms(lambda c=cfgs[f]: server_update(
                table, state, c, 0.1, sketch), reps=5))
    wins = sum(a < o for a, o in zip(ms["auto"], ms["off"]))
    print(f"server A/B (sketch, d={cs.d}, k={K}): --server_fused auto and "
          f"off give bitwise equal update ({nonzeros} nonzeros), Vvelocity "
          f"and Verror; {pairs} alternating pairs of one server step: auto "
          f"median {float(np.median(ms['auto'])):.4f} ms, off median "
          f"{float(np.median(ms['off'])):.4f} ms, auto faster in {wins} of "
          f"{pairs}; auto {[round(x, 4) for x in ms['auto']]}, off "
          f"{[round(x, 4) for x in ms['off']]}", flush=True)
    torch.cuda.empty_cache()


def phase_parity_batched(dev, d, B, errs):
    """The batched sketch of a seeded (B, d) batch (row 1 all zero, row 2
    with 2k planted heavy coordinates) and of an offset slice of it, row by
    row bitwise equal to its plain version and to the unbatched kernel,
    and the same over two runs. Returns ``(cs, vecs)``."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.ops.sketch_kernels import (
        sketch_vec, sketch_vec_batched, sketch_vec_batched_plain)
    cs = CountSketch(d, 500_000, 5, seed=42)
    gen = torch.Generator(device=dev).manual_seed(B)
    vecs = torch.randn(B, d, generator=gen, device=dev) * 1e-3
    vecs[1] = 0.0
    hot = torch.randperm(d, generator=gen, device=dev)[:2 * K]
    vecs[2, hot] += torch.randn(2 * K, generator=gen, device=dev)
    del hot
    off = 1000    # a bucket-style slice placed at block 1000
    part = vecs[:, off * 128: off * 128 + d // 3].contiguous()
    for tag, x, o in (("", vecs, 0), (f", offset block {off}", part, off)):
        got = sketch_vec_batched(cs, x, o)
        again = sketch_vec_batched(cs, x, o)
        torch.cuda.synchronize()
        if not _same_bits(got, again):
            raise AssertionError(f"sketch_batched differs between two runs"
                                 f" (B={B}, d={d}{tag})")
        for b in range(B):
            plain = sketch_vec_batched_plain(cs, x[b:b + 1], o)[0]
            one = sketch_vec(cs, x[b], o)
            if not (_same_bits(got[b], plain) and _same_bits(got[b], one)):
                raise AssertionError(
                    f"sketch_batched row {b} != plain / unbatched kernel "
                    f"(B={B}, d={d}{tag}), max abs err "
                    f"{_max_abs_err(got[b], plain)}")
            errs["sketch_batched"] = max(errs.get("sketch_batched", 0.0),
                                         _max_abs_err(got[b], plain))
            del plain, one
        if got[1].any():
            raise AssertionError("sketch_batched: the all-zero row's table "
                                 "is not zero")
        del got, again
    del part
    print(f"parity sketch_batched (B={B}, d={d}, table {cs.r}x{cs.c_eff}): "
          f"every row bitwise equal to plain and to the unbatched kernel, "
          f"an all-zero row and a planted row included, offset slice ok, "
          f"deterministic over 2 runs", flush=True)
    return cs, vecs


def phase_timing_batched(cs, vecs, plain_reps=REPS):
    """Times of the batched sketch beside its plain version, B launches of
    the unbatched kernel, one ``index_add_`` per row at precomputed
    buckets (the library call) and the bound."""
    import torch

    from commefficient_tpu_torch.ops.sketch_kernels import (
        sketch_vec, sketch_vec_batched, sketch_vec_batched_plain)
    B, d = vecs.shape
    dev = vecs.device
    buckets, signs = [], []
    for row in range(cs.r):
        s, b = cs._row_hashes(row, torch.arange(d, device=dev))
        buckets.append(b + row * cs.c_eff)
        signs.append(s)
    buckets, signs = torch.cat(buckets), torch.cat(signs)
    signed = [signs * vecs[b].repeat(cs.r) for b in range(B)]
    del signs
    flat = torch.zeros(B, cs.r * cs.c_eff, device=dev)

    def library():
        for b in range(B):
            flat[b].index_add_(0, buckets, signed[b])

    r = dict(
        ms=_time_ms(lambda: sketch_vec_batched(cs, vecs)),
        device_ms=_device_ms(lambda: sketch_vec_batched(cs, vecs)),
        plain_ms=_time_ms(lambda: sketch_vec_batched_plain(cs, vecs),
                          plain_reps),
        library_ms=_time_ms(library),
        unbatched_ms=_time_ms(lambda: [sketch_vec(cs, vecs[b])
                                       for b in range(B)]),
        cost=_sketch_cost(cs, B), at=f"B={B}, d={d}")
    del buckets, signed, flat
    torch.cuda.empty_cache()
    bound_ms, kind = r["cost"]
    design_b, design_ms = _sketch_design(cs, B)
    print(f"time sketch_batched ({r['at']}): kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f} ms a call, 20 back to back), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
          f"{B} unbatched calls {r['unbatched_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({kind}); the design's bytes at most "
          f"{design_b:,} ({design_ms:.5f} ms: x {cs.r} times a row)",
          flush=True)
    print(f"  library: sketch_batched = {B} index_add_ calls, one per row, "
          f"of the {cs.r}x{d} signed values at precomputed buckets "
          f"(scatter only, atomic order)", flush=True)
    return r


def phase_timing(cs, vec, table, plain_reps=REPS):
    """Times of the sketch, count and select kernels at ``cs.d`` beside
    their plain versions (median of ``plain_reps``), the library calls and
    the bound."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
                                                            sketch_vec_plain)
    dev = vec.device
    t, n_take = tk._radix_threshold(lambda c: tk.count(cs, table, c), K, dev)
    cands = tk._wrap_i32(t.long() + torch.arange(16, device=dev) - 8)
    est = cs.estimates(table)
    scores = est * est
    # the same scatter as one library call, hashes precomputed: the
    # sketch's index_add_ yardstick (scatter only, atomic order)
    buckets, signed = [], []
    for row in range(cs.r):
        s, b = cs._row_hashes(row, torch.arange(cs.d, device=dev))
        buckets.append(b + row * cs.c_eff)
        signed.append(s * vec)
    buckets, signed = torch.cat(buckets), torch.cat(signed)
    flat = torch.zeros(cs.r * cs.c_eff, device=dev)
    topk_ms = _time_ms(lambda: torch.topk(scores, K))
    rows = {
        "sketch": dict(
            ms=_time_ms(lambda: sketch_vec(cs, vec)),
            device_ms=_device_ms(lambda: sketch_vec(cs, vec)),
            plain_ms=_time_ms(lambda: sketch_vec_plain(cs, vec),
                              plain_reps),
            library_ms=_time_ms(lambda: flat.index_add_(0, buckets, signed)),
            cost=_sketch_cost(cs)),
        "count": dict(
            ms=_time_ms(lambda: tk.count(cs, table, cands)),
            plain_ms=_time_ms(lambda: tk.count_plain(cs, table, cands),
                              plain_reps),
            library_ms=topk_ms, cost=_count_cost(cs)),
        "select": dict(
            ms=_time_ms(lambda: tk.select(cs, table, t, n_take)),
            plain_ms=_time_ms(lambda: tk.select_plain(cs, table, t, n_take),
                              plain_reps),
            library_ms=topk_ms, cost=_select_cost(cs)),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back)" if "device_ms" in r else "")
        print(f"time {name} (d={cs.d}): kernel {r['ms']:.4f} ms{dev_ms}, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind})",
              flush=True)
    design_b, design_ms = _sketch_design(cs)
    print(f"  sketch: the design's bytes at most {design_b:,} "
          f"({design_ms:.5f} ms: x {cs.r} times, once a row's sweep)",
          flush=True)
    print(f"  library: sketch = index_add_ of the {cs.r}x{cs.d} signed "
          f"values at precomputed buckets (scatter only); count, select = "
          f"torch.topk(k={K}) of the (d,) squared estimates (selection "
          f"only, for the count+select pair)", flush=True)
    return rows


def phase_timing_stream(cs, table, inputs):
    """Times of the plain/resid count and select kernels at the main
    paths' shapes (B = 8 for local_topk, B = 1 for true_topk) and of the
    estimates kernel."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (estimates,
                                                            estimates_plain)
    xs, t, n_take = inputs["xs"], inputs["t"], inputs["n_take"]
    err, v, t1, n1 = inputs["err"], inputs["v"], inputs["t1"], inputs["n1"]
    B, n = xs.shape
    dev = xs.device
    cands = tk._wrap_i32(t.long()[:, None] + torch.arange(16, device=dev)
                         - 8)
    err_rows = err[None]
    cands1 = tk._wrap_i32(t1.long() + torch.arange(16, device=dev)
                          - 8)[None]
    scores8, scores1 = xs * xs, err * err
    topk_b8 = _time_ms(lambda: torch.topk(scores8, K, dim=-1))
    topk_b1 = _time_ms(lambda: torch.topk(scores1, K))
    rows = {
        "count_plain": dict(
            ms=_time_ms(lambda: tk.count_rows(xs, cands)),
            plain_ms=_time_ms(lambda: tk.count_rows_plain(xs, cands)),
            library_ms=topk_b8, cost=_count_plain_cost(B, n),
            at=f"B={B}, n={n}"),
        "count_plain_b1": dict(
            ms=_time_ms(lambda: tk.count_rows(err_rows, cands1)),
            plain_ms=_time_ms(lambda: tk.count_rows_plain(err_rows, cands1)),
            library_ms=topk_b1, cost=_count_plain_cost(1, n),
            at=f"B=1, n={n}"),
        "select_plain": dict(
            ms=_time_ms(lambda: tk.select_rows(xs, t, n_take)),
            plain_ms=_time_ms(lambda: tk.select_rows_plain(xs, t, n_take)),
            library_ms=topk_b8, cost=_select_plain_cost(B, n),
            at=f"B={B}, n={n}, no mask"),
        "select_resid": dict(
            ms=_time_ms(lambda: tk.select_resid(err, v, t1, n1)),
            plain_ms=_time_ms(lambda: tk.select_resid_plain(err, v, t1, n1)),
            library_ms=topk_b1, cost=_select_resid_cost(n),
            at=f"n={n}"),
        "estimates": dict(
            ms=_time_ms(lambda: estimates(cs, table)),
            device_ms=_device_ms(lambda: estimates(cs, table)),
            plain_ms=_time_ms(lambda: estimates_plain(cs, table)),
            library_ms=None, cost=_estimates_cost(cs),
            at=f"{cs.r}x{cs.c_eff} -> {cs.d}; no main path launches this "
               "unbatched grid: --server_fused off takes estimates_batched "
               "at B=1, as the reference does"),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back)" if "device_ms" in r else "")
        print(f"time {name} ({r['at']}): kernel {r['ms']:.4f} ms{dev_ms}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: count_plain, select_plain = torch.topk(k={K}, "
          f"dim=-1) of the 8 rows' squares; count_plain_b1, select_resid = "
          f"torch.topk(k={K}) of err's squares (selection only, for the "
          f"count+select pair); estimates: no single library call",
          flush=True)
    return rows


def phase_parity_estimates_batched(dev, cs, table, errs):
    """The batched estimates of 8 tables (the sketched table of phase 2,
    an all-zero one, seeded normals) at B = 8, 3 (a partial tile of 8) and
    1, each table bitwise equal to the unbatched kernel and to the plain
    version, and the same over two runs. Returns the 8 tables."""
    import torch

    from commefficient_tpu_torch.ops.sketch_kernels import (
        estimates, estimates_batched, estimates_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    tables = torch.randn((8, cs.r, cs.c_eff), generator=gen, device=dev)
    tables[0] = table
    tables[1] = 0.0
    errs["estimates_batched"] = 0.0
    for B in (8, 3, 1):
        got = estimates_batched(cs, tables[:B])
        again = estimates_batched(cs, tables[:B])
        torch.cuda.synchronize()
        if not _same_bits(got, again):
            raise AssertionError(f"estimates_batched differs between two "
                                 f"runs (B={B})")
        for b in range(B):
            plain = estimates_plain(cs, tables[b])
            if not (_same_bits(got[b], plain)
                    and _same_bits(got[b], estimates(cs, tables[b]))):
                raise AssertionError(
                    f"estimates_batched table {b} != plain / unbatched "
                    f"kernel (B={B}), max abs err "
                    f"{_max_abs_err(got[b], plain)}")
            errs["estimates_batched"] = max(errs["estimates_batched"],
                                            _max_abs_err(got[b], plain))
        del got, again
    print(f"parity estimates_batched (B = 8, 3, 1, d={cs.d}): every table "
          f"bitwise equal to plain and to the unbatched kernel, the "
          f"sketched table and an all-zero one included, deterministic "
          f"over 2 runs", flush=True)
    return tables


def phase_timing_estimates_batched(cs, table, tables):
    """Times of the batched estimates at B = 8 beside its plain version
    and 8 launches of the unbatched kernel, and at B = 1 beside the
    unbatched kernel (row 4)."""
    from commefficient_tpu_torch.ops.sketch_kernels import (
        estimates, estimates_batched, estimates_batched_plain)
    B = tables.shape[0]
    one = table[None]
    r = dict(
        ms=_time_ms(lambda: estimates_batched(cs, tables)),
        device_ms=_device_ms(lambda: estimates_batched(cs, tables)),
        plain_ms=_time_ms(lambda: estimates_batched_plain(cs, tables)),
        library_ms=None,
        unbatched_ms=_time_ms(lambda: [estimates(cs, t) for t in tables]),
        b1_ms=_time_ms(lambda: estimates_batched(cs, one)),
        b1_device_ms=_device_ms(lambda: estimates_batched(cs, one)),
        row4_ms=_time_ms(lambda: estimates(cs, table)),
        cost=_estimates_batched_cost(cs, B),
        at=f"B={B}, {cs.r}x{cs.c_eff} -> {cs.d}")
    bound_ms, kind = r["cost"]
    print(f"time estimates_batched ({r['at']}): kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f} ms a call, 20 back to back), "
          f"plain {r['plain_ms']:.4f} ms, library none, {B} unbatched "
          f"launches {r['unbatched_ms']:.4f} ms, bound {bound_ms:.5f} ms "
          f"({kind}); at B=1 {r['b1_ms']:.4f} ms (device "
          f"{r['b1_device_ms']:.4f} ms) against the unbatched kernel's "
          f"{r['row4_ms']:.4f} ms (bound "
          f"{_estimates_batched_cost(cs, 1)[0]:.5f} ms)", flush=True)
    return r


def _radix_tables(dev, cs, table):
    """The tables of the radix parity: the sketched vector's, planted ties
    (few distinct magnitudes, ties spread over every tile), all zero, and
    seeded normals with +-0.0 and NaN cells."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(cs.d % 1000)
    ties = torch.tensor([-3, -2, -1, 1, 2, 3], dtype=torch.float32,
                        device=dev)[torch.randint(
                            6, (cs.r, cs.c_eff), generator=gen, device=dev)]
    nan0 = torch.randn((cs.r, cs.c_eff), generator=gen, device=dev)
    u = torch.rand((cs.r, cs.c_eff), generator=gen, device=dev)
    nan0[u < 0.3] = 0.0
    nan0[(u >= 0.3) & (u < 0.5)] = -0.0
    nan0[u > 0.99995] = float("nan")
    return {"sketched vector": table, "planted ties": ties,
            "all zero": torch.zeros_like(table), "+-0.0 and NaN": nan0}


def phase_parity_radix(dev, cs, table, errs):
    """The estimate-once histogram radix against its plain versions at
    ``cs.d``, bitwise, on each table of ``_radix_tables``: the stored
    estimates, each pass's digit histogram, t and n_take (also against the
    first port's count kernels' radix), the dense and the compact select;
    then both entry points again, bitwise equal to the first run."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    for name in ("est_hist", "digit_hist", "radix_select", "radix_compact"):
        errs.setdefault(name, 0.0)
    for name, tab in _radix_tables(dev, cs, table).items():
        est, ws = tk.unsketch_radix(cs, tab, K)
        dense = tk.radix_select(est, cs.d, K, ws, dense=True)
        compact = tk.radix_select(est, cs.d, K, ws, dense=False)
        views = tk.radix_views(ws)
        p_est = cs.estimates(tab)
        if not _same_bits(est[:cs.d], p_est):
            raise AssertionError(f"est_hist estimates != plain ({name}, "
                                 f"d={cs.d})")
        bits = tk._score_bits(p_est)
        prefix = torch.zeros((), dtype=torch.int64, device=dev)
        k_rem = prefix + K
        for p, ((shift, width), hist) in enumerate(zip(tk.DIGITS,
                                                       views["hists"])):
            want = tk.digit_histogram_plain(bits, prefix, shift, width)
            if not torch.equal(hist, want):
                raise AssertionError(f"digit histogram of pass {p} != "
                                     f"plain ({name}, d={cs.d})")
            key = "est_hist" if p == 0 else "digit_hist"
            errs[key] = max(errs[key], _max_abs_err(hist, want))
            b, above = tk.digit_pick_plain(want, k_rem)
            prefix, k_rem = (prefix << width) | b, k_rem - above
        t, n_take = tk.radix_threshold_plain(bits, K)
        del bits
        got = (int(views["t"]), int(views["n_take"]))
        ct, cn = tk._radix_threshold(lambda c: tk.count(cs, tab, c), K, dev)
        if got != (int(t), int(n_take)) or got != (int(ct), int(cn)):
            raise AssertionError(f"radix (t, n_take) {got} != plain "
                                 f"{(int(t), int(n_take))} / count kernels' "
                                 f"{(int(ct), int(cn))} ({name}, d={cs.d})")
        p_dense = tk._select_est(p_est, t, n_take)
        p_compact = tk.select_compact_plain(p_est, t, n_take, K)
        if not (_same_bits(dense[0], p_dense[0])
                and torch.equal(dense[1], p_dense[1])):
            raise AssertionError(f"radix_select != plain ({name}, "
                                 f"d={cs.d})")
        if not (_same_bits(compact[0], p_compact[0])
                and torch.equal(compact[1], p_compact[1])):
            raise AssertionError(f"radix_compact != plain ({name}, "
                                 f"d={cs.d})")
        errs["radix_select"] = max(errs["radix_select"],
                                   _max_abs_err(dense[0], p_dense[0]),
                                   _max_abs_err(dense[1], p_dense[1]))
        errs["radix_compact"] = max(errs["radix_compact"],
                                    _max_abs_err(compact[0], p_compact[0]),
                                    _max_abs_err(compact[1], p_compact[1]))
        del p_est, p_dense, p_compact, est, ws
        again = tk.unsketch_select(cs, tab, K)
        if not (_same_bits(again[0], dense[0])
                and torch.equal(again[1], dense[1])):
            raise AssertionError(f"unsketch_select differs between two runs "
                                 f"({name}, d={cs.d})")
        del again
        again = tk.unsketch_compact(cs, tab, K)
        if not (_same_bits(again[0], compact[0])
                and torch.equal(again[1], compact[1])):
            raise AssertionError(f"unsketch_compact differs between two "
                                 f"runs ({name}, d={cs.d})")
        kept = int(dense[1].sum())
        del again, dense, compact
        print(f"parity radix ({name}, d={cs.d}, k={K}): stored estimates, "
              f"the 3 digit histograms, t {got[0]}, n_take {got[1]} (= the "
              f"count kernels' radix), dense and compact selects bitwise "
              f"equal to plain, deterministic over 2 runs; {kept} kept",
              flush=True)
    torch.cuda.empty_cache()


def phase_timing_radix(cs, table, pairs=20):
    """Times of the histogram radix at ``cs.d``: each kernel alone (its
    workspace restored outside the timed events) beside its plain version
    and bound; the whole recovery, compact and dense, against the first
    port's count x 9 + select as ``pairs`` alternating rounds in this
    process (each side the median of 25 timings); ``torch.topk`` of the
    squared estimates, and ``estimates_batched`` + ``torch.topk``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import estimates_batched
    dev, d = table.device, cs.d
    est, ws = tk.radix_workspace(d, dev)
    snaps = []
    tk.est_hist(cs, table, K, est, ws)
    snaps.append(ws.clone())
    for p in (1, 2):
        tk.digit_hist(est, d, K, ws, p)
        snaps.append(ws.clone())
    p_est = cs.estimates(table)
    bits = tk._score_bits(p_est)
    prefixes = [torch.zeros((), dtype=torch.int64, device=dev)]
    k_rem = prefixes[0] + K
    for shift, width in tk.DIGITS:
        b, above = tk.digit_pick_plain(tk.digit_histogram_plain(
            bits, prefixes[-1], shift, width), k_rem)
        prefixes.append((prefixes[-1] << width) | b)
        k_rem = k_rem - above
    t, n_take = tk.radix_threshold_plain(bits, K)
    scores = p_est * p_est
    del bits

    def restore(i):
        return lambda: ws.copy_(snaps[i])

    def plain_pass(p):
        shift, width = tk.DIGITS[p]
        est_ = cs.estimates(table) if p == 0 else p_est
        hist = tk.digit_histogram_plain(tk._score_bits(est_), prefixes[p],
                                        shift, width)
        return tk.digit_pick_plain(hist, K)

    topk_ms = _time_ms(lambda: torch.topk(scores, K))
    est_topk_ms = _time_ms(lambda: torch.topk(
        torch.square(estimates_batched(cs, table[None])[0]), K))
    digit_ms = [_time_ms(lambda p=p: tk.digit_hist(est, d, K, ws, p),
                         setup=restore(p - 1)) for p in (1, 2)]
    plain_reps = REPS if d < 2 * 10 ** 7 else 3
    rows = {
        "est_hist": dict(
            ms=_time_ms(lambda: tk.est_hist(cs, table, K, est, ws),
                        setup=ws.zero_),
            device_ms=_device_ms(lambda: tk.est_hist(cs, table, K, est, ws),
                                 setup=ws.zero_),
            plain_ms=_time_ms(lambda: plain_pass(0), plain_reps),
            library_ms=None, cost=_est_hist_cost(cs)),
        "digit_hist": dict(
            ms=float(np.mean(digit_ms)),
            plain_ms=float(np.mean([_time_ms(lambda p=p: plain_pass(p),
                                             plain_reps) for p in (1, 2)])),
            library_ms=None, cost=_digit_hist_cost(cs),
            at=f"d={d}; mean of pass 1 {digit_ms[0]:.4f} ms and pass 2 "
               f"{digit_ms[1]:.4f} ms"),
        "radix_compact": dict(
            ms=_time_ms(lambda: tk.radix_select(est, d, K, ws, False),
                        setup=restore(2)),
            plain_ms=_time_ms(lambda: tk.select_compact_plain(
                p_est, t, n_take, K), plain_reps),
            library_ms=topk_ms, cost=_radix_select_cost(cs, False)),
        "radix_select": dict(
            ms=_time_ms(lambda: tk.radix_select(est, d, K, ws, True),
                        setup=restore(2)),
            plain_ms=_time_ms(lambda: tk._select_est(p_est, t, n_take),
                              plain_reps),
            library_ms=topk_ms, cost=_radix_select_cost(cs, True)),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back, less 20 workspace restores)" if "device_ms" in r
                  else "")
        print(f"time {name} ({r.get('at', f'd={d}')}): kernel "
              f"{r['ms']:.4f} ms{dev_ms}, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {bound_ms:.5f} ms ({kind})",
              flush=True)
    del snaps, p_est, scores

    def old():
        t_, n_ = tk._radix_threshold(lambda c: tk.count(cs, table, c), K,
                                     dev)
        return tk.select(cs, table, t_, n_)

    sides = {"old": old,
             "new_dense": lambda: tk.unsketch_select(cs, table, K),
             "new_compact": lambda: tk.unsketch_compact(cs, table, K)}
    ms = {name: [] for name in sides}
    names = list(sides)
    for i in range(pairs):
        order = names if i % 2 == 0 else names[::-1]
        for name in order:
            ms[name].append(_time_ms(sides[name]))
    med = {name: float(np.median(v)) for name, v in ms.items()}
    ratio = [o / n for o, n in zip(ms["old"], ms["new_dense"])]
    pair_bound = sum(r["cost"][0] for r in
                     (rows["est_hist"], rows["digit_hist"],
                      rows["digit_hist"], rows["radix_compact"]))
    design_ms = max(_radix_design_bytes(cs, False) / HBM_BYTES_PER_S * 1e3,
                    (_estimate_ops(cs) + 5 * _OPS_RADIX * d)
                    / CUDA_CORE_OPS_PER_S * 1e3)
    print(f"time recovery (d={d}, k={K}, {pairs} alternating rounds): new "
          f"compact {med['new_compact']:.4f} ms, new dense "
          f"{med['new_dense']:.4f} ms, old count x 9 + select "
          f"{med['old']:.4f} ms (old / new dense: median "
          f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
          f"{max(ratio):.3f}); torch.topk of the squared estimates "
          f"{topk_ms:.4f} ms, estimates_batched + torch.topk "
          f"{est_topk_ms:.4f} ms; bound of the compact recovery "
          f"{pair_bound:.5f} ms (sum of its kernels' bounds; the design's "
          f"own bytes and operations {design_ms:.5f} ms)", flush=True)
    print(f"  rounds: new compact {[round(x, 4) for x in ms['new_compact']]},"
          f" new dense {[round(x, 4) for x in ms['new_dense']]}, old "
          f"{[round(x, 4) for x in ms['old']]}", flush=True)
    del est, ws
    torch.cuda.empty_cache()
    return rows


def _rows_stream(dev):
    """The (8, d) stream of the per-row radix's check, one row per case:
    seeded normals (rows 0, 3, 4, 6, 7), all zero (1), 3k planted ties at
    3.0 (2, k/2 among them), normals with 30% +0.0, 20% -0.0 and 1% NaN
    (5)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((len(KK_RADIX), D_RESNET9), generator=gen, device=dev)
    x[1] = 0.0
    x[2, torch.randperm(D_RESNET9, generator=gen, device=dev)[:3 * K]] = 3.0
    u = torch.rand(D_RESNET9, generator=gen, device=dev)
    x[5, u < 0.3] = 0.0
    x[5, (u >= 0.3) & (u < 0.5)] = -0.0
    x[5, u > 0.99] = float("nan")
    return x


def _check_rows_radix(tag, x, kk, ws, errs):
    """A ``rows_radix`` workspace against the plain versions, per row:
    each pass's histograms, t and n_take. Returns the plain (t, n_take)."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    views = tk.rows_views(ws)
    bits = tk._score_bits(x)
    prefix, k_rem = torch.zeros_like(kk), kk
    for p, ((shift, width), hist) in enumerate(zip(tk.DIGITS,
                                                   views["hists"])):
        want = tk.digit_histogram_plain(bits, prefix, shift, width)
        if not torch.equal(hist, want):
            raise AssertionError(f"rows_hist pass {p} histograms != plain "
                                 f"({tag})")
        errs["rows_hist"] = max(errs["rows_hist"], _max_abs_err(hist, want))
        b, above = tk.digit_pick_plain(want, k_rem)
        prefix, k_rem = (prefix << width) | b, k_rem - above
    t, n_take = tk.radix_threshold_rows_plain(bits, kk)
    if not (torch.equal(views["t"], t)
            and torch.equal(views["n_take"], n_take)):
        raise AssertionError(f"rows_hist (t, n_take) {views['t'].tolist()}, "
                             f"{views['n_take'].tolist()} != plain "
                             f"{t.tolist()}, {n_take.tolist()} ({tag})")
    return t, n_take


def phase_parity_rows(dev, errs):
    """The per-row histogram radix (the plain and resid sources' route)
    against its plain versions at ResNet9's d, bitwise: at
    B = 8 with ``KK_RADIX`` over random, all-zero, planted-tie and
    NaN-bearing rows, each pass's per-row histograms, t and n_take, the
    select with and without the mask; at B = 1 the resid select over
    ``_resid_inputs`` (planted ties; selected +-0.0); every entry point
    twice, bitwise equal. Returns the timing phase's inputs."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    for name in ("rows_hist", "rows_select", "rows_resid"):
        errs.setdefault(name, 0.0)
    xs = _rows_stream(dev)
    kk = torch.tensor(KK_RADIX, device=dev)
    ws = tk.rows_radix(xs, kk)
    t, n_take = _check_rows_radix(f"B=8, kk {KK_RADIX}", xs, kk, ws, errs)
    for with_mask in (True, False):
        got = tk.rows_select(xs, ws, with_mask)
        ref = tk.select_rows_plain(xs, t, n_take, with_mask)
        if not _same_bits(got[0], ref[0]) or (
                with_mask and not torch.equal(got[1], ref[1])):
            raise AssertionError(f"rows_select != plain (mask {with_mask})")
        errs["rows_select"] = max(errs["rows_select"],
                                  _max_abs_err(got[0], ref[0]))
    kept = ref[0].ne(0).sum(1).tolist()
    again = tk.topk_select(xs, kk, K, with_mask=True)
    if not (_same_bits(again[0], ref[0]) and torch.equal(
            again[1], tk.select_rows_plain(xs, t, n_take, True)[1])):
        raise AssertionError("topk_select differs from its first run / the "
                             "plain selection")
    taken = again[1].sum(1).tolist()
    print(f"parity rows_hist/rows_select (8 x {D_RESNET9}, kk {KK_RADIX}; "
          f"random, all-zero, planted ties, NaN rows): per-pass histograms, "
          f"t {t.tolist()}, n_take {n_take.tolist()} and the select with "
          f"and without mask bitwise equal to plain, deterministic over 2 "
          f"runs; selected {taken}, nonzeros kept {kept}", flush=True)
    del again, got, ref, ws

    rng = np.random.RandomState(12)
    kk1 = torch.full((1,), K, dtype=torch.int64, device=dev)
    for name, sparse in (("planted ties", False), ("selected +-0.0", True)):
        g, vv, ve = _resid_inputs(dev, rng, sparse)
        v = g + 0.9 * vv
        err = ve + v
        ws1 = tk.rows_radix(err[None], kk1)
        t1, n1 = _check_rows_radix(f"B=1, {name}", err[None], kk1, ws1, errs)
        got = tk.rows_resid(err, v, ws1)
        ref = tk.select_resid_plain(err, v, t1[0], n1[0])
        fused = tk.fused_true_topk(g, vv, ve, K, 0.9)
        for a, b, c in zip(got, ref, fused):
            if not (_same_bits(a, b) and _same_bits(c, b)):
                raise AssertionError(f"rows_resid != plain / fused_true_topk"
                                     f" ({name})")
            errs["rows_resid"] = max(errs["rows_resid"], _max_abs_err(a, b))
        print(f"parity rows_hist/rows_resid (B=1, n={D_RESNET9}, k={K}, "
              f"{name}): histograms, t {int(t1[0])}, n_take {int(n1[0])}, "
              f"update, velocity and error bitwise equal to plain and to a "
              f"second run through fused_true_topk", flush=True)
    return {"xs": xs, "kk": kk, "err": err, "v": v, "kk1": kk1}


def _rows_hist_cost(rows, n):
    """One digit pass: the stream read once, the rows' histograms
    written."""
    return _bound(4 * rows * n + 4 * rows * 2048, _OPS_RADIX * rows * n)


def _time_rows_passes(x, kk, plain_reps=REPS):
    """Each digit pass alone (its workspace restored outside the timed
    events) and its plain version: ``(ms [3], plain ms [3], ws after the
    last pass)``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    ws = tk.rows_workspace(x.shape[0], x.device)
    snaps = [ws.clone()]
    for p in range(3):
        tk.rows_hist(x, kk, ws, p)
        snaps.append(ws.clone())
    bits = tk._score_bits(x)
    prefixes, k_rem = [torch.zeros_like(kk)], kk
    for shift, width in tk.DIGITS:
        b, above = tk.digit_pick_plain(tk.digit_histogram_plain(
            bits, prefixes[-1], shift, width), k_rem)
        prefixes.append((prefixes[-1] << width) | b)
        k_rem = k_rem - above
    ms = [_time_ms(lambda p=p: tk.rows_hist(x, kk, ws, p),
                   setup=lambda p=p: ws.copy_(snaps[p])) for p in range(3)]

    def plain_pass(p):
        shift, width = tk.DIGITS[p]
        return tk.digit_pick_plain(tk.digit_histogram_plain(
            tk._score_bits(x), prefixes[p], shift, width), kk)

    plain = [_time_ms(lambda p=p: plain_pass(p), plain_reps)
             for p in range(3)]
    ws.copy_(snaps[3])
    return ms, plain, ws


def _alternate(sides, pairs):
    """``pairs`` alternating rounds of every side (each the median of 25
    CUDA-event timings): ``{side: [ms a round]}``."""
    ms = {name: [] for name in sides}
    names = list(sides)
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            ms[name].append(_time_ms(sides[name]))
    return ms


def _report_route(tag, ms, bound_ms, design_ms):
    med = {name: float(np.median(v)) for name, v in ms.items()}
    ratio = [o / n for o, n in zip(ms["old"], ms["new"])]
    print(f"time {tag} ({len(ms['new'])} alternating rounds): new "
          f"{med['new']:.4f} ms, old (nibble glue + count_plain x 9 + "
          f"select) {med['old']:.4f} ms (old / new: median "
          f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
          f"{max(ratio):.3f}), torch.topk of the squares {med['topk']:.4f} "
          f"ms; bound of the function {bound_ms:.5f} ms, of the design's "
          f"own bytes {design_ms:.5f} ms", flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(x, 4) for x in v]}" for name, v in ms.items()),
          flush=True)
    return med


def phase_timing_rows(inputs, pairs=20):
    """Times of the per-row radix at the main paths' shapes: each digit
    pass, the select (B = 8, no mask: local_topk's call) and the resid
    select (B = 1: true_topk's) beside their plain versions and bounds;
    then the whole top-k by the new route, by the first port's (nibble
    glue, count_plain x 9, select_plain or select_resid) and
    ``torch.topk`` of the squares as ``pairs`` alternating rounds, at
    B = 8 and B = 1."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    xs, kk = inputs["xs"], inputs["kk"]
    err, v, kk1 = inputs["err"], inputs["v"], inputs["kk1"]
    B, n = xs.shape
    dev = xs.device
    err_rows = err[None]
    pass_ms, pass_plain, ws = _time_rows_passes(xs, kk)
    pass1_ms, pass1_plain, ws1 = _time_rows_passes(err_rows, kk1)
    views, views1 = tk.rows_views(ws), tk.rows_views(ws1)
    t, n_take = views["t"], views["n_take"]
    t1, n1 = views1["t"][0], views1["n_take"][0]
    scores8, scores1 = xs * xs, err * err
    topk_b8 = _time_ms(lambda: torch.topk(scores8, K, dim=-1))
    topk_b1 = _time_ms(lambda: torch.topk(scores1, K))
    rows = {
        "rows_hist": dict(
            ms=float(np.mean(pass_ms)), plain_ms=float(np.mean(pass_plain)),
            library_ms=topk_b8, cost=_rows_hist_cost(B, n),
            at=f"B={B}, n={n}, mean of the 3 passes: pass 0 "
               f"{pass_ms[0]:.4f} ms, 1 {pass_ms[1]:.4f}, 2 "
               f"{pass_ms[2]:.4f}; B=1: {pass1_ms[0]:.4f}, "
               f"{pass1_ms[1]:.4f}, {pass1_ms[2]:.4f} (plain "
               f"{float(np.mean(pass1_plain)):.4f}, bound "
               f"{_rows_hist_cost(1, n)[0]:.5f})"),
        "rows_select": dict(
            ms=_time_ms(lambda: tk.rows_select(xs, ws)),
            plain_ms=_time_ms(lambda: tk.select_rows_plain(xs, t, n_take)),
            library_ms=topk_b8, cost=_select_plain_cost(B, n),
            at=f"B={B}, n={n}, no mask; counts, scan and select"),
        "rows_resid": dict(
            ms=_time_ms(lambda: tk.rows_resid(err, v, ws1)),
            plain_ms=_time_ms(lambda: tk.select_resid_plain(err, v, t1, n1)),
            library_ms=topk_b1, cost=_select_resid_cost(n),
            at=f"B=1, n={n}; counts, scan and select"),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} ({r['at']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: rows_hist, rows_select = torch.topk(k={K}, dim=-1) "
          f"of the 8 rows' squares; rows_resid = torch.topk(k={K}) of err's "
          f"squares (selection only, for the whole top-k)", flush=True)
    del ws, ws1

    def old8():
        t_, n_ = tk._radix_threshold_batched(lambda c: tk.count_rows(xs, c),
                                             kk, dev)
        return tk.select_rows(xs, t_, n_)

    med8 = _report_route(
        f"top-k (B={B}, n={n}, kk {KK_RADIX})",
        _alternate({"new": lambda: tk.topk_select(xs, kk, K), "old": old8,
                    "topk": lambda: torch.topk(scores8, K, dim=-1)}, pairs),
        _select_plain_cost(B, n)[0],
        6 * 4 * B * n / HBM_BYTES_PER_S * 1e3)
    rows["rows_select"]["at"] += (f"; whole top-k {med8['new']:.4f} ms, old "
                                  f"route {med8['old']:.4f}")
    med1 = _time_rows_b1(err, v, kk1, scores1, pairs)
    rows["rows_resid"]["at"] += (f"; whole top-k {med1['new']:.4f} ms, old "
                                 f"route {med1['old']:.4f}")
    torch.cuda.empty_cache()
    return rows


def _time_rows_b1(err, v, kk1, scores1, pairs):
    """true_topk's whole top-k at B = 1, new against old route and
    ``torch.topk``, ``pairs`` alternating rounds; the momentum read, the
    same on both routes, is left out."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    err_rows = err[None]
    n = err.shape[0]

    def old1():
        t_, n_ = tk._radix_threshold_batched(
            lambda c: tk.count_rows(err_rows, c), kk1, err.device)
        return tk.select_resid(err, v, t_[0], n_[0])

    return _report_route(
        f"top-k (B=1, n={n}, k={K}, resid)",
        _alternate({"new": lambda: tk.rows_resid(
            err, v, tk.rows_radix(err_rows, kk1)), "old": old1,
            "topk": lambda: torch.topk(scores1, K)}, pairs),
        _select_resid_cost(n)[0], 4 * n * 9 / HBM_BYTES_PER_S * 1e3)


def phase_timing_rows_b1(dev, d, pairs=20):
    """The B = 1 resid top-k at the GPT2 path's d (no main path runs
    true_topk there): a seeded (err, v) pair, parity of the new route with
    the plain versions, then the alternating rounds of ``_time_rows_b1``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    gen = torch.Generator(device=dev).manual_seed(13)
    err = torch.randn(d, generator=gen, device=dev)
    v = torch.randn(d, generator=gen, device=dev)
    kk1 = torch.full((1,), K, dtype=torch.int64, device=dev)
    ws1 = tk.rows_radix(err[None], kk1)
    t1, n1 = _check_rows_radix(f"B=1, n={d}", err[None], kk1, ws1,
                               {"rows_hist": 0.0})
    got = tk.rows_resid(err, v, ws1)
    ref = tk.select_resid_plain(err, v, t1[0], n1[0])
    if not all(_same_bits(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"rows_resid != plain (n={d})")
    del got, ref, ws1
    ms, plain, _ = _time_rows_passes(err[None], kk1, plain_reps=3)
    print(f"parity rows_hist/rows_resid (B=1, n={d}, k={K}): bitwise equal "
          f"to plain; passes {ms[0]:.4f}, {ms[1]:.4f}, {ms[2]:.4f} ms "
          f"(plain {float(np.mean(plain)):.4f}, bound "
          f"{_rows_hist_cost(1, d)[0]:.5f} a pass)", flush=True)
    _time_rows_b1(err, v, kk1, err * err, pairs)
    del err, v
    torch.cuda.empty_cache()


def phase_sketch_sparse(dev, cs, table):
    """The deterministic sparse re-sketch on the card: the k survivors of
    the sketched table, three of them planted in one row-0 bucket with
    signed 1e8, 1, -1e8 (a sum that depends on the order), bitwise equal
    to the CPU's table over two runs; timed beside ``index_add_`` a row
    (atomic order)."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    vals, idxs = cs.unsketch_values_indices(table, K)
    signs, buckets = cs._row_hashes(0, idxs)
    b, counts = torch.unique(buckets, return_counts=True)
    three = torch.nonzero(buckets == b[counts >= 3][0]).flatten()[:3]
    vals = vals.clone()
    vals[three] = torch.tensor([1e8, 1.0, -1e8], device=dev) * signs[three]
    cpu = cs.sketch_sparse(vals.cpu(), idxs.cpu())
    before = cuda_lib.LAUNCHES["segment_sum"]
    got = cs.sketch_sparse(vals, idxs)
    again = cs.sketch_sparse(vals, idxs)
    if cuda_lib.LAUNCHES["segment_sum"] != before + 2:
        raise AssertionError("sketch_sparse did not launch segment_sum")
    if not (_same_bits(got.cpu(), cpu) and _same_bits(again, got)):
        raise AssertionError(f"sketch_sparse on the card != CPU or differs "
                             f"between runs (d={cs.d})")
    hot = got.view(-1)[buckets[three[0]]]

    def atomic():
        out = cs.zero_table(dev)
        for row in range(cs.r):
            s_, b_ = cs._row_hashes(row, idxs)
            out[row].index_add_(0, b_, s_ * vals)
        return out

    ms = _time_ms(lambda: cs.sketch_sparse(vals, idxs))
    lib_ms = _time_ms(atomic)
    print(f"parity sketch_sparse (d={cs.d}, {K} survivors, 3 planted in one "
          f"bucket as 1e8, 1, -1e8 -> {float(hot)!r}): card bitwise equal "
          f"to the CPU, deterministic over 2 runs; {ms:.4f} ms (sort + "
          f"segment_sum) against {lib_ms:.4f} ms with index_add_ atomics",
          flush=True)


def phase_repeat(dev):
    """Reproducibility of the headline sketch path (ROADMAP C5): two runs
    of 3 rounds through ``training.cv.train`` from the same seed must give
    bitwise equal per-round losses, weights, Vvelocity and Verror. Then
    what deterministic cuDNN costs: one ResNet9 forward and backward at
    the path's batch (8 workers x 32 images), called directly, with
    ``torch.backends.cudnn.deterministic`` False, then True. Returns the
    run's (losses, weights, Vvelocity, Verror, (upload, download) bytes a
    round)."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.models.resnet9 import ResNet9
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    runs = []
    for _ in range(2):
        args = build_parser().parse_args(HEADLINE)
        np.random.seed(args.seed)
        learner, row = train(args, max_rounds=3, log=False)
        s = learner.state
        runs.append(([r["loss"] for r in row["rounds"]],
                     s.weights.clone(), s.opt.Vvelocity.clone(),
                     s.opt.Verror.clone()))
        nbytes = [(r["upload_bytes"], r["download_bytes"])
                  for r in row["rounds"]]
        del learner, row, s
    (la, *ta), (lb, *tb) = runs
    same = [_same_bits(a, b) for a, b in zip(ta, tb)]
    if [x.hex() for x in la] != [x.hex() for x in lb] or not all(same):
        raise AssertionError(f"the sketch path is not reproducible: losses "
                             f"{la} vs {lb}; weights, Vvelocity, Verror "
                             f"bitwise equal: {same}")
    ref = (la, *ta, nbytes)
    del runs, ta, tb
    torch.cuda.empty_cache()
    model = ResNet9().reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((8 * 32, 32, 32, 3), generator=gen, device=dev)
    y = torch.randint(10, (8 * 32,), generator=gen, device=dev)

    def step():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()

    ms = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        ms[det] = _time_ms(step)
    torch.backends.cudnn.deterministic = True
    print(f"repeat sketch (3 rounds twice, same seed): losses "
          f"{[round(v, 6) for v in la]}, losses, weights, Vvelocity and "
          f"Verror bitwise equal; ResNet9 forward + backward (256 images): "
          f"cudnn.deterministic False {ms[False]:.4f} ms, True "
          f"{ms[True]:.4f} ms", flush=True)
    del model, x, y
    torch.cuda.empty_cache()
    return ref


def phase_hw_dropout_parity(dev, errs):
    """The hardware-RNG dropout kernel against its plain version, bitwise:
    the GPT2 path's (64, 256, 768) at rates 0.1 and 0.5, the mc head's
    (64, 768), a (300, 1024) view whose second logical block is partial,
    and bfloat16; each run twice, bitwise equal. Then the reference's
    on-device contract at (512, 1024), rate 0.1: keep fraction within
    5e-3 of 0.9, kept values exactly f32(1/0.9), the gradient of the sum
    equal to the output, a second seed differing in over 10%."""
    import torch

    from commefficient_tpu_torch.ops.dropout import (fold_in, hw_dropout,
                                                     hw_dropout_plain,
                                                     seed_words)
    cases = [(HW_SHAPE, torch.float32, HW_RATE),
             (HW_SHAPE, torch.float32, 0.5),
             ((64, 768), torch.float32, HW_RATE),
             ((300, 1024), torch.float32, HW_RATE),
             ((16, 256, 768), torch.bfloat16, HW_RATE),
             # a seq rank's block (mesh_seq_gpt2: T 128 of 256)
             (SEQ_HW_SHAPE, torch.float32, HW_RATE)]
    gen = torch.Generator(device=dev).manual_seed(8)
    errs["hw_dropout"] = 0.0
    for i, (shape, dtype, rate) in enumerate(cases):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        seeds = seed_words(fold_in(8, i))
        got = hw_dropout(x, seeds, rate)
        again = hw_dropout(x, seeds, rate)
        plain = hw_dropout_plain(x, seeds, rate)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), again.view(bits)):
            raise AssertionError(f"hw_dropout differs between two runs "
                                 f"({shape}, {dtype}, rate {rate})")
        if got.dtype != dtype or not torch.equal(got.view(bits),
                                                 plain.view(bits)):
            raise AssertionError(f"hw_dropout != plain ({shape}, {dtype}, "
                                 f"rate {rate}), max abs err "
                                 f"{_max_abs_err(got, plain)}")
        errs["hw_dropout"] = max(errs["hw_dropout"], _max_abs_err(got, plain))
        print(f"parity hw_dropout ({tuple(shape)}, {dtype}, rate {rate}): "
              f"bitwise equal to plain, deterministic over 2 runs, keep "
              f"fraction {float((got != 0).double().mean()):.6f}",
              flush=True)
        del x, got, again, plain

    ones = torch.ones((512, 1024), device=dev, requires_grad=True)
    y = hw_dropout(ones, seed_words(7), HW_RATE)
    (g,) = torch.autograd.grad(y.sum(), ones)
    y = y.detach()
    keep = float((y != 0).double().mean())
    scale = float(np.float32(1.0 / (1.0 - HW_RATE)))
    kept = y[y != 0]
    differ = float((hw_dropout(ones.detach(), seed_words(8), HW_RATE)
                    != y).double().mean())
    exact = torch.equal(kept, torch.full_like(kept, scale))
    same_mask = torch.equal(g, y)
    if abs(keep - (1.0 - HW_RATE)) >= 5e-3 or not exact or not same_mask \
            or differ <= 0.1:
        raise AssertionError(f"hw_dropout contract: keep {keep}, scaling "
                             f"exact {exact}, grad = output {same_mask}, "
                             f"second seed differs in {differ}")
    print(f"contract hw_dropout ((512, 1024), rate {HW_RATE}): keep "
          f"fraction {keep:.6f}, kept values exactly {scale!r}, backward "
          f"mask = forward mask, a second seed differs in {differ:.4f}",
          flush=True)


def _back_to_back_ms(fn, n=200) -> float:
    """Device time of one ``fn()``: ``n`` calls back to back between one
    pair of CUDA events, over ``n``. The host's work before each launch
    hides behind the device while it is shorter than the kernel."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _host_us(fn, n=200) -> float:
    """Host time of one ``fn()`` in microseconds: ``n`` calls in a row
    on the host's clock, over ``n``, the device idle at the start so
    that no launch waits for a full queue."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return host / n * 1e6


def phase_hw_dropout_timing(dev, pairs=20):
    """The hardware-RNG dropout's call against
    ``torch.nn.functional.dropout`` (the library row) at the GPT2 path's
    activation shape and at the mc head's, as ``pairs`` alternating
    rounds (each side the median of 25 CUDA-event timings of one call, so
    the host's work before the launch counts); each one's device time
    alone (``_back_to_back_ms``) and host time (``_host_us``); the plain
    version and the bound. Every
    input needs a gradient, as the training path's activations do, so
    both calls record their autograd node as they do there."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops.dropout import (hw_dropout,
                                                     hw_dropout_plain,
                                                     seed_words)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(HW_SHAPE, generator=gen, device=dev)
    mc = x[:, 0].contiguous().requires_grad_(True)
    x.requires_grad_(True)
    seeds = seed_words(1234)
    hw = lambda a: (lambda: hw_dropout(a, seeds, HW_RATE))
    lib = lambda a: (lambda: F.dropout(a, HW_RATE, training=True))
    ms = _alternate({"hw": hw(x), "lib": lib(x), "hw_mc": hw(mc),
                     "lib_mc": lib(mc)}, pairs)
    med = {name: float(np.median(v)) for name, v in ms.items()}
    at = f"{HW_SHAPE}, f32 with requires_grad, rate {HW_RATE}"
    r = dict(ms=med["hw"], library_ms=med["lib"],
             plain_ms=_time_ms(lambda: hw_dropout_plain(x.detach(), seeds,
                                                        HW_RATE)),
             device_ms=_back_to_back_ms(hw(x)),
             cost=_hw_dropout_cost(x.numel()), at=at)
    lib_device_ms = _back_to_back_ms(lib(x))
    mc_device_ms = (_back_to_back_ms(hw(mc)), _back_to_back_ms(lib(mc)))
    host_us = {name: _host_us(fn) for name, fn in (
        ("hw", hw(x)), ("lib", lib(x)), ("hw_mc", hw(mc)),
        ("lib_mc", lib(mc)))}
    bound_ms, kind = r["cost"]
    ratio = [a / b for a, b in zip(ms["lib"], ms["hw"])]
    print(f"time hw_dropout ({at}; {pairs} alternating rounds of one "
          f"call): kernel {r['ms']:.4f} ms, F.dropout {r['library_ms']:.4f} "
          f"ms (F.dropout / hw_dropout: median {float(np.median(ratio)):.3f},"
          f" min {min(ratio):.3f}, max {max(ratio):.3f}); device time alone "
          f"{r['device_ms']:.4f} ms, F.dropout's {lib_device_ms:.4f} ms; "
          f"plain {r['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind}); "
          f"at the mc head's {tuple(mc.shape)} {med['hw_mc']:.4f} ms, "
          f"F.dropout {med['lib_mc']:.4f} ms, device time alone "
          f"{mc_device_ms[0]:.4f} and {mc_device_ms[1]:.4f} ms; host time "
          f"of a call (us): " + ", ".join(
              f"{name} {v:.2f}" for name, v in host_us.items()), flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(v, 4) for v in vals]}" for name, vals in ms.items()),
          flush=True)
    print("  library: hw_dropout = torch.nn.functional.dropout(x, "
          f"{HW_RATE}, training=True) at the same shape (its own bits)",
          flush=True)
    return r


class _ScalarLRProbe:
    """Records, for every round of a run, the recovered top-k
    (``CountSketch.unsketch_values_indices``) and the server's update
    (the round's ``server_update``), which is the recovered values times
    the round's per-coordinate lr. Adds no launch."""

    def __enter__(self):
        from commefficient_tpu_torch.federated import round as round_mod
        from commefficient_tpu_torch.ops.countsketch import CountSketch
        self.recovered, self.updates = [], []
        self._saved = [(CountSketch, "unsketch_values_indices",
                        CountSketch.unsketch_values_indices),
                       (round_mod, "server_update", round_mod.server_update)]
        unsketch, server_update = (f for _, _, f in self._saved)

        def recover(cs, *args, **kwargs):
            self.recovered.append(unsketch(cs, *args, **kwargs))
            return self.recovered[-1]

        def update(*args, **kwargs):
            out = server_update(*args, **kwargs)
            self.updates.append(out[0])
            return out

        CountSketch.unsketch_values_indices = recover
        round_mod.server_update = update
        return self

    def __exit__(self, *exc):
        for owner, attr, f in self._saved:
            setattr(owner, attr, f)

    def ratio(self, scalar):
        """(rate of the Fixup scalars, rate of the other coordinates):
        update / recovered value on the recovered coordinates of the last
        round that recovered a scalar."""
        for (vals, idxs), upd in zip(reversed(self.recovered),
                                     reversed(self.updates)):
            keep = vals != 0
            vals, idxs = vals[keep], idxs[keep]
            on_scalar = scalar[idxs]
            if bool(on_scalar.any()) and not bool(on_scalar.all()):
                rate = upd[idxs] / vals
                return (float(rate[on_scalar].mean()),
                        float(rate[~on_scalar].mean()))
        raise AssertionError("no round recovered a Fixup scalar")


class _KdistProbe:
    """Records, for every local top-k of a run, each row's nonzeros in and
    out and its budget (``client.topk``), and each cohort's drawn budgets
    (``api.cohort_client_ks``). The counts read the device; it adds no
    launch."""

    def __enter__(self):
        from commefficient_tpu_torch.federated import api, client
        self.tops, self.draws = [], []
        self._saved = [(client, "topk", client.topk),
                       (api, "cohort_client_ks", api.cohort_client_ks)]
        topk, draw = (f for _, _, f in self._saved)

        def top(vec, k, row_k=None, use_kernel=None):
            out = topk(vec, k, row_k=row_k, use_kernel=use_kernel)
            self.tops.append(((vec != 0).sum(-1).cpu(),
                              (out != 0).sum(-1).cpu(),
                              None if row_k is None else row_k.cpu()))
            return out

        def cohort(seed, ids, *args, **kwargs):
            ks = draw(seed, ids, *args, **kwargs)
            self.draws.append((np.array(ids), ks.copy()))
            return ks

        client.topk = top
        api.cohort_client_ks = cohort
        return self

    def __exit__(self, *exc):
        for owner, attr, f in self._saved:
            setattr(owner, attr, f)

    def check(self, seed):
        """Each transmit's support is min(k_i, nnz) with k_i from a fresh
        ``cohort_client_ks`` of the round's ids; returns the budgets."""
        from commefficient_tpu_torch.federated.faults import cohort_client_ks
        if len(self.tops) != len(self.draws) or not self.draws:
            raise AssertionError("local_topk_kdist: the probe saw "
                                 f"{len(self.tops)} top-ks for "
                                 f"{len(self.draws)} cohorts")
        for (nnz_in, nnz_out, row_k), (ids, ks) in zip(self.tops,
                                                        self.draws):
            fresh = cohort_client_ks(seed, ids, K, KDIST)
            if not (np.array_equal(fresh, ks)
                    and np.array_equal(row_k.numpy(), ks)
                    and np.array_equal(nnz_out.numpy(), np.minimum(
                        ks, nnz_in.numpy()))
                    and len(set(ks.tolist())) > 1):
                raise AssertionError(
                    f"local_topk_kdist: budgets {ks} (fresh {fresh}, "
                    f"passed {row_k.tolist()}), nonzeros in "
                    f"{nnz_in.tolist()}, out {nnz_out.tolist()}")
        return [ks.tolist() for _, ks in self.draws]


def phase_path(name):
    """One main path: 3 full-width rounds through ``training.cv.train``
    with every launch counter zeroed just before and read just after.
    On fixup9_sketch, also the rate the Fixup scalars moved at against the
    convolutions' (0.1, the default ``--scalar_lr_factor``); on
    local_topk_kdist, each client's transmit support against its budget
    (``_KdistProbe``)."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    flags, want, per_client = PATHS[name]
    d = PATH_D.get(name, D_RESNET9)
    args = build_parser().parse_args(flags)
    np.random.seed(args.seed)
    probe = {"fixup9_sketch": _ScalarLRProbe,
             "local_topk_kdist": _KdistProbe}.get(name, nullcontext)()
    torch.cuda.reset_peak_memory_stats()
    with probe:
        cuda_lib.LAUNCHES.clear()
        learner, row = train(args, max_rounds=3, log=False)
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    rounds = row["rounds"]
    if len(rounds) != 3:
        raise AssertionError(f"{name}: ran {len(rounds)} rounds, expected 3")
    w = learner.state.weights
    if learner.cfg.grad_size != d or w.shape != (d,):
        raise AssertionError(f"{name}: d = {learner.cfg.grad_size}, "
                             f"expected {d}")
    if not all(math.isfinite(r["loss"]) for r in rounds) \
            or not bool(torch.isfinite(w).all()) \
            or not math.isfinite(row["test_loss"]):
        raise AssertionError(f"{name}: non-finite loss or weights")
    # the first round has all the workers (the epoch tail may have fewer);
    # the byte counters are float32, as the reference's, so 7 x 4 d of
    # fixup50_imagenet reads rounded to float32's step of 64 there
    clients = [args.num_workers] + [round(r["upload_bytes"] / per_client)
                                    for r in rounds[1:]]
    if any(r["upload_bytes"] != float(np.float32(n * per_client))
           for n, r in zip(clients, rounds)) or not all(
               1 <= n <= args.num_workers for n in clients):
        raise AssertionError(f"{name}: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]} are "
                             f"not {per_client} per client")
    extra = ""
    if name == "fixup9_sketch":
        scalar = learner.lr_scale_vec != 1.0
        rates = probe.ratio(scalar)
        if int(scalar.sum()) != 23 or not math.isclose(
                rates[0] / rates[1], 0.1, rel_tol=1e-5):
            raise AssertionError(f"{name}: {int(scalar.sum())} scalars "
                                 f"moved at {rates[0]} against {rates[1]}")
        extra = (f", Fixup scalars moved at {rates[0]:.6g} against "
                 f"{rates[1]:.6g} (ratio {rates[0] / rates[1]:.6f})")
    if name == "local_topk_kdist":
        extra = f", budgets a round {probe.check(args.seed)}"
    if learner.host_store is not None:
        extra += (f", host arenas {learner.host_store.nbytes()} B, "
                  f"pipeline {learner._offload_pipe.stats}")
    changed = int((learner.state.last_changed >= 0).sum())
    print(f"path {name}: d = {d}, launches {launches}, losses "
          f"{[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, upload B "
          f"{[int(r['upload_bytes']) for r in rounds]}, test_loss "
          f"{row['test_loss']:.6f}, {changed} weights changed, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{extra}",
          flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


class _FlushEachRound:
    """Makes ``training.cv.train``'s rounds flush the offload pipeline
    after each one (the synchronous writeback), by flushing after every
    ``finalize_round_metrics``."""

    def __enter__(self):
        from commefficient_tpu_torch.federated.api import FedLearner
        self._saved = FedLearner.finalize_round_metrics

        def finalize(learner, raw):
            out = self._saved(learner, raw)
            learner.flush_offload()
            return out
        FedLearner.finalize_round_metrics = finalize
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.federated.api import FedLearner
        FedLearner.finalize_round_metrics = self._saved


class _RoundTables:
    """Records each round's aggregate (the server's ``gradient``: the
    sketched table in sketch mode) and, where the round sketches it
    whole, the dense aggregate it sketched."""

    def __enter__(self):
        from commefficient_tpu_torch.federated import round as round_mod
        from commefficient_tpu_torch.ops.countsketch import CountSketch
        self.tables, self.dense = [], []
        self._saved = [(round_mod, "server_update", round_mod.server_update),
                       (CountSketch, "sketch_vec", CountSketch.sketch_vec)]
        server_update, sketch_vec = (f for _, _, f in self._saved)

        def update(gradient, *args, **kwargs):
            self.tables.append(gradient.clone())
            return server_update(gradient, *args, **kwargs)

        def sketch(cs, vec):
            self.dense.append(vec.clone())
            return sketch_vec(cs, vec)
        round_mod.server_update = update
        CountSketch.sketch_vec = sketch
        return self

    def __exit__(self, *exc):
        for owner, attr, f in self._saved:
            setattr(owner, attr, f)


def _cv_run(flags, context=None, rounds=3):
    """``rounds`` rounds of ``training.cv.train`` with ``flags``:
    (learner, row)."""
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    args = build_parser().parse_args(flags)
    np.random.seed(args.seed)
    with context or nullcontext():
        return train(args, max_rounds=rounds, log=False)


def _rows_of(learner):
    """Every client's stored rows, field by field, as CPU trees: the
    device storage without its sink row, or the host arenas."""
    from torch.utils._pytree import tree_map
    out = {}
    for field in ("velocities", "errors", "weights"):
        if learner.host_store is not None:
            view = learner.host_store.view(field)
            out[field] = (None if view is None
                          else learner.host_store.arena(field))
        else:
            rows = getattr(learner.state.clients, field)
            out[field] = (None if rows is None else tree_map(
                lambda t: t[:-1].cpu(), rows))
    return out


def _same_trees(a, b) -> bool:
    from torch.utils._pytree import tree_flatten
    if a is None or b is None:
        return a is b
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(_same_bits(x, y) for x, y in zip(la, lb))


def _assert_same_runs(tag, a, b):
    """Two runs' losses, bytes, weights, server state and every client's
    rows bitwise equal."""
    (la, ra), (lb, rb) = a, b
    for x, y in zip(ra["rounds"], rb["rounds"]):
        if (x["loss"].hex(), x["upload_bytes"], x["download_bytes"]) != (
                y["loss"].hex(), y["upload_bytes"], y["download_bytes"]):
            raise AssertionError(f"{tag}: round {x} != {y}")
    for what, x, y in (("weights", la.state.weights, lb.state.weights),
                       ("Vvelocity", la.state.opt.Vvelocity,
                        lb.state.opt.Vvelocity),
                       ("client_last_round", la.state.client_last_round,
                        lb.state.client_last_round)):
        if not _same_bits(x, y):
            raise AssertionError(f"{tag}: {what} differ")
    rows_a, rows_b = _rows_of(la), _rows_of(lb)
    for field in rows_a:
        if not _same_trees(rows_a[field], rows_b[field]):
            raise AssertionError(f"{tag}: the clients' {field} differ")


def phase_offload_parity():
    """The offloaded rows against the device-resident ones and the
    bucketed transmits against the whole, 3 full-width rounds from one
    seed each, in this process: local_topk against local_topk_offload and
    sparse client state on the card against sparse offload (losses,
    bytes, weights, every client's rows bitwise); sparse offload at depth
    2 against the same run flushed after every round (bitwise); true_topk
    against --grad_buckets 4 (bitwise); sketch against sketch_buckets:
    round 1's loss bitwise, round 1's table within the float32
    association bound of the whole table, the bytes exact."""
    import torch
    local = PATHS["local_topk"][0]
    sparse = ["--client_state", "sparse"]
    offload = ["--client_state_offload"]

    def pair(tag, flags_a, flags_b, ctx_b=None):
        a = _cv_run(flags_a)
        b = _cv_run(flags_b, ctx_b)
        _assert_same_runs(tag, a, b)
        stats = [ln._offload_pipe.stats for ln, _ in (a, b)
                 if ln._offload_pipe is not None]
        print(f"offload parity {tag}: losses "
              f"{[round(r['loss'], 6) for r in a[1]['rounds']]}, weights, "
              f"bytes and every client's rows bitwise equal; pipeline "
              f"{stats}", flush=True)
        del a, b
        torch.cuda.empty_cache()

    pair("local_topk vs local_topk_offload", local, local + offload)
    pair("sparse on the card vs sparse offload", local + sparse,
         local + sparse + offload)
    pair("sparse offload depth 2 vs flushed every round",
         local + sparse + offload, local + sparse + offload,
         _FlushEachRound())
    true_topk = PATHS["true_topk"][0]
    a, b = _cv_run(true_topk), _cv_run(true_topk + ["--grad_buckets", "4"])
    if b[0].grad_buckets is None:
        raise AssertionError("true_topk --grad_buckets 4: no bucket plan")
    _assert_same_runs("true_topk vs --grad_buckets 4", a, b)
    print(f"offload parity true_topk vs --grad_buckets 4 "
          f"({b[0].grad_buckets.num_buckets} buckets at "
          f"{list(b[0].grad_buckets.offsets)}): weights bitwise equal",
          flush=True)
    del a, b
    whole, parts = _RoundTables(), _RoundTables()
    a = _cv_run(HEADLINE, whole)
    b = _cv_run(HEADLINE + ["--grad_buckets", "4"], parts)
    ra, rb = a[1]["rounds"], b[1]["rounds"]
    if ra[0]["loss"].hex() != rb[0]["loss"].hex() or parts.dense:
        raise AssertionError("sketch_buckets: round 1's loss differs, or "
                             "the bucketed round sketched a whole vector")
    if any((x["upload_bytes"], x["download_bytes"]) != (
            y["upload_bytes"], y["download_bytes"]) for x, y in zip(ra, rb)):
        raise AssertionError("sketch_buckets: bytes differ")
    # each cell's sum over its m terms, associated bucket by bucket: both
    # sums within (m - 1) u sum|x_i| of the exact one, u = 2**-24
    from commefficient_tpu_torch.federated.server import make_sketch
    cs = make_sketch(a[0].cfg)
    agg = whole.dense[0]
    _, buckets = cs._row_hashes(None, torch.arange(agg.shape[0],
                                                    device=agg.device))
    keys = (buckets + torch.arange(cs.r, device=agg.device)[:, None]
            * cs.c_eff).flatten()
    abs_sum = torch.zeros(cs.r * cs.c_eff, dtype=torch.float64,
                          device=agg.device).index_add_(
        0, keys, agg.abs().double().repeat(cs.r))
    terms = torch.bincount(keys, minlength=cs.r * cs.c_eff).double()
    bound = 2 * torch.clamp(terms - 1, min=0) * 2.0 ** -24 * abs_sum
    diff = (parts.tables[0].double() - whole.tables[0].double()).abs()
    diff = diff.flatten()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"sketch_buckets: round 1's table off by "
                             f"{float(diff.max())} beyond the bound")
    share = float((diff / bound.clamp(min=1e-45)).max())
    print(f"offload parity sketch vs sketch_buckets: round 1 loss "
          f"{ra[0]['loss']:.6f} bitwise, its table within the association "
          f"bound (largest difference {float(diff.max()):.3e}, its largest "
          f"share of the bound {share:.4f}, {int((diff != 0).sum())} of "
          f"{diff.numel()} cells differ), bytes equal", flush=True)
    del a, b, whole, parts
    torch.cuda.empty_cache()


# the sketch path's launches a round
SKETCH_ROUND = {k: v // 3 for k, v in dict(RECOVERY, sketch=3).items()}
SCAN_K = 4
SCAN_ROUNDS = 8
# examples/cifar10_fetchsgd.sh's flags (its --num_epochs 24 aside: the
# phase stops after CIFAR_ROUNDS rounds and one validation pass)
CIFAR_FLAGS = ["--dataset_name", "CIFAR10", "--model", "ResNet9", "--mode",
               "sketch", "--error_type", "virtual", "--virtual_momentum",
               "0.9", "--num_clients", "100", "--num_workers", "8",
               "--local_batch_size", "32", "--k", "50000", "--num_rows", "5",
               "--num_cols", "500000", "--pivot_epoch", "5", "--lr_scale",
               "0.4", "--scan_rounds", "8", "--device", "cuda"]
CIFAR_ROUNDS = 16


class _SyncWatch:
    """Records the host syncs that the CUDA sync debug mode reports inside
    each ``FedLearner.train_rounds_scan`` call (the K rounds' dispatch,
    not the read of their metrics), each with the Python frames that made
    it."""

    def __enter__(self):
        import traceback
        import warnings

        import torch

        from commefficient_tpu_torch.federated.api import FedLearner
        self._saved = FedLearner.train_rounds_scan
        self.windows, self.syncs = 0, []
        saved = self._saved

        def show(message, category, *args, **kwargs):
            if "synchronizing CUDA operation" in str(message):
                frames = traceback.format_stack(limit=6)[:-1]
                self.syncs.append(" | ".join(
                    f.strip().splitlines()[0] for f in frames))

        def scan(learner, *args, **kwargs):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = saved(learner, *args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            self.windows += 1
            return out
        FedLearner.train_rounds_scan = scan
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.federated.api import FedLearner
        FedLearner.train_rounds_scan = self._saved


class _BlockingLoop:
    """Makes ``training.cv.train`` run the loop it ran before the round
    pipeline: no device prefetch (the batches stay numpy arrays), each
    round's inputs copied from pageable host memory inside its dispatch,
    and its metrics read right after it."""

    class _Now:
        def __init__(self, learner):
            self.learner = learner

        def push(self, raw):
            return self.learner.finalize_round_metrics(raw)

        def flush(self):
            return None

    def __enter__(self):
        import torch

        from commefficient_tpu_torch.federated.api import FedLearner
        from commefficient_tpu_torch.training import cv
        self._saved = [(cv, "device_prefetch", cv.device_prefetch),
                       (FedLearner, "_to_device", FedLearner._to_device),
                       (FedLearner, "pipeline", FedLearner.pipeline)]
        cv.device_prefetch = lambda batches, **kwargs: batches
        FedLearner._to_device = lambda learner, x, dtype=None: \
            torch.as_tensor(np.asarray(x), dtype=dtype,
                            device=learner.device)
        FedLearner.pipeline = lambda learner: self._Now(learner)
        return self

    def __exit__(self, *exc):
        for owner, attr, f in self._saved:
            setattr(owner, attr, f)


def _profile_loop(tag, learner, k=SCAN_K):
    """``k`` more sketch rounds of seeded full-width batches (8 workers of
    32 images) on ``learner``, as one window and then through the
    one-round pipeline, each under ``torch.profiler``: the wall time a
    round on the host's clock (to the last metrics' read) beside the
    device's busy time a round and the idle share. Checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(11)
    W, B = learner.cfg.num_workers, 32
    rounds = [(rng.choice(learner.cfg.num_clients, W, replace=False),
               (rng.randn(W, B, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, (W, B)).astype(np.int32)),
               np.ones((W, B), np.float32)) for _ in range(k)]
    dev = learner.device

    def window():
        stacked = (np.stack([r[0] for r in rounds]),
                   tuple(torch.from_numpy(np.stack([r[1][i] for r in rounds]))
                         .to(dev) for i in range(2)),
                   np.stack([r[2] for r in rounds]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.finalize_scan_metrics(learner.train_rounds_scan(*stacked))
        return time.perf_counter() - t0

    def pipelined():
        cols = [tuple(torch.from_numpy(c).to(dev) for c in r[1])
                for r in rounds]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = learner.pipeline()
        for (ids, _, mask), c in zip(rounds, cols):
            pipe.push(learner.train_round_async(ids, c, mask))
        pipe.flush()
        return time.perf_counter() - t0

    parts = []
    for name, run in (("window", window), ("pipelined", pipelined)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        parts.append(f"{name}: wall {1e3 * wall / k:.3f} ms a round, "
                     f"device busy {1e3 * busy / k:.3f} ms a round, idle "
                     f"share {1 - busy / wall:.4f}")
    print(f"profile {tag} ({k} rounds each, torch.profiler): "
          + "; ".join(parts), flush=True)


def _period_ms(rounds):
    """The mean round period (``round_s``) of a run's rounds, in ms."""
    return 1e3 * sum(r["round_s"] for r in rounds) / len(rounds)


def _check_sketch_bytes(tag, rounds, workers):
    """Every round's upload bytes are the float32 value of the exact count
    (``workers`` clients' 5 x 500,096 tables)."""
    want = float(np.float32(workers * 4 * TABLE_FLOATS))
    if any(r["upload_bytes"] != want for r in rounds):
        raise AssertionError(f"{tag}: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]} != "
                             f"{want} a round")


def phase_sketch_scan():
    """sketch_scan: the sketch path's flags with --scan_rounds 4 for 8
    rounds (two windows, within Synthetic's first epoch of 20 rounds)
    through ``training.cv.train``, the launch
    counters zeroed just before and read just after; the host syncs inside
    each window's dispatch recorded (``_SyncWatch``: none on this fused
    path); then the same 8 rounds at --scan_rounds 1 (the pipelined
    loop) and in the loop as it was before the pipeline (``_BlockingLoop``):
    weights, per-round losses and bytes bitwise equal. Prints the three
    runs' round periods, then profiles 4 more rounds as a window and as
    pipelined single rounds (``_profile_loop``)."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    runs = {}
    for k in (SCAN_K, 1, "blocking"):
        # a fresh --dataset_dir: Synthetic's 512 images a class, 20 full
        # rounds an epoch (the committed dataset/stats.json holds 64)
        with tempfile.TemporaryDirectory() as root:
            args = build_parser().parse_args(HEADLINE + [
                "--scan_rounds", str(SCAN_K if k == SCAN_K else 1),
                "--dataset_dir", root])
            np.random.seed(args.seed)
            cuda_lib.LAUNCHES.clear()
            context = {SCAN_K: _SyncWatch, "blocking": _BlockingLoop}.get(
                k, nullcontext)
            with context() as watch:
                learner, row = train(args, max_rounds=SCAN_ROUNDS,
                                     log=False)
        torch.cuda.synchronize()
        launches = {n: v for n, v in cuda_lib.LAUNCHES.items() if v}
        want = {n: v * SCAN_ROUNDS for n, v in SKETCH_ROUND.items()}
        if launches != want:
            raise AssertionError(f"sketch_scan (K {k}): launch counts "
                                 f"{launches} != {want}")
        rounds = row["rounds"]
        if len(rounds) != SCAN_ROUNDS or not all(
                math.isfinite(r["loss"]) for r in rounds):
            raise AssertionError(f"sketch_scan (K {k}): rounds {rounds}")
        _check_sketch_bytes(f"sketch_scan (K {k})", rounds, 8)
        runs[k] = (learner.state.weights.clone(), rounds, launches)
        if k == "blocking":
            _profile_loop("sketch_scan", learner)
        if k == SCAN_K:
            if watch.windows != SCAN_ROUNDS // SCAN_K or watch.syncs:
                raise AssertionError(
                    f"sketch_scan: {watch.windows} windows, host syncs "
                    f"inside them: {watch.syncs}")
        del learner, row
        torch.cuda.empty_cache()
    w_scan, r_scan, launches = runs[SCAN_K]
    for k in (1, "blocking"):
        w, r, _ = runs[k]
        same_rounds = all(
            (a["loss"].hex(), a["upload_bytes"], a["download_bytes"])
            == (b["loss"].hex(), b["upload_bytes"], b["download_bytes"])
            for a, b in zip(r_scan, r))
        if not _same_bits(w_scan, w) or not same_rounds:
            raise AssertionError(
                f"sketch_scan: --scan_rounds {SCAN_K} and the {k} loop "
                f"differ: losses {[x['loss'] for x in r_scan]} vs "
                f"{[x['loss'] for x in r]}")
    periods = ", ".join(
        f"{_period_ms(runs[k][1]):.3f} ms ({name})" for k, name in (
            (SCAN_K, f"windows of {SCAN_K}"), (1, "pipelined"),
            ("blocking", "blocking, as before the pipeline")))
    rounds_ms = "; ".join(
        f"{k}: {[round(x['round_s'] * 1e3, 3) for x in runs[k][1]]}"
        for k in runs)
    print(f"path sketch_scan: {SCAN_ROUNDS} rounds in windows of {SCAN_K} "
          f"against the pipelined and the blocking loop, launches "
          f"{launches}, losses {[round(r['loss'], 6) for r in r_scan]}, "
          f"weights, losses and bytes bitwise equal, no host sync inside a "
          f"window; round period {periods}; round ms {rounds_ms}",
          flush=True)
    del runs, w_scan
    torch.cuda.empty_cache()
    return launches


def write_cifar10_pickles(root, per_batch=10_000, n_test=10_000, seed=0):
    """CIFAR-10's python-pickle batches (``cifar-10-batches-py``: five
    train batches and a test batch of uint8 rows of 3 x 32 x 32 pixels,
    balanced labels) with seeded random pixels, under ``root``."""
    import pickle
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name, n in zip(names, [per_batch] * 5 + [n_test]):
        labels = np.arange(n) % 10
        rng.shuffle(labels)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         "labels": labels.tolist()}, f)


FEED_BATCHES = 32


def _feed_alone(args):
    """The CIFAR train feed alone, on the host (no round runs): median ms
    of ``FEED_BATCHES`` batches of ``args``' batcher (sampling, gathering,
    train transforms), with the C++ data plane and with the numpy stages,
    alternated twice."""
    from commefficient_tpu_torch import native
    from commefficient_tpu_torch.data import FedBatcher
    from commefficient_tpu_torch.training.cv import make_dataset
    ds = make_dataset(args, True)
    out = {"native": [], "numpy": []}
    for feed in ("native", "numpy") * 2:
        if feed == "numpy":
            os.environ[native.OPT_OUT] = "1"
        try:
            times = []
            batches = FedBatcher(ds, args.num_workers, args.local_batch_size,
                                 seed=args.seed).epoch()
            for _ in range(FEED_BATCHES):
                t0 = time.perf_counter()
                next(batches)
                times.append(1e3 * (time.perf_counter() - t0))
        finally:
            os.environ.pop(native.OPT_OUT, None)
        out[feed].append(float(np.median(times)))
    return out


def phase_cifar10_fetchsgd():
    """cifar10_fetchsgd: examples/cifar10_fetchsgd.sh's flags (100 non-iid
    clients, 8 a round, --scan_rounds 8) through ``training.cv.train`` on
    CIFAR-10 pickles written from a seed at the real format and size,
    with the real train (normalize, reflect-pad 4 and crop, flip) and test
    transforms: 16 rounds (two windows), then one validation pass over the
    10,000 test images; launches counted over both; every round's bytes
    the float32 value of the exact count. Run three times from the same
    seed: with the C++ data plane (its native calls above 0), with
    ``COMMEFFICIENT_NO_NATIVE=1`` (the numpy stages, no native call) and
    with the C++ data plane again (the first run also pays the process's
    first read of the data); the runs' losses and weights bitwise equal.
    Prints each run's data feed host time a batch (sampling, gathering,
    transforms) beside its round period, and first the feed alone
    (``_feed_alone``). Returns the first run's launches."""
    import torch

    from commefficient_tpu_torch import native
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    runs = []
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_cifar10_pickles(root)
        gen_s = time.perf_counter() - t0
        alone = _feed_alone(build_parser().parse_args(CIFAR_FLAGS + [
            "--dataset_dir", root]))
        print(f"cifar10_fetchsgd feed alone (host, median of "
              f"{FEED_BATCHES} batches of 8 x 32 images, alternated): "
              f"native {alone['native']} ms, numpy {alone['numpy']} ms a "
              f"batch; {_smi()}", flush=True)
        for feed in ("native", "numpy", "native"):
            if feed == "numpy":
                os.environ[native.OPT_OUT] = "1"
            try:
                args = build_parser().parse_args(CIFAR_FLAGS + [
                    "--dataset_dir", root])
                np.random.seed(args.seed)
                cuda_lib.LAUNCHES.clear()
                calls = dict(native.CALLS)
                t0 = time.perf_counter()
                learner, row = train(args, max_rounds=CIFAR_ROUNDS,
                                     log=False)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            finally:
                os.environ.pop(native.OPT_OUT, None)
            made = {k: v - calls.get(k, 0) for k, v in native.CALLS.items()
                    if v - calls.get(k, 0)}
            launches = {n: v for n, v in cuda_lib.LAUNCHES.items() if v}
            want = {n: v * CIFAR_ROUNDS for n, v in SKETCH_ROUND.items()}
            if launches != want:
                raise AssertionError(f"cifar10_fetchsgd ({feed}): launch "
                                     f"counts {launches} != {want}")
            if (feed == "native") != bool(made.get("pad_crop_batch")):
                raise AssertionError(f"cifar10_fetchsgd ({feed}): native "
                                     f"calls {made}")
            rounds = row["rounds"]
            w = learner.state.weights
            if len(rounds) != CIFAR_ROUNDS \
                    or learner.cfg.grad_size != D_RESNET9 \
                    or learner.cfg.num_clients != 100:
                raise AssertionError(f"cifar10_fetchsgd: {len(rounds)} "
                                     f"rounds, d = {learner.cfg.grad_size},"
                                     f" {learner.cfg.num_clients} clients")
            if not all(math.isfinite(r["loss"]) for r in rounds) \
                    or not bool(torch.isfinite(w).all()) \
                    or not math.isfinite(row["test_loss"]) \
                    or not 0 <= row["test_acc"] <= 1:
                raise AssertionError("cifar10_fetchsgd: non-finite loss, "
                                     "weights or validation")
            _check_sketch_bytes("cifar10_fetchsgd", rounds, 8)
            print(f"path cifar10_fetchsgd ({feed} feed): d = "
                  f"{learner.cfg.grad_size}, launches {launches}, native "
                  f"calls {made}, losses "
                  f"{[round(r['loss'], 6) for r in rounds]}, test_loss "
                  f"{row['test_loss']:.6f} test_acc {row['test_acc']:.4f} "
                  f"over 10,000 images, round period "
                  f"{_period_ms(rounds):.3f} ms (the second window's "
                  f"{_period_ms(rounds[CIFAR_ROUNDS // 2:]):.3f}), data feed "
                  f"{1e3 * row['feed_s'] / row['feed_batches']:.3f} ms a "
                  f"batch (host; {row['feed_batches']} batches, transforms "
                  f"included), train {row['train_time']:.3f} s, validation "
                  f"{row['test_time']:.3f} s, whole train() {wall_s:.3f} s "
                  f"after {gen_s:.3f} s writing 184 MB of pickles; "
                  f"{_smi()}", flush=True)
            runs.append(([r["loss"] for r in rounds], w.clone(), launches))
            del learner, row, w
            torch.cuda.empty_cache()
    (la, wa, launches), *rest = runs
    for lb, wb, _ in rest:
        if [x.hex() for x in la] != [x.hex() for x in lb] \
                or not _same_bits(wa, wb):
            raise AssertionError(f"cifar10_fetchsgd: the native-fed and "
                                 f"numpy-fed runs differ: losses {la} vs "
                                 f"{lb}, weights bitwise equal "
                                 f"{_same_bits(wa, wb)}")
    print(f"cifar10_fetchsgd: the native-fed and numpy-fed runs' losses and "
          f"weights after {CIFAR_ROUNDS} rounds bitwise equal", flush=True)
    return launches


# --------------------------------------------------------------------------
# Robustness (ROADMAP A10): the buffered server, the fault model,
# quarantine, checkpoints, resume and finetune
# --------------------------------------------------------------------------

SKETCH_LAUNCHES = dict(RECOVERY, sketch=3)
FAULT_FLAGS = ["--server_mode", "buffered", "--fault_seed", "7",
               "--fault_dropout_prob", "0.1", "--fault_crash_prob", "0.05",
               "--straggler_frac", "0.25", "--staleness_alpha", "0.5",
               "--num_workers", "8", "--buffer_m", "4"]
# cohorts of the faulted run: fault seed 7 draws its first dropouts (two)
# and its first crash in cohort 7 of the headline Synthetic run (epochs of
# 3 rounds)
FAULT_COHORTS = 7
# the reference's preemption config for the buffered server
# (tests/test_preemption.py _CONFIGS["buffered"]) at ResNet9's width: the
# lock-step server, the per-row radix top-k at k 5
PATHS["buffered_local_topk"] = (
    _BASE + ["--mode", "local_topk", "--error_type", "local", "--k", "5",
             "--local_batch_size", "32", "--server_mode", "buffered"],
    LOCAL_TOPK, 4 * 5)
QUARANTINE_ROUNDS = 5
HEAD_RESNET9 = 512 * 10   # Dense_0 (bias-free), the head finetune trains


def _launches():
    from commefficient_tpu_torch.ops import cuda_lib
    return {k: v for k, v in cuda_lib.LAUNCHES.items() if v}


def _scaled(launches, n, of=3):
    """Per-round launch counts of ``launches`` (over ``of`` rounds) times
    ``n``."""
    return {k: v // of * n for k, v in launches.items()}


def phase_buffered_lockstep(ref):
    """--server_mode buffered with no fault model at alpha 0: 3 rounds of
    the headline sketch flags, bitwise the sync path's (``ref`` from
    ``phase_repeat``: losses, weights, Vvelocity, Verror, bytes) with
    the sketch path's launches."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    cuda_lib.LAUNCHES.clear()
    learner, row = _cv_run(HEADLINE + ["--server_mode", "buffered"])
    torch.cuda.synchronize()
    launches = _launches()
    if launches != SKETCH_LAUNCHES:
        raise AssertionError(f"buffered_lockstep: launch counts {launches} "
                             f"!= {SKETCH_LAUNCHES}")
    losses, weights, vvel, verr, nbytes = ref
    rounds = row["rounds"]
    s = learner.state
    got = [(r["upload_bytes"], r["download_bytes"]) for r in rounds]
    if ([r["loss"].hex() for r in rounds] != [v.hex() for v in losses]
            or got != nbytes
            or not all(_same_bits(a, b) for a, b in (
                (s.weights, weights), (s.opt.Vvelocity, vvel),
                (s.opt.Verror, verr)))
            or learner.applies_done != 3
            or int(s.weights_version) != int(s.round_idx) != 3):
        raise AssertionError(f"buffered_lockstep: not the sync path's "
                             f"trajectory: losses "
                             f"{[r['loss'] for r in rounds]} vs {losses}, "
                             f"bytes {got} vs {nbytes}")
    print(f"path buffered_lockstep: launches {launches}, losses "
          f"{[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}; losses, "
          f"bytes, weights, Vvelocity and Verror bitwise the sync sketch "
          f"path's; {learner.applies_done} applies", flush=True)
    del learner, row, s
    torch.cuda.empty_cache()
    return launches


class _CohortLog:
    """Records each cohort a ``BufferedFedLearner`` dispatches: its client
    ids and mask on the host."""

    def __enter__(self):
        from commefficient_tpu_torch.federated.buffer import \
            BufferedFedLearner
        self.cohorts = []
        self._saved = BufferedFedLearner.train_round_async
        saved = self._saved

        def dispatch(learner, client_ids, batch, mask, **kwargs):
            self.cohorts.append((np.array(client_ids),
                                 np.array(mask.cpu() if hasattr(mask, "cpu")
                                          else mask)))
            return saved(learner, client_ids, batch, mask, **kwargs)
        BufferedFedLearner.train_round_async = dispatch
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.federated.buffer import \
            BufferedFedLearner
        BufferedFedLearner.train_round_async = self._saved


def _replay_schedule_on_cpu(args, num_clients, cohorts):
    """The same cohorts (ids, masks) through a CPU ``BufferedFedLearner``
    of a 2-class toy model, with the run's fault flags, buffer and
    dispatch interval: the host event loop's schedule (fault_stats,
    applies, sim_time) does not depend on the model or the device."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.buffer import BufferedFedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.toy import TinyMLP
    from commefficient_tpu_torch.training.args import make_fault_model
    model = TinyMLP(num_classes=2, hidden=2, in_channels=1, image_size=1)
    cfg = FedConfig(mode="uncompressed", num_workers=args.num_workers,
                    num_clients=num_clients, server_mode="buffered",
                    buffer_m=args.buffer_m,
                    staleness_alpha=args.staleness_alpha)
    learner = BufferedFedLearner(
        model, cfg, make_cv_loss(model), device="cpu",
        fault_model=make_fault_model(args, num_clients),
        dispatch_interval=args.dispatch_interval)
    for ids, mask in cohorts:
        W, B = mask.shape
        batch = (np.zeros((W, B, 1, 1, 1), np.float32),
                 np.zeros((W, B), np.int64))
        learner.train_round(ids, batch, mask)
    learner.flush_faults()
    del torch
    return learner.fault_stats, learner.applies_done, learner.sim_time


def phase_buffered_faults():
    """The buffered server under a seeded fault schedule (FAULT_FLAGS: 8
    workers, M 4, alpha 0.5, dropouts, crashes, chronic stragglers),
    FAULT_COHORTS cohorts of the headline sketch flags (the seed's
    schedule drops two clients and crashes one in them) and the
    end-of-training flush, twice: weights, losses, bytes, fault_stats, applies and sim_time
    bitwise equal; each apply sketches the aggregate once and recovers
    (the sketch path's launches per apply); the schedule equal to a CPU
    replay of the same cohorts."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    runs = []
    for _ in range(2):
        cuda_lib.LAUNCHES.clear()
        with _CohortLog() as log:
            learner, row = _cv_run(HEADLINE + FAULT_FLAGS,
                                   rounds=FAULT_COHORTS)
        torch.cuda.synchronize()
        runs.append(dict(
            launches=_launches(), weights=learner.state.weights.clone(),
            losses=[r["loss"].hex() for r in row["rounds"]],
            stats=dict(learner.fault_stats), applies=learner.applies_done,
            sim_time=learner.sim_time, cohorts=log.cohorts,
            num_clients=learner.cfg.num_clients,
            bytes=(learner.total_upload_bytes,
                   learner.total_download_bytes),
            version=int(learner.state.weights_version),
            round_ms=[round(r["round_s"] * 1e3, 3) for r in row["rounds"]]))
        del learner, row
        torch.cuda.empty_cache()
    a, b = runs
    for key in ("launches", "losses", "stats", "applies", "sim_time",
                "bytes", "version"):
        if a[key] != b[key]:
            raise AssertionError(f"buffered_faults: {key} differs between "
                                 f"two runs: {a[key]} vs {b[key]}")
    if not _same_bits(a["weights"], b["weights"]):
        raise AssertionError("buffered_faults: the weights differ between "
                             "two runs")
    if not torch.isfinite(a["weights"]).all() or a["applies"] < 1 \
            or a["version"] != a["applies"]:
        raise AssertionError(f"buffered_faults: {a['applies']} applies, "
                             f"version {a['version']}")
    if min(a["stats"]["dropouts"], a["stats"]["crashes"]) < 1:
        raise AssertionError(f"buffered_faults: the schedule drew no "
                             f"dropout or no crash: {a['stats']}")
    want = _scaled(SKETCH_LAUNCHES, a["applies"])
    if a["launches"] != want:
        raise AssertionError(f"buffered_faults: launch counts "
                             f"{a['launches']} != {want} "
                             f"({a['applies']} applies)")
    args = build_parser().parse_args(HEADLINE + FAULT_FLAGS)
    cpu = _replay_schedule_on_cpu(args, a["num_clients"], a["cohorts"])
    if cpu != (a["stats"], a["applies"], a["sim_time"]):
        raise AssertionError(f"buffered_faults: the card's schedule "
                             f"{(a['stats'], a['applies'], a['sim_time'])} "
                             f"!= the CPU replay's {cpu}")
    print(f"path buffered_faults: launches {a['launches']}, "
          f"{len(a['cohorts'])} cohorts, {a['applies']} applies, fault "
          f"stats {a['stats']}, sim_time {a['sim_time']!r}, upload B "
          f"{a['bytes'][0]:.0f}, round ms {a['round_ms']}; two runs "
          f"bitwise equal, schedule equal to the CPU replay", flush=True)
    return a["launches"]


class _Timed:
    """Times every call of ``owner.attr`` (seconds in ``self.seconds``)."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr

    def __enter__(self):
        self.seconds = []
        self._saved = getattr(self.owner, self.attr)
        saved = self._saved

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self._saved)


class _PoisonRound:
    """Makes worker 0's images NaN in round ``at`` (1-based) of a run and
    records every round's quarantine metrics (read on the host after the
    dispatch)."""

    def __init__(self, at=2):
        self.at = at

    def __enter__(self):
        from commefficient_tpu_torch.federated.api import FedLearner
        self.seen, self.poisoned = [], None
        self._saved = FedLearner.train_round_async
        saved = self._saved

        def dispatch(learner, client_ids, batch, mask, **kwargs):
            if len(self.seen) + 1 == self.at:
                images = batch[0].clone()
                images[0] = float("nan")
                batch = (images,) + tuple(batch[1:])
                self.poisoned = int(np.asarray(client_ids)[0])
            raw = saved(learner, client_ids, batch, mask, **kwargs)
            self.seen.append((float(raw["dropped_contributions"]),
                              int(raw["num_quarantined"])))
            return raw
        FedLearner.train_round_async = dispatch
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.federated.api import FedLearner
        FedLearner.train_round_async = self._saved


def phase_quarantine():
    """--client_quarantine in the sync server, worker 0's batch NaN in
    round 2 of the headline sketch flags: the per-worker round, the
    aggregate sketched once a round (the sketch path's launches), that
    contribution alone excluded, its client benched for the remaining
    rounds, no abort, finite weights."""
    import torch

    from commefficient_tpu_torch.federated.round import \
        fused_clients_eligible
    from commefficient_tpu_torch.ops import cuda_lib
    cuda_lib.LAUNCHES.clear()
    with _PoisonRound(at=2) as poison:
        learner, row = _cv_run(HEADLINE + ["--client_quarantine"])
    torch.cuda.synchronize()
    launches = _launches()
    rounds = row["rounds"]
    q = learner.state.quarantine.cpu()
    bench = QUARANTINE_ROUNDS - 1   # benched in round 2, ticked in round 3
    if (launches != SKETCH_LAUNCHES
            or fused_clients_eligible(learner.cfg)
            or poison.seen != [(0.0, 0), (1.0, 1), (0.0, 1)]
            or any(r["aborted"] for r in rounds)
            or not all(math.isfinite(r["loss"]) for r in rounds)
            or not bool(torch.isfinite(learner.state.weights).all())
            or int((q > 0).sum()) != 1
            or int(q[poison.poisoned]) != bench):
        raise AssertionError(f"quarantine: launches {launches}, "
                             f"(dropped, num_quarantined) a round "
                             f"{poison.seen}, bench {q.tolist()}, client "
                             f"{poison.poisoned}, rounds {rounds}")
    print(f"path quarantine: launches {launches}, client "
          f"{poison.poisoned} poisoned in round 2: (dropped, quarantined) "
          f"a round {poison.seen}, bench left {int(q[poison.poisoned])}, "
          f"losses {[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, upload B "
          f"{[int(r['upload_bytes']) for r in rounds]}, no abort, finite "
          f"weights", flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


RESUME_EPOCHS = "2"   # 3 rounds an epoch on Synthetic at 64 images a class


def _export(path, name):
    with np.load(os.path.join(path, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _same_export(a, b) -> bool:
    keys = [k for k in a if k.startswith(("arr_", "host_"))] + [
        "rounds_done", "total_download_bytes", "total_upload_bytes",
        "torch_generator"]
    return sorted(k for k in a if k.startswith(("arr_", "host_"))) == \
        sorted(k for k in b if k.startswith(("arr_", "host_"))) and all(
            np.array_equal(a[k], b[k]) for k in keys)


def _build_snapshot():
    from commefficient_tpu_torch.ops import cuda_lib
    return {p.name: p.stat().st_mtime_ns
            for p in cuda_lib.BUILD_DIR.glob("*.so")}


def phase_sigkill_resume(tmpdir):
    """The preemption contract on the card: the headline sketch flags for
    2 epochs (6 rounds) with --checkpoint_every_rounds 2 and the final
    export, once in this process; then a child process (the CLI) SIGKILLed
    once its first step file appears, and a second child with --resume
    auto: its export bitwise this process's. The children load the
    kernels built here (the build directory unchanged). Also the save
    and load time of a checkpoint at d = 6,568,640. Returns (launches of
    the in-process run, the export's path)."""
    import signal

    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    from commefficient_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint)

    def flags(where):
        return HEADLINE + ["--num_epochs", RESUME_EPOCHS, "--checkpoint",
                           "--checkpoint_path", where,
                           "--checkpoint_every_rounds", "2"]
    base = os.path.join(tmpdir, "resume_base")
    args = build_parser().parse_args(flags(base))
    np.random.seed(args.seed)
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, log=False)
    torch.cuda.synchronize()
    launches = _launches()
    n = len(row["rounds"])
    if launches != _scaled(SKETCH_LAUNCHES, n) or n != 6:
        raise AssertionError(f"resume: {n} rounds, launches {launches}")
    t0 = time.perf_counter()
    fn = save_checkpoint(os.path.join(tmpdir, "timing"), learner, "t")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_checkpoint(fn, learner)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = os.path.getsize(fn)
    del learner, row
    torch.cuda.empty_cache()
    want = _export(base, args.model)
    built = _build_snapshot()
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("COMMEFF_CRASH_POINT", None)
    ckpt = os.path.join(tmpdir, "resume_killed")
    cmd = [sys.executable, "-m", "commefficient_tpu_torch.training.cv",
           *flags(ckpt)]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    killed_at = None
    try:
        while time.perf_counter() - t0 < 300:
            if child.poll() is not None:
                raise AssertionError(f"resume: the child exited "
                                     f"(rc={child.returncode}) before the "
                                     f"kill:\n{child.stdout.read()}")
            if os.path.isdir(ckpt) and any("_r" in f and f.endswith(".npz")
                                           for f in os.listdir(ckpt)):
                child.send_signal(signal.SIGKILL)
                killed_at = sorted(os.listdir(ckpt))
                break
            time.sleep(0.01)
        out, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    first_s = time.perf_counter() - t0
    if child.returncode != -signal.SIGKILL \
            or os.path.exists(os.path.join(ckpt, f"{args.model}.npz")):
        raise AssertionError(f"resume: the child ended with "
                             f"{child.returncode}:\n{out}")
    t0 = time.perf_counter()
    done = subprocess.run(cmd + ["--resume", "auto"], env=env,
                          capture_output=True, text=True, timeout=300)
    second_s = time.perf_counter() - t0
    if done.returncode != 0 or "resumed from" not in done.stdout:
        raise AssertionError(f"resume: the resumed child failed "
                             f"({done.returncode}):\n{done.stdout}\n"
                             f"{done.stderr}")
    if _build_snapshot() != built or not built:
        raise AssertionError("resume: a child rebuilt the kernels")
    if not _same_export(want, _export(ckpt, args.model)):
        raise AssertionError("resume: the resumed run's export is not the "
                             "uninterrupted run's")
    line = next(x for x in done.stdout.splitlines()
                if x.startswith("resumed from"))
    print(f"path sigkill_resume: {n} rounds in process, launches "
          f"{launches}; child killed at {killed_at} after {first_s:.3f} s; "
          f"the resumed child ({second_s:.3f} s): '{line}'; its export "
          f"bitwise the uninterrupted run's (state, bytes, generator); "
          f"kernels not rebuilt; checkpoint at d = {D_RESNET9}: "
          f"{size} B, save {save_s * 1e3:.3f} ms, load "
          f"{load_s * 1e3:.3f} ms", flush=True)
    return launches, os.path.join(base, f"{args.model}.npz")


FINETUNE_ROUNDS = 3   # a middle round to time (the epoch's last is ~0.3 ms)


def phase_finetune(export):
    """--finetune from ``export`` (the resume phase's ResNet9 export) for
    FINETUNE_ROUNDS rounds of the headline sketch flags: the frozen
    coordinates keep the export's weights bitwise and never change
    (last_changed -2), the head (Dense_0, 5,120 coordinates) moves; the
    middle round's period is finetune's round time."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    args = build_parser().parse_args(HEADLINE + [
        "--finetune", "--finetune_path", export])
    np.random.seed(args.seed)
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, max_rounds=FINETUNE_ROUNDS, log=False)
    torch.cuda.synchronize()
    launches = _launches()
    mask = learner._trainable_mask.cpu() > 0
    with np.load(export) as z:
        saved = torch.from_numpy(z["arr_0"])
    w = learner.state.weights.cpu()
    changed = learner.state.last_changed.cpu() >= 0
    head = int(mask.sum())
    if (launches != _scaled(SKETCH_LAUNCHES, FINETUNE_ROUNDS)
            or head != HEAD_RESNET9
            or not _same_bits(w[~mask], saved[~mask])
            or bool(changed[~mask].any()) or not bool(changed[mask].any())
            or not all(math.isfinite(r["loss"]) for r in row["rounds"])):
        raise AssertionError(f"finetune: launches {launches}, head {head}, "
                             f"{int(changed[mask].sum())} head and "
                             f"{int(changed[~mask].sum())} frozen "
                             f"coordinates changed")
    print(f"path finetune: launches {launches}, head {head} coordinates, "
          f"{int(changed[mask].sum())} of them moved, the other "
          f"{int((~mask).sum())} bitwise the export's; losses "
          f"{[round(r['loss'], 6) for r in row['rounds']]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in row['rounds']]}",
          flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


def phase_gpt2_resume(tmpdir, ref):
    """GPT2-small, in process: 3 rounds of ``GPT2_FLAGS`` with
    --checkpoint_every_rounds 2 (the step file of round 2), bitwise the
    gpt2 path's 3 rounds (``ref`` = (losses, weights)); then a fresh
    learner resumed from round 2 runs round 3, bitwise too (the torch
    generator, which the dropout draws from, is in the checkpoint). The
    checkpointer's save and load are timed (d = 124,051,201)."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training import preempt
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    ckpt = os.path.join(tmpdir, "gpt2_resume")
    flags = GPT2_FLAGS + ["--dataset_dir", tmpdir, "--checkpoint_path",
                          ckpt, "--checkpoint_every_rounds", "2"]
    losses, weights = ref
    launches = {}
    for resume in ([], ["--resume", "auto"]):
        args = build_gpt2_parser().parse_args(flags + resume)
        np.random.seed(args.seed)
        cuda_lib.LAUNCHES.clear()
        with _Timed(preempt, "save_checkpoint") as save, \
                _Timed(preempt, "load_checkpoint") as load:
            learner, row = train(args, max_rounds=3, log=False)
        torch.cuda.synchronize()
        if resume:
            load_s = load.seconds
        else:
            save_s = save.seconds
        got = [r["loss"].hex() for r in row["rounds"]]
        want = [v.hex() for v in losses[3 - len(got):]]
        if got != want or not _same_bits(learner.state.weights, weights) \
                or learner.rounds_done != 3:
            raise AssertionError(f"gpt2_resume {resume}: losses "
                                 f"{[r['loss'] for r in row['rounds']]} vs "
                                 f"{losses}, or the weights differ")
        if not resume and not os.path.exists(
                os.path.join(ckpt, f"{args.model}_r00000002.npz")):
            raise AssertionError(f"gpt2_resume: no step file of round 2 in "
                                 f"{os.listdir(ckpt)}")
        for k, v in row["launches_after_rounds"].items():
            launches[k] = launches.get(k, 0) + v
        if not resume:
            del learner, row
            torch.cuda.empty_cache()
    if launches != _scaled(GPT2_SKETCH, 4):
        raise AssertionError(f"gpt2_resume: launch counts {launches}")
    if len(save_s) != 1 or len(load_s) != 1:
        raise AssertionError(f"gpt2_resume: saves {save_s}, loads {load_s}")
    size = os.path.getsize(os.path.join(ckpt, f"{args.model}_r00000002.npz"))
    print(f"path gpt2_resume: 3 rounds with a save at round 2, then a "
          f"fresh learner from it for round 3: losses and weights bitwise "
          f"the gpt2 path's; launches {launches}; checkpoint at d = "
          f"{D_GPT2}: {size} B, save {save_s[0]:.3f} s, load "
          f"{load_s[0]:.3f} s",
          flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


REFERENCE_CONFIGS = {
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   num_cols=2000, num_rows=5),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9),
    # the per-worker sketch, its batched kernel on the card (DP noise 0:
    # the two devices' generators draw different normals)
    "sketch_clip": dict(mode="sketch", error_type="virtual",
                        virtual_momentum=0.9, num_cols=2000, num_rows=5,
                        max_grad_norm=1.0),
    "sketch_dp": dict(mode="sketch", error_type="virtual",
                      virtual_momentum=0.9, num_cols=2000, num_rows=5,
                      do_dp=True, l2_norm_clip=1.0, noise_multiplier=0.0),
}


def phase_reference(dev):
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
    rng = np.random.RandomState(1)
    batches = [(rng.choice(10, 4, replace=False).astype(np.int32),
                (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (4, 8)).astype(np.int32)),
                np.ones((4, 8), np.float32)) for _ in range(2)]
    for mode, kw in REFERENCE_CONFIGS.items():
        cfg = FedConfig(k=200, num_clients=10, num_workers=4, **kw)
        outs = {}
        for device in ("cpu", dev):
            model = ResNet9(channels=ch).reset_parameters(
                torch.Generator().manual_seed(0))
            loss = make_cv_loss(model)
            learner = FedLearner(model, cfg, loss, loss, device=device)
            ms = [learner.train_round(ids, cols, m, epoch_frac=1.0)
                  for ids, cols, m in batches]
            outs[str(device)] = (ms, learner.state.weights.cpu())
        (m_cpu, w_cpu), (m_gpu, w_gpu) = outs["cpu"], outs[str(dev)]
        for a, b in zip(m_cpu, m_gpu):
            if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
                raise AssertionError(f"{mode}: loss cpu {a['loss']} != "
                                     f"cuda {b['loss']}")
            if (a["download_bytes"], a["upload_bytes"]) != (
                    b["download_bytes"], b["upload_bytes"]):
                raise AssertionError(f"{mode}: byte metrics differ between "
                                     "cpu and cuda")
        close = torch.isclose(w_gpu, w_cpu, rtol=1e-3, atol=1e-5)
        frac = float(close.float().mean())
        if frac < 0.99:
            raise AssertionError(f"{mode}: only {frac:.4f} of weights agree")
        print(f"reference {mode} (narrow ResNet9, 2 rounds, cuda vs cpu "
              f"plain): losses {[round(m['loss'], 6) for m in m_gpu]} vs "
              f"{[round(m['loss'], 6) for m in m_cpu]}, bytes equal, "
              f"{frac:.6f} of weights within rtol 1e-3", flush=True)


def _flash_inputs(dev, bh, t, d, dtype, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(bh, t, d, generator=gen, device=dev).to(dtype)
                 for _ in range(4))


def _flash_args(d, rate):
    from commefficient_tpu_torch.ops import flash_attention as fa
    return ((1234567, -7654321), d ** -0.5, fa.DEFAULT_BLOCK_Q,
            fa.DEFAULT_BLOCK_K, rate)


def _flash_run(q, k, v, g, args, v1=False):
    """The kernels' forward and backward: the tensor-core forward, dq and
    dk/dv, or (``v1``) the first port's scalar ones."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    fwd = fa.flash_fwd_v1 if v1 else fa.flash_fwd
    bwd_dq = fa.flash_bwd_dq_v1 if v1 else fa.flash_bwd_dq
    dkv = fa.flash_bwd_dkv_v1 if v1 else fa.flash_bwd_dkv
    o, lse = fwd(q, k, v, *args)
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = dkv(q, k, v, g, lse, delta, *args)
    return o, lse, dq, dk, dv


_FLASH_NAMES = ("o", "lse", "dq", "dk", "dv")


def _flash_check(dev, bh, t, d, dtype, rate, seed):
    """Both routes' kernels twice (bitwise equal) and against the plain
    versions: ``{route: ({name: max abs err}, {name: err relative to max
    |plain|})}``, route "tc" (the path's kernels) or "v1", and "v1 - tc"
    (the two routes against each other, relative to max |plain|)."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(dev, bh, t, d, dtype, seed)
    args = _flash_args(d, rate)
    ref = fa.flash_fwd_plain(q, k, v, *args) + fa.flash_bwd_plain(
        q, k, v, g, *args)
    top = {n: max(float(b.double().abs().max()), 1e-30)
           for n, b in zip(_FLASH_NAMES, ref)}
    out, got = {}, {}
    for route in ("tc", "v1"):
        got[route] = _flash_run(q, k, v, g, args, v1=route == "v1")
        again = _flash_run(q, k, v, g, args, v1=route == "v1")
        torch.cuda.synchronize()
        for name, a, b in zip(_FLASH_NAMES, got[route], again):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"flash kernels ({route}) are not deterministic: {name} "
                    f"differs between two runs ({bh}, {t}, {d}, {dtype}, "
                    f"rate {rate})")
        del again
        err = {n: _max_abs_err(a, b)
               for n, a, b in zip(_FLASH_NAMES, got[route], ref)}
        out[route] = (err, {n: err[n] / top[n] for n in _FLASH_NAMES})
    err = {n: _max_abs_err(a, b)
           for n, a, b in zip(_FLASH_NAMES, got["tc"], got["v1"])}
    out["v1 - tc"] = (err, {n: err[n] / top[n] for n in _FLASH_NAMES})
    return out


def _flash_bad(dtype, err, rel):
    """The names over the limits: float32 O and lse 1e-5 absolute, dq, dk
    and dv 1e-4 of their largest magnitude; bfloat16 O 2e-2."""
    import torch
    if dtype == torch.float32:
        return [n for n in ("o", "lse") if err[n] > 1e-5] + [
            n for n in ("dq", "dk", "dv") if rel[n] > 1e-4]
    return [n for n in ("o",) if err[n] > 2e-2]


def phase_flash_parity(dev, errs):
    import torch
    bh, t, d = FLASH_SHAPE
    cases = [("f32", bh, t, d, torch.float32, 0.0),
             ("f32", bh, t, d, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_CLIENT, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_T512, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_T512_VAL, torch.float32, 0.0),
             ("f32", *FLASH_SHAPE_CHUNK, torch.float32, FLASH_RATE),
             ("bf16", bh, t, d, torch.bfloat16, FLASH_RATE),
             ("f32", 24, 1100, 128, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_HALF, torch.float32, FLASH_RATE)]
    errs.update(flash_fwd=0.0, flash_bwd_dq=0.0, flash_bwd_dkv=0.0,
                flash_fwd_v1=0.0, flash_bwd_dq_v1=0.0, flash_bwd_dkv_v1=0.0)
    for i, (tag, bh_, t_, d_, dtype, rate) in enumerate(cases):
        res = _flash_check(dev, bh_, t_, d_, dtype, rate, seed=i)
        for route, (err, rel) in res.items():
            how = ("the routes against each other" if route == "v1 - tc"
                   else "bitwise equal over 2 runs")
            print(f"parity flash {route} ({tag}, BH={bh_}, T={t_}, D={d_}, "
                  f"rate {rate}): {how}; max abs err O "
                  f"{err['o']:.3e}, lse {err['lse']:.3e}; relative to max "
                  f"|.|: dq {rel['dq']:.3e}, dk {rel['dk']:.3e}, dv "
                  f"{rel['dv']:.3e}", flush=True)
            bad = _flash_bad(dtype, err, rel)
            if bad:
                raise AssertionError(
                    f"flash kernels ({route}) disagree ({tag}, T={t_}, "
                    f"D={d_}, rate {rate}) in {bad}: {err} / {rel}")
        if dtype == torch.float32 and d_ == d:
            for suffix, route in (("", "tc"), ("_v1", "v1")):
                err = res[route][0]
                errs["flash_fwd" + suffix] = max(errs["flash_fwd" + suffix],
                                                 err["o"])
                errs["flash_bwd_dq" + suffix] = max(
                    errs["flash_bwd_dq" + suffix], err["dq"])
                errs["flash_bwd_dkv" + suffix] = max(
                    errs["flash_bwd_dkv" + suffix], err["dk"], err["dv"])


def _flash_cost(kind, bh, t, d):
    """The least time for one kernel at (bh, t, d) float32, two ways:
    ``{"tensor_cores": (ms, by), "cuda_cores": (ms, by)}``. Each input is
    read once and each output written once; the causal products' flops
    (forward 2 T^2 D BH, dq 1.5x, dkv 2x) run either in 3xTF32 on the
    tensor cores (3 products at 495 TFLOP/s, the least time for float32
    accuracy) or in float32 on the CUDA cores (67 TFLOP/s)."""
    tensor, row = 4 * bh * t * d, 4 * bh * t
    flops = 2 * t * t * d * bh
    nbytes, ops = {
        "fwd": (4 * tensor + row, flops),          # q, k, v -> O, lse
        "dq": (5 * tensor + 2 * row, 1.5 * flops),  # q, k, v, dO, lse, delta
        "dkv": (6 * tensor + 2 * row, 2 * flops),   # ... -> dk, dv
    }[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * ops / TF32_OPS_PER_S * 1e3
    tc = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return {"tensor_cores": tc, "cuda_cores": _bound(nbytes, ops)}


def phase_flash_timing(dev, pairs=20):
    """The flash kernels at the GPT2 path's shape: the tensor-core
    forward, dq and dk/dv against the first port's scalar ones and SDPA's
    forward and backward, and the port's whole backward (delta, dq, dk/dv)
    against SDPA's, as ``pairs`` alternating rounds (each side the median
    of 25 CUDA-event timings); the plain versions timed once."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops import flash_attention as fa
    bh, t, d = FLASH_SHAPE
    q, k, v, g = _flash_inputs(dev, bh, t, d, torch.float32, 0)
    args = _flash_args(d, FLASH_RATE)
    o, lse = fa.flash_fwd(q, k, v, *args)
    delta = torch.sum(g * o, dim=-1)
    # the same attention as one library call, (B, H, T, D) views of the
    # (BH, T, D) tensors; its backward through autograd
    q4, k4, v4, g4 = (x.view(bh // 12, 12, t, d) for x in (q, k, v, g))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, dropout_p=FLASH_RATE)
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
    out = sdpa(*leaves)
    bwd_in = (q, k, v, g, lse, delta)

    def port_bwd():
        # as _Flash.backward: delta, then dq, then dk/dv
        dl = torch.sum(g * o, dim=-1)
        fa.flash_bwd_dq(q, k, v, g, lse, dl, *args)
        fa.flash_bwd_dkv(q, k, v, g, lse, dl, *args)
    ms = _alternate({
        "fwd": lambda: fa.flash_fwd(q, k, v, *args),
        "fwd_v1": lambda: fa.flash_fwd_v1(q, k, v, *args),
        "dq": lambda: fa.flash_bwd_dq(*bwd_in, *args),
        "dq_v1": lambda: fa.flash_bwd_dq_v1(*bwd_in, *args),
        "dkv": lambda: fa.flash_bwd_dkv(*bwd_in, *args),
        "dkv_v1": lambda: fa.flash_bwd_dkv_v1(*bwd_in, *args),
        "bwd": port_bwd,
        "sdpa_fwd": lambda: sdpa(q4, k4, v4),
        "sdpa_bwd": lambda: torch.autograd.grad(out, leaves, g4,
                                                retain_graph=True),
    }, pairs)
    med = {name: float(np.median(x)) for name, x in ms.items()}
    plain_fwd = _time_ms(lambda: fa.flash_fwd_plain(q, k, v, *args))
    plain_bwd = _time_ms(lambda: fa.flash_bwd_plain(q, k, v, g, *args))
    at = f"BH={bh}, T={t}, D={d}, f32, rate {FLASH_RATE}"

    def row(ms_, plain_ms, library_ms, kind, route):
        cost = _flash_cost(kind, bh, t, d)
        return dict(ms=ms_, plain_ms=plain_ms, library_ms=library_ms,
                    cost=cost["tensor_cores"], at=at, flash_route=route,
                    bound_cuda_cores_ms=cost["cuda_cores"][0])
    tc, v1 = "tensor cores, 3xTF32", "CUDA cores, scalar FMA"
    rows = {
        "flash_fwd": row(med["fwd"], plain_fwd, med["sdpa_fwd"], "fwd", tc),
        "flash_fwd_v1": row(med["fwd_v1"], plain_fwd, med["sdpa_fwd"],
                            "fwd", v1),
        "flash_bwd_dq": row(med["dq"], plain_bwd, med["sdpa_bwd"], "dq",
                            tc),
        "flash_bwd_dq_v1": row(med["dq_v1"], plain_bwd, med["sdpa_bwd"],
                               "dq", v1),
        "flash_bwd_dkv": row(med["dkv"], plain_bwd, med["sdpa_bwd"], "dkv",
                             tc),
        "flash_bwd_dkv_v1": row(med["dkv_v1"], plain_bwd, med["sdpa_bwd"],
                                "dkv", v1),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} ({at}; {r['flash_route']}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind}; "
              f"3xTF32 on the tensor cores), {r['bound_cuda_cores_ms']:.5f} "
              f"ms on the CUDA cores", flush=True)
    for new, old, lib in (("fwd", "fwd_v1", "sdpa_fwd"),
                          ("dq", "dq_v1", "sdpa_bwd"),
                          ("dkv", "dkv_v1", "sdpa_bwd")):
        ratio = [a / b for a, b in zip(ms[old], ms[new])]
        print(f"time flash {new} ({pairs} alternating rounds): tensor cores "
              f"{med[new]:.4f} ms, v1 {med[old]:.4f} ms (v1 / new: median "
              f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
              f"{max(ratio):.3f}), {lib} {med[lib]:.4f} ms", flush=True)
    ratio = [a / b for a, b in zip(ms["sdpa_bwd"], ms["bwd"])]
    print(f"time flash backward ({pairs} alternating rounds): delta + dq + "
          f"dk/dv {med['bwd']:.4f} ms, SDPA's backward {med['sdpa_bwd']:.4f}"
          f" ms (SDPA / port: median {float(np.median(ratio)):.3f}, min "
          f"{min(ratio):.3f}, max {max(ratio):.3f})", flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(x, 4) for x in v]}" for name, v in ms.items()),
          flush=True)
    print("  library: flash_fwd = scaled_dot_product_attention(is_causal, "
          f"dropout_p={FLASH_RATE}) forward; flash_bwd_dq, flash_bwd_dkv = "
          "its whole autograd backward (dq, dk, dv together); plain ms of "
          "the backward rows = the plain forward's autograd (dq, dk, dv "
          "together)", flush=True)
    return rows


# kernel classes of the round's device-time breakdown, by name substring
_KERNEL_CLASSES = (
    ("flash attention (B5-B7)", ("fwd_kernel", "dq_kernel", "dkv_kernel",
                                 "fwd_v1_kernel", "dq_v1_kernel",
                                 "dkv_v1_kernel")),
    ("hardware-RNG dropout (B8)", ("hw_dropout_kernel",)),
    ("sketch and top-k (B1-B3)", ("sketch_kernel", "count_kernel",
                                  "select_kernel", "tie_count_kernel",
                                  "exclusive_scan_kernel", "est_hist_kernel",
                                  "digit_hist_kernel", "rows_hist_kernel",
                                  "segment_sum_kernel")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
)


_ELEMENTWISE = (("add", r"AddFunctor|CUDAFunctor_add|add_kernel"),
                ("fill", r"FillFunctor|fill_kernel"))


def _kernel_class(name: str) -> str:
    for label, keys in _KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def _profile_round(name, learner, call):
    """One more round (round 3's batch again) under ``torch.profiler``:
    device time by kernel class and the top kernels, beside the round's
    wall time. Prints the breakdown and returns the names of the kernels
    the round ran; checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ids, batch, mask = call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train_round(ids, batch, mask)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the host's calls that launch a kernel, as the runtime saw them
    host_launches = sum(e.count for e in averages
                        if e.device_type == DeviceType.CPU
                        and re.fullmatch(r"cu(da)?LaunchKernel(ExC|Ex)?",
                                         e.key))
    if not kernels:
        print(f"profile {name} round: the profiler recorded no device time",
              flush=True)
        return []
    by_class = {}
    for e in kernels:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    print(f"profile {name} round (torch.profiler, one round): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}, host kernel launches "
          f"{host_launches}; by class: " + ", ".join(
              f"{c} {ms:.3f} ms ({ms / busy_ms:.4f})"
              for c, ms in sorted(by_class.items(), key=lambda x: -x[1])),
          flush=True)
    # the elementwise adds and fills (before the per-leaf gradient, the
    # (d,) zero fill and add of every leaf's slice backward)
    for label, pattern in _ELEMENTWISE:
        hits = [e for e in kernels if re.search(pattern, e.key)]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"  {label}: {ms:.3f} ms x{sum(e.count for e in hits)} in "
              f"{len(hits)} kernels", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{_kernel_class(e.key)}: {e.key[:90]}", flush=True)
    torch.cuda.synchronize()
    return [e.key for e in kernels]


def phase_gpt2_path(tmpdir, name, profile=False):
    """3 rounds of a GPT2 path; launches of the rounds and of the
    validation pass read apart; then, with ``profile``, one more round
    under the profiler."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    extra, namespace, want = GPT2_PATHS[name]
    args = build_gpt2_parser().parse_args(GPT2_FLAGS + extra + [
        "--dataset_dir", tmpdir])
    for key, value in namespace.items():
        setattr(args, key, value)
    np.random.seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, max_rounds=3, log=False)
    torch.cuda.synchronize()
    launches = row["launches_after_rounds"]
    val = {k: v - launches.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
           if v - launches.get(k, 0)}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    n_layer = learner.model.config.n_layer
    if val != {"flash_fwd": n_layer * row["val_batches"]}:
        raise AssertionError(f"{name}: validation launches {val} over "
                             f"{row['val_batches']} batches, expected "
                             f"flash_fwd {n_layer} a batch")
    rounds = row["rounds"]
    w = learner.state.weights
    if len(rounds) != 3 or learner.cfg.grad_size != D_GPT2 \
            or w.shape != (D_GPT2,):
        raise AssertionError(f"{name}: {len(rounds)} rounds, d = "
                             f"{learner.cfg.grad_size}")
    if not all(math.isfinite(r["loss"]) for r in rounds) \
            or not bool(torch.isfinite(w).all()) \
            or not math.isfinite(row["nll"]):
        raise AssertionError(f"{name}: non-finite loss, weights or val nll")
    if any(r["upload_bytes"] != GPT2_WORKERS * GPT2_UPLOAD[name]
           for r in rounds):
        raise AssertionError(f"{name}: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]} are "
                             f"not {GPT2_UPLOAD[name]} per client x "
                             f"{GPT2_WORKERS}")
    if learner.host_store is not None:
        print(f"path {name}: host arenas {learner.host_store.nbytes()} B "
              f"for {learner.host_store.num_rows} clients, pipeline "
              f"{learner._offload_pipe.stats}", flush=True)
    fused = learner.model.config.fused_lm_head
    if fused != (args.max_seq_len >= 512):
        raise AssertionError(f"{name}: fused LM head {fused} at T "
                             f"{args.max_seq_len}")
    print(f"path {name}: d = {learner.cfg.grad_size}, launches {launches}, "
          f"T {args.max_seq_len}, fused LM head {fused}, "
          f"validation launches {val} over {row['val_batches']} batches, "
          f"losses {[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, upload B "
          f"{[int(r['upload_bytes']) for r in rounds]}, val nll "
          f"{row['nll']:.6f}, mc_acc {row['mc_acc']:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if profile:
        names = _profile_round(name, learner, row["last_batch"])
        # download_counts reads last_changed W times, with no histogram
        hist = [k for k in names
                if re.search(r"[Bb]incount|kernelHistogram1D", k)]
        if hist:
            raise AssertionError(f"{name}: the profiled round ran {hist}")
    del learner, row
    torch.cuda.empty_cache()
    return launches


def phase_repeat_gpt2(tmpdir):
    """Reproducibility of the GPT2 path (ROADMAP C5b): two runs of 3
    rounds through ``training.gpt2.train`` with ``GPT2_FLAGS`` from the
    same seed must give bitwise equal per-round losses, weights,
    Vvelocity and Verror. The first run is freed before the second."""
    import torch

    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    runs = []
    for i in range(2):
        args = build_gpt2_parser().parse_args(GPT2_FLAGS + [
            "--dataset_dir", tmpdir])
        np.random.seed(args.seed)
        with _RoundTables() if i == 0 else nullcontext() as rec:
            learner, row = train(args, max_rounds=3, log=False)
        if i == 0:
            # mesh_tp_gpt2's comparison: round 1's table and the aggregate
            # it sketched, the rounds' losses and bytes
            GPT2_ROUND1.update(
                table=rec.tables[0].cpu().numpy(),
                agg=rec.dense[0].cpu().numpy(),
                losses=[r["loss"] for r in row["rounds"]],
                up=[r["upload_bytes"] for r in row["rounds"]],
                down=[r["download_bytes"] for r in row["rounds"]])
            del rec
        s = learner.state
        runs.append(([r["loss"] for r in row["rounds"]],
                     s.weights.clone(), s.opt.Vvelocity.clone(),
                     s.opt.Verror.clone()))
        del learner, row, s
        torch.cuda.empty_cache()
    (la, *ta), (lb, *tb) = runs
    same = [_same_bits(a, b) for a, b in zip(ta, tb)]
    if [x.hex() for x in la] != [x.hex() for x in lb] or not all(same):
        raise AssertionError(f"the gpt2 path is not reproducible: losses "
                             f"{la} vs {lb}; weights, Vvelocity, Verror "
                             f"bitwise equal: {same}")
    print(f"repeat gpt2 (3 rounds twice, same seed, d = {ta[0].numel()}): "
          f"losses {[round(v, 6) for v in la]}, losses, weights, Vvelocity "
          f"and Verror bitwise equal", flush=True)
    ref = (la, ta[0])
    del runs, ta, tb
    torch.cuda.empty_cache()
    return ref


GPT2_SCAN_K = 3
#: the gpt2 path's round 1 (``phase_repeat_gpt2``'s first run)
GPT2_ROUND1 = {}


def phase_gpt2_scan(tmpdir, ref):
    """gpt2_scan: ``GPT2_FLAGS`` with --scan_rounds 3 through
    ``training.gpt2.train`` for 3 rounds (one window), the launch counters
    zeroed just before and read when the validation pass starts (the gpt2
    path's); the host syncs inside the window's dispatch recorded (none);
    per-round losses and weights bitwise those of the gpt2 path's 3
    rounds, ``ref`` = (losses, weights) from ``phase_repeat_gpt2``."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    args = build_gpt2_parser().parse_args(GPT2_FLAGS + [
        "--scan_rounds", str(GPT2_SCAN_K), "--dataset_dir", tmpdir])
    np.random.seed(args.seed)
    cuda_lib.LAUNCHES.clear()
    with _SyncWatch() as watch:
        learner, row = train(args, max_rounds=GPT2_SCAN_K, log=False)
    torch.cuda.synchronize()
    launches = row["launches_after_rounds"]
    if launches != GPT2_PATHS["gpt2"][2]:
        raise AssertionError(f"gpt2_scan: launch counts {launches} != "
                             f"{GPT2_PATHS['gpt2'][2]}")
    if watch.windows != 1 or watch.syncs:
        raise AssertionError(f"gpt2_scan: {watch.windows} windows, host "
                             f"syncs inside them: {watch.syncs}")
    rounds = row["rounds"]
    losses, weights = ref
    if [r["loss"].hex() for r in rounds] != [v.hex() for v in losses] \
            or not _same_bits(learner.state.weights, weights):
        raise AssertionError(f"gpt2_scan: losses "
                             f"{[r['loss'] for r in rounds]} vs {losses}, "
                             f"or the weights differ from the gpt2 path's")
    if any(r["upload_bytes"] != GPT2_WORKERS * GPT2_UPLOAD["gpt2"]
           for r in rounds):
        raise AssertionError(f"gpt2_scan: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]}")
    print(f"path gpt2_scan: {GPT2_SCAN_K} rounds in one window, launches "
          f"{launches}, losses {[round(r['loss'], 6) for r in rounds]}, "
          f"losses and weights bitwise the gpt2 path's, no host sync inside "
          f"the window; round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, val nll "
          f"{row['nll']:.6f}", flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


def _gpt2_small_batch(dev, B=32, C=2, T=256, seed=5):
    """One full-width batch of the headline GPT2 round's shape (32 dialogs
    x 2 candidates x 256 tokens, byte-tokenizer ids), on the card."""
    import torch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 261, (B, C, T))
    cols = (ids, rng.randint(T // 2, T, (B, C)),
            np.where(rng.rand(B, C, T) < 0.3, ids, -1),
            np.full((B,), C - 1), rng.randint(256, 261, (B, C, T)))
    return tuple(torch.from_numpy(np.asarray(c, np.int32)).to(dev)
                 for c in cols)


def _gpt2_small(dev):
    """GPT2-small (d = 124,051,201, blockwise attention, dropout 0.1 in
    the flash kernels and at every other site) from seeded weights."""
    import torch

    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config.small(vocab_size=50262)
    cfg.attn_impl = "blockwise"
    return GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)


def _gpt2_small_grad(model, batch, fused=False, remat=False):
    """The flat gradient and summed loss of ``model`` with its config's
    ``fused_lm_head`` and ``remat`` set as asked, on ``batch`` under a
    fixed dropout seed; with the ms of the second of two such steps,
    their peak memory and the flash launches of one step."""
    import torch

    from commefficient_tpu_torch.federated.client import \
        _masked_loss_and_grad
    from commefficient_tpu_torch.federated.losses import \
        make_gpt2_train_loss
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.utils.params import flatten_params
    model.config.fused_lm_head, model.config.remat = fused, remat
    flat, unflatten = flatten_params(model)
    mask = torch.ones(batch[0].shape[0], device=flat.device)
    loss_fn = make_gpt2_train_loss(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        grad = None
        before = cuda_lib.LAUNCHES.get("flash_fwd", 0)
        t0 = time.perf_counter()
        grad, loss, _ = _masked_loss_and_grad(loss_fn, unflatten, flat,
                                              batch, mask, seed=17)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = cuda_lib.LAUNCHES.get("flash_fwd", 0) - before
    del flat
    return grad, float(loss), ms, peak, launches


def _alternate_grads(model, batch, key, pairs):
    """``pairs`` alternating rounds of ``_gpt2_small_grad`` with ``key``
    (``fused`` or ``remat``) off and on, off first in even rounds: each
    side's first gradient and loss, its times and flash launches a round
    and its largest peak memory."""
    import torch
    out = {}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            grad, loss, ms, peak, launches = _gpt2_small_grad(
                model, batch, **{key: on})
            side = out.setdefault(on, dict(grad=grad, loss=loss, ms=[],
                                           peak=0.0, launches=[]))
            side["ms"].append(ms)
            side["peak"] = max(side["peak"], peak)
            side["launches"].append(launches)
            del grad
            torch.cuda.empty_cache()
    return out[False], out[True]


def _report_alternation(tag, off, on):
    diff = [b - a for a, b in zip(off["ms"], on["ms"])]
    print(f"  {tag} ({len(diff)} alternating rounds, the second of two "
          f"steps each): on {[round(x, 3) for x in on['ms']]}, off "
          f"{[round(x, 3) for x in off['ms']]}; median on "
          f"{np.median(on['ms']):.3f} ms, off {np.median(off['ms']):.3f} "
          f"ms, median difference {np.median(diff):.3f} ms", flush=True)


def phase_fused_ce(model, batch, pairs=3):
    """GPT2-small's loss and gradient on one full-width batch with the
    vocab-chunked fused LM head against the materialized logits, float32
    with TF32 off: loss within 1e-5 relative, gradient within 1e-4 of its
    largest magnitude; each side's time (``pairs`` alternating rounds) and
    peak memory printed."""
    off, on = _alternate_grads(model, batch, "fused", pairs)
    l0, l1 = off["loss"], on["loss"]
    rel = abs(l1 - l0) / abs(l0)
    err = float((on["grad"] - off["grad"]).abs().max()) / float(
        off["grad"].abs().max())
    print(f"fused_ce (GPT2-small, {tuple(batch[0].shape)}, f32, TF32 off): "
          f"loss {l1:.6f} vs materialized {l0:.6f} (rel {rel:.3e}), "
          f"gradient max err {err:.3e} of max |g|; fused peak "
          f"{on['peak']:.2f} GiB, materialized peak {off['peak']:.2f} GiB",
          flush=True)
    _report_alternation("fused head against materialized logits", off, on)
    if not (rel <= 1e-5 and err <= 1e-4):
        raise AssertionError(f"fused_ce: loss rel {rel}, gradient {err} of "
                             "max |g|")


def phase_remat(model, batch, pairs=3):
    """The same batch with ``GPT2Config.remat`` on and off: the gradients
    bitwise equal (the recomputed forward draws the same dropout bits),
    each flash forward launched twice under remat (24 against 12) in every
    step; each side's peak memory, time (``pairs`` alternating rounds) and
    launches printed."""
    off, on = _alternate_grads(model, batch, "remat", pairs)
    g0, g1, l0, l1 = off["grad"], on["grad"], off["loss"], on["loss"]
    n0, n1 = set(off["launches"]), set(on["launches"])
    print(f"remat (GPT2-small, {tuple(batch[0].shape)}): gradient bitwise "
          f"equal {_same_bits(g0, g1)}, loss {l1:.6f} vs {l0:.6f}; remat "
          f"peak {on['peak']:.2f} GiB, flash_fwd {n1}; without peak "
          f"{off['peak']:.2f} GiB, flash_fwd {n0}", flush=True)
    _report_alternation("remat against without", off, on)
    if not _same_bits(g0, g1) or l0 != l1 or (n0, n1) != ({12}, {24}):
        raise AssertionError(f"remat: gradient bitwise {_same_bits(g0, g1)}"
                             f", losses {l0} {l1}, flash_fwd {n0} {n1}")


def phase_chunk_host(model, batch, sizes=(1, 2, 4, 8, 16, 32), steps=3):
    """Where a microbatched GPT2 client's time goes: one GPT2-small
    forward and backward (``_masked_loss_and_grad``, as one chunk of the
    per-worker round runs it) on the first n dialogs of ``batch``, for
    each n of ``sizes``. Per n, the medians over the last ``steps - 1`` of
    ``steps`` steps of the host's time until the call returns (the launch
    queue is still draining then), the wall time to a synchronize, and the
    device time from CUDA events around the call; with the flash forward
    launches of a step. Where the host time is at the wall time and above
    the device time, the step waits for the host."""
    import torch

    from commefficient_tpu_torch.federated.client import \
        _masked_loss_and_grad
    from commefficient_tpu_torch.federated.losses import \
        make_gpt2_train_loss
    from commefficient_tpu_torch.utils.params import flatten_params
    model.config.fused_lm_head, model.config.remat = False, False
    flat, unflatten = flatten_params(model)
    loss_fn = make_gpt2_train_loss(model)
    for n in sizes:
        part = tuple(c[:n] for c in batch)
        mask = torch.ones(n, device=flat.device)
        host, wall, device = [], [], []
        for _ in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            grad, _, _ = _masked_loss_and_grad(loss_fn, unflatten, flat,
                                               part, mask, seed=17)
            end.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
            device.append(start.elapsed_time(end))
            del grad
        print(f"chunk host (GPT2-small, {n} dialogs x {batch[0].shape[1]} "
              f"x {batch[0].shape[2]}): host {np.median(host[1:]):.3f} ms, "
              f"wall {np.median(wall[1:]):.3f} ms, device (events) "
              f"{np.median(device[1:]):.3f} ms; steps host "
              f"{[round(x, 3) for x in host]}, wall "
              f"{[round(x, 3) for x in wall]}", flush=True)
    del flat
    torch.cuda.empty_cache()


def _download_counts_bincount(last_changed, stale_round):
    """The port's download counts before it dropped ``bincount``: one
    sorted search and a histogram of d buckets into W + 1 bins."""
    import torch
    W = stale_round.shape[0]
    order = torch.argsort(stale_round, stable=True)
    buckets = torch.searchsorted(stale_round[order].contiguous(),
                                 last_changed.contiguous(), right=True)
    below = torch.cumsum(torch.bincount(buckets, minlength=W + 1), 0)[:W]
    counts = torch.zeros(W, dtype=torch.int32, device=last_changed.device)
    counts[order] = (last_changed.shape[0] - below).to(torch.int32)
    return counts


def phase_download_counts(dev, pairs=6):
    """``download_counts`` (W comparison-and-count reductions) against the
    ``bincount`` formulation at GPT2's d with W = 4 and ResNet9's with W =
    8, on random ``last_changed`` in [-2, 5] with tied stale rounds and a
    never-pulled client, and at GPT2's d as after 3 gpt2 rounds (all but
    3 x 50,000 weights at -2): bitwise equal; both timed as alternating
    pairs."""
    import torch

    from commefficient_tpu_torch.federated.round import download_counts
    rng = np.random.RandomState(8)
    for d, W, case in ((D_GPT2, GPT2_WORKERS, "random"),
                       (D_RESNET9, 8, "random"),
                       (D_GPT2, GPT2_WORKERS, "3 rounds")):
        if case == "random":
            lc = rng.randint(-2, 6, d).astype(np.int32)
            stale = rng.randint(-1, 6, W).astype(np.int32)
            stale[0], stale[W // 2:] = -1, stale[W // 2]
        else:
            lc = np.full(d, -2, np.int32)
            lc[rng.randint(0, d, 3 * K)] = np.repeat(
                np.arange(3, dtype=np.int32), K)
            stale = np.array([-1, -1, 0, 1], np.int32)
        last_changed = torch.from_numpy(lc).to(dev)
        stale = torch.from_numpy(stale).to(dev)
        new = download_counts(last_changed, stale)
        old = _download_counts_bincount(last_changed, stale)
        if not _same_bits(new, old):
            raise AssertionError(f"download_counts at d = {d}, W = {W}: "
                                 f"{new.tolist()} != {old.tolist()}")
        ms = _alternate({
            "new": lambda: download_counts(last_changed, stale),
            "bincount": lambda: _download_counts_bincount(last_changed,
                                                          stale)}, pairs)
        bound = W * 4 * d / HBM_BYTES_PER_S * 1e3
        print(f"download_counts d = {d}, W = {W} ({case}): bitwise equal "
              f"to the bincount formulation ({new.tolist()}); {pairs} "
              f"alternating "
              f"pairs, median ms: new {np.median(ms['new']):.4f}, bincount "
              f"{np.median(ms['bincount']):.4f}; W sweeps of last_changed "
              f"at HBM rate {bound:.4f}", flush=True)
        del last_changed, lc
    torch.cuda.empty_cache()


# name: (GPT2Config attributes, launches of the card's 2 rounds). With
# tpu_bits the attention dropout goes on the attention output on both
# sides ("output"): under "auto" the card would drop the probabilities in
# the flash kernels and the CPU the output. 8 sites a forward (embedding,
# 2 x (attention output, projection, MLP), mc head), 8 in the backward.
GPT2_REFERENCE_CASES = {
    "dropout 0": (dict(dropout=0.0), {"flash_fwd": 4}),
    "tpu_bits, dropout 0.1": (dict(dropout=0.1, dropout_impl="tpu_bits",
                                   attn_dropout="output"),
                              {"flash_fwd": 4, "hw_dropout": 32}),
}


def phase_gpt2_reference(dev):
    """Two sketch rounds of a narrow GPT2 learner with the flash kernels
    (and with tpu_bits the hardware-RNG dropout kernel) on the card and
    the plain versions on the CPU, from the same weights, batches and
    seeds, per case of ``GPT2_REFERENCE_CASES``."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import (
        make_gpt2_train_loss, make_gpt2_val_loss)
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.ops import cuda_lib
    W, B, C, T = 4, 2, 2, 64
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 261, (W, B, C, T)).astype(np.int32)
        cols = (ids, rng.randint(T // 2, T, (W, B, C)).astype(np.int32),
                np.where(rng.rand(W, B, C, T) < 0.3, ids, -1).astype(
                    np.int32), np.full((W, B), C - 1, np.int32),
                rng.randint(256, 261, (W, B, C, T)).astype(np.int32))
        batches.append((rng.choice(8, W, replace=False).astype(np.int32),
                        cols, np.ones((W, B), np.float32)))
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=500, num_cols=4000, num_rows=5,
                    num_clients=8, num_workers=W, weight_decay=0.0)
    for case, (attrs, want) in GPT2_REFERENCE_CASES.items():
        outs = {}
        for device in ("cpu", dev):
            gcfg = GPT2Config(vocab_size=300, n_positions=T, n_embd=64,
                              n_layer=2, n_head=4, attn_impl="blockwise")
            for key, value in attrs.items():
                setattr(gcfg, key, value)
            model = GPT2DoubleHeads(gcfg).reset_parameters(
                torch.Generator().manual_seed(0))
            learner = FedLearner(model, cfg, make_gpt2_train_loss(model),
                                 make_gpt2_val_loss(model), device=device)
            before = dict(cuda_lib.LAUNCHES)
            ms = [learner.train_round(ids, cols, m, epoch_frac=r)
                  for r, (ids, cols, m) in enumerate(batches)]
            outs[str(device)] = (ms, {
                k: cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in want})
        (m_cpu, n_cpu), (m_gpu, n_gpu) = outs["cpu"], outs[str(dev)]
        if any(n_cpu.values()) or n_gpu != want:
            raise AssertionError(f"gpt2 reference ({case}): launches "
                                 f"{n_cpu} on the CPU, {n_gpu} on the card, "
                                 f"expected none and {want}")
        for a, b in zip(m_cpu, m_gpu):
            if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
                raise AssertionError(f"gpt2 reference ({case}): loss cpu "
                                     f"{a['loss']} != cuda {b['loss']}")
            if (a["download_bytes"], a["upload_bytes"]) != (
                    b["download_bytes"], b["upload_bytes"]):
                raise AssertionError(f"gpt2 reference ({case}): byte "
                                     "metrics differ")
        print(f"reference gpt2 ({case}; 2 layers, n_embd 64, T {T}, 2 "
              f"sketch rounds, cuda kernels {n_gpu} vs cpu): losses "
              f"{[round(m['loss'], 6) for m in m_gpu]} vs "
              f"{[round(m['loss'], 6) for m in m_cpu]}, bytes equal",
              flush=True)


SOURCES = {
    "sketch": ("commefficient_tpu_torch/csrc/sketch.cu",
               "commefficient_tpu/ops/sketch_kernels.py:285"),
    "count": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
              "commefficient_tpu/ops/topk_kernels.py:200"),
    "select": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
               "commefficient_tpu/ops/topk_kernels.py:355"),
    "count_plain": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                    "commefficient_tpu/ops/topk_kernels.py:200"),
    "select_plain": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "select_resid": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "estimates": ("commefficient_tpu_torch/csrc/estimates.cu",
                  "commefficient_tpu/ops/sketch_kernels.py:183"),
    "flash_fwd": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                  "commefficient_tpu/ops/flash_attention.py:183"),
    "flash_bwd_dq": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                     "commefficient_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                      "commefficient_tpu/ops/flash_attention.py:356"),
    "flash_fwd_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                     "commefficient_tpu/ops/flash_attention.py:183"),
    "flash_bwd_dq_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                        "commefficient_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                         "commefficient_tpu/ops/flash_attention.py:356"),
    "sketch_batched": ("commefficient_tpu_torch/csrc/sketch.cu",
                       "commefficient_tpu/ops/sketch_kernels.py:285 "
                       "(batched grid :381)"),
    "estimates_batched": ("commefficient_tpu_torch/csrc/estimates.cu",
                          "commefficient_tpu/ops/sketch_kernels.py:183 "
                          "(batched grid :248)"),
    "hw_dropout": ("commefficient_tpu_torch/csrc/hw_dropout.cu",
                   "commefficient_tpu/ops/dropout.py:121"),
    "est_hist": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                 "commefficient_tpu/ops/topk_kernels.py:200"),
    "digit_hist": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                   "commefficient_tpu/ops/topk_kernels.py:200"),
    "radix_compact": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                      "commefficient_tpu/ops/topk_kernels.py:355"),
    "radix_select": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "rows_hist": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                  "commefficient_tpu/ops/topk_kernels.py:200"),
    "rows_select": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                    "commefficient_tpu/ops/topk_kernels.py:355"),
    "rows_resid": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                   "commefficient_tpu/ops/topk_kernels.py:355"),
}


# ---- the serving and online stack (ROADMAP A11) -------------------------

SERVE_SLOTS = 8
SERVE_REQUESTS = 32
SERVE_NEW = 24
SERVE_PREFILL = 256       # the GPT2 entry point's --max_seq_len: its window
SERVE_MAX_LEN = 288       # prompt and reply: 256 + 24, rounded up to pages
SERVE_PAGE = 16
SERVE_FULL_RECOMPUTE = 4
SERVE_WARMUP_NEW = 2      # the warm-up burst: the first 8 prompts, 2 tokens
SPEC_K = 4
# the online entry point at GPT2-small's width: 8 personas, two workers of
# two single-candidate examples a cohort, a cohort every 2 interactions
# and a swap after every apply, until 2 swaps
ONLINE_FLAGS = ["--model", "gpt2", "--vocab_pad_to", "50262", "--attn_impl",
                "blockwise", "--mode", "local_topk", "--error_type", "local",
                "--client_state", "sparse", "--k", "50000", "--server_mode",
                "buffered", "--serve_personalized", "--serve_online",
                "--serve_slots", "8", "--online_train_every", "2",
                "--online_swap_every", "1", "--max_seq_len", "128",
                "--num_workers", "2", "--local_batch_size", "2",
                "--lr_scale", "0.04", "--weight_decay", "0", "--seed", "3",
                "--device", "cuda"]


def _serve_model(dev, n_layer=12, seed=0):
    """GPT2-small (or its first ``n_layer`` layers' shape) from seeded
    weights, float32, blockwise attention, with its params dict."""
    import torch

    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config.small(vocab_size=50262)
    cfg.attn_impl = "blockwise"
    cfg.n_layer = n_layer
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(seed)).to(dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    return model, params


def _serve_prompts(tmpdir, n):
    """The first ``n`` interactions of the online loop's traffic
    (``online.build_traffic``: users round-robin) over the GPT2 entry
    point's SyntheticPersona at --max_seq_len ``SERVE_PREFILL``, with the
    tokenizer: each as (persona, history, ids, types), where persona and
    history are the raw dialogs' context that ``sample_reply`` builds the
    same prompt from."""
    from commefficient_tpu_torch.data.persona import (
        build_input_from_segments, tokenize_tree)
    from commefficient_tpu_torch.data.tokenizer import get_tokenizer
    from commefficient_tpu_torch.online import build_traffic
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       make_persona)
    args = build_gpt2_parser().parse_args([
        "--model", "gpt2", "--max_seq_len", str(SERVE_PREFILL),
        "--dataset_dir", os.path.join(tmpdir, "serve")])
    tok = get_tokenizer(args.model_checkpoint, verbose=False)
    train_set = make_persona(args, tok, train=True)
    traffic, _ = build_traffic(train_set)
    contexts = {}
    for dialog in train_set._raw_dialogs()["train"]:
        persona = tokenize_tree(dialog["personality"], tok)
        for utt in dialog["utterances"]:
            history = tokenize_tree(
                utt["history"][-(2 * args.max_history + 1):], tok)
            ids = build_input_from_segments(persona, history, [], tok,
                                            with_eos=False)["input_ids"]
            contexts.setdefault(tuple(ids), (persona, history))
    out = []
    for item in traffic[:n]:
        if tuple(item["prompt"]) not in contexts:
            raise AssertionError("serve_gpt2: a traffic prompt has no "
                                 "context in the raw dialogs")
        out.append(contexts[tuple(item["prompt"])] + (item["prompt"],
                                                      item["types"]))
    if len(out) != n:
        raise AssertionError(f"serve_gpt2: {len(out)} traffic items, not {n}")
    return tok, out


def _cloned(x):
    import torch
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(y) for y in x)
    return x


def _topk_select_plain(vec, kk, k, with_mask=False):
    """``topk_select``'s plain versions (the digit radix, then the select)
    on the card: what its CPU branch computes."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    rows = vec.reshape(1, -1) if vec.dim() == 1 else vec
    kk = (kk.to(device=vec.device, dtype=torch.int64).expand(rows.shape[0])
          if torch.is_tensor(kk) else
          torch.full((rows.shape[0],), int(kk), dtype=torch.int64,
                     device=vec.device))
    t, n_take = tk.radix_threshold_rows_plain(tk._score_bits(rows), kk)
    masked, mask = tk.select_rows_plain(rows, t, n_take, with_mask)
    if vec.dim() == 1:
        masked = masked[0]
        mask = None if mask is None else mask[0]
    return (masked, mask) if with_mask else masked


class _KernelInputs:
    """Keeps the inputs and outputs of the first call on the card, at each
    distinct (shape, dtype, dropout rate), of the flash kernels' wrappers
    (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) and, at each
    distinct shape, of ``topk_select`` (the per-row radix: ``rows_hist``
    and ``rows_select``), so that ``check`` holds each against its plain
    version on those very inputs after the run. Copies tensors; adds no
    counted launch."""

    FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def __enter__(self):
        from commefficient_tpu_torch.ops import flash_attention as fa
        from commefficient_tpu_torch.ops import topk_kernels as tk
        self.calls = {}
        self._saved = [(fa, n, getattr(fa, n)) for n in self.FLASH] + [
            (tk, "topk_select", tk.topk_select)]
        for owner, name, f in self._saved:
            setattr(owner, name, self._recording(name, f))
        return self

    def _recording(self, name, f):
        def call(*args, **kwargs):
            out = f(*args, **kwargs)
            x = args[0]
            key = (name, tuple(x.shape), x.dtype,
                   args[-1] if name in self.FLASH else None)
            if x.is_cuda and key not in self.calls:
                self.calls[key] = (_cloned(args), dict(kwargs), _cloned(out))
            return out
        return call

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)

    def check(self, tag, errs):
        """Each kept call against its plain version on its own inputs: the
        flash kernels within ``phase_flash_parity``'s limits
        (``_flash_bad``), the top-k's masked rows and mask bitwise. Folds
        the errors into ``errs``; prints each. Returns the names seen."""
        import torch

        from commefficient_tpu_torch.ops import flash_attention as fa
        for (name, shape, dtype, rate), (args, kwargs,
                                         out) in self.calls.items():
            if name == "topk_select":
                vec, kk, k = args[:3]
                with_mask = kwargs.get("with_mask",
                                       args[3] if len(args) > 3 else False)
                ref = _topk_select_plain(vec, kk, k, with_mask)
                got, ref = ((out, ref) if with_mask else ((out,), (ref,)))
                if not (_same_bits(got[0], ref[0]) and (
                        not with_mask or torch.equal(got[1], ref[1]))):
                    raise AssertionError(f"{tag}: topk_select {shape} (k "
                                         f"{k}) != its plain version on the "
                                         f"run's own input")
                for kernel in ("rows_hist", "rows_select"):
                    errs[kernel] = max(errs[kernel],
                                       _max_abs_err(got[0], ref[0]))
                print(f"{tag}: topk_select (rows_hist, rows_select) at "
                      f"{shape}, k {k}: masked rows"
                      f"{' and mask' if with_mask else ''} bitwise equal "
                      f"to the plain version on the run's own input, "
                      f"{int(got[0].ne(0).sum())} kept", flush=True)
                continue
            if name == "flash_fwd":
                ref, names = fa.flash_fwd_plain(*args), ("o", "lse")
            else:
                q, k, v, do, _, _, *cfg = args
                dq, dk, dv = fa.flash_bwd_plain(q, k, v, do, *cfg)
                ref, names = (((dq,), ("dq",)) if name == "flash_bwd_dq"
                              else ((dk, dv), ("dk", "dv")))
            got = out if isinstance(out, tuple) else (out,)
            err = dict.fromkeys(_FLASH_NAMES, 0.0)
            rel = dict.fromkeys(_FLASH_NAMES, 0.0)
            for n, a, b in zip(names, got, ref):
                err[n] = _max_abs_err(a, b)
                rel[n] = err[n] / max(float(b.double().abs().max()), 1e-30)
            bad = _flash_bad(dtype, err, rel)
            if bad:
                raise AssertionError(f"{tag}: {name} at {shape} rate {rate} "
                                     f"disagrees with its plain version on "
                                     f"the run's own inputs in {bad}: {err}")
            errs[name] = max([errs[name]] + [err[n] for n in names])
            print(f"{tag}: {name} at (BH, T, D) {shape}, {dtype}, rate "
                  f"{rate} against its plain version on the run's own "
                  f"inputs: max abs err " + ", ".join(
                      f"{n} {err[n]:.3e}" for n in names) + "; relative "
                  f"to max |.|: " + ", ".join(f"{n} {rel[n]:.3e}"
                                              for n in names), flush=True)
        return {name for name, *_ in self.calls}


def _serve_burst(srv, prompts, max_new=SERVE_NEW):
    """Submit every prompt at once and step the server until it drains:
    replies in submission order, with the host clock of each request's
    first token (the end of the step that admitted it), of every step
    that only decoded, the peak pages in use and the wall time."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.submit(ids, types, types[-1], max_new)
            for _, _, ids, types in prompts]
    first, replies, decode_ms, peak_pages = {}, {}, [], 0
    while srv._queued() or any(r is not None for r in srv._slot_req):
        queued = sum(len(q) for q in [srv._queue] + srv._shard_queue)
        ts = time.perf_counter()
        for rid, toks in srv.step():
            replies[rid] = toks
        torch.cuda.synchronize()
        te = time.perf_counter()
        admitted = queued - sum(len(q) for q in [srv._queue]
                                + srv._shard_queue)
        if admitted == 0:
            decode_ms.append((te - ts) * 1e3)
        live = {r.rid for r in srv._slot_req if r is not None}
        for rid in rids:
            if rid not in first and (rid in live or rid in replies):
                first[rid] = te - t0
        if srv.pager is not None:
            peak_pages = max(peak_pages, srv.pager.pages_in_use)
    wall = time.perf_counter() - t0
    return ([replies[r] for r in rids], [first[r] for r in rids], decode_ms,
            peak_pages, wall)


def _serve_server(engine, **kw):
    from commefficient_tpu_torch.serving import ContinuousBatchingServer
    return ContinuousBatchingServer(engine, slots=SERVE_SLOTS,
                                    prefill_len=SERVE_PREFILL,
                                    page_size=SERVE_PAGE, **kw)


def _profile_decode(srv, prompts, steps=8):
    """``steps`` decode-only steps of ``srv`` over 8 fresh requests under
    ``torch.profiler``: wall and device-busy ms a step, the idle share,
    host kernel launches a step and the host's costliest operators.
    Prints; checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _, _, ids, types in prompts[:SERVE_SLOTS]:
        srv.submit(ids, types, types[-1], SERVE_NEW)
    srv.step()                                   # the admissions
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    srv.run()
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev
               if e.device_type == DeviceType.CUDA) / 1e3 / steps
    launches = sum(e.count for e in ev if e.device_type == DeviceType.CPU
                   and re.fullmatch(r"cu(da)?LaunchKernel(ExC|Ex)?",
                                    e.key)) / steps
    top = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:10]
    print(f"profile serve decode step (torch.profiler, {steps} steps of "
          f"{SERVE_SLOTS} rows): wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, host "
          f"kernel launches {launches:.0f} a step; host self time: " +
          ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / steps:.3f} ms "
                    f"x{e.count / steps:.0f}" for e in top), flush=True)


def phase_serve_gpt2(dev, tmpdir, errs):
    """serve_gpt2: the first 32 prompts of the online loop's traffic
    (``_serve_prompts``; greedy, at most 24 new tokens each) through a
    paged ``ContinuousBatchingServer`` of 8 slots with a 256-token prefill
    window over GPT2-small (d = 124,051,201, float32, blockwise attention)
    from seeded weights. A warm-up burst (8 prompts, 2 tokens) runs first;
    the launch counters are zeroed just before the timed burst: every
    prefill launches the flash forward once a layer, and the forward
    agrees with its plain version on the burst's own prefill inputs;
    every reply is token-identical to the request decoded alone by the
    dense-cache engine, and the first 4 to ``sample_reply``'s full
    recompute. Prints tokens/s, time to first token, ms a decode step,
    pages, the weights' and KV pool's bytes and the peak memory above the
    burst's start. Returns (launches, engine, prompts, replies)."""
    import torch

    from commefficient_tpu_torch.models.gpt2_generate import sample_reply
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.serving import DecodeEngine
    tok, prompts = _serve_prompts(tmpdir, SERVE_REQUESTS)
    model, params = _serve_model(dev)
    d = sum(p.numel() for p in params.values())
    if d != D_GPT2:
        raise AssertionError(f"serve_gpt2: d = {d}")
    eos = tok.convert_tokens_to_ids("<eos>")
    engine = DecodeEngine(model, params, eos_id=eos, max_len=SERVE_MAX_LEN)
    srv = _serve_server(engine, kv_cache="paged")
    _serve_burst(srv, prompts[:SERVE_SLOTS], max_new=SERVE_WARMUP_NEW)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    with _KernelInputs() as probe:
        replies, ttft, decode_ms, pages, wall = _serve_burst(srv, prompts)
        torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    above = (torch.cuda.max_memory_allocated() - start) / 2**30
    n_layer = model.config.n_layer
    if launches != {"flash_fwd": n_layer * SERVE_REQUESTS}:
        raise AssertionError(f"serve_gpt2: launches {launches}, expected "
                             f"flash_fwd {n_layer} a prefill x "
                             f"{SERVE_REQUESTS}")
    if probe.check("serve_gpt2", errs) != {"flash_fwd"}:
        raise AssertionError(f"serve_gpt2: the probe saw {list(probe.calls)}")
    del probe
    if srv.pager.pages_in_use != 0:
        raise AssertionError(f"serve_gpt2: {srv.pager.pages_in_use} pages "
                             f"left in use after the burst")
    solo = [engine.generate([(ids, types)], [types[-1]], max_new=SERVE_NEW)[0]
            for _, _, ids, types in prompts]
    bad = [i for i, (a, b) in enumerate(zip(replies, solo)) if a != b]
    if bad:
        raise AssertionError(f"serve_gpt2: replies {bad} differ from the "
                             f"dense engine alone: {replies[bad[0]]} vs "
                             f"{solo[bad[0]]}")
    for i, (persona, history, _, _) in enumerate(
            prompts[:SERVE_FULL_RECOMPUTE]):
        full = sample_reply(model, params, tok, persona, history,
                            max_seq_len=SERVE_MAX_LEN,
                            max_reply_len=SERVE_NEW)
        if full != replies[i]:
            raise AssertionError(f"serve_gpt2: reply {i} {replies[i]} is not "
                                 f"sample_reply's full recompute {full}")
    _profile_decode(_serve_server(engine, kv_cache="paged"), prompts)
    tokens = sum(len(r) for r in replies)
    lengths = [len(ids) for _, _, ids, _ in prompts]
    print(f"serve_gpt2 (GPT2-small d = {d}, float32, blockwise, paged KV "
          f"page {SERVE_PAGE}, {SERVE_SLOTS} slots, prefill window "
          f"{SERVE_PREFILL}, capacity {SERVE_MAX_LEN}; {SERVE_REQUESTS} "
          f"traffic prompts of {min(lengths)}-{max(lengths)} tokens (median "
          f"{np.median(lengths):.1f}) at once, greedy, <= {SERVE_NEW} new, "
          f"after a warm-up burst): {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; time to first token median "
          f"{np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms; "
          f"decode step median {np.median(decode_ms):.3f} ms over "
          f"{len(decode_ms)} decode-only steps; peak pages {pages} of "
          f"{srv.pager.num_pages}; weights {d * 4 / 2**30:.3f} GiB, KV pool "
          f"{srv.stats()['kv_pool_bytes'] / 2**30:.3f} GiB, peak memory "
          f"{above:.3f} GiB above the {start / 2**30:.3f} GiB allocated at "
          f"the burst's start; launches {launches}; replies token-identical "
          f"to the dense engine alone (all {SERVE_REQUESTS}) and to "
          f"sample_reply's full recompute (first {SERVE_FULL_RECOMPUTE}); "
          f"{len({t for r in replies for t in r})} distinct tokens in the "
          f"replies; reply lengths {[len(r) for r in replies]}", flush=True)
    return launches, engine, prompts, replies


def phase_serve_variants(engine, prompts, plain):
    """serve_variants on serve_gpt2's weights and prompts: speculation
    (k 4, greedy) with a 2-layer drafter cut from the target (its
    embeddings, first 2 blocks and head) and self-drafting, which must
    accept at least one draft; --serve_disagg and --kv_quant none;
    each token-identical to the plain server's ``plain`` replies; int8
    and int4 pools hold at least 3x and 7x the users of float32 ones,
    their agreement with float32 printed."""
    import torch

    from commefficient_tpu_torch.ops import kv_quant as kvq
    dmodel, _ = _serve_model(engine.device, n_layer=2)
    dparams = {n: engine.params[n] for n, _ in dmodel.named_parameters()}
    variants = {
        "speculate_k 4, 2-layer drafter cut from the target": dict(
            kv_cache="paged", speculate_k=SPEC_K, drafter_model=dmodel,
            drafter_params=dparams),
        "speculate_k 4, self-drafting": dict(kv_cache="paged",
                                             speculate_k=SPEC_K),
        "serve_disagg": dict(kv_cache="paged", disaggregate=True),
        "kv_quant none": dict(kv_cache="paged", kv_quant="none"),
    }
    for name, kw in variants.items():
        srv = _serve_server(engine, **kw)
        replies, _, decode_ms, _, wall = _serve_burst(srv, prompts)
        bad = [i for i, (a, b) in enumerate(zip(replies, plain)) if a != b]
        if bad:
            raise AssertionError(f"serve_variants {name}: replies {bad} "
                                 f"differ from the plain server's")
        st = srv.stats()
        if name.endswith("self-drafting") and not st["accepted"] > 0:
            raise AssertionError(f"serve_variants {name}: no draft accepted "
                                 f"of {st['drafted']}")
        extra = (f", drafted {st['drafted']}, accepted {st['accepted']}, "
                 f"rejected {st['drafted'] - st['accepted']}, acceptance "
                 f"{st['acceptance_rate']:.4f}" if "drafted" in st else "")
        print(f"serve_variants {name}: token-identical to the plain server "
              f"({SERVE_REQUESTS} replies); "
              f"{sum(len(r) for r in replies) / wall:.1f} tokens/s, step "
              f"median {np.median(decode_ms):.3f} ms{extra}", flush=True)
        del srv
    for mode, want in (("int8", 3.0), ("int4", 7.0)):
        srv = _serve_server(engine, kv_cache="paged", kv_quant=mode)
        replies, _, decode_ms, _, wall = _serve_burst(srv, prompts)
        st = srv.stats()
        mult = st["kv_capacity_multiplier_vs_f32"]
        if mult < want:
            raise AssertionError(f"serve_variants {mode}: capacity "
                                 f"multiplier {mult} < {want}")
        same = sum(a == b for x, y in zip(replies, plain)
                   for a, b in zip(x, y))
        total = sum(len(r) for r in plain)
        cfg = engine.model.config
        f32 = kvq.pool_bytes(srv.pager.num_pages, SERVE_PAGE, cfg.n_head,
                             cfg.n_embd // cfg.n_head, cfg.n_layer, "none")
        print(f"serve_variants kv_quant {mode}: pool {st['kv_pool_bytes']} B "
              f"against {f32} B float32 ({mult:.4f}x the users); token "
              f"agreement with float32 {same}/{total} = {same / total:.4f} "
              f"(the reference holds 0.9 at tiny scale only); "
              f"{sum(len(r) for r in replies) / wall:.1f} tokens/s, step "
              f"median {np.median(decode_ms):.3f} ms", flush=True)
        del srv
    del dmodel, dparams
    torch.cuda.empty_cache()


def phase_serve_online(tmpdir, errs):
    """serve_online: the GPT2 entry point's --serve_online
    (``ONLINE_FLAGS``, what its ``main`` runs) twice from the same seed,
    the launch counters zeroed just before each: at least 2 buffered
    applies and 1 hot swap, no dirty or refused swap, rows_hist and
    rows_select launched by the cohorts and the flash forward by the
    prefills; on the first run, the flash kernels and the cohorts' top-k
    held against their plain versions on the run's own inputs; the two
    runs' replies token for token and final weights bitwise equal
    (ROADMAP C5b). Returns the first run's launches."""
    import torch

    from commefficient_tpu_torch.online import run_online
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (_refuse_unported,
                                                       build_gpt2_parser)
    runs = []
    for i in range(2):
        args = build_gpt2_parser().parse_args(ONLINE_FLAGS + [
            "--dataset_dir", os.path.join(tmpdir, "online")])
        _refuse_unported(args)
        np.random.seed(args.seed)
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        with _KernelInputs() if i == 0 else nullcontext() as probe:
            learner, loop, res = run_online(args, log=False)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        d = learner.cfg.grad_size
        if (res["applies"] < 2 or res["swaps"] < 1 or res["dirty_swaps"]
                or res["refused_swaps"] or d != D_GPT2):
            raise AssertionError(f"serve_online: {res}, d = {d}")
        if not all(launches.get(k, 0) > 0 for k in ("rows_hist",
                                                    "rows_select",
                                                    "flash_fwd")):
            raise AssertionError(f"serve_online: launches {launches}")
        if not all(math.isfinite(x) for x in res["train_losses"]):
            raise AssertionError(f"serve_online: losses "
                                 f"{res['train_losses']}")
        if probe is not None:
            seen = probe.check("serve_online", errs)
            if seen != {*_KernelInputs.FLASH, "topk_select"}:
                raise AssertionError(f"serve_online: the probe saw "
                                     f"{list(probe.calls)}")
            del probe
        print(f"serve_online run {i + 1} (d = {d}): {wall:.1f} s, "
              f"{res['steps']} steps, {res['interactions']} interactions, "
              f"{res['rounds']} cohorts, {res['applies']} applies, "
              f"{res['swaps']} swaps, losses "
              f"{[round(x, 6) for x in res['train_losses']]}, held-out nll "
              f"{res['heldout_nll_first']:.6f} -> "
              f"{res['heldout_nll_last']:.6f}, launches {launches}, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        runs.append((dict(loop.replies), learner.state.weights.clone(),
                     launches))
        del learner, loop, res
        torch.cuda.empty_cache()
    (ra, wa, la), (rb, wb, _) = runs
    if ra != rb or not _same_bits(wa, wb):
        raise AssertionError(f"serve_online is not reproducible: replies "
                             f"equal {ra == rb}, weights bitwise equal "
                             f"{_same_bits(wa, wb)}")
    print(f"serve_online: the two runs' {len(ra)} replies token for token "
          f"and final weights bitwise equal", flush=True)
    del runs, wa, wb
    torch.cuda.empty_cache()
    return la


# ---- the C++ host data plane (ROADMAP A7c) and GPT2's Switch MoE ------

# cifar10_fetchsgd's train batch of a round (8 workers x 32 images) and an
# ImageNet batch of the reference's storage size, cropped to 224
CIFAR_BATCH = (256, 32, 32, 3)
IMAGENET_BATCH = (64, 256, 256, 3)
IMAGENET_ROWS = 512       # rows of the memory-mapped client file
NATIVE_REPS = 9
RRC_TOL = 2e-4
# GPT2_FLAGS + --moe_experts 4: each block's MLP a 4-expert Switch FFN at
# the default capacity factor 1.25 and aux weight 1e-2
MOE_FLAGS = ["--moe_experts", "4"]
D_GPT2_MOE = 124_051_201 + 12 * (18_892_804 - 4_722_432)
MOE_TOKENS = 4096         # one client's 8 dialogs x 2 candidates x 256
MOE_TOL = 1e-5
NEAR_TIE = 1e-6


def _host_ms(fn, reps=NATIVE_REPS) -> float:
    """Median host ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _same_rng(a, b) -> bool:
    sa, sb = a.get_state(), b.get_state()
    return sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) \
        and sa[2:] == sb[2:]


def phase_native_feed():
    """native_feed, on the card machine's host: the C++ data plane against
    the numpy stages on the same inputs and draws: ``pad_crop_batch`` at
    cifar10_fetchsgd's train batch (bitwise), ``rrc_batch`` at an
    ImageNet batch of 64 uint8 images of 256 x 256 x 3 cropped to 224
    (within 2e-4, the ``RandomState`` equal afterwards) and
    ``gather_rows`` of 64 sorted rows from a ``np.memmap`` of 512 such
    images (bitwise; a warm read: the file was just written); each as the
    median host ms of both and the thread count of the native pass."""
    from commefficient_tpu_torch import native
    from commefficient_tpu_torch.data import transforms as T
    calls = dict(native.CALLS)
    rng = np.random.RandomState(0)
    res = {}

    imgs = rng.randint(0, 256, CIFAR_BATCH, np.uint8)
    numpy_fn = T.compose(T.normalize(T.CIFAR10_MEAN, T.CIFAR10_STD),
                         T.random_crop(32, 4, "reflect"), T.random_hflip())
    fused = T.cifar10_train_transforms
    a = fused([imgs], np.random.RandomState(1))[0]
    b = numpy_fn([imgs], np.random.RandomState(1))[0]
    if not np.array_equal(a.view(np.int32), b.view(np.int32)):
        raise AssertionError("native_feed: pad_crop_batch != the numpy "
                             "stages")
    res["pad_crop_batch"] = (
        _host_ms(lambda: fused([imgs], np.random.RandomState(1))),
        _host_ms(lambda: numpy_fn([imgs], np.random.RandomState(1))))

    imgs = rng.randint(0, 256, IMAGENET_BATCH, np.uint8)
    numpy_fn = T.compose(T.random_resized_crop(224), T.random_hflip(),
                         T.normalize(T.IMAGENET_MEAN, T.IMAGENET_STD))
    fused = T.imagenet_train_transforms
    ra, rb = np.random.RandomState(2), np.random.RandomState(2)
    a, b = fused([imgs], ra)[0], numpy_fn([imgs], rb)[0]
    err = float(np.abs(a.astype(np.float64) - b).max())
    if a.shape != (64, 224, 224, 3) or err > RRC_TOL or not _same_rng(ra,
                                                                      rb):
        raise AssertionError(f"native_feed: rrc_batch {a.shape}, max abs "
                             f"err {err} (limit {RRC_TOL}), RandomState "
                             f"equal {_same_rng(ra, rb)}")
    res["rrc_batch"] = (
        _host_ms(lambda: fused([imgs], np.random.RandomState(2))),
        _host_ms(lambda: numpy_fn([imgs], np.random.RandomState(2)), 3))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train_client_00000.npy")
        np.save(path, rng.randint(0, 256, (IMAGENET_ROWS,)
                                  + IMAGENET_BATCH[1:], np.uint8))
        arr = np.load(path, mmap_mode="r")
        order = np.sort(rng.choice(IMAGENET_ROWS, IMAGENET_BATCH[0],
                                   replace=False))
        if not np.array_equal(native.gather_rows(arr, order),
                              np.asarray(arr[order])):
            raise AssertionError("native_feed: gather_rows != numpy")
        res["gather_rows"] = (
            _host_ms(lambda: native.gather_rows(arr, order)),
            _host_ms(lambda: np.asarray(arr[order])))
        del arr
    made = {k: v - calls.get(k, 0) for k, v in native.CALLS.items()}
    if not all(made.get(k, 0) > 0 for k in res):
        raise AssertionError(f"native_feed: native calls {made}")
    smi = _smi()
    out_bytes = {"pad_crop_batch": 4 * int(np.prod(CIFAR_BATCH)),
                 "rrc_batch": 4 * IMAGENET_BATCH[0] * 224 * 224 * 3,
                 "gather_rows": int(np.prod(IMAGENET_BATCH))}
    shapes = {"pad_crop_batch": f"{CIFAR_BATCH} uint8 -> float32, reflect "
                                "pad 4, flips",
              "rrc_batch": f"{IMAGENET_BATCH} uint8 -> (64, 224, 224, 3), "
                           f"max abs err {err:.3e}, RandomState equal",
              "gather_rows": f"64 of {IMAGENET_ROWS} rows of "
                             f"{IMAGENET_BATCH[1:]} uint8 from a memmap "
                             "(warm)"}
    for name, (ms, numpy_ms) in res.items():
        print(f"native_feed {name} ({shapes[name]}): {ms:.3f} ms native "
              f"against {numpy_ms:.3f} ms numpy (median host ms), "
              f"{native.threads_for(out_bytes[name])} threads; bitwise"
              f"{' within 2e-4' if name == 'rrc_batch' else ''}; {smi}",
              flush=True)
    return res


def _moe_aux(learner, call):
    """The blocks' mean load-balancing term on ``call``'s batch at the
    learner's weights (no gradient)."""
    import torch
    from torch.func import functional_call
    _, batch, _ = call
    ids, mc, _, _, types = (c.reshape((-1,) + tuple(c.shape[2:]))
                            for c in batch)
    with torch.no_grad():
        out = functional_call(learner.model,
                              learner.unflatten(learner.state.weights),
                              (ids, types, mc),
                              {"train": False, "return_aux": True})
    return float(out[2])


def phase_moe_layer(learner, dev):
    """Block 0's ``MoEFFN`` at the trained weights on the card against the
    same layer on the CPU, on MOE_TOKENS seeded tokens: assignments and
    keep mask identical but for near-ties (top two probabilities within
    1e-6), counted; the output within 1e-5 of its largest magnitude on the
    tokens routed alike."""
    import torch

    from commefficient_tpu_torch.ops.moe import MoEFFN
    params = learner.unflatten(learner.state.weights)
    prefix = "Block_0.moe."
    state = {k[len(prefix):]: v.detach().cpu() for k, v in params.items()
             if k.startswith(prefix)}
    C = learner.model.config.n_embd
    layers = {}
    for device in ("cpu", dev):
        layer = MoEFFN(C, 4, 4 * C).to(device)
        layer.load_state_dict(state)
        layers[str(device)] = layer
    x = torch.from_numpy(np.random.RandomState(11).randn(
        MOE_TOKENS, C).astype(np.float32))
    with torch.no_grad():
        (yc, auxc), rc = layers["cpu"](x), layers["cpu"].route(x)
        (yg, auxg), rg = layers[str(dev)](x.to(dev)), layers[str(dev)].route(
            x.to(dev))
    yg, eg, kg = yg.cpu(), rg.expert.cpu(), rg.keep.cpu()
    top2 = torch.sort(rc.probs, dim=-1).values[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= NEAR_TIE
    flips = eg != rc.expert
    if bool((flips & ~tie).any()) or (not bool(flips.any())
                                      and not torch.equal(kg, rc.keep)):
        raise AssertionError(f"moe layer: {int(flips.sum())} flips, "
                             f"{int((flips & ~tie).sum())} off a near-tie; "
                             f"keep equal {torch.equal(kg, rc.keep)}")
    alike = ~flips & (kg == rc.keep)
    err = float((yg[alike] - yc[alike]).abs().max())
    rel = err / float(yc.abs().max())
    if rel > MOE_TOL:
        raise AssertionError(f"moe layer: card vs CPU max abs err {err}, "
                             f"{rel:.3e} of the largest |y|")
    print(f"moe layer (Block_0, {MOE_TOKENS} tokens, capacity "
          f"{rc.capacity}, {int(rc.keep.sum())} kept): card vs CPU "
          f"assignments equal but {int(flips.sum())} near-tie flips, keep "
          f"masks equal, output max abs err {err:.3e} ({rel:.3e} of the "
          f"largest |y|), aux {float(auxg):.6f} vs {float(auxc):.6f}",
          flush=True)


class _SketchRecovery:
    """Keeps the inputs and outputs of the first card call of the tiled
    sketch (``sketch_kernels.sketch_vec``, the round's aggregate) and of
    the compact recovery (``topk_kernels.unsketch_compact``, est_hist,
    digit_hist and radix_compact) so that ``check`` holds both against
    their plain versions on those very inputs after the run. Copies
    tensors; adds no counted launch."""

    def __enter__(self):
        from commefficient_tpu_torch.ops import sketch_kernels as sk
        from commefficient_tpu_torch.ops import topk_kernels as tk
        self.calls = {}
        self._saved = [(sk, "sketch_vec", sk.sketch_vec),
                       (tk, "unsketch_compact", tk.unsketch_compact)]
        for owner, name, f in self._saved:
            setattr(owner, name, self._recording(name, f))
        return self

    def _recording(self, name, f):
        def call(*args, **kwargs):
            out = f(*args, **kwargs)
            if args[1].is_cuda and name not in self.calls:
                self.calls[name] = (args[0], _cloned(args[1:]),
                                    dict(kwargs), _cloned(out))
            return out
        return call

    def __exit__(self, *exc):
        for owner, name, f in self._saved:
            setattr(owner, name, f)

    def check(self, tag, errs):
        import torch

        from commefficient_tpu_torch.ops import topk_kernels as tk
        from commefficient_tpu_torch.ops.sketch_kernels import \
            sketch_vec_plain
        if set(self.calls) != {"sketch_vec", "unsketch_compact"}:
            raise AssertionError(f"{tag}: the probe saw {list(self.calls)}")
        cs, (vec, *rest), kwargs, table = self.calls.pop("sketch_vec")
        plain = sketch_vec_plain(cs, vec, *rest, **kwargs)
        if not _same_bits(table, plain):
            raise AssertionError(f"{tag}: the sketch of the round's "
                                 f"aggregate at d = {vec.numel()} != its "
                                 "plain version")
        errs["sketch"] = max(errs["sketch"], _max_abs_err(table, plain))
        del vec, table, plain
        cs, (tab, k), kwargs, (vals, idxs) = self.calls.pop(
            "unsketch_compact")
        p_vals, p_idxs = tk.unsketch_compact_plain(cs, tab, k)
        if not (_same_bits(vals, p_vals) and torch.equal(idxs, p_idxs)):
            raise AssertionError(f"{tag}: the recovery of round 1's table "
                                 f"at d = {cs.d} != its plain version")
        for name in ("est_hist", "digit_hist", "radix_compact"):
            errs[name] = max(errs[name], _max_abs_err(vals, p_vals))
        print(f"{tag}: round 1's sketch of the aggregate (d = {cs.d}, "
              f"{cs.r} x {cs.c_eff}) and its recovery (est_hist, digit_hist "
              f"x 2, radix_compact; k = {k}, {int((vals != 0).sum())} "
              f"nonzero) bitwise equal to their plain versions on the run's "
              f"own inputs", flush=True)
        torch.cuda.empty_cache()


def phase_gpt2_moe(tmpdir, errs, dev):
    """gpt2_moe: ``GPT2_FLAGS`` + --moe_experts 4 at GPT2-small's widths (d
    = 294,095,665) through ``training.gpt2.train`` for 3 rounds, twice
    from one seed, the launch counters zeroed just before each: the gpt2
    path's launches, flash_fwd 12 a validation batch; finite losses,
    weights and validation nll, exact upload bytes; on the first run the
    round's sketch and recovery held against their plain versions on the
    run's own aggregate and table, the blocks' aux term on the last batch,
    and Block 0's layer on the card against the CPU
    (``phase_moe_layer``); the two runs' losses, weights, Vvelocity and
    Verror bitwise equal. Returns the first run's launches."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    runs = []
    for i in range(2):
        args = build_gpt2_parser().parse_args(GPT2_FLAGS + MOE_FLAGS + [
            "--dataset_dir", tmpdir])
        np.random.seed(args.seed)
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.LAUNCHES.clear()
        with _SketchRecovery() if i == 0 else nullcontext() as probe:
            learner, row = train(args, max_rounds=3, log=False)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = row["launches_after_rounds"]
        val = {k: v - launches.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
               if v - launches.get(k, 0)}
        if launches != GPT2_SKETCH or val != {
                "flash_fwd": 12 * row["val_batches"]}:
            raise AssertionError(f"gpt2_moe: launches {launches}, "
                                 f"validation {val}")
        rounds, s = row["rounds"], learner.state
        if learner.cfg.grad_size != D_GPT2_MOE or len(rounds) != 3 \
                or learner.model.config.moe_experts != 4:
            raise AssertionError(f"gpt2_moe: d = {learner.cfg.grad_size}, "
                                 f"{len(rounds)} rounds")
        if not all(math.isfinite(r["loss"]) for r in rounds) \
                or not bool(torch.isfinite(s.weights).all()) \
                or not math.isfinite(row["nll"]):
            raise AssertionError("gpt2_moe: non-finite loss, weights or "
                                 "validation nll")
        if any(r["upload_bytes"] != GPT2_WORKERS * GPT2_UPLOAD["gpt2"]
               for r in rounds):
            raise AssertionError(f"gpt2_moe: upload bytes "
                                 f"{[r['upload_bytes'] for r in rounds]}")
        aux = ""
        if probe is not None:
            aux = (f", aux term on the last batch "
                   f"{_moe_aux(learner, row['last_batch']):.6f}")
        print(f"path gpt2_moe run {i + 1}: d = {learner.cfg.grad_size}, "
              f"launches {launches}, validation launches {val} over "
              f"{row['val_batches']} batches, losses "
              f"{[round(r['loss'], 6) for r in rounds]}, round ms "
              f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, val nll "
              f"{row['nll']:.6f}{aux}, peak memory {peak:.2f} GiB; "
              f"{_smi()}", flush=True)
        if probe is not None:
            phase_moe_layer(learner, dev)
        runs.append(([r["loss"] for r in rounds], s.weights.clone(),
                     s.opt.Vvelocity.clone(), s.opt.Verror.clone(),
                     launches))
        del learner, row, s
        torch.cuda.empty_cache()
        if probe is not None:
            probe.check("gpt2_moe", errs)
            del probe
    (la, *ta, launches), (lb, *tb, _) = runs
    same = [_same_bits(a, b) for a, b in zip(ta, tb)]
    if [x.hex() for x in la] != [x.hex() for x in lb] or not all(same):
        raise AssertionError(f"gpt2_moe is not reproducible: losses {la} "
                             f"vs {lb}; weights, Vvelocity, Verror bitwise "
                             f"equal: {same}")
    print("gpt2_moe: the two runs' losses, weights, Vvelocity and Verror "
          "bitwise equal", flush=True)
    del runs, ta, tb
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# The clients mesh (A12's clients axis): two ranks share the one card over
# gloo (NCCL refuses a second rank on a device it already holds); a ring
# of one runs over NCCL
# --------------------------------------------------------------------------

MESH_RANKS = 2
MESH_BACKEND = "gloo"
# round 1's aggregate table on 2 ranks against one process's, in float32
# ulps of the table's largest magnitude: the limit is this multiple of
# the distance between one process's table and the table of the same two
# half-batch gradients summed in one process (the mesh's reassociation,
# measured without a mesh)
MESH_TABLE_SLACK = 2
# the mesh's trajectory against one process's after round 1: the top-k
# of a reassociated table may pick other near-threshold coordinates
MESH_LOSS_RTOL = 1e-3
MESH_GPT2_ROUNDS = 3
# the A10b baselines check the placements' equality, not the arenas' size:
# 20 clients (a multiple of the 10 classes, the non-iid split's partition)
ROBUST_CLIENTS = 20
# the reference's buffered_mesh preemption arm (tests/test_preemption.py
# _CONFIGS) at ResNet9's width, 2 epochs of 3 rounds
MESH_KILL_FLAGS = _BASE + [
    "--mode", "local_topk", "--error_type", "local", "--k", "5",
    "--local_batch_size", "32", "--server_mode", "buffered",
    "--client_state_offload", "--client_k_dist", "uniform:0.5,1.0",
    "--num_epochs", RESUME_EPOCHS]


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _sha_of(t) -> str:
    import hashlib
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _mesh_spec(tmpdir, tag, argv, entry="cv", **kw):
    return dict(kw, entry=entry, argv=list(argv),
                out=os.path.join(tmpdir, tag))


def _mesh_ranks_agree(tag, recs):
    """Every rank's replicated state bitwise rank 0's: after every round
    (where recorded) and at the end, with the same losses and bytes."""
    a = recs[0]
    for b in recs[1:]:
        for key in ("digests", "weights_sha", "vvel_sha", "verr_sha",
                    "rows_sha", "round_idx"):
            if a[key] != b[key]:
                raise AssertionError(f"{tag}: rank {b['rank']}'s {key} "
                                     f"differs from rank 0's")
        if [(x["loss_hex"], x["upload_bytes"], x["download_bytes"])
                for x in a["rounds"]] != [
                (x["loss_hex"], x["upload_bytes"], x["download_bytes"])
                for x in b["rounds"]]:
            raise AssertionError(f"{tag}: rank {b['rank']}'s rounds differ")
    for rec in recs:
        if not rec["finite"]:
            raise AssertionError(f"{tag}: rank {rec['rank']}'s weights are "
                                 f"not finite")


def _mesh_launches(tag, recs, want):
    """Each rank's launches of its rounds are ``want``; returns their sum
    over the ranks."""
    total = {}
    for rec in recs:
        if rec["launches"] != want:
            raise AssertionError(f"{tag}: rank {rec['rank']} launched "
                                 f"{rec['launches']}, expected {want}")
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _round_ms(rec):
    return [round(x["round_s"] * 1e3, 3) for x in rec["rounds"]]


def _peaks(recs):
    """Each rank's peak device GiB ("not measured" off the card)."""
    return [round(r["peak_gib"], 2) if r["peak_gib"] is not None
            else "not measured" for r in recs]


def _ulps_of_largest(got, want) -> float:
    """max |got - want| in float32 ulps of max |want|."""
    big = float(np.abs(want).max())
    ulp = float(np.spacing(np.float32(big)))
    return float(np.abs(got.astype(np.float64) - want).max()) / ulp


def phase_mesh_nccl1(tmpdir, ref):
    """mesh_nccl1: the headline sketch flags with ``--mesh clients=1``
    through the launcher the CLI uses, a ring of one over NCCL in this
    process: 3 rounds bitwise the sketch path (``ref`` from
    ``phase_repeat``), with its launches."""
    from commefficient_tpu_torch.tools import mesh_run
    t0 = time.perf_counter()
    (rec,), = mesh_run.launch(_mesh_spec(tmpdir, "mesh_nccl1", HEADLINE,
                                         max_rounds=3, digests=False),
                              1, "nccl")
    wall = time.perf_counter() - t0
    losses, weights, vvel, verr, nbytes = ref
    got = [(x["upload_bytes"], x["download_bytes"]) for x in rec["rounds"]]
    if (rec["backend"] != "nccl"
            or [x["loss_hex"] for x in rec["rounds"]]
            != [v.hex() for v in losses] or got != nbytes
            or (rec["weights_sha"], rec["vvel_sha"], rec["verr_sha"])
            != (_sha_of(weights), _sha_of(vvel), _sha_of(verr))):
        raise AssertionError(f"mesh_nccl1: not the sketch path's "
                             f"trajectory: {rec['rounds']} vs {losses}, "
                             f"{nbytes}")
    launches = _mesh_launches("mesh_nccl1", [rec], SKETCH_LAUNCHES)
    print(f"path mesh_nccl1: backend {rec['backend']}, 1 rank, launches "
          f"{launches}, round ms {_round_ms(rec)}, peak GiB "
          f"{_peaks([rec])}; losses, bytes, weights, Vvelocity "
          f"and Verror bitwise the sketch path's ({wall:.1f} s)",
          flush=True)
    return launches


class _FirstRound:
    """Keeps the first round's learner, weights, columns and mask."""

    def __enter__(self):
        from commefficient_tpu_torch.federated.api import FedLearner
        self.inputs = None
        self._saved = FedLearner.train_round_async
        saved = self._saved

        def dispatch(learner, client_ids, batch, mask, **kwargs):
            if self.inputs is None:
                self.inputs = (learner, learner.state.weights.clone(),
                               tuple(batch), np.array(mask))
            return saved(learner, client_ids, batch, mask, **kwargs)
        FedLearner.train_round_async = dispatch
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.federated.api import FedLearner
        FedLearner.train_round_async = self._saved


def _one_process_round1_tables():
    """The sketch path's round-1 aggregate table in this process, and the
    table of the same round's two half-batch gradients (workers 0-3 and
    4-7, a mesh rank's each) summed here as the 2-rank fused round sums
    them: (g0 + g1 + weight decay) / datapoints, then the sketch."""
    import torch

    from commefficient_tpu_torch.federated import client as client_lib
    with _RoundTables() as rec, _FirstRound() as first:
        _cv_run(HEADLINE, rounds=1)
    learner, w0, cols, mask = first.inputs
    cfg = learner.cfg
    m = torch.as_tensor(mask, dtype=torch.float32, device=w0.device)
    half = cfg.num_workers // MESH_RANKS
    grads, counts = [], []
    for r in range(MESH_RANKS):
        sl = slice(r * half, (r + 1) * half)
        flat = tuple(c[sl].reshape((-1,) + tuple(c.shape[2:]))
                     for c in cols)
        g, _, _ = client_lib._masked_loss_and_grad(
            learner._loss_train, learner.unflatten, w0, flat,
            m[sl].reshape(-1), 0)
        grads.append(g)
        counts.append(torch.sum(m[sl]))
    total_n = counts[0] + counts[1]
    wd = (cfg.weight_decay / cfg.num_workers) * w0 * total_n
    agg = (grads[0] + grads[1] + wd) / torch.clamp(total_n, min=1.0)
    halves = learner._round.sketch.sketch_vec(agg).cpu().numpy()
    whole = rec.tables[0].cpu().numpy()
    del learner, rec, first, grads, agg, wd, w0, cols
    _sync()
    return whole, halves


def _check_mesh_sketch(tmpdir, recs_a, recs_b, ref, tables1):
    """mesh_sketch's checks (see ``phase_mesh``)."""
    _mesh_ranks_agree("mesh_sketch", recs_a)
    _mesh_ranks_agree("mesh_sketch (second run)", recs_b)
    a, b = recs_a[0], recs_b[0]
    for key in ("weights_sha", "vvel_sha", "verr_sha"):
        if a[key] != b[key]:
            raise AssertionError(f"mesh_sketch: the two runs' {key} differ")
    if [(x["loss_hex"], x["upload_bytes"], x["download_bytes"])
            for x in a["rounds"]] != [
            (x["loss_hex"], x["upload_bytes"], x["download_bytes"])
            for x in b["rounds"]]:
        raise AssertionError("mesh_sketch: the two runs' rounds differ")
    tables = [np.load(os.path.join(tmpdir, f"mesh_sketch_rank{r}_table.npy"))
              for r in range(MESH_RANKS)]
    if not all(np.array_equal(tables[0], t) for t in tables[1:]):
        raise AssertionError("mesh_sketch: the ranks' round-1 tables differ")
    whole, halves = tables1
    ulps = _ulps_of_largest(tables[0], whole)
    limit = MESH_TABLE_SLACK * _ulps_of_largest(halves, whole)
    if ulps > limit:
        raise AssertionError(f"mesh_sketch: round 1's table {ulps:.1f} ulps "
                             f"of its largest cell from one process's "
                             f"(limit {limit:.1f})")
    same_as_halves = bool(np.array_equal(tables[0], halves))
    losses, _, _, _, nbytes = ref
    got = [x["loss"] for x in a["rounds"]]
    up = [x["upload_bytes"] for x in a["rounds"]]
    down = [x["download_bytes"] for x in a["rounds"]]
    if (up != [n[0] for n in nbytes] or down[:2] != [n[1] for n in
                                                     nbytes[:2]]
            or not math.isclose(got[0], losses[0], rel_tol=1e-5)
            or not all(math.isclose(x, y, rel_tol=MESH_LOSS_RTOL)
                       for x, y in zip(got, losses))):
        raise AssertionError(f"mesh_sketch: trajectory {got}, up {up}, "
                             f"down {down} against the sketch path's "
                             f"{losses}, {nbytes}")
    return (ulps, limit, same_as_halves), got, down


def phase_mesh(tmpdir, ref):
    """The mesh paths on 2 ranks sharing the card over gloo, in one
    launch (the ranks start once), the counters zeroed in each rank just
    before each run:

    * mesh_sketch: the headline sketch flags, twice (the second with no
      per-round digest, for its round times): the ranks bitwise each
      other every round; the two runs' losses, bytes and final state
      bitwise; round 1's aggregate
      table within MESH_TABLE_SLACK times the distance of the half-batch
      sum's table from this process's (``_one_process_round1_tables``),
      and whether it is bitwise that sum's; against the sketch path
      (``ref``): upload bytes every
      round, download bytes of rounds 1-2 exact, round 1's loss rtol
      1e-5 and every loss within MESH_LOSS_RTOL;
    * mesh_gpt2: ``GPT2_FLAGS``, MESH_GPT2_ROUNDS rounds, no per-round
      digest (it reads the state back and would stretch the rounds): the
      ranks' final state bitwise; flash, sketch and recovery launches per
      rank; peak GiB a rank; steady round ms;
    * mesh_local_topk_offload: local_topk's flags with
      --client_state_offload, and without: the offloaded rows bitwise the
      device-resident mesh rows after 3 rounds; each rank reads and
      writes its own arena shard;
    * mesh_buffered: the sketch flags with --server_mode buffered
      (lock-step), bitwise mesh_sketch; then FAULT_FLAGS over
      FAULT_COHORTS cohorts, its schedule equal to its one-process CPU
      replay of the same cohorts;
    * the uninterrupted run of mesh_kill_resume (``phase_mesh_kill``);
    * mesh_tp_gpt2 (``check_mesh_tp_gpt2``: the ranks join a model axis
      for it);
    * A12 1b and the seq, stage and expert axes (``mesh_a12_specs``:
      ``check_mesh_seq``, ``check_mesh_tp_1b``, ``check_mesh_pp``,
      ``check_mesh_ep``; the ranks join a seq, model, stage or expert
      axis for each), after ``phase_seq_reference``'s,
      ``phase_pp_reference``'s and ``phase_ep_reference``'s one-process
      rounds.

    Returns (launches summed over the ranks, the kill arm's export)."""
    from commefficient_tpu_torch.tools import mesh_run
    from commefficient_tpu_torch.training.args import build_parser
    tables1 = _one_process_round1_tables()
    base = os.path.join(tmpdir, "mesh_kill_base")
    specs = [
        _mesh_spec(tmpdir, "mesh_sketch", HEADLINE, max_rounds=3,
                   record_table=True),
        _mesh_spec(tmpdir, "mesh_sketch_b", HEADLINE, max_rounds=3,
                   digests=False),
        _mesh_spec(tmpdir, "mesh_offload", PATHS["local_topk_offload"][0],
                   max_rounds=3),
        _mesh_spec(tmpdir, "mesh_device_rows", PATHS["local_topk"][0],
                   max_rounds=3),
        _mesh_spec(tmpdir, "mesh_lockstep",
                   HEADLINE + ["--server_mode", "buffered"], max_rounds=3),
        _mesh_spec(tmpdir, "mesh_faults", HEADLINE + FAULT_FLAGS,
                   max_rounds=FAULT_COHORTS, record_cohorts=True),
        _mesh_spec(tmpdir, "mesh_kill_base", MESH_KILL_FLAGS + [
            "--checkpoint", "--checkpoint_path", base,
            "--checkpoint_every_rounds", "2"]),
        _mesh_spec(tmpdir, "mesh_gpt2", GPT2_FLAGS + [
            "--dataset_dir", tmpdir, "--valid_batch_size", "32"],
            entry="gpt2",
            max_rounds=MESH_GPT2_ROUNDS, digests=False),
        mesh_tp_gpt2_spec(tmpdir),
        *mesh_a12_specs(tmpdir),
    ]
    phase_seq_reference(tmpdir)
    phase_pp_reference(tmpdir)
    phase_ep_reference(tmpdir)
    t0 = time.perf_counter()
    launched = mesh_run.launch(specs, MESH_RANKS, MESH_BACKEND)
    (sk_a, sk_b, off, dev_rows, lock, faults, kill_base,
     gpt2, tp, seq_a, seq_b, seq_parity, tp_buffered, tp_buckets,
     tp_offload, tp_device, pp_a, pp_parity, ep_a, ep_parity,
     tp_moe) = launched
    wall = time.perf_counter() - t0
    if any(r["backend"] != MESH_BACKEND or r["world"] != MESH_RANKS
           for recs in (sk_a, gpt2) for r in recs):
        raise AssertionError("mesh: not the 2-rank gloo group")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # mesh_sketch
    (ulps, limit, same), losses, down = _check_mesh_sketch(
        tmpdir, sk_a, sk_b, ref, tables1)
    add(_mesh_launches("mesh_sketch", sk_a, SKETCH_LAUNCHES))
    add(_mesh_launches("mesh_sketch", sk_b, SKETCH_LAUNCHES))
    print(f"path mesh_sketch: {MESH_RANKS} ranks on one card over "
          f"{MESH_BACKEND}, launches a rank {sk_a[0]['launches']}; ranks "
          f"bitwise every round, two runs bitwise; round 1's table "
          f"{ulps:.2f} ulps of its largest cell from one process's (limit "
          f"{limit:.2f}: {MESH_TABLE_SLACK}x the half-batch sum's), bitwise "
          f"the half-batch sum's table: {same}; losses "
          f"{[round(x, 6) for x in losses]} "
          f"against the sketch path's {[round(x, 6) for x in ref[0]]}, "
          f"download B {down} against {[n[1] for n in ref[4]]}; round ms "
          f"(the second run, no digest) rank 0 {_round_ms(sk_b[0])}, rank 1 "
          f"{_round_ms(sk_b[1])}; peak GiB {_peaks(sk_a)}", flush=True)
    # mesh_gpt2
    _mesh_ranks_agree("mesh_gpt2", gpt2)
    add(_mesh_launches("mesh_gpt2", gpt2,
                       _scaled(GPT2_SKETCH, MESH_GPT2_ROUNDS)))
    if gpt2[0]["d"] != D_GPT2:
        raise AssertionError(f"mesh_gpt2: d = {gpt2[0]['d']}")
    # the first round carries the set-up, the epoch's last is read at once
    steady = [x["round_s"] * 1e3 for x in gpt2[0]["rounds"][1:-1]]
    print(f"path mesh_gpt2: d = {D_GPT2}, launches a rank "
          f"{gpt2[0]['launches']}, ranks' final state bitwise; losses "
          f"{[round(x['loss'], 6) for x in gpt2[0]['rounds']]}; round ms "
          f"rank 0 {_round_ms(gpt2[0])}, rank 1 {_round_ms(gpt2[1])} "
          f"(steady {np.mean(steady):.3f}); peak GiB {_peaks(gpt2)}",
          flush=True)
    # mesh_local_topk_offload
    for tag, recs in (("mesh_local_topk_offload", off),
                      ("mesh_device_rows", dev_rows)):
        _mesh_ranks_agree(tag, recs)
        add(_mesh_launches(tag, recs, LOCAL_TOPK))
    if (off[0]["rows_sha"], off[0]["weights_sha"], off[0]["digests"]) != (
            dev_rows[0]["rows_sha"], dev_rows[0]["weights_sha"],
            dev_rows[0]["digests"]):
        raise AssertionError("mesh_local_topk_offload: the offloaded rows "
                             "or state are not the device-resident mesh's")
    for r, rec in enumerate(off):
        own = (rec["shard_reads"][r], rec["shard_writes"][r])
        other = [x for s, x in enumerate(rec["shard_reads"]
                                         + rec["shard_writes"])
                 if s % MESH_RANKS != r]
        if min(own) <= 0 or any(other):
            raise AssertionError(f"mesh_local_topk_offload: rank {r}'s "
                                 f"shard reads {rec['shard_reads']}, "
                                 f"writes {rec['shard_writes']}")
    print(f"path mesh_local_topk_offload: launches a rank "
          f"{off[0]['launches']}; rows and state after 3 rounds bitwise "
          f"the device-resident mesh run's; shard reads "
          f"{[r['shard_reads'] for r in off]}, writes "
          f"{[r['shard_writes'] for r in off]}; arena "
          f"{off[0]['arena_bytes']} B a rank; round ms offload "
          f"{_round_ms(off[0])}, device {_round_ms(dev_rows[0])}",
          flush=True)
    # mesh_buffered
    _mesh_ranks_agree("mesh_buffered lock-step", lock)
    _mesh_ranks_agree("mesh_buffered faults", faults)
    add(_mesh_launches("mesh_buffered lock-step", lock, SKETCH_LAUNCHES))
    if (lock[0]["digests"], lock[0]["weights_sha"], lock[0]["vvel_sha"]) \
            != (sk_a[0]["digests"], sk_a[0]["weights_sha"],
                sk_a[0]["vvel_sha"]) or lock[0]["applies"] != 3:
        raise AssertionError("mesh_buffered: lock-step is not the sync mesh "
                             "run")
    fa = faults[0]
    add(_mesh_launches("mesh_buffered faults", faults,
                       _scaled(SKETCH_LAUNCHES, fa["applies"])))
    with np.load(os.path.join(tmpdir, "mesh_faults_rank0_cohorts.npz")) as z:
        cohorts = list(zip(z["ids"], z["masks"]))
    args = build_parser().parse_args(HEADLINE + FAULT_FLAGS)
    stats, applies, sim_time = _replay_schedule_on_cpu(
        args, fa["num_clients"], cohorts)
    if (dict(stats), applies, sim_time) != (fa["fault_stats"], fa["applies"],
                                            fa["sim_time"]):
        raise AssertionError(f"mesh_buffered: the mesh's schedule "
                             f"{fa['fault_stats']}, {fa['applies']}, "
                             f"{fa['sim_time']} != the CPU replay's "
                             f"{stats}, {applies}, {sim_time}")
    if min(fa["fault_stats"]["dropouts"], fa["fault_stats"]["crashes"]) < 1:
        raise AssertionError(f"mesh_buffered: no dropout or crash drawn: "
                             f"{fa['fault_stats']}")
    print(f"path mesh_buffered: lock-step bitwise the sync mesh run every "
          f"round; faults: {len(cohorts)} cohorts, {fa['applies']} applies, "
          f"stats {fa['fault_stats']}, sim_time {fa['sim_time']!r}, equal "
          f"to the one-process CPU replay; launches a rank "
          f"{fa['launches']}; cohort ms {_round_ms(fa)}", flush=True)
    _mesh_ranks_agree("mesh_kill_resume (uninterrupted)", kill_base)
    add(_mesh_launches("mesh_kill_resume (uninterrupted)", kill_base,
                       _scaled(LOCAL_TOPK, 6)))
    add(check_mesh_tp_gpt2(tmpdir, tp))
    add(check_mesh_seq(tmpdir, seq_a, seq_b, seq_parity))
    add(check_mesh_tp_1b(tmpdir, tp, tp_buffered, tp_buckets, tp_offload,
                         tp_device))
    add(check_mesh_pp(tmpdir, pp_a, pp_parity))
    add(check_mesh_ep(tmpdir, ep_a, ep_parity, tp_moe))
    EP_ROUND1.clear()
    walls = {os.path.basename(spec["out"]): round(recs[0]["wall_s"], 1)
             for spec, recs in zip(specs, launched)}
    print(f"mesh: train's wall s, rank 0: {walls}", flush=True)
    print(f"mesh: one launch of {len(specs)} runs on {MESH_RANKS} ranks in "
          f"{wall:.1f} s", flush=True)
    return launches, base


def phase_mesh_kill(tmpdir, base):
    """mesh_kill_resume: the reference's buffered_mesh arm
    (MESH_KILL_FLAGS: lock-step buffered local_topk at k 5, offloaded
    rows, per-client budgets) on 2 ranks, through
    ``tools.mesh_run``'s command line: a child SIGKILLed (its process
    group: the launcher and both ranks) once its first step file is
    there, then one with --resume auto: its export bitwise the
    uninterrupted run's (``base``, from ``phase_mesh``), the previous
    step file intact; the export then loads in a one-process run."""
    import signal

    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.utils.checkpoint import load_checkpoint
    name = build_parser().parse_args(MESH_KILL_FLAGS).model
    ckpt = os.path.join(tmpdir, "mesh_kill")
    flags = MESH_KILL_FLAGS + ["--checkpoint", "--checkpoint_path", ckpt,
                               "--checkpoint_every_rounds", "2"]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    cmd = [sys.executable, "-m", "commefficient_tpu_torch.tools.mesh_run",
           "--entry", "cv", "--ranks", str(MESH_RANKS), "--backend",
           MESH_BACKEND, "--out", os.path.join(tmpdir, "mesh_kill")]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd + ["--"] + flags, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
    killed_at = None
    try:
        while time.perf_counter() - t0 < 300:
            if child.poll() is not None:
                raise AssertionError(f"mesh_kill_resume: the child exited "
                                     f"(rc={child.returncode}) before the "
                                     f"kill:\n{child.stdout.read()}")
            if os.path.isdir(ckpt) and any(
                    "_r" in f and f.endswith(".npz")
                    for f in os.listdir(ckpt)):
                os.killpg(child.pid, signal.SIGKILL)
                killed_at = sorted(os.listdir(ckpt))
                break
            time.sleep(0.01)
        out, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()
    first_s = time.perf_counter() - t0
    if child.returncode != -signal.SIGKILL \
            or os.path.exists(os.path.join(ckpt, f"{name}.npz")):
        raise AssertionError(f"mesh_kill_resume: the child ended with "
                             f"{child.returncode}:\n{out}")
    t0 = time.perf_counter()
    done = subprocess.run(cmd + ["--", *flags, "--resume", "auto"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    second_s = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"mesh_kill_resume: the resumed child failed "
                             f"({done.returncode}):\n{done.stdout}\n"
                             f"{done.stderr}")
    if not _same_export(_export(base, name), _export(ckpt, name)):
        raise AssertionError("mesh_kill_resume: the resumed run's export "
                             "is not the uninterrupted run's")
    learner, _ = _cv_run([f for f in MESH_KILL_FLAGS], rounds=1)
    export = os.path.join(ckpt, f"{name}.npz")
    load_checkpoint(export, learner)
    with np.load(export) as z:
        saved = z[f"arr_{int(z['weights_idx'])}"]
    if not np.array_equal(learner.state.weights.cpu().numpy(), saved):
        raise AssertionError("mesh_kill_resume: the mesh export does not "
                             "load in one process")
    del learner
    _sync()
    print(f"path mesh_kill_resume: child (launcher + {MESH_RANKS} ranks) "
          f"SIGKILLed at {killed_at} after {first_s:.3f} s; the resumed "
          f"child ({second_s:.3f} s): its export bitwise the "
          f"uninterrupted mesh run's (state, host rows, bytes, generator); "
          f"the export loads in one process", flush=True)


def phase_offload_robust():
    """A10b's one-card baselines of the mesh phases: local_topk's flags at
    ROBUST_CLIENTS clients (1) under FAULT_FLAGS for FAULT_COHORTS cohorts
    with --client_state_offload and without, and (2) with
    --client_quarantine, worker 0's images NaN in round 2, offloaded and
    not: in each pair the client rows and the state bitwise (ROADMAP
    C14)."""
    from commefficient_tpu_torch.ops import cuda_lib
    flags = PATHS["local_topk"][0] + ["--num_clients", str(ROBUST_CLIENTS)]
    out = {}
    for tag, extra, rounds, ctx in (
            ("buffered_offload_faults", FAULT_FLAGS, FAULT_COHORTS,
             nullcontext),
            ("quarantine_offload", ["--client_quarantine"], 3,
             lambda: _PoisonRound(at=2))):
        runs = []
        for offload in ([], ["--client_state_offload"]):
            cuda_lib.LAUNCHES.clear()
            with ctx() as probe:
                learner, row = _cv_run(flags + extra + offload,
                                       rounds=rounds)
            _sync()
            runs.append(((learner, row), _launches(),
                         getattr(probe, "seen", None),
                         [round(r["round_s"] * 1e3, 3)
                          for r in row["rounds"]]))
        (a, la, sa, ma), (b, lb, sb, mb) = runs
        _assert_same_runs(tag, a, b)
        if la != lb or sa != sb:
            raise AssertionError(f"{tag}: launches {la} vs {lb}, "
                                 f"quarantine {sa} vs {sb}")
        if tag == "quarantine_offload" and sa[1] != (1.0, 1):
            raise AssertionError(f"{tag}: (dropped, quarantined) {sa}")
        for k, v in la.items():
            out[k] = out.get(k, 0) + 2 * v
        print(f"path {tag}: launches {la}; rows, weights, Vvelocity and "
              f"losses bitwise offloaded and device-resident"
              f"{'; (dropped, quarantined) a round ' + str(sa) if sa else ''}"
              f"; round ms device {ma}, offload {mb}", flush=True)
        del runs, a, b
        _sync()
    return out


def phase_gpt2_robust(tmpdir, ref):
    """The buffered server and quarantine on the GPT2 entry point:
    ``GPT2_FLAGS`` with --server_mode buffered (lock-step), 3 rounds
    bitwise the gpt2 path's (``ref`` from ``phase_repeat_gpt2``); and with
    --client_quarantine, 2 rounds of the per-worker path (a forward and
    backward a client), nothing excluded, finite."""
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    losses, weights = ref
    out = {}
    for tag, extra, rounds, want in (
            ("gpt2_buffered", ["--server_mode", "buffered"], 3,
             GPT2_SKETCH),
            ("gpt2_quarantine", ["--client_quarantine"], 2,
             _scaled(dict(RECOVERY, flash_fwd=144, flash_bwd_dq=144,
                          flash_bwd_dkv=144, sketch=3), 2))):
        args = build_gpt2_parser().parse_args(GPT2_FLAGS + extra + [
            "--dataset_dir", tmpdir])
        np.random.seed(args.seed)
        cuda_lib.LAUNCHES.clear()
        learner, row = train(args, max_rounds=rounds, log=False)
        _sync()
        got = row["launches_after_rounds"]
        rs = row["rounds"]
        if got != want or not all(math.isfinite(r["loss"]) for r in rs) \
                or any(r["aborted"] for r in rs):
            raise AssertionError(f"{tag}: launches {got} != {want}, or "
                                 f"rounds {rs}")
        if tag == "gpt2_buffered" and (
                [r["loss"].hex() for r in rs] != [v.hex() for v in losses]
                or not _same_bits(learner.state.weights, weights)):
            raise AssertionError("gpt2_buffered: not the gpt2 path's "
                                 "trajectory")
        if tag == "gpt2_quarantine" and int(
                (learner.state.quarantine > 0).sum()) != 0:
            raise AssertionError("gpt2_quarantine: a finite client benched")
        for k, v in got.items():
            out[k] = out.get(k, 0) + v
        print(f"path {tag}: launches {got}, losses "
              f"{[round(r['loss'], 6) for r in rs]}, round ms "
              f"{[round(r['round_s'] * 1e3, 3) for r in rs]}"
              f"{', bitwise the gpt2 path' if tag == 'gpt2_buffered' else ''}",
              flush=True)
        del learner, row
        _sync()
    return out


# ---- A12's model axis: tensor parallelism on 2 ranks ---------------------

TP_HEADS = 12             # GPT2-small's heads
TP_RANKS = 2
# the losses of mesh_tp_gpt2 against the gpt2 path's
TP_LOSS_RTOL = 1e-4
# rounds of mesh_tp_gpt2, each held against the gpt2 path's; the 2nd is
# the steady one (the first carries the set-up, the epoch's last is read
# at once)
TP_GPT2_ROUNDS = 3
# round 1's table against the gpt2 path's, in float32 ulps of its largest
# cell: the limit is this multiple of the distance the inputs explain,
# max over cells of the sketch of |TP gradient - gpt2 gradient| (with
# every sign +1: a bound on the sketch of the difference) plus the
# distance of the same gradient's two block sketches summed from its
# whole sketch (the split's reassociation)
TP_TABLE_SLACK = 2


def phase_tp_flash_parity(dev, errs):
    """tp_flash_parity: at the GPT2 shape (BH 768 = 64 x 12 heads, T 256,
    D 64, float32) at dropout 0 and FLASH_RATE, each flash kernel
    (tensor-core and scalar) launched on a rank's 6 heads with its head
    map is bitwise the unsharded launch's rows of those heads, for both
    ranks; the identity map (0, 12, 12) on the whole is bitwise no map;
    each slice is within ``_flash_bad``'s limits of its plain version
    with the same map."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    bh, t, d = FLASH_SHAPE
    B, Hl = bh // TP_HEADS, TP_HEADS // TP_RANKS
    worst = {}
    t0 = time.perf_counter()
    for rate in (0.0, FLASH_RATE):
        q, k, v, g = _flash_inputs(dev, bh, t, d, torch.float32, seed=40)
        args = _flash_args(d, rate)
        for v1 in (False, True):
            full = _flash_run(q, k, v, g, args, v1)
            ident = _flash_run(q, k, v, g, args + ((0, TP_HEADS, TP_HEADS),),
                               v1)
            if not all(_same_bits(a, b) for a, b in zip(full, ident)):
                raise AssertionError(f"tp_flash_parity: the identity head "
                                     f"map changed a launch (v1 {v1}, rate "
                                     f"{rate})")
            for h0 in range(0, TP_HEADS, Hl):
                rows = (torch.arange(B, device=dev)[:, None] * TP_HEADS + h0
                        + torch.arange(Hl, device=dev)).reshape(-1)
                part_in = tuple(x[rows].contiguous() for x in (q, k, v, g))
                heads = (h0, Hl, TP_HEADS)
                part = _flash_run(*part_in, args + (heads,), v1)
                for name, a, b in zip(_FLASH_NAMES, part, full):
                    if not _same_bits(a, b[rows]):
                        raise AssertionError(
                            f"tp_flash_parity: {name} of heads [{h0}, "
                            f"{h0 + Hl}) (v1 {v1}, rate {rate}) is not the "
                            f"unsharded launch's rows")
                ref = fa.flash_fwd_plain(*part_in[:3], *args, heads) + \
                    fa.flash_bwd_plain(*part_in, *args, heads)
                err = {n: _max_abs_err(a, b)
                       for n, a, b in zip(_FLASH_NAMES, part, ref)}
                rel = {n: err[n] / max(float(b.double().abs().max()), 1e-30)
                       for n, b in zip(_FLASH_NAMES, ref)}
                bad = _flash_bad(torch.float32, err, rel)
                if bad:
                    raise AssertionError(f"tp_flash_parity: heads [{h0}, "
                                         f"{h0 + Hl}) disagree with the plain "
                                         f"versions in {bad}: {err}")
                if not v1:
                    errs["flash_fwd"] = max(errs["flash_fwd"], err["o"])
                    errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"],
                                               err["dq"])
                    errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"],
                                                err["dk"], err["dv"])
                for n in _FLASH_NAMES:
                    worst[n] = max(worst.get(n, 0.0), err[n])
        del q, k, v, g, full, ident, part, ref
        torch.cuda.empty_cache()
    print(f"parity tp_flash (BH {bh} = {B} x {TP_HEADS} heads, T {t}, D "
          f"{d}, float32, rates 0 and {FLASH_RATE}; tensor-core and scalar "
          f"kernels): each rank's {Hl} heads with its head map bitwise the "
          f"unsharded launch's rows (forward, lse, dq, dk, dv), the "
          f"identity map bitwise no map; max abs err against the plain "
          f"versions {', '.join(f'{n} {e:.3e}' for n, e in worst.items())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _abs_sketch(cs, x, chunk=1 << 23):
    """The sketch of ``x`` with every sign +1 (each cell the sum of |x|
    over its coordinates): a cellwise bound on |sketch(x)|. Plain
    PyTorch, a check only."""
    import torch
    table = torch.zeros(cs.r * cs.c_eff, device=x.device)
    rows = torch.arange(cs.r, device=x.device)[:, None] * cs.c_eff
    for lo in range(0, x.shape[0], chunk):
        idx = torch.arange(lo, min(lo + chunk, x.shape[0]), device=x.device)
        _, buckets = cs._row_hashes(None, idx)
        table.index_add_(0, (buckets + rows).flatten(),
                         x[idx].abs().expand(cs.r, -1).flatten())
    return table.view(cs.r, cs.c_eff)


def mesh_tp_gpt2_spec(tmpdir):
    """mesh_tp_gpt2's run (phase 10), on the persona cache the gpt2 paths
    made: ``phase_mesh``'s launch runs it on its 2 ranks."""
    return _mesh_spec(tmpdir, "mesh_tp_gpt2", GPT2_FLAGS + [
        "--dataset_dir", tmpdir, "--valid_batch_size", "32"], entry="gpt2",
        max_rounds=TP_GPT2_ROUNDS,
        record_table=True, record_block=True, model=TP_RANKS,
        time_collectives=True)


def check_mesh_tp_gpt2(tmpdir, recs):
    """mesh_tp_gpt2's checks (see the module docstring, phase 10) on the
    ranks' records, against ``GPT2_ROUND1`` from ``phase_repeat_gpt2``.
    Returns the launches summed over the ranks."""
    ref = GPT2_ROUND1
    if any(r["backend"] != MESH_BACKEND or r["world"] != TP_RANKS
           for r in recs):
        raise AssertionError("mesh_tp_gpt2: not the 2-rank gloo group")
    _mesh_ranks_agree("mesh_tp_gpt2", recs)
    launches = _mesh_launches("mesh_tp_gpt2", recs,
                              _scaled(GPT2_SKETCH, TP_GPT2_ROUNDS))
    d_pad = D_GPT2 + 1
    if [(r["d"], r["held"]) for r in recs] != [(d_pad, d_pad // 2)] * 2:
        raise AssertionError(f"mesh_tp_gpt2: d, held "
                             f"{[(r['d'], r['held']) for r in recs]}")
    rounds = recs[0]["rounds"]
    up = [x["upload_bytes"] for x in rounds]
    down = [x["download_bytes"] for x in rounds]
    losses = [x["loss"] for x in rounds]
    if up != [GPT2_WORKERS * GPT2_UPLOAD["gpt2"]] * TP_GPT2_ROUNDS \
            or up[:3] != ref["up"] or down[:2] != ref["down"][:2]:
        raise AssertionError(f"mesh_tp_gpt2: upload {up}, download {down} "
                             f"against the gpt2 path's {ref['up']}, "
                             f"{ref['down']}")
    if not all(math.isclose(a, b, rel_tol=TP_LOSS_RTOL)
               for a, b in zip(losses, ref["losses"])):
        raise AssertionError(f"mesh_tp_gpt2: losses {losses} against the "
                             f"gpt2 path's {ref['losses']}")
    # round 1's table
    ulps, limit, ulps_grad, ulps_split, grad_rel = _split_tables(
        "mesh_tp_gpt2", tmpdir, recs, D_GPT2, ref["agg"], ref["table"])
    steady = [x["round_s"] * 1e3 for x in rounds[1:-1]]
    coll = recs[0]["collectives"]
    print(f"path mesh_tp_gpt2: {TP_RANKS} ranks on one card over "
          f"{MESH_BACKEND} (clients=1, model=2), d = {D_GPT2} padded to "
          f"{d_pad}, {d_pad // 2} coordinates held a rank; launches a rank "
          f"{recs[0]['launches']}; the ranks' whole state bitwise every "
          f"round; losses {[round(x, 6) for x in losses]} against the gpt2 "
          f"path's {[round(x, 6) for x in ref['losses']]}; upload B {up}, "
          f"download B {down} (gpt2 path {ref['down']}); round 1's table "
          f"bitwise the ranks' block sketches summed, {ulps:.2f} ulps of "
          f"its largest cell from the gpt2 path's (limit {limit:.2f} = "
          f"{TP_TABLE_SLACK} x (gradient deviation {ulps_grad:.2f} + block "
          f"split {ulps_split:.2f})), the TP gradient within "
          f"{grad_rel:.3e} of the gpt2 path's largest; round ms rank 0 "
          f"{_round_ms(recs[0])}, rank 1 {_round_ms(recs[1])} (steady "
          f"{np.mean(steady):.3f}; a state digest a round); collectives "
          f"a round, rank 0 (synchronized around each): "
          f"{[round(c[0] * 1e3, 3) for c in coll]} ms, "
          f"{[round(c[1] / 1e9, 4) for c in coll]} GB, {[c[2] for c in coll]} "
          f"calls; peak GiB {_peaks(recs)}", flush=True)
    return launches


# ---- A12 1b and the seq axis on 2 ranks -----------------------------------

SEQ_RANKS = 2
SEQ_GPT2_ROUNDS = 3
# the second mesh_seq_gpt2 run's rounds, each state digest bitwise the
# first run's (the script's time)
SEQ_REPEAT_ROUNDS = 2
SEQ_FLAGS = GPT2_FLAGS + ["--attn_impl", "ring"]
# hw_dropout a round a rank: 38 sites a forward (the embedding; each
# layer's ring attention output, attention projection and MLP; the MC
# head's owner contribution) and 38 in the backward; the flash kernels do
# not run (ring attention is plain PyTorch, as the reference's einsums)
SEQ_LAUNCHES = dict(RECOVERY, sketch=3, hw_dropout=SEQ_GPT2_ROUNDS * 76)
# mesh_seq_parity's round 1 against the one-process full-attention round
# at dropout 0: the loss within this, and the table within SEQ_TABLE_SLACK
# times the ulps the two aggregates' difference explains (the sketch of
# |g_seq - g_full| with every sign +1), plus the cells' last rounding
SEQ_LOSS_RTOL = 1e-5
SEQ_TABLE_SLACK = 2
TP_BUFFERED_ROUNDS = 2
TP_BUCKETS = 4
TP_OFFLOAD_ROUNDS = 2
GPT2_SPARSE_OFFLOAD = GPT2_PATHS["gpt2_local_topk_sparse_offload"][0]
#: the one-process full-attention round 1 at dropout 0
#: (``phase_seq_reference``)
SEQ_ROUND1 = {}
# the stage axis: GPT2_FLAGS LM-only, 2 stages of 6 blocks on 2 ranks
PP_RANKS = 2
PP_GPT2_ROUNDS = 3
PP_FLAGS = GPT2_FLAGS + ["--mc_coef", "0"]
# mesh_pp_gpt2 runs --pp_microbatches 0 (= the stages: 2 microbatches of 32
# sequences), mesh_pp_parity 4 (of 16)
PP_PARITY_MICRO = 4
# a stage rank's hops a round: its n_micro activations (stage 0) or
# cotangents (stage 1) of (B / n_micro, T, C) float32, B = 64 sequences
PP_HOP_BYTES = 64 * 256 * 768 * 4
# mesh_pp_parity's round 1 against the one-process --mc_coef 0 round at
# dropout 0: the loss within PP_LOSS_RTOL, the aggregate within
# PP_AGG_TOL of its largest coordinate, the table within PP_TABLE_SLACK
# times the ulps the aggregates' difference explains
PP_LOSS_RTOL = 1e-5
PP_AGG_TOL = 1e-5
PP_TABLE_SLACK = 2
#: the one-process LM-only round 1 at dropout 0 (``phase_pp_reference``)
PP_ROUND1 = {}
# the expert axis and MoE blocks on the model axis: GPT2-small with 4
# experts (d = 294,095,665) at --local_batch_size 4 (N = 8,192 tokens a
# round, capacity 2,560; the (N, E, cap) one-hot tensors grow as N^2,
# ROADMAP.md X1), on 2 ranks sharing the card over gloo
EP_RANKS = 2
EP_GPT2_ROUNDS = 3
TP_MOE_ROUNDS = 2
EP_FLAGS = GPT2_FLAGS + MOE_FLAGS + ["--local_batch_size", "4"]
# mesh_ep_parity's round 1 (and mesh_tp_moe's, both at dropout 0) against
# the one-process round: the loss within EP_LOSS_RTOL, mesh_ep_parity's
# aggregate within EP_AGG_TOL of its largest coordinate and its table
# within EP_TABLE_SLACK times the ulps the aggregates' difference
# explains; mesh_tp_moe's table within TP_TABLE_SLACK times what its
# inputs explain (check_mesh_tp_gpt2's limit)
EP_LOSS_RTOL = 1e-5
EP_AGG_TOL = 1e-5
EP_TABLE_SLACK = 2
#: the one-process MoE round 1 at dropout 0 (``phase_ep_reference``)
EP_ROUND1 = {}


def phase_seq_reference(tmpdir):
    """mesh_seq_parity's reference: round 1 of ``GPT2_FLAGS`` with
    ``--attn_impl full`` at dropout 0 in this process (its loss, bytes,
    aggregate and table into ``SEQ_ROUND1``)."""
    from commefficient_tpu_torch.tools.mesh_run import gpt2_overrides
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    args = build_gpt2_parser().parse_args(GPT2_FLAGS + [
        "--attn_impl", "full", "--dataset_dir", tmpdir])
    np.random.seed(args.seed)
    t0 = time.perf_counter()
    with gpt2_overrides({"dropout": 0.0}), _RoundTables() as rec:
        learner, row = train(args, max_rounds=1, log=False)
    r = row["rounds"][0]
    SEQ_ROUND1.update(table=rec.tables[0].cpu().numpy(),
                      agg=rec.dense[0].cpu().numpy(), loss=r["loss"],
                      up=r["upload_bytes"], down=r["download_bytes"])
    del learner, row, rec
    _sync()
    print(f"seq reference: one process, --attn_impl full, dropout 0, round "
          f"1 loss {SEQ_ROUND1['loss']!r} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_pp_reference(tmpdir):
    """mesh_pp_parity's reference: round 1 of ``PP_FLAGS`` at dropout 0
    in this process (its loss, bytes, aggregate and table into
    ``PP_ROUND1``)."""
    from commefficient_tpu_torch.tools.mesh_run import gpt2_overrides
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    args = build_gpt2_parser().parse_args(PP_FLAGS + [
        "--dataset_dir", tmpdir, "--valid_batch_size", "32"])
    np.random.seed(args.seed)
    t0 = time.perf_counter()
    with gpt2_overrides({"dropout": 0.0}), _RoundTables() as rec:
        learner, row = train(args, max_rounds=1, log=False)
    r = row["rounds"][0]
    PP_ROUND1.update(table=rec.tables[0].cpu().numpy(),
                     agg=rec.dense[0].cpu().numpy(), loss=r["loss"],
                     up=r["upload_bytes"], down=r["download_bytes"])
    del learner, row, rec
    _sync()
    print(f"pp reference: one process, --mc_coef 0, dropout 0, round 1 "
          f"loss {PP_ROUND1['loss']!r} ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def phase_ep_reference(tmpdir):
    """mesh_ep_parity's and mesh_tp_moe's reference: round 1 of
    ``EP_FLAGS`` at dropout 0 in this process (its loss, bytes,
    aggregate, table and peak into ``EP_ROUND1``)."""
    import torch

    from commefficient_tpu_torch.tools.mesh_run import gpt2_overrides
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    args = build_gpt2_parser().parse_args(EP_FLAGS + [
        "--dataset_dir", tmpdir, "--valid_batch_size", "32"])
    np.random.seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with gpt2_overrides({"dropout": 0.0}), _RoundTables() as rec:
        learner, row = train(args, max_rounds=1, log=False)
    r = row["rounds"][0]
    EP_ROUND1.update(table=rec.tables[0].cpu().numpy(),
                     agg=rec.dense[0].cpu().numpy(), loss=r["loss"],
                     up=r["upload_bytes"], down=r["download_bytes"],
                     peak=torch.cuda.max_memory_allocated() / 2**30)
    del learner, row, rec
    _sync()
    print(f"ep reference: one process, --moe_experts 4 --local_batch_size "
          f"4, dropout 0, round 1 loss {EP_ROUND1['loss']!r}, peak "
          f"{EP_ROUND1['peak']:.2f} GiB ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def mesh_a12_specs(tmpdir):
    """The runs of A12 1b and the seq axis on ``phase_mesh``'s 2 ranks,
    on the persona caches the gpt2 paths made."""
    # validation in batches of 32 dialogs (the default 4 makes ~8x the
    # eval steps, each a ring or TP pass); the rounds do not read it
    data = ["--dataset_dir", tmpdir, "--valid_batch_size", "32"]
    seq = dict(entry="gpt2", seq=SEQ_RANKS)
    tp = dict(entry="gpt2", model=TP_RANKS)
    pp = dict(entry="gpt2", stage=PP_RANKS)
    return [
        _mesh_spec(tmpdir, "mesh_seq_gpt2", SEQ_FLAGS + data,
                   max_rounds=SEQ_GPT2_ROUNDS, time_collectives=True,
                   attrs={"dropout_impl": "tpu_bits"}, **seq),
        _mesh_spec(tmpdir, "mesh_seq_gpt2_b", SEQ_FLAGS + data,
                   max_rounds=SEQ_REPEAT_ROUNDS,
                   attrs={"dropout_impl": "tpu_bits"}, **seq),
        _mesh_spec(tmpdir, "mesh_seq_parity", SEQ_FLAGS + data,
                   max_rounds=1, record_table=True, record_block=True,
                   gpt2_config={"dropout": 0.0}, **seq),
        _mesh_spec(tmpdir, "mesh_tp_buffered", GPT2_FLAGS + data + [
            "--server_mode", "buffered"], max_rounds=TP_BUFFERED_ROUNDS,
            time_collectives=True, **tp),
        _mesh_spec(tmpdir, "mesh_tp_buckets", GPT2_FLAGS + data + [
            "--grad_buckets", str(TP_BUCKETS)], max_rounds=1,
            record_table=True, time_collectives=True, **tp),
        _mesh_spec(tmpdir, "mesh_tp_sparse_offload", GPT2_FLAGS + data
                   + GPT2_SPARSE_OFFLOAD, max_rounds=TP_OFFLOAD_ROUNDS,
                   time_collectives=True, **tp),
        _mesh_spec(tmpdir, "mesh_tp_sparse_device", GPT2_FLAGS + data + [
            f for f in GPT2_SPARSE_OFFLOAD if f != "--client_state_offload"],
            max_rounds=TP_OFFLOAD_ROUNDS, **tp),
        _mesh_spec(tmpdir, "mesh_pp_gpt2", PP_FLAGS + data,
                   max_rounds=PP_GPT2_ROUNDS, time_collectives=True, **pp),
        _mesh_spec(tmpdir, "mesh_pp_parity", PP_FLAGS + data + [
            "--pp_microbatches", str(PP_PARITY_MICRO)], max_rounds=1,
            record_table=True, record_block=True,
            gpt2_config={"dropout": 0.0}, **pp),
        *mesh_ep_specs(tmpdir, data),
    ]


def mesh_ep_specs(tmpdir, data):
    """The expert axis's and MoE-on-model runs on ``phase_mesh``'s 2
    ranks (``check_mesh_ep``)."""
    ep = dict(entry="gpt2", expert=EP_RANKS)
    return [
        _mesh_spec(tmpdir, "mesh_ep_gpt2", EP_FLAGS + data,
                   max_rounds=EP_GPT2_ROUNDS, time_collectives=True, **ep),
        _mesh_spec(tmpdir, "mesh_ep_parity", EP_FLAGS + data, max_rounds=1,
                   record_table=True, record_block=True,
                   gpt2_config={"dropout": 0.0}, **ep),
        _mesh_spec(tmpdir, "mesh_tp_moe", EP_FLAGS + data,
                   max_rounds=TP_MOE_ROUNDS, record_table=True,
                   record_block=True, time_collectives=True,
                   gpt2_config={"dropout": 0.0}, entry="gpt2",
                   model=TP_RANKS),
    ]


def _by_kind(rec, kind):
    """Per round of ``rec``: (ms, GB) of the collectives of ``kind``."""
    return [(round(r.get(kind, [0.0])[0] * 1e3, 3),
             round(r.get(kind, [0.0, 0])[1] / 1e9, 4))
            for r in rec["collectives_by_kind"]]


def _coll_ms(rec):
    return [round(c[0] * 1e3, 3) for c in rec["collectives"]]


def _same_rounds(a, b, n=None) -> bool:
    key = [(x["loss_hex"], x["upload_bytes"], x["download_bytes"])
           for x in a["rounds"]]
    other = [(x["loss_hex"], x["upload_bytes"], x["download_bytes"])
             for x in b["rounds"]]
    return key[:n] == other[:n] if n else key == other


def check_mesh_seq(tmpdir, recs, recs_b, parity):
    """mesh_seq_gpt2 and mesh_seq_parity's checks (see the module
    docstring, phase 11). Returns the launches summed over the ranks."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    for tag, rr in (("mesh_seq_gpt2", recs), ("mesh_seq_gpt2 (second run)",
                                              recs_b),
                    ("mesh_seq_parity", parity)):
        if any(r["backend"] != MESH_BACKEND or r["world"] != SEQ_RANKS
               for r in rr):
            raise AssertionError(f"{tag}: not the 2-rank gloo group")
        _mesh_ranks_agree(tag, rr)
    a, b = recs[0], recs_b[0]
    n = SEQ_REPEAT_ROUNDS
    if b["digests"] != a["digests"][:n] or not _same_rounds(a, b, n):
        raise AssertionError("mesh_seq_gpt2: the two runs differ")
    launches = _mesh_launches("mesh_seq_gpt2", recs, SEQ_LAUNCHES)
    for k, v in _mesh_launches("mesh_seq_gpt2 (second run)", recs_b,
                               _scaled(SEQ_LAUNCHES, n)).items():
        launches[k] = launches.get(k, 0) + v
    up = [x["upload_bytes"] for x in a["rounds"]]
    down = [x["download_bytes"] for x in a["rounds"]]
    ref = GPT2_ROUND1
    if up != [GPT2_WORKERS * GPT2_UPLOAD["gpt2"]] * SEQ_GPT2_ROUNDS \
            or down[:2] != ref["down"][:2] or a["d"] != D_GPT2:
        raise AssertionError(f"mesh_seq_gpt2: upload {up}, download {down} "
                             f"against the gpt2 path's {ref['up']}, "
                             f"{ref['down']}; d {a['d']}")
    ring = [_by_kind(r, "batch_isend_irecv") for r in recs]
    reduce = [_by_kind(r, "all_reduce") for r in recs]
    steady = [x["round_s"] * 1e3 for x in a["rounds"][1:-1]]
    print(f"path mesh_seq_gpt2: {SEQ_RANKS} ranks on one card over "
          f"{MESH_BACKEND} (clients=1, seq=2, T 256 in blocks of 128), "
          f"dropout_impl tpu_bits; launches a rank {a['launches']}; the "
          f"ranks' state bitwise every round; losses "
          f"{[round(x['loss'], 6) for x in a['rounds']]}; upload B {up}, "
          f"download B {down}; round ms rank 0 {_round_ms(a)}, rank 1 "
          f"{_round_ms(recs[1])} (steady {np.mean(steady):.3f}; a state "
          f"digest a round), second run ({n} rounds, every state digest "
          f"bitwise the first run's) {_round_ms(b)}; ring traffic a "
          f"round (ms, GB sent) rank 0 {ring[0]}, rank 1 {ring[1]}; "
          f"all-reduces a round (ms, GB) rank 0 {reduce[0]}; collectives "
          f"ms a round rank 0 {_coll_ms(a)} (synchronized around each); "
          f"peak GiB {_peaks(recs)}", flush=True)
    # mesh_seq_parity
    p = parity[0]
    loss, want = p["rounds"][0]["loss"], SEQ_ROUND1["loss"]
    if not math.isclose(loss, want, rel_tol=SEQ_LOSS_RTOL) \
            or p["rounds"][0]["upload_bytes"] != SEQ_ROUND1["up"]:
        raise AssertionError(f"mesh_seq_parity: round 1 loss {loss!r} "
                             f"against the one-process full attention's "
                             f"{want!r}")
    prefix = os.path.join(tmpdir, "mesh_seq_parity")
    tables = [np.load(f"{prefix}_rank{r}_table.npy")
              for r in range(SEQ_RANKS)]
    if not np.array_equal(tables[0], tables[1]):
        raise AssertionError("mesh_seq_parity: the ranks' tables differ")
    dev = torch.device("cuda")
    g_seq = torch.from_numpy(np.load(f"{prefix}_rank0_block.npy")).to(dev)
    g_full = torch.from_numpy(SEQ_ROUND1["agg"]).to(dev)
    whole = SEQ_ROUND1["table"]
    cs = CountSketch(D_GPT2, 500_000, 5, seed=42)
    if p["block_offset"] != 0 or g_seq.numel() != D_GPT2 or not \
            np.array_equal(cs.sketch_vec(g_seq).cpu().numpy(), tables[0]):
        raise AssertionError("mesh_seq_parity: the table is not the sketch "
                             "of the recorded aggregate")
    ulp = float(np.spacing(np.float32(np.abs(whole).max())))
    ulps_grad = float(_abs_sketch(cs, g_seq - g_full).max()) / ulp
    ulps = _ulps_of_largest(tables[0], whole)
    limit = SEQ_TABLE_SLACK * (ulps_grad + 1.0)
    grad_rel = float((g_seq - g_full).abs().max() / g_full.abs().max())
    del g_seq, g_full, cs
    torch.cuda.empty_cache()
    if ulps > limit:
        raise AssertionError(
            f"mesh_seq_parity: round 1's table {ulps:.1f} ulps of its "
            f"largest cell from the one-process full attention's (limit "
            f"{limit:.1f}: the aggregates' difference explains "
            f"{ulps_grad:.1f}, its max {grad_rel:.3e} of the largest)")
    print(f"path mesh_seq_parity: round 1 of clients=1, seq=2 ring "
          f"attention at dropout 0 against one process's --attn_impl full: "
          f"loss {loss!r} vs {want!r} (rtol {SEQ_LOSS_RTOL}); the "
          f"aggregate within {grad_rel:.3e} of the largest coordinate; the "
          f"table {ulps:.2f} ulps of its largest cell (limit {limit:.2f} = "
          f"{SEQ_TABLE_SLACK} x (the difference's {ulps_grad:.2f} + 1)); "
          f"round ms {_round_ms(p)}; peak GiB {_peaks(parity)}", flush=True)
    for k, v in _mesh_launches("mesh_seq_parity", parity, _scaled(
            dict(RECOVERY, sketch=3), 1)).items():
        launches[k] = launches.get(k, 0) + v
    return launches


def _round1_parity(tag, tmpdir, parity, ref, d, loss_rtol, agg_tol, slack):
    """Round 1 of ``parity`` (2 ranks at dropout 0, the aggregate whole on
    each: ``record_table``, ``record_block``) against the one-process
    round 1 ``ref`` (its loss, upload bytes, aggregate and table): the
    loss within ``loss_rtol``, the ranks' tables equal and the sketch of
    rank 0's recorded aggregate, the aggregate within ``agg_tol`` of its
    largest coordinate, the table within ``slack`` times (the ulps the
    aggregates' difference explains + 1). Returns (the table's ulps, its
    limit, the difference's ulps, the aggregate's relative distance,
    whether aggregate and table are bitwise ``ref``'s)."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    p = parity[0]
    loss, want = p["rounds"][0]["loss"], ref["loss"]
    if not math.isclose(loss, want, rel_tol=loss_rtol) \
            or p["rounds"][0]["upload_bytes"] != ref["up"]:
        raise AssertionError(f"{tag}: round 1 loss {loss!r} against the "
                             f"one-process round's {want!r}")
    prefix = os.path.join(tmpdir, tag)
    tables = [np.load(f"{prefix}_rank{r}_table.npy")
              for r in range(len(parity))]
    if not all(np.array_equal(tables[0], t) for t in tables[1:]):
        raise AssertionError(f"{tag}: the ranks' tables differ")
    dev = torch.device("cuda")
    g = torch.from_numpy(np.load(f"{prefix}_rank0_block.npy")).to(dev)
    g_one = torch.from_numpy(ref["agg"]).to(dev)
    whole = ref["table"]
    cs = CountSketch(d, 500_000, 5, seed=42)
    if p["block_offset"] != 0 or g.numel() != d or not \
            np.array_equal(cs.sketch_vec(g).cpu().numpy(), tables[0]):
        raise AssertionError(f"{tag}: the table is not the sketch of the "
                             f"recorded aggregate")
    ulp = float(np.spacing(np.float32(np.abs(whole).max())))
    ulps_grad = float(_abs_sketch(cs, g - g_one).max()) / ulp
    ulps = _ulps_of_largest(tables[0], whole)
    limit = slack * (ulps_grad + 1.0)
    grad_rel = float((g - g_one).abs().max() / g_one.abs().max())
    bitwise = (bool(torch.equal(g, g_one)),
               bool(np.array_equal(tables[0], whole)))
    del g, g_one, cs
    torch.cuda.empty_cache()
    if grad_rel > agg_tol or ulps > limit:
        raise AssertionError(
            f"{tag}: round 1's aggregate {grad_rel:.3e} of its largest "
            f"coordinate from the one-process round's (limit {agg_tol}), "
            f"its table {ulps:.1f} ulps of its largest cell (limit "
            f"{limit:.1f}: the aggregates' difference explains "
            f"{ulps_grad:.1f})")
    return ulps, limit, ulps_grad, grad_rel, bitwise


def _split_tables(tag, tmpdir, recs, d, agg, whole):
    """A model-axis run's round-1 table (``record_table``,
    ``record_block``; d padded by one to the 2 ranks) against the
    one-process aggregate ``agg`` and its table ``whole``: the ranks'
    tables equal and the sum of their block sketches, and within
    ``TP_TABLE_SLACK`` times the distance its inputs explain (the TP
    gradient's deviation and the block split's reassociation). Returns
    (the table's ulps, its limit, the gradient's ulps, the split's ulps,
    the gradient's relative distance)."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    d_pad = d + 1
    prefix = os.path.join(tmpdir, tag)
    tables = [np.load(f"{prefix}_rank{r}_table.npy") for r in range(2)]
    if not np.array_equal(tables[0], tables[1]):
        raise AssertionError(f"{tag}: the ranks' round-1 tables differ")
    dev = torch.device("cuda")
    blocks = [torch.from_numpy(np.load(f"{prefix}_rank{r}_block.npy"))
              .to(dev) for r in range(2)]
    offsets = [r["block_offset"] for r in recs]
    g_tp = torch.cat(blocks)
    if offsets[0] != 0 or offsets[1] != blocks[0].numel() \
            or g_tp.numel() != d_pad:
        raise AssertionError(f"{tag}: blocks at {offsets} of "
                             f"{[b.numel() for b in blocks]}")
    cs = CountSketch(d_pad, 500_000, 5, seed=42)
    split = (cs.sketch_range(blocks[0], 0)
             + cs.sketch_range(blocks[1], offsets[1])).cpu().numpy()
    if not np.array_equal(split, tables[0]):
        raise AssertionError(f"{tag}: round 1's table is not the sum of "
                             f"the ranks' block sketches")
    g_1 = torch.from_numpy(agg).to(dev)
    ulps = _ulps_of_largest(tables[0], whole)
    ulp = float(np.spacing(np.float32(np.abs(whole).max())))
    grad_dev = torch.cat([g_tp[:d] - g_1, g_tp[d:]])
    ulps_grad = float(_abs_sketch(cs, grad_dev).max()) / ulp
    g_1pad = torch.cat([g_1, g_1.new_zeros(1)])
    ulps_split = _ulps_of_largest(
        (cs.sketch_range(g_1pad[:offsets[1]], 0)
         + cs.sketch_range(g_1pad[offsets[1]:], offsets[1])).cpu().numpy(),
        whole)
    limit = TP_TABLE_SLACK * (ulps_grad + ulps_split)
    grad_rel = float(grad_dev.abs().max() / g_1.abs().max())
    del blocks, g_tp, g_1, g_1pad, grad_dev, cs
    torch.cuda.empty_cache()
    if ulps > limit:
        raise AssertionError(
            f"{tag}: round 1's table {ulps:.1f} ulps of its largest cell "
            f"from the one-process round's (limit {limit:.1f}: the TP "
            f"gradient's deviation explains {ulps_grad:.1f}, its max "
            f"{grad_rel:.3e} of the largest gradient; the block split "
            f"{ulps_split:.1f})")
    return ulps, limit, ulps_grad, ulps_split, grad_rel


def check_mesh_pp(tmpdir, recs, parity):
    """mesh_pp_gpt2 and mesh_pp_parity's checks (see the module
    docstring, phase 11). Returns the launches summed over the ranks."""
    for tag, rr in (("mesh_pp_gpt2", recs), ("mesh_pp_parity", parity)):
        if any(r["backend"] != MESH_BACKEND or r["world"] != PP_RANKS
               for r in rr):
            raise AssertionError(f"{tag}: not the 2-rank gloo group")
        _mesh_ranks_agree(tag, rr)
    # each stage rank: its 6 blocks' flash kernels for each of the 2
    # microbatches, the sketch and the recovery of the replicated tail
    launches = _mesh_launches("mesh_pp_gpt2", recs, _scaled(
        GPT2_SKETCH, PP_GPT2_ROUNDS))
    a = recs[0]
    up = [x["upload_bytes"] for x in a["rounds"]]
    down = [x["download_bytes"] for x in a["rounds"]]
    ref = GPT2_ROUND1
    if up != [GPT2_WORKERS * GPT2_UPLOAD["gpt2"]] * PP_GPT2_ROUNDS \
            or down[:2] != ref["down"][:2] or a["d"] != D_GPT2:
        raise AssertionError(f"mesh_pp_gpt2: upload {up}, download {down} "
                             f"against the gpt2 path's {ref['up']}, "
                             f"{ref['down']}; d {a['d']}")
    hops = [_by_kind(r, "stage_send") for r in recs]
    waits = [_by_kind(r, "stage_recv") for r in recs]
    for r, rec in enumerate(recs):
        sent = [k.get("stage_send", [0.0, 0])[1]
                for k in rec["collectives_by_kind"]]
        if sent != [PP_HOP_BYTES] * PP_GPT2_ROUNDS:
            raise AssertionError(f"mesh_pp_gpt2: rank {r} sent {sent} B a "
                                 f"round, not {PP_HOP_BYTES}")
    reduce = [_by_kind(r, "all_reduce") for r in recs]
    # the share of a steady round a rank waits in its receives (the GPipe
    # bubble is 1/3 of the ticks at 2 stages and 2 microbatches; the
    # first round carries the set-up, the last round's period is its read)
    idle = [[round(w[0] / (x["round_s"] * 1e3), 3)
             for w, x in zip(wr[1:-1], r["rounds"][1:-1])]
            for wr, r in zip(waits, recs)]
    steady = [x["round_s"] * 1e3 for x in a["rounds"][1:-1]]
    print(f"path mesh_pp_gpt2: {PP_RANKS} ranks on one card over "
          f"{MESH_BACKEND} (clients=1, stage=2: blocks 0-5 and 6-11, 2 "
          f"microbatches of 32 sequences, --mc_coef 0); launches a rank "
          f"{a['launches']}; the ranks' state bitwise every round; losses "
          f"{[round(x['loss'], 6) for x in a['rounds']]}; upload B {up}, "
          f"download B {down}; round ms stage 0 {_round_ms(a)}, stage 1 "
          f"{_round_ms(recs[1])} (steady {np.mean(steady):.3f}; a state "
          f"digest a round); hops sent a round (ms, GB) stage 0 {hops[0]}, "
          f"stage 1 {hops[1]}; receive waits a round (ms) stage 0 "
          f"{[w[0] for w in waits[0]]}, stage 1 {[w[0] for w in waits[1]]}, "
          f"of a steady round {idle[0]}, {idle[1]} (the schedule's bubble "
          f"1/3 of the ticks); "
          f"all-reduces a round (ms, GB) stage 0 {reduce[0]}; collectives "
          f"ms a round stage 0 {_coll_ms(a)} (synchronized around each); "
          f"peak GiB stage 0, stage 1 {_peaks(recs)}", flush=True)
    # mesh_pp_parity
    p = parity[0]
    loss, want = p["rounds"][0]["loss"], PP_ROUND1["loss"]
    ulps, limit, ulps_grad, grad_rel, _ = _round1_parity(
        "mesh_pp_parity", tmpdir, parity, PP_ROUND1, D_GPT2, PP_LOSS_RTOL,
        PP_AGG_TOL, PP_TABLE_SLACK)
    per_round = {k: v // PP_GPT2_ROUNDS for k, v in GPT2_SKETCH.items()}
    micro = PP_PARITY_MICRO // PP_RANKS
    want_launches = dict(per_round, **{k: per_round[k] * micro for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    for k, v in _mesh_launches("mesh_pp_parity", parity,
                               want_launches).items():
        launches[k] = launches.get(k, 0) + v
    print(f"path mesh_pp_parity: round 1 of clients=1, stage=2 in "
          f"{PP_PARITY_MICRO} microbatches at dropout 0 against one "
          f"process's --mc_coef 0 round: loss {loss!r} vs {want!r} (rtol "
          f"{PP_LOSS_RTOL}); the aggregate within {grad_rel:.3e} of the "
          f"largest coordinate (limit {PP_AGG_TOL}); the table {ulps:.2f} "
          f"ulps of its largest cell (limit {limit:.2f} = {PP_TABLE_SLACK} "
          f"x (the difference's {ulps_grad:.2f} + 1)); launches a rank "
          f"{p['launches']}; round ms {_round_ms(p)}, {_round_ms(parity[1])};"
          f" peak GiB {_peaks(parity)}", flush=True)
    return launches


def _gb(nbytes) -> float:
    return round(nbytes / 1e9, 4)


def _expert_products_bitwise() -> dict:
    """At mesh_ep_gpt2's shapes (8,192 tokens, 4 experts of capacity
    2,560, C 768, d_ff 3,072; seeded weights and tokens), whether each
    per-expert tensor of an expert rank's MoE block (experts 0-1: its
    dispatch slice and weight blocks) is bitwise the 4-expert block's
    first two, forward (the dispatched tokens, the hidden layer, the
    experts' outputs) and backward (their gradients, the combine
    weights', the weights'). A check only."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops.moe import MoEFFN
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    layer = MoEFFN(768, 4, 3072)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    layer.to(dev)
    xt, gy = (torch.randn(8192, 768, generator=gen).to(dev)
              for _ in range(2))
    with torch.no_grad():
        r = layer.route(xt)
    slots = torch.arange(r.capacity, device=dev, dtype=r.slot.dtype)
    dispatch = r.onehot[:, :, None] * (r.slot[:, None] == slots).float()[
        :, None, :]
    names = ("xin", "h", "out_e", "combine", "w1", "b1", "w2", "b2")

    def block(per):
        w = [t[:per].detach().requires_grad_(True) for t in (
            layer.moe_w1, layer.moe_b1, layer.moe_w2, layer.moe_b2)]
        gate = r.gate.detach().requires_grad_(True)
        x = xt.detach().requires_grad_(True)
        d = dispatch[:, :per]
        xin = torch.einsum("nec,nd->ecd", d, x)
        h = F.gelu(torch.einsum("ecd,edh->ech", xin, w[0])
                   + w[1][:, None, :], approximate="tanh")
        out_e = torch.einsum("ech,ehd->ecd", h, w[2]) + w[3][:, None, :]
        combine = d * gate[:, None, None]
        out = torch.einsum("nec,ecd->nd", combine, out_e)
        grads = torch.autograd.grad(out, [xin, h, out_e, combine] + w, gy)
        return (xin.detach(), h.detach(), out_e.detach()), grads

    (f4, g4), (f2, g2) = block(4), block(2)
    out = {n: bool(torch.equal(a[:2], b))
           for n, a, b in zip(names, f4, f2)}
    for n, a, b in zip(names, g4, g2):
        a = a[:, :2] if n == "combine" else a[:2]
        out[f"d{n}"] = bool(torch.equal(a, b))
    del layer, xt, gy, r, dispatch, f4, g4, f2, g2
    torch.cuda.empty_cache()
    return out


def check_mesh_ep(tmpdir, recs, parity, tp_moe):
    """mesh_ep_gpt2, mesh_ep_parity and mesh_tp_moe's checks (see the
    module docstring, phase 12) against ``EP_ROUND1``. Returns the
    launches summed over the ranks."""
    for tag, rr in (("mesh_ep_gpt2", recs), ("mesh_ep_parity", parity),
                    ("mesh_tp_moe", tp_moe)):
        if any(r["backend"] != MESH_BACKEND or r["world"] != EP_RANKS
               for r in rr):
            raise AssertionError(f"{tag}: not the 2-rank gloo group")
        _mesh_ranks_agree(tag, rr)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # mesh_ep_gpt2: each rank the whole model but half the experts
    add(_mesh_launches("mesh_ep_gpt2", recs, _scaled(GPT2_SKETCH,
                                                     EP_GPT2_ROUNDS)))
    a = recs[0]
    up = [x["upload_bytes"] for x in a["rounds"]]
    if up != [GPT2_WORKERS * GPT2_UPLOAD["gpt2"]] * EP_GPT2_ROUNDS \
            or a["d"] != D_GPT2_MOE or a["held"] != D_GPT2_MOE:
        raise AssertionError(f"mesh_ep_gpt2: upload {up}, d {a['d']}, held "
                             f"{a['held']}")
    if not all(math.isfinite(x["loss"]) for x in a["rounds"]):
        raise AssertionError("mesh_ep_gpt2: a loss is not finite")
    kinds = {k: [_by_kind(r, k) for r in recs] for k in (
        "expert_combine", "expert_grad", "expert_join", "all_reduce",
        "all_gather")}
    steady = [x["round_s"] * 1e3 for x in a["rounds"][1:-1]]
    peaks = [r["peak_gib"] for r in recs]
    print(f"path mesh_ep_gpt2: {EP_RANKS} ranks on one card over "
          f"{MESH_BACKEND} (clients=1, expert=2: experts 0-1 and 2-3 of "
          f"every block, --local_batch_size 4: N = 8,192 tokens, capacity "
          f"2,560), d = {a['d']}; launches a rank {a['launches']}; the "
          f"ranks' whole state bitwise every round; losses "
          f"{[round(x['loss'], 6) for x in a['rounds']]}; upload B {up}, "
          f"download B {[x['download_bytes'] for x in a['rounds']]}; round "
          f"ms rank 0 {_round_ms(a)}, rank 1 {_round_ms(recs[1])} (steady "
          f"{np.mean(steady):.3f}; a state digest a round); expert-group "
          f"collectives a round, rank 0 (ms, GB): the combine all-reduces "
          f"{kinds['expert_combine'][0]}, the f all-reduces "
          f"{kinds['expert_grad'][0]}, the gradient join "
          f"{kinds['expert_join'][0]}; rank 1: "
          f"{kinds['expert_combine'][1]}, {kinds['expert_grad'][1]}, "
          f"{kinds['expert_join'][1]}; other all-reduces "
          f"{kinds['all_reduce'][0]}, all-gathers {kinds['all_gather'][0]};"
          f" collectives ms a round rank 0 {_coll_ms(a)} (synchronized "
          f"around each); peak GiB {_peaks(recs)}, both ranks "
          f"{sum(peaks) if None not in peaks else 'not measured'}",
          flush=True)

    # mesh_ep_parity: round 1 at dropout 0 against one process
    p = parity[0]
    loss, want = p["rounds"][0]["loss"], EP_ROUND1["loss"]
    ulps, limit, ulps_grad, grad_rel, (agg_bitwise, table_bitwise) = \
        _round1_parity("mesh_ep_parity", tmpdir, parity, EP_ROUND1,
                       D_GPT2_MOE, EP_LOSS_RTOL, EP_AGG_TOL, EP_TABLE_SLACK)
    products = _expert_products_bitwise()
    add(_mesh_launches("mesh_ep_parity", parity, _scaled(GPT2_SKETCH, 1)))
    print(f"path mesh_ep_parity: round 1 of clients=1, expert=2 at dropout "
          f"0 against one process's round (peak {EP_ROUND1['peak']:.2f} "
          f"GiB): loss {loss!r} vs {want!r} (rtol {EP_LOSS_RTOL}); the "
          f"aggregate within {grad_rel:.3e} of the largest coordinate "
          f"(limit {EP_AGG_TOL}), bitwise the one-process aggregate: "
          f"{agg_bitwise}; the table {ulps:.2f} ulps of its largest cell "
          f"(limit {limit:.2f} = {EP_TABLE_SLACK} x (the difference's "
          f"{ulps_grad:.2f} + 1)), bitwise the one-process table: "
          f"{table_bitwise}; an expert rank's per-expert tensors (2 of 4 "
          f"experts) bitwise the 4-expert block's: {products}; round ms "
          f"{_round_ms(p)}; peak GiB {_peaks(parity)}", flush=True)

    # mesh_tp_moe: every MoE block whole on each model rank
    add(_mesh_launches("mesh_tp_moe", tp_moe, _scaled(GPT2_SKETCH,
                                                      TP_MOE_ROUNDS)))
    t = tp_moe[0]
    d_pad = D_GPT2_MOE + 1
    if [(r["d"], r["held"]) for r in tp_moe] != [(d_pad, d_pad // 2)] * 2:
        raise AssertionError(f"mesh_tp_moe: d, held "
                             f"{[(r['d'], r['held']) for r in tp_moe]}")
    loss = t["rounds"][0]["loss"]
    if not math.isclose(loss, want, rel_tol=EP_LOSS_RTOL) \
            or t["rounds"][0]["upload_bytes"] != EP_ROUND1["up"]:
        raise AssertionError(f"mesh_tp_moe: round 1 loss {loss!r} against "
                             f"the one-process round's {want!r}")
    ulps, limit, ulps_grad, ulps_split, grad_rel = _split_tables(
        "mesh_tp_moe", tmpdir, tp_moe, D_GPT2_MOE, EP_ROUND1["agg"],
        EP_ROUND1["table"])
    coll = t["collectives"]
    steady = [x["round_s"] * 1e3 for x in t["rounds"][1:]]
    peaks = [r["peak_gib"] for r in tp_moe]
    print(f"path mesh_tp_moe: {TP_RANKS} ranks on one card over "
          f"{MESH_BACKEND} (clients=1, model=2, each MoE block whole on "
          f"both; --local_batch_size 4, dropout 0), d = {D_GPT2_MOE} padded "
          f"to {d_pad}, {d_pad // 2} coordinates held a rank; launches a "
          f"rank {t['launches']} (flash at BH 192: 6 heads of 32 "
          f"sequences); the ranks' whole state bitwise every round; losses "
          f"{[round(x['loss'], 6) for x in t['rounds']]}; round 1's table "
          f"bitwise the ranks' block sketches summed, {ulps:.2f} ulps of "
          f"its largest cell from the one-process round's (limit "
          f"{limit:.2f} = {TP_TABLE_SLACK} x (gradient deviation "
          f"{ulps_grad:.2f} + block split {ulps_split:.2f})), the TP "
          f"gradient within {grad_rel:.3e} of the one-process largest; "
          f"round ms rank 0 {_round_ms(t)}, rank 1 {_round_ms(tp_moe[1])} "
          f"(round 2 {np.mean(steady):.3f}; a state digest a round); "
          f"collectives a round, rank 0 (synchronized around each): "
          f"{[round(c[0] * 1e3, 3) for c in coll]} ms, "
          f"{[_gb(c[1]) for c in coll]} GB, {[c[2] for c in coll]} calls; "
          f"peak GiB {_peaks(tp_moe)}, both ranks "
          f"{sum(peaks) if None not in peaks else 'not measured'}",
          flush=True)
    return launches


def check_mesh_tp_1b(tmpdir, tp, buffered, buckets, offload, device):
    """mesh_tp_buffered, mesh_tp_buckets and mesh_tp_sparse_offload's
    checks (see the module docstring, phase 11) against mesh_tp_gpt2's
    records ``tp``. Returns the launches summed over the ranks."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for tag, rr in (("mesh_tp_buffered", buffered),
                    ("mesh_tp_buckets", buckets),
                    ("mesh_tp_sparse_offload", offload),
                    ("mesh_tp_sparse_device", device)):
        if any(r["backend"] != MESH_BACKEND or r["world"] != TP_RANKS
               for r in rr):
            raise AssertionError(f"{tag}: not the 2-rank gloo group")
        _mesh_ranks_agree(tag, rr)
    # buffered lock-step: the sync round itself (C13), bitwise
    n = TP_BUFFERED_ROUNDS
    if buffered[0]["digests"] != tp[0]["digests"][:n] \
            or not _same_rounds(buffered[0], tp[0], n) \
            or buffered[0]["applies"] != n:
        raise AssertionError("mesh_tp_buffered: lock-step is not "
                             "mesh_tp_gpt2's rounds")
    add(_mesh_launches("mesh_tp_buffered", buffered,
                       _scaled(GPT2_SKETCH, n)))
    print(f"path mesh_tp_buffered: --server_mode buffered on clients=1, "
          f"model=2: every round's whole state, losses and bytes bitwise "
          f"mesh_tp_gpt2's ({n} rounds, {buffered[0]['applies']} applies); "
          f"launches a rank {buffered[0]['launches']}; round ms "
          f"{_round_ms(buffered[0])}; collectives ms a round "
          f"{_coll_ms(buffered[0])}; peak GiB {_peaks(buffered)}",
          flush=True)
    # buckets: the same aggregate, sketched bucket by bucket within each
    # rank's block
    b0 = buckets[0]
    prefix = os.path.join(tmpdir, "mesh_tp_buckets")
    tables = [np.load(f"{prefix}_rank{r}_table.npy")
              for r in range(TP_RANKS)]
    if not np.array_equal(tables[0], tables[1]):
        raise AssertionError("mesh_tp_buckets: the ranks' tables differ")
    offsets, sizes = b0["buckets"]
    if len(offsets) < 2:
        raise AssertionError(f"mesh_tp_buckets: one bucket {b0['buckets']}")
    dev = torch.device("cuda")
    tp_prefix = os.path.join(tmpdir, "mesh_tp_gpt2")
    blocks = [torch.from_numpy(np.load(f"{tp_prefix}_rank{r}_block.npy"))
              .to(dev) for r in range(TP_RANKS)]
    starts = [r["block_offset"] for r in tp]
    g = torch.cat(blocks)
    cs = CountSketch(g.numel(), 500_000, 5, seed=42)
    pieces, table = [], None
    for (lo, hi) in zip(starts, starts[1:] + [g.numel()]):
        part, n_r = None, 0
        for o, m in zip(offsets, sizes):
            a, b = max(o, lo), min(o + m, hi)
            if a >= b:
                continue
            t = cs.sketch_range(g[a:b], a)
            part = t if part is None else part + t
            n_r += 1
        pieces.append(n_r)
        table = part if table is None else table + part
    # round 1 on each rank: the flash kernels and the recovery once, a
    # sketch launch a piece of its block
    for r, rec in enumerate(buckets):
        want = dict(_scaled(GPT2_SKETCH, 1), sketch=pieces[r])
        if rec["launches"] != want:
            raise AssertionError(f"mesh_tp_buckets: rank {r} launched "
                                 f"{rec['launches']}, expected {want}")
        add(rec["launches"])
    pieces = sum(pieces)
    ulp = float(np.spacing(np.float32(np.abs(tables[0]).max())))
    same = np.array_equal(table.cpu().numpy(), tables[0])
    whole = np.load(f"{tp_prefix}_rank0_table.npy")
    # the two summation orders of a cell's n coordinates (its block's in
    # one pass, or its pieces' passes added): each is within (n - 1 +
    # pieces) 2^-24 sum|x| of the exact sum (recursive summation)
    count = _abs_sketch(cs, torch.ones_like(g)).cpu().numpy()
    bound = (2 * (count - 1 + pieces) * 2.0 ** -24
             * _abs_sketch(cs, g).cpu().numpy())
    dist_ = np.abs(tables[0].astype(np.float64) - whole)
    del blocks, g, table, cs
    torch.cuda.empty_cache()
    if not same or np.any(dist_ > bound):
        raise AssertionError(
            f"mesh_tp_buckets: bitwise the pieces' sketches summed: {same}; "
            f"max distance from mesh_tp_gpt2's table "
            f"{dist_.max() / ulp:.2f} ulps, over the bound in "
            f"{int(np.sum(dist_ > bound))} cells")
    print(f"path mesh_tp_buckets: --grad_buckets {TP_BUCKETS} on clients=1, "
          f"model=2 ({len(offsets)} buckets, {pieces} bucket-block pieces): "
          f"round 1's table bitwise the pieces' sketches summed (each rank "
          f"its pieces in bucket order, then the model group), "
          f"{dist_.max() / ulp:.2f} ulps of its largest cell from "
          f"mesh_tp_gpt2's, every cell within 2 (n - 1 + pieces) 2^-24 "
          f"sum|x| of it (n its coordinates), at most "
          f"{float(np.max(dist_ / np.maximum(bound, 1e-45))):.3e} of that "
          f"bound; "
          f"launches a rank {b0['launches']}; round ms {_round_ms(b0)}; "
          f"collectives ms {_coll_ms(b0)}; peak GiB {_peaks(buckets)}",
          flush=True)
    # sparse offload: bitwise the device-resident rows
    o0, d0 = offload[0], device[0]
    if (o0["rows_sha"], o0["weights_sha"], o0["digests"]) != (
            d0["rows_sha"], d0["weights_sha"], d0["digests"]) \
            or not _same_rounds(o0, d0):
        raise AssertionError("mesh_tp_sparse_offload: the offloaded rows "
                             "or state are not the device-resident run's")
    want = dict(_scaled(LOCAL_TOPK, TP_OFFLOAD_ROUNDS),
                flash_fwd=48 * TP_OFFLOAD_ROUNDS,
                flash_bwd_dq=48 * TP_OFFLOAD_ROUNDS,
                flash_bwd_dkv=48 * TP_OFFLOAD_ROUNDS)
    add(_mesh_launches("mesh_tp_sparse_offload", offload, want))
    add(_mesh_launches("mesh_tp_sparse_device", device, want))
    print(f"path mesh_tp_sparse_offload: gpt2_local_topk_sparse_offload's "
          f"flags on clients=1, model=2: the rows (k pairs, encoded from "
          f"the whole row every model rank holds), weights and every "
          f"round's state bitwise the device-resident run's over "
          f"{TP_OFFLOAD_ROUNDS} rounds; arena {o0['arena_bytes']} B a rank, "
          f"shard reads {[r['shard_reads'] for r in offload]}; launches a "
          f"rank {o0['launches']}; round ms offload {_round_ms(o0)}, device "
          f"{_round_ms(d0)}; collectives ms a round {_coll_ms(o0)}; peak "
          f"GiB offload {_peaks(offload)}, device {_peaks(device)}",
          flush=True)
    return launches


def phase_serve_tp2(tmpdir, prompts, replies, eos):
    """serve_tp2: serve_gpt2's burst (the same seeded GPT2-small, server
    and prompts) through ``DecodeEngine(mesh=)`` at tp = 2 on 2 ranks
    sharing the card over gloo (``tools/serve_tp.py``): every rank's
    replies token-identical to serve_gpt2's ``replies``, flash_fwd 12 a
    prefill a rank and nothing else, 24 all-reduces a decode step, a
    rank's pools half the model's, no page left in use. Returns the
    launches summed over the ranks."""
    from commefficient_tpu_torch.tools import serve_tp
    spec = dict(out=os.path.join(tmpdir, "serve_tp2"),
                prompts=[(list(ids), list(types))
                         for _, _, ids, types in prompts],
                eos=int(eos), seed=0, vocab=50262, n_layer=12,
                device="cuda", max_new=SERVE_NEW, warmup=SERVE_SLOTS,
                warmup_new=SERVE_WARMUP_NEW, slots=SERVE_SLOTS,
                prefill=SERVE_PREFILL, max_len=SERVE_MAX_LEN,
                page=SERVE_PAGE)
    t0 = time.perf_counter()
    recs = serve_tp.launch(spec, TP_RANKS, MESH_BACKEND)
    wall = time.perf_counter() - t0
    want = {"flash_fwd": 12 * SERVE_REQUESTS}
    launches = {}
    for rec in recs:
        if rec["tp"] != TP_RANKS or rec["backend"] != MESH_BACKEND:
            raise AssertionError(f"serve_tp2: rank {rec['rank']} tp "
                                 f"{rec['tp']} over {rec['backend']}")
        if rec["replies"] != replies:
            bad = [i for i, (a, b) in enumerate(zip(rec["replies"],
                                                    replies)) if a != b]
            raise AssertionError(f"serve_tp2: rank {rec['rank']}'s replies "
                                 f"{bad} differ from serve_gpt2's")
        if rec["launches"] != want:
            raise AssertionError(f"serve_tp2: rank {rec['rank']} launched "
                                 f"{rec['launches']}, expected {want}")
        if rec["allreduces_per_decode_step"] != [24] \
                or rec["kv_pool_bytes_per_rank"] * TP_RANKS \
                != rec["kv_pool_bytes"] or rec["pages_in_use"]:
            raise AssertionError(f"serve_tp2: rank {rec['rank']}: "
                                 f"{rec['allreduces_per_decode_step']} "
                                 f"all-reduces a step, pools "
                                 f"{rec['kv_pool_bytes_per_rank']} of "
                                 f"{rec['kv_pool_bytes']}, "
                                 f"{rec['pages_in_use']} pages in use")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    r0 = recs[0]
    print(f"serve_tp2 (serve_gpt2's burst at tp = {TP_RANKS}, {TP_RANKS} "
          f"ranks on one card over {MESH_BACKEND}): replies token-identical "
          f"to serve_gpt2's on every rank; {r0['tokens']} tokens in "
          f"{r0['wall_s']:.3f} s = {r0['tokens'] / r0['wall_s']:.1f} "
          f"tokens/s; decode step median {np.median(r0['decode_ms']):.3f} "
          f"ms (rank 1 {np.median(recs[1]['decode_ms']):.3f}) over "
          f"{len(r0['decode_ms'])} decode-only steps; all-reduces a decode "
          f"step {r0['allreduces_per_decode_step']}, their ms a step median "
          f"{np.median(r0['allreduce_ms_per_decode_step']):.3f} "
          f"(synchronized around each); KV pool "
          f"{r0['kv_pool_bytes_per_rank'] / 2**30:.3f} GiB a rank of "
          f"{r0['kv_pool_bytes'] / 2**30:.3f}; launches a rank "
          f"{r0['launches']}; peak GiB {_peaks(recs)} ({wall:.1f} s)",
          flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    try:
        import commefficient_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def stamp(label):
        # the script's time so far, at each group of phases (a smoke run
        # has a time limit, and the script grows)
        print(f"time: {label} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    smi = _smi()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    stamp("build (all but LATE_BUILDS)")
    errs = {}
    cs, vec, table = phase_parity(dev, D_RESNET9, errs)
    inputs = phase_parity_stream(dev, cs, table, errs)
    phase_parity_radix(dev, cs, table, errs)
    rows_inputs = phase_parity_rows(dev, errs)
    phase_server_ab(dev, cs, table)
    phase_sketch_sparse(dev, cs, table)
    times = phase_timing(cs, vec, table)
    times.update(phase_timing_stream(cs, table, inputs))
    times.update(phase_timing_rows(rows_inputs))
    del rows_inputs
    times.update(phase_timing_radix(cs, table))
    tables = phase_parity_estimates_batched(dev, cs, table, errs)
    times["estimates_batched"] = phase_timing_estimates_batched(cs, table,
                                                                tables)
    del vec, table, inputs, tables
    cs, vecs = phase_parity_batched(dev, D_RESNET9, 8, errs)
    times["sketch_batched"] = phase_timing_batched(cs, vecs)
    del cs, vecs
    torch.cuda.empty_cache()
    stamp("kernel parity and timing at ResNet9's d")
    # the flash build ran beside the kernel phases above (the card's work,
    # little of the host's); the CV paths would slow it down threefold
    phase_build_report()
    launches = {}
    for name in PATHS:
        for kernel, n in phase_path(name).items():
            launches[kernel] = launches.get(kernel, 0) + n
    phase_native_feed()
    for phase in (phase_sketch_scan, phase_cifar10_fetchsgd):
        for kernel, n in phase().items():
            launches[kernel] = launches.get(kernel, 0) + n
    stamp("the CV paths")
    phase_offload_parity()
    sketch_ref = phase_repeat(dev)
    with tempfile.TemporaryDirectory() as tmpdir:
        robust = [phase_buffered_lockstep(sketch_ref),
                  phase_buffered_faults(), phase_quarantine(),
                  phase_offload_robust()]
        resume_launches, export = phase_sigkill_resume(tmpdir)
        robust += [resume_launches, phase_finetune(export)]
    for counts in robust:
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
    del robust
    stamp("repeat and robustness")
    phase_reference(dev)
    phase_flash_parity(dev, errs)
    phase_tp_flash_parity(dev, errs)
    times.update(phase_flash_timing(dev))
    phase_hw_dropout_parity(dev, errs)
    times["hw_dropout"] = phase_hw_dropout_timing(dev)
    # the sketch-mode kernels again at the GPT2 path's d (timed apart: the
    # kernel line keeps ResNet9's d)
    cs, vec, table = phase_parity(dev, D_GPT2, errs)
    phase_parity_radix(dev, cs, table, errs)
    phase_server_ab(dev, cs, table)
    phase_timing(cs, vec, table, plain_reps=3)
    phase_timing_radix(cs, table)
    del cs, vec, table
    phase_timing_rows_b1(dev, D_GPT2)
    cs, vecs = phase_parity_batched(dev, D_GPT2, GPT2_WORKERS, errs)
    phase_timing_batched(cs, vecs, plain_reps=3)
    del cs, vecs
    torch.cuda.empty_cache()
    phase_download_counts(dev)
    stamp("flash, hw_dropout and the kernels at GPT2's d")
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in GPT2_PATHS:
            for kernel, n in phase_gpt2_path(tmpdir, name,
                                             profile=True).items():
                launches[kernel] = launches.get(kernel, 0) + n
        gpt2_ref = phase_repeat_gpt2(tmpdir)
        for phase in (phase_gpt2_scan, phase_gpt2_resume,
                      phase_gpt2_robust):
            for kernel, n in phase(tmpdir, gpt2_ref).items():
                launches[kernel] = launches.get(kernel, 0) + n
        del gpt2_ref
        stamp("the GPT2 paths")
        # the clients mesh, mesh_gpt2 on the persona cache made above
        mesh = [phase_mesh_nccl1(tmpdir, sketch_ref)]
        mesh_launches, base = phase_mesh(tmpdir, sketch_ref)
        GPT2_ROUND1.clear()
        phase_mesh_kill(tmpdir, base)
        for counts in mesh + [mesh_launches]:
            for kernel, n in counts.items():
                launches[kernel] = launches.get(kernel, 0) + n
        del sketch_ref
    stamp("the meshes")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        for kernel, n in phase_gpt2_moe(tmpdir, errs, dev).items():
            launches[kernel] = launches.get(kernel, 0) + n
    model, batch = _gpt2_small(dev), _gpt2_small_batch(dev)
    phase_fused_ce(model, batch)
    phase_remat(model, batch)
    phase_chunk_host(model, batch)
    del model, batch
    phase_gpt2_reference(dev)
    stamp("MoE, fused CE, remat, chunk host, GPT2 reference")
    with tempfile.TemporaryDirectory() as tmpdir:
        serve_launches, engine, prompts, replies = phase_serve_gpt2(
            dev, tmpdir, errs)
    phase_serve_variants(engine, prompts, replies)
    eos = engine.eos_id
    del engine
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        for kernel, n in phase_serve_tp2(tmpdir, prompts, replies,
                                         eos).items():
            launches[kernel] = launches.get(kernel, 0) + n
    del prompts, replies
    with tempfile.TemporaryDirectory() as tmpdir:
        online_launches = phase_serve_online(tmpdir, errs)
    for counts in (serve_launches, online_launches):
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = times[name]
        bound_ms, kind = r["cost"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": kind, "library_ms": r["library_ms"],
            "at": r.get("at", f"d={D_RESNET9}"),
            **{key: r[key] for key in ("flash_route", "bound_cuda_cores_ms",
                                       "device_ms") if key in r}})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
