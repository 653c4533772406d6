"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``), torch and numpy. Phases:

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a, one process per source, all
   started together) into ``build/repro_torch/``; each kernel's
   registers, static shared memory and spills from ``-Xptxas -v``;
2. kernels vs plain versions on the card:
   a. flash attention against ``flash_attention_plain`` over the
      reference's test sweep (f32 at 2e-5 on the SIMT kernel, bf16 at
      2e-2 on the tensor-core kernel; the instantiation each call ran is
      checked and printed), the windows, the decode offset, fully masked
      rows (before position 0 and past the window), T > S with
      q_offset, S not a multiple of 64, MQA and GQA, q/k/v as views of
      one fused projection, zamba2's shared-attention shapes (D=80,
      H=KV=32), whisper's encoder (4 x 1500 frames, 20/20 heads of 64,
      no mask: a 28-key last tile), llava's prefix (2880 patches + 128
      tokens, 32/8 heads of 128) and smollm's serving shape; times the
      kernel, the plain version and ``F.scaled_dot_product_attention``
      (a yardstick only: the port never calls it) in turns at six
      prefill shapes (smollm's serving batch and one request, olmoe's,
      zamba2's, whisper's encoder and llava's prefix), on the device
      alone (torch.profiler) and back to back between CUDA events,
      beside the bound and the host's time to issue one call;
   b. the SSD chunk kernels against ``ssd_chunked_plain`` (all three
      outputs) over the reference's sweep in f32 (5e-5, the SIMT
      ``ssd_chunk``) and bf16 (5e-2, the tensor-core ``ssd_chunk_mma``;
      the instantiation each call ran is checked), Q=100, Q=7, P=32,
      mamba2's one-request shapes (B=1, S=128/256/512) and both models'
      serving shapes; times kernel and plain at mamba2's serving shape
      and the one-request shapes, warm (back to back, and on the device
      from the profiler) and cold (L2 flushed by a 1 GiB write before
      each call), beside the bound (no single PyTorch call computes this
      function, so there is no library time);
   c. the segment-combine kernel against ``segment_combine_plain`` over
      the reference's sweep (n in 7, 128, 1000, 65536), 16M elements and
      misaligned row slices, f32 and bf16, add/max/min, at the
      reference's 1e-6 (it is expected bit-equal; the count of bit-equal
      cases is printed), each case again in place (``out=acc``), which
      must give the out-of-place bits; times kernel, plain and
      ``torch.add`` (the yardstick), the in-place call, ``Tensor.add_``
      and the out-of-place call plus a copy back, at 16M elements f32 and
      bf16 beside the bound, and the kernel's design alternatives
      (vectors per thread, grid cap);
   d. the paged decode attention kernel (split over the table, two
      launches) against ``ref.paged_attention_ref`` (the gather path)
      over the reference's sweep (partial, full, wrapped and
      several-wraps-deep views, windows 0 and 6, shuffled tables) at head
      dims 64, 80 and 128, the five serving shapes (smollm, zamba2,
      olmoe, whisper's decoder, llava) and the splits' edges (an empty
      row, splits with no valid slot, a wrapped window across a split
      boundary), f32 at 2e-5 and
      bf16 within one bf16 ulp (2**-7); sharp scores on which fp32 q and
      P would miss that by 4x; two calls bit-equal; times the kernel
      (warm back to back and on the device, and cold) and the plain
      version at each serving shape beside the bound (no single PyTorch
      call computes this function);
   e. the flash-attention backward (bf16 ``fa_bwd_dq_mma`` then
      ``fa_bwd_dkdv_mma`` on the tensor cores, fp32 the SIMT ``fa_bwd_dq``
      then ``fa_bwd_dkdv``; the instantiation each call ran is checked)
      against ``flash_attention_bwd_plain`` on the forward's own output
      and row log-sum-exp, over the forward's sweep (windows, the decode
      offset, fully masked rows, T != S, S and T off the tile heights,
      MQA and GQA, D 64/80/128 with query groups of 1, 2 and 3),
      whisper's training encoder rows (2, 1500, 20, 20, 64, no mask),
      llava's prefix at 8/2 heads, and olmoe-1b-7b's and smollm-135m's
      training shapes, f32 at 1e-4 and
      bf16 at 2e-2, bf16
      also against ``flash_attention_bwd_mma_plain`` (the kernels'
      rounding) at 1e-2, each case called twice and held bit-equal, the
      forward's lse held to the plain one and the serving forward's bits
      to the lse-writing forward's; times the backward, the SIMT kernels
      on the same bf16 inputs (the first design, as the yardstick), its
      plain version, the forward and backward through autograd, and
      SDPA's forward alone and forward and backward through autograd (a
      yardstick only; its backward alone is the difference of the two
      device times) at smollm's training shape (2, 256, 9, 3, 64), its
      serving shape, olmoe's training shape (4, 256, 16, 16, 128) and
      whisper's training encoder (2, 1500, 20, 20, 64, no mask), beside
      the backward's bound; the tensor-core
      kernels must not spill at D = 64 (ptxas, [1]);
   f. the SSD chunk backward (bf16: the tensor-core ``ssd_chunk_bwd_mma``,
      one launch; fp32: the SIMT ``ssd_chunk_bwd`` then
      ``ssd_chunk_bwd_reduce``; the kernel each call ran is checked)
      against ``ssd_chunk_bwd_plain`` on the forward kernel's ``cum``
      with random fp32 cotangents of all three forward outputs, over the
      reference's SSD shapes, Q=100, Q=7 with N below one staged slice,
      and the two training shapes (mamba2-130m's (2, 256, 24, 64, 128,
      128) a rank, zamba2-2.7b's heads (2, 256, 80, 64, 64, 128)), f32 at
      5e-5 and bf16 at 5e-2 of each gradient leaf's largest entry, bf16
      also against ``ssd_chunk_bwd_mma_plain`` (the kernel's rounding) at
      1e-2 and that rounding's own error against the plain version
      printed, each call counted and repeated bit-equal; at both training
      shapes (bf16, dy a transposed view as training hands it over), in
      turns, times the kernel, the first design's SIMT pair on the same
      inputs (``simt=True``, with its copy of dy and its three casts) and
      the plain version, back to back and on the device, beside the bound
      (no single PyTorch call computes this function) and the host's time
      to issue a call;
      logs the kernel's shared memory, registers, spills, blocks an SM
      and clusters at once; fails unless the kernel is faster on the
      device than the SIMT pair;
3. the kernels inside the models, fp32: full-width smollm-135m prefill
   logits with ``attn_impl="auto"`` (kernel) vs ``"ref"``;
   full-width, full-depth mamba2-130m and zamba2-2.7b prefill logits
   with ``ssd_impl``/``attn_impl="auto"`` (kernels) vs ``"xla"``/``"ref"``
   (the plain chunked SSD oracle, plain attention), with both launch
   counts read from the kernel prefill; olmoe-1b-7b at full width and
   depth: prefill logits through the flash kernel vs plain attention,
   then the continuous engine decoding through the paged kernel vs the
   engine decoding through the gather path, the same requests on a
   simulated clock: tokens equal and logits within 1e-3 over fp32
   pools, tokens equal over the serving dtype's bf16 pools (their logit
   difference printed beside PR 14's 0.271 and beside the gather path
   run twice; above 0.05 the first decode layer whose MoE input or
   output departs is traced and printed), the launches one per layer per
   decode step; whisper-large-v3 at full width and depth: the prefill of
   2 x 64 tokens over 2 x 1500 frames through the flash kernel (the
   encoder's non-causal self-attention, the decoder's causal one) vs
   plain attention, logits within 1e-3, 64 launches (cross-attention is
   plain in both, as the reference's); [3v] llava-next-mistral-7b at
   full width and depth: ``vlm.prefill`` over 2880 patches and 128
   tokens, kernel vs plain, logits within 1e-3, 32 launches; [3t] the
   training loss and every leaf's gradient of mamba2-130m at full width
   and depth, of zamba2-2.7b at full width and 6 mamba layers (one
   group, one shared-attention application), 2 x 256 tokens, of
   whisper-large-v3 at full width and 2 + 2 layers (2 x 64 tokens over
   2 x 1500 frames) and of llava-next-mistral-7b at full width and 2
   layers (1 x (2880 patches + 128 tokens)), fp32, one process:
   ``ssd_impl``/``attn_impl="auto"`` (SSD forward and backward kernels,
   flash forward and backward) against ``"xla"``/``"ref"`` under
   autograd, the loss within 1e-5 and each leaf within 1e-3 (relative
   2-norm), the launches of the kernels' call held to one SSD forward
   and ``LAUNCHES_PER_CALL`` (fp32) backward launches a layer, one flash
   forward and backward a shared application or self-attention layer;
4. serving through ``repro_torch.launch.serve`` at full width, bf16, each
   path with every launch count zeroed just before it and read just
   after: smollm-135m, mamba2-130m, zamba2-2.7b (full depth: 54 SSM
   layers, 9 shared-attention applications), olmoe-1b-7b (full
   depth: 16 layers of 64 experts), whisper-large-v3 (full depth: 32
   encoder and 32 decoder layers; fixed 4 x 64-token prompts over 1500
   frames each, 32 new; continuous 8 requests at 20 req/s, 32 new, 4
   slots; cross-attention plain, its KV per slot as the engine's opaque
   state) and llava-next-mistral-7b (full depth: 32 layers, 7.24B fp32
   parameters; fixed 2 x 512, 16 new; continuous as zamba2's), each in
   the fixed-batch and the continuous mode; the counts must be one flash
   or SSD launch per layer (whisper: per encoder and decoder layer) for
   every prefill, one paged-attention launch per attention layer for
   every decode step of a continuous path (none on a fixed path), and
   zero for a kernel off the path;
   t. tensor-parallel decode: smollm-135m served by ``--tensor-parallel
   4 --tuning-table examples/artifacts/tuned_decision.json`` (4 ranks on
   the card, each step's logits reassembled through the tuned
   collective), fixed batch through ``all_gather`` and ``all_reduce``,
   continuous through ``all_gather``, each held to [4]'s one-process run
   of the same argv: tokens equal, the fixed loop's last logits
   bit-equal, every rank's equal rank 0's, the executed collective the
   printed one, launches summed over the ranks (flash per prefill layer
   a rank, paged per attention layer a decode step a rank, the
   ``all_reduce`` plan's combines a step a rank); per-token p50/p99
   beside the one-process run's;
5. where the time goes: torch.profiler over one full-width prefill and
   over decode steps of each model, dense and, where the model has a KV
   cache, through the paged kernel (device busy share, top kernels, and
   the port's own kernels wherever they rank);
6. tuned collectives through ``repro_torch.launch.measure_collectives``
   at 4 ranks on the card (processes under a gloo group, payloads staged
   through the host, every reduce step in the segment-combine kernel):
   every algorithm and synthesized program held against the oracle at
   4 MB and an odd size; every (algorithm, segments) candidate of
   all_reduce and broadcast timed at 4 KB, 256 KB, 4 MB and 64 MB over
   one trial (a second and a third were cut for the script's time), the
   exhaustive
   tuner's table printed, saved and loaded back,
   with the launch counts gathered from the ranks (zeroed just before the
   tuning run, read just after: every reducing algorithm launches the
   kernel exactly as its schedule says); then a gradient of
   smollm-135m's parameter count (one fp32 leaf) synced through the
   Communicator built from the table just tuned, on a ``("data",)``
   mesh, and through ``"xla"`` (gloo's all-reduce), each held against
   the float64 oracle mean and timed, with its launches held to its
   plan's;
   b. every tuner family of ``core.tuning.TUNERS``
   (``measure_collectives --tuners all``, 4 ranks, [6]'s ops, its sizes
   up to 4 MB, one trial: 64 MB and a second and third trial were cut
   for the script's time) fitted over one measured session: per family its new
   experiments, cache hits, empirical penalty, seconds and
   ``segment_combine``
   launches (zeroed just before its fit, read just after, summed over
   the ranks): a family that only refits the cache launches nothing,
   and every family's launches (STAR's and feedback's fresh samples)
   equal what its runs' schedules imply; every rank ends with the same
   table for every family;
7. the tuned Communicator over smollm-135m's fp32 gradient tree at full
   width cut to 5 of its 30 layers (``COMM_GRAD_LAYERS``, cut for the
   script's time, from 10; the port's per-layer layout, leaves
   drawn from a seed), through ``measure_collectives --grad-arch
   smollm-135m --grad-layers 5``: (a) a 2x2
   ``("pod", "data")`` mesh of 4 ranks with
   ``examples/artifacts/hierarchical_decision.json``, per leaf, the
   sync tiers probed first; (b) a 2x2x2 ``("dcn", "pod", "data")`` mesh
   of 8 ranks with ``hierarchical_decision_3level.json``, per leaf and
   bucketed and pipelined at the artifact's own 8 MB schedule; (c)
   ``"xla"`` on both meshes. Each variant is held against the float64
   oracle mean at 2e-4, its ``explain_gradients`` against the spans a
   `TraceRecorder` recorded, and its ``segment_combine`` launches
   (zeroed just before it, read just after, summed over the ranks)
   against what its plan's reduce phases imply; the bucketed result is
   held to each bucket's own sequential composition bit for bit and to
   the per-leaf result at 2e-4; every variant is timed (one run after
   its traced run, ``measure_collectives.GRAD_TRIALS``, as [6]'s
   gradient: the second was cut for the enc-dec and VLM phases); (d)
   [7b]'s tree and artifact with a tuned mesh mapping stamped into every level's
   meta (the first non-identity candidate of ``enumerate_mappings`` on
   2x2x2, written to a temporary file): the Communicator rebuilds the
   mesh in the mapping's rank order, every rank is checked at its
   ``device_order`` slot and ``describe()`` names the mapping; each
   variant checked as in (b), the bucketed one timed beside (b)'s; then
   ``tune_topology(2x2x2, tune_mapping=True)`` on the simulator and its
   winner's summary;
   t. the rank transport: in one spawned group of 4 ranks on the card,
   every collective of ``core/collectives/group.py`` (``ppermute`` with
   a rank that is no destination and an (i, i) pair, with no crossing
   pair and as a shift; ``all_gather``, ``all_to_all``, ``pmax``,
   ``psum``, ``reduce_scatter``) on CUDA tensors, through the axes'
   CUDA IPC arenas, against the same collective over gloo on CPU copies
   of the same inputs, fp32 and bf16, over the data and model axes of a
   2 x 2 mesh, the data axis of a remapped one and the remapped default
   group: copies bit-equal, sums within ``TRANSPORT_SUM_TOL`` (reduction
   order), each psum the same bits on every rank; the data arena grown
   in lockstep past its first slot up to its largest, and a 96 MB psum
   across it in two rounds; then the 64 MB fp32 all-reduce over
   the 4 ranks, ring in 2 segments and the built-in sum, timed (the
   slowest rank's, beside the card's name and power limit);
8. training: ``repro_torch.launch.train --arch smollm-135m --ranks 4
   --topology 2x2 --tuning-table examples/artifacts/
   hierarchical_decision.json --steps 2 --seq 256 --batch 8`` (full
   width and depth, fp32 master weights, bf16 compute, 4 ranks on the
   card), then the same with ``--collective xla`` as the
   oracle: each step's loss and its split into forward+backward,
   gradient sync and optimizer seconds, each rank's peak memory; the
   replicas' params bit-equal after every step; the launches (zeroed in
   every rank just before the steps, summed over the ranks just after)
   held to 30 flash forwards and 30 x ``attention_bwd.LAUNCHES_PER_CALL``
   backward launches a rank-step
   and, tuned, the plan's 2,184 combines a step (none through xla); the
   tuned run held to the xla run: step 0's synced gradients leaf by
   leaf (relative 2-norm; rank 0's gradients before the sync bit-equal
   in both runs, so only the order of the sum differs), the params'
   change over the run (relative 2-norm over the tree) and the losses;
   each reading also taken of faults planted in the tuned run's trees
   (gradients zeroed, negated, summed and not averaged, shifted between
   same-shaped leaves, half a leaf dropped; the update lost, reversed),
   each of which must exceed its tolerance;
   c. the tuned run again with ``--overlap-backward --trace-dir`` (each
   layer's gradients synced on a thread of every rank, on its own CUDA
   stream, while the backward computes the layers below), its launches
   zeroed just before the steps and read just after: rank 0's step-0
   gradients before any sync bit-equal to the tuned run's (each
   release's cotangent checksummed in the sink before its sync, the
   residual before its sync), step 0's synced gradients within
   ``TRAIN_GRAD_TOL``, the losses within ``TRAIN_LOSS_TOL``, the
   combines 3 x ``explain_gradients(overlap_backward=True)``'s plan,
   the flash launches the tuned run's, the releases in order 29...0 in
   every rank and step, each step's trace and summary written, parsed
   and holding one span a plan entry; each step's compute / exposed sync
   / optimizer seconds printed beside the tuned run's;
   s. [8]'s runs and checks for ``--arch mamba2-130m`` at full width (d
   768, 24 SSD heads of 64, N 128, vocab 50280) cut to 6 of its 24
   layers for the script's time (from 12; ``config={"num_layers":
   6}``: 100,056,240 fp32 params, 57 leaves), tuned and ``"xla"``: the
   launches held to 6 SSD forwards and 6 x
   ``ssd_scan_bwd.LAUNCHES_PER_CALL`` (bf16: one) backward launches a
   rank-step, no flash, and the tuned plan's combines every step;
   sc. [8s]'s tuned run with ``--overlap-backward --trace-dir``, held to
   it as [8c] is held to [8] (the SSD launches its, releases 11...0);
   m. MoE expert parallelism: ``--arch olmoe-1b-7b --ranks 4
   --model-parallel 2 --steps 2 --seq 256 --batch 8`` at full width, cut
   to 1 of its 16 layers (``train.main(..., config={"num_layers": 1})``;
   2 before the script's time took [8t]'s; 32 of the 64 experts a
   rank), tuned (``tuned_decision.json``) and ``"xla"``,
   held to each other as [8] (the replicas: non-expert params on every
   rank, each expert slice on its two data ranks; the launches: the
   flash kernels a layer a rank-step and the plan's combines), the
   dispatch all-to-all the table resolved printed, and the three faults
   of ``steps.planted_ep_fault`` (expert gradients left undivided by tp,
   replicated gradients not averaged over ``model``, the reverse
   exchange replaced by identity), each planted in a 2-rank tuned step
   of one layer, its synced step-0 gradients read against the correct
   step's: each must exceed ``TRAIN_GRAD_TOL``;
   mc. [8m]'s tuned run with ``--overlap-backward``, two steps: each
   released layer synced over ``data`` on the sync thread (its own CUDA
   stream) while the backward's model-axis collectives run on the main
   thread, as the launcher prints; held to [8m]'s tuned run (step 0's
   synced gradients within ``TRAIN_GRAD_TOL``, losses within
   ``TRAIN_LOSS_TOL``, rank 0's gradients before the sync bit-equal,
   releases 0 in every rank and step, the thread busy in every step);
   every process's host memory available, resident memory and CUDA
   memory logged once a second while it runs (``memory_log``) and
   printed;
   w. [8]'s runs and checks for ``--arch whisper-large-v3`` at full width
   cut to 2 encoder and 2 decoder layers (``config={"num_layers": 2,
   "encoder_layers": 2}``: 231,980,800 params, 59 leaves, a 0.93 GB
   fp32 gradient a step; full depth takes 25.7 GB a rank of params,
   gradients and Adam moments, so four ranks do not fit one card), tuned
   and ``"xla"``: 4 flash forwards (the encoder's over 1500 frames, no
   mask) and their backwards a rank-step, the tuned plan's combines, the
   tuned run held to the xla run and the planted faults read, no
   overlapped run;
   f. FSDP (``train.main(..., parallel=ParallelConfig(
   shard_params_over_data=True))``; each rank holds a quarter of every
   weight the 2 x 2 data axes divide, gathers each layer's in one
   all-gather where it enters the model and reduce-scatters its
   gradient in the backward): [8w]'s ``"xla"`` run again under FSDP
   (63,389,440 params a rank, 34 leaves sharded and 25 replicated),
   held to [8w]'s ``"xla"`` run (the same start, step 0's loss
   bit-equal, its synced gradients gathered whole within
   ``TRAIN_GRAD_TOL``, the params' change within ``TRAIN_CHANGE_TOL``,
   the losses within ``TRAIN_LOSS_TOL``), then whisper-large-v3 at full
   width, 8 + 8 layers (cut from 32 + 32, which [8ft] trains; 132,279,040
   params a rank, 130 leaves sharded and 85 replicated), one step over
   4 x 256 tokens with bf16 gathers (``gather_in_compute_dtype``): each
   run's launches (the flash kernels a layer a rank-step: 4 and 16
   layers), its gathers and reduce-scatters (one a layer and one for
   the rest of the tree), the replicated leaves bit-equal, a finite
   loss; the deeper run's peak memory a rank and its seconds in gathers
   and reduce-scatters printed;
   ft. FSDP with the model axis (right after [8m], whose ``"xla"`` run
   is [8mf]'s oracle): whisper-large-v3 on ``("data", "model")`` = 2 x
   2 under FSDP + tensor parallelism (each rank its tensor-parallel
   slice cut to its FSDP shard; 63,389,440 params a rank at 2 + 2
   layers, 34 leaves cut by both halves and 25 whole), (a) 2 + 2 layers
   at fp32 compute, 2 steps, held to the same run without FSDP on the
   same mesh (the same start, step 0's loss bit-equal, its synced
   gradients gathered whole within ``SELF_TOL`` of each leaf's scale,
   the params' change within ``TRAIN_CHANGE_TOL``), (b) full depth
   (32 + 32 layers, 407,837,440 params a rank), one step over 2 x 256
   tokens with bf16 gathers; [8mf] olmoe-1b-7b as [8m]'s ``"xla"`` run
   under FSDP + expert parallelism (expert stacks (32, 1024, 1024) a
   rank, 212,408,320 params a rank), held to it as (a) is to its run
   without FSDP but with ``TRAIN_GRAD_TOL``. Each run's launches (flash
   a layer a rank-step), its gathers and reduce-scatters, its leaves by
   the halves that cut them, model-axis collectives, the replicas; each
   step's fwd+bwd / gathers / reduce-scatters / model-axis collectives
   / sync / AdamW seconds and the peak memory a rank printed;
   t. tensor parallelism: ``--arch smollm-135m --ranks 4
   --model-parallel 2 --seq 256 --batch 8`` at full width and depth
   (``{"data": 2, "model": 2}``; 94,701,888 params a rank: the FFN
   columns and the vocab split, the attention whole on every rank since
   9 heads do not divide 2), tuned (``tuned_decision.json``, 2 steps)
   and ``"xla"`` (1 step), their launches zeroed just before the steps
   and read just after (30 flash forwards and their backwards a
   rank-step, the plan's combines); the replicated leaves bit-equal on
   all 4 ranks and each slice on its 2 data ranks after every step;
   tuned held to ``"xla"`` as [8] (step 0's synced gradients, rank 0's
   slices, within ``TRAIN_GRAD_TOL``, the losses within
   ``TRAIN_LOSS_TOL``), both runs' step-0 loss to [8]'s ``"xla"`` step
   0 (the same global batch and initial params, no model axis) within
   ``TRAIN_LOSS_TOL``, their gathered gradients' reading against it
   printed (bf16 sets two data partitions ~2e-2 apart already); then,
   in one spawned group at fp32 compute and full width, cut to
   ``TP_FP32_LAYERS`` layers, the split step's synced gradients gathered
   over ``model`` against the unsplit step's (4 x 1, [8]'s layout)
   within ``TP_GRAD_TOL`` a leaf, and the fault of
   ``steps.planted_tp_fault`` that the card's layout runs
   (``copy_not_summed``) at least 10 x ``TP_GRAD_TOL``;
   tc. [8t]'s tuned run again with ``--overlap-backward``, 2 steps: each
   released layer synced over ``data`` on the sync thread while the
   blocks' model-axis all-reduces run on the main thread, held to [8t]'s
   tuned run as [8mc] to [8m]'s (releases 29...0), under the memory log;
9. compile-free accounting: the dry-run's trace of [8ft] (b) and [8mf]
   on a recording 2 x 2 mesh held to their steps on the card, and two
   ``launch.dryrun`` subprocesses;
10. the examples' counterparts (``repro_torch.examples``): (a)
   ``train_e2e`` with the real smollm-135m config (30 layers, d 576,
   162,826,560 fp32 params), seq 128, batch 4, ``E2E_STEPS`` steps,
   checkpointed in the reference's layout after half of them into a
   temporary directory, restored and resumed, then the same steps
   straight through in the same process: the losses and final params
   bit-equal, the manifest's keys and shapes the reference's
   (``E2E_MANIFEST``), one flash forward and LAUNCHES_PER_CALL backward
   launches a layer a step over both runs (counts zeroed just before,
   read just after); (b) ``serve_decode`` (reduced smollm, windows 0 and
   16), tok/s printed; (c) ``quickstart`` on the reference's mesh, data
   4 x model 2 (8 ranks), ``QUICKSTART_STEPS`` steps under each of
   ``xla``, ``ring`` and ``rabenseifner``: the losses within
   ``TRAIN_LOSS_TOL`` of the ``xla`` run's, the flash launches a layer a
   rank-step and the plan's combines every step (none under ``xla``);
11. each measure of the transport (the 64 MB all-reduce, [8]'s and
   [8t]'s tuned sync, [8ft] (b)'s sync and step) printed beside the
   host-staged transport's (``HOST_STAGED``, measured by
   ``tools/transport_ab.py``), with the card's name and power limit;
   the kernels line, then ``{"ok": true, "device": ...}`` as the last
   line.

Exits nonzero, with no result line, when there is no CUDA device, when
the port is not beside this file, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the paged kernel rounds where the gather path does: fp32 summation order
# only, so within one bf16 ulp at bf16 (tests/test_torch_cuda.py)
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
BF16_LOGIT_DIFF_PR14 = 0.271     # olmoe's engine over bf16 pools, PR 14
L2_FLUSH_BYTES = 1 << 30         # written before each cold call (L2: 50 MB)
SSD_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}   # tests/test_kernels.py
# the bf16 SSD backward against ssd_chunk_bwd_mma_plain, which rounds where
# the kernel does (tests/test_torch_cuda.py): fp32 summation order, which
# now and then moves a rounded score or dG by one ulp, and one bf16 ulp of
# dx, dB and dC
SSD_BWD_MMA_TOL = 1e-2
MODEL_TOL = 1e-3                 # phase 3: 24-54 layers of the kernel tolerance
COMBINE_TOL = 1e-6               # tests/test_kernels.py (expected bit-equal)
# the flash backward against its plain version (tests/test_torch_cuda.py):
# f32 sums up to S x H/KV terms per dK/dV entry in another order; bf16
# computes in fp32 from the same bf16 inputs and rounds once, as the
# forward (the forward's bf16 tolerance)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 against flash_attention_bwd_mma_plain, which rounds P and dS where
# the kernels do: fp32 summation order, which now and then moves a
# rounded P or dS by one ulp, and one bf16 ulp of the output (2**-7)
BWD_MMA_TOL = 1e-2
# smollm-135m's training attention: 2 rows a rank of the 8 x 256 batch
TRAIN_ATTN_SHAPE = (2, 256, 9, 3, 64)
# olmoe-1b-7b's ([8m]): 4 rows a rank of the 8 x 256 batch on 2 x 2
# ("data", "model"), 16/16 heads of 128
OLMOE_TRAIN_ATTN_SHAPE = (4, 256, 16, 16, 128)
COMBINE_N = 1 << 24              # 16M elements: 64 MB of fp32 per operand
RANKS = 4                        # processes on the card for the collectives
# the tuning sessions' depth: [6] at every size, [6b] (which measures the
# same grid again for every tuner family) up to 4 MB; the 64 MB points
# and a third trial took ~110 s of the script's 1200 on a slow host, and
# the second trial was cut for the enc-dec and VLM phases
TUNE_TRIALS = 1
TUNER_SIZES = (4096, 262144, 4194304)
SERVE_SHAPE = dict(B=8, S=512, H=9, KV=3, D=64)
# the prefill attention calls of the serving paths, (B, S, H, KV, D[,
# causal]), bf16: whisper's encoder over the fixed path's 4 x 1500 frames
# (non-causal), llava's 2880 patches and 128 tokens (GQA 4)
ATTN_TIMED_SHAPES = {
    "smollm serving": (8, 512, 9, 3, 64),
    "olmoe prefill": (4, 512, 16, 16, 128),
    "zamba2 prefill": (4, 512, 32, 32, 80),
    "smollm one request": (1, 512, 9, 3, 64),
    "whisper encoder": (4, 1500, 20, 20, 64, False),
    "llava patch prefix": (1, 3008, 32, 8, 128),
}
# whisper-large-v3's training encoder attention ([8w]): 2 rows a rank of
# the 8-row batch, 1500 frames, 20 heads of 64, no mask
WHISPER_TRAIN_ATTN_SHAPE = (2, 1500, 20, 20, 64, False)
# llava-next-mistral-7b's prefix: 2880 patches and 128 tokens
LLAVA_PREFIX = 2880 + 128
# mamba2-130m's SSD call at the fixed-batch serving shape (8 x 512 prompts)
SSD_SERVE_SHAPE = dict(B=8, S=512, H=24, P=64, N=128, Q=128)
# and at the continuous path's one-request prefills
SSD_ONE_REQUEST_S = (128, 256, 512)
# the paged decode attention at each continuous path's shape: requests
# (slots), query heads, KV heads, head dim, block size, view length
PAGED_SERVE_SHAPES = {
    "smollm-135m": dict(R=8, H=9, KV=3, D=64, bs=16, T=576),
    "zamba2-2.7b": dict(R=4, H=32, KV=32, D=80, bs=16, T=528),
    "olmoe-1b-7b": dict(R=4, H=16, KV=16, D=128, bs=16, T=528),
    "whisper-large-v3": dict(R=4, H=20, KV=20, D=64, bs=16, T=96),
    "llava-next-mistral-7b": dict(R=4, H=32, KV=8, D=128, bs=16, T=528),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_calls(fn, reps: int = 20, runs: int = 5, warmup: int = 3) -> list:
    """Device time (ms per call) of each of ``runs`` runs of ``reps``
    back-to-back calls, one pair of CUDA events around each run, after
    ``warmup`` calls: the host's launch work overlaps the device's as it
    does on the serving path. The inputs are warm in the 50 MB L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def device_ms(fn, reps: int = 20) -> float:
    """Device time (ms per call) of the kernels ``fn`` launches, from
    torch.profiler's CUDA events over ``reps`` calls after a warm-up:
    the kernels alone, without the host's launch work between them,
    which the back-to-back timing of ``time_calls`` (every kernel's
    ``ms``) counts where the host is slower than the device. Every
    kernel's ``device_ms`` comes from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without its device events: take
    # the next one, and fail rather than report a time of 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if len(kernels) >= reps:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    # and in some processes every trace lacks one event (19 over 20 calls
    # in five traces in a row): the mean of the events seen, times the
    # events a call, where at most one call's worth is missing
    n = len(kernels)
    per_call = round(n / reps)
    if per_call >= 1 and n >= per_call * (reps - 1):
        return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n * \
            per_call
    raise AssertionError(f"the profiler saw {n} device events over {reps} "
                         f"calls")


def host_ms(fn, reps: int = 20) -> float:
    """Host time (ms per call) to issue ``fn`` back to back, without
    waiting for the device: where it exceeds the device time, the
    back-to-back timing measures the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def cold_ms(fn, reps: int = 20) -> float:
    """Device time (ms per call, median of ``reps``) of ``fn`` with the L2
    cold: before each call a 1 GiB write evicts the 50 MB L2, then CUDA
    events around the call alone. The write takes longer on the device
    than the host takes to queue the call behind it, so the events time
    the device, not the host."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def attention_bound_ms(B, S, T, H, KV, D, itemsize, causal=True):
    """Least time for the call: each input read once and the output
    written once over the memory rate, or the QK and PV products of the
    visible (query, key) pairs over the peak rate of the input type."""
    nbytes = itemsize * (2 * B * S * H * D + 2 * B * T * KV * D)
    pairs = B * H * (S * (S + 1) // 2 if causal and S == T else S * T)
    flops = 4 * D * pairs
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def rand_qkv(B, S, T, H, KV, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, D), mk(B, T, KV, D), mk(B, T, KV, D)


# ---------------------------------------------------------------------------
# the host-memory log of the overlapped runs ([8mc], [8tc])
# ---------------------------------------------------------------------------
#: while set, it names the directory every process of the script (the
#: launcher, and each rank, which imports this file as ``__mp_main__``)
#: appends one line a second to, ``mem.<pid>.log``
MEMLOG_ENV = "CHIP_SMOKE_MEMLOG"


def _meminfo_kib(key: str, path: str = "/proc/meminfo") -> int:
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return -1


def watch_memory(role: str) -> None:
    """A daemon thread of this process: while ``MEMLOG_ENV`` is set, one
    line a second with its role, the host's available memory and this
    process's resident memory (``/proc``), and in a rank its CUDA memory
    allocated and reserved."""
    def run():
        while True:
            d = os.environ.get(MEMLOG_ENV)
            if d and os.path.isdir(d):
                cuda = ""
                if role == "rank" and torch.cuda.is_initialized():
                    cuda = (f" cuda_alloc_mib "
                            f"{torch.cuda.memory_allocated() >> 20} "
                            f"cuda_reserved_mib "
                            f"{torch.cuda.memory_reserved() >> 20}")
                with open(os.path.join(d, f"mem.{os.getpid()}.log"),
                          "a") as f:
                    f.write(f"{time.time():.1f} {role} host_avail_mib "
                            f"{_meminfo_kib('MemAvailable') >> 10} rss_mib "
                            f"{_meminfo_kib('VmRSS', '/proc/self/status') >> 10}"
                            f"{cuda}\n")
            time.sleep(1.0)
    threading.Thread(target=run, daemon=True).start()


@contextlib.contextmanager
def memory_log(tag: str):
    """Log every process's memory once a second for the block, then print
    each process's samples, the least host memory available, its largest
    resident and CUDA reserved memory, and its first and last line."""
    d = tempfile.mkdtemp(prefix="chip_smoke_mem_")
    os.environ[MEMLOG_ENV] = d
    try:
        yield
    finally:
        del os.environ[MEMLOG_ENV]
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name)) as f:
                lines = [ln.split() for ln in f if ln.strip()]
            if not lines:
                continue

            def most(key, pick):
                vals = [int(ln[ln.index(key) + 1]) for ln in lines
                        if key in ln]
                return pick(vals) if vals else None
            log(f"    [{tag}] memory {name[4:-4]} ({lines[0][1]}): "
                f"{len(lines)} samples a second, host available min "
                f"{most('host_avail_mib', min)} MiB, rss max "
                f"{most('rss_mib', max)} MiB, cuda reserved max "
                f"{most('cuda_reserved_mib', max)} MiB; first "
                f"{' '.join(lines[0][2:])}; last {' '.join(lines[-1][2:])}")
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__mp_main__":       # a rank of a group this script spawned
    watch_memory("rank")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"    built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
        f"-> {_build.build_dir()}")
    for name in libs:
        logf = _build.build_dir() / f"{name}.log"
        if logf.exists():
            for fn, props in ptxas_report(logf.read_text()):
                log(f"    ptxas {name}: {fn}: {props}")
                # the tensor-core backward at D = 64 (the training path's)
                if "fa_bwd_" in fn and ("_mma<64>" in fn or
                                        "_mmaILi64E" in fn) \
                        and "0 bytes spill stores" not in props:
                    raise AssertionError(f"{fn} spills: {props}")
    return smi


def ptxas_report(text):
    """(kernel, 'N registers, S bytes smem, spills') for every entry
    function in nvcc's ``-Xptxas -v`` output, names demangled where
    ``c++filt`` is on the path (dynamic shared memory is not in it: the
    wrappers size that at launch)."""
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line and fn:
            spill = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line and fn:
            used = line.split("Used", 1)[1].strip()
            out.append((fn, f"{used}; {spill}"))
            fn, spill = None, ""
    names = [fn for fn, _ in out]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    if len(names) != len(out):
        names = [fn for fn, _ in out]
    return [(n, props) for n, (_, props) in zip(names, out)]


def kernel_for(dtype, D):
    """The instantiation the wrapper must launch for ``dtype``: bf16 on
    the tensor cores, fp32 on the SIMT kernel."""
    return (f"fa_fwd_mma<bf16,{D}>" if dtype == torch.bfloat16
            else f"fa_fwd<f32,{D}>")


def phase_kernel():
    from repro_torch.kernels import attention as fa
    sweep = [((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 4, 2, 64), {}),
             ((1, 128, 128, 4, 1, 128), {}), ((1, 96, 96, 2, 2, 80), {})]
    both = (torch.float32, torch.bfloat16)
    cases = [(shape, dt, kw) for shape, kw in sweep for dt in both]
    cases += [((1, 256, 256, 2, 2, 64), dt, {"window": w})
              for w in (1, 17, 64, 256) for dt in both]
    cases += [((2, 1, 200, 4, 2, 64), dt, {"q_offset": 199}) for dt in both]
    # bf16 edges of the tensor-core kernel: fully masked rows before
    # position 0; rows fully masked by the window (q_offset past T: whole
    # warps of them); S not a multiple of 64 with T > S and q_offset; MQA
    # at S = 200; no causal mask over a ragged T; head dims 80 and 128
    # with windows
    cases += [((1, 40, 40, 2, 1, 64), dt, {"q_offset": -5}) for dt in both]
    cases += [((1, 64, 64, 2, 1, 64), torch.bfloat16,
               {"window": 16, "q_offset": 50}),
              ((1, 96, 300, 4, 2, 64), torch.bfloat16, {"q_offset": 204}),
              ((2, 200, 200, 4, 1, 64), torch.bfloat16, {}),
              ((2, 70, 300, 3, 1, 64), torch.bfloat16, {"causal": False}),
              ((1, 200, 200, 4, 2, 80), torch.bfloat16, {"window": 17}),
              ((1, 200, 264, 2, 1, 128), torch.bfloat16,
               {"window": 64, "q_offset": 64})]
    # zamba2's shared attention: fixed batch (4 x 512) and the continuous
    # mode's one-request prefills (128 and 512)
    cases += [((4, 512, 512, 32, 32, 80), torch.bfloat16, {}),
              ((1, 128, 128, 32, 32, 80), torch.bfloat16, {}),
              ((1, 512, 512, 32, 32, 80), torch.bfloat16, {})]
    # whisper's encoder (4 x 1500 frames, 20 heads of 64, no mask) and
    # llava's prefix (2880 patches + 128 tokens, 32/8 heads of 128)
    cases += [((4, 1500, 1500, 20, 20, 64), dt, {"causal": False})
              for dt in both]
    cases += [((1, LLAVA_PREFIX, LLAVA_PREFIX, 32, 8, 128), dt, {})
              for dt in both]
    s = SERVE_SHAPE
    serve_case = ((s["B"], s["S"], s["S"], s["H"], s["KV"], s["D"]),
                  torch.bfloat16, {})
    cases.append(serve_case)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, ((B, S, T, H, KV, D), dt, kw) in enumerate(cases):
        q, k, v = rand_qkv(B, S, T, H, KV, D, dt, seed=i)
        kw = {"causal": True, **kw}
        err = check_attention(fa, q, k, v, dt, kw)
        max_err[dt] = max(max_err[dt], err)
        log(f"[2] {(B, S, T, H, KV, D)} {str(dt)[6:]} {kw}: "
            f"{fa.last_kernel()}, max|err| {err:.3g}")
    serve_err = err      # the serving shape is the last case
    # q, k and v as strided views of one fused projection, both dtypes
    for dt in both:
        g = torch.Generator(device="cuda").manual_seed(5)
        qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=g,
                          device="cuda").to(dt)
        q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
        err = check_attention(fa, q, k, v, dt, {"causal": True})
        max_err[dt] = max(max_err[dt], err)
        log(f"[2] fused qkv views (2, 96, 96, 4, 2, 64) {str(dt)[6:]}: "
            f"{fa.last_kernel()}, max|err| {err:.3g}")
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 2e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 2e-2)")

    by_shape = {name: time_attention(fa, name, shape)
                for name, shape in ATTN_TIMED_SHAPES.items()}
    top = by_shape["smollm serving"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention.py:132",
            "max_abs_err": serve_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "device_ms": top["device_ms"],
            "library_device_ms": top["library_device_ms"],
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={s['B']} S={s['S']} H={s['H']} KV={s['KV']} "
                     f"D={s['D']} bf16 causal",
            "by_shape": by_shape}


def check_attention(fa, q, k, v, dt, kw):
    """One launch against ``flash_attention_plain``: counted once, the
    dtype's kernel, finite and within the dtype's tolerance; returns the
    max error."""
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if fa.launches != before + 1:
        raise AssertionError("the wrapper did not count its launch")
    D = q.shape[-1]
    if fa.last_kernel() != kernel_for(dt, D):
        raise AssertionError(f"{dt} D={D} ran {fa.last_kernel()}, expected "
                             f"{kernel_for(dt, D)}")
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    bad = (got.float() - want.float()).abs() > \
        TOL[dt] * (1 + want.float().abs())
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"flash_attention disagrees with plain at "
                             f"{tuple(q.shape)} k {tuple(k.shape)} {dt} "
                             f"{kw}: max err {err}")
    return err


def time_attention(fa, name, shape):
    """Kernel, plain version and SDPA (a yardstick only: the port never
    calls it) in turns at one bf16 causal shape, beside the bound: back
    to back between CUDA events (``ms``, ``plain_ms``, ``library_ms``,
    which count the host's launch work where it is slower than the
    device), on the device alone from the profiler (``device_ms``,
    ``library_device_ms``), and the host's time to issue one call."""
    import torch.nn.functional as F
    B, S, H, KV, D, causal = (*shape, True)[:6]
    q, k, v = rand_qkv(B, S, S, H, KV, D, torch.bfloat16, seed=99)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(  # noqa: E731
        q, k, v, causal=causal)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=KV != H)
    # in turns (kernel, plain, library, kernel, plain, library): one card
    k1, p1, l1 = time_calls(kern), time_calls(plain), time_calls(lib)
    dk1, dl1 = device_ms(kern), device_ms(lib)
    k2, p2, l2 = time_calls(kern), time_calls(plain), time_calls(lib)
    dk2, dl2 = device_ms(kern), device_ms(lib)
    ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
    library_ms = statistics.median(l1 + l2)
    dev, library_dev = (dk1 + dk2) / 2, (dl1 + dl2) / 2
    host, library_host = host_ms(kern), host_ms(lib)
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(
        B, S, S, H, KV, D, 2, causal=causal)
    mask = "causal" if causal else "no mask"
    log(f"    {name} B={B} S={S} H={H} KV={KV} D={D} bf16 {mask}: "
        f"{fa.last_kernel()} back to back: kernel {ms:.4f} ms (turns "
        f"{statistics.median(k1):.4f}, {statistics.median(k2):.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; device: kernel "
        f"{dev:.4f} ms (turns {dk1:.4f}, {dk2:.4f}), sdpa "
        f"{library_dev:.4f} ms (turns {dl1:.4f}, {dl2:.4f}); host per "
        f"call: kernel {host:.4f} ms, sdpa {library_host:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); device {dev / bound_ms:.1f}x the "
        f"bound, {dev / library_dev:.2f}x sdpa")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": dev,
            "library_device_ms": library_dev, "host_ms": host,
            "library_host_ms": library_host,
            "shape": f"B={B} S={S} H={H} KV={KV} D={D} {mask}"}


# ---------------------------------------------------------------------------
# [2e] the flash-attention backward
# ---------------------------------------------------------------------------
def flash_bwd_bound_ms(B, S, T, H, KV, D, itemsize, causal=True):
    """Least time for the backward: q, k, v, o, dO and the fp32 lse read
    once, dq, dk, dv written once, over the memory rate; or its five
    products (QK^T, dO V^T, P^T dO, dS K, dS^T Q) over the visible
    pairs, 10 D flops a pair, over the peak rate of the input type."""
    nbytes = itemsize * (4 * B * S * H * D + 4 * B * T * KV * D) \
        + 4 * B * H * S
    pairs = B * H * (S * (S + 1) // 2 if causal and S == T else S * T)
    flops = 10 * D * pairs
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def bwd_kernel_for(dtype, D):
    """The backward instantiation the wrapper must launch for ``dtype``:
    bf16 on the tensor cores, fp32 on the SIMT kernels."""
    return (f"fa_bwd_mma<bf16,{D}>" if dtype == torch.bfloat16
            else f"fa_bwd<f32,{D}>")


def check_flash_bwd(fa, fb, q, k, v, dt, kw, seed):
    """One backward call against ``flash_attention_bwd_plain`` on the
    forward's own output and lse: counted, the dtype's kernels, finite,
    within the dtype's tolerance (bf16 also against
    ``flash_attention_bwd_mma_plain``), and a second call bit-equal; the
    lse against the plain forward's. Returns (max error, max error
    against the kernels' rounding (bf16), lse max error)."""
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dt)
    before = fb.launches
    got = fb.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    if fb.launches != before + fb.LAUNCHES_PER_CALL:
        raise AssertionError("the backward did not count its launches")
    name = bwd_kernel_for(dt, q.shape[-1])
    if fb.last_kernel() != name:
        raise AssertionError(f"ran {fb.last_kernel()}, expected {name}")
    want = fb.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    err = 0.0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        if not torch.isfinite(a).all() or \
                (d > BWD_TOL[dt] * (1 + b.float().abs())).any():
            raise AssertionError(f"backward disagrees at {tuple(q.shape)} "
                                 f"k {tuple(k.shape)} {dt} {kw}: max err "
                                 f"{d.max().item()}")
        err = max(err, d.max().item())
    mma_err = 0.0
    if dt == torch.bfloat16:
        rounded = fb.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse,
                                                   **kw)
        for a, b in zip(got, rounded):
            d = (a.float() - b.float()).abs()
            if (d > BWD_MMA_TOL * (1 + b.float().abs())).any():
                raise AssertionError(
                    f"backward disagrees with its rounding at "
                    f"{tuple(q.shape)} k {tuple(k.shape)} {kw}: max err "
                    f"{d.max().item()}")
            mma_err = max(mma_err, d.max().item())
    again = fb.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two backward calls differ at "
                             f"{tuple(q.shape)} {dt} {kw}")
    _, plse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    if not torch.equal(torch.isinf(lse), torch.isinf(plse)):
        raise AssertionError(f"lse -inf rows differ at {tuple(q.shape)}")
    fin = torch.isfinite(plse)
    lerr = 0.0
    if fin.any():
        lerr = (lse[fin] - plse[fin]).abs().max().item()
        if lerr > 1e-4 * (1 + plse[fin].abs().max().item()):
            raise AssertionError(f"lse off by {lerr} at {tuple(q.shape)}")
    if not torch.equal(fa.flash_attention(q, k, v, **kw), out):
        raise AssertionError("the serving forward's bits change with lse")
    return err, mma_err, lerr


def time_flash_bwd(fa, fb, name, shape):
    """At one bf16 causal shape, in turns: the backward kernels alone, the
    SIMT kernels on the same inputs (the first design: the yardstick of
    the redesign), the plain backward, the forward (with lse) and
    backward through autograd, SDPA's forward alone and SDPA's forward
    and backward through autograd (a yardstick only: the port never
    calls it; its backward alone is the difference of the two device
    times, derived); back to back between CUDA events and on the device
    from the profiler; beside the backward's bound."""
    import torch.nn.functional as F
    B, S, H, KV, D, causal = (*shape, True)[:6]
    q, k, v = rand_qkv(B, S, S, H, KV, D, torch.bfloat16, seed=98)
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, causal=causal)
    g = torch.Generator(device="cuda").manual_seed(97)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k, v))
    doutt = dout.transpose(1, 2)
    bwd = lambda: fb.flash_attention_bwd(  # noqa: E731
        q, k, v, out, dout, lse, causal=causal)
    simt = lambda: fb.flash_attention_bwd(  # noqa: E731
        q, k, v, out, dout, lse, causal=causal, simt=True)
    plain = lambda: fb.flash_attention_bwd_plain(  # noqa: E731
        q, k, v, out, dout, lse, causal=causal)
    lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=KV != H)

    def ours():
        o = fa.flash_attention(qg, kg, vg, causal=causal)
        return torch.autograd.grad(o, (qg, kg, vg), dout)

    def lib():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=KV != H)
        return torch.autograd.grad(o, (qt, kt, vt), doutt)
    # the yardstick computes the same gradients, on its own kernels
    ran = simt()
    if fb.last_kernel() != f"fa_bwd<bf16,{D}>" or not all(
            torch.allclose(a.float(), b.float(), atol=BWD_TOL[q.dtype],
                           rtol=BWD_TOL[q.dtype])
            for a, b in zip(ran, plain())):
        raise AssertionError(f"the SIMT yardstick ({fb.last_kernel()}) "
                             f"disagrees with the plain backward")
    fns = {"bwd": bwd, "simt": simt, "plain": plain, "ours": ours,
           "lib_fwd": lib_fwd, "lib": lib}
    on_device = ("bwd", "simt", "ours", "lib_fwd", "lib")
    turns = [({key: time_calls(fn) for key, fn in fns.items()},
              {key: device_ms(fns[key]) for key in on_device})
             for _ in range(2)]
    ms = {key: statistics.median(turns[0][0][key] + turns[1][0][key])
          for key in fns}
    dev = {key: (turns[0][1][key] + turns[1][1][key]) / 2
           for key in on_device}
    lib_bwd_dev = dev["lib"] - dev["lib_fwd"]
    bwd()                  # last_kernel() names the kernels timed
    bound_ms, bound_by, nbytes, flops = flash_bwd_bound_ms(
        B, S, S, H, KV, D, 2, causal=causal)
    mask = "causal" if causal else "no mask"
    log(f"    {name} B={B} S={S} H={H} KV={KV} D={D} bf16 {mask}: "
        f"{fb.last_kernel()} back to back: backward {ms['bwd']:.4f} ms "
        f"(turns {statistics.median(turns[0][0]['bwd']):.4f}, "
        f"{statistics.median(turns[1][0]['bwd']):.4f}), SIMT "
        f"{ms['simt']:.4f} ms, plain {ms['plain']:.4f} ms; forward+backward"
        f" through autograd: ours {ms['ours']:.4f} ms, sdpa "
        f"{ms['lib']:.4f} ms; device: backward {dev['bwd']:.4f} ms (turns "
        f"{turns[0][1]['bwd']:.4f}, {turns[1][1]['bwd']:.4f}), SIMT "
        f"{dev['simt']:.4f} ms (turns {turns[0][1]['simt']:.4f}, "
        f"{turns[1][1]['simt']:.4f}), ours fwd+bwd {dev['ours']:.4f} ms, "
        f"sdpa fwd {dev['lib_fwd']:.4f} ms, fwd+bwd {dev['lib']:.4f} ms, "
        f"bwd alone {lib_bwd_dev:.4f} ms (derived: the difference); bound "
        f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); device {dev['bwd'] / bound_ms:.1f}x "
        f"the bound, {dev['simt'] / dev['bwd']:.2f}x faster than SIMT, "
        f"{dev['bwd'] / lib_bwd_dev:.2f}x sdpa's backward")
    return {"ms": ms["bwd"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "device_ms": dev["bwd"],
            "simt_ms": ms["simt"], "simt_device_ms": dev["simt"],
            "fwd_bwd_ms": ms["ours"], "fwd_bwd_device_ms": dev["ours"],
            "library_ms": ms["lib"], "library_device_ms": dev["lib"],
            "library_fwd_device_ms": dev["lib_fwd"],
            "library_bwd_device_ms": lib_bwd_dev,
            "shape": f"B={B} S={S} H={H} KV={KV} D={D} {mask}"}


def phase_flash_backward():
    """[2e] the backward kernels against ``flash_attention_bwd_plain``
    over the forward's sweep, both dtypes, then timed at smollm's
    training and serving shapes; returns the kernels-line entry."""
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import attention_bwd as fb
    both = (torch.float32, torch.bfloat16)
    sweep = [((1, 128, 128, 4, 4, 64), {}), ((2, 256, 256, 4, 2, 64), {}),
             ((1, 128, 128, 4, 1, 128), {}), ((1, 96, 96, 2, 2, 80), {})]
    sweep += [((1, 256, 256, 2, 2, 64), {"window": w})
              for w in (1, 17, 64, 256)]
    sweep += [((2, 1, 200, 4, 2, 64), {"q_offset": 199}),
              ((1, 40, 40, 2, 1, 64), {"q_offset": -5}),   # fully masked
              ((1, 96, 300, 4, 2, 64), {"q_offset": 204}),
              ((2, 200, 200, 4, 1, 64), {}),               # MQA, S = 200
              ((2, 200, 200, 6, 2, 80), {}),               # GQA
              ((2, 70, 300, 3, 1, 128), {"causal": False}),
              ((1, 200, 264, 2, 1, 128), {"window": 64, "q_offset": 64})]
    # S and T off the tile heights (32 and 64 rows); D 80 and 128 with
    # query groups of 1, 2 and 3
    sweep += [((2, 200, 264, 6, 3, 64), {"q_offset": 64}),
              ((1, 200, 264, 3, 3, 80), {"q_offset": 64}),
              ((2, 200, 264, 4, 2, 80), {"q_offset": 64}),
              ((2, 200, 264, 4, 2, 128), {}),
              ((1, 200, 264, 6, 2, 128), {"q_offset": 64, "window": 96})]
    B, S, H, KV, D = OLMOE_TRAIN_ATTN_SHAPE
    sweep.append(((B, S, S, H, KV, D), {}))
    # whisper's training encoder rows (1500 frames: a 28-key last tile,
    # no mask) and llava's prefix (GQA 4, D 128), 8 of its 32 heads
    B, S, H, KV, D, _ = WHISPER_TRAIN_ATTN_SHAPE
    sweep.append(((B, S, S, H, KV, D), {"causal": False}))
    sweep.append(((1, LLAVA_PREFIX, LLAVA_PREFIX, 8, 2, 128), {}))
    B, S, H, KV, D = TRAIN_ATTN_SHAPE
    sweep.append(((B, S, S, H, KV, D), {}))
    max_err = {dt: 0.0 for dt in both}
    lse_err = mma_err = 0.0
    for i, ((B, S, T, H, KV, D), kw) in enumerate(sweep):
        for dt in both:
            q, k, v = rand_qkv(B, S, T, H, KV, D, dt, seed=200 + i)
            err, merr, lerr = check_flash_bwd(fa, fb, q, k, v, dt,
                                              {"causal": True, **kw}, seed=i)
            max_err[dt] = max(max_err[dt], err)
            mma_err, lse_err = max(mma_err, merr), max(lse_err, lerr)
            log(f"[2e] {(B, S, T, H, KV, D)} {str(dt)[6:]} {kw}: "
                f"{fb.last_kernel()}, max|err| {err:.3g}"
                + (f" (its rounding {merr:.3g})" if dt == torch.bfloat16
                   else "") + f", lse {lerr:.3g}; two calls bit-equal")
    train_err = err          # the training shape (bf16) is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol "
        f"{BWD_TOL[torch.float32]}), bf16 {max_err[torch.bfloat16]:.3g} "
        f"(tol {BWD_TOL[torch.bfloat16]}; against its rounding "
        f"{mma_err:.3g}, tol {BWD_MMA_TOL}), lse {lse_err:.3g}; every "
        f"serving forward bit-equal with and without lse")
    s = SERVE_SHAPE
    by_shape = {"smollm training": time_flash_bwd(fa, fb, "smollm training",
                                                  TRAIN_ATTN_SHAPE),
                "smollm serving": time_flash_bwd(
                    fa, fb, "smollm serving",
                    (s["B"], s["S"], s["H"], s["KV"], s["D"])),
                "olmoe training": time_flash_bwd(fa, fb, "olmoe training",
                                                 OLMOE_TRAIN_ATTN_SHAPE),
                "whisper encoder training": time_flash_bwd(
                    fa, fb, "whisper encoder training",
                    WHISPER_TRAIN_ATTN_SHAPE)}
    top = by_shape["smollm training"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/attention.py:132",
            "note": "the gradient of that kernel's function, as the "
                    "reference takes it under jax.value_and_grad",
            "max_abs_err": train_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_is": "F.scaled_dot_product_attention forward and "
                          "backward through autograd",
            "device_ms": top["device_ms"],
            "library_device_ms": top["library_device_ms"],
            "library_bwd_device_ms": top["library_bwd_device_ms"],
            "library_bwd_is": "derived: SDPA fwd+bwd minus SDPA fwd, "
                              "device times",
            "simt_device_ms": top["simt_device_ms"],
            "fwd_bwd_ms": top["fwd_bwd_ms"],
            "fwd_bwd_device_ms": top["fwd_bwd_device_ms"],
            "launches_per_call": fb.LAUNCHES_PER_CALL,
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "max_err_bf16_vs_rounding": mma_err,
            "max_lse_err": lse_err,
            "shape": top["shape"] + " bf16", "by_shape": by_shape}


# ---------------------------------------------------------------------------
# [2f] the SSD chunk backward
# ---------------------------------------------------------------------------
# mamba2-130m's training SSD call, one rank's rows (2 of the 8 x 256
# batch), and zamba2-2.7b's heads (80 of 64, N 64) at the same rows
SSD_TRAIN_SHAPE = (2, 256, 24, 64, 128, 128)
SSD_ZAMBA2_TRAIN_SHAPE = (2, 256, 80, 64, 64, 128)


def ssd_bwd_bound_ms(B, S, H, P, N, Q, itemsize):
    """Least time for the backward: x, dt, A, B, C, the forward's cum and
    the fp32 cotangents of y_intra, states and cum read once, dx, ddt,
    dA, dB and dC written once (in the inputs' dtypes) over the memory
    rate; or the products over the peak rate of the input type: per
    (batch, head, chunk) dy x^T and scores^T dy (2 P flops a lower-
    triangle pair each), dG B and dG^T C (2 N each), x dS^T and B dS
    (2 Q N P each), and C B^T once per (batch, chunk)."""
    nc = S // Q
    nbytes = (2 * itemsize * (B * S * H * P + 2 * B * S * N)
              + 4 * (2 * B * S * H + 2 * H)
              + 4 * B * H * nc * (2 * Q + Q * P + N * P))
    pairs = Q * (Q + 1) // 2
    flops = (2 * N * pairs * B * nc
             + B * H * nc * (4 * P * pairs + 4 * N * pairs + 4 * Q * N * P))
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def ssd_bwd_inputs(shape, dtype, seed):
    """rand_ssd's inputs, the forward kernel's cum, and random fp32
    cotangents of all three forward outputs."""
    from repro_torch.kernels import ssd_scan
    B, S, H, P, N, Q = shape
    x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, dtype, seed)
    outs = ssd_scan.ssd_chunk(x, dts, A, Bm, Cm, chunk=Q)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cts = [torch.randn(t.shape, generator=g, device="cuda") for t in outs]
    return (x, dts, A, Bm, Cm, outs[2], *cts)


def check_ssd_bwd(shape, dtype, seed):
    """One backward call against ``ssd_chunk_bwd_plain``: counted, the
    dtype's kernel, finite, every leaf within the forward's tolerance of
    its largest entry (ddt's and dA's terms cancel, so their error scales
    with the leaf, not the entry), bf16 also within ``SSD_BWD_MMA_TOL`` of
    ``ssd_chunk_bwd_mma_plain`` (the kernel's rounding), and a second
    call bit-equal. Returns (max |err| over the leaves, max of |err| /
    (1 + max |want|) over the leaves, that against the kernel's rounding
    (bf16), and the rounding's own: ``ssd_chunk_bwd_mma_plain`` against
    ``ssd_chunk_bwd_plain`` (bf16))."""
    from repro_torch.kernels import ssd_scan_bwd as sb
    ins = ssd_bwd_inputs(shape, dtype, seed)
    Q, P = shape[5], shape[3]
    before = sb.launches
    got = sb.ssd_chunk_bwd(*ins, chunk=Q)
    torch.cuda.synchronize()
    if sb.launches != before + sb.LAUNCHES_PER_CALL[dtype]:
        raise AssertionError("the SSD backward did not count its launches")
    name = ssd_bwd_kernel_for(dtype, P)
    if sb.last_kernel() != name:
        raise AssertionError(f"ran {sb.last_kernel()}, expected {name}")

    def leaf_rel(a_leaves, b_leaves, tol, what):
        worst = (0.0, 0.0)
        for leaf, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), a_leaves,
                              b_leaves):
            d = (a.float() - b.float()).abs().max().item()
            r = d / (1 + b.float().abs().max().item())
            if a.shape != b.shape or a.dtype != b.dtype or \
                    not torch.isfinite(a).all() or r > tol:
                raise AssertionError(f"SSD backward {leaf} disagrees with "
                                     f"{what} at {shape} {dtype}: max err "
                                     f"{d} ({r:.3g} of the leaf)")
            worst = (max(worst[0], d), max(worst[1], r))
        return worst
    want = sb.ssd_chunk_bwd_plain(*ins, chunk=Q)
    err, rel = leaf_rel(got, want, SSD_TOL[dtype], "the plain version")
    mma_rel = own_rel = 0.0
    if dtype == torch.bfloat16:
        rounded = sb.ssd_chunk_bwd_mma_plain(*ins, chunk=Q)
        mma_rel = leaf_rel(got, rounded, SSD_BWD_MMA_TOL,
                           "its rounding")[1]
        own_rel = leaf_rel(rounded, want, SSD_TOL[dtype],
                           "the plain version (its rounding)")[1]
    again = sb.ssd_chunk_bwd(*ins, chunk=Q)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"two SSD backward calls differ at {shape} "
                             f"{dtype}")
    return err, rel, mma_rel, own_rel


def ssd_bwd_kernel_for(dtype, P):
    """The kernel the backward must launch for ``dtype``: bf16 on the
    tensor cores, fp32 the SIMT chunk pass (then its reduce)."""
    return (f"ssd_chunk_bwd_mma<bf16,{P}>" if dtype == torch.bfloat16
            else f"ssd_chunk_bwd<f32,{P}>")


def time_ssd_bwd(name, shape):
    """At one bf16 shape, with dy a transposed view as the training path
    hands it over, in turns: the tensor-core kernel, the first design's
    SIMT pair on the same inputs (``simt=True``: it copies dy and casts
    dx, dB and dC, as that design's call does) and the plain backward;
    back to back between CUDA events and on the device from the
    profiler; beside the bound and the kernel's resources on this
    card."""
    from repro_torch.kernels import ssd_scan_bwd as sb
    B, S, H, P, N, Q = shape
    x, dts, A, Bm, Cm, cum, dy, dS, dcum = ssd_bwd_inputs(
        shape, torch.bfloat16, seed=96)
    view = dy.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
    ins = (x, dts, A, Bm, Cm, cum, view, dS, dcum)
    kern = lambda: sb.ssd_chunk_bwd(*ins, chunk=Q)  # noqa: E731
    simt = lambda: sb.ssd_chunk_bwd(*ins, chunk=Q, simt=True)  # noqa: E731
    plain = lambda: sb.ssd_chunk_bwd_plain(*ins, chunk=Q)  # noqa: E731
    # the yardstick computes the same gradients
    ran, other = kern(), simt()
    if any((a.float() - b.float()).abs().max().item()
           > SSD_TOL[torch.bfloat16] * (1 + b.float().abs().max().item())
           for a, b in zip(other, ran)):
        raise AssertionError(f"the SIMT call disagrees with the tensor-core "
                             f"kernel at {shape}")
    fns = {"kern": kern, "simt": simt, "plain": plain}
    on_device = {"kern": kern, "simt": simt}
    turns = [({key: time_calls(fn) for key, fn in fns.items()},
              {key: device_ms(fn) for key, fn in on_device.items()})
             for _ in range(2)]
    ms = {key: statistics.median(turns[0][0][key] + turns[1][0][key])
          for key in fns}
    dev = {key: (turns[0][1][key] + turns[1][1][key]) / 2
           for key in on_device}
    host = host_ms(kern)
    res = sb.mma_resources(P, N, H)
    grid = B * H * (S // Q)
    waves = -(-grid // (res["max_active_clusters"] * res["cluster"]))
    kern()                  # last_kernel() names the kernel timed
    bound_ms, bound_by, nbytes, flops = ssd_bwd_bound_ms(B, S, H, P, N, Q,
                                                         2)
    log(f"    {name} B={B} S={S} H={H} P={P} N={N} Q={Q} bf16, dy a "
        f"transposed view ({grid} blocks in clusters of {res['cluster']}; "
        f"{res['smem_bytes']} bytes of shared memory, {res['registers']} "
        f"registers, {res['local_bytes']} bytes local a thread, "
        f"{res['blocks_per_sm']} block(s) an SM, {res['max_active_clusters']}"
        f" clusters at once: {waves} wave(s)): {sb.last_kernel()} back to "
        f"back {ms['kern']:.4f} ms (turns "
        f"{statistics.median(turns[0][0]['kern']):.4f}, "
        f"{statistics.median(turns[1][0]['kern']):.4f}), device "
        f"{dev['kern']:.4f} ms (turns {turns[0][1]['kern']:.4f}, "
        f"{turns[1][1]['kern']:.4f}), host {host:.4f} ms to issue a call; "
        f"SIMT pair (the first design's call) back to back "
        f"{ms['simt']:.4f} ms, device {dev['simt']:.4f} ms (turns "
        f"{turns[0][1]['simt']:.4f}, {turns[1][1]['simt']:.4f}); plain "
        f"{ms['plain']:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); device "
        f"{dev['kern'] / bound_ms:.1f}x the bound, "
        f"{dev['simt'] / dev['kern']:.2f}x faster than the SIMT pair; no "
        f"single library call")
    if dev["kern"] >= dev["simt"]:
        raise AssertionError(f"the tensor-core kernel ({dev['kern']:.4f} ms)"
                             f" is not faster than the SIMT pair "
                             f"({dev['simt']:.4f} ms) at {shape}")
    return {"ms": ms["kern"], "plain_ms": ms["plain"],
            "device_ms": dev["kern"], "bound_ms": bound_ms,
            "bound_by": bound_by, "simt_ms": ms["simt"],
            "simt_device_ms": dev["simt"], "host_ms": host,
            "resources": res, "waves": waves,
            "shape": f"B={B} S={S} H={H} P={P} N={N} Q={Q} bf16"}


def phase_ssd_backward():
    """[2f] the SSD backward kernels against ``ssd_chunk_bwd_plain`` over
    the reference's SSD shapes, Q off the powers of two, and the two
    training shapes, fp32 and bf16 (bf16 also against its rounding,
    ``ssd_chunk_bwd_mma_plain``), random cotangents of all three forward
    outputs; timed at both training shapes beside the SIMT pair; returns
    the kernels-line entry."""
    from repro_torch.kernels import ssd_scan_bwd
    sweep = [(1, 64, 2, 64, 32, 32), (2, 128, 3, 64, 64, 32),
             (1, 128, 1, 32, 128, 64),               # tests/test_kernels.py
             (1, 200, 2, 64, 128, 100), (2, 14, 3, 32, 16, 7),
             SSD_ZAMBA2_TRAIN_SHAPE, SSD_TRAIN_SHAPE]  # the main path's last
    max_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    mma_rel = own_rel = 0.0
    for i, shape in enumerate(sweep):
        for dt in (torch.float32, torch.bfloat16):
            err, rel, mrel, orel = check_ssd_bwd(shape, dt, seed=300 + 2 * i)
            max_rel[dt] = max(max_rel[dt], rel)
            mma_rel, own_rel = max(mma_rel, mrel), max(own_rel, orel)
            log(f"[2f] ssd backward {shape} {str(dt)[6:]}: "
                f"{ssd_scan_bwd.last_kernel()}, max|err| {err:.3g} ({rel:.3g}"
                f" of the leaf's scale"
                + (f"; against its rounding {mrel:.3g}, the rounding's own "
                   f"{orel:.3g}" if dt == torch.bfloat16 else "")
                + "); two calls bit-equal")
    train_err = err           # the training shape, bf16, is the last case
    log(f"    max error over the leaves' scale: f32 "
        f"{max_rel[torch.float32]:.3g} (tol {SSD_TOL[torch.float32]}), bf16 "
        f"{max_rel[torch.bfloat16]:.3g} (tol {SSD_TOL[torch.bfloat16]}; "
        f"against its rounding {mma_rel:.3g}, tol {SSD_BWD_MMA_TOL}; the "
        f"rounding's own {own_rel:.3g})")
    by_shape = {"mamba2 training": time_ssd_bwd("mamba2 training",
                                                SSD_TRAIN_SHAPE),
                "zamba2 training": time_ssd_bwd("zamba2 training",
                                                SSD_ZAMBA2_TRAIN_SHAPE)}
    top = by_shape["mamba2 training"]
    return {"name": "ssd_chunk_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:81",
            "note": "the gradient of that kernel's function, which the "
                    "reference takes through XLA under jax.value_and_grad",
            "max_abs_err": train_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "device_ms": top["device_ms"],
            "simt_ms": top["simt_ms"],
            "simt_device_ms": top["simt_device_ms"],
            "launches_per_call": ssd_scan_bwd.LAUNCHES_PER_CALL[
                torch.bfloat16],
            "max_err_of_leaf_f32": max_rel[torch.float32],
            "max_err_of_leaf_bf16": max_rel[torch.bfloat16],
            "max_err_of_leaf_bf16_vs_rounding": mma_rel,
            "rounding_err_of_leaf": own_rel,
            "shape": top["shape"], "by_shape": by_shape}


def phase_model():
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    kern = build_model(cfg, compute_dtype=torch.float32, attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref")
    with torch.inference_mode():
        params = kern.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
        tokens = tokens.cuda()
        lk, _ = kern.prefill(params, tokens, 256)
        lp, _ = plain.prefill(params, tokens, 256)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
    log(f"[3] smollm-135m full width fp32 prefill (2x256): logits "
        f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
        f"tol {MODEL_TOL})")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"model logits through the kernel differ by "
                             f"{diff} > {MODEL_TOL}")
    del params
    torch.cuda.empty_cache()
    return diff


def ssd_bound_ms(B, S, H, P, N, Q, itemsize):
    """Least time for the call: x, dt, A, B and C read once and y_intra,
    states and cum written once over the memory rate, or the operations
    the data needs over the peak rate of the input type: C B^T on the
    lower triangle once per (batch, chunk) (B and C are shared by the
    heads), scores times x on the lower triangle and the chunk state's
    N x Q x P product per (batch, head, chunk)."""
    nc = S // Q
    nbytes = (itemsize * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 4 * H + 4 * B * H * nc * (Q * P + N * P + Q))
    pairs = Q * (Q + 1) // 2
    flops = (2 * N * pairs * B * nc
             + B * H * nc * (2 * P * pairs + 2 * N * Q * P))
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def rand_ssd(B, S, H, P, N, dtype, seed):
    """x, B and C as column slices of one (B, S, H*P + 2N) tensor, as the
    model's conv output hands them to the kernel (read through strides)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g,
                      device="cuda").to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=g, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((H,), generator=g, device="cuda"))
    return x, dt, A, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def ssd_kernel_for(dtype, P):
    """The instantiation the wrapper must launch for ``dtype``: bf16 on
    the tensor cores, fp32 on the SIMT kernel."""
    return (f"ssd_chunk_mma<bf16,{P}>" if dtype == torch.bfloat16
            else f"ssd_chunk<f32,{P}>")


def phase_ssd_kernel():
    from repro_torch.kernels import ssd_scan
    s = SSD_SERVE_SHAPE
    sweep = [(1, 64, 2, 64, 32, 32), (2, 128, 3, 64, 64, 32),
             (1, 128, 1, 32, 128, 64)]                # tests/test_kernels.py
    cases = [(shape, dt) for shape in sweep
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((1, 200, 2, 64, 128, 100), dt)          # Q = 100
              for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 14, 3, 64, 128, 7), dt)             # Q = 7, two chunks
              for dt in (torch.float32, torch.bfloat16)]
    # mamba2's continuous path: one request per call
    cases += [((1, S, s["H"], s["P"], s["N"], s["Q"]), torch.bfloat16)
              for S in SSD_ONE_REQUEST_S]
    cases.append(((4, 512, 80, 64, 64, 128), torch.bfloat16))  # zamba2 serving
    cases.append(((s["B"], s["S"], s["H"], s["P"], s["N"], s["Q"]),
                  torch.bfloat16))                     # mamba2 serving, last
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, ((B, S, H, P, N, Q), dt) in enumerate(cases):
        x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, dt, seed=100 + i)
        before = ssd_scan.launches
        got = ssd_scan.ssd_chunk(x, dts, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        if ssd_scan.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        if ssd_scan.last_kernel() != ssd_kernel_for(dt, P):
            raise AssertionError(f"{dt} P={P} ran {ssd_scan.last_kernel()}, "
                                 f"expected {ssd_kernel_for(dt, P)}")
        want = ssd_scan.ssd_chunked_plain(x, dts, A, Bm, Cm, chunk=Q)
        err = 0.0
        for name, g_, w_ in zip(("y_intra", "states", "cum"), got, want):
            diff = (g_ - w_).abs()
            bad = diff > SSD_TOL[dt] * (1 + w_.abs())
            if g_.shape != w_.shape or not torch.isfinite(g_).all() \
                    or bad.any():
                raise AssertionError(
                    f"ssd_chunk {name} disagrees with plain at "
                    f"{(B, S, H, P, N, Q)} {dt}: max err "
                    f"{diff.max().item()}")
            err = max(err, diff.max().item())
        max_err[dt] = max(max_err[dt], err)
        log(f"[2b] ssd {(B, S, H, P, N, Q)} {str(dt)[6:]}: "
            f"{ssd_scan.last_kernel()}, max|err| {err:.3g}")
    serve_err = err      # the mamba2 serving shape is the last case
    log(f"    max|err| f32 {max_err[torch.float32]:.3g} (tol 5e-5), "
        f"bf16 {max_err[torch.bfloat16]:.3g} (tol 5e-2)")

    by_shape = {}
    shapes = [("mamba2 serving", s["B"], s["S"])] + [
        (f"mamba2 one request S={S}", 1, S) for S in SSD_ONE_REQUEST_S]
    for name, B, S in shapes:
        H, P, N, Q = (s[k] for k in ("H", "P", "N", "Q"))
        x, dts, A, Bm, Cm = rand_ssd(B, S, H, P, N, torch.bfloat16, seed=99)
        kern = lambda: ssd_scan.ssd_chunk(  # noqa: E731
            x, dts, A, Bm, Cm, chunk=Q)
        plain = lambda: ssd_scan.ssd_chunked_plain(  # noqa: E731
            x, dts, A, Bm, Cm, chunk=Q)
        # in turns (kernel, plain, kernel, plain): one card, one call
        k1, p1, dk1, c1 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        k2, p2, dk2, c2 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        dev, cold = (dk1 + dk2) / 2, (c1 + c2) / 2
        bound_ms, bound_by, nbytes, flops = ssd_bound_ms(B, S, H, P, N, Q, 2)
        log(f"    {name} B={B} S={S} H={H} P={P} N={N} Q={Q} bf16 "
            f"({B * H * (S // Q)} blocks): kernel back to back {ms:.4f} ms "
            f"(turns {statistics.median(k1):.4f}, "
            f"{statistics.median(k2):.4f}), device warm {dev:.4f} ms (turns "
            f"{dk1:.4f}, {dk2:.4f}), cold {cold:.4f} ms (turns {c1:.4f}, "
            f"{c2:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
            f"no single library call")
        by_shape[name] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev,
                          "cold_ms": cold, "bound_ms": bound_ms,
                          "bound_by": bound_by}
    top = by_shape["mamba2 serving"]
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:81",
            "max_abs_err": serve_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "device_ms": top["device_ms"], "cold_ms": top["cold_ms"],
            "max_err_f32": max_err[torch.float32],
            "max_err_bf16": max_err[torch.bfloat16],
            "shape": f"B={s['B']} S={s['S']} H={s['H']} P={s['P']} "
                     f"N={s['N']} Q={s['Q']} bf16",
            "by_shape": by_shape}


def combine_bound_ms(n, itemsize):
    """Least time for the call: acc and part read once and out written
    once over the memory rate, or the n fp32 operations over the fp32
    rate outside the tensor cores."""
    nbytes = 3 * n * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def phase_combine_kernel():
    from repro_torch.kernels import segment_reduce as sr
    # (n, element offset of acc): the reference's sweep, 16M elements,
    # and row slices that start off a 16-byte boundary, as a ring's
    # segments do
    shapes = [(7, 0), (128, 0), (1000, 0), (65536, 0), (4099, 0),
              (COMBINE_N, 0), (1000, 1), (65536, 3), (4099, 5),
              ((1 << 20) + 1, 2)]
    cases = [(n, off, dt, op) for n, off in shapes
             for dt in (torch.float32, torch.bfloat16)
             for op in ("add", "max", "min")]
    g = torch.Generator(device="cuda").manual_seed(7)
    max_err, equal, in_place_equal = 0.0, 0, 0
    for n, off, dt, op in cases:
        acc = torch.randn((n + off,), generator=g, device="cuda").to(dt)[off:]
        part = torch.randn((n,), generator=g, device="cuda").to(dt)
        before = sr.launches
        got = sr.segment_combine(acc, part, op)
        torch.cuda.synchronize()
        if sr.launches != before + 1:
            raise AssertionError("the wrapper did not count its launch")
        want = sr.segment_combine_plain(acc, part, op)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != dt or not torch.isfinite(got).all() \
                or not err <= COMBINE_TOL:
            raise AssertionError(f"segment_combine disagrees with plain at "
                                 f"n={n} offset={off} {dt} {op}: {err}")
        max_err = max(max_err, err)
        equal += bool(torch.equal(got, want))
        # in place into acc: the out-of-place call's bits
        res = sr.segment_combine(acc, part, op, out=acc)
        torch.cuda.synchronize()
        if res.data_ptr() != acc.data_ptr() or \
                sr.launches != before + 2:
            raise AssertionError("the in-place call did not write acc")
        err = (acc.float() - want.float()).abs().max().item()
        if not err <= COMBINE_TOL:
            raise AssertionError(f"segment_combine in place disagrees at "
                                 f"n={n} offset={off} {dt} {op}: {err}")
        max_err = max(max_err, err)
        in_place_equal += bool(torch.equal(acc, got))
    if in_place_equal != len(cases):
        raise AssertionError(f"in place bit-equal to out of place in only "
                             f"{in_place_equal}/{len(cases)} cases")
    log(f"[2c] segment_combine: {len(cases)} cases (n 7..{COMBINE_N}, "
        f"offsets 0-5, f32/bf16, add/max/min), each out of place and in "
        f"place, max|err| {max_err:.3g} (tol {COMBINE_TOL}), bit-equal to "
        f"plain {equal}/{len(cases)}, in place bit-equal to out of place "
        f"{in_place_equal}/{len(cases)}")

    out = {"name": "segment_combine", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_combine.cu",
           "replaces": "src/repro/kernels/segment_reduce.py:63",
           "max_abs_err": max_err, "bit_equal_cases": equal,
           "cases": len(cases)}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        b = torch.randn((COMBINE_N,), generator=g, device="cuda").to(dt)
        c = torch.empty_like(a)
        kern = lambda: sr.segment_combine(a, b, "add")  # noqa: E731
        plain = lambda: sr.segment_combine_plain(a, b, "add")  # noqa: E731
        lib = lambda: torch.add(a, b)  # noqa: E731
        # in place, as the ring calls it, against Tensor.add_ and against
        # the earlier form: out of place, then copied back
        inplace = lambda: sr.segment_combine(c, b, "add", out=c)  # noqa: E731
        lib_inplace = lambda: c.add_(b)  # noqa: E731
        copy_back = lambda: c.copy_(sr.segment_combine(c, b, "add"))  # noqa: E731
        # in turns (kernel, plain, library, ..., then again): one card
        t = {}
        for rnd in range(2):
            for key, fn in (("kernel", kern), ("plain", plain),
                            ("library", lib), ("in_place", inplace),
                            ("add_", lib_inplace), ("copy_back", copy_back)):
                c.copy_(a)
                t.setdefault(key, []).append(time_calls(fn))
            t.setdefault("device", []).append(device_ms(kern))
        med = {key: statistics.median(r[0] + r[1]) for key, r in t.items()
               if key != "device"}
        dev = sum(t["device"]) / 2
        bound_ms, bound_by, nbytes = combine_bound_ms(COMBINE_N,
                                                      a.element_size())
        name = str(dt)[6:]
        log(f"    n={COMBINE_N} {name} add: kernel {med['kernel']:.4f} ms "
            f"(turns {statistics.median(t['kernel'][0]):.4f}, "
            f"{statistics.median(t['kernel'][1]):.4f}), device {dev:.4f} ms "
            f"(turns {t['device'][0]:.4f}, {t['device'][1]:.4f}), plain "
            f"{med['plain']:.4f} ms, torch.add {med['library']:.4f} ms; in "
            f"place {med['in_place']:.4f} ms, Tensor.add_ {med['add_']:.4f} "
            f"ms, out of place + copy back {med['copy_back']:.4f} ms; bound "
            f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB)")
        suffix = "" if dt == torch.float32 else "_bf16"
        out.update({f"ms{suffix}": med["kernel"],
                    f"plain_ms{suffix}": med["plain"],
                    f"bound_ms{suffix}": bound_ms,
                    f"library_ms{suffix}": med["library"],
                    f"in_place_ms{suffix}": med["in_place"],
                    f"add__ms{suffix}": med["add_"],
                    f"copy_back_ms{suffix}": med["copy_back"],
                    f"device_ms{suffix}": dev})
        if dt == torch.float32:
            out.update(bound_by=bound_by, shape=f"n={COMBINE_N} f32 add")
    del a, b, c
    torch.cuda.empty_cache()
    return out


def rand_paged(R, H, KV, D, bs, nb, dtype, seed):
    """q, pools with a null block 0, and shuffled int32 tables on the
    card, as the engine lays them out."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = 1 + R * nb
    kp = torch.randn((NB, bs, KV, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((NB, bs, KV, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(R * nb, generator=g, device="cuda")
    tables = (1 + perm).reshape(R, nb).to(torch.int32)
    q = torch.randn((R, 1, H, D), generator=g, device="cuda").to(dtype)
    return q, kp, vp, tables


def paged_bound_ms(R, H, KV, D, T, itemsize):
    """Least time for a call over full views (every slot valid): each
    request's K and V view read once, q, the tables and lengths read
    and the output written once over the memory rate, or the QK and PV
    products of every (query head, slot) over the peak rate of the
    input type."""
    nbytes = (itemsize * (2 * R * T * KV * D + 2 * R * H * D)
              + 4 * (R * T // 16 + R))
    flops = 4 * D * H * T * R
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes, flops


def off_by(got, want, tol):
    """Max |got - want| and whether some element lies outside
    ``tol * (1 + |want|)``."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool(
        (diff > tol * (1 + want.float().abs())).any())


def check_paged(pa, ref, q, kp, vp, tables, lengths, window, label):
    """One launch against the gather path at the dtype's tolerance (a row
    with no valid slot must be 0, where the gather path gives the mean of
    V); returns the max error over the other rows."""
    dt = q.dtype
    before = pa.launches
    got = pa.paged_attention(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    if pa.launches != before + 1:
        raise AssertionError("the wrapper did not count its launch")
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    empty = lengths == 0
    err, bad = off_by(got[~empty], want[~empty], PAGED_TOL[dt])
    if got.dtype != dt or not torch.isfinite(got).all() or bad or \
            (got[empty] != 0).any():
        raise AssertionError(f"paged_attention disagrees with plain at "
                             f"{label} window {window} {dt}: max err {err}")
    return err


def phase_paged_kernel():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    # tests/test_paged_attention.py's setup (3 requests of 3 blocks of 4
    # slots, 2 KV heads, 4 query heads) at each built head dim, windows 0
    # and 6, partial/full/wrapped and several-wraps-deep views
    cases = []
    for D in (64, 80, 128):
        for window in (0, 6):
            for lens in ((5, 12, 17), (27, 36, 13)):
                for dt in (torch.float32, torch.bfloat16):
                    cases.append((dict(R=3, H=4, KV=2, D=D, bs=4, T=12),
                                  lens, window, dt))
    # one split: a table of one pool block, and R * KV filling the card
    for s in (dict(R=4, H=4, KV=2, D=80, bs=16, T=16),
              dict(R=33, H=16, KV=16, D=128, bs=16, T=32)):
        for dt in (torch.float32, torch.bfloat16):
            cases.append((s, tuple(([5, 16, 40, 100] * 9)[:s["R"]]), 0, dt))
    for arch, s in PAGED_SERVE_SHAPES.items():
        T = s["T"]
        lens = tuple(([T - 64, T, T + 100, 3 * T + 5, 1, 200] * 2)[:s["R"]])
        for dt in (torch.float32, torch.bfloat16):
            cases.append((s, lens, 0, dt))
            # the splits' edges: an empty row, splits with no valid slot,
            # a wrapped window across a split and the ring's end
            edge = tuple(([0, 20, T + 50, T + 3, 1, T, 2 * T + 47, 300]
                          * 2)[:s["R"]])
            cases.append((s, edge, 6, dt))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (s, lens, window, dt) in enumerate(cases):
        q, kp, vp, tables = rand_paged(s["R"], s["H"], s["KV"], s["D"],
                                       s["bs"], s["T"] // s["bs"], dt,
                                       seed=300 + i)
        lengths = torch.tensor(lens, device="cuda")
        err = check_paged(pa, ref, q, kp, vp, tables, lengths, window,
                          f"{s} lengths {lens}")
        max_err[dt] = max(max_err[dt], err)
    log(f"[2d] paged_attention: {len(cases)} cases (head dims 64/80/128, "
        f"windows 0/6, partial/full/wrapped views, one split, the "
        f"{len(PAGED_SERVE_SHAPES)} serving shapes, the splits' edges), "
        f"max|err| f32 {max_err[torch.float32]:.3g} "
        f"(tol 2e-5), bf16 {max_err[torch.bfloat16]:.3g} (tol 2**-7)")
    # sharp scores (q and K x 8) at the serving shapes: fp32 q and P (the
    # TPU kernel's rounding) would miss the gather path by 4 tolerances
    for arch, s in PAGED_SERVE_SHAPES.items():
        R, T = s["R"], s["T"]
        q, kp, vp, tables = rand_paged(R, s["H"], s["KV"], s["D"], s["bs"],
                                       T // s["bs"], torch.float32, seed=7)
        q, kp, vp = (q * 8).bfloat16(), (kp * 8).bfloat16(), vp.bfloat16()
        lengths = torch.tensor(([T - 3, T, T + 5] * R)[:R], device="cuda")
        want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
        fp32_err, fp32_bad = off_by(
            ref.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                    tables, lengths), want,
            4 * PAGED_TOL[torch.bfloat16])
        err = check_paged(pa, ref, q, kp, vp, tables, lengths, 0,
                          f"{arch} sharp")
        log(f"    {arch} sharp scores bf16: kernel max|err| {err:.3g}; fp32 "
            f"q and P would be {fp32_err:.3g} off"
            f"{' (past 4 ulps: the case tells the roundings apart)' if fp32_bad else ''}")
        # two calls on the same inputs give the same bits
        again = [pa.paged_attention(q, kp, vp, tables, lengths)
                 for _ in range(2)]
        if not torch.equal(again[0], again[1]):
            raise AssertionError(f"paged_attention at {arch}: two calls "
                                 f"differ")

    out = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:179",
           "max_abs_err": max_err[torch.bfloat16],
           "max_err_f32": max_err[torch.float32],
           "max_err_bf16": max_err[torch.bfloat16], "library_ms": None,
           "by_shape": {}}
    for arch, s in PAGED_SERVE_SHAPES.items():
        R, H, KV, D, bs, T = (s[k] for k in ("R", "H", "KV", "D", "bs", "T"))
        q, kp, vp, tables = rand_paged(R, H, KV, D, bs, T // bs,
                                       torch.bfloat16, seed=99)
        lengths = torch.full((R,), T, dtype=torch.int32,
                             device="cuda")                 # full views
        kern = lambda: pa.paged_attention(  # noqa: E731
            q, kp, vp, tables, lengths)
        plain = lambda: ref.paged_attention_ref(  # noqa: E731
            q, kp, vp, tables, lengths)
        # in turns (kernel, plain, kernel, plain): one card, one call
        k1, p1, dk1, c1 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        k2, p2, dk2, c2 = (time_calls(kern), time_calls(plain),
                           device_ms(kern), cold_ms(kern))
        ms, plain_ms = statistics.median(k1 + k2), statistics.median(p1 + p2)
        dev, cold = (dk1 + dk2) / 2, (c1 + c2) / 2
        host = host_ms(kern)
        bps, splits = pa.split_plan(R, KV, T // bs, pa._sms(q.device))
        bound_ms, bound_by, nbytes, flops = paged_bound_ms(R, H, KV, D, T, 2)
        log(f"    {arch} R={R} H={H} KV={KV} D={D} block {bs} view {T} "
            f"bf16 ({splits} splits of {bps} blocks, {R * KV * splits} "
            f"blocks a launch): kernel back to back {ms:.4f} ms (turns "
            f"{statistics.median(k1):.4f}, {statistics.median(k2):.4f}), "
            f"device warm {dev:.4f} ms (turns {dk1:.4f}, {dk2:.4f}), cold "
            f"{cold:.4f} ms (turns {c1:.4f}, {c2:.4f}), host per call "
            f"{host:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
            f"ms ({bound_by}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} "
            f"GFLOP); no single library call")
        out["by_shape"][arch] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "device_ms": dev,
                                 "cold_ms": cold, "host_ms": host,
                                 "blocks": R * KV * splits}
        if arch == "smollm-135m":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, device_ms=dev, cold_ms=cold,
                       shape=f"R={R} H={H} KV={KV} D={D} bs={bs} view={T} "
                             f"bf16")
    return out


def moe_engine_run(api, params, attn_impl, pool_dtype, trace=None):
    """The continuous engine on a simulated clock (so admission is the
    same in every run) over 6 requests; returns the tokens, the logits
    of the active rows of every decode step, the decode steps and the
    paged-attention launches. With a list as ``trace``, every decode
    layer's MoE input and output (fp32 copies) are appended to it."""
    import dataclasses
    import functools

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import moe_model
    from repro_torch.serve import Scheduler, ServeEngine, synthetic_trace
    logits, step = [], api.decode_step
    moe_block = moe_model.moe_block

    def traced_moe(h, *args, **kw):
        y, aux = moe_block(h, *args, **kw)
        if h.shape[1] == 1:                     # a decode step's rows
            trace.append((h.float().clone(), y.float().clone()))
        return y, aux

    def record(params_, cache, tokens, **kw):
        out = step(params_, cache, tokens, **kw)
        active = cache["block_tables"][:, 0] != 0       # live slots own blocks
        logits.append(out[0][active].float())
        return out
    api = dataclasses.replace(
        api, decode_step=record,
        init_cache=functools.partial(api.init_cache, dtype=pool_dtype))
    requests = synthetic_trace(6, rate_rps=20.0, vocab=api.cfg.vocab_size,
                               prompt_lens=(128, 256, 512), max_new=8,
                               seed=0)
    engine = ServeEngine(api, params, max_active=4, view_len=528,
                         block_size=16, attn_impl=attn_impl)
    sched = Scheduler(requests, max_active=4, token_budget=4 * 528)
    pa.launches = 0
    if trace is not None:
        moe_model.moe_block = traced_moe
    try:
        engine.run(sched, cost_model=lambda kind, n: 1e-3)
    finally:
        moe_model.moe_block = moe_block
    tokens = {r.rid: list(r.generated) for r in sched.finished}
    return tokens, logits, engine.decode_steps, pa.launches


def trace_moe_departure(api, params, num_layers):
    """Where the bf16-pool engine through the paged kernel departs from
    the one through the gather path: both runs' decode-layer MoE inputs
    and outputs, compared call by call; prints the first calls whose
    input or output differs by more than 1e-2 and the per-layer
    differences of that decode step."""
    runs = []
    for impl in ("auto", "xla"):
        trace = []
        moe_engine_run(api, params, impl, torch.bfloat16, trace=trace)
        runs.append(trace)
    rows = []
    for i, ((hk, yk), (hx, yx)) in enumerate(zip(*runs)):
        rows.append((i // num_layers, i % num_layers,
                     (hk - hx).abs().max().item(),
                     (yk - yx).abs().max().item()))
    first = next((r for r in rows if max(r[2], r[3]) > 1e-2), None)
    log(f"    trace: {len(rows)} decode-layer MoE calls compared; first "
        f"past 1e-2: "
        + ("none" if first is None else
           f"step {first[0]} layer {first[1]} (input {first[2]:.3g}, "
           f"output {first[3]:.3g})"))
    if first is not None:
        for st, layer, dh, dy in rows:
            if st == first[0]:
                log(f"      step {st} layer {layer:2d}: MoE input max|diff| "
                    f"{dh:.3g}, output {dy:.3g}")
    return first


def phase_moe_model():
    """olmoe-1b-7b at full width and depth, fp32: prefill logits through
    the flash kernel vs plain attention (one flash launch per layer),
    then the continuous engine through the paged kernel vs through the
    gather path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models.registry import build_model
    cfg = get_config("olmoe-1b-7b")
    kern = build_model(cfg, compute_dtype=torch.float32, attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref")
    out = {}
    with torch.inference_mode():
        params = kern.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g)
        tokens = tokens.cuda()
        attention.launches = 0
        lk, _ = kern.prefill(params, tokens, 256)
        fa = attention.launches
        lp, _ = plain.prefill(params, tokens, 256)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
        log(f"[3c] olmoe-1b-7b full width/depth fp32 prefill (2x256): logits "
            f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
            f"tol {MODEL_TOL}); flash_attention launches {fa}")
        if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
            raise AssertionError(f"olmoe logits through the kernel differ by "
                                 f"{diff} > {MODEL_TOL}")
        if fa != cfg.num_layers:
            raise AssertionError(f"olmoe prefill launched flash_attention "
                                 f"{fa} times, expected {cfg.num_layers}")
        out["prefill_logit_diff"] = diff
        del lk, lp
        for pool_dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            kt, kl, steps, launches = moe_engine_run(kern, params, "auto",
                                                     pool_dtype)
            xt, xl, xsteps, xlaunches = moe_engine_run(kern, params, "xla",
                                                       pool_dtype)
            same = kt == xt
            n = min(len(kl), len(xl))
            ldiff = max(((a - b)[:, valid].abs().max().item()
                         for a, b in zip(kl[:n], xl[:n])
                         if a.shape == b.shape), default=float("inf"))
            name = str(pool_dtype)[6:]
            log(f"    engine over {name} pools, 6 requests, 8 new tokens: "
                f"paged kernel vs gather path tokens "
                f"{'equal' if same else 'DIFFER'}, active-row logits "
                f"max|diff| {ldiff:.3g} over {n} steps; decode steps "
                f"{steps}/{xsteps}, paged launches {launches}/{xlaunches} "
                f"({time.perf_counter() - t0:.1f}s)")
            out[f"engine_{name}"] = {"tokens_equal": same, "logit_diff": ldiff,
                                     "decode_steps": steps,
                                     "launches": launches}
            if launches != steps * cfg.num_layers or xlaunches != 0:
                raise AssertionError(f"paged launches {launches}/{xlaunches} "
                                     f"over {steps} steps, expected "
                                     f"{steps * cfg.num_layers}/0")
            if pool_dtype == torch.float32 and not (
                    same and len(kl) == len(xl) and ldiff <= MODEL_TOL):
                raise AssertionError(f"olmoe engine through the paged kernel "
                                     f"differs from the gather path: tokens "
                                     f"equal {same}, logits {ldiff}")
            if pool_dtype == torch.bfloat16:
                # the kernel rounds q and P where the gather path does; the
                # gather path run again gives the run-to-run floor (the
                # MoE combine's index_add_ sums with atomics)
                _, xl2, _, _ = moe_engine_run(kern, params, "xla", pool_dtype)
                floor = max(((a - b)[:, valid].abs().max().item()
                             for a, b in zip(xl, xl2) if a.shape == b.shape),
                            default=float("inf"))
                out[f"engine_{name}"]["gather_vs_gather_logit_diff"] = floor
                log(f"    bf16 pools: logits max|diff| {ldiff:.3g} (PR 14, "
                    f"before the kernel rounded as the gather path: "
                    f"{BF16_LOGIT_DIFF_PR14}); the gather path against "
                    f"itself {floor:.3g}")
                if ldiff > 0.05:
                    out[f"engine_{name}"]["first_departure"] = \
                        trace_moe_departure(kern, params, cfg.num_layers)
                if not (same and len(kl) == len(xl)):
                    raise AssertionError(f"olmoe engine over bf16 pools "
                                         f"through the paged kernel gives "
                                         f"other tokens than the gather "
                                         f"path")
    del params
    torch.cuda.empty_cache()
    return out


def phase_ssm_model(arch: str, batch: int):
    """Full-width, full-depth fp32 prefill logits of an SSM-family model
    through the kernels (``"auto"``) against the plain chunked SSD oracle
    (``ssd_impl="xla"``) and, for the hybrid, plain attention
    (``attn_impl="ref"``); both counts are zeroed just before the kernel
    prefill and read just after: one ssd launch per SSM layer and one
    flash-attention launch per shared-attention application."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention, ssd_scan
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    kern = build_model(cfg, compute_dtype=torch.float32, ssd_impl="auto",
                       attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, ssd_impl="xla",
                        attn_impl="ref")
    want = {"ssd_chunk": cfg.num_layers,
            "flash_attention": (cfg.num_layers // cfg.attn_every
                                if hybrid else 0)}
    with torch.inference_mode():
        params = kern.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, 512), generator=g)
        tokens = tokens.cuda()
        ssd_scan.launches = attention.launches = 0
        lk, ck = kern.prefill(params, tokens, 512)
        got = {"ssd_chunk": ssd_scan.launches,
               "flash_attention": attention.launches}
        lp, cp = plain.prefill(params, tokens, 512)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
        state = ck["ssm"] if hybrid else ck
        state_p = cp["ssm"] if hybrid else cp
        sdiff = (state["ssd"] - state_p["ssd"]).abs().max().item()
    log(f"[3b] {arch} full width/depth fp32 prefill ({batch}x512): logits "
        f"kernel vs plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, "
        f"tol {MODEL_TOL}); decode state max|diff| {sdiff:.3g}; "
        f"launches {got}")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"{arch} logits through the kernels differ by "
                             f"{diff} > {MODEL_TOL}")
    if got != want:
        raise AssertionError(f"{arch} prefill launched {got}, expected "
                             f"{want}")
    del params, lk, lp, ck, cp
    torch.cuda.empty_cache()
    return diff


def phase_encdec_model():
    """[3] whisper-large-v3 at full width and depth, fp32: the prefill of
    2 x 64 tokens over 2 x 1500 frames through the flash kernel
    (``attn_impl="auto"``: the encoder's non-causal self-attention and
    the decoder's causal one) against plain attention (``"ref"``);
    logits and the cross KV compared, the launches of the kernel prefill
    (zeroed just before it, read just after) one a self-attention layer,
    none for cross-attention, which is plain in both."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models.registry import build_model
    cfg = get_config("whisper-large-v3")
    kern = build_model(cfg, compute_dtype=torch.float32, attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, attn_impl="ref")
    want = cfg.encoder_layers + cfg.num_layers
    with torch.inference_mode():
        params = kern.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                               device="cuda")
        audio = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g,
                            device="cuda").to(torch.bfloat16)
        attention.launches = 0
        lk, ck = kern.prefill(params, tokens, 96, audio=audio)
        got = attention.launches
        lp, cp = plain.prefill(params, tokens, 96, audio=audio)
        torch.cuda.synchronize()
        valid = slice(0, cfg.vocab_size)
        diff = (lk[..., valid] - lp[..., valid]).abs().max().item()
        scale = lp[..., valid].abs().max().item()
        xdiff = max((ck[n].float() - cp[n].float()).abs().max().item()
                    for n in ("xk", "xv"))
    log(f"[3] whisper-large-v3 full width/depth fp32 prefill (2x64 tokens, "
        f"2x{cfg.encoder_seq} frames): logits kernel vs plain max|diff| "
        f"{diff:.3g} (max|logit| {scale:.3g}, tol {MODEL_TOL}); bf16 cross "
        f"KV max|diff| {xdiff:.3g}; flash launches {got} (expected {want}:"
        f" {cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
        f"self-attention, cross-attention plain)")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"whisper logits through the kernel differ by "
                             f"{diff} > {MODEL_TOL}")
    if got != want:
        raise AssertionError(f"whisper prefill launched {got}, expected "
                             f"{want}")
    del params, lk, lp, ck, cp
    torch.cuda.empty_cache()
    return diff, got


def phase_vlm_model():
    """[3v] llava-next-mistral-7b at full width and depth, fp32:
    ``vlm.prefill`` over 1 x (2880 patches + 128 tokens) through the
    flash kernel against plain attention; logits compared, the launches
    one a layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import vlm
    from repro_torch.models.registry import build_model
    cfg = get_config("llava-next-mistral-7b")
    api = build_model(cfg, compute_dtype=torch.float32)
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator(device="cuda").manual_seed(1)
        batch = {"patches": torch.randn(
            (1, cfg.num_patches, cfg.d_model), generator=g,
            device="cuda").to(torch.bfloat16),
            "tokens": torch.randint(0, cfg.vocab_size,
                                    (1, LLAVA_PREFIX - cfg.num_patches),
                                    generator=g, device="cuda")}
        attention.launches = 0
        lk, _ = vlm.prefill(params, batch, cfg, LLAVA_PREFIX,
                            compute_dtype=torch.float32, attn_impl="auto")
        got = attention.launches
        lp, _ = vlm.prefill(params, batch, cfg, LLAVA_PREFIX,
                            compute_dtype=torch.float32, attn_impl="ref")
        torch.cuda.synchronize()
        diff = (lk - lp).abs().max().item()
        scale = lp.abs().max().item()
    log(f"[3v] llava-next-mistral-7b full width/depth fp32 vlm.prefill "
        f"(1x({cfg.num_patches} patches + "
        f"{LLAVA_PREFIX - cfg.num_patches} tokens)): logits kernel vs "
        f"plain max|diff| {diff:.3g} (max|logit| {scale:.3g}, tol "
        f"{MODEL_TOL}); flash launches {got} (expected {cfg.num_layers})")
    if not (torch.isfinite(lk).all() and diff <= MODEL_TOL):
        raise AssertionError(f"llava logits through the kernel differ by "
                             f"{diff} > {MODEL_TOL}")
    if got != cfg.num_layers:
        raise AssertionError(f"llava prefill launched {got}, expected "
                             f"{cfg.num_layers}")
    del params, lk, lp
    torch.cuda.empty_cache()
    return diff, got


# ---------------------------------------------------------------------------
# [3t] gradients with the kernels inside the models
# ---------------------------------------------------------------------------
# the kernels' loss and gradients against the plain versions', fp32: the
# loss within 1e-5 (relative); each leaf's gradient within 1e-3 (relative
# 2-norm): the SSD kernels' fp32 tolerance (5e-5) through 6-24 layers of
# forward and backward, as MODEL_TOL is for the logits
GRAD_MODEL_TOL = 1e-3
GRAD_LOSS_TOL = 1e-5


def leaf_names(tree, prefix=""):
    """Dotted paths of the leaves in ``pytree.flatten``'s order (dicts by
    sorted key, lists in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def phase_train_grads(arch, config=None, batch=2, seq=256):
    """Loss and every leaf's gradient of ``arch`` at full width (depth cut
    by ``config``), fp32, one process: ``ssd_impl``/``attn_impl="auto"``
    (the SSD and flash kernels, forward and backward) against
    ``"xla"``/``"ref"`` (plain PyTorch under autograd); the launches of
    the kernels' call zeroed just before it and read just after: one
    SSD forward a mamba layer, one flash forward an attention layer (a
    shared application; every self-attention layer of the VLM and
    enc-dec families), each with its backward's launches."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_to_tensors
    from repro_torch.kernels import attention_bwd, ssd_scan_bwd
    from repro_torch.models.registry import build_model, make_train_batch
    cfg = get_config(arch).replace(**(config or {}))
    kern = build_model(cfg, compute_dtype=torch.float32, ssd_impl="auto",
                       attn_impl="auto")
    plain = build_model(cfg, compute_dtype=torch.float32, ssd_impl="xla",
                        attn_impl="ref")
    n_ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = {"hybrid": cfg.num_layers // max(cfg.attn_every, 1),
              "ssm": 0, "encdec": cfg.encoder_layers + cfg.num_layers
              }.get(cfg.family, cfg.num_layers)
    want = {"ssd_chunk": n_ssd,
            "ssd_chunk_bwd": n_ssd
            * ssd_scan_bwd.LAUNCHES_PER_CALL[torch.float32],
            "flash_attention": n_attn,
            "flash_attention_bwd": n_attn * attention_bwd.LAUNCHES_PER_CALL}
    params = kern.init(torch.Generator(device="cuda").manual_seed(0))
    shape = ShapeConfig(name="grad", seq_len=seq, global_batch=batch,
                        kind="train")
    data = batch_to_tensors(make_train_batch(cfg, shape, seed=1), "cuda")

    def loss_and_grads(api):
        leaves, treedef = pytree.flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, _ = api.loss(treedef.unflatten(leaves), data)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.item(), grads

    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    lk, gk = loss_and_grads(kern)
    t_kern = time.perf_counter() - t0
    got = {name: counters[name].launches for name in want}
    t0 = time.perf_counter()
    lp, gp = loss_and_grads(plain)
    t_plain = time.perf_counter() - t0
    worst, worst_leaf = 0.0, None
    for i, (a, b) in enumerate(zip(gk, gp)):
        num, den = (a.double() - b.double()).norm().item(), \
            b.double().norm().item()
        r = num / den if den else (0.0 if num == 0 else float("inf"))
        if not torch.isfinite(a).all():
            r = float("inf")
        if r >= worst:
            worst, worst_leaf = r, i
    loss_rel = abs(lk - lp) / abs(lp)
    where = leaf_names(params)[worst_leaf]
    depth = f"{cfg.encoder_layers} + {cfg.num_layers}" \
        if cfg.family == "encdec" else cfg.num_layers
    log(f"[3t] {arch} full width, {depth} layers, fp32 loss and "
        f"gradients ({batch}x{seq}; {len(gk)} leaves, "
        f"{sum(t.numel() for t in gk)} elements): loss kernels {lk:.6f} "
        f"plain {lp:.6f} (relative {loss_rel:.3g}, tol {GRAD_LOSS_TOL}); "
        f"worst leaf's gradient {worst:.3g} ({where}; relative 2-norm, tol "
        f"{GRAD_MODEL_TOL}); launches {got}; {t_kern:.2f}s with the "
        f"kernels, {t_plain:.2f}s plain (first calls)")
    if got != want:
        raise AssertionError(f"[3t] {arch} launched {got}, expected {want}")
    if loss_rel > GRAD_LOSS_TOL or worst > GRAD_MODEL_TOL:
        raise AssertionError(f"[3t] {arch} gradients through the kernels "
                             f"depart from the plain versions: loss "
                             f"{loss_rel}, worst leaf {worst}")
    del params, gk, gp
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "worst_leaf_rel": worst,
            "layers": cfg.num_layers, "launches": got}


def _counters():
    from repro_torch.kernels import attention, attention_bwd, \
        paged_attention, segment_reduce, ssd_scan, ssd_scan_bwd
    return {"flash_attention": attention,
            "flash_attention_bwd": attention_bwd, "ssd_chunk": ssd_scan,
            "ssd_chunk_bwd": ssd_scan_bwd,
            "segment_combine": segment_reduce,
            "paged_attention": paged_attention}


def serve_path(label, argv, expect):
    """Serve once through the CLI with every launch count zeroed just
    before and read just after; ``expect`` is kernel -> launches (a
    number, or a function of the run's result: the paged kernel's count
    follows the decode steps), and a kernel it does not name must not
    launch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    vocab = get_config(argv[argv.index("--arch") + 1]).vocab_size
    log(f"[4] {label}: serve {' '.join(argv)}")
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res = serve.main(argv)
    wall = time.perf_counter() - t0
    got = {name: mod.launches for name, mod in counters.items()}
    want = {name: expect.get(name, 0) for name in counters}
    want = {name: n(res) if callable(n) else n for name, n in want.items()}
    if "tokens" in res:
        toks = res["tokens"]
        log(f"    prefill {res['prefill_s']:.4f}s, {res['tok_per_s']:.1f} "
            f"tok/s, per-token p50 {res['token_ms_p50']:.3f} p90 "
            f"{res['token_ms_p90']:.3f} p99 {res['token_ms_p99']:.3f} ms; "
            f"launches {got}; {wall:.1f}s with set-up")
        B, gen = int(argv[argv.index("--batch") + 1]), \
            int(argv[argv.index("--gen") + 1])
        if toks.shape != (B, gen) or toks.min() < 0 or \
                toks.max() >= vocab:
            raise AssertionError(f"{label}: bad generated tokens "
                                 f"{toks.shape}")
    else:
        gen, max_new = res["generated"], res["max_new"]
        log(f"    served {len(gen)} requests, {res['new_tokens']} tokens, "
            f"{res['tok_per_s']:.1f} tok/s, per-token p50 "
            f"{res['token_ms_p50']:.3f} p90 {res['token_ms_p90']:.3f} p99 "
            f"{res['token_ms_p99']:.3f} ms, wall {res['wall_s']:.2f}s, "
            f"{res['decode_steps']} decode steps; launches {got}; "
            f"{wall:.1f}s with set-up")
        n_req = int(argv[argv.index("--num-requests") + 1])
        if len(gen) != n_req or any(len(gen[r]) != max_new[r]
                                    for r in max_new):
            raise AssertionError(f"{label}: not every request got its "
                                 f"max_new tokens")
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected "
                             f"{want}")
    return got, res


# smollm-135m's and mamba2-130m's serving argv ([4]; smollm's also [4t],
# held to [4]'s run): fixed 8 x 512 prompts; continuous Poisson requests
# at 20 a second, 8 slots. New tokens 64 -> 32 and requests 32 -> 16 in
# PR 26 for the script's time
SERVE_NEW_TOKENS = 32
SERVE_REQUESTS = 16
SERVE_FIXED = ["--prompt-len", "512", "--gen", str(SERVE_NEW_TOKENS),
               "--batch", "8"]
SERVE_CONTINUOUS = ["--continuous", "--num-requests", str(SERVE_REQUESTS),
                    "--poisson-rate", "20", "--prompt-len", "512", "--gen",
                    str(SERVE_NEW_TOKENS), "--max-active", "8",
                    "--block-size", "16"]


def per_step(n_attention):
    """Expected paged-attention launches of a continuous path: one per
    attention application for every decode step of the engine."""
    return lambda res: res["decode_steps"] * n_attention


def serving_paths():
    """(label, argv, expected launches) of every serving path: one
    launch per attention layer (flash_attention) or SSM layer
    (ssd_chunk) for every prefill, and one paged_attention launch per
    attention layer for every decode step of the continuous engine."""
    fixed, cont = SERVE_FIXED, SERVE_CONTINUOUS
    z_fixed = ["--prompt-len", "512", "--gen", "16", "--batch", "4"]
    z_cont = ["--continuous", "--num-requests", "8", "--poisson-rate", "20",
              "--prompt-len", "512", "--gen", "16", "--max-active", "4",
              "--block-size", "16"]
    w_fixed = ["--prompt-len", "64", "--gen", "32", "--batch", "4"]
    w_cont = ["--continuous", "--num-requests", "8", "--poisson-rate", "20",
              "--prompt-len", "64", "--gen", "32", "--max-active", "4",
              "--block-size", "16"]
    return [
        ("smollm_fixed", ["--arch", "smollm-135m", *fixed],
         {"flash_attention": 30}),
        ("smollm_continuous", ["--arch", "smollm-135m", *cont],
         {"flash_attention": SERVE_REQUESTS * 30,
          "paged_attention": per_step(30)}),
        ("mamba2_fixed", ["--arch", "mamba2-130m", *fixed],
         {"ssd_chunk": 24}),
        ("mamba2_continuous", ["--arch", "mamba2-130m", *cont],
         {"ssd_chunk": SERVE_REQUESTS * 24}),
        ("zamba2_fixed", ["--arch", "zamba2-2.7b", *z_fixed],
         {"ssd_chunk": 54, "flash_attention": 9}),
        ("zamba2_continuous", ["--arch", "zamba2-2.7b", *z_cont],
         {"ssd_chunk": 8 * 54, "flash_attention": 8 * 9,
          "paged_attention": per_step(9)}),
        # olmoe: 6.92B fp32 parameters; cut like zamba2
        ("olmoe_fixed", ["--arch", "olmoe-1b-7b", *z_fixed],
         {"flash_attention": 16}),
        ("olmoe_continuous", ["--arch", "olmoe-1b-7b", *z_cont],
         {"flash_attention": 8 * 16, "paged_attention": per_step(16)}),
        # whisper: each prefill encodes its 1500 frames (32 encoder
        # layers) and runs the prompt (32 decoder layers); decode reads
        # the paged self-attention KV, the cross KV plainly
        ("whisper_fixed", ["--arch", "whisper-large-v3", *w_fixed],
         {"flash_attention": 64}),
        ("whisper_continuous", ["--arch", "whisper-large-v3", *w_cont],
         {"flash_attention": 8 * 64, "paged_attention": per_step(32)}),
        # llava: 7.24B fp32 parameters, text prompts through the dense
        # family's prefill; cut like zamba2, the fixed batch to 2
        ("llava_fixed", ["--arch", "llava-next-mistral-7b", "--prompt-len",
                         "512", "--gen", "16", "--batch", "2"],
         {"flash_attention": 32}),
        ("llava_continuous", ["--arch", "llava-next-mistral-7b", *z_cont],
         {"flash_attention": 8 * 32, "paged_attention": per_step(32)}),
    ]


# the device-side names of the port's kernels (csrc/*.cu)
PORT_KERNELS = ("fa_fwd", "ssd_chunk", "ssd_chunk_mma", "combine_kernel",
                "pa_scores", "pa_pv")


def paged_cache(cache, bs=16):
    """A dense decode cache in the engine's paged form: each layer's K and
    V cut into ``bs``-slot pool blocks behind a null block 0, one table
    row per batch row, per-row lengths; any other state as it is."""
    k = cache["k"]
    layers, B, T, KV, D = k.shape
    nb = T // bs

    def pool(x):
        blocks = x.reshape(layers, B * nb, bs, KV, D)
        return torch.cat([torch.zeros_like(blocks[:, :1]), blocks], dim=1)
    tables = 1 + torch.arange(B * nb, dtype=torch.int32,
                              device=k.device).reshape(B, nb)
    rest = {n: x for n, x in cache.items() if n not in ("k", "v", "length")}
    return {**rest, "k_pool": pool(k), "v_pool": pool(cache["v"]),
            "block_tables": tables,
            "length": torch.full((B,), int(cache["length"]),
                                 dtype=torch.long, device=k.device)}


def phase_breakdown(arch, B, S):
    """Where a fixed-batch path's time goes: torch.profiler over one
    full-width bf16 prefill (B x S) and over 3 decode steps, and, for a
    family with a KV cache, over 3 decode steps through the same cache
    in the continuous engine's paged form (the paged kernel's path); the
    device's busy share of the wall time, the kernels that fill it, and
    the port's own kernels wherever they rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    api = build_model(cfg)
    out = {}
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(0))
        g = torch.Generator().manual_seed(2)
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g).cuda()
        logits, cache = api.prefill(params, prompt, S + 64)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        api.decode_step(params, cache, tok)
        runs = [("prefill", 1, lambda: api.prefill(params, prompt, S + 64)),
                ("decode", 3, lambda: api.decode_step(params, cache, tok))]
        if "k" in cache:
            pcache = paged_cache(cache)
            api.decode_step(params, pcache, tok)
            runs.append(("paged decode", 3,
                         lambda: api.decode_step(params, pcache, tok)))
        torch.cuda.synchronize()
        for name, reps, fn in runs:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / reps
            by_kernel = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
                        e.time_range.elapsed_us() / 1e3 / reps
            busy = sum(by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
            n_kernels = sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA) // reps
            out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                         "kernels_per_call": n_kernels,
                         "top": [(k[:60], v) for k, v in top]}
            share = f"{busy / wall_ms:.3f}" if busy else "not measured"
            log(f"[5] {arch} {name} (batch {B}, prompt {S}): wall "
                f"{wall_ms:.3f} ms/call, device busy {busy:.3f} ms/call "
                f"(share {share}), {n_kernels} kernels")
            for k, v in top:
                log(f"      {v:9.4f} ms  {k[:90]}")
            # the port's own kernels, wherever they rank
            ours = {k: v for k, v in by_kernel.items()
                    if any(n in k for n in PORT_KERNELS)}
            out[name]["port_kernels"] = {k[:60]: v for k, v in ours.items()}
            for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
                if (k[:60], v) not in out[name]["top"]:
                    log(f"      {v:9.4f} ms  {k[:90]} (a port kernel)")
    del params, cache, runs
    torch.cuda.empty_cache()
    return out


def expected_combines(op, key, p):
    """segment_combine launches of one run of ``key`` ("algorithm/
    segments") summed over the p ranks, from its schedule
    (``measure_collectives.combines_per_rank``: ring g(p-1) per rank and
    segment count g, recursive doubling and Rabenseifner log2(p) per
    rank, the binomial reduce of reduce_bcast p-1 in all, a synthesized
    program its reduce steps per rank, allgather_reduce none; broadcast
    and all-gather none)."""
    from repro_torch.launch import measure_collectives as mc
    algo, segs = key.rsplit("/", 1)
    return int(p * mc.combines_per_rank(op, algo, int(segs), p))


def check_grad_sync(gs, world, tag):
    """The launcher's gradient-sync variants, held again here: the
    oracle error within 2e-4, the recorded spans equal to the plan, the
    traced run's bits equal to the untraced one's, and the launches,
    summed over the ``world`` ranks, equal to the runs times what the
    plan's phases imply (recounted here entry by entry). Returns the
    launch counts by path."""
    from repro_torch.launch import measure_collectives as mc
    paths = {}
    for label, v in gs["variants"].items():
        per_run = 0
        for key, n in v["plan"].items():
            op, algo, segs, p = key.split("/")
            per_run += n * world // int(p) * expected_combines(
                op, f"{algo}/{segs}", int(p))
        got = v["launches"]["segment_combine"]
        log(f"    {tag} {label}: {v['plan_entries']} plan entries "
            f"({v['describe']}), s per run "
            f"{' '.join(f'{t:.4f}' for t in v['seconds'])}, max|err| vs "
            f"the float64 mean {v['max_abs_err']:.3g}; segment_combine "
            f"{got} over {v['runs']} runs, plan {per_run} a run"
            + (f"; {v['buckets_bit_equal']}/{v['buckets']} buckets "
               f"bit-equal to their sequential composition, "
               f"{v['vs_per_leaf_max_abs']:.3g} from per leaf"
               if "buckets" in v else ""))
        log(f"      rank 0's traced run {v['recorded_s']:.4f} s, in its "
            f"collectives: " + ", ".join(
                f"{k} {t:.4f}" for k, t in sorted(v["span_s"].items())))
        if not (v["max_abs_err"] <= mc.GRAD_TOL and v["plan_matches_spans"]
                and v["trace_bits_equal"] and per_run == v["plan_combines"]
                and got == v["runs"] * per_run
                and v["launches"]["flash_attention"] == 0
                and v["launches"]["ssd_chunk"] == 0
                and v.get("buckets_bit_equal") == v.get("buckets")
                and v.get("vs_per_leaf_max_abs", 0.0) <= mc.GRAD_TOL):
            raise AssertionError(f"{tag} {label}: {v}")
        paths[f"{tag}_{label}"] = v["launches"]
    return paths


def gradient_elems(num_layers=None):
    """smollm-135m's parameter count, from the port's model (cut to
    ``num_layers`` layers)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config("smollm-135m")
    api = build_model(cfg.replace(num_layers=num_layers) if num_layers
                      else cfg)
    with torch.inference_mode():
        params = api.init(torch.Generator(device="cuda").manual_seed(0))

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(count(v) for v in t)
        return t.numel()
    n = count(params)
    del params
    torch.cuda.empty_cache()
    return n


def phase_collectives(ranks=RANKS):
    """measure_collectives at ``ranks`` processes on the card, with the
    oracle check and the gradient all-reduce; returns the result and the
    launch counts by path."""
    from repro_torch.core.tuning import DecisionTable
    from repro_torch.launch import measure_collectives as mc
    n_grad = gradient_elems()
    out_path = os.path.join(ROOT, "device_measured_decision.json")
    argv = ["--ranks", str(ranks), "--check", "--grad-elems", str(n_grad),
            "--trials", str(TUNE_TRIALS), "--out", out_path]
    log(f"[6] measure_collectives {' '.join(argv)}")
    t0 = time.perf_counter()
    res = mc.main(argv)
    wall = time.perf_counter() - t0
    chk = res["check"]
    worst = max(chk["max_abs_err"].items(), key=lambda kv: kv[1])
    log(f"    check: {len(chk['max_abs_err'])} cases (every algorithm and "
        f"synthesized program, n {mc.CHECK_ELEMS}), max|err| vs oracle "
        f"{worst[1]:.3g} ({worst[0]}; tol {mc.TOL}); launches "
        f"{chk['launches']}")
    if res["device"] != "cuda:0" or res["ranks"] != ranks:
        raise AssertionError(f"ran on {res['device']} x {res['ranks']}")

    # launches of the tuning run, zeroed just before it and read after
    got, runs = res["launches_by_method"], res["runs_by_method"]
    for key, n_runs in sorted(runs.items()):
        op, k = key.split("/", 1)
        want = n_runs // ranks * expected_combines(op, k, ranks)
        if got.get(key, 0) != want:
            raise AssertionError(f"{key}: {got.get(key)} segment_combine "
                                 f"launches over {n_runs} rank-runs, "
                                 f"expected {want}")
    reducing = [k for k in runs if expected_combines(
        k.split("/", 1)[0], k.split("/", 1)[1], ranks)]
    if not reducing or any(got[k] <= 0 for k in reducing):
        raise AssertionError("a reducing algorithm never launched the "
                             "kernel")
    if res["launches"]["segment_combine"] != sum(got.values()) or \
            res["launches"]["flash_attention"] or res["launches"]["ssd_chunk"]:
        raise AssertionError(f"tuning run launches {res['launches']}")
    by_point = {}
    for key, t in res["means"].items():
        op, _, m, algo, segs = key.split("/")
        by_point.setdefault((op, int(m)), []).append((t, f"{algo}/s{segs}"))
    for (op, m), row in sorted(by_point.items()):
        log(f"    {op} {m} B, ms (mean of the trials, each the slowest "
            f"rank's): "
            + ", ".join(f"{a} {1e3 * t:.3f}" for t, a in sorted(row)))
    log(f"    tuning: {res['samples']} samples in "
        f"{res['tune_seconds']:.1f}s; segment_combine launches "
        f"{res['launches']['segment_combine']} over {len(reducing)} "
        f"reducing candidates, each as its schedule says")

    # the artifact, loaded back: the measured argmin at every point
    table = DecisionTable.load(out_path)
    if table.meta.backend != "DeviceBackend" or len(table.table) != \
            len(res["best"]):
        raise AssertionError(f"artifact {out_path}: {table.meta}")
    for op, m, algo, segs, _ in res["best"]:
        meth = table.decide(op, ranks, m)
        if (meth.algorithm, meth.segments) != (algo, segs):
            raise AssertionError(f"artifact row {op} {m}: {meth}")
    log(f"    {out_path} loaded back: {len(table.table)} rows, backend "
        f"{table.meta.backend}, {len(table.meta.programs or ())} programs")

    gs = res["grad_sync"]
    log(f"    gradient sync through the Communicator, mesh {gs['mesh']}, "
        f"{gs['elems']} fp32 elements ({gs['bytes'] / 1e6:.1f} MB)")
    if gs["mesh"] != {"data": ranks} or list(gs["variants"]) != \
            ["per_leaf", "xla"]:
        raise AssertionError(f"gradient sync ran {gs['mesh']} "
                             f"{list(gs['variants'])}")
    paths = check_grad_sync(gs, ranks, "grad_sync")
    log(f"    {wall:.1f}s with set-up")
    res["wall_s"] = wall
    paths.update({"measure_collectives_tune": res["launches"],
                  "measure_collectives_check": chk["launches"]})
    return res, paths


#: the Communicator phase: (path, topology, committed artifact, variants)
#: [7]'s tree: smollm-135m at full width cut to 10 of its 30 layers
#: (92,024,640 fp32 elements, 93 leaves) in PR 26 for the script's time
COMM_GRAD_LAYERS = 5
COMMUNICATOR_PATHS = (
    ("comm_2x2", "2x2", "hierarchical_decision.json",
     ["per_leaf", "xla"]),
    ("comm_2x2x2", "2x2x2", "hierarchical_decision_3level.json",
     ["per_leaf", "bucketed", "xla"]),
)


def communicator_run(tag, topo, artifact, variants, n_params, probe=False):
    """One ``measure_collectives --tuning-table`` run of smollm-135m's
    fp32 gradient tree at ``COMM_GRAD_LAYERS`` layers (``n_params``
    elements, as `gradient_elems` counts them) on the ``topo`` mesh, each
    variant checked; returns the
    launcher's gradient-sync result, its summary and the launch counts
    by path."""
    from repro_torch.launch import measure_collectives as mc
    argv = ["--topology", topo, "--tuning-table", artifact,
            "--grad-arch", "smollm-135m", "--grad-layers",
            str(COMM_GRAD_LAYERS)]
    if probe:
        argv.append("--probe-fabric")
    log(f"[7] measure_collectives {' '.join(argv)}")
    t0 = time.perf_counter()
    res = mc.main(argv)
    wall = time.perf_counter() - t0
    gs = res["grad_sync"]
    world = 1
    for n in gs["mesh"].values():
        world *= n
    if res["device"] != "cuda:0" or res["ranks"] != world or \
            list(gs["variants"]) != variants or gs["arch"] != \
            "smollm-135m" or gs["elems"] != n_params:
        raise AssertionError(f"{tag}: ran {res['device']} x "
                             f"{res['ranks']}, {gs['elems']} elements, "
                             f"variants {list(gs['variants'])}")
    if "probed" in res:
        for line in res["probed"].splitlines():
            log(f"    {line}")
    log(f"    {tag}: mesh {gs['mesh']}, {gs['leaves']} leaves, "
        f"{gs['elems']} fp32 elements ({gs['bytes'] / 1e6:.1f} MB); "
        f"{gs['describe']}; slot -> rank {gs['slots']}")
    paths = check_grad_sync(gs, world, tag)
    log(f"    {wall:.1f}s with set-up")
    summary = {"wall_s": wall, "mesh": gs["mesh"], "leaves": gs["leaves"],
               "probed": res.get("probed"), "slots": gs["slots"],
               "mapping": gs["mapping"],
               "variants": {k: {kk: v[kk] for kk in (
                   "seconds", "max_abs_err", "plan_entries",
                   "plan_combines", "runs", "launches", "buckets",
                   "vs_per_leaf_max_abs", "recorded_s", "span_s")
                   if kk in v}
                   for k, v in gs["variants"].items()}}
    return gs, summary, paths


def phase_communicator(n_params):
    """smollm-135m's fp32 gradient tree (``COMM_GRAD_LAYERS`` layers)
    through the tuned Communicator on the 2x2 and 2x2x2 meshes (``measure_collectives
    --tuning-table``), each variant checked and timed; returns the
    results and the launch counts by path."""
    out, paths = {}, {}
    for tag, topo, artifact, variants in COMMUNICATOR_PATHS:
        gs, out[tag], got = communicator_run(
            tag, topo, os.path.join(ROOT, "examples", "artifacts", artifact),
            variants, n_params, probe=topo == "2x2")
        if gs["mapping"] is not None or gs["slots"] != list(range(len(
                gs["slots"]))):
            raise AssertionError(f"{tag}: a committed artifact remapped "
                                 f"the mesh: {gs['slots']}")
        paths.update(got)
    return out, paths


# ---------------------------------------------------------------------------
# [6b] every tuner family from the card's measurements
# ---------------------------------------------------------------------------
#: the families that measure afresh (``session.fresh_sample``)
ADAPTIVE_TUNERS = ("star", "feedback")


def phase_tuners(ranks=RANKS):
    """``measure_collectives --tuners all`` at ``ranks`` processes on the
    card, over [6]'s ops and sizes: every family fitted over the one
    measured session, each with its launch counts zeroed just before its
    fit and read just after. Returns the per-family results and the
    launch counts by path."""
    import tempfile
    from repro_torch.core.tuning import TUNERS, DecisionTable
    from repro_torch.launch import measure_collectives as mc
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "tuners_measured_decision.json")
        argv = ["--ranks", str(ranks), "--tuners", "all", "--trials",
                str(TUNE_TRIALS), "--sizes", *map(str, TUNER_SIZES),
                "--out", out_path]
        log(f"[6b] measure_collectives {' '.join(argv[:-2])}")
        t0 = time.perf_counter()
        res = mc.main(argv)
        wall = time.perf_counter() - t0
        table = DecisionTable.load(out_path)
    fams = res["families"]
    if res["device"] != "cuda:0" or res["ranks"] != ranks or \
            [f["name"] for f in fams] != list(TUNERS) or \
            table.meta.tuner != res["tuner"] or \
            table.meta.backend != "DeviceBackend":
        raise AssertionError(f"[6b] ran {res['device']} x {res['ranks']}, "
                             f"families {[f['name'] for f in fams]}, "
                             f"table {table.meta}")
    log(f"    {res['samples']} samples, {res['n_experiments']} experiments "
        f"in {res['tune_seconds']:.1f}s (ranks of one card); sizes "
        f"{list(TUNER_SIZES)} B, ops {list(mc.OPS)}")
    log(f"    {'tuner':14s} {'new exps':>9s} {'cache hits':>11s} "
        f"{'penalty':>9s} {'seconds':>8s} {'segment_combine':>16s}")
    paths = {}
    for f in fams:
        got = f["launches"]["segment_combine"]
        want = 0
        for key, n_runs in f["runs_by_method"].items():
            op, k = key.split("/", 1)
            want += n_runs // ranks * expected_combines(op, k, ranks)
        log(f"    {f['name']:14s} {f['n_experiments']:9d} "
            f"{f['cache_hits']:11d} {f['penalty'] * 100:8.2f}% "
            f"{f['seconds']:8.2f} {got:16d}")
        ok = (f["same_table_on_every_rank"] and got == want
              and got == sum(f["launches_by_method"].values())
              and f["launches"]["flash_attention"] == 0
              and f["launches"]["ssd_chunk"] == 0)
        if f["n_experiments"] == 0:
            ok = ok and got == 0 and not f["runs_by_method"]
        if f["name"] in ADAPTIVE_TUNERS:
            ok = ok and f["n_experiments"] > 0 and got > 0
        if not ok:
            raise AssertionError(f"[6b] {f['name']}: launches {got}, the "
                                 f"runs' schedules imply {want}: {f}")
        paths[f"tuner_{f['name']}"] = f["launches"]
    log(f"    best: {res['tuner']} ({res['penalty'] * 100:.2f}%); every "
        f"rank ended with the same table for every family; {wall:.1f}s "
        f"with set-up")
    return {"wall_s": wall, "tune_seconds": res["tune_seconds"],
            "samples": res["samples"], "best": res["tuner"],
            "families": [{k: f[k] for k in (
                "name", "n_experiments", "cache_hits", "penalty", "seconds",
                "launches")} for f in fams]}, paths


# ---------------------------------------------------------------------------
# [7d] the gradient tree through a remapped mesh
# ---------------------------------------------------------------------------
def mapped_artifact(path):
    """``hierarchical_decision_3level.json`` with the first non-identity
    candidate of ``enumerate_mappings`` on 2x2x2 stamped into every
    level's meta, written to ``path``; returns the mapping."""
    from repro_torch.core.topology import (
        HierarchicalDecision, Topology, enumerate_mappings, load_decision)
    from repro_torch.core.tuning.decision import TableMeta
    axes, shape = ("dcn", "pod", "data"), (2, 2, 2)
    remap = next(c for c in enumerate_mappings(
        Topology.from_spec("2x2x2"), axes, shape) if not c.is_identity)
    hier = load_decision(os.path.join(
        ROOT, "examples", "artifacts", "hierarchical_decision_3level.json"))
    if not isinstance(hier, HierarchicalDecision):
        raise AssertionError(f"3-level artifact loads as "
                             f"{type(hier).__name__}")
    for _, table in hier.levels:
        if table.meta is None:
            table.meta = TableMeta()
        table.meta.mapping = remap.to_json()
    hier.save(path)
    return remap


def phase_remapped(n_params, identity_bucketed):
    """[7b]'s tree and artifact through a mesh rebuilt in a mapping's
    rank order, bucketed at the artifact's schedule, checked as [7]
    checks; the placement sweep of ``tune_topology`` on the simulator;
    returns the summary and the launch counts by path."""
    import tempfile
    from repro_torch.core.topology import MeshMapping, Topology, tune_topology
    from repro_torch.core.tuning.space import DECODE_MESSAGE_SIZES
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mapped_3level.json")
        remap = mapped_artifact(path)
        log(f"[7d] 2x2x2 remapped: {remap.summary()}, slot -> rank "
            f"{list(remap.device_order)}")
        gs, summary, paths = communicator_run(
            "comm_2x2x2_mapped", "2x2x2", path,
            ["per_leaf", "bucketed", "xla"], n_params)
    if gs["slots"] != list(remap.device_order) or \
            MeshMapping.from_json(gs["mapping"]) != remap or \
            f"mapping={remap.summary()}" not in gs["describe"]:
        raise AssertionError(f"[7d] ran slots {gs['slots']}, mapping "
                             f"{gs['mapping']}: {gs['describe']}")
    b = gs["variants"]["bucketed"]
    log(f"    bucketed through the remapped mesh: s per run "
        f"{' '.join(f'{t:.4f}' for t in b['seconds'])} beside [7b]'s "
        f"identity mesh {' '.join(f'{t:.4f}' for t in identity_bucketed)} "
        f"(ranks of one card, this call); every rank at its "
        f"device_order slot")
    # examples/autotune_collectives.py's grid and gradient-leaf mix
    ms = tuple(sorted(set(1024 * 4 ** i for i in range(7))
                      | set(DECODE_MESSAGE_SIZES)))
    leaf_mix = [4 << 20, 64 << 10, 64 << 10, 16 << 10] * 6
    t0 = time.perf_counter()
    hier, _ = tune_topology(Topology.from_spec("2x2x2"), ms=ms,
                            schedule_leaf_bytes=leaf_mix, tune_mapping=True)
    winner = MeshMapping.from_json(hier.levels[0][1].meta.mapping)
    log(f"    tune_topology(2x2x2, tune_mapping=True) on the simulator "
        f"({time.perf_counter() - t0:.1f}s): {winner.summary()}"
        + ("; the identity wins, as the reference's "
           "BENCH_mapping_smoke.json reads for 2x2x2 (vs-identity=1.00x)"
           if winner.is_identity else ""))
    summary["tune_topology_winner"] = winner.summary()
    return summary, paths


# ---------------------------------------------------------------------------
# [7t] the transport: CUDA payloads through the arena, held to gloo
# ---------------------------------------------------------------------------
#: every collective of ``group`` (``ppermute`` three ways: with a rank
#: that is no destination and an (i, i) pair, with no crossing pair, a
#: shift)
TRANSPORT_OPS = ("ppermute:mixed", "ppermute:self", "ppermute:shift",
                 "all_gather", "all_to_all", "pmax", "psum",
                 "reduce_scatter")
TRANSPORT_SUMS = ("psum", "reduce_scatter")
#: a sum on the card against gloo's on the host: |got - want| / max|want|,
#: the order of p - 1 additions in the payload's dtype (copies: bit-equal)
TRANSPORT_SUM_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
#: the payloads that grow the data axis's arena past its first slot, the
#: last past its largest (96 MB: two rounds of a 64 MiB slot)
TRANSPORT_GROW_ELEMS = (700_000, 4, 1_500_000, 12_000_000)
#: the timed all-reduce: 64 MB of fp32 over the 4 ranks, as [6] times it
TRANSPORT_TIMED_ELEMS = (64 << 20) // 4
TRANSPORT_TRIALS = 3


def _transport_perm(kind, p):
    if kind == "mixed":
        return [(0, 1), (3, 0), (2, 2)] if p == 4 else [(0, 1)]
    if kind == "self":
        return [(1, 1)]
    return [(i, (i + 1) % p) for i in range(p)]


def _transport_rank():
    """One rank of [7t]: every collective on CUDA tensors against the same
    collective on CPU copies of the same inputs over gloo, fp32 and bf16,
    over the axes of a 2 x 2 mesh, a remapped one and the remapped
    default group; the data arena's growth; the timed all-reduces."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.collectives import group as grp
    from repro_torch.core.collectives.algorithms import ALGORITHMS
    dev = grp.device_of("cuda")
    mesh = grp.RankMesh((2, 2), ("data", "model"), device=dev)
    mapped = grp.RankMesh((2, 2), ("data", "model"), device=dev,
                          device_order=[2, 3, 0, 1])
    axes = {"data": mesh.axis("data"), "model": mesh.axis("model"),
            "mapped_data": mapped.axis("data"),
            "world": mapped.joint(("data", "model"))}
    rng = np.random.default_rng(7 + grp.rank())
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def draw(shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtypes[dtype])

    def both(op, x, axis):
        kind, _, how = op.partition(":")
        if kind == "ppermute":
            perm = _transport_perm(how, axis.size)
            return (grp.ppermute(x.to(dev), perm, axis).cpu(),
                    grp.ppermute(x, perm, axis))
        fn = getattr(grp, kind)
        return fn(x.to(dev), axis).cpu(), fn(x, axis)

    def reading(got, want, op):
        if op in TRANSPORT_SUMS:
            scale = float(want.float().abs().max()) or 1.0
            return float((got.float() - want.float()).abs().max()) / scale
        return 0.0 if torch.equal(got, want) else float("inf")
    out = {"readings": {}, "same_bits": {}}
    for name, axis in axes.items():
        for dtype in dtypes:
            for op in TRANSPORT_OPS:
                got, want = both(op, draw((axis.size * 3, 257), dtype), axis)
                out["readings"][f"{name}/{dtype}/{op}"] = reading(got, want,
                                                                  op)
                if op == "psum":
                    every = grp.all_gather(got, axis).chunk(axis.size)
                    out["same_bits"][f"{name}/{dtype}"] = all(
                        torch.equal(every[0], e) for e in every)
    data = grp._arena(axes["data"])
    out["capacity"] = [data.capacity]
    for n in TRANSPORT_GROW_ELEMS:
        got, want = both("psum", draw((2, n), "float32"), axes["data"])
        out["readings"][f"grow {n}"] = reading(got, want, "psum")
        out["capacity"].append(data.capacity)
    # the 64 MB all-reduce over the 4 ranks: the built-in sum and the ring
    # in two segments, each the slowest rank's seconds
    x = torch.ones(TRANSPORT_TIMED_ELEMS, device=dev)
    ring = ALGORITHMS["all_reduce"]["ring"]
    runs = {"xla": lambda: grp.psum(x),
            "ring/s2": lambda: ring(x, None, grp.size(), segments=2)}
    out["timed_s"] = {}
    for label, fn in runs.items():
        ts = []
        for _ in range(1 + TRANSPORT_TRIALS):       # the first warms up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            ts.append(grp.max_over_ranks([time.perf_counter() - t0])[0])
        out["timed_s"][label] = ts[1:]
        out[f"timed_ok/{label}"] = bool((y == grp.size()).all())
    outs = [None] * grp.size()
    dist.all_gather_object(outs, out)
    return outs


#: the same measures through the host-staged transport (every CUDA
#: payload through host memory and the gloo wire), the tree before the
#: arena, by ``tools/transport_ab.py`` on an NVIDIA H100 80GB HBM3 at
#: 700.00 W in one call with the arena's tree: what `log_before_after`
#: prints beside this run's
HOST_STAGED = {"64 MB all-reduce, ring/s2 (ms)": (253.2, 374.6),
               "64 MB all-reduce, built-in (ms)": (139.1, 330.2),
               "[8] tuned sync, step 1 (s)": 4.086,
               "[8t] tuned sync, step 1 (s)": 2.587,
               "[8ft] (b) sync, step 0 (s)": 0.930,
               "[8ft] (b) step 0 (s)": 14.225}


def log_before_after(smi, transport, training, training_tp, fsdp_model):
    """Each measure of `HOST_STAGED` beside this run's, with the card."""
    def span(ms):
        return f"{min(ms):.3f}–{max(ms):.3f}"
    after = {"64 MB all-reduce, ring/s2 (ms)":
             span(transport["timed_ms"]["ring/s2"]),
             "64 MB all-reduce, built-in (ms)":
             span(transport["timed_ms"]["xla"]),
             "[8] tuned sync, step 1 (s)":
             f"{training['tuned']['sync_s'][1]:.3f}",
             "[8t] tuned sync, step 1 (s)":
             f"{training_tp['tuned']['sync_s'][1]:.3f}",
             "[8ft] (b) sync, step 0 (s)":
             f"{fsdp_model['full']['sync_s'][0]:.3f}",
             "[8ft] (b) step 0 (s)": f"{fsdp_model['full']['step_s'][0]:.3f}"}
    log(f"[7t] before / after: host-staged (tools/transport_ab.py, NVIDIA "
        f"H100 80GB HBM3, 700.00 W) / the arena, this run ({smi}):")
    for k, before in HOST_STAGED.items():
        b = "–".join(f"{x}" for x in before) if isinstance(before, tuple) \
            else f"{before}"
        log(f"    {k}: {b} / {after[k]}")


def phase_transport(smi):
    """[7t] every collective on CUDA tensors through the arena against the
    same collective over gloo on CPU copies (4 ranks on the card); the
    timed 64 MB all-reduce. Returns the summary."""
    from repro_torch.core.collectives import group as grp
    t0 = time.perf_counter()
    outs = grp.spawn(_transport_rank, RANKS)
    bad = []
    for r, out in enumerate(outs):
        for key, v in out["readings"].items():
            op = key.rsplit("/", 1)[-1]
            dtype = key.split("/")[1] if "/" in key else "float32"
            tol = TRANSPORT_SUM_TOL[dtype] if op in TRANSPORT_SUMS or \
                key.startswith("grow") else 0.0
            if not v <= tol:
                bad.append(f"rank {r} {key} {v}")
        bad += [f"rank {r} psum bits {k}" for k, ok in
                out["same_bits"].items() if not ok]
        bad += [f"rank {r} {k}" for k, ok in out.items()
                if k.startswith("timed_ok") and not ok]
    caps = outs[0]["capacity"]
    if any(o["capacity"] != caps for o in outs) or caps[0] != (1 << 20) \
            or not caps[1] < caps[-1] == grp.ARENA_MAX_BYTES:
        bad.append(f"capacities {[o['capacity'] for o in outs]}")
    sums = {dt: max(v for o in outs for k, v in o["readings"].items()
                    if k.rsplit("/", 1)[-1] in TRANSPORT_SUMS
                    and f"/{dt}/" in k) for dt in TRANSPORT_SUM_TOL}
    log(f"[7t] transport: {len(outs[0]['readings'])} collectives a rank "
        f"on CUDA tensors against gloo on CPU copies (4 axes, fp32 and "
        f"bf16, {', '.join(TRANSPORT_OPS)}): copies bit-equal, sums within "
        + ", ".join(f"{dt} {v:.3g} (tol {TRANSPORT_SUM_TOL[dt]})"
                    for dt, v in sums.items())
        + f" of the largest value, psum the same bits on every rank; the "
        f"data arena {caps} B through {TRANSPORT_GROW_ELEMS} x 2 fp32 "
        f"elements (the last in two rounds)")
    timed = outs[0]["timed_s"]
    for label, ts in timed.items():
        log(f"    64 MB fp32 all-reduce over 4 ranks, {label}: "
            + " ".join(f"{1e3 * t:.3f}" for t in ts)
            + f" ms (slowest rank's; {smi})")
    if bad:
        raise AssertionError(f"[7t] {bad[:8]}")
    summary = {"readings": len(outs[0]["readings"]), "sum_reading": sums,
               "capacity": caps, "timed_ms": {
                   k: [1e3 * t for t in v] for k, v in timed.items()},
               "phase_s": time.perf_counter() - t0}
    log(f"    [7t] {summary['phase_s']:.1f}s")
    return summary


# ---------------------------------------------------------------------------
# [8] the data-parallel training step
# ---------------------------------------------------------------------------
TRAIN_STEPS = 2
TRAIN_RANKS = 4
TRAIN_ARGS = ["--ranks", "4", "--topology", "2x2", "--steps",
              str(TRAIN_STEPS), "--seq", "256", "--batch", "8"]
# what each trained model's run must show: its layers (each one release
# point and one flash or SSD launch a rank-step), params and leaves, and
# the tuned 2x2 plan's combines a step where it is pinned
TRAIN_MODELS = {
    "smollm-135m": {"tag": "8", "layers": 30, "param_elems": 162826560,
                    "leaves": 273, "combines": 2184,
                    "kernels": ("flash_attention", "flash_attention_bwd")},
    # full width, depth cut 24 -> 12 for the script's time ([8t] took
    # it), 12 -> 6 ([8ft] took it): 3,765,320 params and 9 leaves a layer
    "mamba2-130m": {"tag": "8s", "layers": 6, "param_elems": 100056240,
                    "leaves": 57, "combines": None,
                    "config": {"num_layers": 6},
                    "kernels": ("ssd_chunk", "ssd_chunk_bwd")},
    # full width, depth cut 32 + 32 -> 2 + 2 (at 16 B a param, full depth
    # is 25.7 GB a rank: four replicas do not fit one card; [8ft] trains
    # it at full depth under FSDP with the model axis); 4 flash
    # launches a rank-step (2 encoder, 2 decoder self-attention); the
    # tuned run is held to "xla", not overlapped
    "whisper-large-v3": {"tag": "8w", "layers": 4,
                         "param_elems": 231980800, "leaves": 59,
                         "combines": None,
                         "kernels": ("flash_attention",
                                     "flash_attention_bwd"),
                         "config": {"num_layers": 2, "encoder_layers": 2},
                         "overlap": False},
}
# the tuned run against the "xla" run. Both start from the same params
# and batches, and rank 0's step-0 gradients before the sync are checked
# bit-equal in both, so step 0's synced trees differ only by the order
# of an fp32 sum of 4 terms: per leaf |g_t - g_x| / |g_x| (2-norms), a
# few 1e-8 where the terms do not cancel
TRAIN_GRAD_TOL = 1e-6
# the params' change over the run, |d_t - d_x| / |d_x| over the whole
# tree (d = final - initial): Adam's update g / (|g| + eps) is
# insensitive to the gradient's size and the global-norm clip rescales
# it anyway, so this holds the sync's signs and placement; where a
# gradient is near 0 the order of the sum can flip its update (two steps
# apart), which a flip in 1 of 10^5 params would read at ~1e-2
TRAIN_CHANGE_TOL = 1e-2
# lr_scale is 0, .01 over the 2 warmup steps (lr 3e-4), so a param
# moves at most a few times 3e-6 in all; a param that crosses a
# bf16 rounding boundary moves the bf16 forward's loss by ~1e-4
TRAIN_LOSS_TOL = 5e-3


#: each [8] run's "xla" run (step 0's synced gradients and loss, the
#: initial and final params and the losses, on the host), by arch: what
#: [8t] and [8f] are held to
STEP0_ORACLE = {}


def grad_reading(got, want) -> float:
    """max over the leaves of |got - want| / |want| (2-norms, float64 on
    the card)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to("cuda", torch.float64), w.to("cuda", torch.float64)
        num, den = (g - w).norm().item(), w.norm().item()
        worst = max(worst, num / den if den else
                    (0.0 if num == 0 else float("inf")))
    return worst


def change_reading(final, init, want) -> float:
    """|d - d_want| / |d_want| over the whole tree, d = final - init."""
    num = den = 0.0
    for f, i, w in zip(final, init, want):
        f, i, w = (t.to("cuda", torch.float64) for t in (f, i, w))
        num += (f - w).square().sum().item()
        den += (w - i).square().sum().item()
    return (num / den) ** 0.5


def sync_readings(tuned, xla):
    """[8]'s readings of the tuned run against the xla run, and the same
    readings of faults planted in the tuned run's trees (each tree moved
    to the card in float64 once)."""
    from repro_torch import pytree

    def card(tree):
        return [t.to("cuda", torch.float64) for t in pytree.leaves(tree)]
    gt, gx = card(tuned["grads0"]), card(xla["grads0"])
    init = card(tuned["init_params"])
    ft, fx = card(tuned["params"]), card(xla["params"])
    if not all(torch.equal(a, b) for a, b in
               zip(init, card(xla["init_params"]))) or \
            tuned["local_grads0_fingerprint"] != \
            xla["local_grads0_fingerprint"]:
        raise AssertionError("[8] the runs' initial params or rank 0's "
                             "step-0 gradients before the sync differ")
    shifted = list(gt)              # each leaf takes the next same-shaped
    by_shape = {}
    for j, t in enumerate(gt):
        by_shape.setdefault(tuple(t.shape), []).append(j)
    for idx in by_shape.values():
        for a, b in zip(idx, idx[1:] + idx[:1]):
            shifted[a] = gt[b]
    big = max(range(len(gt)), key=lambda j: gt[j].numel())
    halved = list(gt)
    halved[big] = gt[big].flatten().clone()
    halved[big][gt[big].numel() // 2:] = 0
    planted = {
        "gradients zeroed": grad_reading([torch.zeros_like(g) for g in gt],
                                         gx),
        "gradients negated": grad_reading([-g for g in gt], gx),
        "summed, not averaged": grad_reading([4 * g for g in gt], gx),
        "shifted between same-shaped leaves": grad_reading(shifted, gx),
        "half of the largest leaf dropped": grad_reading(
            halved, [g.flatten() if j == big else g
                     for j, g in enumerate(gx)]),
        "update lost": change_reading(init, init, fx),
        "update reversed": change_reading([2 * i - f for i, f in
                                           zip(init, ft)], init, fx)}
    out = {"grad": grad_reading(gt, gx),
           "change": change_reading(ft, init, fx),
           "max_abs_param": max((a - b).abs().max().item()
                                for a, b in zip(ft, fx)),
           "planted": planted}
    # the card's copies go back to the device before the ranks of the
    # next run need it (olmoe's: ~31 GB)
    del gt, gx, init, ft, fx, shifted, halved
    torch.cuda.empty_cache()
    return out


def train_run(tag, label, argv, config=None, parallel=None, keep=True):
    """One ``repro_torch.launch.train`` run (its counts are zeroed in
    every rank just before the steps and summed over the ranks just
    after); returns rank 0's result, with its final params unless
    ``keep`` is false. ``config`` replaces fields of the model's config
    (a depth cut), ``parallel`` the `ParallelConfig` (FSDP)."""
    from repro_torch.launch import train
    log(f"[{tag}] {label}: train {' '.join(argv)}"
        + (f" (config {config})" if config else "")
        + (f" ({parallel})" if parallel else ""))
    t0 = time.perf_counter()
    res = train.main(argv, keep_params=keep, config=config,
                     parallel=parallel)
    res["wall_s"] = time.perf_counter() - t0
    mem = ", ".join(f"{b / 2**30:.2f}" for b in res["peak_mem_bytes"])
    log(f"    losses {' '.join(f'{x:.6f}' for x in res['losses'])}; s per "
        f"step {' '.join(f'{x:.3f}' for x in res['step_s'])}")
    for i in range(len(res["losses"])):
        log(f"    step {i}: forward+backward {res['compute_s'][i]:.4f} s, "
            f"gradient sync {res['sync_s'][i]:.4f} s, optimizer "
            f"{res['opt_s'][i]:.4f} s (slowest rank's)")
    log(f"    peak memory per rank (GiB): {mem}; launches {res['launches']};"
        f" {res['plan_entries']} sync collectives and "
        f"{res['plan_combines']} combines a step; replicas bit-equal after "
        f"every step: "
        f"{all(res['replicas_equal'])}; {res['wall_s']:.1f}s with set-up")
    if "fsdp" in res:
        log(f"    FSDP {res['fsdp']}; collectives a step "
            f"{res['collectives']}; gathers s "
            f"{' '.join(f'{x:.4f}' for x in res['gather_s'])}, "
            f"reduce-scatters s "
            f"{' '.join(f'{x:.4f}' for x in res['reduce_scatter_s'])} "
            f"(slowest rank's, inside forward+backward)")
    return res


def expected_train_launches(arch, r):
    """Each kernel's launches over a run's steps, summed over the ranks:
    one forward launch a layer and LAUNCHES_PER_CALL backward launches a
    layer for every rank-step of the model's kernels (flash attention or
    the SSD chunk; no remat), none of the others, and the tuned plan's
    combines every step."""
    from repro_torch.kernels import attention_bwd, ssd_scan_bwd
    spec = TRAIN_MODELS[arch]
    per = spec["layers"] * TRAIN_STEPS * TRAIN_RANKS
    fwd, bwd = spec["kernels"]
    # the training step computes in bf16
    bwd_per_call = {"flash_attention_bwd": attention_bwd.LAUNCHES_PER_CALL,
                    "ssd_chunk_bwd":
                    ssd_scan_bwd.LAUNCHES_PER_CALL[torch.bfloat16]}[bwd]
    want = {name: 0 for name in ("flash_attention", "flash_attention_bwd",
                                 "ssd_chunk", "ssd_chunk_bwd")}
    want[fwd], want[bwd] = per, per * bwd_per_call
    want["segment_combine"] = TRAIN_STEPS * r["plan_combines"]
    return want


def phase_training(arch):
    """[8] / [8s] ``arch`` at full width and depth trained data-parallel
    on 4 ranks on the card through the tuned 2x2
    hierarchical sync, and again through ``--collective xla`` as the
    oracle; each run's launches held to its plan; returns the summary
    and the launch counts by path."""
    spec = TRAIN_MODELS[arch]
    tag = spec["tag"]
    argv = ["--arch", arch, *TRAIN_ARGS]
    hier = os.path.join(ROOT, "examples", "artifacts",
                        "hierarchical_decision.json")
    config = spec.get("config")
    tuned = train_run(tag, "tuned", [*argv, "--tuning-table", hier],
                      config=config)
    xla = train_run(tag, "xla", [*argv, "--collective", "xla"],
                    config=config)
    for label, r in (("tuned", tuned), ("xla", xla)):
        want = expected_train_launches(arch, r)
        bad = (r["device"] != "cuda:0" or r["ranks"] != TRAIN_RANKS
               or r["mesh"] != {"pod": 2, "data": 2, "model": 1}
               or r["param_elems"] != spec["param_elems"]
               or r["leaves"] != spec["leaves"]
               or not r["replicas_equal_at_init"]
               or not all(r["replicas_equal"])
               or len(r["losses"]) != TRAIN_STEPS
               or not all(x == x and 0 < x < 20 for x in r["losses"])
               or r["launches"] != want)
        if bad:
            raise AssertionError(f"[{tag}] {label}: {r['launches']} vs "
                                 f"{want}; "
                                 f"{ {k: r[k] for k in ('mesh', 'losses')} }")
    if not tuned["tuned"] or xla["tuned"] or xla["plan_combines"] != 0 or \
            tuned["plan_combines"] <= 0 or spec["combines"] not in (
                None, tuned["plan_combines"]):
        raise AssertionError(f"[{tag}] plans: tuned "
                             f"{tuned['plan_combines']} combines a step, xla "
                             f"{xla['plan_combines']}")
    loss_diff = max(abs(a - b) for a, b in zip(tuned["losses"],
                                               xla["losses"]))
    rd = sync_readings(tuned, xla)
    # [8t] holds its step 0 to this run's (the host's copies)
    STEP0_ORACLE[arch] = {"grads0": xla["grads0"],
                          "loss": xla["losses"][0],
                          "init_params": xla["init_params"],
                          "losses": xla["losses"], "params": xla["params"]}
    log(f"    tuned vs xla: step 0's synced gradients within {rd['grad']:.3g}"
        f" (tol {TRAIN_GRAD_TOL}), the params' change within "
        f"{rd['change']:.3g} (tol {TRAIN_CHANGE_TOL}), losses within "
        f"{loss_diff:.3g} (tol {TRAIN_LOSS_TOL}), final params within "
        f"{rd['max_abs_param']:.3g}; sync s a step tuned "
        f"{statistics.median(tuned['sync_s']):.3f}, xla "
        f"{statistics.median(xla['sync_s']):.3f} (medians)")
    log("    planted in the tuned run's trees: " + "; ".join(
        f"{k} {v:.3g}" for k, v in rd["planted"].items()))
    if rd["grad"] > TRAIN_GRAD_TOL or rd["change"] > TRAIN_CHANGE_TOL \
            or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"[{tag}] the tuned run departs from the xla "
                             f"run")
    for k, v in rd["planted"].items():
        if v <= (TRAIN_CHANGE_TOL if k.startswith("update")
                 else TRAIN_GRAD_TOL):
            raise AssertionError(f"[{tag}] the planted fault '{k}' reads "
                                 f"{v}, inside the tolerance")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "peak_mem_bytes", "launches", "plan_entries", "plan_combines",
            "describe", "wall_s")
    summary = {"tuned": {k: tuned[k] for k in keep},
               "xla": {k: xla[k] for k in keep},
               "loss_diff": loss_diff, "readings": rd}
    prefix = "train" if arch == "smollm-135m" else f"train_{arch}"
    paths = {f"{prefix}_tuned": tuned["launches"],
             f"{prefix}_xla": xla["launches"]}
    if spec.get("overlap", True):
        summary["overlapped"], paths[f"{prefix}_overlapped"] = \
            phase_training_overlapped(arch, tuned)
    return summary, paths


def check_step_traces(d, r) -> dict:
    """[8c]'s trace directory: every step's Perfetto trace and summary
    parse, one span a plan entry; returns the drift a step and the
    replayed seconds a step of the released layers' syncs and of the
    residual's (each task alone, the slowest rank's)."""
    drift, layers_s, residual_s = [], [], []
    for i in range(TRAIN_STEPS):
        with open(os.path.join(d, f"step{i:03d}.trace.json")) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e["ph"] == "X"]
        with open(os.path.join(d, f"step{i:03d}.summary.json")) as f:
            summ = json.load(f)
        if len(spans) != r["plan_entries"] or \
                summ["n_tasks"] != r["plan_entries"] or summ["step"] != i:
            raise AssertionError(f"[8c/8sc] step {i}'s trace has "
                                 f"{len(spans)} "
                                 f"spans, its summary {summ['n_tasks']} "
                                 f"tasks; the plan {r['plan_entries']}")
        drift.append(summ.get("drift"))
        released = [e for e in spans if e["args"]["release"] is not None]
        layers_s.append(sum(e["dur"] for e in released) * 1e-6)
        residual_s.append(sum(e["dur"] for e in spans) * 1e-6
                          - layers_s[-1])
    return {"drift": drift, "replay_layers_s": layers_s,
            "replay_residual_s": residual_s}


def phase_training_overlapped(arch, tuned):
    """[8c] / [8sc] [8]'s / [8s]'s tuned run of ``arch`` again with
    ``--overlap-backward --trace-dir``: each layer's gradients synced on
    a thread of every rank (its own CUDA stream) while the backward
    computes the layers below, held to that tuned run; each step's trace
    written and checked; returns the summary
    and the launch counts of the steps (zeroed in every rank just before
    them, summed over the ranks just after; the trace replay's apart)."""
    import tempfile
    spec = TRAIN_MODELS[arch]
    tag = spec["tag"] + "c"
    hier = os.path.join(ROOT, "examples", "artifacts",
                        "hierarchical_decision.json")
    with tempfile.TemporaryDirectory() as d:
        r = train_run(tag, "tuned, overlapped",
                      ["--arch", arch, *TRAIN_ARGS, "--tuning-table", hier,
                       "--overlap-backward", "--trace-dir", d],
                      config=spec.get("config"))
        traces = check_step_traces(d, r)
    order = list(reversed(range(spec["layers"])))
    bad = [k for k, ok in (
        ("replicas", r["replicas_equal_at_init"]
         and all(r["replicas_equal"])),
        ("release order", r["release_events"]
         == [[order] * TRAIN_RANKS] * TRAIN_STEPS),
        ("combines", r["launches"]["segment_combine"]
         == TRAIN_STEPS * r["plan_combines"] > 0),
        ("model kernels' launches", all(
            r["launches"][k] == tuned["launches"][k]
            for k in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                      "ssd_chunk_bwd"))),
        ("gradients before the sync", r["local_grads0_fingerprint"]
         == tuned["local_grads0_fingerprint"])) if not ok]
    from repro_torch import pytree
    grad = grad_reading(pytree.leaves(r["grads0"]),
                        pytree.leaves(tuned["grads0"]))
    loss_diff = max(abs(a - b) for a, b in zip(r["losses"],
                                               tuned["losses"]))
    log(f"    overlapped vs [{spec['tag']}] tuned: step 0's synced "
        f"gradients within {grad:.3g} (tol {TRAIN_GRAD_TOL}), losses within {loss_diff:.3g}"
        f" (tol {TRAIN_LOSS_TOL}); {r['plan_entries']} sync collectives "
        f"and {r['plan_combines']} combines a step ([{spec['tag']}]: "
        f"{tuned['plan_entries']}, {tuned['plan_combines']}); trace "
        f"replay launches {r['replay_launches']}; drift a step "
        f"{traces['drift']}")
    log("    replayed sync s a step, each task alone: layers "
        + " ".join(f"{x:.4f}" for x in traces["replay_layers_s"])
        + "; residual " + " ".join(f"{x:.4f}"
                                   for x in traces["replay_residual_s"]))
    for i in range(TRAIN_STEPS):
        log(f"    step {i}: compute / exposed sync / optimizer s, "
            f"overlapped {r['compute_s'][i]:.4f} / {r['sync_s'][i]:.4f} / "
            f"{r['opt_s'][i]:.4f} (sync thread {r['release_sync_s'][i]:.4f})"
            f", [{spec['tag']}] tuned {tuned['compute_s'][i]:.4f} / "
            f"{tuned['sync_s'][i]:.4f} / {tuned['opt_s'][i]:.4f}; step "
            f"{r['step_s'][i]:.3f} vs {tuned['step_s'][i]:.3f}")
    if bad or grad > TRAIN_GRAD_TOL or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"[{tag}] the overlapped run departs from "
                             f"[{spec['tag']}]'s tuned run: {bad}, "
                             f"gradients {grad}, losses {loss_diff}")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "release_sync_s", "peak_mem_bytes", "launches",
            "replay_launches", "plan_entries", "plan_combines", "wall_s")
    return ({**{k: r[k] for k in keep}, "grad_reading": grad,
             "loss_diff": loss_diff, **traces}, r["launches"])


# ---------------------------------------------------------------------------
# [8m] MoE expert parallelism in the training step
# ---------------------------------------------------------------------------
FLAT_TABLE = os.path.join(ROOT, "examples", "artifacts",
                          "tuned_decision.json")
MOE_TRAIN_STEPS = 2
# [8mc]'s steps: held to [8m]'s (1 from [8ft] until the arena transport
# gave the script's time back)
MOE_OVERLAP_STEPS = 2
# olmoe-1b-7b at full width on 4 ranks, ("data", "model") = 2 x 2: each
# rank holds 32 of the 64 experts of every layer, 4 rows of the 8 x 256
# batch and routes a 128-token chunk of each
MOE_TRAIN_ARGS = ["--arch", "olmoe-1b-7b", "--ranks", "4",
                  "--model-parallel", "2", "--steps", str(MOE_TRAIN_STEPS),
                  "--seq", "256", "--batch", "8"]
# depth cut 16 -> 1 (2 until [8t] took the script's time): at 16 B a
# param (fp32 param, gradient, Adam m and v) a rank's 2-layer 643M params
# were 10.3 GB, four ranks ~41 GB of the card
MOE_TRAIN_CONFIG = {"num_layers": 1}
MOE_EXPERTS = [[0, 32], [32, 64], [0, 32], [32, 64]]


def expected_moe_launches(r, steps):
    """Each kernel's launches over a run's ``steps``, summed over the
    ranks: one flash forward and LAUNCHES_PER_CALL backward launches a
    layer a rank-step, and the tuned plan's combines every step."""
    from repro_torch.kernels import attention_bwd
    per = MOE_TRAIN_CONFIG["num_layers"] * steps * TRAIN_RANKS
    return {"flash_attention": per,
            "flash_attention_bwd": per * attention_bwd.LAUNCHES_PER_CALL,
            "ssd_chunk": 0, "ssd_chunk_bwd": 0,
            "segment_combine": steps * r["plan_combines"]}


def check_moe_run(tag, label, r, steps=MOE_TRAIN_STEPS):
    want = expected_moe_launches(r, steps)
    bad = [k for k, ok in (
        ("device", r["device"] == "cuda:0" and r["ranks"] == TRAIN_RANKS),
        ("mesh", r["mesh"] == {"data": 2, "model": 2}),
        ("experts", r["experts"] == MOE_EXPERTS),
        ("replicas", r["replicas_equal_at_init"]
         and all(r["replicas_equal"])),
        ("losses", len(r["losses"]) == steps and all(
            x == x and 0 < x < 20 for x in r["losses"])),
        ("launches", r["launches"] == want)) if not ok]
    if bad:
        raise AssertionError(f"[{tag}] {label}: {bad}; launches "
                             f"{r['launches']} vs {want}")


def _moe_fault_rank(layers):
    """One rank of a 2-rank ("data", "model") = 1 x 2 mesh: olmoe's
    tuned training step at full width (4 rows x 256, [8m]'s rows a
    rank), and the same step with each fault of
    ``steps.planted_ep_fault`` planted; returns rank 0's readings of each
    faulty step's synced step-0 gradients against the correct step's
    (`grad_reading`, per leaf)."""
    from repro_torch import pytree
    from repro_torch.comms import Communicator
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    from repro_torch.data import batch_to_tensors
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import make_train_batch
    dev = grp.device_of("cuda")
    mesh = make_local_mesh(2, device=dev)
    cfg = ARCHITECTURES["olmoe-1b-7b"].replace(num_layers=layers)
    shape = ShapeConfig(name="faults", seq_len=256, global_batch=4,
                        kind="train")
    comm = Communicator.create(mesh, artifact=FLAT_TABLE)
    step = steps.build_train_step(cfg, shape, ParallelConfig(),
                                  CollectiveConfig(decision=FLAT_TABLE),
                                  mesh, communicator=comm, device=dev)
    params = step.init(torch.Generator(device=dev).manual_seed(0))
    batch = batch_to_tensors(make_train_batch(cfg, shape, seed=0), dev,
                             rows=step.rows)

    def grads():        # the step updates its params in place
        p = pytree.tree_map(torch.clone, params)
        m = step.fn(p, step.opt.init(p), batch, keep_grads=True)[2]
        return pytree.leaves(m["grads"])
    good = grads()
    readings = {}
    for fault in steps.EP_FAULTS:
        with steps.planted_ep_fault(fault):
            readings[fault] = grad_reading(grads(), good)
    return readings


def phase_training_moe():
    """[8m] olmoe-1b-7b at full width (1 of 16 layers) trained with
    expert parallelism on 4 ranks, tuned (the flat table)
    and through "xla", held to each other as [8] is; faults planted in
    the expert-parallel correction must read above the gradient
    tolerance; then [8mc], the tuned run overlapped. Returns the summary
    and the launch counts by path."""
    from repro_torch.core.collectives import group as grp
    t0 = time.perf_counter()
    tuned = train_run("8m", "tuned", [*MOE_TRAIN_ARGS, "--tuning-table",
                                      FLAT_TABLE], config=MOE_TRAIN_CONFIG)
    xla = train_run("8m", "xla", [*MOE_TRAIN_ARGS, "--collective", "xla"],
                    config=MOE_TRAIN_CONFIG)
    for label, r in (("tuned", tuned), ("xla", xla)):
        check_moe_run("8m", label, r)
    if not tuned["tuned"] or xla["tuned"] or tuned["plan_combines"] <= 0 \
            or xla["a2a_algorithm"] != "xla":
        raise AssertionError(f"[8m] plans: tuned {tuned['plan_combines']} "
                             f"combines, xla a2a {xla['a2a_algorithm']}")
    log(f"    dispatch: {tuned['dispatch_bytes']} B each way a layer; the "
        f"table resolved the all-to-all to {tuned['a2a_algorithm']!r} "
        f"(xla run: {xla['a2a_algorithm']!r}); {tuned['leaves']} leaves, "
        f"{tuned['param_elems']} params a rank")
    loss_diff = max(abs(a - b) for a, b in zip(tuned["losses"],
                                               xla["losses"]))
    rd = sync_readings(tuned, xla)
    # the host keeps of both runs only what [8mc] and [8mf] are held to
    for k in ("init_params", "params"):
        tuned.pop(k)
    STEP0_ORACLE["olmoe-1b-7b"] = {
        "grads0": xla.pop("grads0"), "loss": xla["losses"][0],
        "init_params": xla.pop("init_params"), "losses": xla["losses"],
        "params": xla.pop("params")}
    t1 = time.perf_counter()
    # one layer is enough to read each fault, and costs less set-up
    faults = grp.spawn(_moe_fault_rank, 2, (1,))
    rd["planted_ep"] = faults
    log(f"    tuned vs xla: step 0's synced gradients within {rd['grad']:.3g}"
        f" (tol {TRAIN_GRAD_TOL}), the params' change within "
        f"{rd['change']:.3g} (tol {TRAIN_CHANGE_TOL}), losses within "
        f"{loss_diff:.3g} (tol {TRAIN_LOSS_TOL}), final params within "
        f"{rd['max_abs_param']:.3g}")
    log("    planted in the tuned run's trees: " + "; ".join(
        f"{k} {v:.3g}" for k, v in rd["planted"].items()))
    log(f"    planted in the expert-parallel step (2 ranks, 1 layer, "
        f"step 0's synced gradients against the correct step's, "
        f"{time.perf_counter() - t1:.1f}s): "
        + "; ".join(f"{k} {v:.3g}" for k, v in faults.items()))
    if rd["grad"] > TRAIN_GRAD_TOL or rd["change"] > TRAIN_CHANGE_TOL \
            or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError("[8m] the tuned run departs from the xla run")
    for k, v in {**rd["planted"], **faults}.items():
        if v <= (TRAIN_CHANGE_TOL if k.startswith("update")
                 else TRAIN_GRAD_TOL):
            raise AssertionError(f"[8m] the planted fault '{k}' reads {v}, "
                                 f"inside the tolerance")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "peak_mem_bytes", "launches", "plan_entries", "plan_combines",
            "describe", "wall_s", "a2a_algorithm", "dispatch_bytes",
            "param_elems", "leaves")
    summary = {"tuned": {k: tuned[k] for k in keep},
               "xla": {k: xla[k] for k in keep},
               "loss_diff": loss_diff, "readings": rd}
    paths = {"train_olmoe_tuned": tuned["launches"],
             "train_olmoe_xla": xla["launches"]}
    with memory_log("8mc"):
        r = train_run("8mc", "tuned, overlapped on the sync thread",
                      [*MOE_TRAIN_ARGS[:-5], str(MOE_OVERLAP_STEPS),
                       *MOE_TRAIN_ARGS[-4:], "--tuning-table", FLAT_TABLE,
                       "--overlap-backward"], config=MOE_TRAIN_CONFIG)
    check_moe_run("8mc", "overlapped", r, MOE_OVERLAP_STEPS)
    from repro_torch import pytree
    order = list(reversed(range(MOE_TRAIN_CONFIG["num_layers"])))
    grad = grad_reading(pytree.leaves(r["grads0"]),
                        pytree.leaves(tuned["grads0"]))
    o_loss = max(abs(a - b) for a, b in zip(r["losses"], tuned["losses"]))
    bad = [k for k, ok in (
        ("release order", r["release_events"]
         == [[order] * TRAIN_RANKS] * MOE_OVERLAP_STEPS),
        ("combines", r["plan_combines"] > 0),
        ("sync thread busy every step", len(r["release_sync_s"])
         == MOE_OVERLAP_STEPS and all(t > 0 for t in r["release_sync_s"])),
        ("gradients before the sync", r["local_grads0_fingerprint"]
         == tuned["local_grads0_fingerprint"])) if not ok]
    log(f"    overlapped vs [8m] tuned: step 0's synced gradients within "
        f"{grad:.3g} (tol {TRAIN_GRAD_TOL}), losses within {o_loss:.3g}; "
        f"{r['plan_entries']} sync collectives and {r['plan_combines']} "
        f"combines a step ([8m]: {tuned['plan_entries']}, "
        f"{tuned['plan_combines']})")
    for i in range(MOE_OVERLAP_STEPS):
        log(f"    step {i}: compute / exposed sync / optimizer s, "
            f"overlapped {r['compute_s'][i]:.4f} / {r['sync_s'][i]:.4f} / "
            f"{r['opt_s'][i]:.4f} (sync thread {r['release_sync_s'][i]:.4f})"
            f", [8m] tuned {tuned['compute_s'][i]:.4f} / "
            f"{tuned['sync_s'][i]:.4f} / {tuned['opt_s'][i]:.4f}")
    if bad or grad > TRAIN_GRAD_TOL or o_loss > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8mc] the overlapped run departs from [8m]'s "
                             f"tuned run: {bad}, gradients {grad}, losses "
                             f"{o_loss}")
    summary["overlapped"] = {**{k: r[k] for k in keep + (
        "release_sync_s",)}, "grad_reading": grad, "loss_diff": o_loss}
    paths["train_olmoe_overlapped"] = r["launches"]
    summary["phase_s"] = time.perf_counter() - t0
    log(f"    [8m] + [8mc] {summary['phase_s']:.1f}s")
    return summary, paths


# ---------------------------------------------------------------------------
# [8t] tensor parallelism in the training step
# ---------------------------------------------------------------------------
TP_TRAIN_ARGS = ["--arch", "smollm-135m", "--ranks", "4",
                 "--model-parallel", "2", "--seq", "256", "--batch", "8"]
TP_TRAIN_STEPS = {"tuned": 2, "xla": 1}
# smollm-135m on ("data", "model") = 2 x 2: the attention (26,542,080)
# and the norms (34,560, with the final norm's 576) whole on every rank,
# half the MLP (39,813,120) and half of tok + out (28,311,552)
TP_PARAM_ELEMS = 94701888
TP_SPLIT = {"heads": False, "kv_heads": False, "ffn": True, "vocab": True}
# [8t]'s gradients against a run without a model axis ([8]'s layout):
# the same batch and params, but the split products sum their fp32
# partials over model and a rank takes 4 rows, not 2, so fp32 sums run
# in other orders. At bf16 that sets bf16 roundings apart, and 30 layers
# spread them: two data-parallel partitions of the same step (4 x 2
# rows, 2 x 4) already read about 2e-2 apart (`allclose_reading`,
# tools/tp_grad_probe.py), so no bf16 tolerance within the reference's
# 2e-2 can hold. The gradients are held at fp32 compute
# (`_tp_fp32_rank`), where only the sums' order separates them (a few
# 1e-6 at full depth); at bf16 the loss is held ([8]'s TRAIN_LOSS_TOL)
# and the gradients' reading is printed. A planted fault must read 10x.
TP_GRAD_TOL = 1e-4


def allclose_reading(got, want) -> dict:
    """Per leaf, max_i |got_i - want_i| / (max|want| + |want_i|): the
    least ``tol`` at which ``assert_allclose(got, want, atol=tol *
    max|want|, rtol=tol)`` holds, the reference's form of a tolerance
    with atol scaled to the leaf (float64 on the card)."""
    out = {}
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.to("cuda", torch.float64), w.to("cuda", torch.float64)
        den = w.abs().max() + w.abs()
        out[j] = ((g - w).abs() / den.clamp_min(1e-300)).max().item()
    return out


def expected_tp_launches(r, steps):
    """Every rank runs smollm's 30 attention layers whole: one flash
    forward and LAUNCHES_PER_CALL backward launches a layer a
    rank-step, and the tuned plan's combines every step."""
    from repro_torch.kernels import attention_bwd
    per = 30 * steps * TRAIN_RANKS
    return {"flash_attention": per,
            "flash_attention_bwd": per * attention_bwd.LAUNCHES_PER_CALL,
            "ssd_chunk": 0, "ssd_chunk_bwd": 0,
            "segment_combine": steps * r["plan_combines"]}


#: the fp32 check's depth: full width, 2 of smollm's 30 layers (the
#: script's time; tools/tp_grad_probe.py runs it at 30)
TP_FP32_LAYERS = 2


def _tp_fp32_rank(layers):
    """One of 4 ranks: smollm-135m's "xla" training step at full width
    and ``layers`` layers, fp32 compute, [8t]'s batch (8 x 256, seed 0) and params
    (seed 0), on ("data", "model") = 4 x 1 ([8]'s layout, no model
    axis), then 2 x 2 (tensor-parallel), then 2 x 2 with each fault of
    ``steps.planted_tp_fault`` that the layout runs; returns rank 0's
    losses and its readings of each split step's synced step-0
    gradients, gathered over model, against the unsplit step's
    (`allclose_reading`, per leaf)."""
    import contextlib
    from repro_torch import pytree
    from repro_torch.configs import ARCHITECTURES, ParallelConfig, \
        ShapeConfig
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    from repro_torch.data import batch_to_tensors
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import make_train_batch
    from repro_torch.parallel import sharding as sh
    dev = grp.device_of("cuda")
    cfg = ARCHITECTURES["smollm-135m"].replace(num_layers=layers)
    shape = ShapeConfig(name="tp_fp32", seq_len=256, global_batch=8,
                        kind="train")
    batch_np = make_train_batch(cfg, shape, seed=0)

    def synced(model_parallel, fault=None):
        mesh = make_local_mesh(model_parallel, device=dev)
        step = steps.build_train_step(
            cfg, shape, ParallelConfig(compute_dtype="float32"),
            CollectiveConfig(), mesh, device=dev)
        params = step.init(torch.Generator(device=dev).manual_seed(0))
        batch = batch_to_tensors(batch_np, dev, rows=step.rows)
        plant = steps.planted_tp_fault(fault) if fault \
            else contextlib.nullcontext()
        with plant:
            m = step.fn(params, step.opt.init(params), batch,
                        keep_grads=True)[2]
        return float(m["loss"]), step.gather(m["grads"])
    loss, tree = synced(1)
    whole = pytree.leaves(tree)
    out = {"loss": loss, "faults": {}, "names": leaf_names(tree)}
    del tree
    out["tp_loss"], got = synced(2)
    out["grad"] = allclose_reading(pytree.leaves(got), whole)
    del got
    for fault in steps.TP_FAULTS:
        if fault == "kv_not_summed" and not sh.tp_mixed(cfg, 2):
            continue        # smollm's kv heads are never read split here
        got = pytree.leaves(synced(2, fault)[1])
        out["faults"][fault] = max(allclose_reading(got, whole).values())
        del got
    return out


def first_slice(whole, shape):
    """The first block of ``shape`` of ``whole`` (split on at most one
    dimension)."""
    for d, (n, m) in enumerate(zip(whole.shape, shape)):
        if n != m:
            return whole.narrow(d, 0, m)
    return whole


def phase_training_tp():
    """[8t] smollm-135m at full width and depth trained tensor-parallel
    on 4 ranks (``("data", "model")`` = 2 x 2), tuned and
    through "xla", held to each other as [8] is and to [8]'s "xla" step
    0; at fp32 compute, the split step's gradients held to the unsplit
    step's and a planted fault read 10x above the tolerance. Returns the
    summary and the launch counts by path."""
    from repro_torch import pytree
    from repro_torch.core.collectives import group as grp
    t0 = time.perf_counter()
    runs = {}
    for label, extra in (("tuned", ["--tuning-table", FLAT_TABLE]),
                         ("xla", ["--collective", "xla"])):
        steps_n = TP_TRAIN_STEPS[label]
        r = train_run("8t", label, [*TP_TRAIN_ARGS, "--steps", str(steps_n),
                                    *extra])
        want = expected_tp_launches(r, steps_n)
        bad = [k for k, ok in (
            ("device", r["device"] == "cuda:0"
             and r["ranks"] == TRAIN_RANKS),
            ("mesh", r["mesh"] == {"data": 2, "model": 2}),
            ("params a rank", r["param_elems"] == TP_PARAM_ELEMS),
            ("layout", r["tp_split"] == TP_SPLIT),
            ("replicas", r["replicas_equal_at_init"]
             and all(r["replicas_equal"])),
            ("losses", len(r["losses"]) == steps_n and all(
                x == x and 0 < x < 20 for x in r["losses"])),
            ("launches", r["launches"] == want)) if not ok]
        if bad:
            raise AssertionError(f"[8t] {label}: {bad}; launches "
                                 f"{r['launches']} vs {want}; mesh "
                                 f"{r['mesh']}, {r['param_elems']} params")
        runs[label] = r
    tuned, xla = runs["tuned"], runs["xla"]
    if not tuned["tuned"] or xla["tuned"] or tuned["plan_combines"] <= 0:
        raise AssertionError(f"[8t] plans: tuned {tuned['plan_combines']} "
                             f"combines, xla tuned={xla['tuned']}")

    def card(tree):
        return [t.to("cuda", torch.float64) for t in pytree.leaves(tree)]
    overlapped = overlapped_tp_run(tuned, card)
    oracle = STEP0_ORACLE["smollm-135m"]
    # the same start: both runs, and [8]'s draw (rank 0 holds the first
    # slice of each split leaf); rank 0's gradients before the sync
    same_start = all(torch.equal(a, b) for a, b in zip(
        card(tuned["init_params"]), card(xla["init_params"]))) and \
        tuned["local_grads0_fingerprint"] == \
        xla["local_grads0_fingerprint"] and all(
            torch.equal(held, first_slice(whole, held.shape))
            for held, whole in zip(pytree.leaves(tuned["init_params"]),
                                   pytree.leaves(oracle["init_params"])))
    grad = grad_reading(card(tuned["grads0"]), card(xla["grads0"]))
    loss_diff = abs(tuned["losses"][0] - xla["losses"][0])
    gx8 = card(oracle["grads0"])
    vs8 = {}
    for label, r in runs.items():
        per_leaf = allclose_reading(card(r["grads0_whole"]), gx8)
        vs8[label] = {"grad_bf16": max(per_leaf.values()),
                      "loss": abs(r["losses"][0] - oracle["loss"])}
    del gx8
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fp32 = grp.spawn(_tp_fp32_rank, TRAIN_RANKS, (TP_FP32_LAYERS,))
    fp32_s = time.perf_counter() - t1
    names = fp32["names"]
    worst = sorted(fp32["grad"], key=fp32["grad"].get, reverse=True)[:3]
    fp32_grad = max(fp32["grad"].values())
    fp32_loss = abs(fp32["tp_loss"] - fp32["loss"])
    log(f"    tuned vs xla: step 0's synced gradients (rank 0's slices) "
        f"within {grad:.3g} (tol {TRAIN_GRAD_TOL}), step 0's losses "
        f"within {loss_diff:.3g} (tol {TRAIN_LOSS_TOL}); the same start "
        f"(and [8]'s, sliced) and rank 0's gradients before the sync "
        f"bit-equal: {same_start}")
    for label, v in vs8.items():
        log(f"    {label} vs [8] xla step 0 (bf16): loss within "
            f"{v['loss']:.3g} (tol {TRAIN_LOSS_TOL}); synced gradients "
            f"gathered over model {v['grad_bf16']:.3g} (not held: bf16's "
            f"floor, see TP_GRAD_TOL)")
    log(f"    fp32, {TP_FP32_LAYERS} layers, 4 ranks, 2 x 2 against 4 x 1 "
        f"({fp32_s:.1f}s): synced "
        f"gradients gathered over model within {fp32_grad:.3g} (tol "
        f"{TP_GRAD_TOL}; worst "
        + ", ".join(f"{names[j]} {fp32['grad'][j]:.3g}" for j in worst)
        + f"), loss within {fp32_loss:.3g}; planted: " + "; ".join(
            f"{k} {v:.3g} (>= {10 * TP_GRAD_TOL})"
            for k, v in fp32["faults"].items()))
    if not same_start or grad > TRAIN_GRAD_TOL or \
            loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError("[8t] the tuned run departs from the xla run")
    if any(v["loss"] > TRAIN_LOSS_TOL for v in vs8.values()) or \
            fp32_grad > TP_GRAD_TOL or fp32_loss > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8t] the split step departs from the "
                             f"unsplit one: {vs8}, fp32 {fp32_grad}")
    if not fp32["faults"] or any(v < 10 * TP_GRAD_TOL
                                 for v in fp32["faults"].values()):
        raise AssertionError(f"[8t] a planted fault reads under 10x the "
                             f"tolerance: {fp32['faults']}")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "peak_mem_bytes", "launches", "plan_entries", "plan_combines",
            "describe", "wall_s", "param_elems", "leaves", "tp_split")
    summary = {"tuned": {k: tuned[k] for k in keep},
               "xla": {k: xla[k] for k in keep},
               "tuned_vs_xla": {"grad": grad, "loss": loss_diff},
               "vs_8_xla_step0": vs8,
               "fp32": {"grad": fp32_grad, "loss": fp32_loss,
                        "worst": {names[j]: fp32["grad"][j]
                                  for j in worst},
                        "planted": fp32["faults"], "seconds": fp32_s},
               "overlapped": overlapped,
               "phase_s": time.perf_counter() - t0}
    log(f"    [8t] + [8tc] {summary['phase_s']:.1f}s")
    return summary, {"train_tp_tuned": tuned["launches"],
                     "train_tp_xla": xla["launches"],
                     "train_tp_overlapped": overlapped["launches"]}


def overlapped_tp_run(tuned, card):
    """[8tc] [8t]'s tuned run again with ``--overlap-backward``: each
    released layer synced over ``data`` on the sync thread while the
    backward's model-axis all-reduces run on the main thread, under the
    memory log; held to the tuned run (step 0's synced gradients within
    ``TRAIN_GRAD_TOL``, the losses within ``TRAIN_LOSS_TOL``, rank 0's
    gradients before the sync bit-equal, the thread busy in every step,
    releases 29...0 in every rank and step). Returns its summary."""
    from repro_torch import pytree
    steps_n = TP_TRAIN_STEPS["tuned"]
    with memory_log("8tc"):
        r = train_run("8tc", "tuned, overlapped on the sync thread",
                      [*TP_TRAIN_ARGS, "--steps", str(steps_n),
                       "--tuning-table", FLAT_TABLE, "--overlap-backward"])
    grad = grad_reading(card(r["grads0"]), card(tuned["grads0"]))
    loss = max(abs(a - b) for a, b in zip(r["losses"], tuned["losses"]))
    order = list(reversed(range(30)))
    bad = [k for k, ok in (
        ("device", r["device"] == "cuda:0" and r["ranks"] == TRAIN_RANKS),
        ("replicas", all(r["replicas_equal"])),
        ("launches", r["launches"] == expected_tp_launches(r, steps_n)),
        ("combines", r["plan_combines"] > 0),
        ("release order", r["release_events"]
         == [[order] * TRAIN_RANKS] * steps_n),
        ("sync thread busy every step", len(r["release_sync_s"])
         == steps_n and all(t > 0 for t in r["release_sync_s"])),
        ("gradients before the sync", r["local_grads0_fingerprint"]
         == tuned["local_grads0_fingerprint"])) if not ok]
    log(f"    overlapped vs [8t] tuned: step 0's synced gradients within "
        f"{grad:.3g} (tol {TRAIN_GRAD_TOL}), losses within {loss:.3g} (tol "
        f"{TRAIN_LOSS_TOL}); {r['plan_entries']} sync collectives and "
        f"{r['plan_combines']} combines a step ([8t]: "
        f"{tuned['plan_entries']}, {tuned['plan_combines']})")
    for i in range(steps_n):
        log(f"    step {i}: compute / exposed sync / optimizer s, "
            f"overlapped {r['compute_s'][i]:.4f} / {r['sync_s'][i]:.4f} / "
            f"{r['opt_s'][i]:.4f} (sync thread {r['release_sync_s'][i]:.4f})"
            f", [8t] tuned {tuned['compute_s'][i]:.4f} / "
            f"{tuned['sync_s'][i]:.4f} / {tuned['opt_s'][i]:.4f}")
    if bad or grad > TRAIN_GRAD_TOL or loss > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8tc] the overlapped run departs from [8t]'s "
                             f"tuned run: {bad}, gradients {grad}, losses "
                             f"{loss}; launches {r['launches']}")
    out = {k: r[k] for k in ("losses", "step_s", "compute_s", "sync_s",
                             "opt_s", "release_sync_s", "peak_mem_bytes",
                             "launches", "plan_entries", "plan_combines")}
    out.update(grad_reading=grad, loss_diff=loss)
    return out


# ---------------------------------------------------------------------------
# [8f] FSDP: whisper-large-v3 sharded over the 2 x 2 data axes
# ---------------------------------------------------------------------------
# params a rank, by hand from the leaf shapes (d 1280, 20 heads of 64, ff
# 5120, vocab 51866 padded to 51968, 4096 decoder positions, 1500
# frames): the sharded leaves are tok and out (2 x 51968 x 1280) and a
# layer's attention (4 x 1280 x 1280; the decoder's two) and MLP (2 x
# 1280 x 5120), a quarter of each a rank; the replicated ones are pos
# (4096 x 1280), enc_pos (1500 x 1280), the final norms (3 x 1280) and
# the layer norms (2 x 1280 each: 2 an encoder layer, 3 a decoder one).
# 2 + 2 layers: 224,788,480 / 4 + 7,192,320 = 63,389,440 (231,980,800
# whole); 8 + 8: 500,039,680 / 4 + 7,269,120 = 132,279,040; 32 + 32:
# 1,601,044,480 / 4 + 7,576,320 = 407,837,440 (1,608,620,800 whole);
# leaves (sharded, replicated) 34 + 25, 130 + 85 and 514 + 325
FSDP_RUNS = {
    "2+2": {"param_elems": 63389440, "leaves": (34, 25), "layers": 4},
    "8+8": {"param_elems": 132279040, "leaves": (130, 85), "layers": 16},
}
# the deeper run: one step, bf16 gathers and reduce-scatters
# (gather_in_compute_dtype), 4 x 256 tokens over 4 x 1500 frames (one row
# a rank): at [8w]'s 8 x 256 the four ranks ran out of the card's memory
# with 18.5-18.7 GiB allocated each, 1 row a rank peaks at 14.76 GiB at
# 32 + 32 (PERF.md §6). Depth cut 32 + 32 -> 8 + 8 for the script's
# time: [8ft] (b) trains the full depth under FSDP with the model axis
FSDP_DEEP_ARGS = ["--arch", "whisper-large-v3", "--ranks", "4",
                  "--topology", "2x2", "--steps", "1", "--seq", "256",
                  "--batch", "4", "--collective", "xla"]
FSDP_DEEP_CONFIG = {"num_layers": 8, "encoder_layers": 8}


def fsdp_checks(r, run, steps):
    """What every [8f] run must show: the mesh, params a rank, the
    sharded and replicated leaves, the replicas, finite losses, one
    gather and one reduce-scatter a layer and one for the rest of the
    tree, and the flash kernels a layer a rank-step (no combine, no SSD
    kernel); the names of the checks that fail."""
    from repro_torch.kernels import attention_bwd
    spec = FSDP_RUNS[run]
    sharded, replicated = spec["leaves"]
    per = spec["layers"] * steps * TRAIN_RANKS
    want = {"flash_attention": per,
            "flash_attention_bwd": per * attention_bwd.LAUNCHES_PER_CALL,
            "ssd_chunk": 0, "ssd_chunk_bwd": 0, "segment_combine": 0}
    return [k for k, ok in (
        ("device", r["device"] == "cuda:0" and r["ranks"] == TRAIN_RANKS),
        ("mesh", r["mesh"] == {"pod": 2, "data": 2, "model": 1}),
        ("params a rank", r["param_elems"] == spec["param_elems"]),
        ("leaves", r["fsdp"] == {"data_axes": ["pod", "data"],
                                 "sharded_leaves": sharded,
                                 "replicated_leaves": replicated}),
        ("collectives", r["collectives"]["gathers"] ==
         r["collectives"]["reduce_scatters"] == 1 + spec["layers"]),
        ("replicas", r["replicas_equal_at_init"]
         and all(r["replicas_equal"])),
        ("losses", len(r["losses"]) == steps
         and all(x == x and 0 < x < 20 for x in r["losses"])),
        ("launches", r["launches"] == want)) if not ok]


def phase_training_fsdp():
    """[8f] whisper-large-v3 trained under FSDP on 4 ranks
    (``("pod", "data")`` = 2 x 2, each rank holding a quarter of every
    weight the data axes divide): (a) [8w]'s 2 + 2-layer ``"xla"`` run
    again with FSDP, held to it (step 0's loss bit-equal, its synced
    gradients gathered whole within ``TRAIN_GRAD_TOL``, the params'
    change within ``TRAIN_CHANGE_TOL``, the losses within
    ``TRAIN_LOSS_TOL``); (b) the model at 8 + 8 layers (cut from 32 + 32,
    which [8ft] trains), one step, bf16 gathers. Returns the summary and
    the launch counts by path."""
    from repro_torch import pytree
    from repro_torch.configs.base import ParallelConfig
    t0 = time.perf_counter()
    spec = TRAIN_MODELS["whisper-large-v3"]
    oracle = STEP0_ORACLE["whisper-large-v3"]
    a = train_run("8f", "2 + 2 layers, held to [8w] xla",
                  ["--arch", "whisper-large-v3", *TRAIN_ARGS, "--collective",
                   "xla"], config=spec["config"],
                  parallel=ParallelConfig(shard_params_over_data=True))

    def card(tree):
        return [t.to("cuda", torch.float64) for t in pytree.leaves(tree)]
    init = card(oracle["init_params"])
    same_start = all(torch.equal(x, y) for x, y in
                     zip(card(a["init_params"]), init))
    grad = grad_reading(card(a["grads0"]), card(oracle["grads0"]))
    change = change_reading(card(a["params"]), init,
                            card(oracle["params"]))
    del init
    torch.cuda.empty_cache()
    loss0_equal = a["losses"][0] == oracle["loss"]
    loss_diff = max(abs(x - y) for x, y in zip(a["losses"],
                                               oracle["losses"]))
    log(f"    vs [8w] xla: the same start {same_start}; step 0's loss "
        f"bit-equal {loss0_equal}; step 0's synced gradients within "
        f"{grad:.3g} (tol {TRAIN_GRAD_TOL}); the params' change within "
        f"{change:.3g} (tol {TRAIN_CHANGE_TOL}); losses within "
        f"{loss_diff:.3g} (tol {TRAIN_LOSS_TOL})")
    bad = fsdp_checks(a, "2+2", TRAIN_STEPS)
    if bad or not same_start or not loss0_equal or grad > TRAIN_GRAD_TOL \
            or change > TRAIN_CHANGE_TOL or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8f] 2 + 2 under FSDP: {bad}; launches "
                             f"{a['launches']}, {a['param_elems']} params "
                             f"a rank, {a.get('fsdp')}")
    b = train_run("8f", "8 + 8 layers", FSDP_DEEP_ARGS,
                  config=FSDP_DEEP_CONFIG,
                  parallel=ParallelConfig(shard_params_over_data=True,
                                          gather_in_compute_dtype=True),
                  keep=False)
    bad = fsdp_checks(b, "8+8", 1)
    peak = [x / 2**30 for x in b["peak_mem_bytes"]]
    log(f"    8 + 8 layers: {b['param_elems']} params a rank; peak "
        f"{', '.join(f'{x:.2f}' for x in peak)} GiB a rank "
        f"({sum(peak):.2f} in all); step {b['step_s'][0]:.2f} s, of which "
        f"gathers {b['gather_s'][0]:.2f} s and reduce-scatters "
        f"{b['reduce_scatter_s'][0]:.2f} s (slowest rank's)")
    if bad:
        raise AssertionError(f"[8f] 8 + 8 layers: {bad}; launches "
                             f"{b['launches']}, {b['param_elems']} params "
                             f"a rank, {b.get('fsdp')}")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "gather_s", "reduce_scatter_s", "collectives",
            "peak_mem_bytes", "launches", "param_elems", "fsdp", "wall_s")
    summary = {"2+2": {k: a[k] for k in keep},
               "8+8": {k: b[k] for k in keep},
               "vs_8w_xla": {"loss0_equal": loss0_equal, "grad": grad,
                             "change": change, "loss": loss_diff},
               "phase_s": time.perf_counter() - t0}
    log(f"    [8f] {summary['phase_s']:.1f}s")
    return summary, {"train_whisper-large-v3_fsdp": a["launches"],
                     "train_whisper-large-v3_fsdp_8+8": b["launches"]}


# ---------------------------------------------------------------------------
# [8ft] / [8mf] FSDP with the model axis: both halves of param_specs
# ---------------------------------------------------------------------------
# whisper-large-v3 on ("data", "model") = 2 x 2: every sharded leaf of
# [8f] is also split over model (20 heads, d_ff 5120 and the padded vocab
# divide 2), so a rank holds a quarter of it, as under [8f]: params a
# rank and leaves (cut by both, whole) as [8f]'s at the same depth; the
# run without FSDP on the same mesh holds half of each split leaf
FSDP_MODEL_RUNS = {
    "2+2": {"param_elems": 63389440, "leaves": {"data": 0, "model": 0,
                                                "both": 34, "neither": 25},
            "layers": 4, "tp_param_elems": 119586560},
    "full": {"param_elems": 407837440, "leaves": {"data": 0, "model": 0,
                                                  "both": 514,
                                                  "neither": 325},
             "layers": 64},
}
FSDP_MODEL_ARGS = ["--arch", "whisper-large-v3", "--ranks", "4",
                   "--model-parallel", "2", "--seq", "256",
                   "--collective", "xla"]
# (a) [8w]'s batch, 2 steps; (b) full depth, one step, 2 x 256 over 2 x
# 1500 frames: one row a data rank, as [8f] (b) held. At [8f] (b)'s 4 x
# 256 (two rows a data rank) the four ranks ran out of the card's memory
# with 18.2 GiB allocated each, in the decoder's plain cross-attention
# (PERF.md §6): the model axis halves the kept bf16 weights
# and the blocks' inner activations, not the residual stream
FSDP_MODEL_A = ["--steps", "2", "--batch", "8"]
FSDP_MODEL_FULL = ["--steps", "1", "--batch", "2"]
# olmoe-1b-7b as [8m] "xla" (full width, 1 layer, 2 x 2, 8 x 256, bf16
# compute), each expert stack (E/2, d/2, ff) and every other weight but
# the norms split over data: 2 x 50432 x 2048 (tok, out) + 4 x 2048 x
# 2048 (attention) + 2048 x 64 (router), halved; 3 x 64 x 2048 x 1024
# (experts), quartered; 3 x 2048 norms whole
MOE_FSDP_PARAM_ELEMS = 212408320
MOE_FSDP_LEAVES = {"data": 7, "model": 0, "both": 3, "neither": 3}
MOE_FSDP_EXPERT_SHAPE = [32, 1024, 1024]
# FSDP against the same step without it (tests/test_torch_fsdp.py): the
# reduce-scatter sums the data ranks' gradients in another order than
# the all-reduce, |got - want| / max|want| a leaf
SELF_TOL = 1e-6


def fsdp_model_checks(r, want_layout, leaves, param_elems, layers, steps):
    """What every [8ft] / [8mf] run must show: the mesh and layout,
    params a rank, the leaves by the halves that cut them, the gather
    points (one a layer and one for the rest of the tree), model-axis
    collectives, the replicas, finite losses, and the flash kernels a
    layer a rank-step (no combine, no SSD kernel); the names of the
    checks that fail."""
    from repro_torch.kernels import attention_bwd
    per = layers * steps * TRAIN_RANKS
    want = {"flash_attention": per,
            "flash_attention_bwd": per * attention_bwd.LAUNCHES_PER_CALL,
            "ssd_chunk": 0, "ssd_chunk_bwd": 0, "segment_combine": 0}
    c = r.get("collectives", {})
    return [k for k, ok in (
        ("device", r["device"] == "cuda:0" and r["ranks"] == TRAIN_RANKS),
        ("mesh", r["mesh"] == {"data": 2, "model": 2}),
        ("layout", r["layout"] == want_layout),
        ("params a rank", r["param_elems"] == param_elems),
        ("leaves", leaves is None or r["fsdp"]["leaves"] == leaves),
        ("gathers", leaves is None or c.get("gathers") ==
         c.get("reduce_scatters") == 1 + layers),
        ("model collectives", c.get("model_all_reduces", 1) > 0),
        ("replicas", r["replicas_equal_at_init"]
         and all(r["replicas_equal"])),
        ("losses", len(r["losses"]) == steps
         and all(x == x and 0 < x < 20 for x in r["losses"])),
        ("launches", r["launches"] == want)) if not ok]


def leaf_reading(got, want) -> float:
    """max over the leaves of max|got - want| / max|want| (float64 on the
    card): ``tests/test_torch_fsdp.py``'s per-leaf scale."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to("cuda", torch.float64), w.to("cuda", torch.float64)
        scale = w.abs().max().item() or 1.0
        worst = max(worst, (g - w).abs().max().item() / scale)
    return worst


def _log_fsdp_model_run(tag, r):
    c = r["collectives"]
    peak = [x / 2**30 for x in r["peak_mem_bytes"]]
    for i in range(len(r["losses"])):
        log(f"    [{tag}] step {i}: {r['step_s'][i]:.3f} s; fwd+bwd "
            f"{r['compute_s'][i]:.3f} (gathers {r['gather_s'][i]:.3f}, "
            f"reduce-scatters {r['reduce_scatter_s'][i]:.3f}, model-axis "
            f"collectives {r['model_s'][i]:.3f}), sync {r['sync_s'][i]:.3f},"
            f" AdamW {r['opt_s'][i]:.3f} (slowest rank's)")
    log(f"    [{tag}] {r['param_elems']} params a rank, leaves "
        f"{r['fsdp'].get('leaves')}; collectives a step {c}; peak "
        f"{', '.join(f'{x:.2f}' for x in peak)} GiB a rank "
        f"({sum(peak):.2f} in all); flash launches {r['launches']}")


def phase_training_fsdp_model():
    """[8ft] whisper-large-v3 under FSDP + tensor parallelism on 4
    ranks, ``("data", "model")`` = 2 x 2, untuned: (a) 2 + 2
    layers, fp32 compute, 2 steps, held to the same run without FSDP on
    the same mesh (the tensor-parallel step): step 0's loss bit-equal,
    its synced gradients gathered whole within `SELF_TOL` of each leaf's
    scale, the params' change within ``TRAIN_CHANGE_TOL``; (b) full depth
    (32 + 32 layers), one step, bf16 gathers, 2 x 256. [8mf] olmoe-1b-7b
    under FSDP + expert parallelism, [8m]'s "xla" run with
    ``shard_params_over_data``, held to it (the same start, step 0's
    loss bit-equal, the synced gradients within ``TRAIN_GRAD_TOL``, the
    change within ``TRAIN_CHANGE_TOL``). Returns the summary and the
    launch counts by path."""
    from repro_torch import pytree
    from repro_torch.configs.base import ParallelConfig
    t0 = time.perf_counter()
    spec = TRAIN_MODELS["whisper-large-v3"]
    fp32 = ParallelConfig(compute_dtype="float32")
    runs = {}
    for label, parallel in (("tp", fp32), ("fsdp+tp", dataclasses.replace(
            fp32, shard_params_over_data=True))):
        runs[label] = train_run("8ft", f"(a) 2 + 2 layers, fp32, {label}",
                                [*FSDP_MODEL_ARGS, *FSDP_MODEL_A],
                                config=spec["config"], parallel=parallel)
    tp, a = runs["tp"], runs["fsdp+tp"]
    run = FSDP_MODEL_RUNS["2+2"]
    bad = fsdp_model_checks(a, "fsdp+tp", run["leaves"], run["param_elems"],
                            run["layers"], TRAIN_STEPS)
    bad += [f"tp {k}" for k in fsdp_model_checks(
        tp, "tp", None, run["tp_param_elems"], run["layers"], TRAIN_STEPS)]

    def card(tree):
        return [t.to("cuda", torch.float64) for t in pytree.leaves(tree)]
    # the tensor-parallel run keeps rank 0's slices (model coordinate 0:
    # the first slice of each split leaf) and its gradients gathered
    # whole; the FSDP run whole leaves
    init = [first_slice(w, h.shape) for w, h in zip(
        card(a["init_params"]), card(tp["init_params"]))]
    same_start = all(torch.equal(x, y) for x, y in
                     zip(init, card(tp["init_params"])))
    grad = leaf_reading(card(a["grads0"]), card(tp["grads0_whole"]))
    final = [first_slice(w, h.shape) for w, h in zip(
        card(a["params"]), card(tp["params"]))]
    change = change_reading(final, init, card(tp["params"]))
    del init, final
    torch.cuda.empty_cache()
    loss0_equal = a["losses"][0] == tp["losses"][0]
    loss_diff = max(abs(x - y) for x, y in zip(a["losses"], tp["losses"]))
    _log_fsdp_model_run("8ft a", a)
    log(f"    [8ft] (a) vs the same run without FSDP: the same start "
        f"{same_start}; step 0's loss bit-equal {loss0_equal}; step 0's "
        f"synced gradients within {grad:.3g} of each leaf's scale (tol "
        f"{SELF_TOL}); the params' change within {change:.3g} (tol "
        f"{TRAIN_CHANGE_TOL}); losses within {loss_diff:.3g}; steps "
        + " ".join(f"{x:.3f}" for x in tp["step_s"]) + " s without FSDP")
    if bad or not same_start or not loss0_equal or grad > SELF_TOL \
            or change > TRAIN_CHANGE_TOL or loss_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8ft] (a): {bad}; launches {a['launches']},"
                             f" {a['param_elems']} params a rank, "
                             f"{a.get('fsdp')}")
    for r in (tp, a):
        for k in ("init_params", "params", "grads0", "grads0_whole"):
            r.pop(k, None)
    run = FSDP_MODEL_RUNS["full"]
    b = train_run("8ft", "(b) full depth (32 + 32 layers), bf16 gathers",
                  [*FSDP_MODEL_ARGS, *FSDP_MODEL_FULL],
                  parallel=ParallelConfig(shard_params_over_data=True,
                                          gather_in_compute_dtype=True),
                  keep=False)
    _log_fsdp_model_run("8ft b", b)
    bad = fsdp_model_checks(b, "fsdp+tp", run["leaves"], run["param_elems"],
                            run["layers"], 1)
    if bad:
        raise AssertionError(f"[8ft] (b): {bad}; launches {b['launches']}, "
                             f"{b['param_elems']} params a rank, "
                             f"{b.get('fsdp')}")
    # [8mf]
    oracle = STEP0_ORACLE["olmoe-1b-7b"]
    m = train_run("8mf", "olmoe under FSDP + EP, held to [8m] xla",
                  [*MOE_TRAIN_ARGS, "--collective", "xla"],
                  config=MOE_TRAIN_CONFIG,
                  parallel=ParallelConfig(shard_params_over_data=True))
    _log_fsdp_model_run("8mf", m)
    bad = fsdp_model_checks(m, "fsdp+ep", MOE_FSDP_LEAVES,
                            MOE_FSDP_PARAM_ELEMS,
                            MOE_TRAIN_CONFIG["num_layers"], MOE_TRAIN_STEPS)
    bad += [k for k, ok in (
        ("experts", m["experts"] == MOE_EXPERTS),
        ("expert stack a rank", m["expert_shape"] == MOE_FSDP_EXPERT_SHAPE),
        ("a2a", m["collectives"].get("model_all_to_alls") ==
         4 * MOE_TRAIN_CONFIG["num_layers"])) if not ok]
    # [8m] keeps rank 0's expert slices (the first 32 experts), [8mf]
    # whole leaves
    init = [first_slice(w, h.shape) for w, h in zip(
        card(m["init_params"]), card(oracle["init_params"]))]
    m_same = all(torch.equal(x, y) for x, y in
                 zip(init, card(oracle["init_params"])))
    m_grad = grad_reading([first_slice(w, h.shape) for w, h in zip(
        card(m["grads0"]), card(oracle["grads0"]))], card(oracle["grads0"]))
    final = [first_slice(w, h.shape) for w, h in zip(
        card(m["params"]), card(oracle["params"]))]
    m_change = change_reading(final, init, card(oracle["params"]))
    del init, final
    torch.cuda.empty_cache()
    m_loss0 = m["losses"][0] == oracle["loss"]
    m_loss = max(abs(x - y) for x, y in zip(m["losses"], oracle["losses"]))
    log(f"    [8mf] vs [8m] xla: the same start {m_same}; step 0's loss "
        f"bit-equal {m_loss0}; step 0's synced gradients within "
        f"{m_grad:.3g} (tol {TRAIN_GRAD_TOL}); the params' change within "
        f"{m_change:.3g} (tol {TRAIN_CHANGE_TOL}); losses within "
        f"{m_loss:.3g}; expert stack a rank {m['expert_shape']} (experts "
        f"{m['experts']})")
    if bad or not m_same or not m_loss0 or m_grad > TRAIN_GRAD_TOL \
            or m_change > TRAIN_CHANGE_TOL or m_loss > TRAIN_LOSS_TOL:
        raise AssertionError(f"[8mf]: {bad}; launches {m['launches']}, "
                             f"{m['param_elems']} params a rank, "
                             f"{m.get('fsdp')}, {m.get('collectives')}")
    keep = ("losses", "step_s", "compute_s", "sync_s", "opt_s",
            "gather_s", "reduce_scatter_s", "model_s", "collectives",
            "peak_mem_bytes", "launches", "param_elems", "fsdp", "wall_s",
            "param_elems_by_rank", "step_collectives", "step_peak_bytes")
    summary = {"2+2": {k: a[k] for k in keep},
               "2+2_tp": {k: tp[k] for k in keep if k in tp},
               "full": {k: b[k] for k in keep},
               "olmoe": {**{k: m[k] for k in keep},
                         "expert_shape": m["expert_shape"]},
               "vs_tp": {"loss0_equal": loss0_equal, "grad": grad,
                         "change": change, "loss": loss_diff},
               "olmoe_vs_8m_xla": {"loss0_equal": m_loss0, "grad": m_grad,
                                   "change": m_change, "loss": m_loss},
               "phase_s": time.perf_counter() - t0}
    log(f"    [8ft] + [8mf] {summary['phase_s']:.1f}s")
    return summary, {"train_whisper-large-v3_fsdp_tp": a["launches"],
                     "train_whisper-large-v3_tp": tp["launches"],
                     "train_whisper-large-v3_fsdp_tp_full": b["launches"],
                     "train_olmoe_fsdp_ep": m["launches"]}


# ---------------------------------------------------------------------------
# [9] compile-free accounting held to [8ft] (b) and [8mf]
# ---------------------------------------------------------------------------
# peak predicted / measured: the band the trace of a rank's step must fall
# in against torch.cuda.max_memory_allocated of the same rank's step
PEAK_BAND = (0.8, 1.2)
#: the dry-runs the phase runs as subprocesses, each must exit 0
DRYRUNS = (("smollm-135m", "decode_32k"), ("whisper-large-v3", "train_4k"))


def accounting_cases():
    """[8ft] (b) and [8mf] as the phase traces them: ``{tag: (config,
    shape, parallel, the run's key in [8ft]'s summary)}``."""
    from repro_torch.configs import ARCHITECTURES
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    whisper = ShapeConfig("8ft_b", 256, 2, "train")
    return {
        "8ft b": (ARCHITECTURES["whisper-large-v3"], whisper,
                  ParallelConfig(shard_params_over_data=True,
                                 gather_in_compute_dtype=True), "full"),
        "8mf": (ARCHITECTURES["olmoe-1b-7b"].replace(**MOE_TRAIN_CONFIG),
                ShapeConfig("8mf", 256, 8, "train"),
                ParallelConfig(shard_params_over_data=True), "olmoe")}


def phase_accounting(fsdp_model, smi):
    """[9] The dry-run's trace (``launch/dryrun.py``: one rank's step on
    ``meta`` over a recording 2 x 2 mesh, ``group.MetaMesh``) of [8ft] (b)
    and [8mf], at the coordinate of each of the four ranks, held to the
    same rank's step on the card (``fsdp_model``: [8ft]'s summary; ``smi``
    the card's name and power limit; no new
    GPU step): params a rank equal; the collectives of step 0 by kind and
    axis equal in count and bytes; the flash launches the plan's (the
    measured ones); the peak within `PEAK_BAND` of the rank's step peak
    (``max_memory_allocated`` with its arguments live). Rank 0 goes
    through ``accounting_metrics`` (1 and 2 layer units and full depth,
    the extrapolation checked exactly). Also prints FLOPs a rank beside
    ``model_flops``, the achieved rate over the measured forward+backward,
    the predicted peak of [8ft] (b) at two rows a data rank against a
    quarter of the card's free memory with its largest live tensors, and
    runs `DRYRUNS` as subprocesses. Returns the summary."""
    import subprocess
    from repro_torch.configs.base import CollectiveConfig
    from repro_torch.core.collectives import group as grp
    from repro_torch.kernels import attention_bwd
    from repro_torch.launch import accounting as acct
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out_dir], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for arch, shape in DRYRUNS]
    free, _ = torch.cuda.mem_get_info()
    coll = CollectiveConfig()
    summary, bad = {}, []
    for tag, (cfg, shape, parallel, key) in accounting_cases().items():
        run = fsdp_model[key]
        rows = []
        for r in range(TRAIN_RANKS):
            mesh = grp.MetaMesh((2, 2), ("data", "model"), divmod(r, 2))
            t1 = time.perf_counter()
            if r == 0:
                m = dryrun.accounting_metrics(cfg, shape, parallel, coll,
                                              mesh)
                c = m["trace"]
            else:
                c, _, _ = dryrun.trace_step(cfg, shape, parallel, coll, mesh)
            got_coll = c.record.by_kind()
            peak = c.memory["peak_bytes_per_device"]
            measured = max(run["step_peak_bytes"][r])
            rows.append({"params": c.params, "collectives": got_coll,
                         "flops": c.flops, "bytes": c.bytes,
                         "kernels": dict(c.kernels), "peak_bytes": peak,
                         "measured_peak_bytes": measured,
                         "peak_ratio": peak / measured,
                         "trace_s": time.perf_counter() - t1})
            if r == 0:
                rows[0].update(units=m["units"],
                               per_unit_flops=m["per_unit_flops"],
                               largest_at_peak=c.largest(10),
                               by_op_at_peak=c.by_op(10))
            lo, hi = PEAK_BAND
            bad += [f"{tag} rank {r} {k}" for k, ok in (
                ("params", c.params == run["param_elems_by_rank"][r]),
                ("collectives", got_coll == run["step_collectives"][r]),
                ("peak", lo <= peak / measured <= hi)) if not ok]
            log(f"    [9] {tag} rank {r}: params {c.params} (measured "
                f"{run['param_elems_by_rank'][r]}); collectives "
                + ", ".join(f"{k} {v['count']} x {v['bytes']} B"
                            for k, v in got_coll.items())
                + f" (equal to the card's step 0: "
                f"{got_coll == run['step_collectives'][r]}); peak "
                f"{peak / 2**30:.3f} GiB predicted, {measured / 2**30:.3f} "
                f"measured ({peak / measured:.3f}); "
                f"{rows[-1]['trace_s']:.1f}s")
        steps_n = len(run["losses"])
        plan = {"flash_attention": rows[0]["kernels"]["flash_attention"]
                * TRAIN_RANKS * steps_n,
                "flash_attention_bwd": rows[0]["kernels"]["flash_attention"]
                * TRAIN_RANKS * steps_n * attention_bwd.LAUNCHES_PER_CALL}
        traced = {k: sum(row["kernels"].get(k, 0) for row in rows) * steps_n
                  for k in plan}
        measured = {k: run["launches"][k] for k in plan}
        if not traced == plan == measured:
            bad.append(f"{tag} flash launches {traced} traced, {plan} "
                       f"planned, {measured} measured")
        flops = sum(row["flops"] for row in rows)
        fwd_bwd = run["compute_s"][0]
        rate = flops / fwd_bwd
        mf = acct.model_flops(cfg, shape)
        log(f"    [9] {tag}: flash launches {traced} traced = {plan} "
            f"planned = {measured} measured; FLOPs a rank "
            f"{rows[0]['flops']:.6g} (model_flops {mf / TRAIN_RANKS:.6g} a "
            f"rank, {mf:.6g} in all; per unit {rows[0]['per_unit_flops']} "
            f"over {rows[0]['units']} units, extrapolation exact); "
            f"achieved {rate / 1e12:.4f} TFLOP/s over step 0's "
            f"forward+backward of {fwd_bwd:.3f} s (four ranks, the "
            f"arena collectives inside), {rate / acct.PEAK_FLOPS:.3e} of "
            f"989 TFLOP/s bf16 on {smi}")
        summary[tag] = {"ranks": rows, "launches": traced,
                        "model_flops": mf, "achieved_flops_per_s": rate}
    # [8ft] (b) at two rows a data rank, which ran the card out of memory
    cfg, shape, parallel, _ = accounting_cases()["8ft b"]
    two = dataclasses.replace(shape, global_batch=2 * shape.global_batch)
    c, _, _ = dryrun.trace_step(cfg, two, parallel, coll,
                                grp.MetaMesh((2, 2), ("data", "model")))
    peak = c.memory["peak_bytes_per_device"]
    summary["8ft b two rows"] = {
        "peak_bytes": peak, "quarter_free_bytes": free / 4,
        "largest_at_peak": c.largest(10), "by_op_at_peak": c.by_op(10)}
    log(f"    [9] [8ft] (b) at two rows a data rank: {peak / 2**30:.3f} "
        f"GiB a rank predicted against {free / 4 / 2**30:.3f} GiB, a "
        f"quarter of the card's free memory; live at the peak by op: "
        + ", ".join(f"{op} {b / 2**30:.3f} GiB ({n})"
                    for op, b, n in c.by_op(10))
        + "; largest: " + ", ".join(
            f"{x['op']} {x['shape']} {x['dtype']} {x['bytes'] / 2**20:.1f} "
            f"MiB" for x in c.largest(10)))
    for arch, shape, proc in procs:
        text, _ = proc.communicate(timeout=600)
        last = text.strip().splitlines()[-1] if text.strip() else ""
        log(f"    [9] dryrun {arch} {shape}: rc {proc.returncode}: {last}")
        path = os.path.join(out_dir, f"{arch}_{shape}_16x16_xla.json")
        if proc.returncode or not os.path.exists(path):
            bad.append(f"dryrun {arch} {shape} rc {proc.returncode}: "
                       f"{text[-2000:]}")
        else:
            with open(path) as f:
                rec = json.load(f)
            summary[f"dryrun {arch} {shape}"] = {
                k: rec[k] for k in ("memory", "cost", "roofline",
                                    "trace_s", "kernel_launches")}
    summary["phase_s"] = time.perf_counter() - t0
    log(f"    [9] {summary['phase_s']:.1f}s")
    if bad:
        raise AssertionError(f"[9]: {bad}")
    return summary


# ---------------------------------------------------------------------------
# [4t] tensor-parallel decode through the tuned Communicator
# ---------------------------------------------------------------------------
TP_ARGS = ["--arch", "smollm-135m", "--tensor-parallel", "4",
           "--tuning-table", FLAT_TABLE]


def phase_tp_decode(one_process):
    """[4t] smollm-135m at full width and depth served by 4 ranks on the
    card, each step's logits reassembled through the tuned collective:
    the fixed batch through all_gather and all_reduce, the continuous
    trace through all_gather. Each held to the one-process run of the
    same argv (``one_process``: [4]'s results by label): tokens equal,
    the fixed loop's last logits bit-equal, every rank's equal rank
    0's; the executed collective the printed one; the launches (summed
    over the ranks) the plan's. Returns the summary and the launches by
    path."""
    from repro_torch.launch import serve
    from repro_torch.launch.measure_collectives import combines_per_rank
    fixed, cont = SERVE_FIXED, SERVE_CONTINUOUS
    runs = [("tp_fixed_all_gather", "smollm_fixed", fixed, "all_gather"),
            ("tp_fixed_all_reduce", "smollm_fixed", fixed, "all_reduce"),
            ("tp_continuous_all_gather", "smollm_continuous", cont,
             "all_gather")]
    t0 = time.perf_counter()
    summary, paths = {}, {}
    for label, base, argv, coll in runs:
        full = [*TP_ARGS, *argv, "--tp-collective", coll]
        log(f"[4t] {label}: serve {' '.join(full)}")
        t1 = time.perf_counter()
        res = serve.main(full)
        wall = time.perf_counter() - t1
        one = one_process[base]
        nbytes, alg, seg = res["executed_spec"]
        p = 4
        if "tokens" in res:
            same = bool((res["tokens"] == one["tokens"]).all()) and \
                torch.equal(res["last_logits"], one["last_logits"])
            flash, paged = 30 * p, 0
        else:
            same = res["generated"] == one["generated"]
            flash = SERVE_REQUESTS * 30 * p
            paged = res["decode_steps"] * 30 * p
        combines = combines_per_rank(coll, alg, seg, p) * p * \
            res["decode_steps"]
        want = {"flash_attention": flash, "flash_attention_bwd": 0,
                "ssd_chunk": 0, "ssd_chunk_bwd": 0,
                "segment_combine": combines, "paged_attention": paged}
        log(f"    executed {res['executed']} (printed {nbytes} B -> {alg} "
            f"segments={seg}); per-token p50 {res['token_ms_p50']:.3f} p99 "
            f"{res['token_ms_p99']:.3f} ms (one process: "
            f"{one['token_ms_p50']:.3f} / {one['token_ms_p99']:.3f}), "
            f"{res['tok_per_s']:.1f} tok/s ({one['tok_per_s']:.1f}); "
            f"{res['decode_steps']} decode steps; tokens and logits equal to "
            f"the one-process run: {same}; ranks equal: "
            f"{res['ranks_equal']}; launches {res['launches']}; "
            f"{wall:.1f}s with set-up")
        bad = [k for k, ok in (
            ("one-process bits", same), ("ranks", res["ranks_equal"]),
            ("executed", res["executed"] == [(nbytes, alg, seg)]),
            ("launches", res["launches"] == want)) if not ok]
        if bad:
            raise AssertionError(f"[4t] {label}: {bad}; launches "
                                 f"{res['launches']} vs {want}")
        summary[label] = {k: res[k] for k in (
            "token_ms_p50", "token_ms_p90", "token_ms_p99", "tok_per_s",
            "decode_steps", "executed_spec") if k in res}
        summary[label].update(wall_s=wall, one_process={
            k: one[k] for k in ("token_ms_p50", "token_ms_p99",
                                "tok_per_s")})
        paths[label] = res["launches"]
    summary["phase_s"] = time.perf_counter() - t0
    log(f"    [4t] {summary['phase_s']:.1f}s")
    return summary, paths


# ---------------------------------------------------------------------------
# [10] the examples' counterparts
# ---------------------------------------------------------------------------
#: train_e2e's steps (the reference's default 15, cut for the script's
#: time); it checkpoints after half of them
E2E_STEPS = 8
#: keys and shapes of the full smollm-135m checkpoint, the reference's
E2E_MANIFEST = {"params/layers/attn/wq": [30, 576, 9, 64],
                "params/layers/mlp/w_up": [30, 576, 1536],
                "params/embed/tok": [49152, 576],
                "opt/.step": [],
                "opt/.mu/layers/mlp/w_up": [30, 576, 1536],
                "opt/.nu/layers/attn/wo": [30, 9, 64, 576]}
E2E_PARAMS = 162826560
QUICKSTART_STEPS = 2
QUICKSTART_MESH = (4, 2)
QUICKSTART_LAYERS = 2       # the reduced smollm-135m's


def phase_examples():
    """[10] ``repro_torch.examples`` on the card: (a) ``train_e2e``
    --full, checkpointed and resumed, against a straight run; (b)
    ``serve_decode``; (c) ``quickstart`` on 4 x 2. Returns the summary
    and the launch counts by path."""
    import math
    import shutil
    import tempfile

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_decode, train_e2e
    from repro_torch.kernels import attention_bwd
    t0 = time.perf_counter()
    counters = _counters()

    def zero():
        for mod in counters.values():
            mod.launches = 0

    def read():
        return {name: mod.launches for name, mod in counters.items()}

    # (a) the real config, a checkpoint in the reference's layout
    cfg = get_config("smollm-135m")
    tmp = tempfile.mkdtemp(prefix="e2e_ckpt_")
    try:
        ck = os.path.join(tmp, "ck")
        zero()
        resumed = train_e2e.run(cfg, steps=E2E_STEPS, seq=128, batch=4,
                                ckpt=ck, device="cuda")
        straight = train_e2e.run(cfg, steps=E2E_STEPS, seq=128, batch=4,
                                 device="cuda")
        torch.cuda.synchronize()
        e2e_launches = read()
        with open(os.path.join(ck, "manifest.json")) as f:
            manifest = json.load(f)
        ck_bytes = sum(os.path.getsize(os.path.join(ck, n))
                       for n in os.listdir(ck))
    finally:
        shutil.rmtree(tmp)
    same_params = all(torch.equal(a, b) for a, b in zip(
        pytree.leaves(resumed["params"]), pytree.leaves(straight["params"])))
    del resumed["params"], straight["params"]
    torch.cuda.empty_cache()
    shapes = {r["key"]: r["shape"] for r in manifest["leaves"]}
    n_params = sum(math.prod(r["shape"]) for r in manifest["leaves"]
                   if r["key"].startswith("params/"))
    runs = 2 * E2E_STEPS * cfg.num_layers
    want = {name: 0 for name in counters}
    want["flash_attention"] = runs
    want["flash_attention_bwd"] = runs * attention_bwd.LAUNCHES_PER_CALL
    log(f"[10a] train_e2e --full: {E2E_STEPS} steps, seq 128, batch 4, "
        f"checkpointed at step {E2E_STEPS // 2} ({ck_bytes} B, "
        f"{len(manifest['leaves'])} keys, save {resumed['save_s']:.2f} s, "
        f"restore {resumed['restore_s']:.2f} s)")
    log(f"    losses resumed  {' '.join(f'{x:.6f}' for x in resumed['losses'])}")
    log(f"    losses straight {' '.join(f'{x:.6f}' for x in straight['losses'])}")
    log(f"    s a step resumed {' '.join(f'{x:.4f}' for x in resumed['step_s'])}; "
        f"straight {' '.join(f'{x:.4f}' for x in straight['step_s'])}")
    log(f"    params {n_params}; launches {e2e_launches} (want {want}); "
        f"losses bit-equal {resumed['losses'] == straight['losses']}, "
        f"params bit-equal {same_params}")
    bad = [k for k, ok in (
        ("losses bit-equal", resumed["losses"] == straight["losses"]),
        ("params bit-equal", same_params),
        ("losses finite", all(x == x and 0 < x < 20
                              for x in resumed["losses"])),
        ("manifest", all(shapes.get(k) == v
                         for k, v in E2E_MANIFEST.items())),
        ("params", n_params == E2E_PARAMS),
        ("step", manifest["step"] == E2E_STEPS // 2),
        ("launches", e2e_launches == want)) if not ok]
    if bad:
        raise AssertionError(f"[10a] {bad}: {shapes if 'manifest' in bad else ''}")

    # (b) greedy decode through the dense cache, both windows
    small = cfg.reduced()
    decode = {}
    zero()
    for window in serve_decode.WINDOWS:
        r = serve_decode.run(small, window=window, device="cuda")
        tok = r["tokens"]
        if tok.shape != (serve_decode.B, serve_decode.GEN) or \
                int(tok.min()) < 0 or int(tok.max()) >= small.vocab_size:
            raise AssertionError(f"[10b] window {window}: tokens {tok}")
        decode[window] = {"tok_per_s": r["tok_per_s"],
                          "decode_s": r["decode_s"],
                          "first_tokens": tok[0, :8].tolist()}
    decode_launches = read()
    log(f"[10b] serve_decode: "
        + ", ".join(f"window {w} {v['tok_per_s']:.1f} tok/s"
                    for w, v in decode.items())
        + f"; launches {decode_launches}")

    # (c) the quickstart on the reference's mesh
    qs, qs_paths = {}, {}
    ranks = QUICKSTART_MESH[0] * QUICKSTART_MESH[1]
    for algo in quickstart.ALGORITHMS:
        r = quickstart.train(algo, steps=QUICKSTART_STEPS,
                             topology=QUICKSTART_MESH, device="cuda")
        per = QUICKSTART_LAYERS * QUICKSTART_STEPS * ranks
        want = {"flash_attention": per,
                "flash_attention_bwd": per * attention_bwd.LAUNCHES_PER_CALL,
                "ssd_chunk": 0, "ssd_chunk_bwd": 0,
                "segment_combine": QUICKSTART_STEPS * r["plan_combines"]}
        log(f"[10c] quickstart {algo}: losses "
            f"{' '.join(f'{x:.6f}' for x in r['losses'])}; s a step "
            f"{' '.join(f'{x:.3f}' for x in r['step_s'])}; {r['wall_s']:.1f}"
            f" s with set-up; launches {r['launches']} (want {want})")
        bad = [k for k, ok in (
            ("mesh", r["mesh"] == {"data": QUICKSTART_MESH[0],
                                   "model": QUICKSTART_MESH[1]}
             and r["ranks"] == ranks and r["device"] == "cuda:0"),
            ("replicas", all(r["replicas_equal"])),
            ("tuned", r["tuned"] == (algo != "xla")),
            ("combines", (r["launches"]["segment_combine"] > 0)
             == (algo != "xla")),
            ("launches", r["launches"] == want)) if not ok]
        if bad:
            raise AssertionError(f"[10c] {algo}: {bad}")
        qs[algo] = {k: r[k] for k in ("losses", "step_s", "wall_s",
                                      "launches", "plan_combines")}
        qs_paths[f"quickstart_{algo}"] = r["launches"]
    worst = max(abs(a - b) for algo in ("ring", "rabenseifner")
                for a, b in zip(qs[algo]["losses"], qs["xla"]["losses"]))
    log(f"    ring and rabenseifner against xla: losses within {worst:.3g} "
        f"(tol {TRAIN_LOSS_TOL})")
    if worst > TRAIN_LOSS_TOL:
        raise AssertionError(f"[10c] losses depart from xla's by {worst}")
    summary = {"train_e2e": {
        k: {"losses": r["losses"], "step_s": r["step_s"]}
        for k, r in (("resumed", resumed), ("straight", straight))},
        "ckpt": {"bytes": ck_bytes, "save_s": resumed["save_s"],
                 "restore_s": resumed["restore_s"], "params": n_params},
        "serve_decode": decode, "quickstart": qs, "quickstart_worst": worst,
        "phase_s": time.perf_counter() - t0}
    summary["train_e2e"]["launches"] = e2e_launches
    log(f"    [10] {summary['phase_s']:.1f}s")
    return summary, {"examples_train_e2e_full": e2e_launches,
                     "examples_serve_decode": decode_launches, **qs_paths}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    watch_memory("launcher")

    def mark(label):
        log(f"[t] {time.perf_counter() - t0:.1f}s after {label}")
    smi = phase_device()
    kernels = {"flash_attention": phase_kernel(),
               "flash_attention_bwd": phase_flash_backward(),
               "ssd_chunk": phase_ssd_kernel(),
               "ssd_chunk_bwd": phase_ssd_backward(),
               "segment_combine": phase_combine_kernel(),
               "paged_attention": phase_paged_kernel()}
    mark("[1]-[2f] kernels")
    diffs = {"smollm-135m": phase_model(),
             "mamba2-130m": phase_ssm_model("mamba2-130m", 2),
             "zamba2-2.7b": phase_ssm_model("zamba2-2.7b", 2)}
    # the model phases' paths, added to the kernels line below
    model_paths = {}
    diffs["whisper-large-v3"], n = phase_encdec_model()
    model_paths["prefill_whisper_fp32"] = {"flash_attention": n}
    diffs["llava-next-mistral-7b"], n = phase_vlm_model()
    model_paths["prefill_llava_fp32"] = {"flash_attention": n}
    # zamba2 at full width, one group: 6 mamba layers, one shared block;
    # whisper 2 + 2 layers over 2 x 64 tokens; llava 2 layers over
    # 2880 patches and 128 tokens
    train_grads = {
        "mamba2-130m": phase_train_grads("mamba2-130m"),
        "zamba2-2.7b": phase_train_grads("zamba2-2.7b",
                                         {"num_layers": 6}),
        "whisper-large-v3": phase_train_grads(
            "whisper-large-v3", {"num_layers": 2, "encoder_layers": 2},
            seq=64),
        "llava-next-mistral-7b": phase_train_grads(
            "llava-next-mistral-7b", {"num_layers": 2}, batch=1,
            seq=LLAVA_PREFIX)}
    for arch, r in train_grads.items():
        model_paths[f"grads_{arch}_fp32"] = r["launches"]
    moe = phase_moe_model()
    diffs["olmoe-1b-7b"] = moe["prefill_logit_diff"]
    mark("[3] models, [3v], [3t], [3c]")
    serving, one_process = {}, {}
    for k in kernels.values():
        k["launches"], k["launches_by_path"] = 0, {}
    for path, counts in model_paths.items():
        for name, n in counts.items():
            if n:
                kernels[name]["launches_by_path"][path] = n
    for label, argv, expect in serving_paths():
        got, res = serve_path(label, argv, expect)
        if label.startswith("smollm"):
            one_process[label] = res
        for name, n in got.items():
            if n:
                kernels[name]["launches"] += n
                kernels[name]["launches_by_path"][label] = n
        serving[label] = {k: res[k] for k in (
            "prefill_s", "decode_s", "new_tokens", "tok_per_s", "wall_s",
            "token_ms_p50", "token_ms_p90", "token_ms_p99", "decode_steps")
            if k in res}
        if "generated" in res:
            serving[label]["requests"] = len(res["generated"])
    mark("[4] serving")
    tp_decode, tp_paths = phase_tp_decode(one_process)
    mark("[4t]")
    for path, counts in tp_paths.items():
        for name, n in counts.items():
            if n:
                kernels[name]["launches_by_path"][path] = n
    breakdown = {"smollm-135m": phase_breakdown("smollm-135m", 8, 512),
                 "mamba2-130m": phase_breakdown("mamba2-130m", 8, 512),
                 "zamba2-2.7b": phase_breakdown("zamba2-2.7b", 4, 512),
                 "olmoe-1b-7b": phase_breakdown("olmoe-1b-7b", 4, 512)}
    mark("[5] breakdown")
    coll, coll_paths = phase_collectives()
    mark("[6]")
    tuners, tuner_paths = phase_tuners()
    mark("[6b]")
    coll_paths.update(tuner_paths)
    n_comm = gradient_elems(COMM_GRAD_LAYERS)
    comm, comm_paths = phase_communicator(n_comm)
    comm["comm_2x2x2_mapped"], mapped_paths = phase_remapped(
        n_comm,
        comm["comm_2x2x2"]["variants"]["bucketed"]["seconds"])
    comm_paths.update(mapped_paths)
    mark("[7], [7d]")
    transport = phase_transport(smi)
    mark("[7t]")
    training, train_paths = phase_training("smollm-135m")
    mark("[8], [8c]")
    training_ssm, ssm_paths = phase_training("mamba2-130m")
    train_paths.update(ssm_paths)
    mark("[8s], [8sc]")
    training_whisper, whisper_paths = phase_training("whisper-large-v3")
    train_paths.update(whisper_paths)
    mark("[8w]")
    training_fsdp, fsdp_paths = phase_training_fsdp()
    train_paths.update(fsdp_paths)
    del STEP0_ORACLE["whisper-large-v3"]
    mark("[8f]")
    training_moe, moe_paths = phase_training_moe()
    train_paths.update(moe_paths)
    mark("[8m], [8mc]")
    training_fsdp_model, fsdp_model_paths = phase_training_fsdp_model()
    train_paths.update(fsdp_model_paths)
    del STEP0_ORACLE["olmoe-1b-7b"]
    mark("[8ft], [8mf]")
    accounting = phase_accounting(training_fsdp_model, smi)
    mark("[9]")
    training_tp, tp_train_paths = phase_training_tp()
    train_paths.update(tp_train_paths)
    STEP0_ORACLE.clear()
    mark("[8t]")
    examples, example_paths = phase_examples()
    train_paths.update(example_paths)
    mark("[10]")
    log_before_after(smi, transport, training, training_tp,
                     training_fsdp_model)
    for path, counts in train_paths.items():
        for name, n in counts.items():
            kernels[name]["launches_by_path"][path] = n
    # the training paths' launches of the backward kernels
    kernels["flash_attention_bwd"]["launches"] = \
        train_paths["train_tuned"]["flash_attention_bwd"]
    kernels["ssd_chunk_bwd"]["launches"] = \
        train_paths["train_mamba2-130m_tuned"]["ssd_chunk_bwd"]
    for path, counts in {**coll_paths, **comm_paths}.items():
        for name, n in counts.items():
            # every gradient-sync path is listed for the combine, 0 too
            if n or (name == "segment_combine" and path in comm_paths):
                kernels[name]["launches_by_path"][path] = n
    # the collectives path's launches: its tuning run
    kernels["segment_combine"]["launches"] = \
        coll_paths["measure_collectives_tune"]["segment_combine"]
    log(f"    total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"card": smi, "model_logit_diff_fp32": diffs,
                      "olmoe_engine": {k: v for k, v in moe.items()
                                       if k.startswith("engine")},
                      "breakdown": breakdown, "serving": serving,
                      "collectives": {k: coll[k] for k in (
                          "best", "grad_sync", "tune_seconds", "wall_s",
                          "samples", "penalty", "fronts")},
                      "tuners": tuners,
                      "communicator": comm, "transport": transport,
                      "training": training,
                      "training_mamba2": training_ssm,
                      "training_olmoe_ep": training_moe,
                      "training_whisper": training_whisper,
                      "training_fsdp": training_fsdp,
                      "training_fsdp_model": training_fsdp_model,
                      "training_tp": training_tp,
                      "accounting": accounting,
                      "examples": examples,
                      "tp_decode": tp_decode,
                      "train_grads_fp32": train_grads}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
