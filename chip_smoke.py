#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raydp_tpu_torch``) on one NVIDIA
card: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero and prints no result line:

1. Device: require CUDA, print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them and, on the next line, the build: ``torch.__version__``,
   ``torch.version.cuda`` and the release line of ``nvcc --version`` (no
   nvcc is an error); build the kernels from ``raydp_tpu_torch/csrc`` and print the
   build seconds; for the tensor-core kernels (the bf16 forward
   ``flash_fwd_sm90_kernel``, the bf16 backward
   ``flash_bwd_dq_sm90_kernel`` / ``flash_bwd_dkv_sm90_kernel`` and the
   int8 product ``int8_gemm_sm90_kernel``, seventeen instantiations) the
   registers and spills ``ptxas`` reports and the wgmma (``HGMMA`` for
   bf16, ``IGMMA`` for s8) and ``UTMALDG`` (TMA load) instructions
   ``cuobjdump -sass`` finds in the built library (no spill, and both
   present, or it fails; the bf16 forward and backward take head dims 8,
   16 and 32 through their D 64 instantiations); for the split
   f32/bf16-cache decode (``flash_decode_scores_kernel`` and
   ``flash_decode_pv_kernel``, forty-eight instantiations: D 8, 16, 32, 64,
   128 and 256 for each pair of types) its registers, spills and static shared memory (no
   spill, or it fails); for K5 (``quantize_stochastic_rows_kernel``'s two
   register bodies and ``quantize_stochastic_kernel``) and K1
   (``interaction_fwd_kernel``, f32 and bf16) registers, spills, SASS
   instruction counts and K5's instructions per group of 4 elements (no
   spill, or it fails); for the CUDA-core f32 bodies (the forward's twelve
   ``flash_fwd_kernel`` and the backward's twelve ``flash_bwd_dq_kernel`` /
   ``flash_bwd_dkv_kernel`` instantiations, D 8 to 256) registers, spills and the SASS
   ``FFMA``/``LDS``/``LDGSTS`` counts (no spill, or it fails).
2. Kernels vs their plain PyTorch versions on the card, at the slices'
   shapes: ``flash_fwd`` and ``flash_fwd_twoterm`` (causal and not, offsets
   0 and nonzero, f32 and bf16, and for the bf16 tensor-core kernel D 64,
   T 1500, T 200 against Tk 136 and q_off < k_off with fully masked rows;
   o within 1e-5 in f32, and in bf16 element by element within 2^-7
   |plain| + 1.05 * 2^-8 * (the attention of |v|), the rounding of o and
   of p to bf16 (``bf16_limit``); m and l rtol 1e-5; the first launch of
   each case finished within a minute, two launches bitwise equal and the
   two-term body bitwise equal to the one-pass one), ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` (the same cases and, for the bf16 tensor-core
   backward and the CUDA-core f32 one, the hard cases of
   ``backward_cases`` with rows of no live key getting exactly 0; f32
   within 1e-4, bf16 element by element within ``bf16_bwd_limit``,
   2^-7 |plain| plus 1.05 * 2^-8 times the product of magnitudes whose p
   or ds the kernel rounds to bf16; two launches bitwise equal), all four
   again at the training path's own shape (q/k/v/do [2,8,8192,128] bf16
   causal), ``flash_decode`` (the split f32/bf16-cache kernel, two
   launches a call; mixed kv_len) and ``flash_decode_int8`` (against
   ``flash_decode`` on the dequantized cache), both against their plain
   versions, f32 q within 1e-5, bf16 q element by element within
   ``bf16_decode_limit``, 2^-7 |plain| + 1e-6 * (the attention of |v|);
   two launches bitwise; ``flash_decode`` bit for bit equal to the f32
   prefill row at kv_len 1, 31, 32, 33, 127, 128, 129, 2047, 2048 and the
   serving lengths, D 128 and 64, tq 1 and 3 (the failover contract), its
   bf16 q equal to f32 q with o rounded after and a bf16 cache equal to
   the same cache widened to f32, bit for bit; both kernels' edge cases
   (f32, bf16 and int8 caches): kv_len 1, the 32-key tile and 128-key
   block boundaries, capacity and past it, tq 3, a sequence of no live key
   giving exactly 0; decode vs the prefill row for bf16 q/k/v (within
   ``bf16_limit``, the gap printed); every attention family (the forward
   and the backward in f32 and bf16, K4a over every pair of types, K4b) at
   head dims 8, 16, 24 (zero-padded to 32) and 32
   (``check_small_heads``: at tools/trace_smoke.py's engine shapes and at
   [1,2,2048,D], against their plain versions at the limits above, two
   launches bitwise, the decodes' edges, decode == the f32 prefill row bit
   for bit, the bf16 decode row within ``bf16_limit`` of the bf16 prefill
   row); every family again at head dims 256 (bench.py's LM at d_model
   2048, 8 heads) and 192 (zero-padded to 256) (``check_wide_heads``: the
   forward and backward in f32 and bf16 at [1,8,2048,D] and the hard
   cases of ``wide_forward_cases`` / ``wide_backward_cases``, the bf16
   forward and backward at the training shape [2,8,8192,256], K4a and K4b
   at the serving shape, and at D 256 decode == the f32 prefill row bit
   for bit at every tile boundary, the decodes' edges and the bf16 decode
   row within ``bf16_limit`` of the bf16 prefill row; the limits above,
   two launches bitwise); every family (the forward in f32 and bf16,
   both bodies, the backward in f32 and bf16, K4a and K4b) at head dims
   512 (bench.py's LM at d_model 4096, 8 heads), 320 (zero-padded to
   512), 1024 and 1536, which they take in 256-column chunks
   (``check_heads_past_256``: the forward at ``wide_forward_cases``, the
   backward at ``past_256_backward_cases``, every call through the
   kernels, the decodes at the serving shape, and at 512 and 1024 decode
   == the f32 prefill row bit for bit at every tile boundary and the
   decodes' edges), and
   ``interaction_fwd`` against ``dot_interaction_plain`` at
   the DLRM path's shape [2048,7,16] (f32 and bf16), at the Criteo Kaggle
   shape [2048,27,16] and at the edges of its layout (``INTERACTION_EDGES``:
   F 2, F 9, F 12, batches 2047, 1001 and 4099, D 13, T off its alignment, the
   widest row a block holds, F 64 x D 900, with F 65 refused as an invalid
   argument (CUDA error 1, no other error); f32 atol 1e-5
   * max|plain|, bf16 2e-2 * max|plain|; two launches bitwise equal), with
   its input gradient against the plain version's autograd (f32, 1e-5
   relative);
   ``quantize_int8(stochastic=True)`` (K5) against
   ``quantize_int8_stochastic_plain`` at the training step's MLP
   activations [16384,1024] and [16384,4096], a row tail [300,96] and the
   edges of its layout (``STOCHASTIC_EDGES``: D 1024, 1028, 4096, 4100,
   4097, 97 and 96, N not a multiple of a block's rows, x off its 16-byte
   alignment, each with an all-zero row and rows at +-127 and half quanta)
   (values and scales bitwise; one seed the same bits over two launches,
   another seed other values; |values - x/s| <= 1, equal to 1 only where
   x/s is an integer and the f32 sum with u rounds up;
   |mean(dequant - x)| < quantum / 10); ``quantize_int8`` (deterministic,
   ``quantize_rows_kernel``) against the torch chain
   ``quantize_int8_plain``, bitwise and over two launches, on the int8
   product's bf16 operands, an int8 cache's K/V rows and ragged rows, each
   with rows at the rounding's edges, and as the product calls it (x and w
   in one launch, rows padded to a 16-byte pitch); ``int8_gemm`` against
   ``int8_gemm_plain`` at N 1, 4, 15, 16 (the swapped, split-K mode), 17,
   1500, 16384 (the tiled mode) with (K, M) (1024, 4096), (4096, 1024) and
   (1000, 1024), f32 and bf16 out, bitwise and over two launches; and at
   the step's two products ``int8_matmul`` (one quantize and one GEMM
   launch, bitwise equal to ``int8_matmul_plain``) and its two gradients
   against ``int8_matmul_plain``'s (bitwise).
3. Decode serving of ``TransformerLM`` at full width (vocab 2048, d_model
   1024, 8 heads of 128, 4 layers, bf16, seeded random weights) through
   ``DecodeEngine`` (capacity 2048, pages of 128, 4 slots, 32 new tokens)
   for 8 streams with seeded prompts of 64-1500 tokens, with an f32 cache
   and again with an int8 cache. Launch counts are zeroed just before each
   run and read just after; every kernel of the path must have launched.
   One stream's prefill and first-step logits are held against the same
   weights on the plain attention path (``attn_impl="full"``). Then the
   same weights with ``quantized_mlp=True``: one stream's prefill and
   first-step logits bitwise equal to the same model with its products
   through ``int8_matmul_plain``; then they serve the same streams (f32
   cache), ``int8_gemm`` launching in prefill and decode with one
   ``quantize_int8`` launch per product, and once more under the
   profiler. Before the int8 MLP, the f32-cache run again with the
   engine's obs in use (``serve_obs``): tracing on, a minted trace context
   per stream; tokens and launch counts bitwise those of obs off; the
   metric deltas (``serve.decode.{tokens,prefills,steps}``, the
   ``serve.ttft_ms`` and ``serve.tpot_ms`` counts); a
   ``serve.decode.prefill`` span per stream and a ``serve.decode.step``
   span per round in the trace ``export_trace`` writes
   (``chiprun_out/serve_trace.json``); a ``serve.decode.state`` note taken
   mid-decode and the crash dossier's decode section assembled then (the
   in-flight streams, the pool's pages); ``explain_stream`` of each record
   within 1% of its wall; then the memory-pressure veto on the card
   (``max_mem_pressure`` -1 holds a stream in the queue with no prefill
   launched; 0.95 releases it, its tokens those of obs off); and the
   decode obs probe (bench.py's ``decode_obs_overhead_probe``: ms a token
   with tracing on and off, 4 rounds, the lead alternating; reported, not
   gated).
4. Training of ``TransformerLM`` at full width (bench.py's
   ``bench_transformer_lm``: batch 2, T 8192, Adam 3e-4, tokens from
   ``np.random.default_rng(17)``, seeded random weights): one warm step and
   8 timed steps, the loss falling, 4 launches of ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` per step; tokens/s, step ms, MFU,
   the device's busy share of one profiled step, attention's share and the
   MFU of the rest (the same step with ``attn_impl="skip"``); one
   full-width step with ``RAYDP_TPU_FLASH_ONEPASS=0``, through
   ``flash_fwd_twoterm``, bitwise equal to the one-pass step; peak memory
   with and without ``remat``. At T 2048: gradients against the plain
   attention path (``attn_impl="full"``), and the two-term step again.
   The same model in f32 at batch 1, T 2048 (``phase_train_f32``): the
   first step's loss and gradients against ``attn_impl="full"`` at
   tests/test_torch_training.py's f32 tolerances (loss rtol 1e-6,
   gradients 1e-4 relative), then one warm and 4 timed Adam steps, the
   loss falling, 4 launches a step of ``flash_fwd_f32`` and of the f32
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``csrc/flash_backward.cu``);
   step ms and one profiled step.
   Sequence parallelism (``phase_seqpar``): the same model in f32 at batch
   1, T 8192, ``attn_impl="ring_flash"`` and ``"ulysses_flash"`` under
   ``sequence_parallel_apply`` at world 1 over NCCL in this process: the
   global loss within 1e-5 and every gradient within 1e-4 relative of
   ``attn_impl="flash"`` on the whole sequence from the same weights, two
   runs bitwise, a warm and 2 timed Adam steps with the loss falling and
   the launches a step ``seqpar_expected`` reckons (W stats forwards, W dq
   and W dk/dv launches a layer for the ring, one each for Ulysses); step
   ms, tokens/s and peak memory beside the ``flash`` step's, and one layer
   alone with its share of time outside the port's kernels. Then whether
   gloo takes CUDA tensors for P2P, all-to-all, all-reduce and the
   pipeline's shift (an all-to-all with split sizes), each op in a pair of
   spawned ranks; each impl whose collectives it takes again at world 2
   over gloo in two processes on the one card, held the same way
   (``--seqpar`` runs this phase alone).
   Pipeline parallelism (``phase_pipeline``): the same model in f32 with
   ``attn_impl="flash"`` at batch 4, T 2048, its 4 blocks the stages of
   ``pipeline_sharded`` over 4 microbatches of [1, 2048, 1024] (the
   embedding, positions, final LayerNorm and head on every rank); world 1
   over NCCL in this process (one stage of 4 blocks), world 2 over gloo in
   two processes on the one card (two stages of 2): the loss within 1e-5
   and every gradient within 1e-4 relative of the non-pipelined ``flash``
   step on the same batch, two runs bitwise, a warm and 4 timed Adam steps
   with the loss falling and M x blocks a stage launches a step of
   ``flash_fwd_f32``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the bubble
   ticks skipped); step ms and tokens/s beside the ``flash`` step's, the
   shares of a step in the shifts, in the bubble's waits and in
   all-reduces, peak memory a rank (``--pipeline`` runs this phase alone).
   Expert parallelism (``phase_moe``): top-2 ``moe_sharded`` over 4096
   tokens a rank of the LM's input activations (its embedding and
   positions of batch 2 x T 2048), each expert the block's MLP (1024 ->
   4096 -> gelu -> 1024, f32), the loss ``mean(out²) + 0.01 · lb``; world 1
   over NCCL (one expert: every token to it), world 2 over gloo on the one
   card (2 experts): at capacity factor 8 the output within 1e-5 and the
   experts' and router's gradients within 1e-4 relative of the same
   routing computed densely (every expert on every token), no drop, two
   runs bitwise; then a warm and 4 Adam steps at 1.25 with each step's
   drop fraction and aux loss, the loss falling, no port kernel launched;
   step ms, tokens/s, the share in the all-to-alls, peak memory a rank
   (``--moe`` runs this phase alone).
   The same training with ``quantized_mlp=True`` (bench.py's
   ``make_runner("flash", quantized_mlp=True)``): the loss falling, 8
   ``int8_gemm`` launches a step (two per block, forward only), as many
   ``quantize_int8`` launches and no K5,
   the first loss within 1e-2 relative of the bf16 model's, tokens/s, step
   ms, ``mfu_int8_mlp`` (bench.py's: the same FLOPs over the bf16 peak)
   and one profiled step. K5's own path: ``quantize_int8(x, seed=step,
   stochastic=True)`` for 8 steps on both activation shapes, every call
   held to the contract above.
   Then DLRM training through the estimator at full width (bench.py's
   ``bench_dlrm``: 6 tables of width 16 with vocabularies 100000 to 100,
   8 dense features, MLPs (128, 64), f32, seeded random weights; 100,000
   rows of bench.py's input form from ``np.random.default_rng(11)`` in 4
   blocks, the label the parity of the vocab-100 id ``c5``, batch 2048): 3
   epochs of
   Adam 1e-3 on BCE and ``evaluate``, the loss falling by 10%; one launch of
   ``interaction_fwd`` per forward pass (48 steps an epoch, 49 evaluation
   batches); training samples/s and step ms from epochs 2-3, the device's
   busy share of one profiled epoch, peak memory and MFU; one epoch with
   ``dlrm_optimizer()``; one step's loss and every gradient through the
   kernel against the einsum path (1e-5 relative).
   Then the port's object store on the same cell (``phase_store``): a CPU
   producer actor of the port's cluster writes the 4 blocks into the
   store as Arrow IPC streams and hands their ownership to the driver,
   which maps them, builds the columns (views of the mapping) and runs the
   same fit on the card, bit for bit the fit from numpy in its losses,
   evaluation and final parameters, with as many K1 launches; a second
   producer SIGKILLed before any transfer leaves blocks that read as lost
   and segments the head unlinks (kill to unlink timed); a third hands its
   blocks to a ``BlockService`` and is SIGKILLed, and the fit from them is
   bitwise again; put and get GB/s of 4 blocks of 256 MiB and
   ``mem.shm_bytes`` at its peak; after ``shutdown()`` no segment left and
   the driver's leak audit at 0 (``--store`` runs phase_dlrm and this
   phase alone).
   Then bench.py's DLRM cell end to end (``phase_etl``): ``init_etl`` of
   2 executors, bench's ``make_criteo_frame`` query over the same 100,000
   rows in 4 partitions (its label the parity of the hashed c5),
   ``dataframe_to_dataset(_use_owner=True)``, ``stop_etl``; the ids and
   label bit for bit numpy's and pandas', the dense ``log1p`` within 1 ulp;
   the staged fit from the ETL ``Dataset`` and, on a live second session,
   ``fit_on_etl(streaming=True)`` with its spans decoded on the executors,
   each bit for bit the same fit from an ``ArrayDataset`` of the blocks'
   columns, one K1 launch a forward pass; no process of the session with a
   CUDA context; after ``shutdown()`` no process or ``rtpt-`` segment of
   the session (``--etl`` runs phase_dlrm and this phase alone).
   Then the same cell through the other estimators (``phase_estimators``):
   in an ETL session, the columns of ``dlrm_data`` in 4 blocks and 2,048
   held-out rows; ``TorchEstimator.fit_on_etl`` (Adam, batch 2048 a rank,
   2 epochs) at world 1, one rank over NCCL bit for bit a plain loop in
   this process (losses, evaluation, parameters, K1 launches), and at
   world 2, two ranks over gloo on the one card (gloo must take DDP's
   all-gather, broadcast and all-reduce): both ranks' parameters equal,
   ``get_model()`` rank 0's, the mean loss within 1e-3 of the world-1
   loop on both ranks' batches and falling by 10%, one step of the
   estimator's rank program within 1e-5 (loss, gradients) and 1e-4 (the
   tables' update) of world 1's; K1 once a forward on every rank;
   ``XGBoostEstimator``'s native GBDT at world 2, bit for bit an
   in-process two-rank run; samples/s, step ms, DDP's all-reduce share,
   peak memory and setup seconds a rank, an ``{"estimators": {...}}``
   line (``--estimators`` runs phase_dlrm and this phase alone).
   Then the port's examples (``phase_examples``, after
   phase_estimators): ``main([])`` (no ``--device``: the card is the
   default) of ``raydp_tpu_torch.examples.nyctaxi`` (100,000 rows, 5
   epochs), ``dlrm_criteo`` (50,000 rows, 3 epochs, W 1) and
   ``long_context_lm`` (W 1, seq 128) at the JAX scripts' default sizes:
   every fitted parameter on the card, the first loss above the last, the
   lines tests/test_examples.py asserts, one K1 launch a DLRM forward pass
   with every forward on the card; then ``raydp_tpu_torch.tools.
   trace_smoke.main([])``: its ``trace ok`` line and its replica's
   ``flash_fwd_f32`` and ``flash_decode`` launches above 0 at head dim
   16, read from the head before the deployment closed; no ``rtpt-``
   segment of the phase left; an ``{"examples": {...}}`` line with each
   script's seconds (``--examples`` runs this phase alone, with
   ``phase_leftovers``; ``--small-heads`` runs phase 1 and every
   attention family's checks and times at head dims 8, 16, 24 and 32
   alone).
   Then examples/dlrm_criteo.py's dp x tp fit at the same width
   (``phase_sharded_dlrm``, after phase_store): ``dlrm_sharding_rules``
   and a mesh of ranks; world 1 over NCCL in this process, mesh {"data":
   1, "model": 1}, bit for bit phase_dlrm's fit (losses, evaluation,
   parameters, K1 launches); then world 2, two ranks of the cluster
   runtime on the one card over gloo, launched by ``create_spmd_job`` and
   brought up by ``bootstrap_torch``: (a) {"data": 1, "model": 2} with
   Adam, every table split in two (100,000 rows, 50,000 a rank), bit for
   bit phase_dlrm's fit, the tables gathered whole; (b) {"data": 2,
   "model": 1} with Adam, the batch split in two and fed in order, within
   1e-4 (losses relative, parameters absolute) of a world-1 fit of the
   same global batches; (c) {"data": 1, "model": 2} with
   ``dlrm_optimizer()``, within the same limits of its world-1 fit (the
   check that Adafactor reduces over the whole table). Every run: the
   loss falls by 10%, K1 launched once a forward pass on each rank, no
   parameter off the card, both ranks' losses equal; samples/s, step ms,
   peak memory and the share of the epochs inside all-reduces, a
   ``{"sharded_dlrm": {...}}`` line (``--sharded`` runs phase_dlrm and
   this phase alone).
   Then the serving plane (``phase_deploy``): ``serve.deploy`` of 2 light
   replicas a deployment on the card, in a cluster of the port. The DLRM
   cell with phase_dlrm's weights as epoch 0: 4 closed-loop clients for 3
   s of 1-32 rows (each response within 1e-5 relative of the driver's
   ``Estimator.predict``; requests/s, p50/p99, batch fill, the stage
   split), a replica's ``profile`` listing ``interaction_fwd_kernel``;
   at the one bucket of 256, 160 fixed requests clean, then with replica
   0 SIGKILLed 50 ms in (none dropped, each bitwise the clean run's and
   the driver's predict of the rows padded to 256, the pool healed within
   15 s), then under a rolling reload to a perturbed epoch 1 (each
   response bitwise the old weights' or the new's, all new after it).
   The full-width LM in f32 at max_len 2048 through ``stream`` (8
   prompts, a client thread each): tokens bitwise the driver's
   ``DecodeEngine``, clean and through a SIGKILL once every stream has two
   tokens (at least one failover); the int8 cache bitwise the driver's;
   the bf16 model through a SIGKILL (tokens before it equal, the streams
   that differ after it counted). K2a's f32 body, K4a and K4b launch in
   the replicas (the ``ops.launches.*`` gauges each ships to the head).
   After ``shutdown()`` no replica process, no ``rtpt-`` segment of the
   session's shm namespace, the card's memory back and the
   driver's leak audit at 0; at most 150 s (``--deploy`` runs
   phase_dlrm and this phase alone).
   Then the estimator's streamed, checkpointed and retried fit at the same
   width (``phase_fit``), a line for each step: (1) fits of 3 epochs with
   ``streaming=True``, ``"hybrid"`` and ``stream_wire_quant="int8"``: the
   loss falling by 10%, one ``interaction_fwd`` launch per forward pass,
   the bytes each epoch uploads (60 a row; the hybrid's epochs 2-3 none;
   the int8 wire 12 dense bytes a row in place of 32), samples/s and step
   ms beside the staged fit's; each segmented fit bit for bit, in its
   losses and final parameters, a fit fed one batch at a time on the
   compute stream (``stream_scan_steps=0``; for the int8 wire on the
   data's wire round trip, for the hybrid its uploaded epoch and, without
   shuffle, all three); (2) ``widen_wire`` on the card equal to
   ``dequantize_rows`` on the host bit for bit at [2048, 8] and [32, 2048,
   8]; (3) 2-epoch fits with a step checkpoint every 16 steps and a crash
   planted after epoch 1's step-32 checkpoint, run with ``max_retries=1``,
   staged and streamed: resumed at (1, 32), the planted crash the only
   error absorbed, the parameters bit for bit those of the uninterrupted
   fit (itself run twice, and bitwise), only epoch checkpoints left (one with
   ``keep_checkpoints=1``), ms and bytes a checkpoint; (4) the streamed
   fit's ``explain_last_fit()`` and how much of its wall time the step
   phases cover, a ``profile_dir`` trace, and the card's busy share of one
   profiled streamed epoch.
   Then what obs counts and costs (``phase_obs``): ``count_flops`` of one
   ``TransformerLM`` training step at the training shape, the mode's part
   equal to ``lm_nonattn_flops_per_step`` and the attention kernels'
   reports to 18 * D a live pair (``lm_counted_flops``: 1.195 of
   ``lm_train_flops_per_step``), the staged DLRM step's count equal to
   ``dlrm_counted_flops`` (K1 reported); the step recorder on against off
   over one-epoch staged DLRM fits (bench.py's ``fit_profile_probe``: 4
   rounds, the lead alternating; reported, not gated); and one
   ``torch.library.custom_op`` around K1's wrapper against the raw
   wrapper, 1000 calls by events and by the host's clock.
   Then the JAX package's small LMs at their own width
   (``phase_small_lm``, after the f32 training; ``--small-lm`` runs it
   alone): chaos.py's ``DECODE_LM`` (vocab 64, d_model 32, 2 heads of 16,
   2 layers) and its 4-head variant (D 8), each trained with
   ``attn_impl="flash"`` in f32 and in bf16 (batch 2, T 128, 3 Adam steps;
   one step's loss and gradients against ``attn_impl="full"`` within
   ``SMALL_LM_LIMITS``; the forward and both backward kernels launching
   once a layer a step) and served through ``serve.deploy`` from an int8
   cache and as a bf16 model (4 streams of 12 tokens, each whole; the
   replicas' ``flash_decode_int8`` / ``flash_decode`` gauges above 0; the
   int8 tokens that are an f32 engine's counted). A ``{"small_lm":
   {...}}`` line gives the gaps, the serving seconds and the launches by
   head dim.
   Then bench.py's LM at its 2048 width (``phase_wide_lm``, after
   phase_small_lm; ``--wide-lm`` runs it alone): vocab 2048, d_model 2048,
   8 heads of 256, 4 layers, seeded random weights. bf16 training with
   ``attn_impl="flash"`` at batch 2, T 8192 (one warm and 3 timed Adam
   steps), its loss and gradients against ``attn_impl="full"`` at T 2048
   (grad_check's bounds); f32 training at batch 1, T 2048 (one warm and 2
   timed steps) against ``"full"`` at phase_train_f32's bounds (loss rtol
   1e-6, gradients 1e-4); the loss falling, the forward and both backward
   kernels launching once a layer a step; then ``DecodeEngine`` at
   ENGINE's shape for 4 streams of 64-1500 tokens from an f32 cache, as a
   bf16 model and from an int8 cache, one stream's logits held to the
   plain path; every head-dim-256 kernel launched; a ``{"wide_lm":
   {...}}`` line. Then bench.py's LM at its 4096 width (``phase_lm_4096``;
   ``--lm-4096`` runs it alone): d_model 4096, 8 heads of 512, its other
   widths the 2048 LM's, on ``phase_wide_lm``'s paths: bf16 training at
   batch 2, T 8192 and f32 at batch 1, T 2048, each against ``"full"``,
   every attention kernel launched once a layer a step, the loss falling;
   served by ``DecodeEngine`` at ENGINE's shape from an f32 cache, as a
   bf16 model and from an int8 cache (4 streams), one stream's prefill and
   first decode step held to the plain path; every kernel launched at
   head dim 512; a ``{"lm_4096": {...}}`` line.
   Then the chaos plane (``phase_chaos``, after the times, before the
   leftovers): under ``RAYDP_TPU_SANITIZE=donation,lockdep,leaks-strict``
   (the environment restored after), ``raydp_tpu_torch.chaos.run`` of
   ``scenario_mid_fit`` on the card at the tool's size (2,048 rows,
   ``MLPRegressor``'s widths 256/128/64/16, a streamed fit whose blocks'
   owner is SIGKILLed before it reads them), then
   ``executor_kill_with_service`` (120,000 rows) and ``host_death``
   (60,000 rows) on the card's host, then ``replica_kill_during_load``
   and ``replica_kill_during_decode`` with their replicas on the card.
   Required: the fits' parameters on the card and bitwise the unkilled
   fit's, at least one re-executed task, every scenario's gate (the model
   scenarios: no request dropped, responses and tokens bitwise the clean
   run's, at least one failover, the pool healed), no stranded thread, a clean strict leak
   audit at the cluster's shutdown, no ``rtpt-`` segment of the phase's
   namespaces left. A ``{"chaos": {...}}`` line gives each scenario's
   report and seconds and the donation guard's checks and registered
   ranges beside the card's name and power limit (``--chaos`` runs this
   phase alone).
5. Numbers: serving tok/s, TTFT and TPOT p50; each kernel's time (CUDA
   events, warm, median), its plain version's time, the time of one
   PyTorch call computing the same function as a yardstick (the port never
   calls it: ``F.scaled_dot_product_attention``, its backward for the
   backward pair, ``torch.bmm`` and the triangle gather, a pair of calls,
   for ``interaction_fwd``, ``torch._int_mm`` -- the int32 product alone,
   without scales or cast, its rows padded to 32 at decode's N 4 -- for
   ``int8_gemm``, none for K5 and ``quantize_int8``), and the
   least time the card could take (int8 operations over 1979 TOP/s), with
   each time's ratio to it and, for the attention kernels, their TFLOP/s
   (4 * D, 6 * D and 8 * D operations per live pair for the forward, dq
   and dk/dv). The backward pair is timed 20 calls a sample, median of
   five, and by the profiler's device time, beside SDPA's backward timed
   the same two ways. ``flash_fwd`` at the serving shape is timed
   through ``flash_attention``, the surface the model calls, with
   ``flash_attention_call`` (``call_ms``) and the profiler's device time
   beside it.
   ``interaction_fwd``'s three times, K5's, and the attention kernels' own
   and library times, are also taken by the profiler, as device time per
   call (``device_ms``, ``plain_device_ms``, ``library_device_ms`` in the
   ``kernels`` line, null where not measured; a port kernel counts by the
   launches the profiler recorded of it, ``per_call_device_ms``). The
   f32 bodies (``f32_times``) at the f32 prefill [1,8,2048,128]: the
   forward, its two-term body and the f32 backward pair, against SDPA in
   f32 and its backward. Beside K1's times, the
   launch floor: ``torch.cuda._sleep(0)``, a launch that does no work, by
   events and by the profiler.

Before them a ``{"pipeline": {...}}`` line sums up ``phase_pipeline``, a
``{"moe": {...}}`` line ``phase_moe``, an ``{"etl": {...}}`` line
``phase_etl``, an ``{"estimators": {...}}`` line ``phase_estimators``,
a ``{"small_heads": {...}}`` line every attention family at head dims
8, 16, 24 and 32 (errors and times), a ``{"small_lm": {...}}`` line
``phase_small_lm``, a ``{"wide_heads": {...}}`` line every family at head
dims 256 and 192 (errors, and at 256 the times by events and by the
profiler beside the plain version's, SDPA's and the bound), a
``{"wide_lm": {...}}`` line ``phase_wide_lm``, a ``{"heads_past_256":
{...}}`` line every family at head dims past 256 (errors, and at
512 the times beside the plain version's, SDPA's with its backend and the
bound), an ``{"lm_4096": {...}}`` line ``phase_lm_4096``, an
``{"examples": {...}}`` line
``phase_examples``, a ``{"deploy": {...}}`` line ``phase_deploy`` and a
``{"chaos": {...}}`` line ``phase_chaos``, each
beside the card's name and power limit. The
last three lines are an ``{"obs": {...}}`` object (the two overhead
quotients, the custom op's hop and the LM count's ratio, beside the card
and the build), a ``{"kernels": [...]}`` object and ``{"ok": true,
"device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --planted-faults [NAME ...]

plants each fault of ``PLANTED_FAULTS`` (or each one named) in its own copy of the source it
names (the bf16 forward, the bf16 backward, the f32 forward, the f32
backward, the two decode kernels, the int8 product, K5, K1, the backward's
wrapper; the estimator's resume, the wire's widen and the streamed fit's
segments) under ``build/planted/``, builds the copies (each compiles only
the source its fault changed, all in parallel) and runs in each
``chip_smoke.py --bf16-checks`` for a fault in the kernel layer (phase 2's
bf16 forward, backward and decode checks, the f32 bodies' edges, the
f32/bf16-cache decode's bitwise checks and the int8 product's, at the
serving and training shapes alone, every family at head dims 256 and 192
and past 256, then the K1 and K5 checks) or ``chip_smoke.py
--fit-checks`` for one in a fit's Python modules (``phase_fit``'s steps
1-3: the streamed fits and their per-step parity, the widen and the
crash-and-retry fits); it exits 0 only if every copy fails them with a
disagreement, and prints one JSON line with each fault's failing check.

    python3 chip_smoke.py --k1-k5

runs K1 and K5 alone: phase 1, their checks, K5's entry-point run, their
times and the launch floor, and the host's time a call of each step of the
K1 and K5 wrappers and of the other short wrappers (``launch_times``:
``time.perf_counter`` over 1000 calls); it writes
``chiprun_out/k1_k5.json``.

    python3 chip_smoke.py --wide-heads
    python3 chip_smoke.py --wide-lm

run phase 1 and then every attention family at head dims 256 and 192
(``check_wide_heads`` and ``wide_head_times``, a ``{"wide_heads":
{...}}`` line), or phase 1 and ``phase_wide_lm`` (a ``{"wide_lm": {...}}``
line), alone.

    python3 chip_smoke.py --heads-past-256
    python3 chip_smoke.py --lm-4096

run phase 1 and then every attention family at head dims past 256, the
backward's dq and dk/dv too (``check_heads_past_256`` and
``heads_past_256_times``, a ``{"heads_past_256": {...}}`` line), or phase 1
and ``phase_lm_4096`` (the 4096-wide LM trained in bf16 and f32 and served,
an ``{"lm_4096": {...}}`` line), alone.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from raydp_tpu_torch.estimator import Estimator
from raydp_tpu_torch.exchange import torch_io
from raydp_tpu_torch.exchange.dataset import ArrayDataset
from raydp_tpu_torch.models.dlrm import DLRM, dlrm_optimizer
from raydp_tpu_torch.models.transformer import TransformerLM
from raydp_tpu_torch.obs.costmodel import (H100_SXM_PEAKS,
                                            lm_nonattn_flops_per_step,
                                            lm_train_flops_per_step,
                                            mlp_train_flops_per_step)
from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as fa
from raydp_tpu_torch.ops import interaction as ia
from raydp_tpu_torch.ops import quantization as qz
from raydp_tpu_torch.ops.quantization import dequantize_int8, quantize_int8
from raydp_tpu_torch.serve.decode import DecodeEngine

# the widest TransformerLM the repo runs (bench.py's long-context LM), and
# the serve.decode settings of docs/serving.md (capacity 2048, the rest the
# defaults)
MODEL = dict(vocab_size=2048, d_model=1024, num_heads=8, num_layers=4)
ENGINE = dict(capacity_tokens=2048, page_tokens=128, max_seqs=4,
              max_new_tokens=32)
N_STREAMS = 8
PROMPT_LENS = (64, 1500)
DECODE_LENS = [17, 500, 1300, 2048]
# kv_len at every boundary of the split decode (its 32-key tiles and
# 128-key blocks, capacity) where decode must equal the f32 prefill row
DECODE_BITS_LENS = (1, 31, 32, 33, 127, 128, 129, 2047, 2048)
# and over a cache whose capacity is a multiple of neither the f32 prefill's
# 64-row block nor the 32-key tile, with lengths at the block's edges
DECODE_BITS_ODD = (1000, [63, 64, 65, 999, 1000])
# head dims below 64, which every attention family takes: the small LMs'
# heads (raydp_tpu_torch/tools/trace_smoke.py's and chaos.py's LM, d_model
# 32 over 2 heads, is D 16; over 4 heads, as the JAX package's
# tests/test_models_parallel.py runs attn_impl="flash", D 8), D 32, and D 24,
# for which no kernel is built: it runs zero-padded to 32. Held at the trace
# LM's engine shapes (its serve.decode.capacity_tokens 64, 2 heads, up to 4
# slots of prompts of 3 tokens and 8 new ones) and at [1, 2, 2048, D]
SMALL_HEAD_DIMS = (8, 16, 24, 32)
TRACE_LM = dict(heads=2, capacity=64, decode_lens=[1, 4, 11, 64])
SMALL_HEADS_T = 2048
# head dims past 128: 256, bench.py's LM at BENCH_LM_D=2048 (bench.py fixes
# 8 heads; Gemma 7B's and Gemma 2 9B's heads), and 192, for which no kernel
# is built: it runs zero-padded to 256. Held at the shapes of that LM's
# paths (the prefill [1, 8, 2048, D], the training step [2, 8, 8192, D] in
# bf16, the f32 step [1, 8, 2048, D], decode rows q [4, 8, 1, D] against a
# cache of 2048 at DECODE_LENS) and at hard cases of 2 heads
WIDE_HEAD_DIMS = (256, 192)
WIDE_HEADS = 8
# head dims past 256, which every attention family (the forward, the
# backward, K4a, K4b) takes in 256-column chunks
# (ops.flash_attention.HEAD_CHUNK): 512, bench.py's LM at BENCH_LM_D=4096
# (8 heads), 320, zero-padded to 512, and 1024 and 1536, two and three more
# chunks. Held at WIDE_HEAD_DIMS' shapes; decode == the
# f32 prefill row bit for bit and the decodes' edges at PAST_256_BITS_DIMS
PAST_256_HEAD_DIMS = (512, 320, 1024, 1536)
PAST_256_BITS_DIMS = (512, 1024)
# an odd number of 256-column chunks: the f32 backward's last block of a
# row or key block keeps one chunk alone
PAST_256_ODD_DIM = 768
SEED = 0
# bench.py bench_transformer_lm on its chip: batch 2, T 8192, Adam 3e-4,
# tokens from default_rng(17); 1 warm step, 8 timed
TRAIN = dict(batch=2, seq=8192, steps=8, lr=3e-4, token_seed=17)
GRAD_CHECK_T = 2048
# f32 training of the same model at the f32 model's serving shape: batch 1,
# T 2048 (the prefill of phase_deploy's f32 replicas), 1 warm + 4 timed steps
TRAIN_F32 = dict(batch=1, seq=2048, steps=4)
# phase_seqpar: the widest LM in f32 at batch 1 and T 8192 (the dtype of the
# JAX package's ring tests and of examples/long_context_lm.py), ring_flash
# and ulysses_flash under sequence_parallel_apply, a warm step and 2 timed
# Adam steps each (4 until phase_examples came), beside attn_impl="flash"
# on the whole sequence; worlds 1 (NCCL, in this process) and 2 (gloo, two
# processes on the one card, where gloo takes CUDA tensors)
SEQPAR = dict(batch=1, seq=8192, steps=2, impls=("ring_flash", "ulysses_flash"))
SEQPAR_LOSS_RTOL, SEQPAR_GRAD_RTOL = 1e-5, 1e-4
SEQPAR_RANK_LIMIT_S = 300.0  # a spawned world's whole run
# bench.py bench_dlrm (the BASELINE.json headline workload), uncut: its model,
# BENCH_DLRM_ROWS' default of 100,000 rows, batch 2048, Adam 1e-3, inputs
# from default_rng(11)
DLRM_MODEL = dict(vocab_sizes=[100_000, 10_000, 1_000, 1_000, 100, 100],
                  num_dense=8, embed_dim=16, bottom_mlp=(128, 64),
                  top_mlp=(128, 64))
DLRM_RUN = dict(rows=100_000, batch=2048, epochs=3, lr=1e-3, data_seed=11,
                blocks=4)
# the fits of the estimator's streamed, checkpointed and retried path: step
# checkpoints every 16 of the epoch's 48 steps, a planted crash after epoch
# 1's step-32 checkpoint
FIT_RUN = dict(save_every_steps=16, crash_at=(1, 32), retry_epochs=2)
# the DLRM path's interaction input, [batch, 1 + tables, width], and the
# Criteo Kaggle setting of facebookresearch/dlrm: 13 dense features through
# the bottom MLP and 26 tables of width 16 (--arch-sparse-feature-size=16)
INTERACTION_SHAPES = {"path": (2048, 7, 16), "kaggle": (2048, 27, 16)}
# K1 at the edges of its layout, (B, F, D, dtype, T's offset in elements):
# F 2 (one pair, 32 rows a task, B 4099 leaving a last task of 3 rows); F 9
# (a task is one row of 36 pairs, which leaves 4 lanes a second output); F
# 12 (66 pairs: a lane's third output exists for two lanes only); B 2047
# (not a multiple of the 3 rows of an F 7 task) and B 1001 at F 27; D 13
# (scalar staging); T one element off (scalar staging of an aligned shape);
# the widest row a block holds, F 64 x D 900 f32 (230,400 bytes of shared
# memory; F 65 is refused)
INTERACTION_EDGES = [
    (4099, 2, 16, torch.float32, 0), (2048, 9, 16, torch.bfloat16, 0),
    (1000, 12, 16, torch.float32, 0),
    (2047, 7, 16, torch.float32, 0), (1001, 27, 16, torch.bfloat16, 0),
    (512, 27, 13, torch.float32, 0), (2048, 7, 16, torch.float32, 1),
    (3, 64, 900, torch.float32, 0),
]
# the int8 path: the MLP activations of the training step, [batch * T,
# d_model] into fc1 and [batch * T, 4 * d_model] into fc2, and a row tail;
# the step's two int8 products (x [N, K] against the Linear weight [M, K]),
# decode's N = 4 (the engine's slots) and a prefill-sized N = 1500
QUANT_SHAPES = {"fc1": (16384, 1024), "fc2": (16384, 4096), "tail": (300, 96)}
GEMM_SHAPES = {"fc1": (16384, 1024, 4096), "fc2": (16384, 4096, 1024),
               "decode": (4, 1024, 4096), "decode fc2": (4, 4096, 1024),
               "prefill": (1500, 1024, 4096)}
# int8_gemm held bitwise at every N of its two modes and across the
# threshold (qz.SMALL_N = 16: N 15 and 16 swapped and split, 17 tiled), with
# K a multiple of 128, and 1000 (padded to a 1008-byte pitch); M 1003 takes
# the large mode's bf16 out through registers (rows TMA cannot address)
GEMM_CHECK_N = (1, 4, 15, 16, 17, 1500, 16384)
GEMM_CHECK_KM = ((1024, 4096), (4096, 1024), (1000, 1024), (200, 1003))
# the deterministic quantize kernel: the int8 product's operands as the
# model hands them (bf16 activations of training, prefill and decode, the
# bf16 weights), an int8 cache's new K/V rows (f32, [slots * heads, D]) and
# ragged rows
QUANT_ROWS_SHAPES = {
    "train x fc1": ((16384, 1024), torch.bfloat16),
    "train x fc2": ((16384, 4096), torch.bfloat16),
    "w fc1": ((4096, 1024), torch.bfloat16),
    "w fc2": ((1024, 4096), torch.bfloat16),
    "decode x": ((4, 1024), torch.bfloat16),
    "kv rows": ((32, 128), torch.float32),
    "tail": ((300, 96), torch.float32),
    "ragged": ((7, 1000), torch.bfloat16),
}
STOCHASTIC_SEEDS = 8  # the entry point's run: one seed per step, as advised
# K5 at the edges of its layout, (N, D, x's offset in elements): the warp
# body's widest row (D 1024) with N 1001, not a multiple of its 8 rows a
# block; D 1028, just past it (the block body); the block body's widest row
# (D 4096) and D 4100, just past it (the general body); D 4097 and D 97, not
# multiples of 4 (the general body, groups of 4 across rows); D 96, the
# warp body with most lanes idle; and rows one element off their 16-byte
# alignment (the general body)
STOCHASTIC_EDGES = [(1001, 1024, 0), (300, 1028, 0), (67, 4096, 0),
                    (64, 4100, 0), (37, 4097, 0), (300, 97, 0), (301, 96, 0),
                    (300, 1024, 1)]

# NVIDIA H100 SXM data sheet (dense): HBM rate, and the bf16 and int8
# tensor-core and f32 CUDA-core peaks of the port's cost model
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = H100_SXM_PEAKS

FWD_SOURCE = "raydp_tpu_torch/csrc/flash_attention.cu"
# the bf16 forward, which the serving and training paths run
SM90_SOURCE = "raydp_tpu_torch/csrc/flash_forward_sm90.cu"
# the bf16 backward, which the training path runs (f32: flash_backward.cu)
SM90_BWD_SOURCE = "raydp_tpu_torch/csrc/flash_backward_sm90.cu"
# the f32 backward, which the f32 training step runs
BWD_SOURCE = "raydp_tpu_torch/csrc/flash_backward.cu"
QUANT_SOURCE = "raydp_tpu_torch/csrc/quantization.cu"
# the decodes, split over the cache: f32/bf16 cache (K4a), int8 cache (K4b)
DECODE_SOURCE = "raydp_tpu_torch/csrc/flash_decode.cu"
DECODE_INT8_SOURCE = "raydp_tpu_torch/csrc/flash_decode_int8.cu"
INTERACTION_SOURCE = "raydp_tpu_torch/csrc/interaction.cu"
# kernel -> (source, the pallas_call of the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (SM90_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    # the f32 body, which the f32 model's replicas run (phase_deploy)
    "flash_fwd_f32": (FWD_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_fwd_twoterm": (SM90_SOURCE, "raydp_tpu/ops/flash_attention.py:305"),
    "flash_bwd_dq": (SM90_BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:540"),
    "flash_bwd_dkv": (SM90_BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:561"),
    # the f32 bodies, which the f32 training step runs (phase_train_f32)
    "flash_bwd_dq_f32": (BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:540"),
    "flash_bwd_dkv_f32": (BWD_SOURCE, "raydp_tpu/ops/flash_attention.py:561"),
    "flash_decode": (DECODE_SOURCE, "raydp_tpu/ops/flash_attention.py:833"),
    "flash_decode_int8": (DECODE_INT8_SOURCE,
                          "raydp_tpu/ops/flash_attention.py:833"),
    "interaction_fwd": (INTERACTION_SOURCE,
                        "raydp_tpu/ops/interaction.py:159"),
    "quantize_int8_stochastic": (QUANT_SOURCE,
                                 "raydp_tpu/ops/quantization.py:140"),
    # not TPU kernels: the JAX package's deterministic rounding is jnp code
    # and its int8 product is XLA's
    "quantize_int8": (QUANT_SOURCE, "raydp_tpu/ops/quantization.py:27 "
                      "(jnp, no pallas_call)"),
    "int8_gemm": (QUANT_SOURCE, "raydp_tpu/ops/quantization.py:62 "
                  "(jax.lax.dot_general, no pallas_call)"),
}

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# what a run writes and does not keep (checkpoints, a fit's trace)
BUILD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


@functools.lru_cache(maxsize=None)
def port_kernel_pattern() -> re.Pattern:
    """The port's kernels in a profile: the ``__global__`` functions of
    csrc/*.cu, which sit in an anonymous namespace (PyTorch, too, has
    kernels in anonymous namespaces, under ``at::native::``). The profiler
    names a template kernel with its return type ("void ...") and a plain
    one without it; an explicit specialisation (``name<256>``) is the
    template's kernel."""
    names = sorted({
        found for src in _build.CSRC_DIR.glob("*.cu")
        for found in re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)"
            r"\s*(?:<[^<>()]*>)?\s*\(",
            src.read_text())})
    return re.compile(
        rf"(?:void )?\(anonymous namespace\)::({'|'.join(names)})\b")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def onepass_env(value: str):
    """RAYDP_TPU_FLASH_ONEPASS set to ``value`` inside, restored after."""
    saved = os.environ.get("RAYDP_TPU_FLASH_ONEPASS")
    os.environ["RAYDP_TPU_FLASH_ONEPASS"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["RAYDP_TPU_FLASH_ONEPASS"]
        else:
            os.environ["RAYDP_TPU_FLASH_ONEPASS"] = saved


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def toolchain() -> dict:
    """The build this run uses: ``torch.__version__``, ``torch.version.cuda``
    and the line of ``nvcc --version`` that names the release (the compiler
    that builds the kernels: a missing nvcc is an error)."""
    text = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = [line.strip() for line in text.splitlines() if "release" in line]
    require(bool(release), f"nvcc --version names no release: {text!r}")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": release[0]}


def device_lines() -> dict:
    """Print the card's name and power limit as nvidia-smi gives them, and
    on the next line the build; returns both."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = toolchain()
    log(smi)
    log(f"build: torch {build['torch']}, CUDA {build['cuda']}, "
        f"nvcc {build['nvcc']}")
    return {"nvidia_smi": smi, "toolchain": build}


def phase_device() -> dict:
    lines = device_lines()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s -> {_build.library_path().name}")
    entries = ptxas_entries(_build.build_log())
    ptxas = {
        "kernels": len(entries),
        "max_registers": max((row["registers"] or 0 for row in entries.values()),
                             default=0),
        "spill_bytes": sum(row["spill_bytes"] for row in entries.values()),
    }
    log(f"ptxas: {ptxas}")
    sm90 = sm90_report(entries)
    decode = decode_report(entries)
    return lines | {"build_s": build_s, "ptxas": ptxas, "sm90": sm90,
                    "decode": decode, "chunked": chunked_report(entries),
                    "f32_fwd": f32_fwd_report(entries),
                    "f32_bwd": f32_bwd_report(entries),
                    "k1_k5": k1_k5_report(entries)}


def ptxas_entries(text: str) -> dict:
    """ptxas's report per entry function of the build log: registers,
    spill bytes and static shared memory."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(int(n) for n in
                               re.findall(r"(\d+) bytes spill", chunk)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
        }
    return out


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG")
# an instruction line of cuobjdump -sass: /*0a30*/ [@P0] OPCODE operands ;
SASS_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def parse_sass(text: str) -> dict:
    """Each function of ``cuobjdump -sass`` output as its list of opcodes,
    NOPs left out."""
    return {chunk.split("\n", 1)[0].strip(): [
                op for op in SASS_INSTRUCTION.findall(chunk) if op != "NOP"]
            for chunk in re.split(r"\n\s*Function : ", text)[1:]}


@functools.lru_cache(maxsize=None)
def sass_text(lib: Path) -> str:
    """The built library's SASS (``cuobjdump -sass``)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


@functools.lru_cache(maxsize=None)
def sass_functions(lib: Path) -> dict:
    """The built library's SASS, by ``parse_sass`` (parsed once: phase 1's
    six reports read it; callers do not change it)."""
    return parse_sass(sass_text(lib))


def sass_counts(lib: Path) -> dict:
    """HGMMA (bf16 wgmma), IGMMA (integer wgmma) and UTMALDG (TMA load)
    instructions per function of the built library's SASS."""
    return {name: {op: sum(o.split(".")[0] == op for o in ops)
                   for op in SASS_OPS}
            for name, ops in sass_functions(lib).items()}


def _sm90_key(family: str, found: re.Match) -> str:
    if family == "int8_gemm_sm90":
        mode = "small-N" if found.group(1) == "1" else "large-N"
        out = "f32" if found.group(2) == "f" else "bf16"
        staged = " TMA store" if found.group(3) == "1" else ""
        return f"{family} {mode} {out}{staged}"
    two = found.groups()[1:] == ("1",)
    return f"{family} D{found.group(1)}{' two-term' if two else ''}"


# the tensor-core kernels' instantiations in ptxas's and cuobjdump's mangled
# names: the bf16 forward <D, two-term>, the bf16 backward <D>, and the int8
# product <swapped, out type, staged epilogue>, with the wgmma op each must
# run
SM90_KERNELS = {
    "flash_fwd_sm90": (r"flash_fwd_sm90_kernelILi(\d+)ELb(\d)E", "HGMMA"),
    "flash_bwd_dq_sm90": (r"flash_bwd_dq_sm90_kernelILi(\d+)EE", "HGMMA"),
    "flash_bwd_dkv_sm90": (r"flash_bwd_dkv_sm90_kernelILi(\d+)EE", "HGMMA"),
    "int8_gemm_sm90": (
        r"int8_gemm_sm90_kernelILb(\d)E(f|13__nv_bfloat16)Lb(\d)E", "IGMMA"),
}
SM90_INSTANTIATIONS = 17


def sm90_report(entries: dict) -> dict:
    """The tensor-core kernels' instantiations among ptxas's ``entries``
    (the forward at D 64, 128 and 256, one-pass and two-term; dq and dk/dv
    at D 64, 128 and 256; the int8 product in its two modes, f32 and bf16 out, and
    the large mode's bf16 epilogue through TMA stores):
    registers and spills, and the SASS counts that show each runs on tensor
    cores (HGMMA for bf16, IGMMA for s8) through TMA. Fails on a spill, a
    missing instantiation or a missing wgmma op or UTMALDG."""
    sass = sass_counts(_build.library_path())
    out = {}
    for name, row in entries.items():
        for family, (pattern, op) in SM90_KERNELS.items():
            found = re.search(pattern, name)
            if not found:
                continue
            counts = sass.get(name, dict.fromkeys(SASS_OPS, 0))
            out[_sm90_key(family, found)] = row | counts | {"wgmma_op": op}
    log(f"sm90 kernels (ptxas, SASS): {out}")
    require(len(out) == SM90_INSTANTIATIONS,
            f"expected {SM90_INSTANTIATIONS} sm90 kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
        require(row[row["wgmma_op"]] > 0 and row["UTMALDG"] > 0,
                f"{key}: no {row['wgmma_op']} or UTMALDG in its SASS")
    return out


# the split f32/bf16-cache decode's two kernels <D, q type, cache type> in
# ptxas's mangled names (a repeated bf16 is a substitution, S..._)
DECODE_KERNEL = re.compile(r"(flash_decode_(?:scores|pv)_kernel)ILi(\d+)E(\w+?)Lb0E")
DECODE_TYPES = re.compile(r"f|13__nv_bfloat16|S\d*_")
DECODE_INSTANTIATIONS = 48  # D 8/16/32/64/128/256 x 4 type pairs x 2 kernels


def _decode_key(found: re.Match) -> str:
    types = ["f32" if tok == "f" else "bf16"
             for tok in DECODE_TYPES.findall(found.group(3))]
    return f"{found.group(1)} D{found.group(2)} q {types[0]} cache {types[1]}"


# the chunked bodies of head dims past 256 in ptxas's mangled names: the
# f32 and bf16 forward <two-term>, K4a's two kernels <256, q type, cache
# type, true> and K4b <256, q type, true>, and the f32 and bf16 backward's
# dq and dk/dv (no template)
CHUNKED_KERNELS = (
    re.compile(r"(flash_fwd_chunked_kernel)ILb(\d)E"),
    re.compile(r"(flash_fwd_sm90_chunked_kernel)ILb(\d)E"),
    re.compile(r"(flash_decode_(?:scores|pv)_kernel)ILi256E(\w+?)Lb1E"),
    re.compile(r"(flash_decode_int8_kernel)ILi256E(\w+?)Lb1E"),
    re.compile(r"(flash_bwd_(?:dq|dkv)(?:_sm90)?_chunked_kernel)E"),
)
CHUNKED_INSTANTIATIONS = 18  # 2 + 2 + 2 x 4 type pairs + 2 + 4


def _chunked_key(found: re.Match) -> str:
    if "bwd" in found.group(1):
        return found.group(1)
    if "fwd" in found.group(1):
        two = " two-term" if found.group(2) == "1" else ""
        return f"{found.group(1)}{two}"
    types = ["f32" if tok == "f" else "bf16"
             for tok in DECODE_TYPES.findall(found.group(2))]
    cache = f" cache {types[1]}" if len(types) > 1 else ""
    return f"{found.group(1)} chunked q {types[0]}{cache}"


def chunked_report(entries: dict) -> dict:
    """The chunked bodies of head dims past 256 among ptxas's ``entries``
    (``CHUNKED_KERNELS``): registers, spills and static shared memory, and
    for the tensor-core forward and backward their HGMMA and UTMALDG
    counts. Fails on a spill, a missing instantiation or a tensor-core body
    without them."""
    sass = sass_counts(_build.library_path())
    out = {}
    for name, row in entries.items():
        for pattern in CHUNKED_KERNELS:
            if found := pattern.search(name):
                extra = sass.get(name, {}) if "sm90" in found.group(1) else {}
                out[_chunked_key(found)] = row | extra
    log(f"chunked kernels, head dims past 256 (ptxas): {out}")
    require(len(out) == CHUNKED_INSTANTIATIONS,
            f"expected {CHUNKED_INSTANTIATIONS} chunked kernels, found "
            f"{sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
        if "sm90" in key:
            require(row.get("HGMMA", 0) > 0 and row.get("UTMALDG", 0) > 0,
                    f"{key}: no HGMMA or UTMALDG in its SASS")
    return out


def decode_report(entries: dict) -> dict:
    """The split decode's instantiations among ptxas's ``entries`` (scores
    and p.v kernels at D 8, 16, 32, 64, 128 and 256, f32 and bf16 q and
    cache):
    registers, spills and static shared memory. Fails on a spill or a
    missing one."""
    out = {_decode_key(found): row for name, row in entries.items()
           if (found := DECODE_KERNEL.search(name))}
    log(f"decode kernels (ptxas): {out}")
    require(len(out) == DECODE_INSTANTIATIONS,
            f"expected {DECODE_INSTANTIATIONS} decode kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
    return out


# the f32 prefill body's instantiations <D, two-term> in ptxas's mangled
# names, and the SASS opcodes that show what feeds its FP32 pipes: FFMA (the
# products), LDS (shared-memory loads), LDGSTS (cp.async), BAR, SHFL, MUFU
# (expf's exp2)
F32_FWD_KERNEL = re.compile(r"flash_fwd_kernelILi(\d+)ELb(\d)E")
F32_FWD_SASS_OPS = ("FFMA", "LDS", "LDGSTS", "BAR", "SHFL", "MUFU")
F32_FWD_INSTANTIATIONS = 12  # D 8, 16, 32, 64, 128, 256 x one-pass, two-term


def cuda_core_report(entries: dict, pattern: re.Pattern, key, expected: int,
                     what: str) -> dict:
    """The instantiations among ptxas's ``entries`` whose names match
    ``pattern`` (``key(match)`` names each): registers and spills, each
    one's SASS instruction count, the opcodes of F32_FWD_SASS_OPS and the
    static ratio of LDS to FFMA. Fails on a spill, a count other than
    ``expected`` or a zero FFMA, LDS or LDGSTS count."""
    sass = sass_functions(_build.library_path())
    out = {}
    for name, row in entries.items():
        if not (found := pattern.search(name)):
            continue
        ops = sass.get(name, [])
        counts = {op: sum(o.split(".")[0] == op for o in ops)
                  for op in F32_FWD_SASS_OPS}
        out[key(found)] = row | {"sass_instructions": len(ops)} | counts | {
            "lds_per_ffma": counts["LDS"] / max(counts["FFMA"], 1)}
    log(f"{what} kernels (ptxas, SASS): {out}")
    require(len(out) == expected,
            f"expected {expected} {what} kernels, found {sorted(out)}")
    for name, row in out.items():
        require(row["spill_bytes"] == 0, f"{name} spills")
        require(all(row[op] > 0 for op in ("FFMA", "LDS", "LDGSTS")),
                f"{name}: no FFMA, LDS or LDGSTS in its SASS")
    return out


def f32_fwd_report(entries: dict) -> dict:
    """The f32 prefill body's instantiations (D 8, 16, 32, 64, 128 and
    256, one-pass and two-term) through ``cuda_core_report``."""
    return cuda_core_report(
        entries, F32_FWD_KERNEL,
        lambda found: (f"flash_fwd_kernel D{found.group(1)}"
                       f"{' two-term' if found.group(2) == '1' else ''}"),
        F32_FWD_INSTANTIATIONS, "f32 forward")


# the f32 backward's instantiations <D> in ptxas's mangled names (dq and
# dk/dv, D 8, 16, 32, 64, 128 and 256); the bf16 bodies are
# flash_bwd_*_sm90_kernel
F32_BWD_KERNEL = re.compile(r"flash_bwd_(dq|dkv)_kernelILi(\d+)EE")
F32_BWD_INSTANTIATIONS = 12


def f32_bwd_report(entries: dict) -> dict:
    """The f32 backward's instantiations (dq and dk/dv, D 8, 16, 32, 64,
    128 and 256) through ``cuda_core_report``."""
    return cuda_core_report(
        entries, F32_BWD_KERNEL,
        lambda found: f"flash_bwd_{found.group(1)}_kernel D{found.group(2)}",
        F32_BWD_INSTANTIATIONS, "f32 backward")


# K5's and K1's instantiations in ptxas's mangled names: the stochastic
# rounding's register bodies <threads a row, 16-byte groups a thread> and its
# general body, and the interaction <element type>
K1_K5_KERNELS = {
    "quantize_stochastic_rows": r"quantize_stochastic_rows_kernelILi(\d+)ELi(\d+)E",
    "quantize_stochastic": r"quantize_stochastic_kernelE",
    "interaction_fwd": r"interaction_fwd_kernelI(f|13__nv_bfloat16)E",
}
K1_K5_INSTANTIATIONS = 5
# what a group of 4 elements costs K5 in issue slots: the integer multiplies
# and xors of Philox, the division's reciprocal and conversions, the byte
# permutes of the packing, and memory
K5_SASS_OPS = ("IMAD", "LOP3", "MUFU", "FRND", "F2I", "I2F", "PRMT", "LDG",
               "STG", "FFMA", "FADD", "FMNMX")


def _k1_k5_key(family: str, found: re.Match) -> str:
    if family == "quantize_stochastic_rows":
        return f"{family} {found.group(1)} threads a row x {found.group(2)} groups"
    if family == "interaction_fwd":
        return f"{family} {'f32' if found.group(1) == 'f' else 'bf16'}"
    return family


def k1_k5_report(entries: dict) -> dict:
    """K5's and K1's instantiations among ptxas's ``entries``: registers and
    spills (fails on a spill or a missing one), each one's SASS instruction
    count and the opcodes of K5_SASS_OPS; for K5's register bodies the
    instructions a group of 4 elements (the function's count over the
    groups a thread takes: the prologue and the row's reduction included)."""
    sass = sass_functions(_build.library_path())
    out = {}
    for name, row in entries.items():
        for family, pattern in K1_K5_KERNELS.items():
            if not (found := re.search(pattern, name)):
                continue
            ops = sass.get(name, [])
            key = _k1_k5_key(family, found)
            out[key] = row | {"sass_instructions": len(ops)} | {
                op: sum(o.split(".")[0] == op for o in ops)
                for op in K5_SASS_OPS}
            if family == "quantize_stochastic_rows":
                out[key]["instructions_per_group"] = len(ops) / int(found.group(2))
    log(f"K5 and K1 kernels (ptxas, SASS): {out}")
    require(len(out) == K1_K5_INSTANTIATIONS,
            f"expected {K1_K5_INSTANTIATIONS} K5/K1 kernels, found {sorted(out)}")
    for key, row in out.items():
        require(row["spill_bytes"] == 0, f"{key} spills")
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels(device, bh_heads=8, t=2048, d=128, lens=None) -> dict:
    lens = lens or DECODE_LENS
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}

    # flash_fwd (one-pass) and flash_fwd_twoterm: normalized (offsets 0)
    # and the stats surface (offsets); f32 on the CUDA cores, bf16 on the
    # tensor cores
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (_randn(gen, (1, bh_heads, t, d), dtype, device)
                   for _ in range(3))
        for causal in (False, True):
            for q_off, k_off, normalize in ((0, 0, True), (t // 4, t // 8, False)):
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off}) normalize={normalize}")
                out.update(check_forward(q, k, v, q_off, k_off, causal,
                                         normalize, case))
    out.update(check_forward_bf16(gen, device, bh_heads))
    out.update(check_forward_f32(gen, device, bh_heads))
    out.update(check_backward(gen, device, bh_heads, t, d))
    out.update(check_backward_bf16(gen, device, bh_heads))
    out.update(check_backward_f32(gen, device, bh_heads))
    out.update(check_train_shape(gen, device, bh_heads, d))
    out.update(check_decode(gen, device, bh_heads, t, d, lens))
    out.update(check_decode_bits(gen, device, bh_heads, t, lens))
    out.update(check_decode_bits(gen, device, bh_heads, *DECODE_BITS_ODD))
    qf, kf, vf = (_randn(gen, (1, bh_heads, t, d), torch.float32, device)
                  for _ in range(3))
    out["decode_vs_prefill_bf16"] = decode_gap_bf16(qf, kf, vf, lens)
    for cache in ("f32", "bf16", "int8"):
        out.update(check_decode_edges(gen, device, bh_heads, t, d, cache))
    out["small_heads"] = check_small_heads(gen, device)
    out["wide_heads"] = check_wide_heads(gen, device)
    out["heads_past_256"] = check_heads_past_256(gen, device)
    out.update(check_interaction(gen, device))
    out.update(check_stochastic(gen, device))
    out.update(check_quantize(gen, device))
    out.update(check_int8_gemm(gen, device))
    return out


def bf16_decode_limit(q, k, v, kv_len, plain_o, k_scale=None, v_scale=None):
    """Per-element limit of |decode - plain| for bf16 q: a bound, not a
    fit. The decode kernel keeps its f32 row update and does not round p,
    so the two sides differ by their own rounding of o to bf16, at most
    2^-8 of it each (2^-7 |plain|), and by the f32 sums, which run over the
    same 32-key tiles in another order: each product, exp and partial sum
    rounds at 2^-24 relative, and the partial sums stay below the attention
    of |v| (sum_j p_j |v_j| / l), so a few ulps of it; 1e-6 of it, about 17
    ulps."""
    a = fa.flash_decode_plain(q.float(), k, v.abs(), kv_len, k_scale, v_scale)
    return 2**-7 * plain_o.float().abs() + 1e-6 * a


def check_decode(gen, device, heads, t, d, lens,
                 dtypes=(torch.float32, torch.bfloat16), int8=True) -> dict:
    """flash_decode at the serving path's shapes (q [slots, H, 1, D], an
    f32 cache of capacity t, mixed kv_len) against flash_decode_plain:
    f32 q within 1e-5, bf16 q within ``bf16_decode_limit`` element by
    element (the worst |o - plain| / limit logged beside whether the old
    limit, an absolute 2e-2, would have passed). flash_decode_int8 against
    flash_decode on the dequantized cache (1e-6) and against its plain
    version, held the same way (where ``int8``). ``dtypes``: the types of
    q. Each call also bitwise over two launches."""
    out = {}
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    kc = _randn(gen, (b, heads, t, d), torch.float32, device)
    vc = _randn(gen, (b, heads, t, d), torch.float32, device)

    def held(name, got, qd, k, v, scales=(None, None)):
        ref = fa.flash_decode_plain(qd, k, v, kv_len, *scales)
        err = max_abs(got, ref)
        if qd.dtype == torch.float32:
            ok, detail = err <= 1e-5, "limit 1e-5"
        else:
            ratio = limit_ratio(got, ref, bf16_decode_limit(
                qd, k, v, kv_len, ref, *scales))
            ok = ratio <= 1.0
            detail = (f"worst |o-plain| / limit {ratio:.3f}; the old limit "
                      f"would pass: {err <= 2e-2}")
            out[f"{name} limit_ratio"] = ratio
        log(f"{name}: max|o-plain| {err:.3e} ({detail})")
        require(ok, f"{name} disagrees with its plain version")
        out[name] = err

    for dtype in dtypes:
        qd = _randn(gen, (b, heads, 1, d), dtype, device)
        name = f"flash_decode q {str(dtype)[6:]} kv_len={lens}"
        if d != 128:  # the serving shape keeps its key
            name += f" D{d} T={t}"
        got = finish_within(lambda: fa.flash_decode(qd, kc, vc, kv_len),
                            "flash_decode")
        require(torch.equal(got, fa.flash_decode(qd, kc, vc, kv_len)),
                f"{name} differs between launches")
        held(name, got, qd, kc, vc)
    if not int8:
        return out

    # flash_decode_int8 vs flash_decode on the dequantized cache
    def q8(x):
        vals, scales = quantize_int8(x.reshape(-1, d))
        return vals.reshape(x.shape), scales.reshape(x.shape[:3])

    k8, ks = q8(kc)
    v8, vs = q8(vc)
    k_dq = dequantize_int8(k8, ks[..., None])
    v_dq = dequantize_int8(v8, vs[..., None])
    for dtype in dtypes:
        qd = _randn(gen, (b, heads, 1, d), dtype, device)
        got = finish_within(lambda: fa.flash_decode(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs), "flash_decode_int8")
        again = fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs)
        name = f"flash_decode_int8 q {str(dtype)[6:]}"
        # K4a on the dequantized cache: the same function, its sums over
        # 32-key tiles in order where K4b's are split over 128-key chunks
        on_dq = fa.flash_decode(qd, k_dq, v_dq, kv_len)
        err_dq = max_abs(got, on_dq)
        if dtype == torch.float32:
            ok, detail = err_dq <= 1e-5, "atol 1e-5"
        else:
            ratio = limit_ratio(got, on_dq, bf16_decode_limit(
                qd, k_dq, v_dq, kv_len, on_dq))
            ok, detail = ratio <= 1.0, f"worst |d| / bf16_decode_limit {ratio:.3f}"
        log(f"{name}: max|o-f32 kernel on dequantized| {err_dq:.3e} "
            f"({detail}); two launches bitwise {torch.equal(got, again)}")
        require(ok, f"{name} disagrees with the dequantized cache")
        require(torch.equal(got, again), f"{name} differs between launches")
        held(name, got, qd, k8, v8, (ks, vs))
    return out


def check_decode_bits(gen, device, heads, t, lens, dims=(128, 64),
                      bf16=True) -> dict:
    """The f32/bf16-cache decode's bitwise contracts, at head dims ``dims``
    over a cache of capacity t, one sequence per kv_len of
    ``DECODE_BITS_LENS`` (those within t) and ``lens`` in one batch:

    - decode == the f32 prefill row at its position (the CUDA-core forward
      over the whole cache, causal), bit for bit, for tq 1 and for tq 3
      against the prefill's last 3 rows: the failover contract;
    - two launches give the same bits;
    - where ``bf16`` (the head dims with bf16 kernels): bf16 q gives the
      same bits as f32 q rounded to bf16 after (q and the cache are staged
      as f32, o rounded once), and a bf16 cache the same bits as that cache
      widened to f32;
    - each against ``flash_decode_plain``: 1e-5 for f32 q, element by
      element within ``bf16_decode_limit`` for bf16 q."""
    out = {}
    ns_all = sorted(set(DECODE_BITS_LENS) | set(lens))
    for d in dims:
        q, k, v = (_randn(gen, (1, heads, t, d), torch.float32, device)
                   for _ in range(3))
        prefill = fa.flash_attention(q, k, v, causal=True)
        for tq in (1, 3):
            ns = [n for n in ns_all if tq <= n <= t]
            kv_len = torch.tensor(ns, dtype=torch.int32, device=device)
            kc, vc = (x.expand(len(ns), -1, -1, -1).contiguous() for x in (k, v))
            qd = torch.cat([q[:, :, n - tq:n] for n in ns])
            ref = torch.cat([prefill[:, :, n - tq:n] for n in ns])
            name = f"flash_decode bits D{d} tq={tq} T={t}"
            got = finish_within(lambda: fa.flash_decode(qd, kc, vc, kv_len),
                                "flash_decode")
            off = [n for i, n in enumerate(ns) if not torch.equal(got[i], ref[i])]
            again = torch.equal(got, fa.flash_decode(qd, kc, vc, kv_len))
            plain = max_abs(got, fa.flash_decode_plain(qd, kc, vc, kv_len))
            log(f"{name} kv_len={ns}: decode == f32 prefill row bit for bit "
                f"except at {off} (max|d| {max_abs(got, ref):.3e}); two launches "
                f"bitwise {again}; max|o-plain| {plain:.3e} (limit 1e-5)")
            require(not off, f"{name} disagrees with the f32 prefill row at "
                    f"kv_len {off}")
            require(again, f"{name} differs between launches")
            require(plain <= 1e-5, f"{name} disagrees with its plain version")
            out[name] = plain
            if tq != 1 or not bf16:
                continue
            # the two identities of staging q and the cache as f32
            qb = qd.bfloat16()
            got_b = fa.flash_decode(qb, kc, vc, kv_len)
            same_q = torch.equal(got_b, fa.flash_decode(qb.float(), kc, vc,
                                                        kv_len).bfloat16())
            kb, vb = kc.bfloat16(), vc.bfloat16()
            got_kb = fa.flash_decode(qd, kb, vb, kv_len)
            same_kv = torch.equal(got_kb, fa.flash_decode(qd, kb.float(),
                                                          vb.float(), kv_len))
            plain_b = fa.flash_decode_plain(qb, kc, vc, kv_len)
            ratio = limit_ratio(got_b, plain_b, bf16_decode_limit(
                qb, kc, vc, kv_len, plain_b))
            plain_kb = max_abs(got_kb, fa.flash_decode_plain(qd, kb, vb, kv_len))
            log(f"flash_decode D{d}: bf16 q == f32 q rounded after, bitwise "
                f"{same_q}; bf16 cache == that cache as f32, bitwise {same_kv}; "
                f"bf16 q |o-plain| / bf16_decode_limit {ratio:.3f}; bf16 cache "
                f"max|o-plain| {plain_kb:.3e} (limit 1e-5)")
            require(same_q, f"flash_decode D{d} bf16 q disagrees with f32 q "
                    "rounded after")
            require(same_kv, f"flash_decode D{d} bf16 cache disagrees with the "
                    "same cache as f32")
            require(ratio <= 1.0 and plain_kb <= 1e-5,
                    f"flash_decode D{d} bf16 disagrees with its plain version")
            out[f"flash_decode bits D{d} T={t} bf16 q limit_ratio"] = ratio
    return out


def check_decode_edges(gen, device, heads, t, d, cache: str,
                       q_dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """A decode kernel's edge cases against flash_decode_plain (f32 q within
    1e-5, bf16 q within bf16_decode_limit), each bitwise over two launches,
    from an f32, bf16 or int8 cache (``cache``): kv_len 1, at the 32-key
    tile and 128-key block boundaries, at capacity and past it (clipped),
    tq 3 (causal inside the new rows, kv_len 2 leaving row 0 without a
    key), and a sequence of no live key, whose output must be exactly 0."""
    out = {}
    c = fa.DECODE_CHUNK
    cases = (([1, c - 1, c, c + 1], 1), ([t, t + 100, 2 * c - 1, 0], 1),
             ([2, c, 3 * c + 1, t], 3), ([31, 32, 33, 2 * c + 1], 1))
    kc = _randn(gen, (4, heads, t, d), torch.float32, device)
    vc = _randn(gen, (4, heads, t, d), torch.float32, device)
    if cache == "int8":
        kc, ks = quantize_int8(kc)
        vc, vs = quantize_int8(vc)
        scales = (ks[..., 0], vs[..., 0])
        kernel = "flash_decode_int8"
    else:
        dtype = torch.float32 if cache == "f32" else torch.bfloat16
        kc, vc = kc.to(dtype), vc.to(dtype)
        scales = (None, None)
        kernel = "flash_decode"
    for lens, tq in cases:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
        for dtype in q_dtypes:
            q = _randn(gen, (4, heads, tq, d), dtype, device)

            def call():
                return fa.flash_decode(q, kc, vc, kv_len, k_scale=scales[0],
                                       v_scale=scales[1])

            got = finish_within(call, kernel)
            same = torch.equal(got, call())
            ref = fa.flash_decode_plain(q, kc, vc, kv_len, *scales)
            err = max_abs(got, ref)
            name = (f"{kernel} edges kv_len={lens} tq={tq} q {str(dtype)[6:]}"
                    + ("" if cache == "int8" else f" cache {cache}"))
            if dtype == torch.float32:
                ok, detail = err <= 1e-5, "limit 1e-5"
            else:
                ratio = limit_ratio(got, ref, bf16_decode_limit(
                    q, kc, vc, kv_len, ref, *scales))
                ok, detail = ratio <= 1.0, f"worst |o-plain| / limit {ratio:.3f}"
            empty = [i for i, n in enumerate(lens) if n == 0]
            zeros = all(bool((got[i] == 0).all()) for i in empty)
            log(f"{name}: max|o-plain| {err:.3e} ({detail}); no-key rows 0: "
                f"{zeros}; two launches bitwise {same}")
            require(ok and zeros, f"{name} disagrees with its plain version")
            require(same, f"{name} differs between launches")
            out[name] = err
    return out


def small_head_family(key: str) -> str:
    """The kernel family a check of ``check_small_heads`` holds, from its
    key: the forward (``flash_fwd_f32`` for f32, ``flash_fwd`` for bf16, both
    bodies), dq and dk/dv (f32 ``_f32``, bf16 without), K4a
    (``flash_decode``, every pair of types) and K4b
    (``flash_decode_int8``)."""
    f32 = "float32" in key
    for name in ("flash_decode_int8", "flash_decode", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        if key.startswith(name):
            return name + "_f32" if name.startswith("flash_bwd") and f32 else name
    return "flash_fwd_f32" if f32 else "flash_fwd"


def fold_head_dim(out: dict, worst: dict, d: int, checks: dict) -> None:
    """Add a check's results at head dim ``d`` to ``out`` (keys prefixed
    ``D<d>``) and fold them into ``worst``: per family and head dim, the
    largest |kernel - plain| and (bf16) |kernel - plain| / limit."""
    for key, value in checks.items():
        out[f"D{d} {key}"] = value
        row = worst.setdefault(f"{small_head_family(key)} D{d}", {})
        kind = "limit_ratio" if key.endswith("limit_ratio") else "max_abs_err"
        row[kind] = max(row.get(kind, 0.0), value)


def small_head_backward_cases(heads, t, cap) -> tuple:
    """The backward's cases at the small heads, (q shape without D, Tk,
    q_off, k_off, causal): the trace LM's prefill (capacity 64) and [1, 2,
    2048] causal; T 200 against Tk 136, not causal (off the 64-key tiles);
    q_off < k_off, rows with no live key."""
    return (((1, heads, cap), cap, 0, 0, True),
            ((1, heads, t), t, 0, 0, True),
            ((1, heads, 200), 136, 0, 0, False),
            ((1, heads, 512), 512, 0, 300, True))


def check_small_heads(gen, device) -> dict:
    """Every attention family at the small LMs' head dims
    (``SMALL_HEAD_DIMS``: chaos.py's and tools/trace_smoke.py's LM, d_model
    32 over 2 heads, is D 16, over 4 heads D 8; D 24 runs zero-padded to
    32), at the trace LM's engine shapes (a causal prefill of [1, 2,
    capacity 64]; decode rows of 4 slots against that capacity) and at [1,
    2, 2048, D], each against its plain version and bitwise over two
    launches:

    - the forward, f32 (CUDA-core body) and bf16 (tensor-core body), both
      bodies, through ``check_forward`` (f32 o within 1e-5, bf16 within
      ``bf16_limit``; m and l allclose; the two bodies bitwise), causal and
      not, a ragged Tk and the stats surface with offsets;
    - the backward, f32 (within 1e-4) and bf16 (within ``bf16_bwd_limit``),
      through ``check_bwd`` (``small_head_backward_cases``), rows with no
      live key getting dq 0;
    - K4a: f32 and bf16 q from an f32 cache within 1e-5 / ``bf16_decode_limit``;
      bit for bit the f32 prefill row at its position at every tile
      boundary within the capacity, tq 1 and 3; bf16 q equal to f32 q
      rounded after and a bf16 cache to that cache as f32, bit for bit; its
      edge cases from f32 and bf16 caches, f32 and bf16 q; a bf16 decode
      row within ``bf16_limit`` of the bf16 prefill row (``decode_gap_bf16``);
    - K4b: against K4a on the dequantized cache and its plain version, f32
      and bf16 q, and its edge cases.

    ``worst`` holds, per family and head dim, the largest |kernel - plain|
    and (bf16) the largest |kernel - plain| / limit."""
    out, worst = {}, {}
    heads, cap = TRACE_LM["heads"], TRACE_LM["capacity"]
    t = SMALL_HEADS_T
    fold = functools.partial(fold_head_dim, out, worst)

    for d in SMALL_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            fold(d, forward_cases(gen, device, dtype, (
                ((1, heads, cap, d), cap, 0, 0, True, True),
                ((1, heads, t, d), t, 0, 0, True, True),
                ((1, heads, t, d), t, 0, 0, False, True),
                ((1, heads, 200, d), 136, 0, 0, True, True),
                ((1, heads, 512, d), 812, 300, 0, True, False),
                ((1, heads, 512, d), 512, 0, 300, True, True))))
            fold(d, check_backward_cases(gen, device, heads, dtype, [
                ((*shape, d), tk, q_off, k_off, causal) for
                shape, tk, q_off, k_off, causal in
                small_head_backward_cases(heads, t, cap)]))
        for cap_t, lens in ((cap, TRACE_LM["decode_lens"]), (t, DECODE_LENS)):
            fold(d, check_decode(gen, device, heads, cap_t, d, lens))
            fold(d, check_decode_bits(gen, device, heads, cap_t, lens,
                                      dims=(d,)))
        for cache in ("f32", "bf16", "int8"):
            fold(d, check_decode_edges(gen, device, heads, t, d, cache))
        qf, kf, vf = (_randn(gen, (1, heads, t, d), torch.float32, device)
                      for _ in range(3))
        out[f"D{d} decode_vs_prefill_bf16"] = decode_gap_bf16(qf, kf, vf,
                                                              DECODE_LENS)
    out["worst"] = worst
    log(f"small head dims {SMALL_HEAD_DIMS}: worst |kernel - plain| (and "
        f"bf16 |kernel - plain| / limit) {worst}")
    return out


def decode_gap_bf16(q, k, v, lens) -> dict:
    """The restated contract for bf16 q/k/v: the prefill row (the
    tensor-core forward, p rounded to bf16) against the decode row from an
    f32 cache holding the same bf16 K/V (the CUDA-core decode kernel), as
    the engine runs them; within ``bf16_limit`` element by element (only
    the prefill rounds p), not bitwise."""
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    prefill = fa.flash_attention(qb, kb, vb, causal=True)
    worst, ratio = 0.0, 0.0
    for n in lens:
        row = fa.flash_decode(qb[:, :, n - 1:n], kb.float(), vb.float(),
                              torch.tensor([n], device=q.device))
        ref = prefill[:, :, n - 1:n]
        limit = bf16_limit(qb[:, :, n - 1:n], kb[:, :, :n], vb[:, :, :n],
                           0, 0, False, ref)
        diff = (row.float() - ref.float()).abs()
        worst = max(worst, float(diff.max()))
        ratio = max(ratio, float((diff / torch.clamp(limit, min=1e-30)).max()))
    log(f"decode vs prefill row (bf16 q/k/v, f32 cache, kv_len {lens}): "
        f"max|d| {worst:.3e}, worst |d| / limit {ratio:.3f} (not bitwise by "
        "design)")
    require(ratio <= 1.0, "bf16 decode row is off the prefill row")
    return {"max_abs": worst, "limit_ratio": ratio}


def wide_forward_cases(heads, t, d) -> tuple:
    """The forward's cases at a head dim past 128, (q shape, Tk, q_off,
    k_off, causal, normalize): the prefill [1, heads, t, D] causal and not,
    and with offsets through the stats surface; at 2 heads T 200 against Tk
    136, causal (ragged off every tile), q_off > 0 against more keys, and
    q_off < k_off (rows with no live key)."""
    return (((1, heads, t, d), t, 0, 0, True, True),
            ((1, heads, t, d), t, 0, 0, False, True),
            ((1, heads, t, d), t, t // 4, t // 8, True, False),
            ((1, 2, 200, d), 136, 0, 0, True, True),
            ((1, 2, 512, d), 812, 300, 0, True, False),
            ((1, 2, 512, d), 512, 0, 300, True, True))


def wide_backward_cases(heads, t, d) -> tuple:
    """The backward's cases at a head dim past 128, (q shape, Tk, q_off,
    k_off, causal): [1, heads, t, D] causal (the f32 step's shape), T 1500
    causal (off the tiles), T 200 against Tk 136 not causal, a ring's
    block pair at global offsets (queries from 300 against 812 keys from
    0), causal, and q_off < k_off (rows with no live key), the last four at
    2 heads."""
    return (((1, heads, t, d), t, 0, 0, True),
            ((1, 2, 1500, d), 1500, 0, 0, True),
            ((1, 2, 200, d), 136, 0, 0, False),
            ((1, 2, 512, d), 812, 300, 0, True),
            ((1, 2, 512, d), 512, 0, 300, True))


def check_wide_heads(gen, device) -> dict:
    """Every attention family at the head dims of ``WIDE_HEAD_DIMS`` (256,
    bench.py's LM at d_model 2048; 192, zero-padded to 256), each against
    its plain version and bitwise over two launches, at the limits of
    phase 2 (f32 forward and decode 1e-5, backward 1e-4; bf16 within
    ``bf16_limit``, ``bf16_bwd_limit``, ``bf16_decode_limit``):

    - the forward, f32 and bf16, both bodies (``wide_forward_cases``);
    - the backward, f32 and bf16 (``wide_backward_cases``: causal, causal
      off every tile, not causal, at a ring's global offsets and with rows
      that see no key), rows with no live key getting dq 0, every call
      through the kernels (``check_backward_launched``);
    - at D 256 only, the bf16 training step's shape [2, 8, 8192, 256]
      causal, the forward and the backward (``check_train_shape``);
    - K4a (f32 and bf16 q, an f32 cache) and K4b (against K4a on the
      dequantized cache and its plain version) at the serving shape,
      ``check_decode``; at D 256 also decode == the f32 prefill row bit for
      bit at every tile and block boundary, tq 1 and 3, with the bf16
      identities (``check_decode_bits``), the edges from f32, bf16 and int8
      caches (``check_decode_edges``, 2 heads) and the bf16 decode row
      within ``bf16_limit`` of the bf16 prefill row.

    ``worst`` holds, per family and head dim, the largest |kernel - plain|
    and (bf16) the largest |kernel - plain| / limit."""
    out, worst = {}, {}
    t = SMALL_HEADS_T
    fold = functools.partial(fold_head_dim, out, worst)

    for d in WIDE_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            fold(d, forward_cases(gen, device, dtype,
                                  wide_forward_cases(WIDE_HEADS, t, d)))
            fold(d, check_backward_launched(
                gen, device, WIDE_HEADS, dtype,
                wide_backward_cases(WIDE_HEADS, t, d)))
        fold(d, check_decode(gen, device, WIDE_HEADS, t, d, DECODE_LENS))
        if d != 256:
            continue
        fold(d, check_train_shape(gen, device, WIDE_HEADS, d))
        fold(d, check_decode_bits(gen, device, WIDE_HEADS, t, DECODE_LENS,
                                  dims=(d,)))
        for cache in ("f32", "bf16", "int8"):
            fold(d, check_decode_edges(gen, device, 2, t, d, cache))
        qf, kf, vf = (_randn(gen, (1, WIDE_HEADS, t, d), torch.float32, device)
                      for _ in range(3))
        out[f"D{d} decode_vs_prefill_bf16"] = decode_gap_bf16(qf, kf, vf,
                                                              DECODE_LENS)
    out["worst"] = worst
    log(f"wide head dims {WIDE_HEAD_DIMS}: worst |kernel - plain| (and bf16 "
        f"|kernel - plain| / limit) {worst}")
    return out


def past_256_backward_cases(heads, t, d) -> tuple:
    """The backward's cases at a head dim past 256, (q shape, Tk, q_off,
    k_off, causal): [1, heads, t, D] causal with zero offsets (the f32
    step's shape); T 1500 causal (ragged off every tile); a ring's block
    pair at global offsets (queries from 300 against 812 keys from 0),
    causal; q_off < k_off (rows with no live key), causal; and T 200
    against Tk 136, not causal, the last four at 2 heads."""
    return (((1, heads, t, d), t, 0, 0, True),
            ((1, 2, 1500, d), 1500, 0, 0, True),
            ((1, 2, 512, d), 812, 300, 0, True),
            ((1, 2, 512, d), 512, 0, 300, True),
            ((1, 2, 200, d), 136, 0, 0, False))


def check_backward_launched(gen, device, heads, dtype, cases) -> dict:
    """``check_backward_cases`` on ``cases``, and every backward call there
    went through dq's and dk/dv's kernels where the wrappers take the
    kernel route on ``device`` (no plain fallback): at least two launches
    of each a case (``check_bwd``'s two calls), none on the plain route."""
    bwd = ("flash_bwd_dq", "flash_bwd_dkv")
    before = {n: fa.LAUNCHES[n] for n in bwd}
    out = check_backward_cases(gen, device, heads, dtype, cases)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in bwd}
    kernel_route = not fa._on_cpu(torch.empty(0, device=device))
    require(all(n >= 2 * len(cases) if kernel_route else n == 0
                for n in launched.values()),
            f"the backward {str(dtype)[6:]} at D{cases[0][0][-1]} disagrees "
            f"with its launches: {launched} over {len(cases)} cases")
    return out


def check_heads_past_256(gen, device) -> dict:
    """Every attention family at the head dims of ``PAST_256_HEAD_DIMS``
    (512, bench.py's LM at d_model 4096; 320, zero-padded to 512; 1024 and
    1536), which they take in 256-column chunks, each against its plain
    version and bitwise over two launches, at the limits of phase 2 (f32
    forward and decode 1e-5, backward 1e-4; bf16 within ``bf16_limit``,
    ``bf16_bwd_limit``, ``bf16_decode_limit``):

    - the forward, f32 and bf16, both bodies (``wide_forward_cases``);
    - the backward, f32 and bf16 (``past_256_backward_cases``: causal with
      zero offsets, causal off every tile, at a ring's global offsets, with
      rows that see no key, and not causal), rows with no live key getting
      dq 0, every call through the kernels (``check_backward_launched``);
      the f32 backward also at ``PAST_256_ODD_DIM`` (a chunk alone);
    - at D 512 only, the bf16 training step's shape [2, 8, 8192, 512]
      causal, the forward and the backward (``check_train_shape``);
    - K4a (f32 and bf16 q, an f32 cache) and K4b (against K4a on the
      dequantized cache and its plain version) at the serving shape,
      ``check_decode``; at ``PAST_256_BITS_DIMS`` also decode == the f32
      prefill row bit for bit at every tile and block boundary, tq 1 and
      3, with the bf16 identities (``check_decode_bits``), and the edges
      from f32, bf16 and int8 caches (``check_decode_edges``, 2 heads).

    ``worst`` holds, per family and head dim, the largest |kernel - plain|
    and (bf16) the largest |kernel - plain| / limit."""
    out, worst = {}, {}
    t = SMALL_HEADS_T
    fold = functools.partial(fold_head_dim, out, worst)

    for d in PAST_256_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            fold(d, forward_cases(gen, device, dtype,
                                  wide_forward_cases(WIDE_HEADS, t, d)))
            fold(d, check_backward_launched(
                gen, device, WIDE_HEADS, dtype,
                past_256_backward_cases(WIDE_HEADS, t, d)))
        fold(d, check_decode(gen, device, WIDE_HEADS, t, d, DECODE_LENS))
        if d == 512:
            fold(d, check_train_shape(gen, device, WIDE_HEADS, d))
        if d not in PAST_256_BITS_DIMS:
            continue
        fold(d, check_decode_bits(gen, device, WIDE_HEADS, t, DECODE_LENS,
                                  dims=(d,)))
        for cache in ("f32", "bf16", "int8"):
            fold(d, check_decode_edges(gen, device, 2, t, d, cache))
    fold(PAST_256_ODD_DIM, check_backward_launched(
        gen, device, WIDE_HEADS, torch.float32,
        past_256_backward_cases(WIDE_HEADS, t, PAST_256_ODD_DIM)))
    out["worst"] = worst
    log(f"head dims past 256 {PAST_256_HEAD_DIMS}: worst |kernel - plain| "
        f"(and bf16 |kernel - plain| / limit) {worst}")
    return out


def finish_within(fn, what: str, seconds: float = 60.0):
    """``fn()``, then wait at most ``seconds`` for the card to finish it. A
    kernel that never ends (an mbarrier phase that never completes) fails
    the run at once instead of holding it to its time limit; the process
    leaves by ``os._exit``, as a hung kernel would also hang the
    interpreter's exit."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"chip_smoke: {what} has not finished after {seconds:.0f} s",
                  file=sys.stderr, flush=True)
            os._exit(1)
        time.sleep(0.005)
    return out


def bf16_limit(q, k, v, q_off, k_off, causal, plain_o):
    """Per-element limit of |bf16 forward - plain| on the attention (o, or
    o / l): a bound, not a fit. Each side rounds its output to bf16, half an
    ulp, at most 2^-8 |o| each; the tensor-core kernel rounds each p to bf16
    before P.V, at most 2^-8 p, so at most 2^-8 sum_j p_j |v_j| / l, the
    attention of |v|; 5% on that for the f32 sums."""
    a, _, l = fa.flash_attention_call_plain(  # noqa: E741
        q, k, v.abs(), q_off, k_off, causal, normalize=False)
    a = a / torch.clamp(l, min=1e-30)[..., None]
    return 2**-7 * plain_o.float().abs() + 1.05 * 2**-8 * a


def check_forward(q, k, v, q_off, k_off, causal, normalize, case) -> dict:
    """flash_fwd and flash_fwd_twoterm against flash_attention_call_plain on
    the same inputs, compared as o / l for the stats surface: o within 1e-5
    (f32), or within ``bf16_limit`` element by element (bf16: the
    tensor-core kernel rounds p to bf16); m and l allclose(rtol 1e-5, atol
    1e-6). Each body gives the same bits over two launches, and the two
    bodies the same bits. The first launch of each case must finish within
    a minute."""
    out, got = {}, {}
    limit = None
    for onepass in (True, False):
        name = ("flash_fwd " if onepass else "flash_fwd_twoterm ") + case
        res = finish_within(lambda onepass=onepass: fa.flash_attention_call(
            q, k, v, q_off, k_off, causal, normalize, onepass), name)
        again = fa.flash_attention_call(q, k, v, q_off, k_off, causal,
                                        normalize, onepass)
        same = all(torch.equal(a, b) for a, b in zip(res, again))
        got[onepass] = res
        (o, m, l), (po, pm, pl) = res, fa.flash_attention_call_plain(  # noqa: E741
            q, k, v, q_off, k_off, causal, normalize, onepass)
        if not normalize:  # compare the attention, o / l
            o = o / torch.clamp(l, min=1e-30)[..., None]
            po = po / torch.clamp(pl, min=1e-30)[..., None]
        diff = (o.float() - po.float()).abs()
        err = float(diff.max())
        if q.dtype == torch.float32:
            o_ok, worst = err <= 1e-5, "limit 1e-5"
        else:
            if limit is None:
                limit = bf16_limit(q, k, v, q_off, k_off, causal, po)
            ratio = float((diff / torch.clamp(limit, min=1e-30)).max())
            o_ok = ratio <= 1.0
            worst = (f"worst |o-plain| / limit {ratio:.3f}, max|plain| "
                     f"{float(po.float().abs().max()):.3e}")
        m_ok = torch.allclose(m, pm, rtol=1e-5, atol=1e-6)
        l_ok = torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
        log(f"{name}: max|o-plain| {err:.3e} ({worst}) m ok {m_ok} "
            f"l ok {l_ok}; two launches bitwise {same}")
        require(o_ok and m_ok and l_ok, f"{name} disagrees")
        require(same, f"{name} differs between launches")
        out[name] = err
    bitwise = all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    log(f"flash_fwd_twoterm == flash_fwd bitwise ({case}): {bitwise}")
    require(bitwise, f"two-term body differs from one-pass ({case})")
    return out


def check_forward_bf16(gen, device, heads) -> dict:
    """The tensor-core forward's hard cases, bf16, through check_forward:
    D 64; T and Tk off the 128-row tile (T 1500; T 200 against Tk 136,
    causal and not); q_off < k_off, where the first rows see no key (o 0,
    m NEG_INF, l 0, no NaN), normalized and not."""
    return forward_cases(gen, device, torch.bfloat16, (
        ((1, heads, 2048, 64), 2048, 0, 0, False, True),
        ((1, heads, 2048, 64), 2048, 0, 0, True, True),
        ((1, heads, 1500, 128), 1500, 0, 0, True, True),
        ((1, heads, 200, 128), 136, 0, 0, False, True),
        ((1, heads, 200, 128), 136, 0, 0, True, True),
        ((1, heads, 512, 128), 512, 0, 300, True, True),
        ((1, heads, 512, 64), 512, 0, 300, True, False)))


def check_forward_f32(gen, device, heads) -> dict:
    """The CUDA-core f32 body's edges through check_forward (o within 1e-5
    of the plain version, m and l allclose, two launches and the two bodies
    bitwise): T one row either side of its 64-row block; Tk off the 32-key
    tile (T 200 against Tk 136), causal and not; causal with q_off > 0 (512
    rows at position 300 against 812 keys) and with k_off > 0 (the first
    300 rows see no key: o 0, m NEG_INF, l 0); a causal block wholly in
    the future of every row (k_off = q_off + T, a later rank's block in
    the ring); D 64; T past 1024, where the staged group of four K/V tiles
    is refilled many times."""
    rows = fa.BLOCK_Q
    return forward_cases(gen, device, torch.float32, (
        ((1, heads, 512, 128), 512, 0, 512, True, False),
        ((1, heads, rows - 1, 128), rows - 1, 0, 0, True, True),
        ((1, heads, rows + 1, 128), rows + 1, 0, 0, True, False),
        ((1, heads, rows + 1, 64), rows + 1, 0, 0, False, True),
        ((1, heads, 200, 128), 136, 0, 0, False, True),
        ((1, heads, 200, 128), 136, 0, 0, True, False),
        ((1, heads, 512, 128), 812, 300, 0, True, True),
        ((1, heads, 512, 128), 512, 0, 300, True, True),
        ((1, heads, 512, 64), 512, 0, 300, True, False),
        ((1, heads, 2048, 64), 2048, 0, 0, True, True),
        ((1, heads, 1500, 128), 1500, 0, 0, True, True),
        ((1, heads, 1500, 64), 1100, 0, 0, False, False)))


def forward_cases(gen, device, dtype, cases) -> dict:
    """check_forward over ``cases`` of (q shape, Tk, q_off, k_off, causal,
    normalize) in ``dtype``; where q_off < k_off, the rows before the first
    key must give o 0, m NEG_INF and l 0."""
    out = {}
    for shape, tk, q_off, k_off, causal, normalize in cases:
        b, h, t, d = shape
        q = _randn(gen, shape, dtype, device)
        k, v = (_randn(gen, (b, h, tk, d), dtype, device) for _ in range(2))
        case = (f"{str(dtype)[6:]} [{b},{h},{t},{d}] tk={tk} causal={causal} "
                f"offsets=({q_off},{k_off}) normalize={normalize}")
        out.update(check_forward(q, k, v, q_off, k_off, causal, normalize, case))
        if k_off > q_off:  # rows before the first key see none
            o, m, l = fa.flash_attention_call(q, k, v, q_off, k_off, causal,  # noqa: E741
                                              normalize)
            dead = k_off - q_off
            require(bool(torch.isfinite(o).all())
                    and not bool(o[:, :, :dead].float().abs().max())
                    and bool((m[:, :, :dead] == fa.NEG_INF).all())
                    and not bool(l[:, :, :dead].abs().max()),
                    f"fully masked rows are not o 0, m NEG_INF, l 0 ({case})")
    return out


def interaction_case(b, f, d, dtype) -> str:
    return f"interaction_fwd [{b},{f},{d}] {str(dtype)[6:]}"


def refused_as_invalid(fn) -> bool:
    """Whether ``fn`` was refused as the kernels refuse a shape they do not
    take: ``_build.check``'s error for cudaErrorInvalidValue (1). Any other
    error (a failed launch, a sticky error of an earlier kernel) is raised
    again."""
    try:
        fn()
    except RuntimeError as err:
        if re.search(r": CUDA error 1 \(", str(err)):
            return True
        raise
    return False


def check_interaction(gen, device) -> dict:
    """interaction_fwd against dot_interaction_plain on the same inputs: at
    the DLRM path's shape in f32 and bf16, at the Criteo Kaggle shape, and
    at the edges of the kernel's layout (INTERACTION_EDGES: one pair, a
    triangle that fills no whole warp of stores, batches that are not a
    multiple of a task's rows, a D off the 16-byte staging, an unaligned T
    and the widest row one block holds); f32 atol 1e-5 * max|plain|, bf16
    2e-2 * max|plain|; two launches bitwise equal. A row one feature wider
    than the widest is refused. Then the wrapper's input gradient against
    autograd through the plain version (f32, 1e-5 relative)."""
    (pb, pf, pd), (kb, kf, kd) = (INTERACTION_SHAPES["path"],
                                  INTERACTION_SHAPES["kaggle"])
    out = {}
    cases = [(pb, pf, pd, torch.float32, 0), (pb, pf, pd, torch.bfloat16, 0),
             (kb, kf, kd, torch.float32, 0), (kb, kf, kd, torch.bfloat16, 0),
             *INTERACTION_EDGES]
    for b, f, d, dtype, offset in cases:
        flat = _randn(gen, (b * f * d + offset,), dtype, device)
        t = flat[offset:].view(b, f, d)  # offset 1: T off its alignment
        got, again = ia.interaction_fwd(t), ia.interaction_fwd(t)
        ref = ia.dot_interaction_plain(t)
        err = max_abs(got, ref)
        limit = (1e-5 if dtype == torch.float32 else 2e-2) * float(
            ref.float().abs().max())
        same = torch.equal(got, again)
        name = interaction_case(b, f, d, dtype) + (
            f" offset {offset}" if offset else "")
        log(f"{name}: max|out-plain| {err:.3e} (limit {limit:.3e}); two "
            f"launches bitwise {same}")
        require(got.dtype == dtype and err <= limit, f"{name} disagrees")
        require(same, f"{name} differs between launches")
        out[name] = err

    b, f, d, dtype, _ = INTERACTION_EDGES[-1]
    wide = torch.zeros((b, f + 1, d), dtype=dtype, device=device)
    refused = refused_as_invalid(lambda: ia.interaction_fwd(wide))
    log(f"{interaction_case(b, f + 1, d, dtype)}: refused {refused}")
    require(refused, "interaction_fwd took a row wider than shared memory")

    t = _randn(gen, (pb, pf, pd), torch.float32, device).requires_grad_()
    g = _randn(gen, (pb, pf * (pf - 1) // 2), torch.float32, device)
    (grad,) = torch.autograd.grad((ia.dot_interaction_kernel(t) * g).sum(), t)
    (ref,) = torch.autograd.grad((ia.dot_interaction_plain(t) * g).sum(), t)
    rel = float((grad - ref).norm() / ref.norm())
    log(f"interaction input gradient [{pb},{pf},{pd}] f32 vs the plain "
        f"version's autograd: {rel:.3e} relative (limit 1e-5)")
    require(rel <= 1e-5, "interaction gradient disagrees with the plain path")
    out["interaction_grad_rel"] = rel
    return out


def stochastic_case(n, d) -> str:
    return f"quantize_int8_stochastic [{n},{d}] f32"


def check_quantized(x, values, scales, name) -> dict:
    """The stochastic contract on one call: int8 values and f32 scales of
    the right shapes; |values - x/s| <= 1 (floor(x/s + u) with u in [0,
    1), clipped to 127 >= |x/s|; the step equals 1 where x/s is an integer
    and u lies within half an ulp of x/s below 1, as the f32 sum then
    rounds up to the next integer; it cannot round past that); and
    the JAX package's own unbiasedness check, |mean(dequant - x)| <
    quantum / 10."""
    n, d = x.shape
    require(values.dtype == torch.int8 and values.shape == (n, d)
            and scales.dtype == torch.float32 and scales.shape == (n, 1),
            f"{name}: wrong output types or shapes")
    step = float((values.float() - x / scales).abs().max())
    bias = float((dequantize_int8(values, scales) - x).mean())
    quantum = float(scales.max())
    require(step <= 1.0, f"{name}: |values - x/s| = {step} > 1")
    require(abs(bias) < quantum / 10, f"{name}: biased ({bias} vs {quantum})")
    return {"max_step": step, "bias": bias, "quantum": quantum}


def check_stochastic(gen, device) -> dict:
    """quantize_int8(stochastic=True), K5, against
    quantize_int8_stochastic_plain on the same inputs at the training step's
    MLP activations and a row tail, and at the edges of the kernel's layout
    (STOCHASTIC_EDGES, rows built by ``edge_rows``: an all-zero row, rows at
    +-127 quanta and at half quanta): values and scales bitwise equal; two
    launches with one seed bitwise equal, another seed different in most
    elements of a row's fractional draws; the contract of check_quantized."""
    out = {}
    cases = [(n, d, 0, False) for n, d in QUANT_SHAPES.values()]
    cases += [(n, d, offset, True) for n, d, offset in STOCHASTIC_EDGES]
    for n, d, offset, edges in cases:
        if edges:
            rows = edge_rows(gen, (n, d), torch.float32, device)
            x = torch.cat([rows.new_zeros(offset), rows.reshape(-1)])[offset:]
            x = x.view(n, d)  # offset 1: x off its 16-byte alignment
        else:
            x = _randn(gen, (n, d), torch.float32, device) * 3.0
        vals, scales = quantize_int8(x, seed=1234, stochastic=True)
        again = quantize_int8(x, seed=1234, stochastic=True)
        other, _ = quantize_int8(x, seed=1235, stochastic=True)
        ref_vals, ref_scales = qz.quantize_int8_stochastic_plain(x, 1234)
        name = stochastic_case(n, d) + (f" offset {offset}" if offset else "")
        bitwise = torch.equal(vals, ref_vals) and torch.equal(scales, ref_scales)
        same = torch.equal(vals, again[0]) and torch.equal(scales, again[1])
        differ = float((vals != other).float().mean())
        err = max(max_abs(vals, ref_vals), max_abs(scales, ref_scales))
        contract = check_quantized(x, vals, scales, name)
        log(f"{name}: bitwise equal to the plain version {bitwise} (max|d| "
            f"{err:.3e}); two launches bitwise {same}; another seed changes "
            f"{differ:.3f} of the values; {contract}")
        require(bitwise, f"{name} disagrees with its plain version")
        require(same, f"{name} differs between launches with one seed")
        require(differ > 0.1, f"{name}: another seed gives the same values")
        out[name] = err
    return out


def gemm_case(n, k, m, dtype) -> str:
    return f"int8_gemm [{n},{k}]x[{m},{k}] {str(dtype)[6:]}"


def quantized_operands(gen, device, n, k, m):
    """x [N, K] bf16 activations and w [M, K] bf16 weights (scaled as the
    model's lecun-normal ones), and their int8 forms as int8_matmul takes
    them (deterministic quantize_int8 of the f32 values)."""
    x = _randn(gen, (n, k), torch.bfloat16, device)
    w = (_randn(gen, (m, k), torch.float32, device) * k**-0.5).to(torch.bfloat16)
    return x, w, (*quantize_int8(x), *quantize_int8(w))


def edge_rows(gen, shape, dtype, device):
    """Random rows at several scales, with rows built to hit the rounding's
    edges: x / s exactly k + 0.5 (half to even), an all-zero row (the
    1e-12 floor) and values at +-127 quanta."""
    n, d = shape
    x = _randn(gen, shape, torch.float32, device) * 3.0
    if n >= 3 and d >= 4:
        k = torch.arange(d, device=device, dtype=torch.float32) % 254 - 126
        x[0] = (k + 0.5) * 0.125  # |x / s| <= 126.5 with s = 0.125
        x[0, 0] = 127 * 0.125
        x[1] = 0.0
        x[2, : d // 2] = 127 * 0.25
        x[2, d // 2:] = -127 * 0.25
    return x.to(dtype)


def check_quantize(gen, device) -> dict:
    """quantize_int8(stochastic=False), quantize_rows_kernel, against the
    torch chain quantize_int8_plain on the same card: values and scales
    bitwise equal, and over two launches, at QUANT_ROWS_SHAPES; and the
    int8 product's one launch for x and w together, into rows padded to a
    16-byte pitch, against the chain on each with zeros past K."""
    out = {}
    for key, (shape, dtype) in QUANT_ROWS_SHAPES.items():
        x = edge_rows(gen, shape, dtype, device)
        got = finish_within(lambda: quantize_int8(x), "quantize_int8")
        again = quantize_int8(x)
        ref = qz.quantize_int8_plain(x)
        name = quantize_case(key, shape, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(max_abs(a, b) for a, b in zip(got, ref))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"{name}: bitwise equal to the torch chain {bitwise} (max|d| "
            f"{err:.3e}); two launches bitwise {same}")
        require(bitwise, f"{name} disagrees with the torch chain")
        require(same, f"{name} differs between launches")
        out[name] = err
    for n, k, m in ((16384, 1024, 4096), (4, 4096, 1024), (5, 1000, 24)):
        x = edge_rows(gen, (n, k), torch.bfloat16, device)
        w = edge_rows(gen, (m, k), torch.float32, device)
        pitch = qz._pitch(k)
        values, scales = qz._quantize_rows_kernel([x, w], pitch)
        ref = [qz.quantize_int8_plain(t) for t in (x, w)]
        ref_vals = torch.nn.functional.pad(torch.cat([ref[0][0], ref[1][0]]),
                                           (0, pitch - k))
        ok = (torch.equal(values, ref_vals)
              and torch.equal(scales, torch.cat([ref[0][1], ref[1][1]])))
        name = f"quantize_int8 x [{n},{k}] bf16 + w [{m},{k}] f32, pitch {pitch}"
        log(f"{name}: bitwise equal to the torch chain, zeros past K: {ok}")
        require(ok, f"{name} disagrees with the torch chain")
    return out


def quantize_case(key, shape, dtype) -> str:
    return f"quantize_int8 {key} [{shape[0]},{shape[1]}] {str(dtype)[6:]}"


def check_int8_gemm(gen, device, cases=None, grads=True) -> dict:
    """int8_gemm against int8_gemm_plain on the same int8 operands, f32 and
    bf16 out, bitwise and over two launches: at every N of GEMM_CHECK_N
    with each (K, M) of GEMM_CHECK_KM (``cases``: (n, k, m) triples in their
    place). At the two training shapes (with ``grads``), int8_matmul's
    gradients (straight through) against the same Function through the
    plain versions, bitwise, and its forward: one quantize launch and one
    GEMM launch, bitwise equal to the plain path."""
    out = {}
    if cases is None:
        cases = [(n, k, m) for n in GEMM_CHECK_N for k, m in GEMM_CHECK_KM]
    for n, k, m in cases:
        x, w, (xq, xs, wq, ws) = quantized_operands(gen, device, n, k, m)
        for dtype in (torch.float32, torch.bfloat16):
            got = finish_within(lambda: qz.int8_gemm(xq, xs, wq, ws, dtype),
                                "int8_gemm")
            again = qz.int8_gemm(xq, xs, wq, ws, dtype)
            ref = qz.int8_gemm_plain(xq, xs, wq, ws, dtype)
            name = gemm_case(n, k, m, dtype)
            err = max_abs(got, ref)
            bitwise, same = torch.equal(got, ref), torch.equal(got, again)
            log(f"{name}: bitwise equal to the plain version {bitwise} "
                f"(max|d| {err:.3e}, max|plain| {float(ref.float().abs().max()):.3e}); "
                f"two launches bitwise {same}")
            require(got.dtype == dtype and bitwise, f"{name} disagrees")
            require(same, f"{name} differs between launches")
            out[name] = err
        if not grads or (n, k, m) not in (GEMM_SHAPES["fc1"], GEMM_SHAPES["fc2"]):
            continue
        qz.reset_launches()
        y = qz.int8_matmul(x, w)
        launches = dict(qz.LAUNCHES)
        same = torch.equal(y, qz.int8_matmul_plain(x, w))
        log(f"int8_matmul [{n},{k}]x[{m},{k}] bf16: launches {launches}; "
            f"bitwise equal to the plain path {same}")
        require(launches["quantize_int8"] == 1 and launches["int8_gemm"] == 1,
                f"int8_matmul launched {launches}, not one quantize and one GEMM")
        require(same, "int8_matmul disagrees with the plain path")
        g = _randn(gen, (n, m), torch.float32, device)
        grads_of = {}
        for fn in (qz.int8_matmul, qz.int8_matmul_plain):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            grads_of[fn] = torch.autograd.grad((fn(xr, wr) * g).sum(), (xr, wr))
        same = all(torch.equal(a, b) for a, b in
                   zip(grads_of[qz.int8_matmul], grads_of[qz.int8_matmul_plain]))
        log(f"int8_matmul gradients [{n},{k}]x[{m},{k}] bf16 vs the plain "
            f"product's autograd: bitwise {same}")
        require(same, "int8_matmul gradients disagree with the plain version's")
    return out


def bwd_inputs(gen, shape, dtype, device, q_off=0, k_off=0, causal=True,
               tk=None):
    """q, k, v, g and the forward's lse and dsum = rowsum(g * o); k and v
    have ``tk`` rows (default: q's)."""
    b, h, t, d = shape
    q, g = (_randn(gen, shape, dtype, device) for _ in range(2))
    k, v = (_randn(gen, (b, h, tk or t, d), dtype, device) for _ in range(2))
    o, m, l = fa.flash_attention_call(q, k, v, q_off, k_off, causal, True)  # noqa: E741
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    dsum = (g.float() * o.float()).sum(dim=-1)
    return q, k, v, lse, dsum, g


def abs_bwd_products(q, k, v, lse, dsum, g, q_off, k_off, causal,
                     block_q=512):
    """Products of magnitudes in f32, over q-tiles of ``block_q`` rows in
    the pattern of the plain versions (p exactly 0 where masked): the
    backward's three products with each operand taken by its magnitude,
    |dS| |K|, |dS|^T |Q| and P^T |dO|, and the two that carry each pair's
    dot product dp = do.v by its magnitude, E |K| and E^T |Q| with E =
    scale * P o (|dO| |V|^T)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    k_pos = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
    adq, edq = torch.zeros_like(qf), torch.zeros_like(qf)
    adk, edk = torch.zeros_like(kf), torch.zeros_like(kf)
    adv = torch.zeros_like(vf)
    for q0 in range(0, q.shape[2], block_q):
        q1 = min(q0 + block_q, q.shape[2])
        qt, gt = qf[:, :, q0:q1], gf[:, :, q0:q1]
        p = torch.exp((qt @ kf.transpose(-1, -2)) * scale
                      - lse[:, :, q0:q1, None].float())
        if causal:
            q_pos = q_off + torch.arange(q0, q1, device=q.device)[:, None]
            p = torch.where(q_pos >= k_pos, p, torch.zeros_like(p))
        ds = (p * (gt @ vf.transpose(-1, -2)
                   - dsum[:, :, q0:q1, None].float()) * scale).abs()
        e = p * (gt.abs() @ vf.abs().transpose(-1, -2)) * scale
        adq[:, :, q0:q1] = ds @ kf.abs()
        edq[:, :, q0:q1] = e @ kf.abs()
        adk += ds.transpose(-1, -2) @ qt.abs()
        edk += e.transpose(-1, -2) @ qt.abs()
        adv += p.transpose(-1, -2) @ gt.abs()
    return adq, adk, adv, edq, edk


def bf16_bwd_limit(q, k, v, lse, dsum, g, q_off, k_off, causal, plain):
    """Per-element limits of |bf16 backward - plain| on (dq, dk, dv): a
    bound, not a fit, the sum of what each rounding can move.
    - Each side rounds its outputs to bf16, at most 2^-8 of the value
      each: 2^-7 |plain|.
    - The tensor-core kernels round p to bf16 before dV += P^T dO and ds
      before dK += dS^T Q and dQ += dS K, each at most 2^-8 of its
      magnitude, so a sum moves by at most 2^-8 times the same product of
      magnitudes (``abs_bwd_products``); 5% on that for the f32 sums,
      taken in another order.
    - ds = p (dp - dsum) scale cancels where dp is near dsum (a row with
      one live key has o = v and dp = dsum exactly), so the f32 rounding
      of dp, summed over D terms in another order on each side, is not
      a share of |ds|: each side's dp errs by at most D * 2^-23 of its sum
      of magnitudes (one ulp a step, for an accumulator that truncates), so
      ds by 2 D 2^-23 of E = scale p (|dO| |V|^T), and dq and dk by that
      times E |K| and E^T |Q|.
    A kernel that rounds only its outputs (f32 on the CUDA cores) lies well
    inside."""
    adq, adk, adv, edq, edk = abs_bwd_products(q, k, v, lse, dsum, g, q_off,
                                               k_off, causal)
    dp_ulps = 2 * q.shape[-1] * 2**-23
    return [2**-7 * x.float().abs() + 1.05 * 2**-8 * a + dp_ulps * e
            for x, a, e in zip(plain, (adq, adk, adv),
                               (edq, edk, torch.zeros_like(adv)))]


def limit_ratio(got, ref, limit) -> float:
    """The worst |got - ref| / limit, element by element (0 / 0 reads 0)."""
    diff = (got.float() - ref.float()).abs()
    return float((diff / torch.clamp(limit, min=1e-30)).max())


def check_bwd(q, k, v, lse, dsum, g, q_off, k_off, causal, case) -> dict:
    """flash_bwd_dq and flash_bwd_dkv (through flash_backward_blocks)
    against flash_backward_blocks_plain on the same inputs: f32 max|d| <=
    1e-4; bf16 within ``bf16_bwd_limit`` element by element, with the worst
    |d - plain| / limit logged per output beside whether the old limit,
    2e-2 * max|plain| per output, would have passed. All finite; two
    launches bitwise equal (no atomics); the first launch finished within a
    minute."""
    args = (q, k, v, lse, dsum, g, q_off, k_off, causal)
    got = finish_within(lambda: fa.flash_backward_blocks(*args),
                        f"flash_bwd {case}")
    again = fa.flash_backward_blocks(*args)
    ref = fa.flash_backward_blocks_plain(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    errs = [max_abs(a, b) for a, b in zip(got, ref)]
    out = {f"flash_bwd_dq {case}": errs[0],
           f"flash_bwd_dkv {case}": max(errs[1:])}
    if q.dtype == torch.float32:
        ok, detail = all(e <= 1e-4 for e in errs), "limit 1e-4"
    else:
        ratios = [limit_ratio(a, b, lim) for a, b, lim in
                  zip(got, ref, bf16_bwd_limit(*args, ref))]
        old_ok = all(e <= 2e-2 * float(r.float().abs().max())
                     for e, r in zip(errs, ref))
        ok = all(r <= 1.0 for r in ratios)
        detail = ("worst |d-plain| / limit dq {:.3f} dk {:.3f} dv {:.3f}; "
                  "the old limit would pass: {}").format(*ratios, old_ok)
        out[f"flash_bwd_dq {case} limit_ratio"] = ratios[0]
        out[f"flash_bwd_dkv {case} limit_ratio"] = max(ratios[1:])
    log(f"flash_bwd {case}: max|d-plain| dq {errs[0]:.3e} dk {errs[1]:.3e} "
        f"dv {errs[2]:.3e} ({detail}); finite {finite}; two launches "
        f"bitwise {same}")
    require(finite and ok, f"flash_bwd {case} disagrees")
    require(same, f"flash_bwd {case} differs between launches")
    return out


def check_backward(gen, device, bh_heads, t, d) -> dict:
    """check_bwd in f32 and bf16, causal and not, offsets 0 and nonzero."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for q_off, k_off in ((0, 0), (t // 4, t // 8)):
                args = bwd_inputs(gen, (1, bh_heads, t, d), dtype, device,
                                  q_off, k_off, causal)
                case = (f"{str(dtype)[6:]} causal={causal} "
                        f"offsets=({q_off},{k_off})")
                out.update(check_bwd(*args, q_off, k_off, causal, case))
    return out


def backward_cases(heads) -> tuple:
    """The backward's hard cases, (q shape, Tk, q_off, k_off, causal): D
    64, causal and not; T 1500, off the tiles; T 200 against Tk 136, causal
    and not; q_off < k_off, where the rows before the first key (lse =
    NEG_INF) see no key, at D 128 and 64, and a causal block wholly in the
    future of every row (a later rank's block in the ring)."""
    return (((1, heads, 2048, 64), 2048, 0, 0, True),
            ((1, heads, 512, 128), 512, 0, 512, True),
            ((1, heads, 2048, 64), 2048, 0, 0, False),
            ((1, heads, 1500, 128), 1500, 0, 0, True),
            ((1, heads, 200, 128), 136, 0, 0, False),
            ((1, heads, 200, 128), 136, 0, 0, True),
            ((1, heads, 512, 128), 512, 0, 300, True),
            ((1, heads, 512, 64), 512, 0, 300, True))


def check_backward_cases(gen, device, heads, dtype, cases=None) -> dict:
    """``cases`` (default ``backward_cases``) in ``dtype`` through
    check_bwd (its limit for the dtype, two launches bitwise); the rows
    with no live key must get dq of exactly 0."""
    out = {}
    for shape, tk, q_off, k_off, causal in cases or backward_cases(heads):
        b, h, t, d = shape
        args = bwd_inputs(gen, shape, dtype, device, q_off, k_off, causal, tk)
        case = (f"{str(dtype)[6:]} [{b},{h},{t},{d}] tk={tk} causal={causal} "
                f"offsets=({q_off},{k_off})")
        out.update(check_bwd(*args, q_off, k_off, causal, case))
        if k_off > q_off:  # rows before the first key see none
            dq, _, _ = fa.flash_backward_blocks(*args, q_off, k_off, causal)
            dead = k_off - q_off
            require(not bool(dq[:, :, :dead].float().abs().max()),
                    f"rows with no live key have nonzero dq ({case})")
    return out


def check_backward_bf16(gen, device, heads) -> dict:
    """The tensor-core backward's hard cases (``backward_cases``), bf16."""
    return check_backward_cases(gen, device, heads, torch.bfloat16)


def check_backward_f32(gen, device, heads) -> dict:
    """The CUDA-core f32 backward's hard cases (``backward_cases``): within
    1e-4 of the plain version; besides the 64-row blocks' and 64-key tiles'
    ragged edges, T 1500 and 2048 refill the staged tiles many times."""
    return check_backward_cases(gen, device, heads, torch.float32)


def check_train_shape(gen, device, heads, d) -> dict:
    """The training path's attention kernels at the shape the path gives
    them, q/k/v/do [batch, H, T, D] bf16 causal (offsets 0), against their
    plain versions on the same inputs: flash_fwd and flash_fwd_twoterm
    through check_forward, flash_bwd_dq and flash_bwd_dkv through
    check_bwd."""
    shape = (TRAIN["batch"], heads, TRAIN["seq"], d)
    q, k, v, lse, dsum, g = bwd_inputs(gen, shape, torch.bfloat16, device)
    case = f"train [{','.join(map(str, shape))}] bfloat16 causal=True"
    out = check_forward(q, k, v, 0, 0, True, True, case)
    out.update(check_bwd(q, k, v, lse, dsum, g, 0, 0, True, case))
    return out


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


def make_prompts(n, lo, hi, vocab):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, vocab, size=int(ln)).tolist() for ln in lens]


def check_model_logits(model, ref, prompt, capacity) -> dict:
    """Prefill logits and the first decode step's logits of one stream,
    through the kernels, against the same weights on the plain attention
    path (prefill of prompt + first token for the decode row)."""
    dev = model.device
    n = len(prompt)
    toks = torch.zeros((1, capacity), dtype=torch.int64, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)
    with torch.inference_mode():
        logits, kv = model(toks, return_kv=True)
        ref_logits = ref(toks)
        err_prefill = max_abs(logits[0, :n], ref_logits[0, :n])
        first = int(torch.argmax(logits[0, n - 1]))
        out = {"prefill": err_prefill}
        for int8 in (False, True):
            caches = []
            for k_h, v_h in kv:
                planes = []
                for x in (k_h, v_h):
                    cache = torch.zeros(x.shape, dtype=torch.float32, device=dev)
                    cache[:, :, :n] = x[:, :, :n].float()
                    if int8:
                        vals, scales = quantize_int8(cache.reshape(-1, x.shape[-1]))
                        planes += [vals.reshape(x.shape), scales.reshape(x.shape[:3])]
                    else:
                        planes.append(cache)
                caches.append(tuple(planes))
            step, _ = model(
                torch.tensor([[first]], device=dev), kv_caches=caches,
                kv_len=torch.tensor([n + 1], device=dev),
            )
            toks2 = toks.clone()
            toks2[0, n] = first
            ref_row = ref(toks2)[0, n]
            out["decode_int8" if int8 else "decode"] = max_abs(step[0, 0], ref_row)
    log(f"model logits vs plain attention path ({str(model.dtype)[6:]}, "
        f"prompt {n}): "
        f"prefill {out['prefill']:.3e}, first decode step {out['decode']:.3e} "
        f"(atol 5e-2); int8 cache step {out['decode_int8']:.3e} (reported)")
    require(out["prefill"] <= 5e-2 and out["decode"] <= 5e-2,
            "model logits disagree with the plain path")
    return out


@contextlib.contextmanager
def plain_int8_product():
    """Inside, ``int8_linear`` (so ``TransformerLM(quantized_mlp=True)``)
    runs its product through ``int8_matmul_plain``: the torch chain and
    ``int8_gemm_plain``, on the card."""
    saved = qz.int8_matmul
    qz.int8_matmul = qz.int8_matmul_plain
    try:
        yield
    finally:
        qz.int8_matmul = saved


def check_int8_mlp_logits(model, prompt, capacity) -> dict:
    """The int8-MLP model's prefill logits and its first decode step's
    (from an f32 cache of the prefill's K/V), through the kernels, equal
    bit for bit the same model with its products through the plain
    versions: the quantize and GEMM kernels reproduce the plain bits, and
    every other kernel is the same on both sides."""
    dev = model.device
    n = len(prompt)
    toks = torch.zeros((1, capacity), dtype=torch.int64, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)

    def run():
        logits, kv = model(toks, return_kv=True)
        first = int(torch.argmax(logits[0, n - 1]))
        caches = []
        for k_h, v_h in kv:
            planes = []
            for x in (k_h, v_h):
                cache = torch.zeros(x.shape, dtype=torch.float32, device=dev)
                cache[:, :, :n] = x[:, :, :n].float()
                planes.append(cache)
            caches.append(tuple(planes))
        step, _ = model(torch.tensor([[first]], device=dev), kv_caches=caches,
                        kv_len=torch.tensor([n + 1], device=dev))
        return logits[0, :n], step[0, 0]

    with torch.inference_mode():
        qz.reset_launches()
        got = run()
        launches = dict(qz.LAUNCHES)
        with plain_int8_product():
            ref = run()
    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    err = [max_abs(a, b) for a, b in zip(got, ref)]
    log(f"int8-MLP model logits through the kernels vs the plain products "
        f"(prompt {n}): prefill bitwise {same[0]} (max|d| {err[0]:.3e}), "
        f"first decode step bitwise {same[1]} (max|d| {err[1]:.3e}); "
        f"launches {launches}")
    require(all(same), "int8-MLP logits disagree with the plain products")
    per_pass = 2 * MODEL["num_layers"]
    require(launches["int8_gemm"] == 2 * per_pass
            and launches["quantize_int8"] == launches["int8_gemm"],
            f"int8-MLP forward passes launched {launches}")
    return {"prefill_max_abs": err[0], "decode_max_abs": err[1]}


def drain_streams(eng, sids, timeout_s: float, on_poll=None) -> dict:
    """Poll every stream to its end, as a client would; ``on_poll()`` runs
    after each round of polls. Returns each stream's tokens."""
    tokens = {sid: [] for sid in sids}
    done = set()
    deadline = time.monotonic() + timeout_s
    while len(done) < len(sids):
        require(time.monotonic() < deadline, "serving timed out")
        for sid in sids:
            if sid in done:
                continue
            res = eng.poll(sid, len(tokens[sid]))
            tokens[sid].extend(res["tokens"])
            require(not res["error"], f"stream {sid}: {res['error']}")
            if res["done"]:
                done.add(sid)
        if on_poll is not None:
            on_poll()
        time.sleep(0.005)  # a client's poll period; the engine stamps TTFT/TPOT itself
    return tokens


def serve(model, prompts, int8: bool, device, timeout_s: float = 600.0,
          engine: dict | None = None) -> dict:
    """Drive the engine (``engine``'s settings, ENGINE's by default) over
    every prompt; counts are zeroed just before and read just after."""
    engine = ENGINE if engine is None else engine
    new_tokens = engine["max_new_tokens"]
    fa.reset_launches()
    qz.reset_launches()
    with DecodeEngine(model, int8_kv=int8, device=device, **engine) as eng:
        t0 = time.perf_counter()
        sids = [eng.submit(p, new_tokens) for p in prompts]
        tokens = drain_streams(eng, sids, timeout_s)
        wall = time.perf_counter() - t0
        records = [eng.explain(sid) for sid in sids]
        stats = eng.stats()
    launches = dict(fa.LAUNCHES) | qz.LAUNCHES
    counts = [len(tokens[sid]) for sid in sids]
    require(counts == [new_tokens] * len(sids),
            f"streams did not finish with their token counts: {counts}")
    vocab = model.vocab_size
    require(all(0 <= t < vocab for toks in tokens.values() for t in toks),
            "token out of vocabulary")
    tpot = [r["steady_s"] / (r["tokens"] - 1) for r in records]
    result = {
        "cache": "int8" if int8 else "f32",
        "int8_mlp": model.quantized_mlp,
        "streams": len(sids),
        "tokens": sum(counts),
        "wall_s": wall,
        "decode_tok_s": sum(counts) / wall,
        "ttft_ms_p50": 1e3 * statistics.median(r["ttft_s"] for r in records),
        "tpot_ms_p50": 1e3 * statistics.median(tpot),
        "prefill_ms_p50": 1e3 * statistics.median(r["prefill_s"] for r in records),
        "steps": stats["steps"],
        "launches": launches,
        "tokens_by_stream": [tokens[sid] for sid in sids],
    }
    log(f"serve ({result['cache']} cache, int8 MLP {model.quantized_mlp}): "
        f"{result['tokens']} tokens in "
        f"{wall:.3f} s = {result['decode_tok_s']:.1f} tok/s, TTFT p50 "
        f"{result['ttft_ms_p50']:.2f} ms, TPOT p50 {result['tpot_ms_p50']:.2f} ms, "
        f"{stats['steps']} steps, launches {launches}")
    return result


def phase_serve(device) -> dict:
    model = TransformerLM(**MODEL, attn_impl="flash", device=device, seed=SEED)
    ref = TransformerLM(**MODEL, attn_impl="full", device=device, seed=SEED)
    ref.load_state_dict(model.state_dict())
    model.eval()
    ref.eval()
    prompts = make_prompts(N_STREAMS, *PROMPT_LENS, MODEL["vocab_size"])
    logits = check_model_logits(model, ref, prompts[0], ENGINE["capacity_tokens"])
    del ref
    runs = [serve(model, prompts, int8, device) for int8 in (False, True)]
    f32_run, int8_run = runs
    require(f32_run["launches"]["flash_fwd"] > 0, "prefill kernel never launched")
    require(f32_run["launches"]["flash_decode"] > 0, "decode kernel never launched")
    require(int8_run["launches"]["flash_fwd"] > 0, "prefill kernel never launched (int8)")
    require(int8_run["launches"]["flash_decode_int8"] > 0,
            "int8 decode kernel never launched")
    require(int8_run["launches"]["quantize_int8"] > 0,
            "the int8 cache's rows were never quantized by the kernel")
    profile = profile_serve(model, prompts, device)
    served_obs = serve_obs(model, prompts, device, f32_run)
    obs_probe = decode_obs_probe(model, device)
    # the same weights with the int8 MLP, served through the same Block
    quantized = TransformerLM(**MODEL, attn_impl="flash", quantized_mlp=True,
                              device=device, seed=SEED)
    quantized.load_state_dict(model.state_dict())
    del model
    quantized.eval()
    logits["int8_mlp_vs_plain"] = check_int8_mlp_logits(
        quantized, prompts[0], ENGINE["capacity_tokens"])
    quantized_run = serve(quantized, prompts, False, device)
    launches = quantized_run["launches"]
    require(launches["int8_gemm"] > 0,
            "the int8 MLP product never launched in serving")
    require(launches["quantize_int8"] == launches["int8_gemm"],
            f"int8 MLP serving: {launches['quantize_int8']} quantize launches "
            f"for {launches['int8_gemm']} products")
    return {"prompt_lens": [len(p) for p in prompts], "logits": logits,
            "runs": runs, "profile": profile, "obs": served_obs,
            "decode_obs_probe": obs_probe, "int8_mlp_run": quantized_run,
            "int8_mlp_profile": profile_serve(quantized, prompts, device)}


SERVE_COUNTERS = ("serve.decode.tokens", "serve.decode.prefills",
                  "serve.decode.steps")
SERVE_HISTOGRAMS = ("serve.ttft_ms", "serve.tpot_ms")


def serve_readings() -> dict:
    """The decode engine's counters, and its latency histograms' counts,
    from the process's metrics registry."""
    from raydp_tpu_torch.obs.metrics import metrics

    snap = metrics.snapshot()
    return ({name: snap.get(name, {}).get("value", 0.0)
             for name in SERVE_COUNTERS}
            | {name: snap.get(name, {}).get("count", 0)
               for name in SERVE_HISTOGRAMS})


def state_notes() -> list:
    """The decode engine's ``serve.decode.state`` notes in the flight
    recorder's log ring, oldest first."""
    from raydp_tpu_torch.obs import recorder

    return [r for r in recorder.recent_logs()
            if r["message"] == "serve.decode.state"]


def await_state_note_phase(lead_s: float = 0.9, slack_s: float = 0.05) -> None:
    """The engine notes its state at its first loop pass, then at most once
    a second: return between ``lead_s`` and ``lead_s + slack_s`` after a
    note, so the next one falls a tenth of a second or less into what is
    submitted now (a sleep that overran waits for the next note)."""
    deadline = time.monotonic() + 30.0
    seen = 0
    while True:
        require(time.monotonic() < deadline, "the engine wrote no state note")
        notes = state_notes()
        if len(notes) > seen:
            seen, ts = len(notes), notes[-1]["ts"]
            time.sleep(max(0.0, ts + lead_s - time.time()))
            if time.time() <= ts + lead_s + slack_s:
                return
        time.sleep(0.005)


def mid_decode_dossier() -> dict:
    """A crash dossier assembled from this process's rings as they stand
    (its log ring and a metrics snapshot), as the recorder would for a
    process that died now."""
    from raydp_tpu_torch.obs import recorder, tracing
    from raydp_tpu_torch.obs.metrics import metrics

    role = tracing.process_role()
    key = f"{role}:{os.getpid()}"
    flight = recorder.FlightRecorder()
    flight.note_ingest(key, role, spans=[], snapshot=metrics.snapshot(),
                       logs=recorder.recent_logs())
    return flight.assemble("chip_smoke: serving, mid-decode", victim_keys=[key])


def serve_obs(model, prompts, device, plain: dict) -> dict:
    """The f32-cache serving run again with the engine's obs in use:
    tracing on, one ``mint_context()`` per stream as its ``trace_ctx``.
    Requires the tokens and the launch counts of the same prompts served
    with obs off (``plain``, the f32 run of this phase) bitwise; the metric
    deltas (tokens 8 x 32, prefills 8, steps as ``stats()``, 8 TTFT and
    8 x 31 TPOT observations); one ``serve.decode.prefill`` span per stream
    under its root and one ``serve.decode.step`` span per round, in the
    trace ``export_trace`` writes to ``chiprun_out/serve_trace.json``; a
    ``serve.decode.state`` note taken while streams were in flight, and a
    dossier assembled then whose decode section names them and the pool's
    pages; ``explain_stream`` of each record summing to its wall within
    1%. Then the memory-pressure veto on the same engine: with
    ``max_mem_pressure`` -1 one more stream is held in the queue (vetoes
    counted, no prefill launched); set back to 0.95 it is served, its
    tokens those of the same prompt served with obs off."""
    from raydp_tpu_torch import obs
    from raydp_tpu_torch.obs import analysis, recorder, tracing

    new_tokens = ENGINE["max_new_tokens"]
    ctxs = [obs.mint_context() for _ in prompts]
    tracing.set_enabled(True)
    tracing.drain_local()
    recorder.drain_logs()
    dossier = {}

    def on_poll():
        if not dossier and any(note["fields"]["inflight"] != "{}"
                               for note in state_notes()):
            dossier.update(mid_decode_dossier())

    before = serve_readings()
    fa.reset_launches()
    qz.reset_launches()
    try:
        with DecodeEngine(model, device=device, **ENGINE) as eng:
            await_state_note_phase()
            t0 = time.perf_counter()
            sids = [eng.submit(p, new_tokens, trace_ctx=ctx)
                    for p, ctx in zip(prompts, ctxs)]
            tokens = drain_streams(eng, sids, 600.0, on_poll)
            wall = time.perf_counter() - t0
            stats = eng.stats()
            launches = dict(fa.LAUNCHES) | qz.LAUNCHES
            deltas = {k: v - before[k] for k, v in serve_readings().items()}
            records = [eng.explain(sid) for sid in sids]
            veto = check_veto(eng, prompts[0], plain["tokens_by_stream"][0])
        OUT_DIR.mkdir(exist_ok=True)
        trace_path = obs.export_trace(str(OUT_DIR / "serve_trace.json"))
    finally:
        tracing.set_enabled(False)
    require([tokens[sid] for sid in sids] == plain["tokens_by_stream"],
            "tokens served with obs on differ from obs off")
    require(launches == plain["launches"],
            f"launches with obs on {launches}, off {plain['launches']}")
    steps = stats["steps"]
    want = {"serve.decode.tokens": len(prompts) * new_tokens,
            "serve.decode.prefills": len(prompts),
            "serve.decode.steps": steps, "serve.ttft_ms": len(prompts),
            "serve.tpot_ms": len(prompts) * (new_tokens - 1)}
    require(deltas == want, f"metric deltas {deltas}, expected {want}")

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    roots = {ctx[1]: sid for ctx, sid in zip(ctxs, sids)}
    prefills = [e for e in events if e["name"] == "serve.decode.prefill"]
    step_spans = [e for e in events if e["name"] == "serve.decode.step"]
    require(sorted(e["args"]["stream"] for e in prefills) == sorted(sids)
            and all(roots.get(e["args"].get("parent_id")) == e["args"]["stream"]
                    for e in prefills),
            f"prefill spans {len(prefills)} do not pair with the streams")
    require(len(step_spans) == steps
            and all(e["args"].get("parent_id") in roots
                    and set(e["args"]["stream_spans"]) <= set(roots)
                    for e in step_spans),
            f"{len(step_spans)} step spans for {steps} rounds")

    require(bool(dossier), "no state note was taken while streams were in flight")
    (section,) = dossier.get("decode") or [None]
    require(section is not None, "the dossier has no decode section")
    fields = section["state"]["fields"]
    named = [sid for sid in sids if repr(sid) in fields["inflight"]]
    require(bool(named) and f"'total': {stats['kv_pages_total']}" in fields["pages"]
            and "serve.decode.inflight" in section["metrics"],
            f"the dossier's decode section {section}")

    gaps = []
    for rec in records:
        report = analysis.explain_stream(rec, rec)
        gaps.append(abs(sum(report["phases"].values()) - rec["wall_s"])
                    / rec["wall_s"])
    require(max(gaps) <= 0.01,
            f"explain_stream phases off their wall by {max(gaps):.2%}")
    tpot = [r["steady_s"] / (r["tokens"] - 1) for r in records]
    out = {"wall_s": wall, "steps": steps, "launches": launches,
           "metric_deltas": deltas, "prefill_spans": len(prefills),
           "step_spans": len(step_spans), "trace_events": len(events),
           "state_note_inflight": named, "explain_gap_max": max(gaps),
           "ttft_ms_p50": 1e3 * statistics.median(r["ttft_s"] for r in records),
           "tpot_ms_p50": 1e3 * statistics.median(tpot), "veto": veto}
    log(f"serve with obs on (f32 cache, tracing on, {len(sids)} sampled "
        f"streams): tokens and launches equal to obs off; {steps} steps, "
        f"metric deltas {deltas}; {len(prefills)} prefill and "
        f"{len(step_spans)} step spans in {trace_path}; a mid-decode "
        f"dossier names {named} in flight; explain_stream within "
        f"{max(gaps):.2e} of each wall; TTFT p50 {out['ttft_ms_p50']:.2f} ms, "
        f"TPOT p50 {out['tpot_ms_p50']:.2f} ms; veto {veto}")
    return out


def check_veto(eng, prompt, plain_tokens) -> dict:
    """The memory-pressure veto on the card: with ``max_mem_pressure`` -1
    a stream waits in the queue, counted, with no prefill launched; set
    back to 0.95, it is served with the tokens of the same prompt served
    before."""
    new_tokens = ENGINE["max_new_tokens"]
    prefill_launches = fa.LAUNCHES["flash_fwd"]
    eng.max_mem_pressure = -1.0
    sid = eng.submit(prompt, new_tokens)
    deadline = time.monotonic() + 30.0
    while eng.stats()["vetoes"]["mem_pressure"] < 1:
        require(time.monotonic() < deadline, "the veto never held the stream")
        time.sleep(0.005)
    held = eng.stats()
    require(held["queued"] == 1 and held["inflight"] == 0
            and fa.LAUNCHES["flash_fwd"] == prefill_launches,
            f"a vetoed stream was admitted: {held}")
    eng.max_mem_pressure = 0.95
    tokens = drain_streams(eng, [sid], 120.0)[sid]
    require(tokens == plain_tokens,
            "the stream released by the veto gave other tokens")
    return {"vetoes": held["vetoes"], "queued_while_held": held["queued"],
            "tokens": len(tokens)}


OBS_PROBE = dict(rounds=4, streams_per_arm=6, max_new_tokens=16,
                 prompt_tokens=8, prompt_seed=23)


def decode_obs_probe(model, device) -> dict:
    """bench.py's ``decode_obs_overhead_probe`` at full width: one engine
    (SLO judging on in both arms), streams submitted and drained one at a
    time, ms a token of each; 4 rounds, the arm that leads alternating,
    each arm 6 streams of 16 new tokens with tracing on (a minted context
    per stream) or off; the median of the rounds' medians. Reported, not
    gated: one machine's noise would make a gate flaky."""
    from raydp_tpu_torch.obs import tracing

    cfg = OBS_PROBE
    rng = np.random.default_rng(cfg["prompt_seed"])
    prompts = [rng.integers(0, MODEL["vocab_size"], cfg["prompt_tokens"]).tolist()
               for _ in range(8)]
    with DecodeEngine(model, device=device, ttft_slo_ms=1000.0,
                      tpot_slo_ms=1000.0, **ENGINE) as eng:

        def one_stream(idx, ctx) -> float:
            t0 = time.perf_counter()
            sid = eng.submit(prompts[idx % len(prompts)], cfg["max_new_tokens"],
                             trace_ctx=ctx)
            tokens = drain_streams(eng, [sid], 120.0)[sid]
            return 1e3 * (time.perf_counter() - t0) / len(tokens)

        def one_arm(on: bool, base: int) -> float:
            tracing.set_enabled(on)
            return statistics.median(
                one_stream(base + k, tracing.mint_context() if on else None)
                for k in range(cfg["streams_per_arm"]))

        try:
            for k in range(2):
                one_stream(k, None)  # warm
            ms = {True: [], False: []}
            for i in range(cfg["rounds"]):
                for on in ((True, False), (False, True))[i % 2]:
                    ms[on].append(one_arm(on, i * cfg["streams_per_arm"]))
        finally:
            tracing.set_enabled(False)
            tracing.drain_local()
    on_ms, off_ms = statistics.median(ms[True]), statistics.median(ms[False])
    out = {"token_ms_on": on_ms, "token_ms_off": off_ms,
           "token_ms_on_samples": ms[True], "token_ms_off_samples": ms[False],
           "overhead_frac": on_ms / off_ms - 1.0} | cfg
    log(f"decode obs probe: {on_ms:.4f} ms a token with tracing on, "
        f"{off_ms:.4f} off (rounds {ms[True]} / {ms[False]}), overhead "
        f"{out['overhead_frac']:+.4f}")
    return out


def profile_serve(model, prompts, device) -> dict:
    """One more f32-cache serving run under torch.profiler (after the
    counted runs): the device's busy share of the wall and its time by
    kernel. Reports None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = serve(model, prompts, False, device)
    out = device_share(prof, 1e3 * run["wall_s"])
    log(f"profile (f32 cache, int8 MLP {model.quantized_mlp}, profiler on): "
        f"wall {out['wall_ms']:.1f} ms, "
        f"device busy {out['device_busy_ms']} ms; port kernels "
        f"{out['port_kernel_ms']} ms; top: "
        + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in out["top_device_ms"]))
    return out


def device_ms_by_name(prof) -> dict:
    """Device milliseconds of a profiled window by kernel name. A user
    annotation (``Optimizer.step#Adam.step``) is also reported on the
    device's timeline, as a range over the kernels it launched: it is
    skipped, or those kernels would count twice."""
    by_name = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue  # host ops and annotations; kernels are events of their own
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    return by_name


def device_share(prof, wall_ms: float) -> dict:
    """The device's busy time over a profiled window of ``wall_ms`` and its
    time by kernel; None where the profiler saw no device time."""
    by_name = device_ms_by_name(prof)
    busy_ms = sum(by_name.values())
    port = {}
    for name, ms in by_name.items():
        found = port_kernel_pattern().match(name)
        if found:
            port[found.group(1)] = port.get(found.group(1), 0.0) + ms
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if by_name else None,
        "device_busy_share": busy_ms / wall_ms if by_name else None,
        "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        "port_kernel_ms": port,
    }


def profiled(step, device) -> dict | None:
    """``device_share`` of one call of ``step`` (which ends in a host
    read); None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return device_share(prof, wall_ms)


# ---------------------------------------------------------------------------
# phase_cluster: a card actor of the port's cluster runtime
# ---------------------------------------------------------------------------

# the cluster of phase_cluster: 4 CPUs and the card as the custom resource
# "GPU"; the card actor may be restarted once, so its second SIGKILL is a
# terminal death
CLUSTER = dict(num_cpus=4, resources={"GPU": 1.0})
CLUSTER_LIMIT_S = 60.0  # the whole phase
CLUSTER_DEADLINE_S = 10.0  # dossier, memory back, no process after shutdown
CARD_MEMORY_SLACK = 256 << 20
SHIP_EVERY_S = 0.05  # the card actor ships its telemetry while it serves


# what phase_cluster's summary line prints (the record holds more)
CLUSTER_KEYS = ("init_s", "zygote_warm_s", "spawn_to_ready_s", "actor_init_s",
                "ttft_ms_first", "ttft_ms_p50", "killed_at_tokens",
                "recover_s", "restart_init_s", "dossier_s", "memory_back_s",
                "head_tokens", "probe_exit_leaks", "driver_exit_leaks",
                "shutdown_s", "gone_after_shutdown_s", "phase_s")


class CardServer:
    """The card actor of ``phase_cluster``: a user class that serves the
    full-width ``TransformerLM`` through ``DecodeEngine``, spawned through
    ``cluster.spawn`` and forked from the zygote. ``__init__`` runs on the
    worker's main thread and the methods on its pool's threads, so each
    names the device itself and holds no stream object; every method
    returns host data only. The weights come from ``seed`` through the
    model's CPU generator, so they equal those of the driver's
    ``phase_serve`` with nothing shipped."""

    def __init__(self, model_cfg: dict, engine_cfg: dict, device: str, seed: int):
        from raydp_tpu_torch import obs

        t0 = time.perf_counter()
        # the flush every process makes (its memory sampler included),
        # before the card is touched: it must leave the CUDA driver alone
        obs.flush()
        self.cuda_untouched_after_flush = not torch.cuda.is_initialized()
        t1 = time.perf_counter()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets them
            torch.backends.cudnn.allow_tf32 = False
            torch.zeros(1, device=self.device)  # the CUDA context
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.model = TransformerLM(**model_cfg, attn_impl="flash",
                                   device=self.device, seed=seed).eval()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.engine_cfg = dict(engine_cfg)
        self.init_s = {"flush": t1 - t0, "cuda_context": t2 - t1,
                       "model": time.perf_counter() - t2}

    def info(self) -> dict:
        return {"pid": os.getpid(), "init_s": self.init_s,
                "cuda_untouched_after_flush": self.cuda_untouched_after_flush}

    def serve(self, prompts: list) -> dict:
        """Serve ``prompts`` as ``serve()`` does in the driver, each stream
        with a minted trace context; launch counts zeroed just before and
        read just after. Ships telemetry every ``SHIP_EVERY_S`` while it
        polls, and once more at the end."""
        from raydp_tpu_torch import obs

        new_tokens = self.engine_cfg["max_new_tokens"]
        fa.reset_launches()
        qz.reset_launches()
        with DecodeEngine(self.model, device=self.device, **self.engine_cfg) as eng:
            submit_unix = time.time()
            sids = [eng.submit(p, new_tokens, trace_ctx=obs.mint_context())
                    for p in prompts]
            tokens = drain_streams(
                eng, sids, 600.0,
                on_poll=lambda: obs.flush_throttled(SHIP_EVERY_S))
            records = [eng.explain(sid) for sid in sids]
        launches = dict(fa.LAUNCHES) | qz.LAUNCHES
        obs.flush()
        return {"pid": os.getpid(), "tokens": [tokens[sid] for sid in sids],
                "launches": launches, "submit_unix": submit_unix,
                "ttft_s": [r["ttft_s"] for r in records]}


class CardProbe:
    """A card actor that exits gracefully: its exit audits its resources
    against the baseline the worker took before ``__init__`` and ships the
    ``sanitize.leaked_*`` gauges to the head."""

    def __init__(self, device: str):
        self.block = torch.ones(1 << 20, device=torch.device(device))

    def touch(self) -> dict:
        return {"pid": os.getpid(), "sum": float(self.block.sum())}


def _wait_for(predicate, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value:
            return value
        require(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.01)


def _zygote_serves(session: str) -> bool:
    """Whether the session-local zygote accepts forks (its warm-up done)."""
    import socket

    from raydp_tpu_torch.cluster.zygote import zygote_sock_path

    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.connect(zygote_sock_path(session))
        return True
    except OSError:
        return False
    finally:
        probe.close()


def _session_procs(session: str) -> list:
    """Processes other than this one whose command line names ``session``:
    the head, the session-local zygote and every child it forked (a forked
    child keeps the zygote's command line)."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                if session.encode() in f.read():
                    found.append(int(entry))
        except OSError:
            continue
    return found


def _series_last(query_metrics, proc_key: str) -> float:
    """The newest shipped value of ``serve.decode.tokens`` of one process on
    the head (0 before its first ship)."""
    for entry in query_metrics("serve.decode.tokens", window_s=600.0):
        if entry["labels"].get("proc") == proc_key:
            return float(entry["last"])
    return 0.0


def _find_dossier(session: str, actor_id: str):
    for path in sorted(Path(session, "dossiers").glob("dossier-*.json")):
        dossier = json.loads(path.read_text())
        if (dossier["victim"].get("actor_id") == actor_id
                and dossier["reason"] == "actor_crashed"):
            return dossier
    return None


def _prefill_spans_by_track(trace: dict, actor_id: str) -> dict:
    """``{"worker:<actor_id> (pid N)": count}`` of ``serve.decode.prefill``
    spans in an exported trace."""
    tracks = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    counts: dict = {}
    for event in trace["traceEvents"]:
        name = tracks.get(event["pid"], "")
        if (event["name"] == "serve.decode.prefill"
                and name.startswith(f"worker:{actor_id} ")):
            counts[name] = counts.get(name, 0) + 1
    return counts


def phase_cluster(device, served: dict, model_cfg: dict = MODEL,
                  engine_cfg: dict = ENGINE, prompts=None,
                  out_dir: Path = OUT_DIR) -> dict:
    """Serve the full-width model from a card actor of the port's cluster
    and hold it to ``served`` (phase_serve's f32-cache run: its tokens and
    its launch counts) through a SIGKILL, a restart and a terminal death:

    1. the free device memory before the cluster;
    2. ``cluster.init`` (4 CPUs, the card as ``GPU``) with the zygote's
       torch warm set on and a session-local zygote, and lockdep and the
       leak audit armed in every process; the zygote's warm-up;
    3. ``CardServer`` spawned with ``resources={"GPU": 1}``,
       ``max_restarts=1``, ``light=True`` (forked from the zygote) and
       tracing on: its tokens equal ``served``'s bit for bit and its
       ``flash_fwd`` (K2a) and ``flash_decode`` (K4a) launches, counted in
       the actor, equal the in-process run's (every count of the run, in
       fact);
    4. a second ``serve.remote``, SIGKILLed once the head's series of the
       actor's ``serve.decode.tokens`` shows the serve under way (above its
       value before the serve, below that plus the serve's tokens): the call
       raises, the head's record turns ALIVE at incarnation 1, and then the
       actor, with ``restarts_used`` 1, serves the same tokens bit for bit;
    5. a second SIGKILL, past ``max_restarts``: within 10 s a dossier with
       reason ``actor_crashed`` names the actor, with a decode section from
       the victim's shipped ``serve.decode.state`` notes and the lock-order
       graph;
    6. the head's view: ``dump_metrics`` holds the actor's
       ``serve.decode.tokens`` of both incarnations, ``export_trace``
       (``cluster_trace.json``) its ``serve.decode.prefill`` spans under
       ``worker:<actor_id>``, a scrape the ``serve_decode_tokens`` series;
    7. within 10 s of the terminal death the free device memory is back
       within 256 MiB of step 1;
    8. a ``CardProbe`` actor that touches the card and exits gracefully
       (``mark_intentional_exit``, then ``__shutdown__``): its leak gauges;
    9. ``cluster.shutdown()``: within 10 s no process of the session is
       alive (head, zygote, workers), and the driver's own leak gauges.

    The whole phase takes at most 60 s. Returns the record, with init to
    head ready, the zygote's warm-up, spawn to ready (the fork, the CUDA
    context, the model), TTFT of the first serve and the kill to the
    restarted actor's first token (time to recover)."""
    from raydp_tpu_torch import cluster
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import ClusterError, _probe_pid, rpc
    from raydp_tpu_torch.cluster.zygote import (WARM_TORCH_ENV,
                                                zygote_marker_path)
    from raydp_tpu_torch.obs import timeseries
    from raydp_tpu_torch.obs.metrics import metrics

    # the actor classes by reference: the worker imports this file as the
    # module chip_smoke (its directory is on the actors' PYTHONPATH). Run as
    # a script, this file is __main__, whose classes cloudpickle would carry
    # by value, and with them torch.backends' module objects, which it
    # cannot pickle
    here = importlib.import_module("chip_smoke")
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    if prompts is None:
        prompts = make_prompts(N_STREAMS, *PROMPT_LENS, model_cfg["vocab_size"])
    per_serve = len(prompts) * engine_cfg["max_new_tokens"]
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", WARM_TORCH_ENV: "1",
             "RAYDP_TPU_SANITIZE": "lockdep,leaks"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    rec: dict = {"streams": len(prompts), "tokens_per_serve": per_serve}

    def same_as_served(run: dict, what: str) -> None:
        require(run["tokens"] == served["tokens_by_stream"],
                f"{what}: the card actor's tokens differ from phase_serve's")
        require(run["launches"] == served["launches"],
                f"{what}: launches {run['launches']} in the actor, "
                f"{served['launches']} in the driver")
        if cuda:
            require(run["launches"]["flash_fwd"] > 0
                    and run["launches"]["flash_decode"] > 0,
                    f"{what}: K2a or K4a never launched in the actor")

    try:
        mem_base = torch.cuda.mem_get_info(device)[0] if cuda else None
        t0 = time.perf_counter()
        session = cluster.init(**CLUSTER)
        rec["init_s"] = time.perf_counter() - t0

        _wait_for(lambda: _zygote_serves(session), 30.0, "the zygote's warm-up")
        rec["zygote_warm_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        actor = cluster.spawn(
            here.CardServer, model_cfg, engine_cfg, str(device), SEED,
            name="card-server", resources={"GPU": 1}, max_restarts=1,
            light=True, env={"RAYDP_TPU_TRACE": "1"})
        rec["spawn_to_ready_s"] = time.perf_counter() - t1
        info0 = actor.info()
        rec["actor_init_s"] = info0["init_s"]
        require(info0["cuda_untouched_after_flush"],
                "the zygote-forked actor's flush initialised CUDA")
        first = actor.serve(prompts)
        same_as_served(first, "first serve")
        rec["launches"] = first["launches"]
        rec["ttft_ms_first"] = 1e3 * min(first["ttft_s"])
        rec["ttft_ms_p50"] = 1e3 * statistics.median(first["ttft_s"])
        log(f"cluster: init {rec['init_s']:.3f} s, zygote warm "
            f"{rec['zygote_warm_s']:.3f} s, spawn to ready "
            f"{rec['spawn_to_ready_s']:.3f} s ({info0['init_s']}), TTFT "
            f"first {rec['ttft_ms_first']:.2f} ms, p50 {rec['ttft_ms_p50']:.2f} "
            f"ms, launches {first['launches']}")

        # 4. SIGKILL mid-serve, restart, the same tokens again
        key0 = f"worker:{actor.actor_id}:{info0['pid']}"
        base = _series_last(capi.query_metrics, key0)
        require(base == per_serve, f"{key0} shipped {base} tokens, not {per_serve}")
        future = actor.serve.remote(prompts)
        # the first half of the serve: the kill lands well before its end
        seen = _wait_for(
            lambda: (lambda v: v if base < v <= base + per_serve // 2 else 0.0)(
                _series_last(capi.query_metrics, key0)),
            60.0, "the head to see the second serve under way")
        t_kill = time.time()
        os.kill(info0["pid"], signal.SIGKILL)
        try:
            future.result(timeout=60)
        except (ConnectionError, OSError, ClusterError) as exc:
            rec["in_flight_error"] = type(exc).__name__
        else:
            raise SmokeFailure("the call in flight returned from a SIGKILLed actor")
        rec["killed_at_tokens"] = seen - base
        # the next call waits for the head's record of the restarted
        # incarnation: a call made while the killed process is still closing
        # its sockets can land in its listener's backlog and be reset, by the
        # JAX package's handle as by the port's. The wait counts in recover_s
        _wait_for(lambda: (lambda r: r is not None and r.incarnation == 1
                           and r.state == cluster.ActorState.ALIVE)(
                               actor._record()),
                  60.0, "the restarted incarnation's record")
        second = actor.serve(prompts)
        rec["recover_s"] = second["submit_unix"] + min(second["ttft_s"]) - t_kill
        same_as_served(second, "after the restart")
        record1 = actor._record()
        require(record1.state == cluster.ActorState.ALIVE
                and record1.incarnation == 1 and record1.restarts_used == 1,
                f"the restarted actor's record: {record1}")
        info1 = actor.info()
        rec["restart_init_s"] = info1["init_s"]
        key1 = f"worker:{actor.actor_id}:{info1['pid']}"
        log(f"cluster: killed at {rec['killed_at_tokens']:.0f} of {per_serve} "
            f"tokens ({rec['in_flight_error']}), back at incarnation 1, "
            f"kill to first token {rec['recover_s']:.3f} s")

        # 5. the terminal death and its dossier
        t_death = time.time()
        os.kill(info1["pid"], signal.SIGKILL)
        dossier = _wait_for(lambda: _find_dossier(session, actor.actor_id),
                            CLUSTER_DEADLINE_S, "the crash dossier")
        rec["dossier_s"] = time.time() - t_death
        require(actor.state() == cluster.ActorState.DEAD, "the actor is not DEAD")
        decode = [s for s in dossier.get("decode", []) if s["proc"] == key1]
        require(bool(decode) and decode[0]["state"] is not None,
                f"the dossier has no decode section of {key1}")
        require(isinstance(dossier.get("lock_order_graph"), list),
                "the dossier has no lock-order graph")
        rec["dossier"] = {
            "keys": sorted(dossier), "rings": [r["proc"] for r in dossier["victim_rings"]],
            "decode_state": decode[0]["state"]["fields"],
            "lock_order_edges": len(dossier["lock_order_graph"])}

        # 7. the card's memory back (read before the head's view: it bounds
        # the time since the death)
        if cuda:
            rec["memory_back_s"] = _wait_for(
                lambda: (time.time() - t_death) if torch.cuda.mem_get_info(
                    device)[0] >= mem_base - CARD_MEMORY_SLACK else 0.0,
                CLUSTER_DEADLINE_S, "the dead actor's device memory")
            rec["memory_free_delta_bytes"] = (
                torch.cuda.mem_get_info(device)[0] - mem_base)
        else:  # no card: nothing to give back
            rec["memory_back_s"] = rec["memory_free_delta_bytes"] = None
        require(time.time() - t_death <= CLUSTER_DEADLINE_S + 1.0,
                "the dossier and the memory took past the deadline")

        # 6. the head's view
        merged = cluster.dump_metrics()
        by_incarnation = {key: merged[key]["serve.decode.tokens"]["value"]
                          for key in (key0, key1)}
        require(by_incarnation[key1] == per_serve
                and base < by_incarnation[key0] < base + per_serve,
                f"serve.decode.tokens on the head: {by_incarnation}")
        rec["head_tokens"] = by_incarnation | {"sum": sum(by_incarnation.values())}
        out_dir.mkdir(exist_ok=True)
        trace = json.loads(Path(cluster.export_trace(
            str(out_dir / "cluster_trace.json"))).read_text())
        prefills = _prefill_spans_by_track(trace, actor.actor_id)
        require(prefills.get(f"worker:{actor.actor_id} (pid {info1['pid']})")
                == len(prompts) and sum(prefills.values()) >= 2 * len(prompts),
                f"prefill spans under the actor's tracks: {prefills}")
        rec["prefill_spans"] = prefills
        cluster.head_rpc("obs_configure", scrape_port=0)
        parsed = timeseries.parse_prometheus_text(
            timeseries.scrape(*capi.scrape_addr()))
        scraped = parsed.get("raydp_serve_decode_tokens_total", {})
        require(any(("proc", key1) in labels for labels in scraped),
                f"the scrape has no serve_decode_tokens series of {key1}")
        rec["scrape_series"] = len(scraped)

        # 8. a graceful exit of a card actor
        probe = cluster.spawn(here.CardProbe, str(device), name="card-probe",
                              resources={"GPU": 1}, light=True)
        probe_pid = probe.touch()["pid"]
        cluster.head_rpc("mark_intentional_exit", actor_id=probe.actor_id)
        rpc(probe._record().sock_path, ("__shutdown__", (), {}, False),
            timeout=10)
        _wait_for(lambda: _probe_pid(probe_pid) != "alive", CLUSTER_DEADLINE_S,
                  "the probe's graceful exit")
        probe_key = f"worker:{probe.actor_id}:{probe_pid}"
        rec["probe_exit_leaks"] = {
            name: snap["value"]
            for name, snap in cluster.dump_metrics()[probe_key].items()
            if name.startswith("sanitize.")}

        # 9. shutdown: no process of the session outlives it
        pids = {"head": capi._head_proc.pid,
                "zygote": int(Path(zygote_marker_path(session)).read_text()),
                "incarnation0": info0["pid"], "incarnation1": info1["pid"],
                "probe": probe_pid}
        t2 = time.perf_counter()
        cluster.shutdown()
        rec["shutdown_s"] = time.perf_counter() - t2
        _wait_for(lambda: not any(_probe_pid(p) == "alive" for p in pids.values())
                  and not _session_procs(session), CLUSTER_DEADLINE_S,
                  f"the session's processes {pids} to exit")
        rec["gone_after_shutdown_s"] = time.perf_counter() - t2
        rec["driver_exit_leaks"] = {
            name: snap["value"] for name, snap in metrics.snapshot().items()
            if name.startswith("sanitize.")}
    finally:
        if capi.is_initialized():
            cluster.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["phase_s"] = time.perf_counter() - t_phase
    require(rec["phase_s"] <= CLUSTER_LIMIT_S,
            f"phase_cluster took {rec['phase_s']:.1f} s")
    log(f"cluster: dossier after {rec['dossier_s']:.3f} s, memory back after "
        f"{rec['memory_back_s']} s, head tokens {rec['head_tokens']}, "
        f"probe exit leaks {rec['probe_exit_leaks']}, driver exit leaks "
        f"{rec['driver_exit_leaks']}, shutdown {rec['shutdown_s']:.3f} s, "
        f"phase {rec['phase_s']:.1f} s")
    return rec


def train_tokens(batch, t, vocab, device):
    """bench.py's tokens: default_rng(17) draws [batch, t + 1]; inputs are
    the first t, targets the last t."""
    rng = np.random.default_rng(TRAIN["token_seed"])
    tok = rng.integers(0, vocab, (batch, t + 1), dtype=np.int32)
    tok = torch.from_numpy(tok).to(device=device, dtype=torch.int64)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def lm(attn_impl, device, max_len, **kw):
    return TransformerLM(**MODEL, max_len=max_len, attn_impl=attn_impl,
                         device=device, seed=SEED, **kw)


def lm_loss(model, tokens, targets):
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def train_step(model, opt, tokens, targets):
    """bench.py's step: forward, mean cross-entropy, backward, Adam."""
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, targets)
    loss.backward()
    opt.step()
    return loss.detach()


def loss_and_grads(model, tokens, targets):
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, targets)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def grad_gap(grads, ref) -> tuple:
    """(worst per-tensor ||g - ref|| / ||ref||, whether all are bitwise)."""
    worst = max(float((grads[n].float() - g.float()).norm()
                      / g.float().norm().clamp_min(1e-30)) for n, g in ref.items())
    return worst, all(torch.equal(grads[n], g) for n, g in ref.items())


def timed_steps(model, opt, tokens, targets, steps):
    """One warm step, then ``steps`` timed steps fenced by loss.item(), as
    bench.py fences them. Returns (first loss, losses, seconds)."""
    first = train_step(model, opt, tokens, targets).item()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, tokens, targets) for _ in range(steps)]
    losses[-1].item()
    return first, [float(x) for x in losses], time.perf_counter() - t0


def phase_train(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    vocab = MODEL["vocab_size"]
    tokens, targets = train_tokens(b, t, vocab, device)
    model = lm("flash", device, t + 1)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    fa.reset_launches()
    first, losses, dt = timed_steps(model, opt, tokens, targets, steps)
    launches = dict(fa.LAUNCHES)
    per_step = {n: launches[n] / (steps + 1) for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"train: loss {first:.4f} (warm step) -> {losses[-1]:.4f} after "
        f"{steps} more; launches per step {per_step}")
    require(all(math.isfinite(x) for x in [first, *losses]), "loss not finite")
    require(losses[-1] < first, "loss did not fall")
    require(all(n == MODEL["num_layers"] for n in per_step.values()),
            f"launches per step {per_step}, expected {MODEL['num_layers']} each")
    flops = lm_train_flops_per_step(b, t, MODEL["d_model"], MODEL["num_layers"],
                                    vocab)
    tok_s = steps * b * t / dt
    out = {
        "shape": f"batch {b}, T {t}, bf16, {MODEL}",
        "first_loss": first, "losses": losses, "launches": launches,
        "tokens_s": tok_s, "step_ms": 1e3 * dt / steps,
        "flops_per_step": flops,
        "mfu": tok_s * flops / (b * t) / PEAK_OPS_S["bf16"],
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens, targets).item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)
    del model, opt

    skip = lm("skip", device, t + 1)
    _, _, skip_dt = timed_steps(
        skip, torch.optim.Adam(skip.parameters(), lr=TRAIN["lr"]), tokens,
        targets, 3)
    del skip
    out["skip_step_ms"] = 1e3 * skip_dt / 3
    out["attention_share"] = 1 - out["skip_step_ms"] / out["step_ms"]
    out["skip_mfu"] = lm_nonattn_flops_per_step(
        b, t, MODEL["d_model"], MODEL["num_layers"], vocab
    ) / (out["skip_step_ms"] / 1e3) / PEAK_OPS_S["bf16"]
    prof_out = out["profile"]
    log(f"train: {tok_s:.1f} tokens/s, step {out['step_ms']:.2f} ms, MFU "
        f"{out['mfu']:.4f} (bf16 peak 989 TFLOP/s); without attention "
        f"{out['skip_step_ms']:.2f} ms, MFU {out['skip_mfu']:.4f} (attention "
        f"{out['attention_share']:.3f} of the step); profiled step: wall "
        f"{prof_out['wall_ms']:.1f} ms, "
        f"device busy {prof_out['device_busy_ms']} ms; port kernels "
        f"{prof_out['port_kernel_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"]))
    out["twoterm_step"] = twoterm_step(device, tokens, targets, t + 1)
    out["remat"] = remat_memory(device, tokens, targets, t + 1)
    out["grad_check"] = grad_check(device, t + 1)
    return out


def phase_train_f32(device) -> dict:
    """The full-width LM in f32, ``TransformerLM(**MODEL, dtype=float32,
    attn_impl="flash")``, at TRAIN_F32's batch 1 and T 2048. First, from
    the same seeded weights, one step's loss and gradients against
    ``attn_impl="full"`` at tests/test_torch_training.py's f32 tolerances:
    loss rtol 1e-6, per tensor ||g - g_full|| / ||g_full|| <= 1e-4. Then a
    warm step and TRAIN_F32["steps"] timed steps with Adam, as phase_train
    runs them, the counts zeroed just before and read just after: the f32
    bodies (``flash_fwd_f32``; ``flash_bwd_dq`` and ``flash_bwd_dkv``, which
    run ``csrc/flash_backward.cu`` for f32) launch once a layer a step; the
    loss is finite and falls. Step ms, and one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    b, t, steps = TRAIN_F32["batch"], TRAIN_F32["seq"], TRAIN_F32["steps"]
    vocab = MODEL["vocab_size"]
    tokens, targets = train_tokens(b, t, vocab, device)
    full = lm("full", device, t + 1, dtype=torch.float32)
    ref_loss, ref_grads = loss_and_grads(full, tokens, targets)
    del full
    model = lm("flash", device, t + 1, dtype=torch.float32)
    loss, grads = loss_and_grads(model, tokens, targets)
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    log(f"train f32 (batch {b}, T {t}) vs attn_impl='full': loss rel "
        f"{loss_rel:.3e} (limit 1e-6), worst grad rel {worst:.3e} (limit 1e-4)")
    require(loss_rel <= 1e-6 and worst <= 1e-4,
            "the f32 step's loss or gradients disagree with the plain path")
    del grads, ref_grads
    model.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    fa.reset_launches()
    first, losses, dt = timed_steps(model, opt, tokens, targets, steps)
    launches = dict(fa.LAUNCHES)
    per_step = {n: launches[n] / (steps + 1) for n in
                ("flash_fwd_f32", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"train f32: loss {first:.4f} (warm step) -> {losses[-1]:.4f} after "
        f"{steps} more; launches per step {per_step}")
    require(all(math.isfinite(x) for x in [first, *losses]), "f32 loss not finite")
    require(losses[-1] < first, "the f32 loss did not fall")
    require(all(n == MODEL["num_layers"] for n in per_step.values()),
            f"f32 launches per step {per_step}, expected {MODEL['num_layers']} each")
    out = {
        "shape": f"batch {b}, T {t}, f32, {MODEL}",
        "loss_rel": loss_rel, "worst_grad_rel": worst,
        "first_loss": first, "losses": losses, "launches": launches,
        "step_ms": 1e3 * dt / steps, "tokens_s": steps * b * t / dt,
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens, targets).item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)
    prof_out = out["profile"]
    log(f"train f32: step {out['step_ms']:.2f} ms, {out['tokens_s']:.1f} "
        f"tokens/s; profiled step: wall {prof_out['wall_ms']:.1f} ms, device "
        f"busy {prof_out['device_busy_ms']} ms; port kernels "
        f"{prof_out['port_kernel_ms']} ms")
    del model, opt
    return out


# ---------------------------------------------------------------------------
# phase_small_lm: the JAX package's small LMs at their own width on the card
# ---------------------------------------------------------------------------

# raydp_tpu_torch/chaos.py's DECODE_LM (tools/chaos.py's and
# tools/trace_smoke.py's width: vocab 64, d_model 32, 2 heads of 16, 2 layers)
# and its 4-head variant, D 8 (tests/test_models_parallel.py runs
# attn_impl="flash" at d_model 32 over 4 heads); keyed by head count
SMALL_LM_HEADS = (2, 4)
# training: tests/test_torch_training.py's batch, T 128 (the JAX flash test's
# length), 3 Adam steps at bench.py's 3e-4; serving: the chaos decode
# scenario's engine (capacity 128, pages of 32, 4 slots) and streams (4
# prompts of 3-9 tokens, 12 new tokens each)
SMALL_LM = dict(batch=2, seq=128, steps=3, lr=3e-4, streams=4, max_new=12,
                capacity=128, page=32, prompt_seed=29)
# flash against attn_impl="full" from the same weights: f32 at
# phase_train_f32's bounds; bf16 at grad_check's (each side rounds its
# activations to bf16, the flash kernels p and ds too)
SMALL_LM_LIMITS = {torch.float32: (1e-6, 1e-4), torch.bfloat16: (5e-2, 5e-2)}
SMALL_LM_LIMIT_S = 240.0  # the whole phase


def small_lm_config(heads: int) -> dict:
    from raydp_tpu_torch import chaos

    return dict(chaos.DECODE_LM, num_heads=heads)


def small_lm_train(device, cfg: dict, dtype) -> dict:
    """One step's loss and gradients with ``attn_impl="flash"`` against
    ``attn_impl="full"`` from the same seeded weights (``SMALL_LM_LIMITS``:
    loss relative, worst per-tensor gradient relative), then
    ``SMALL_LM["steps"]`` Adam steps with flash, the counts zeroed just
    before and read just after: the forward and both backward kernels
    launch once a layer a step on the card, never on the CPU."""
    b, t = SMALL_LM["batch"], SMALL_LM["seq"]
    tokens, targets = train_tokens(b, t, cfg["vocab_size"], device)

    def model(impl):
        return TransformerLM(**cfg, attn_impl=impl, dtype=dtype, device=device,
                             seed=SEED)

    ref_loss, ref_grads = loss_and_grads(model("full"), tokens, targets)
    flash = model("flash")
    loss, grads = loss_and_grads(flash, tokens, targets)
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    loss_limit, grad_limit = SMALL_LM_LIMITS[dtype]
    flash.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(flash.parameters(), lr=SMALL_LM["lr"])
    fa.reset_launches()
    losses = [train_step(flash, opt, tokens, targets)
              for _ in range(SMALL_LM["steps"])]
    losses = [float(x) for x in losses]
    launches = dict(fa.LAUNCHES)
    kind = str(dtype)[6:]
    fwd = "flash_fwd_f32" if dtype == torch.float32 else "flash_fwd"
    want = cfg["num_layers"] * SMALL_LM["steps"] if device.type == "cuda" else 0
    per_run = {n: launches[n] for n in (fwd, "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"small LM D{cfg['d_model'] // cfg['num_heads']} {kind}: flash vs "
        f"full loss rel {loss_rel:.3e} (limit {loss_limit}), worst grad rel "
        f"{worst:.3e} (limit {grad_limit}); {SMALL_LM['steps']} Adam steps "
        f"{losses}; launches {per_run}")
    require(loss_rel <= loss_limit and worst <= grad_limit,
            f"the small LM's {kind} flash step disagrees with attn_impl='full'")
    require(all(math.isfinite(x) for x in losses), "small LM loss not finite")
    require(all(n == want for n in per_run.values()),
            f"small LM {kind} launches {per_run}, expected {want} each")
    # by the kernels line's names: the f32 backward pair is its own entry
    suffix = "_f32" if dtype == torch.float32 else ""
    return {"loss_rel": loss_rel, "worst_grad_rel": worst, "losses": losses,
            "launches": {n + (suffix if n.startswith("flash_bwd") else ""): k
                         for n, k in launches.items() if k}}


def small_lm_serve(device, cfg: dict, workdir: Path) -> dict:
    """Decode serving of the LM through ``serve.deploy`` (one replica,
    ``serve.decode.enabled``): the f32 model on an int8 cache
    (``serve.decode.int8_kv``) and the bf16 model (on the engine's f32
    cache, as in the JAX package), each stream to its whole token budget;
    the replicas' ``ops.launches.*`` gauges, read from the head before the
    deployment closes (K4b in the first, K4a in the second: > 0 on the
    card, 0 on the CPU). The f32 model's tokens from a ``DecodeEngine`` in
    this process are the reference the int8 tokens are counted against
    (reported, not gated: an int8 cache changes the logits)."""
    from raydp_tpu_torch import serve
    from raydp_tpu_torch.estimator import checkpoint as ckpt

    vocab, max_new = cfg["vocab_size"], SMALL_LM["max_new"]
    rng = np.random.default_rng(SMALL_LM["prompt_seed"])
    prompts = [[int(x) for x in rng.integers(0, vocab, rng.integers(3, 10))]
               for _ in range(SMALL_LM["streams"])]
    engine = dict(capacity_tokens=SMALL_LM["capacity"],
                  page_tokens=SMALL_LM["page"], max_seqs=SMALL_LM["streams"],
                  max_new_tokens=max_new)
    conf = {"serve.decode.enabled": True,
            "serve.decode.capacity_tokens": SMALL_LM["capacity"],
            "serve.decode.page_tokens": SMALL_LM["page"],
            "serve.decode.max_seqs": SMALL_LM["streams"],
            "serve.decode.max_new_tokens": max_new}
    head_dim = cfg["d_model"] // cfg["num_heads"]
    on_card = device.type == "cuda"
    with DecodeEngine(TransformerLM(**cfg, attn_impl="flash",
                                    dtype=torch.float32, device=device,
                                    seed=SEED),
                      device=device, **engine) as eng:
        sids = [eng.submit(p, max_new) for p in prompts]
        reference = drain_streams(eng, sids, 120.0)
        reference = [reference[sid] for sid in sids]
    out = {"prompts": prompts, "f32_engine_tokens": reference}
    for leg, dtype, int8, kernel in (("int8", torch.float32, True, "flash_decode_int8"),
                                     ("bf16", torch.bfloat16, False, "flash_decode")):
        model = functools.partial(TransformerLM, **cfg, attn_impl="flash",
                                  dtype=dtype, seed=SEED)
        directory = workdir / f"D{head_dim}-{leg}"
        weights = model(device="cpu")
        ckpt.save_checkpoint(str(directory), 0, None, weights,
                             torch.optim.Adam(weights.parameters()))
        t0 = time.perf_counter()
        dep = serve.deploy(model=model, checkpoint_dir=str(directory),
                           replicas=1, device=device,
                           conf=conf | {"serve.decode.int8_kv": int8})
        try:
            tokens = [list(dep.stream(p, max_new, timeout=120)) for p in prompts]
            launches = {}
            for counts in _replica_launches(dep).values():
                _add_launches(launches, counts)
        finally:
            dep.close()
        counts = [len(x) for x in tokens]
        row = {"seconds": time.perf_counter() - t0, "tokens": tokens,
               "launches": {n: k for n, k in launches.items() if k}}
        if int8:
            row["tokens_as_f32"] = sum(a == b for got, ref in zip(tokens, reference)
                                       for a, b in zip(got, ref))
        log(f"small LM D{head_dim} serving, {leg}: {row['seconds']:.2f} s, "
            f"tokens a stream {counts}, replica launches {row['launches']}"
            + (f", {row['tokens_as_f32']} of {sum(counts)} tokens as the f32 "
               "engine's" if int8 else ""))
        require(counts == [max_new] * len(prompts),
                f"small LM {leg} streams ended early: {counts}")
        require(all(0 <= x < vocab for toks in tokens for x in toks),
                f"small LM {leg}: token out of vocabulary")
        require((launches.get(kernel, 0) > 0) == on_card,
                f"small LM {leg}: the replica launched {launches}")
        out[leg] = row
    return out


def phase_small_lm(device) -> dict:
    """The JAX package's small LMs at their full width on the card
    (``small_lm_config``: D 16 and D 8): each trained with
    ``attn_impl="flash"`` in f32 and in bf16 (``small_lm_train``), then
    served from an int8 cache and as a bf16 model (``small_lm_serve``) in
    a cluster of the port (``DEPLOY_CLUSTER``, a
    session-local zygote, the session's own shm namespace, shut down at the
    end). ``launches_by_head_dim`` sums each head dim's launches over the
    training steps and the replicas. The whole phase takes at most
    ``SMALL_LM_LIMIT_S``."""
    from raydp_tpu_torch import cluster
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV
    from raydp_tpu_torch.cluster.zygote import WARM_TORCH_ENV

    t0 = time.perf_counter()
    workdir = BUILD_DIR / "small_lm"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    configs = {f"D{cfg['d_model'] // cfg['num_heads']}": cfg
               for cfg in map(small_lm_config, SMALL_LM_HEADS)}
    rec: dict = {"lms": {name: {"config": cfg} | {
        str(dtype)[6:]: small_lm_train(device, cfg, dtype)
        for dtype in (torch.float32, torch.bfloat16)}
        for name, cfg in configs.items()}}
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", WARM_TORCH_ENV: "1",
             SHM_NS_ENV: f"smalllm{os.getpid()}"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    try:
        session = cluster.init(**DEPLOY_CLUSTER)
        _wait_for(lambda: _zygote_serves(session), 30.0, "the zygote's warm-up")
        for name, cfg in configs.items():
            rec["lms"][name]["serving"] = small_lm_serve(device, cfg, workdir)
        cluster.shutdown()
        require(not _rtpt_segments(),
                f"segments left after shutdown: {sorted(_rtpt_segments())}")
    finally:
        if capi.is_initialized():
            cluster.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["launches_by_head_dim"] = {}
    for name, lm_rec in rec["lms"].items():
        total: dict = {}
        for counts in (lm_rec["float32"]["launches"],
                       lm_rec["bfloat16"]["launches"],
                       lm_rec["serving"]["int8"]["launches"],
                       lm_rec["serving"]["bf16"]["launches"]):
            _add_launches(total, counts)
        rec["launches_by_head_dim"][name[1:]] = total
    rec["seconds"] = time.perf_counter() - t0
    log(f"small LMs: {rec['seconds']:.1f} s; launches by head dim "
        f"{rec['launches_by_head_dim']}")
    require(rec["seconds"] <= SMALL_LM_LIMIT_S,
            f"phase_small_lm took {rec['seconds']:.1f} s")
    return rec


def small_lm_summary(rec: dict, nvidia_smi: str) -> dict:
    """The ``{"small_lm": {...}}`` line: per LM, the flash step's gaps to
    ``attn_impl="full"`` in f32 and bf16, the serving legs' seconds, the
    int8 tokens that are the f32 engine's and the launches by head dim,
    beside the card's name and power limit."""
    out = {}
    for name, lm_rec in rec["lms"].items():
        row = {kind: {k: lm_rec[kind][k] for k in ("loss_rel", "worst_grad_rel")}
               for kind in ("float32", "bfloat16")}
        serving = lm_rec["serving"]
        row["serving_s"] = {leg: serving[leg]["seconds"]
                            for leg in ("int8", "bf16")}
        row["int8_tokens_as_f32"] = serving["int8"]["tokens_as_f32"]
        out[name] = row
    return {"small_lm": out | {
        "seconds": rec["seconds"],
        "launches_by_head_dim": rec["launches_by_head_dim"]},
        "nvidia_smi": nvidia_smi}


# ---------------------------------------------------------------------------
# phase_wide_lm: bench.py's LM at its 2048 width, 8 heads of 256
# ---------------------------------------------------------------------------

# bench.py's LM at BENCH_LM_D=2048 (bench.py fixes 8 heads: head dim 256),
# its other widths MODEL's. Its paths: bf16 training at TRAIN's shape
# (batch 2, T 8192, Adam 3e-4; 1 warm + 3 timed steps, 8 in phase_train)
# with flash against attn_impl="full" at grad_check's T 2048 and bounds;
# f32 training at TRAIN_F32's shape (batch 1, T 2048; 1 warm + 2 timed
# steps), against "full" at phase_train_f32's bounds; serving at ENGINE's
# shape from an f32 cache (the f32 model), as a bf16 model (on the engine's
# f32 cache) and from an int8 cache (the f32 model), 4 streams of
# PROMPT_LENS (phase_serve's 8 cut to 4)
WIDE_LM = dict(model=dict(MODEL, d_model=2048),
               bf16=dict(batch=2, seq=8192, steps=3),
               f32=dict(batch=1, seq=2048, steps=2), grad_t=GRAD_CHECK_T,
               streams=4, prompt_lens=PROMPT_LENS, engine=ENGINE)
WIDE_LM_LIMITS = {torch.float32: (1e-6, 1e-4), torch.bfloat16: (5e-2, 5e-2)}
WIDE_LM_LIMIT_S = 300.0  # the whole phase
# the kernels the phase must launch at head dim 256 (the f32 backward pair
# by the kernels line's names)
WIDE_LM_KERNELS = ("flash_fwd", "flash_fwd_f32", "flash_bwd_dq",
                   "flash_bwd_dkv", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
                   "flash_decode", "flash_decode_int8", "quantize_int8")


def wide_lm_model(cfg: dict, impl: str, dtype, device, max_len: int):
    return TransformerLM(**cfg["model"], max_len=max_len, attn_impl=impl,
                         dtype=dtype, device=device, seed=SEED)


def wide_lm_twin(model, impl: str, dtype):
    """A copy of ``model`` with its weights (a TransformerLM keeps them in
    f32 whatever its type, as flax does) that attends by ``impl`` and
    computes in ``dtype``: the model, its blocks and its layer norms read
    ``attn_impl`` and ``dtype`` as attributes at every call. Drawing the
    seeded weights again takes ~12 s at 0.82 B parameters."""
    twin = copy.deepcopy(model)
    for mod in twin.modules():
        if "attn_impl" in vars(mod):
            mod.attn_impl = impl
        if isinstance(vars(mod).get("dtype"), torch.dtype):
            mod.dtype = dtype
    return twin


def wide_lm_train(device, cfg: dict, dtype, models: dict) -> dict:
    """One step's loss and gradients with ``attn_impl="flash"`` against
    ``attn_impl="full"`` from the same seeded weights (``WIDE_LM_LIMITS``:
    f32 loss relative, bf16 |dloss| as grad_check, and the worst per-tensor
    gradient relative) at the f32 shape, or at grad_check's T for bf16;
    then a warm and ``steps`` timed Adam steps at the path's shape, the
    counts zeroed just before and read just after: the forward and both
    backward kernels launch once a layer a step on the card (none on the
    CPU), and the loss is finite and falls. ``models`` holds the two
    (``"flash"``, ``"full"``, ``wide_lm_model``'s at a length that covers
    the path's T); the full one is taken out and freed once its gradients
    are, and the flash one is left trained, its gradients freed."""
    kind = "f32" if dtype == torch.float32 else "bf16"
    shape = cfg[kind]
    b, t, steps = shape["batch"], shape["seq"], shape["steps"]
    vocab, layers = cfg["model"]["vocab_size"], cfg["model"]["num_layers"]
    check_t = t if dtype == torch.float32 else cfg["grad_t"]
    tokens, targets = train_tokens(b, check_t, vocab, device)
    full = models.pop("full").train()
    ref_loss, ref_grads = loss_and_grads(full, tokens, targets)
    del full
    flash = models["flash"].train()
    loss, grads = loss_and_grads(flash, tokens, targets)
    gap = abs(float(loss) - float(ref_loss))
    if dtype == torch.float32:
        gap /= abs(float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    del grads, ref_grads
    loss_limit, grad_limit = WIDE_LM_LIMITS[dtype]
    flash.zero_grad(set_to_none=True)
    if check_t != t:
        tokens, targets = train_tokens(b, t, vocab, device)
    opt = torch.optim.Adam(flash.parameters(), lr=TRAIN["lr"])
    fa.reset_launches()
    first, losses, dt = timed_steps(flash, opt, tokens, targets, steps)
    launches = dict(fa.LAUNCHES)
    del opt
    flash.zero_grad(set_to_none=True)
    fwd = "flash_fwd_f32" if dtype == torch.float32 else "flash_fwd"
    per_run = {n: launches[n] for n in (fwd, "flash_bwd_dq", "flash_bwd_dkv")}
    want = layers * (steps + 1) if device.type == "cuda" else 0
    log(f"wide LM D{cfg['model']['d_model'] // cfg['model']['num_heads']} "
        f"{kind} (batch {b}, T {t}): flash vs full at T {check_t} "
        f"{'loss rel' if dtype == torch.float32 else '|dloss|'} {gap:.3e} "
        f"(limit {loss_limit}), worst grad rel {worst:.3e} (limit "
        f"{grad_limit}); loss {first:.4f} (warm step) -> {losses[-1]:.4f}; "
        f"step {1e3 * dt / steps:.2f} ms; launches {per_run}")
    require(gap <= loss_limit and worst <= grad_limit,
            f"the wide LM's {kind} flash step disagrees with attn_impl='full'")
    require(all(math.isfinite(x) for x in [first, *losses]),
            f"wide LM {kind} loss not finite")
    require(losses[-1] < first, f"the wide LM's {kind} loss did not fall")
    require(all(n == want for n in per_run.values()),
            f"wide LM {kind} launches {per_run}, expected {want} each")
    suffix = "_f32" if dtype == torch.float32 else ""
    return {"shape": f"batch {b}, T {t}, {kind}", "check_t": check_t,
            "loss_gap": gap, "worst_grad_rel": worst, "first_loss": first,
            "losses": losses, "step_ms": 1e3 * dt / steps,
            "tokens_s": steps * b * t / dt,
            "launches": {n + (suffix if n.startswith("flash_bwd") else ""): k
                         for n, k in launches.items() if k}}


def wide_lm_serve(device, cfg: dict, model, leg: str) -> dict:
    """Decode serving through ``DecodeEngine`` at ``cfg["engine"]``'s shape
    (``serve``) of ``model``, one leg: ``"f32"`` (an f32 model from an f32
    cache: the f32 prefill and K4a), ``"int8"`` (the f32 model from an
    int8 cache: K4b and the rows' quantize) or ``"bf16"`` (a bf16 model:
    the bf16 prefill and K4a with bf16 q), each stream to its token
    budget, the leg's kernels launched on the card (none on the CPU)."""
    prompts = make_prompts(cfg["streams"], *cfg["prompt_lens"],
                           cfg["model"]["vocab_size"])
    out = serve(model.eval(), prompts, leg == "int8", device,
                engine=cfg["engine"])
    kernels = {"f32": ("flash_fwd_f32", "flash_decode"),
               "bf16": ("flash_fwd", "flash_decode"),
               "int8": ("flash_fwd_f32", "flash_decode_int8",
                        "quantize_int8")}[leg]
    launched = {n: out["launches"][n] for n in kernels}
    require(all((n > 0) == (device.type == "cuda")
                for n in launched.values()),
            f"wide LM serving, {leg}: launches {launched}")
    return out


def phase_wide_lm(device, cfg: dict = WIDE_LM,
                  kernels: tuple = WIDE_LM_KERNELS,
                  limit_s: float = WIDE_LM_LIMIT_S,
                  name: str = "phase_wide_lm") -> dict:
    """bench.py's LM at its 2048 width, 8 heads of 256 (``WIDE_LM``), on
    its three paths, every model from one draw of the seeded weights
    (``wide_lm_model`` at a length that covers every path's T and the
    engine's capacity; the other models its ``wide_lm_twin``s). bf16:
    training (``wide_lm_train``), then the trained model served
    (``wide_lm_serve``); f32: training, then the trained model's prefill
    and first decode step of one stream held to ``attn_impl="full"`` on
    its own weights (``check_model_logits``), then its serving from an f32
    and an int8 cache (the int8 tokens that are the f32 cache's counted,
    not gated). ``launches`` sums the launches of every run; on the card
    each kernel of ``kernels`` must have launched. The whole phase takes
    at most ``limit_s``."""
    t0 = time.perf_counter()
    capacity = cfg["engine"]["capacity_tokens"]
    prompts = make_prompts(cfg["streams"], *cfg["prompt_lens"],
                           cfg["model"]["vocab_size"])
    rec = {"config": cfg["model"], "train": {},
           "serve": {"prompt_lens": [len(p) for p in prompts]}}
    max_len = max(cfg["bf16"]["seq"], cfg["f32"]["seq"], cfg["grad_t"],
                  capacity) + 1
    base = wide_lm_model(cfg, "flash", torch.float32, device, max_len)
    for dtype in (torch.bfloat16, torch.float32):
        kind = "f32" if dtype == torch.float32 else "bf16"
        if kind == "f32":  # the last leg takes the drawn model itself
            flash, base = base, None
        else:
            flash = wide_lm_twin(base, "flash", dtype)
        models = {"full": wide_lm_twin(flash, "full", dtype), "flash": flash}
        del flash
        rec["train"][str(dtype)[6:]] = wide_lm_train(device, cfg, dtype,
                                                     models)
        if kind == "f32":  # the trained weights that are served
            rec["serve"]["logits"] = check_model_logits(
                models["flash"].eval(),
                wide_lm_twin(models["flash"], "full", dtype).eval(),
                prompts[0], capacity)
        for leg in ("f32", "int8") if kind == "f32" else ("bf16",):
            rec["serve"][leg] = wide_lm_serve(device, cfg, models["flash"], leg)
        del models
    served = rec["serve"]
    served["int8_tokens_as_f32"] = sum(
        a == b for got, ref in zip(served["int8"]["tokens_by_stream"],
                                   served["f32"]["tokens_by_stream"])
        for a, b in zip(got, ref))
    log(f"wide LM serving: {served['int8_tokens_as_f32']} of "
        f"{served['int8']['tokens']} int8-cache tokens as the f32 cache's")
    launches: dict = {}
    for counts in [run["launches"] for run in rec["train"].values()] + [
            served[leg]["launches"] for leg in ("f32", "bf16", "int8")]:
        _add_launches(launches, {n: k for n, k in counts.items() if k})
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    head_dim = cfg["model"]["d_model"] // cfg["model"]["num_heads"]
    log(f"wide LM (D{head_dim}): {rec['seconds']:.1f} s; launches {launches}")
    if device.type == "cuda":
        missing = [n for n in kernels if not launches.get(n)]
        require(not missing, f"{name}: no launch of {missing}")
    else:
        require(not launches, f"{name} on the CPU launched {launches}")
    require(rec["seconds"] <= limit_s, f"{name} took {rec['seconds']:.1f} s")
    return rec


# phase_lm_4096: bench.py's LM at BENCH_LM_D=4096 (bench.py fixes 8 heads:
# head dim 512, past 256, which every attention family takes in 256-column
# chunks), its other widths the 2048 LM's: about 0.82 B parameters, seeded
# random weights. Trained and served as phase_wide_lm does the 2048 LM:
# bf16 at bench.py's shape (batch 2, T 8192; 1 warm + 3 timed steps) and
# f32 at batch 1, T 2048 (1 + 2), each against attn_impl="full" at
# WIDE_LM_LIMITS; served at ENGINE's shape from an f32 cache (the f32
# model), as a bf16 model and from an int8 cache, 4 streams of PROMPT_LENS
LM_4096 = dict(model=dict(MODEL, d_model=4096),
               bf16=dict(batch=2, seq=8192, steps=3),
               f32=dict(batch=1, seq=2048, steps=2), grad_t=GRAD_CHECK_T,
               streams=4, prompt_lens=PROMPT_LENS, engine=ENGINE)
LM_4096_LIMIT_S = 240.0  # the whole phase
# the kernels the phase must launch at head dim 512 (the f32 backward pair
# by the kernels line's names)
LM_4096_KERNELS = ("flash_fwd", "flash_fwd_f32", "flash_bwd_dq",
                   "flash_bwd_dkv", "flash_bwd_dq_f32", "flash_bwd_dkv_f32",
                   "flash_decode", "flash_decode_int8", "quantize_int8")


def phase_lm_4096(device, cfg: dict = LM_4096) -> dict:
    """bench.py's LM at its 4096 width, 8 heads of 512 (``LM_4096``), on
    ``phase_wide_lm``'s paths: bf16 and f32 training (each step's loss and
    gradients held to ``attn_impl="full"``, each attention kernel launched
    once a layer a step, the loss falling) and serving from f32, bf16 and
    int8 caches. On the card each kernel of ``LM_4096_KERNELS`` must have
    launched; the whole phase takes at most ``LM_4096_LIMIT_S``."""
    return phase_wide_lm(device, cfg, LM_4096_KERNELS, LM_4096_LIMIT_S,
                         "phase_lm_4096")


def lm_4096_summary(rec: dict, nvidia_smi: str) -> dict:
    """The ``{"lm_4096": {...}}`` line: ``wide_lm_summary``'s rows."""
    return wide_lm_summary(rec, nvidia_smi, "lm_4096")


def heads_past_256_summary(checks: dict, times: dict, nvidia_smi: str) -> dict:
    """The ``{"heads_past_256": {...}}`` line: each attention family (the
    forward, the f32 and bf16 backward's dq and dk/dv, the decodes) at the
    head dims of ``PAST_256_HEAD_DIMS``, its worst error against its plain
    version over ``check_heads_past_256`` (and, bf16, its worst error over
    its limit), and at D 512 its times (``heads_past_256_times``: events
    and device time, the plain version, SDPA with the backend that took
    the shape (the backward's: its backward), the bound, the operations'
    factor over one pass); beside the card's name and power limit."""
    out = head_dim_rows(checks, times)
    for name, row in out.items():
        timed = times.get(name, {})
        row.update({k: timed.get(k) for k in ("library", "recompute")})
    return {"heads_past_256": out, "nvidia_smi": nvidia_smi}


def wide_lm_summary(rec: dict, nvidia_smi: str, key: str = "wide_lm") -> dict:
    """The ``{key: {...}}`` line: the model, each training path's gaps to
    ``attn_impl="full"``, step ms and tokens/s, each serving run's tok/s,
    TTFT and TPOT p50, the first stream's logit gaps, the int8 tokens that
    are the f32 cache's, the launches and the seconds, beside the card's
    name and power limit."""
    serving = rec["serve"]
    return {key: {
        "config": rec["config"],
        "train": {kind: {k: row[k] for k in (
            "shape", "loss_gap", "worst_grad_rel", "first_loss", "step_ms",
            "tokens_s")} | {"last_loss": row["losses"][-1]}
            for kind, row in rec["train"].items()},
        "serve": {leg: {k: serving[leg][k] for k in (
            "decode_tok_s", "ttft_ms_p50", "tpot_ms_p50", "prefill_ms_p50")}
            for leg in ("f32", "bf16", "int8")},
        "logits": serving["logits"],
        "int8_tokens_as_f32": serving["int8_tokens_as_f32"],
        "launches": rec["launches"], "seconds": rec["seconds"]},
        "nvidia_smi": nvidia_smi}


def wide_heads_summary(checks: dict, times: dict, nvidia_smi: str) -> dict:
    """The ``{"wide_heads": {...}}`` line: every attention family at the
    head dims of ``WIDE_HEAD_DIMS``, each one's worst error against its
    plain version over ``check_wide_heads`` (and, bf16, its worst error
    over its limit), decode == the f32 prefill row, and at D 256 its times
    (``wide_head_times``: events and device time, the plain version, SDPA,
    the bound), beside the card's name and power limit."""
    out = head_dim_rows(checks, times)
    out["flash_fwd D256 train"] = {
        k: times.get("flash_fwd D256 train", {}).get(k) for k in TIME_KEYS}
    out["decode_vs_prefill_bf16 D256"] = checks.get("D256 decode_vs_prefill_bf16")
    return {"wide_heads": out, "nvidia_smi": nvidia_smi}


# ---------------------------------------------------------------------------
# phase_seqpar: sequence parallelism on the card
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def seqpar_expected(impl: str, world: int, device) -> dict:
    """Launches a step of each rank: the ring runs W block products a
    layer (the stats forward, then dq and dk/dv in the backward); Ulysses
    one flash forward and backward a layer on the gathered sequence. None
    on the CPU, where the plain versions run."""
    n = MODEL["num_layers"] * (world if impl.startswith("ring") else 1)
    n = n if device.type == "cuda" else 0
    return {"flash_fwd_f32": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def seqpar_loss(model, tokens, targets, mesh):
    """This rank's share of the global mean cross-entropy (its shard's
    sum over B*T), from its logits shard."""
    from raydp_tpu_torch.models.transformer import sequence_parallel_apply

    world = mesh.shape["sp"]
    rank = mesh.axis_index("sp")
    t_local = targets.shape[1] // world
    logits = sequence_parallel_apply(model, tokens, mesh)
    local = targets[:, rank * t_local:(rank + 1) * t_local]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           local.reshape(-1), reduction="sum") / targets.numel()


def seqpar_global(loss, mesh):
    import torch.distributed as dist

    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.group("sp"))
    return total


def seqpar_step(model, opt, tokens, targets, mesh):
    opt.zero_grad(set_to_none=True)
    loss = seqpar_loss(model, tokens, targets, mesh)
    loss.backward()
    opt.step()
    return seqpar_global(loss, mesh)


def seqpar_grads(model, tokens, targets, mesh):
    model.zero_grad(set_to_none=True)
    loss = seqpar_loss(model, tokens, targets, mesh)
    loss.backward()
    return seqpar_global(loss, mesh), {n: p.grad for n, p in
                                       model.named_parameters()}


def seqpar_overhead(impl, device, mesh) -> dict:
    """One attention layer of ``impl`` alone at the path's shape on this
    rank, q/k/v [B, H, T/W, D] f32 causal, forward and backward: its wall
    time by CUDA events (mean of 3 calls after a warm one) and the
    profiler's device time over 2 calls, split into the port's kernels and
    the rest (the merge, copies, the communication's kernels); the share
    of the wall outside the port's kernels. Not measured on the CPU."""
    from raydp_tpu_torch.parallel import bound_axes, ring_attention, ulysses_attention

    if device.type != "cuda":
        return {"wall_ms": None, "port_kernel_ms": None, "other_device_ms": None,
                "outside_kernels_share": None}
    from torch.profiler import ProfilerActivity, profile

    world = mesh.shape["sp"]
    heads, d = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"]
    shape = (SEQPAR["batch"], heads, SEQPAR["seq"] // world, d)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, g = (_randn(gen, shape, torch.float32, device) for _ in range(4))
    layer = ring_attention if impl.startswith("ring") else ulysses_attention

    def call():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with bound_axes(mesh):
            out = layer(*leaves, "sp", causal=True, use_flash=True)
        out.backward(g)

    call()
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        call()
    end.record()
    end.synchronize()
    wall_ms = start.elapsed_time(end) / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            call()
        torch.cuda.synchronize(device)
    by_name = device_ms_by_name(prof)
    port = sum(ms for name, ms in by_name.items()
               if port_kernel_pattern().match(name)) / 2
    other = sum(by_name.values()) / 2 - port
    return {"wall_ms": wall_ms, "port_kernel_ms": port if by_name else None,
            "other_device_ms": other if by_name else None,
            "outside_kernels_share": 1 - port / wall_ms if by_name else None}


def seqpar_impl(impl, device, mesh, tokens, targets, ref, backend) -> dict:
    """``impl`` at the mesh's world from the seeded weights: the global
    loss and every gradient against the flash run's (``ref``), twice
    (bitwise), then a warm step and SEQPAR["steps"] timed Adam steps with
    the launch counts zeroed just before and read just after, and the
    peak memory allocated over them."""
    world = mesh.shape["sp"]
    b, t, steps = SEQPAR["batch"], SEQPAR["seq"], SEQPAR["steps"]
    model = lm(impl, device, t + 1, dtype=torch.float32)
    loss, grads = seqpar_grads(model, tokens, targets, mesh)
    again, grads_again = seqpar_grads(model, tokens, targets, mesh)
    bitwise = bool(torch.equal(loss, again)) and all(
        torch.equal(grads[n], grads_again[n]) for n in grads)
    loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    worst, _ = grad_gap(grads, ref["grads"])
    del grads, grads_again
    model.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launches()
    first = seqpar_step(model, opt, tokens, targets, mesh).item()
    t0 = time.perf_counter()
    losses = [seqpar_step(model, opt, tokens, targets, mesh) for _ in range(steps)]
    losses = [float(x) for x in losses]  # the last one fences the steps
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    expected = seqpar_expected(impl, world, device)
    rec = {
        "impl": impl, "world": world, "backend": backend,
        "rank": mesh.axis_index("sp"),
        "loss_rel": loss_rel, "worst_grad_rel": worst, "bitwise": bitwise,
        "first_loss": first, "losses": losses, "launches": launches,
        "per_step": {n: launches[n] / (steps + 1) for n in expected},
        "expected_per_step": expected,
        "step_ms": 1e3 * dt / steps, "tokens_s": steps * b * t / dt,
        "base_bytes": base if cuda else None,
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
    }
    del model, opt
    rec["overhead"] = seqpar_overhead(impl, device, mesh)
    return rec


def seqpar_verdict(rec: dict) -> None:
    what = f"{rec['impl']} at world {rec['world']} ({rec['backend']}, rank {rec['rank']})"
    log(f"seqpar {what}: loss rel {rec['loss_rel']:.3e} (limit "
        f"{SEQPAR_LOSS_RTOL}), worst grad rel {rec['worst_grad_rel']:.3e} (limit "
        f"{SEQPAR_GRAD_RTOL}), two runs bitwise {rec['bitwise']}; loss "
        f"{rec['first_loss']:.4f} -> {rec['losses'][-1]:.4f}; launches per step "
        f"{rec['per_step']} (expected {rec['expected_per_step']}); step "
        f"{rec['step_ms']:.2f} ms, {rec['tokens_s']:.1f} tokens/s; peak "
        f"{rec['peak_bytes']} bytes over {rec['base_bytes']}; one layer alone "
        f"{rec['overhead']}")
    require(rec["loss_rel"] <= SEQPAR_LOSS_RTOL
            and rec["worst_grad_rel"] <= SEQPAR_GRAD_RTOL,
            f"seqpar {what}: loss or gradients disagree with the flash run")
    require(rec["bitwise"], f"seqpar {what}: two runs differ")
    require(all(math.isfinite(x) for x in [rec["first_loss"], *rec["losses"]])
            and rec["losses"][-1] < rec["first_loss"],
            f"seqpar {what}: the loss is not finite or did not fall")
    require(rec["per_step"] == {n: float(c) for n, c in
                                rec["expected_per_step"].items()},
            f"seqpar {what}: launches per step {rec['per_step']}")


def seqpar_inputs(device):
    b, t = SEQPAR["batch"], SEQPAR["seq"]
    return train_tokens(b, t, MODEL["vocab_size"], device)


def _rank_device(device_type: str):
    if device_type == "cuda":
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)
    torch.set_num_threads(1)  # two ranks' thread pools on one host's cores
    return torch.device("cpu")


GLOO_PROBE_OPS = ("p2p", "all_to_all", "all_reduce", "shift", "all_gather",
                  "broadcast")
# the collectives each impl's training step runs: the ring's rotation or
# Ulysses' swaps, and the parameters' gradient sum
SEQPAR_OPS = {"ring_flash": ("p2p", "all_reduce"),
              "ulysses_flash": ("all_to_all", "all_reduce")}


def gloo_probe_rank(rank, world, port, out_path, device_type, op) -> None:
    """One rank of one probe: does gloo take tensors on ``device_type`` for
    ``op`` (the ring's rotation by ``batch_isend_irecv``, Ulysses' and the
    experts' ``all_to_all_single``, the gradients' ``all_reduce``, the
    pipeline's ``_shift``: ``all_to_all_single`` with split sizes; DDP's
    ``all_gather`` and ``broadcast`` at construction) and give the values
    it must? Writes "ok", "wrong values", or the error gloo raised (a
    refusal) to ``out_path``."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import pipeline
    from raydp_tpu_torch.parallel.mesh import Axis

    device = _rank_device(device_type)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)

    def p2p():
        x = torch.full((1024,), float(rank), device=device)
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, buf, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bool((buf == (rank - 1) % world).all())

    def all_to_all():
        send = (10.0 * rank + torch.arange(world, device=device))[:, None]
        send = send.expand(world, 256).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        want = (10.0 * torch.arange(world, device=device) + rank)[:, None]
        return bool((recv == want).all())

    def all_reduce():
        x = torch.full((1024,), float(rank + 1), device=device)
        dist.all_reduce(x)
        return bool((x == world * (world + 1) / 2).all())

    def shift():
        x = torch.full((1024,), float(rank), device=device)
        got = pipeline._shift(x, Axis(dist.group.WORLD, rank, world), 1)
        return bool((got == (rank - 1) % world).all())

    def all_gather():
        x = torch.full((1024,), float(rank), device=device)
        got = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(got, x)
        return all(bool((t == r).all()) for r, t in enumerate(got))

    def broadcast():
        x = torch.full((1024,), float(rank + 1), device=device)
        dist.broadcast(x, src=0)
        return bool((x == 1).all())

    try:
        run = {"p2p": p2p, "all_to_all": all_to_all, "all_reduce": all_reduce,
               "shift": shift, "all_gather": all_gather,
               "broadcast": broadcast}[op]
        outcome = "ok" if run() else "wrong values"
    except RuntimeError as exc:  # gloo's refusal is the probe's answer
        outcome = f"refused: {exc!r}"[:300]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(outcome))


def seqpar_rank(rank, world, port, ref_path, out_path, device_type,
                config) -> None:
    """One rank of the world-``world`` run over gloo: every impl of
    SEQPAR against the flash run's loss and gradients in ``ref_path``; the
    records to ``out_path``."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    globals().update(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _rank_device(device_type)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    ref = torch.load(ref_path, map_location=device)
    tokens, targets = seqpar_inputs(device)
    mesh = make_mesh({"sp": world})
    records = [seqpar_impl(impl, device, mesh, tokens, targets, ref, "gloo")
               for impl in SEQPAR["impls"]]
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(records))


def start_world(target, world, args_of) -> list:
    """``target(rank, *args_of(rank))`` started in ``world`` spawned
    processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args_of(rank)))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs, deadline: float) -> list:
    """The exit codes of ``procs`` (None for a process killed at the
    ``time.monotonic()`` deadline)."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10.0)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def spawn_world(target, world, args_of, limit_s) -> list:
    """Run ``target(rank, *args_of(rank))`` in ``world`` spawned processes;
    their exit codes (None for a process killed at ``limit_s``)."""
    return join_world(start_world(target, world, args_of),
                      time.monotonic() + limit_s)


def run_world2(target, device, name: str, config: dict, limit_s: float,
               extra=()) -> list:
    """``target(rank, 2, port, *extra, out_path, device.type, config)`` in
    two spawned processes; each rank's JSON record."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [BUILD_DIR / f"{name}_rank{r}.json" for r in range(2)]
    for out in outs:
        out.unlink(missing_ok=True)
    port = free_port()
    codes = spawn_world(
        target, 2,
        lambda r: (2, port, *extra, str(outs[r]), device.type, config), limit_s)
    require(codes == [0, 0], f"{name} world 2 over gloo: exit codes {codes}")
    return [json.loads(out.read_text()) for out in outs]


_GLOO_TAKES: dict = {}  # (device type, op) -> the probe's verdict


def gloo_takes(device, ops=GLOO_PROBE_OPS) -> dict:
    """Whether gloo takes ``device``'s tensors for each of ``ops``, one
    pair of spawned ranks an op (``gloo_probe_rank``; the pairs run at the
    same time, each on a port of its own), each op probed once a run:
    {"ops": {op: "ok" | "refused" with the ranks' detail}}. Refused is an
    error gloo raised or a rank killed by a signal inside gloo; wrong
    values, or a rank that failed otherwise or ran past its limit, fail the
    run."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = {op: _GLOO_TAKES[(device.type, op)] for op in ops
            if (device.type, op) in _GLOO_TAKES}
    todo = [op for op in ops if op not in done]
    ports: list = []
    while len(ports) < len(todo):
        port = free_port()
        if port not in ports:
            ports.append(port)
    pairs = {}
    for op, port in zip(todo, ports):
        outs = [BUILD_DIR / f"gloo_probe_{op}_{r}.json" for r in range(2)]
        for out in outs:
            out.unlink(missing_ok=True)
        pairs[op] = (outs, start_world(
            gloo_probe_rank, 2,
            lambda r, op=op, port=port, outs=outs: (
                2, port, str(outs[r]), device.type, op)))
    deadline = time.monotonic() + 120.0
    codes_of = {op: join_world(pairs[op][1], deadline) for op in todo}
    for op in todo:
        outs, codes = pairs[op][0], codes_of[op]
        ranks = [json.loads(out.read_text()) if out.exists() else None
                 for out in outs]
        detail = {"exit_codes": codes, "ranks": ranks}
        for code, got in zip(codes, ranks):
            require(got != "wrong values",
                    f"gloo's {op} gave wrong values: {detail}")
            require(code is not None and (code < 0 or (code == 0 and got)),
                    f"the gloo probe of {op} failed: {detail}")
        ok = codes == [0, 0] and ranks == ["ok", "ok"]
        done[op] = _GLOO_TAKES[(device.type, op)] = \
            "ok" if ok else f"refused: {detail}"
    return {"ops": {op: done[op] for op in ops}}


def require_gloo_takes(device, ops, what: str) -> dict:
    """``gloo_takes`` for the ops a world-2 run over gloo needs; a refusal
    fails the phase (there is no other route on the one card)."""
    probe = gloo_takes(device, ops)
    refused = {op: v for op, v in probe["ops"].items() if v != "ok"}
    require(not refused, f"{what} at world 2: gloo does not take "
            f"{device.type} tensors for {refused}")
    return probe


def phase_seqpar(device) -> dict:
    """Sequence parallelism at full width in f32 (SEQPAR): the flash run
    on the whole sequence first (the reference loss and gradients, then its
    step time), then ring_flash and ulysses_flash under
    sequence_parallel_apply at world 1 over NCCL in this process
    (``seqpar_impl``: loss within SEQPAR_LOSS_RTOL and every gradient
    within SEQPAR_GRAD_RTOL of the flash run's, two runs bitwise, the loss
    falls, launches per step as ``seqpar_expected`` reckons them: W stats
    forwards and W dq and W dk/dv launches a layer for the ring, one each
    for Ulysses). Then whether gloo takes the card's tensors
    for each op (``gloo_takes``); each impl whose ops it takes
    (``SEQPAR_OPS``) again at world 2 over gloo in two processes on the
    one card, held the same way, and for each other impl a line saying
    which ops gloo refused. On the CPU the same runs go over gloo with the
    plain versions."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    tokens, targets = seqpar_inputs(device)
    steps = SEQPAR["steps"]
    flash = lm("flash", device, SEQPAR["seq"] + 1, dtype=torch.float32)
    ref_loss, ref_grads = loss_and_grads(flash, tokens, targets)
    ref = {"loss": float(ref_loss),
           "grads": {n: g.detach().clone() for n, g in ref_grads.items()}}
    del ref_grads
    flash.zero_grad(set_to_none=True)
    _, flash_losses, flash_dt = timed_steps(
        flash, torch.optim.Adam(flash.parameters(), lr=TRAIN["lr"]), tokens,
        targets, steps)
    del flash
    rec = {"shape": f"batch {SEQPAR['batch']}, T {SEQPAR['seq']}, f32, {MODEL}",
           "flash_step_ms": 1e3 * flash_dt / steps,
           "flash_tokens_s": steps * SEQPAR["batch"] * SEQPAR["seq"] / flash_dt,
           "runs": []}

    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh({"sp": 1})
        for impl in SEQPAR["impls"]:
            rec["runs"].append(seqpar_impl(impl, device, mesh, tokens, targets,
                                           ref, backend))
            seqpar_verdict(rec["runs"][-1])
    finally:
        dist.destroy_process_group()

    probe = gloo_takes(device)
    rec["gloo_takes_device_tensors"] = probe
    impls2 = [impl for impl in SEQPAR["impls"]
              if all(probe["ops"][op] == "ok" for op in SEQPAR_OPS[impl])]
    for impl in SEQPAR["impls"]:
        if impl not in impls2:
            log(f"seqpar {impl} at world 2: not run; gloo does not take "
                f"{device.type} tensors for {SEQPAR_OPS[impl]}: {probe['ops']}")
    if impls2:
        ref_path = BUILD_DIR / "seqpar_ref.pt"
        torch.save(ref, ref_path)
        config = {"MODEL": MODEL, "SEQPAR": dict(SEQPAR, impls=tuple(impls2)),
                  "TRAIN": TRAIN, "SEED": SEED}
        try:
            ranks = run_world2(seqpar_rank, device, "seqpar", config,
                               SEQPAR_RANK_LIMIT_S, (str(ref_path),))
        finally:
            ref_path.unlink()
        for records in ranks:
            for run in records:
                seqpar_verdict(run)
                rec["runs"].append(run)
    rec["launches"] = {name: sum(run["launches"][name] for run in rec["runs"])
                       for name in ("flash_fwd_f32", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    rec["phase_s"] = time.perf_counter() - t0
    log(f"seqpar: flash step {rec['flash_step_ms']:.2f} ms, "
        f"{rec['flash_tokens_s']:.1f} tokens/s; worlds "
        f"{sorted({run['world'] for run in rec['runs']})}; phase "
        f"{rec['phase_s']:.1f} s")
    require(all(math.isfinite(x) for x in flash_losses), "flash loss not finite")
    return rec


def seqpar_summary(rec: dict, nvidia_smi: str) -> dict:
    """The phase's line: each run's step ms and tokens/s beside the flash
    step, the share of one layer's time outside the port's kernels, and
    the peak memory."""
    return {"seqpar": {
        "shape": rec["shape"], "flash_step_ms": rec["flash_step_ms"],
        "flash_tokens_s": rec["flash_tokens_s"],
        "gloo_takes_device_tensors": {
            op: verdict.split(":")[0]
            for op, verdict in rec["gloo_takes_device_tensors"]["ops"].items()},
        "runs": [{k: run[k] for k in ("impl", "world", "backend", "rank",
                                      "step_ms", "tokens_s", "peak_bytes",
                                      "loss_rel", "worst_grad_rel")}
                 | {"vs_flash_step": run["step_ms"] / rec["flash_step_ms"],
                    "outside_kernels_share":
                        run["overhead"]["outside_kernels_share"]}
                 for run in rec["runs"]]},
        "nvidia_smi": nvidia_smi}


# ---------------------------------------------------------------------------
# phase_pipeline: the LM's blocks as the stages of a pipeline on the card
# ---------------------------------------------------------------------------

# phase_pipeline: the widest LM in f32 with attn_impl="flash" at batch 4 x T
# 2048, split into 4 microbatches of [1, 2048, 1024] (phase_train_f32's
# shape); its 4 blocks are the stages: world 1 one stage of 4 (NCCL, in this
# process), world 2 two stages of 2 (gloo, two processes on the one card); a
# warm step and 4 timed Adam steps each, beside the non-pipelined flash step
PIPELINE = dict(batch=4, seq=2048, microbatches=4, steps=4)
PIPELINE_LOSS_RTOL, PIPELINE_GRAD_RTOL = 1e-5, 1e-4
PIPELINE_RANK_LIMIT_S = 300.0  # the spawned world's whole run
# the collectives of a world-2 step over gloo: the activations' and
# gradients' shifts, the output's broadcast and the input gradient's sum
PIPELINE_OPS = ("shift", "all_reduce")


def pipeline_inputs(device):
    return train_tokens(PIPELINE["batch"], PIPELINE["seq"], MODEL["vocab_size"],
                        device)


def pipeline_expected(world: int, device) -> dict:
    """Launches a step of each rank under the schedule, which skips the
    bubble ticks: each block of the rank's stage runs once a microbatch, M
    x blocks a stage of the f32 forward, and as many of dq and of dk/dv
    (the forward's graphs are kept, not recomputed). 0 on the CPU, where
    the plain versions run."""
    n = PIPELINE["microbatches"] * MODEL["num_layers"] // world
    n = n if device.type == "cuda" else 0
    return {"flash_fwd_f32": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def pipeline_model(device, world: int, rank: int):
    """The seeded f32 flash LM keeping only this rank's stage of blocks:
    (model, stage, named), ``stage`` the blocks' ``module_stage`` (the
    function and its parameters), ``named`` this rank's parameters (the
    outer ones and its stage's) under the whole model's names."""
    from raydp_tpu_torch.parallel.pipeline import module_stage

    model = lm("flash", device, PIPELINE["seq"] + 1, dtype=torch.float32)
    per = MODEL["num_layers"] // world
    lo = rank * per
    stage = module_stage(torch.nn.Sequential(*model.blocks[lo:lo + per]))
    model.blocks = torch.nn.ModuleList()  # the other stages' blocks go
    named = dict(model.named_parameters())
    for name, p in stage[1].items():
        index, rest = name.split(".", 1)
        named[f"blocks.{lo + int(index)}.{rest}"] = p
    return model, stage, named


def pipeline_loss(model, stage, tokens, targets, mesh):
    """TransformerLM's loss with its blocks through ``pipeline_sharded``
    over the "pp" axis: the embedding and positions, the final LayerNorm,
    the head and the mean cross-entropy on every rank alike."""
    from raydp_tpu_torch.parallel import pipeline_sharded

    t = tokens.shape[1]
    x = F.embedding(tokens, model.embed.weight.to(model.dtype))
    x = x + model.pos_embed[:t].to(model.dtype)
    h = pipeline_sharded(*stage, x, mesh, PIPELINE["microbatches"])
    logits = model.lm_head(model.ln_f(h).float())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def pipeline_grads(model, stage, named, tokens, targets, mesh):
    for p in named.values():
        p.grad = None
    loss = pipeline_loss(model, stage, tokens, targets, mesh)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in named.items()}


def pipeline_step(model, stage, opt, tokens, targets, mesh):
    opt.zero_grad(set_to_none=True)
    loss = pipeline_loss(model, stage, tokens, targets, mesh)
    loss.backward()
    opt.step()
    return loss.detach()


def pipeline_gaps(loss, grads: dict, ref: dict) -> dict:
    """The loss's relative gap to the flash step's and the worst of this
    rank's gradients' (per tensor, in norm)."""
    worst, _ = grad_gap(grads, {n: ref["grads"][n] for n in grads})
    return {"loss_rel": abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
            "worst_grad_rel": worst}


def shift_split(shifts: list, world: int, rank: int, m: int) -> dict:
    """The seconds in a step's shifts (``timed_calls`` of the pipeline's
    ``_shift``), and those of the shifts that end a tick where this rank
    computed nothing (a bubble tick: it waits for its neighbour). The
    forward shifts after ticks 0 .. M+N-3, the backward after ticks
    M+N-2 .. 1."""
    ticks = m + world - 1
    tick_of = list(range(ticks - 1)) + list(range(ticks - 1, 0, -1))
    require(len(shifts) == (len(tick_of) if world > 1 else 0),
            f"pipeline: {len(shifts)} shifts in a step of world {world}")
    return {"shift_s": sum(s for _, s in shifts),
            "bubble_wait_s": sum(s for t, (_, s) in zip(tick_of, shifts)
                                 if not 0 <= t - rank < m)}


def pipeline_run(device, mesh, tokens, targets, ref, backend) -> dict:
    """This rank of the pipeline at the mesh's world from the seeded
    weights: the loss and its gradients against the flash step's
    (``ref``), twice (bitwise); then a warm step and PIPELINE["steps"]
    timed Adam steps, the launch counts zeroed just before and read just
    after, the peak memory over them; then one more step with the shifts
    and all-reduces timed (``timed_calls``)."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import pipeline

    world, rank = mesh.shape["pp"], mesh.axis_index("pp")
    b, t, steps, m = (PIPELINE[k] for k in ("batch", "seq", "steps",
                                            "microbatches"))
    t_start = time.perf_counter()
    model, stage, named = pipeline_model(device, world, rank)
    sections = {"model_s": time.perf_counter() - t_start}
    loss, grads = pipeline_grads(model, stage, named, tokens, targets, mesh)
    again, grads_again = pipeline_grads(model, stage, named, tokens, targets,
                                        mesh)
    bitwise = bool(torch.equal(loss, again)) and all(
        torch.equal(grads[n], grads_again[n]) for n in grads)
    gaps = pipeline_gaps(loss, grads, ref)
    del grads, grads_again
    sections["check_s"] = time.perf_counter() - t_start - sections["model_s"]
    opt = torch.optim.Adam(named.values(), lr=TRAIN["lr"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launches()
    first = pipeline_step(model, stage, opt, tokens, targets, mesh).item()
    t0 = time.perf_counter()
    losses = [pipeline_step(model, stage, opt, tokens, targets, mesh)
              for _ in range(steps)]
    losses = [float(x) for x in losses]  # the last one fences the steps
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    with timed_calls(pipeline, "_shift", device) as shifts, \
            timed_calls(dist, "all_reduce", device) as reduces:
        t1 = time.perf_counter()
        pipeline_step(model, stage, opt, tokens, targets, mesh).item()
        split_s = time.perf_counter() - t1
    split = shift_split(shifts, world, rank, m)
    expected = pipeline_expected(world, device)
    profile = profiled(lambda: pipeline_step(model, stage, opt, tokens, targets,
                                             mesh).item(), device)
    sections["run_s"] = time.perf_counter() - t_start
    del model, stage, named, opt
    return {
        "world": world, "backend": backend, "rank": rank, **gaps,
        "bitwise": bitwise, "first_loss": first, "losses": losses,
        "launches": launches,
        "per_step": {n: launches[n] / (steps + 1) for n in expected},
        "expected_per_step": expected,
        "step_ms": 1e3 * dt / steps, "tokens_s": steps * b * t / dt,
        "base_bytes": base if cuda else None, "peak_bytes": peak,
        "split_step_ms": 1e3 * split_s,
        "shift_share": split["shift_s"] / split_s,
        "bubble_wait_share": split["bubble_wait_s"] / split_s,
        "all_reduce_share": sum(s for _, s in reduces) / split_s,
        "bubble_ticks_share": (world - 1) / (m + world - 1),
        "profile": profile, "sections_s": sections,
    }


def pipeline_verdict(rec: dict) -> None:
    what = f"pipeline at world {rec['world']} ({rec['backend']}, rank {rec['rank']})"
    log(f"{what}: loss rel {rec['loss_rel']:.3e} (limit {PIPELINE_LOSS_RTOL}), "
        f"worst grad rel {rec['worst_grad_rel']:.3e} (limit "
        f"{PIPELINE_GRAD_RTOL}), two runs bitwise {rec['bitwise']}; loss "
        f"{rec['first_loss']:.4f} -> {rec['losses'][-1]:.4f}; launches per "
        f"step {rec['per_step']} (expected {rec['expected_per_step']}); step "
        f"{rec['step_ms']:.2f} ms, {rec['tokens_s']:.1f} tokens/s; of a step "
        f"({rec['split_step_ms']:.2f} ms with the device drained at each "
        f"shift) {rec['shift_share']:.3f} in the shifts, "
        f"{rec['bubble_wait_share']:.3f} of it waiting in bubble ticks, "
        f"{rec['all_reduce_share']:.3f} in all-reduces; bubble ticks "
        f"{rec['bubble_ticks_share']:.3f} of the schedule; peak "
        f"{rec['peak_bytes']} bytes over {rec['base_bytes']}")
    require(rec["loss_rel"] <= PIPELINE_LOSS_RTOL
            and rec["worst_grad_rel"] <= PIPELINE_GRAD_RTOL,
            f"{what}: loss or gradients disagree with the flash step")
    require(rec["bitwise"], f"{what}: two runs differ")
    require(all(math.isfinite(x) for x in [rec["first_loss"], *rec["losses"]])
            and rec["losses"][-1] < rec["first_loss"],
            f"{what}: the loss is not finite or did not fall")
    require(rec["per_step"] == {n: float(c) for n, c in
                                rec["expected_per_step"].items()},
            f"{what}: launches per step {rec['per_step']}")


def pipeline_rank(rank, world, port, ref_path, out_path, device_type,
                  config) -> None:
    """One rank of the world-``world`` pipeline over gloo, held to the
    flash step's loss and gradients in ``ref_path``; its record to
    ``out_path``."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    globals().update(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _rank_device(device_type)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    ref = torch.load(ref_path, map_location=device)
    tokens, targets = pipeline_inputs(device)
    rec = pipeline_run(device, make_mesh({"pp": world}), tokens, targets, ref,
                       "gloo")
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(rec))


def phase_pipeline(device) -> dict:
    """Pipeline parallelism at full width in f32 (PIPELINE): the
    non-pipelined flash step on the whole batch first (the reference loss
    and gradients, then its step time), then the LM's blocks as the stages
    of ``pipeline_sharded`` at world 1 over NCCL in this process and at
    world 2 over gloo in two processes on the one card (``pipeline_run``:
    loss within PIPELINE_LOSS_RTOL and every gradient of the rank within
    PIPELINE_GRAD_RTOL, two runs bitwise, the loss falls, launches a step as
    ``pipeline_expected`` reckons them). gloo must take the card's tensors
    for the shift and the all-reduce, or the phase fails. On the CPU the
    same runs go over gloo with the plain versions."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    tokens, targets = pipeline_inputs(device)
    steps = PIPELINE["steps"]
    flash = lm("flash", device, PIPELINE["seq"] + 1, dtype=torch.float32)
    ref_loss, ref_grads = loss_and_grads(flash, tokens, targets)
    ref = {"loss": float(ref_loss),
           "grads": {n: g.detach().clone() for n, g in ref_grads.items()}}
    del ref_grads
    flash.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(flash.parameters(), lr=TRAIN["lr"])
    _, flash_losses, flash_dt = timed_steps(flash, opt, tokens, targets, steps)
    flash_profile = profiled(
        lambda: train_step(flash, opt, tokens, targets).item(), device)
    del flash, opt
    require(all(math.isfinite(x) for x in flash_losses), "flash loss not finite")
    tokens_step = PIPELINE["batch"] * PIPELINE["seq"]
    rec = {"shape": f"batch {PIPELINE['batch']}, T {PIPELINE['seq']}, "
                    f"{PIPELINE['microbatches']} microbatches, f32, {MODEL}",
           "flash_step_ms": 1e3 * flash_dt / steps,
           "flash_tokens_s": steps * tokens_step / flash_dt,
           "flash_profile": flash_profile, "runs": []}
    sections = {"reference_s": time.perf_counter() - t0}

    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        run = pipeline_run(device, make_mesh({"pp": 1}), tokens, targets, ref,
                           backend)
    finally:
        dist.destroy_process_group()
    pipeline_verdict(run)
    rec["runs"].append(run)
    sections["world1_s"] = time.perf_counter() - t0 - sum(sections.values())

    rec["gloo_takes_device_tensors"] = require_gloo_takes(
        device, PIPELINE_OPS, "pipeline")
    sections["probe_s"] = time.perf_counter() - t0 - sum(sections.values())
    ref_path = BUILD_DIR / "pipeline_ref.pt"
    torch.save(ref, ref_path)
    config = {"MODEL": MODEL, "PIPELINE": PIPELINE, "TRAIN": TRAIN, "SEED": SEED}
    try:
        runs = run_world2(pipeline_rank, device, "pipeline", config,
                          PIPELINE_RANK_LIMIT_S, (str(ref_path),))
    finally:
        ref_path.unlink()
    for run in runs:
        pipeline_verdict(run)
        rec["runs"].append(run)
    sections["world2_s"] = time.perf_counter() - t0 - sum(sections.values())
    rec["launches"] = {name: sum(run["launches"][name] for run in rec["runs"])
                       for name in ("flash_fwd_f32", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    rec["phase_s"] = time.perf_counter() - t0
    rec["sections_s"] = sections
    log(f"pipeline: flash step {rec['flash_step_ms']:.2f} ms, "
        f"{rec['flash_tokens_s']:.1f} tokens/s, profiled {flash_profile}; "
        f"world 1 profiled {rec['runs'][0]['profile']}; launches "
        f"{rec['launches']}; phase {rec['phase_s']:.1f} s {sections}; the "
        f"ranks' {[run['sections_s'] for run in rec['runs']]}")
    return rec


def pipeline_summary(rec: dict, nvidia_smi: str) -> dict:
    """The phase's line: each rank's step ms and tokens/s beside the flash
    step, the shares of a step in the shifts, the bubble's waits and the
    all-reduces, and the peak memory."""
    return {"pipeline": {
        "shape": rec["shape"], "flash_step_ms": rec["flash_step_ms"],
        "flash_tokens_s": rec["flash_tokens_s"],
        "runs": [{k: run[k] for k in (
            "world", "backend", "rank", "step_ms", "tokens_s", "peak_bytes",
            "loss_rel", "worst_grad_rel", "per_step", "shift_share",
            "bubble_wait_share", "all_reduce_share", "bubble_ticks_share")}
                 | {"vs_flash_step": run["step_ms"] / rec["flash_step_ms"]}
                 for run in rec["runs"]],
        "phase_s": rec["phase_s"]}, "nvidia_smi": nvidia_smi}


# ---------------------------------------------------------------------------
# phase_moe: top-2 mixture of experts across ranks on the card
# ---------------------------------------------------------------------------

# phase_moe: 4096 tokens a rank (batch 2 x T 2048 of the LM's input
# activations, its embedding and positions of tokens from default_rng(17)),
# each expert the block's MLP in f32, __graft_entry__.py's objective: top-2
# routing and mean(out²) + 0.01 · load_balance_loss; the dense check at
# capacity factor 8 (nothing drops), the trained steps at 1.25
MOE = dict(batch=2, seq=2048, top_k=2, capacity_factor=1.25,
           dense_capacity_factor=8.0, aux_weight=0.01, steps=4, lr=3e-4)
MOE_OUT_RTOL, MOE_GRAD_RTOL = 1e-5, 1e-4
MOE_RANK_LIMIT_S = 300.0
# the collectives of a world-2 step over gloo: the dispatch and return
# all-to-alls, the router's gradient sum and the aux scalars' means
MOE_OPS = ("all_to_all", "all_reduce")


def moe_expert_fn(params, t):
    """The LM block's MLP as an expert: [R, D] -> [R, D], f32."""
    w1, b1, w2, b2 = params
    return F.gelu(t @ w1 + b1, approximate="tanh") @ w2 + b2


def moe_experts(device, n: int) -> list:
    """Every expert's parameters, expert e from seed SEED + 1 + e (lecun
    normal kernels, zero biases), as leaves that take gradients."""
    d = MODEL["d_model"]
    experts = []
    for e in range(n):
        gen = torch.Generator().manual_seed(SEED + 1 + e)
        params = [torch.randn(d, 4 * d, generator=gen) * d ** -0.5,
                  torch.zeros(4 * d),
                  torch.randn(4 * d, d, generator=gen) * (4 * d) ** -0.5,
                  torch.zeros(d)]
        experts.append([p.to(device).requires_grad_(True) for p in params])
    return experts


def moe_router(device, n: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(SEED + 100)
    d = MODEL["d_model"]
    return (torch.randn(d, n, generator=gen) * d ** -0.5).to(device).requires_grad_(True)


def moe_tokens(device, world: int) -> torch.Tensor:
    """[world * batch * seq, d_model] f32: the seeded LM's embedding and
    positions of ``world`` x MOE["batch"] sequences, rank r's rows the
    r-th block of them."""
    b, t = MOE["batch"] * world, MOE["seq"]
    tokens, _ = train_tokens(b, t, MODEL["vocab_size"], device)
    model = lm("full", device, t + 1, dtype=torch.float32)
    with torch.no_grad():
        x = F.embedding(tokens, model.embed.weight) + model.pos_embed[:t]
    return x.reshape(b * t, MODEL["d_model"]).contiguous()


def moe_dense(experts, router, x_all, world: int):
    """The same routing computed densely, every expert on every token:
    the top-k gates (renormalized for k > 1) pick and weight the rows; the
    load-balance loss is the mean over the ranks' shards of each one's, as
    ``moe_apply``'s pmean takes it. Returns (out, loss) with the phase's
    objective."""
    from raydp_tpu_torch.parallel.moe import top_k_lowest_first

    n = len(experts)
    k = min(MOE["top_k"], n)
    gates = torch.softmax(x_all @ router, dim=-1)
    vals, idx = top_k_lowest_first(gates, k)
    w = vals / vals.sum(-1, keepdim=True) if k > 1 else vals
    dense = torch.stack([moe_expert_fn(e, x_all) for e in experts], 1)
    rows = torch.arange(x_all.shape[0], device=x_all.device)
    out = sum(dense[rows, idx[:, c]] * w[:, c:c + 1] for c in range(k))
    shard = x_all.shape[0] // world
    lb = sum(n * torch.sum(F.one_hot(idx[s:s + shard].T.reshape(-1), n)
                           .float().mean(0) * gates[s:s + shard].mean(0))
             for s in range(0, x_all.shape[0], shard)) / world
    return out, out.pow(2).mean() + MOE["aux_weight"] * lb


def moe_loss(mine, router, x, mesh, capacity_factor, total):
    """This rank's loss: its tokens' share of mean(out²) over all ``total``
    elements, plus the aux term whole (moe.py's convention); (loss, out,
    aux)."""
    from raydp_tpu_torch.parallel import moe_sharded

    out, aux = moe_sharded(moe_expert_fn, mine, router, x, mesh, axis="ep",
                           capacity_factor=capacity_factor,
                           top_k=MOE["top_k"], return_aux=True)
    loss = out.pow(2).sum() / total + MOE["aux_weight"] * aux["load_balance_loss"]
    return loss, out, aux


def moe_global(loss, out, total, mesh):
    """The objective's value over every rank (the token term's shares
    summed; the aux term is the same on every rank)."""
    import torch.distributed as dist

    tokens_part = out.detach().pow(2).sum() / total
    aux_part = loss.detach() - tokens_part
    dist.all_reduce(tokens_part, group=mesh.group("ep"))
    return tokens_part + aux_part


def moe_grads(mine, router, x, mesh, capacity_factor, total):
    for p in [*mine, router]:
        p.grad = None
    loss, out, aux = moe_loss(mine, router, x, mesh, capacity_factor, total)
    loss.backward()
    return (moe_global(loss, out, total, mesh), out.detach(),
            {k: float(v.detach()) for k, v in aux.items()},
            [p.grad.clone() for p in mine] + [router.grad.clone()])


def moe_run(device, mesh, backend) -> dict:
    """This rank of the experts at the mesh's world: at
    MOE["dense_capacity_factor"] the output and the gradients of its
    expert and of the router against ``moe_dense`` on the whole batch,
    twice (bitwise); then a warm step and MOE["steps"] Adam steps at
    MOE["capacity_factor"] (each step's global loss, drop fraction and aux
    loss), the port's launch counts zeroed just before and read just
    after, the peak memory; then one more step with the all-to-alls
    timed."""
    from raydp_tpu_torch.parallel import moe

    world, rank = mesh.shape["ep"], mesh.axis_index("ep")
    t_start = time.perf_counter()
    x_all = moe_tokens(device, world)
    shard = x_all.shape[0] // world
    x = x_all[rank * shard:(rank + 1) * shard]
    total = x_all.numel()
    experts, router = moe_experts(device, world), moe_router(device, world)
    ref_out, ref_loss = moe_dense(experts, router, x_all, world)
    ref_loss.backward()
    ref_value = float(ref_loss.detach())
    ref_grads = [p.grad.clone() for p in experts[rank]] + [router.grad.clone()]
    mine = experts[rank]
    del experts[:]
    cf = MOE["dense_capacity_factor"]
    loss, out, aux, grads = moe_grads(mine, router, x, mesh, cf, total)
    again, out2, aux2, grads2 = moe_grads(mine, router, x, mesh, cf, total)
    ref_mine = ref_out[rank * shard:(rank + 1) * shard].detach()
    names = ["w1", "b1", "w2", "b2", "router"]
    worst, _ = grad_gap(dict(zip(names, grads)), dict(zip(names, ref_grads)))
    dense = {
        "out_rel": float((out - ref_mine).abs().max() / ref_mine.abs().max()),
        "loss_rel": abs(float(loss) - ref_value) / abs(ref_value),
        "worst_grad_rel": worst, "drop_fraction": aux["drop_fraction"],
        "bitwise": bool(torch.equal(loss, again) and torch.equal(out, out2)
                        and aux == aux2 and all(torch.equal(a, b) for a, b
                                                in zip(grads, grads2))),
    }
    del ref_out, ref_mine, grads, grads2, out, out2
    check_s = time.perf_counter() - t_start
    opt = torch.optim.Adam([*mine, router], lr=MOE["lr"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    cf = MOE["capacity_factor"]

    def step():
        opt.zero_grad(set_to_none=True)
        loss, out, aux = moe_loss(mine, router, x, mesh, cf, total)
        loss.backward()
        opt.step()
        return (moe_global(loss, out, total, mesh),
                {k: v.detach() for k, v in aux.items()})

    fa.reset_launches()
    first, first_aux = step()
    t0 = time.perf_counter()
    trained = [step() for _ in range(MOE["steps"])]
    losses = [float(l) for l, _ in trained]  # the reads fence the steps
    dt = time.perf_counter() - t0
    launches = {n: c for n, c in fa.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    with timed_calls(moe, "_all_to_all", device) as exchanges:
        t1 = time.perf_counter()
        float(step()[0])
        split_s = time.perf_counter() - t1
    return {
        "world": world, "backend": backend, "rank": rank,
        "tokens_per_rank": shard, "dense": dense,
        "first_loss": float(first), "losses": losses,
        "drop_fraction": [float(first_aux["drop_fraction"])]
        + [float(a["drop_fraction"]) for _, a in trained],
        "load_balance_loss": [float(first_aux["load_balance_loss"])]
        + [float(a["load_balance_loss"]) for _, a in trained],
        "launches": launches,
        "step_ms": 1e3 * dt / MOE["steps"],
        "tokens_s": MOE["steps"] * shard * world / dt,
        "base_bytes": base if cuda else None, "peak_bytes": peak,
        "all_to_all_share": sum(s for _, s in exchanges) / split_s,
        "all_to_all_calls": len(exchanges),
        "sections_s": {"check_s": check_s,
                       "run_s": time.perf_counter() - t_start},
    }


def moe_verdict(rec: dict) -> None:
    what = f"moe at world {rec['world']} ({rec['backend']}, rank {rec['rank']})"
    dense = rec["dense"]
    log(f"{what}: against the dense routing at capacity factor "
        f"{MOE['dense_capacity_factor']}: out rel {dense['out_rel']:.3e} "
        f"(limit {MOE_OUT_RTOL}), loss rel {dense['loss_rel']:.3e}, worst "
        f"grad rel {dense['worst_grad_rel']:.3e} (limit {MOE_GRAD_RTOL}), drop "
        f"fraction {dense['drop_fraction']}, two runs bitwise "
        f"{dense['bitwise']}; at {MOE['capacity_factor']}: loss "
        f"{rec['first_loss']:.6f} -> {rec['losses'][-1]:.6f}, drop fractions "
        f"{rec['drop_fraction']}, aux losses {rec['load_balance_loss']}; step "
        f"{rec['step_ms']:.2f} ms, {rec['tokens_s']:.1f} tokens/s, "
        f"{rec['all_to_all_share']:.3f} of a step in the all-to-alls; port "
        f"kernels launched {rec['launches']}; peak {rec['peak_bytes']} bytes "
        f"over {rec['base_bytes']}")
    require(dense["out_rel"] <= MOE_OUT_RTOL
            and dense["loss_rel"] <= MOE_OUT_RTOL
            and dense["worst_grad_rel"] <= MOE_GRAD_RTOL,
            f"{what}: output, loss or gradients disagree with the dense routing")
    require(dense["drop_fraction"] == 0.0,
            f"{what}: {dense['drop_fraction']} dropped at capacity factor "
            f"{MOE['dense_capacity_factor']}")
    require(dense["bitwise"], f"{what}: two runs differ")
    require(all(math.isfinite(x) for x in [rec["first_loss"], *rec["losses"]])
            and rec["losses"][-1] < rec["first_loss"],
            f"{what}: the loss is not finite or did not fall")
    # the experts' products are torch.matmul, as the JAX package's are
    # plain dots: no port kernel is on this path
    require(not rec["launches"], f"{what}: port kernels launched "
            f"{rec['launches']}")


def moe_rank(rank, world, port, out_path, device_type, config) -> None:
    """One rank of the world-``world`` experts over gloo; its record to
    ``out_path``."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    globals().update(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = _rank_device(device_type)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    rec = moe_run(device, make_mesh({"ep": world}), "gloo")
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(rec))


def phase_moe(device) -> dict:
    """Expert parallelism at full width in f32 (MOE): world 1 over NCCL in
    this process (one expert, every token to it: the dense routing is the
    plain MLP), then world 2 over gloo in two processes on the one card
    (2 experts), each held by ``moe_verdict``. gloo must take the card's
    tensors for the all-to-all and the all-reduce, or the phase fails. On
    the CPU the same runs go over gloo."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    rec = {"shape": f"{MOE['batch'] * MOE['seq']} tokens a rank of width "
                    f"{MODEL['d_model']}, experts {MODEL['d_model']} -> "
                    f"{4 * MODEL['d_model']} -> {MODEL['d_model']}, f32, "
                    f"top_k {MOE['top_k']}", "runs": []}
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        run = moe_run(device, make_mesh({"ep": 1}), backend)
    finally:
        dist.destroy_process_group()
    moe_verdict(run)
    rec["runs"].append(run)
    sections = {"world1_s": time.perf_counter() - t0}
    rec["gloo_takes_device_tensors"] = require_gloo_takes(device, MOE_OPS, "moe")
    sections["probe_s"] = time.perf_counter() - t0 - sum(sections.values())
    config = {"MODEL": MODEL, "MOE": MOE, "TRAIN": TRAIN, "SEED": SEED}
    for run in run_world2(moe_rank, device, "moe", config, MOE_RANK_LIMIT_S):
        moe_verdict(run)
        rec["runs"].append(run)
    sections["world2_s"] = time.perf_counter() - t0 - sum(sections.values())
    rec["phase_s"] = time.perf_counter() - t0
    rec["sections_s"] = sections
    log(f"moe: worlds {[run['world'] for run in rec['runs']]}; phase "
        f"{rec['phase_s']:.1f} s {sections}; the ranks' "
        f"{[run['sections_s'] for run in rec['runs']]}")
    return rec


def moe_summary(rec: dict, nvidia_smi: str) -> dict:
    """The phase's line: each rank's step ms, tokens/s, all-to-all share,
    peak memory, drop fractions and aux losses, and its gaps to the dense
    routing."""
    return {"moe": {
        "shape": rec["shape"],
        "runs": [{k: run[k] for k in (
            "world", "backend", "rank", "step_ms", "tokens_s",
            "all_to_all_share", "peak_bytes", "drop_fraction",
            "load_balance_loss")}
                 | {k: run["dense"][k] for k in ("out_rel", "worst_grad_rel")}
                 for run in rec["runs"]],
        "phase_s": rec["phase_s"]}, "nvidia_smi": nvidia_smi}


def twoterm_step(device, tokens, targets, max_len) -> dict:
    """One full-width training step (forward, backward, Adam) from fresh
    seeded weights with RAYDP_TPU_FLASH_ONEPASS=0, counts zeroed just
    before and read just after: flash_fwd_twoterm launches once per layer
    and flash_fwd never; the loss and the updated parameters are bitwise
    equal to the same step on the one-pass body."""
    runs = {}
    for value in ("1", "0"):
        model = lm("flash", device, max_len)
        opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
        with onepass_env(value):
            fa.reset_launches()
            loss = train_step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
        runs[value] = (loss, {n: p.detach().clone()
                              for n, p in model.named_parameters()}, launches)
        del model, opt
    (loss, params, _), (two_loss, two_params, launches) = runs["1"], runs["0"]
    bitwise = torch.equal(two_loss, loss) and all(
        torch.equal(two_params[n], p) for n, p in params.items())
    log(f"two-term step at full width (RAYDP_TPU_FLASH_ONEPASS=0): launches "
        f"{launches}; loss and updated parameters bitwise equal to the "
        f"one-pass step: {bitwise}")
    layers = MODEL["num_layers"]
    require(launches["flash_fwd_twoterm"] == layers and launches["flash_fwd"] == 0
            and launches["flash_bwd_dq"] == layers
            and launches["flash_bwd_dkv"] == layers,
            "the two-term body did not run on the training path")
    require(bitwise, "the two-term step differs from the one-pass step")
    return {"launches": launches, "loss": float(two_loss), "bitwise": bitwise}


def remat_memory(device, tokens, targets, max_len) -> dict:
    """Peak device memory of one forward+backward with remat off and on,
    from the same weights; the same loss and gradients within 1e-3."""
    peaks, runs = {}, {}
    for remat in (False, True):
        model = lm("flash", device, max_len, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[remat] = loss_and_grads(model, tokens, targets)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        del model
    (loss, grads), (r_loss, r_grads) = runs[False], runs[True]
    worst, bitwise = grad_gap(r_grads, grads)
    loss_rel = abs(float(r_loss) - float(loss)) / abs(float(loss))
    bitwise = bitwise and torch.equal(r_loss, loss)
    log(f"remat: peak {peaks[False] / 2**30:.3f} GiB -> {peaks[True] / 2**30:.3f} "
        f"GiB; loss rel {loss_rel:.2e}, worst grad rel {worst:.2e} (limit "
        f"1e-3), bitwise {bitwise}")
    require(peaks[True] < peaks[False], "remat did not lower peak memory")
    require(loss_rel <= 1e-3 and worst <= 1e-3, "remat changed loss or gradients")
    return {"peak_bytes": peaks[False], "remat_peak_bytes": peaks[True],
            "loss_rel": loss_rel, "worst_grad_rel": worst, "bitwise": bitwise}


def grad_check(device, max_len) -> dict:
    """At T = GRAD_CHECK_T, one step's loss and gradients through the
    kernels against the plain attention path from the same weights
    (|dloss| <= 5e-2, per tensor ||g - g_full|| / ||g_full|| <= 5e-2); then
    the same step with RAYDP_TPU_FLASH_ONEPASS=0 through flash_fwd_twoterm,
    bitwise equal to the one-pass step."""
    tokens, targets = train_tokens(TRAIN["batch"], GRAD_CHECK_T,
                                   MODEL["vocab_size"], device)
    full = lm("full", device, max_len)
    ref_loss, ref_grads = loss_and_grads(full, tokens, targets)
    del full
    flash = lm("flash", device, max_len)
    loss, grads = loss_and_grads(flash, tokens, targets)
    dloss = abs(float(loss) - float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    log(f"grad check (T {GRAD_CHECK_T}) vs plain attention path: |dloss| "
        f"{dloss:.3e}, worst grad rel {worst:.3e} (limits 5e-2)")
    require(dloss <= 5e-2 and worst <= 5e-2, "gradients disagree with the plain path")

    with onepass_env("0"):
        fa.reset_launches()
        two_loss, two_grads = loss_and_grads(flash, tokens, targets)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
    _, bitwise = grad_gap(two_grads, grads)
    bitwise = bitwise and torch.equal(two_loss, loss)
    log(f"two-term step (RAYDP_TPU_FLASH_ONEPASS=0): launches {launches}; "
        f"loss and gradients bitwise equal to the one-pass step: {bitwise}")
    require(launches["flash_fwd_twoterm"] == MODEL["num_layers"]
            and launches["flash_fwd"] == 0, "the two-term body did not run")
    require(bitwise, "the two-term step differs from the one-pass step")
    return {"dloss": dloss, "worst_grad_rel": worst,
            "twoterm_launches": launches, "twoterm_bitwise": bitwise}


def phase_train_int8(device, bf16_first_loss: float) -> dict:
    """bench.py's make_runner("flash", quantized_mlp=True): the training
    phase's model, tokens and Adam with both MLP products of every block
    through the int8 product (int8 forward, straight-through backward). One
    warm step and 8 timed steps, counts zeroed just before and read just
    after: int8_gemm launches twice per block per step (forward only), K5
    never; the loss falls; the first step's loss within 1e-2 relative of the
    bf16 model's from the same seeded weights. mfu_int8_mlp as bench.py
    reports it: the same lm_train_flops_per_step over the bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    vocab = MODEL["vocab_size"]
    tokens, targets = train_tokens(b, t, vocab, device)
    model = lm("flash", device, t + 1, quantized_mlp=True)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    qz.reset_launches()
    first, losses, dt = timed_steps(model, opt, tokens, targets, steps)
    launches = dict(qz.LAUNCHES)
    per_step = launches["int8_gemm"] / (steps + 1)
    rel = abs(first - bf16_first_loss) / abs(bf16_first_loss)
    log(f"train int8 MLP: loss {first:.4f} (warm step; bf16 model {bf16_first_loss:.4f}, "
        f"rel {rel:.2e}, limit 1e-2) -> {losses[-1]:.4f} after {steps} more; "
        f"launches {launches}, int8_gemm per step {per_step}")
    require(all(math.isfinite(x) for x in [first, *losses]), "int8 loss not finite")
    require(losses[-1] < first, "int8 loss did not fall")
    require(per_step == 2 * MODEL["num_layers"],
            f"int8_gemm per step {per_step}, expected {2 * MODEL['num_layers']}")
    require(launches["quantize_int8_stochastic"] == 0,
            "stochastic rounding ran on the int8 MLP path")
    require(launches["quantize_int8"] == launches["int8_gemm"],
            f"int8 MLP training: {launches['quantize_int8']} quantize launches "
            f"for {launches['int8_gemm']} products")
    require(rel <= 1e-2, "the int8 model's first loss is off the bf16 model's")
    flops = lm_train_flops_per_step(b, t, MODEL["d_model"], MODEL["num_layers"],
                                    vocab)
    tok_s = steps * b * t / dt
    out = {
        "shape": f"batch {b}, T {t}, bf16, int8 MLP, {MODEL}",
        "first_loss": first, "bf16_first_loss": bf16_first_loss,
        "first_loss_rel": rel, "losses": losses, "launches": launches,
        "tokens_s": tok_s, "step_ms": 1e3 * dt / steps,
        "mfu_int8_mlp": tok_s * flops / (b * t) / PEAK_OPS_S["bf16"],
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, tokens, targets).item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)
    prof_out = out["profile"]
    log(f"train int8 MLP: {tok_s:.1f} tokens/s, step {out['step_ms']:.2f} ms, "
        f"mfu_int8_mlp {out['mfu_int8_mlp']:.4f} (bf16 peak 989 TFLOP/s); "
        f"profiled step: wall {prof_out['wall_ms']:.1f} ms, device busy "
        f"{prof_out['device_busy_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"]))
    return out


def phase_stochastic(device) -> dict:
    """K5's path, its own entry point as a user calls it: quantize_int8(x,
    seed=step, stochastic=True) for STOCHASTIC_SEEDS steps on the training
    step's two MLP activation shapes, counts zeroed just before and read
    just after, every call held to check_quantized."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    xs = [_randn(gen, shape, torch.float32, device)
          for shape in (QUANT_SHAPES["fc1"], QUANT_SHAPES["fc2"])]
    qz.reset_launches()
    calls = [check_quantized(x, *quantize_int8(x, seed=step, stochastic=True),
                             f"step {step}")
             for step in range(STOCHASTIC_SEEDS) for x in xs]
    torch.cuda.synchronize()
    launches = dict(qz.LAUNCHES)
    worst = max(abs(c["bias"]) / c["quantum"] for c in calls)
    log(f"stochastic rounding through quantize_int8: {STOCHASTIC_SEEDS} seeds x "
        f"{[tuple(x.shape) for x in xs]}, launches {launches}; worst "
        f"|mean(dequant - x)| / quantum {worst:.2e} (limit 0.1)")
    require(launches["quantize_int8_stochastic"] == STOCHASTIC_SEEDS * len(xs),
            f"K5 launched {launches['quantize_int8_stochastic']} times")
    return {"launches": launches, "worst_bias_of_quantum": worst}


# ---------------------------------------------------------------------------
# phase 4, continued: DLRM training through the estimator at full width
# ---------------------------------------------------------------------------


def dlrm_columns(run: dict = None, model: dict = None):
    """bench.py's input form (its ``make_criteo_frame``): dense from
    rng.random, ids from rng.integers per table, default_rng(11); the label
    is the parity of the vocab-100 id c5, a signal the embedding can learn
    (random labels would leave the loss flat). Returns the columns by name
    and the dense and categorical names."""
    run = DLRM_RUN if run is None else run
    model = DLRM_MODEL if model is None else model
    rng = np.random.default_rng(run["data_seed"])
    n = run["rows"]
    dense = rng.random((n, model["num_dense"])).astype(np.float32)
    ids = np.stack([rng.integers(0, v, n) for v in model["vocab_sizes"]],
                   axis=1).astype(np.int32)
    dense_cols = [f"i{i}" for i in range(dense.shape[1])]
    cat_cols = [f"c{j}" for j in range(ids.shape[1])]
    columns = {c: dense[:, i] for i, c in enumerate(dense_cols)}
    columns.update({c: ids[:, j] for j, c in enumerate(cat_cols)})
    columns["label"] = (ids[:, 5] % 2).astype(np.float32)
    return columns, dense_cols, cat_cols


def dlrm_data():
    """``dlrm_columns`` for 100,000 rows in 4 blocks (bench.py's
    ``make_criteo_frame(parts=4)``)."""
    columns, dense_cols, cat_cols = dlrm_columns()
    n, blocks = DLRM_RUN["rows"], DLRM_RUN["blocks"]
    return (ArrayDataset(columns, [n // blocks] * blocks), dense_cols,
            cat_cols)


def final_state(est) -> dict:
    """A fitted estimator's parameters, copied to the host."""
    return {name: t.detach().cpu().clone()
            for name, t in est.get_model().state_dict().items()}


def dlrm_estimator(device, dense_cols, cat_cols, optimizer, epochs, **kw):
    settings = dict(batch_size=DLRM_RUN["batch"], learning_rate=DLRM_RUN["lr"],
                    seed=SEED)
    settings.update(kw)
    return Estimator(
        model=functools.partial(DLRM, **DLRM_MODEL), optimizer=optimizer,
        loss="bce", feature_columns=dense_cols + cat_cols,
        categorical_columns=cat_cols, label_column="label",
        num_epochs=epochs, device=device, **settings)


def dlrm_flops_per_step(batch: int) -> int:
    """Matmul FLOPs of one DLRM step: the bottom MLP with bottom_proj and
    the top MLP with the head (mlp_train_flops_per_step), and the
    interaction's triangle, 2 * D per pair, the backward twice the
    forward."""
    m = DLRM_MODEL
    features = 1 + len(m["vocab_sizes"])
    pairs = features * (features - 1) // 2
    bottom = [m["num_dense"], *m["bottom_mlp"], m["embed_dim"]]
    top = [m["embed_dim"] + pairs, *m["top_mlp"], 1]
    return (mlp_train_flops_per_step(batch, bottom)
            + mlp_train_flops_per_step(batch, top)
            + 3 * 2 * batch * pairs * m["embed_dim"])


def dlrm_counted_flops(batch: int) -> int:
    """``count_flops`` of one staged DLRM step on the card: what
    ``FlopCounterMode`` counts (the MLPs forward and backward, but not the
    input gradient of the bottom MLP's first layer, whose input is data;
    the interaction's backward, one bmm of [B, F, F] by [B, F, D]) plus
    K1's report, 2 * D a pair computed. ``dlrm_flops_per_step`` takes the
    interaction as three times its forward instead, and that first layer's
    input gradient."""
    m = DLRM_MODEL
    features = 1 + len(m["vocab_sizes"])
    k1 = 2 * m["embed_dim"] * batch * features * (features - 1) // 2
    return (dlrm_flops_per_step(batch) - 2 * k1
            + 2 * batch * features * features * m["embed_dim"]
            - 2 * batch * m["num_dense"] * m["bottom_mlp"][0])


def phase_dlrm(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    ds, dense_cols, cat_cols = dlrm_data()
    rows, batch = DLRM_RUN["rows"], DLRM_RUN["batch"]
    steps = rows // batch
    eval_batches = -(-rows // batch)
    epochs = DLRM_RUN["epochs"]

    est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # earlier phases leave allocations (cuBLAS workspaces): count the fit's
    base = torch.cuda.memory_allocated()
    ia.reset_launches()
    history = est.fit(ds)
    evaluation = est.evaluate(ds)
    torch.cuda.synchronize()
    launches = ia.LAUNCHES["interaction_fwd"]
    peak = torch.cuda.max_memory_allocated() - base
    losses = [r["train_loss"] for r in history]
    forwards = epochs * steps + eval_batches
    log(f"dlrm fit: train_loss {losses}, evaluate {evaluation}; "
        f"interaction_fwd launches {launches} for {forwards} forward passes")
    require(all(math.isfinite(x) for x in losses + [evaluation["eval_loss"]]),
            "DLRM loss not finite")
    require(losses[-1] < 0.9 * losses[0], "DLRM loss did not fall by 10%")
    require(launches == forwards,
            f"interaction_fwd launched {launches} times, expected {forwards}")
    timed = history[1:]
    seconds = sum(r["epoch_seconds"] for r in timed)
    sps = len(timed) * steps * batch / seconds
    step_ms = 1e3 * seconds / (len(timed) * steps)
    flops = dlrm_flops_per_step(batch)
    out = {
        "shape": f"{DLRM_MODEL}, {rows} rows, batch {batch}, f32",
        "train_loss": losses, "evaluate": evaluation, "launches": launches,
        "forward_passes": forwards, "epoch_seconds":
            [r["epoch_seconds"] for r in history],
        "samples_s": sps, "step_ms": step_ms, "peak_bytes": peak,
        "flops_per_step": flops,
        "counted_flops_per_step": est.fit_stats_["flops_per_step"],
        "mfu": flops / (step_ms / 1e3) / PEAK_OPS_S["f32"],
        # phase_store's fit from store blocks is held to these bit for bit
        # (main takes the tensors out before the record is written)
        "final_state": final_state(est),
    }

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dlrm_estimator(device, dense_cols, cat_cols, "adam", 1).fit(ds)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    out["profile"] = device_share(prof, wall_ms)

    ia.reset_launches()
    opt_history = dlrm_estimator(device, dense_cols, cat_cols,
                                 dlrm_optimizer(), 1).fit(ds)
    torch.cuda.synchronize()
    out["dlrm_optimizer"] = {"train_loss": opt_history[0]["train_loss"],
                             "launches": ia.LAUNCHES["interaction_fwd"]}
    require(math.isfinite(opt_history[0]["train_loss"]),
            "dlrm_optimizer loss not finite")
    require(out["dlrm_optimizer"]["launches"] == steps,
            "interaction_fwd did not run once per dlrm_optimizer step")
    out["grad_check"] = dlrm_grad_check(device, ds, dense_cols, cat_cols)
    prof_out = out["profile"]
    log(f"dlrm: {sps:.1f} samples/s, step {step_ms:.3f} ms, MFU "
        f"{out['mfu']:.2e} (f32 peak 67 TFLOP/s, {flops:.3e} FLOP/step), "
        f"peak memory of the fit {peak / 2**20:.1f} MiB; profiled epoch (fit of one "
        f"epoch, staging included): wall {prof_out['wall_ms']:.1f} ms, device "
        f"busy {prof_out['device_busy_ms']} ms; top: "
        + "; ".join(f"{n[:50]} {ms:.2f}" for n, ms in prof_out["top_device_ms"])
        + f"; dlrm_optimizer epoch {out['dlrm_optimizer']}")
    return out


def dlrm_grad_check(device, ds, dense_cols, cat_cols) -> dict:
    """One step's loss and every gradient through the kernel against the
    einsum path (use_pallas_interaction=False), from the same weights, on
    the first batch: f32, 1e-5 relative."""
    dense, ids = (torch.from_numpy(a[:DLRM_RUN["batch"]]).to(device)
                  for a in ds.to_numpy_grouped(
                      [(dense_cols, np.float32), (cat_cols, np.int32)])[0])
    labels = torch.from_numpy(
        ds.columns["label"][:DLRM_RUN["batch"]]).to(device)
    runs = {}
    for use_kernel in (None, False):
        model = DLRM(**DLRM_MODEL, use_pallas_interaction=use_kernel,
                     device=device, seed=SEED)
        loss = F.binary_cross_entropy_with_logits(
            model((dense, ids)).reshape(-1), labels)
        loss.backward()
        runs[use_kernel] = (loss.detach(), {n: p.grad for n, p in
                                            model.named_parameters()})
    (loss, grads), (ref_loss, ref_grads) = runs[None], runs[False]
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst, _ = grad_gap(grads, ref_grads)
    log(f"dlrm step through the kernel vs the einsum path: loss rel "
        f"{loss_rel:.2e}, worst grad rel {worst:.2e} (limits 1e-5)")
    require(loss_rel <= 1e-5 and worst <= 1e-5,
            "DLRM gradients through the kernel disagree with the einsum path")
    return {"loss_rel": loss_rel, "worst_grad_rel": worst}


# ---------------------------------------------------------------------------
# phase 4, continued: the object store and block service, and the DLRM fit
# fed from store blocks
# ---------------------------------------------------------------------------

STORE_CLUSTER = dict(num_cpus=4)
STORE_LIMIT_S = 120.0  # the whole phase
STORE_DEADLINE_S = 10.0  # kill to unlink, a producer's death, shutdown
# put and get through the store's host memory: 4 blocks of 256 MiB
STORE_BENCH = dict(blocks=4, block_bytes=256 << 20, seed=13)
# what phase_store's summary line prints (the record holds more)
STORE_KEYS = ("blocks", "block_bytes", "write_s", "columns_ms",
              "columns_split_ms", "zero_copy", "fit_bitwise", "launches",
              "kill_to_unlink_s", "lost_reads", "handoff_fit_bitwise",
              "put_gb_s", "get_gb_s", "copy_gb_s", "bench_tier",
              "shm_bytes_peak", "driver_exit_leaks", "phase_s")


class StoreProducer:
    """A producer actor of ``phase_store``: writes ``dlrm_columns(run)``
    into the port's store as Arrow IPC streams, one block per block of the
    run, through ``create_block(...).arrow_sink()`` and ``seal`` (the JAX
    package's ETL writes its blocks so, ``raydp_tpu/etl/tasks.py:62``).
    With ``handoff`` its blocks go to the namespace's block service."""

    def __init__(self, handoff: bool = False):
        from raydp_tpu_torch.store import object_store

        object_store.set_block_service(handoff)

    def write_blocks(self, run: dict, model: dict) -> list:
        import pyarrow as pa

        from raydp_tpu_torch import store

        columns, _, _ = dlrm_columns(run, model)
        table = pa.table(columns)
        rows = run["rows"] // run["blocks"]
        refs = []
        for i in range(run["blocks"]):
            piece = table.slice(i * rows, rows)
            block = store.create_block(piece.nbytes + (64 << 10))
            sink = block.arrow_sink()
            with pa.ipc.new_stream(sink, piece.schema) as writer:
                writer.write_table(piece)
            refs.append(block.seal(sink.tell()))
        return refs

    def pid(self) -> int:
        return os.getpid()


def store_columns(store, refs) -> tuple:
    """The fit's dataset from store blocks: their locations in one head
    round trip (``lookup_many``), each block mapped and decoded
    (``read_arrow_batches``), its columns numpy views of the mapping where
    Arrow allows it (one batch a block, no nulls), then
    ``ArrayDataset.from_blocks`` (the one copy). Returns the dataset, the
    ms of each of the three steps and whether every column was a view."""
    t0 = time.perf_counter()
    metas = store.object_store.lookup_many(refs)
    t1 = time.perf_counter()
    blocks, views = [], True
    for ref in refs:
        schema, batches = store.read_arrow_batches(ref, meta=metas[ref.object_id])
        if len(batches) == 1:
            cols = {name: batches[0].column(i).to_numpy(zero_copy_only=True)
                    for i, name in enumerate(schema.names)}
            views &= all(not c.flags.owndata and not c.flags.writeable
                         for c in cols.values())
        else:
            views = False
            cols = {name: np.concatenate(
                [b.column(i).to_numpy() for b in batches])
                for i, name in enumerate(schema.names)}
        blocks.append(cols)
    t2 = time.perf_counter()
    ds = ArrayDataset.from_blocks(blocks)
    t3 = time.perf_counter()
    return ds, {"lookup_ms": 1e3 * (t1 - t0), "decode_ms": 1e3 * (t2 - t1),
                "from_blocks_ms": 1e3 * (t3 - t2)}, views


def store_fit(device, store, refs, dense_cols, cat_cols, reference) -> dict:
    """phase_dlrm's fit (3 epochs, then ``evaluate``) from store blocks,
    held bit for bit to ``reference``: the losses, the evaluation, the final
    parameters and K1's launches."""
    ds, split, views = store_columns(store, refs)
    est = dlrm_estimator(device, dense_cols, cat_cols, "adam",
                         DLRM_RUN["epochs"])
    ia.reset_launches()
    history = est.fit(ds)
    evaluation = est.evaluate(ds)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = ia.LAUNCHES["interaction_fwd"]
    state = final_state(est)
    require(all(p.device == device for p in est.get_model().parameters()),
            f"the fit from store blocks did not run on {device}")
    losses = [r["train_loss"] for r in history]
    bitwise = (losses == reference["train_loss"]
               and evaluation == reference["evaluate"]
               and state.keys() == reference["final_state"].keys()
               and all(torch.equal(state[k], reference["final_state"][k])
                       for k in state))
    require(bitwise, f"the fit from store blocks differs from the fit from "
            f"numpy: losses {losses} vs {reference['train_loss']}, evaluate "
            f"{evaluation} vs {reference['evaluate']}")
    require(launches == reference["launches"],
            f"interaction_fwd launched {launches} times from store blocks, "
            f"{reference['launches']} from numpy")
    if device.type == "cuda":
        require(launches > 0, "K1 never launched in the fit from store blocks")
    return {"columns_ms": sum(split.values()), "columns_split_ms": split,
            "zero_copy": views, "train_loss": losses,
            "evaluate": evaluation, "launches": launches, "bitwise": bitwise}


def store_bench(store, profiler) -> dict:
    """put and get of ``STORE_BENCH``'s blocks of host memory: GB/s of
    each, the tier each block landed in, and the namespace's live shm
    bytes with all of them stored; beside them the GB/s of a plain copy of
    the block into fresh host memory (``bytearray``), the yardstick of a
    get, which copies the mapped segment into a new ``bytes``."""
    n = STORE_BENCH["block_bytes"]
    payload = np.random.default_rng(STORE_BENCH["seed"]).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    copy_s = []
    for _ in range(STORE_BENCH["blocks"]):
        t0 = time.perf_counter()
        copied = bytearray(payload)
        copy_s.append(time.perf_counter() - t0)
        del copied
    refs, put_s, get_s, tiers = [], [], [], []
    try:
        for _ in range(STORE_BENCH["blocks"]):
            t0 = time.perf_counter()
            refs.append(store.put(payload))
            put_s.append(time.perf_counter() - t0)
            tiers.append("disk" if store.object_store._lookup(refs[-1])[
                "shm_name"].startswith("file://") else "shm")
        live = profiler.sample_memory(force=True).get("shm_bytes")
        for ref in refs:
            t0 = time.perf_counter()
            data = store.get_bytes(ref)
            get_s.append(time.perf_counter() - t0)
            require(data == payload, "a block read back other bytes")
            del data
    finally:
        store.delete(refs)
    return {"put_gb_s": [n / t / 1e9 for t in put_s],
            "get_gb_s": [n / t / 1e9 for t in get_s],
            "copy_gb_s": [n / t / 1e9 for t in copy_s],
            "bench_tier": tiers, "bench_shm_bytes": live}


def _segments_gone(refs) -> bool:
    return not any(os.path.exists("/dev/shm" + r.shm_name) for r in refs)


def phase_store(device, reference: dict) -> dict:
    """The port's object store and block service on the DLRM cell uncut
    (``DLRM_RUN``'s 100,000 rows in 4 blocks, batch 2048), in a cluster of
    the port with lockdep and the leak audit armed:

    1. a light CPU ``StoreProducer`` actor writes the 4 blocks as Arrow IPC
       streams and their ownership is transferred to the driver;
    2. the driver maps them (``read_arrow_batches``), builds the columns
       (views of the mapping where Arrow allows) and ``from_blocks``, and
       runs phase_dlrm's fit on ``device``: losses, evaluation and final
       parameters bit for bit ``reference``'s (phase_dlrm's fit from numpy),
       and as many K1 launches;
    3. a second producer is SIGKILLed before any transfer: its blocks read
       as lost (``OwnerDiedError``) and the head's owner GC unlinks their
       segments (the time from the kill to the last unlink);
    4. a third producer hands its blocks to a ``BlockService`` and is
       SIGKILLed: the blocks stay readable and the fit from them is bitwise
       step 2's;
    5. put and get GB/s of ``STORE_BENCH``'s blocks, and ``mem.shm_bytes``
       at its peak (reported, not gated);
    6. ``cluster.shutdown()``: no segment of the session left, and the
       driver's leak audit reads 0 shm segments.

    The whole phase takes at most ``STORE_LIMIT_S``."""
    from raydp_tpu_torch import cluster, store
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import DRIVER_OWNER, OwnerDiedError
    from raydp_tpu_torch.cluster.zygote import WARM_TORCH_ENV
    from raydp_tpu_torch.obs import metrics, profiler
    from raydp_tpu_torch.store import block_service

    import pyarrow as pa

    # pyarrow imports pandas at its first conversion: here, not in the
    # timed reads
    pa.array(np.zeros(1))

    here = importlib.import_module("chip_smoke")  # actor classes by reference
    t_phase = time.perf_counter()
    _, dense_cols, cat_cols = dlrm_columns()
    run = {k: DLRM_RUN[k] for k in ("rows", "blocks", "data_seed")}
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", WARM_TORCH_ENV: "1",
             "RAYDP_TPU_SANITIZE": "lockdep,leaks"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    rec: dict = {"blocks": run["blocks"], "rows": run["rows"]}
    try:
        cluster.init(**STORE_CLUSTER)

        # 1. the blocks, written by a producer, owned by the driver
        producer = cluster.spawn(here.StoreProducer, name="store-producer",
                                 light=True)
        t0 = time.perf_counter()
        refs = producer.write_blocks(run, DLRM_MODEL)
        rec["write_s"] = time.perf_counter() - t0
        rec["block_bytes"] = [r.size for r in refs]
        store.transfer(refs, DRIVER_OWNER)
        require({store.owner_of(r) for r in refs} == {DRIVER_OWNER},
                "the blocks' ownership did not move to the driver")
        producer.kill()
        profiler.sample_memory(force=True)

        # 2. the fit from store blocks
        fit = store_fit(device, store, refs, dense_cols, cat_cols, reference)
        rec.update(columns_ms=fit["columns_ms"],
                   columns_split_ms=fit["columns_split_ms"],
                   zero_copy=fit["zero_copy"],
                   fit_bitwise=fit["bitwise"], launches=fit["launches"],
                   train_loss=fit["train_loss"])
        log(f"store: {run['blocks']} blocks of {rec['block_bytes']} bytes "
            f"written in {rec['write_s']:.3f} s, columns from the mapped "
            f"blocks in {fit['columns_ms']:.2f} ms ({fit['columns_split_ms']}; "
            f"views: {fit['zero_copy']}), "
            f"fit bitwise phase_dlrm's, K1 launches {fit['launches']}")

        # 3. the owner's death before any transfer
        doomed = cluster.spawn(here.StoreProducer, name="store-doomed",
                               light=True)
        lost = doomed.write_blocks(run, DLRM_MODEL)
        require(store.get_bytes(lost[0]) == store.get_bytes(refs[0]),
                "a second producer wrote other bytes for the same rows")
        t_kill = time.perf_counter()
        os.kill(doomed.pid(), signal.SIGKILL)
        _wait_for(lambda: _segments_gone(lost), STORE_DEADLINE_S,
                  "the dead owner's segments to be unlinked")
        rec["kill_to_unlink_s"] = time.perf_counter() - t_kill
        errors = []
        for ref in lost:
            try:
                store.get_bytes(ref)
            except OwnerDiedError as exc:
                errors.append(type(exc).__name__)
        require(len(errors) == len(lost),
                f"{len(lost) - len(errors)} of the dead owner's blocks still read")
        rec["lost_reads"] = errors

        # 4. the handoff to a block service, then the producer's death
        service = cluster.spawn(block_service.BlockService, "chip-smoke",
                                name="store-block-service", max_restarts=3,
                                max_concurrency=4, light=True)
        block_service.register_service(service.actor_id)
        handing = cluster.spawn(here.StoreProducer, True, name="store-handoff",
                                light=True)
        kept = handing.write_blocks(run, DLRM_MODEL)
        require({store.owner_of(r) for r in kept} == {service.actor_id},
                "the handoff did not make the block service the owner")
        os.kill(handing.pid(), signal.SIGKILL)
        _wait_for(lambda: handing.state() == cluster.ActorState.DEAD,
                  STORE_DEADLINE_S, "the handing producer's death")
        # bitwise the numpy fit, so bitwise step 2's
        handoff = store_fit(device, store, kept, dense_cols, cat_cols, reference)
        rec["handoff_fit_bitwise"] = handoff["bitwise"]
        rec["handoff_columns_ms"] = handoff["columns_ms"]
        log(f"store: the dead owner's blocks read {set(errors)}, unlinked "
            f"{rec['kill_to_unlink_s']:.3f} s after the kill; the handed-off "
            f"blocks outlived their producer, fit bitwise")

        # 5. put and get through host memory
        bench = store_bench(store, profiler)
        rec.update(bench)
        rec["shm_bytes_peak"] = metrics.gauge("mem.shm_bytes").snapshot()["max"]

        # 6. shutdown: no segment left, the driver's leak audit at 0
        store.delete(refs + kept)
        session_refs = refs + lost + kept
        cluster.shutdown()
        rec["driver_exit_leaks"] = {
            name: snap["value"] for name, snap in metrics.snapshot().items()
            if name.startswith("sanitize.leaked")}
        require(_segments_gone(session_refs),
                "a segment of the session outlived shutdown")
        require(rec["driver_exit_leaks"].get("sanitize.leaked_shm_segments") == 0,
                f"the driver's leak audit: {rec['driver_exit_leaks']}")
    finally:
        if capi.is_initialized():
            cluster.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["phase_s"] = time.perf_counter() - t_phase
    require(rec["phase_s"] <= STORE_LIMIT_S,
            f"phase_store took {rec['phase_s']:.1f} s")
    log(f"store: put {[f'{x:.2f}' for x in rec['put_gb_s']]} GB/s, get "
        f"{[f'{x:.2f}' for x in rec['get_gb_s']]} GB/s ({rec['bench_tier']}; "
        f"a plain copy into fresh memory {[f'{x:.2f}' for x in rec['copy_gb_s']]}), "
        f"mem.shm_bytes peak {rec['shm_bytes_peak']:.0f}, driver exit leaks "
        f"{rec['driver_exit_leaks']}, phase {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 4, continued: bench.py's DLRM cell end to end, ETL query -> store
# blocks -> fit on the card
# ---------------------------------------------------------------------------

# bench.py's bench_dlrm: its session (2 executors of 2 cores and 1G), its
# frame in 4 partitions; the source is DLRM_RUN's rows from default_rng(11)
ETL_SESSION = dict(num_executors=2, executor_cores=2, executor_memory="1G")
ETL_PARTS = 4
ETL_LIMIT_S = 240.0  # the whole phase
ETL_DEADLINE_S = 15.0  # no process or segment of the session after shutdown
# what phase_etl's summary line prints (the record holds more)
ETL_KEYS = ("rows", "blocks", "block_bytes", "init_s", "query_s",
            "query_stats", "ids_bitwise", "label_bitwise", "dense_max_ulp",
            "staged_bitwise", "streamed_bitwise", "executor_decode",
            "launches", "staged_samples_s", "streamed_samples_s",
            "dlrm_samples_s", "executor_pids", "cuda_context_pids",
            "host_cpus", "phase_s")


def make_criteo_source(n_rows: int, model: dict = None):
    """bench.py's ``make_criteo_source`` (the script keeps its own copy):
    default_rng(11); a random label (which ``make_criteo_frame`` replaces),
    the dense columns ``i*`` integers below 1000 as f32, the ids ``c*``
    below each table's vocab as int64."""
    import pandas as pd

    model = DLRM_MODEL if model is None else model
    rng = np.random.default_rng(11)
    data = {"label": rng.integers(0, 2, n_rows).astype(np.float32)}
    for i in range(model["num_dense"]):
        data[f"i{i}"] = rng.integers(0, 1000, n_rows).astype(np.float32)
    for j, vocab in enumerate(model["vocab_sizes"]):
        data[f"c{j}"] = rng.integers(0, vocab, n_rows).astype(np.int64)
    return pd.DataFrame(data)


def make_criteo_frame(session, source, parts: int, model: dict = None):
    """bench.py's ``make_criteo_frame``, with one change: ``label`` becomes
    the parity of the hashed ``c5`` id, computed in the query, so the loss
    can fall (bench's random label leaves it flat; ``dlrm_columns`` uses
    the parity of c5 for the same reason)."""
    from raydp_tpu_torch.etl import functions as Fn

    model = DLRM_MODEL if model is None else model
    df = session.from_pandas(source, num_partitions=parts)
    for i in range(model["num_dense"]):
        df = df.with_column(f"i{i}", Fn.log1p(Fn.col(f"i{i}")).cast("float32"))
    for j, vocab in enumerate(model["vocab_sizes"]):
        df = df.with_column(f"c{j}", Fn.hash(f"c{j}", vocab).cast("int32"))
    return df.with_column("label", (Fn.col("c5") % 2).cast("float32"))


def criteo_expected(source, model: dict = None) -> dict:
    """The query's columns computed here with numpy and pandas: each id
    ``pd.util.hash_array(c) % vocab`` as int32, the label the parity of
    the c5 id as f32, each dense column ``np.log1p`` of the f32 source."""
    import pandas as pd

    model = DLRM_MODEL if model is None else model
    out = {}
    for i in range(model["num_dense"]):
        out[f"i{i}"] = np.log1p(source[f"i{i}"].to_numpy(np.float32))
    for j, vocab in enumerate(model["vocab_sizes"]):
        hashed = pd.util.hash_array(source[f"c{j}"].to_numpy())
        out[f"c{j}"] = (hashed % np.uint64(vocab)).astype(np.int32)
    out["label"] = (out["c5"] % 2).astype(np.float32)
    return out


def f32_ulps(a, b) -> int:
    """The largest distance in f32 units in the last place between two f32
    arrays of finite values (their ordered integer images)."""
    def ordered(x):
        bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
        return np.where(bits < 0, np.int64(-2**31) - bits, bits).astype(np.int64)

    if not len(a):
        return 0
    return int(np.abs(ordered(a) - ordered(b)).max())


def check_etl_columns(ds, expected: dict, rows: int, parts: int) -> dict:
    """The Dataset of the query against ``expected``: ``parts`` blocks and
    ``rows`` rows in the source's order; ids and label bit for bit, each
    dense column within 1 f32 ulp of numpy's ``log1p`` (the largest
    distance is reported)."""
    require(ds.num_blocks == parts,
            f"the query gave {ds.num_blocks} blocks, expected {parts}")
    require(ds.count() == rows, f"the query gave {ds.count()} rows, "
            f"expected {rows}")
    table = ds.to_arrow()
    got = {c: table.column(c).to_numpy() for c in table.column_names}
    ids = [c for c in expected if c.startswith("c")]
    dense = [c for c in expected if c.startswith("i")]
    ids_bitwise = all(got[c].dtype == np.int32
                      and np.array_equal(got[c], expected[c]) for c in ids)
    label_bitwise = (got["label"].dtype == np.float32
                     and np.array_equal(got["label"], expected["label"]))
    require(all(got[c].dtype == np.float32 for c in dense),
            "a dense column is not f32")
    ulps = {c: f32_ulps(got[c], expected[c]) for c in dense}
    require(ids_bitwise, "an id column differs from pd.util.hash_array % vocab")
    require(label_bitwise, "the label differs from the parity of the c5 id")
    require(max(ulps.values()) <= 1,
            f"log1p differs from numpy's by more than 1 ulp: {ulps}")
    return {"ids_bitwise": ids_bitwise, "label_bitwise": label_bitwise,
            "dense_max_ulp": max(ulps.values()), "dense_ulps": ulps}


def blocks_as_arrays(ds):
    """An ``ArrayDataset`` of the Dataset's columns in its blocks (each
    block read and decoded to numpy)."""
    blocks = []
    for i in range(ds.num_blocks):
        table = ds.get_block(i)
        blocks.append({c: table.column(c).to_numpy() for c in table.column_names})
    return ArrayDataset.from_blocks(blocks)


def etl_fit(device, fit, epochs: int, **kw) -> dict:
    """One DLRM fit of ``epochs`` (``fit(est)`` runs it), K1's launches
    counted from 0 around it: its losses, evaluation (None when
    ``fit`` evaluates nothing), final parameters, launches and samples/s
    over the epochs after the first."""
    dense_cols = [f"i{i}" for i in range(DLRM_MODEL["num_dense"])]
    cat_cols = [f"c{j}" for j in range(len(DLRM_MODEL["vocab_sizes"]))]
    est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
    ia.reset_launches()
    history, evaluation = fit(est)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = ia.LAUNCHES["interaction_fwd"]
    require(all(p.device == device for p in est.get_model().parameters()),
            f"the fit did not run on {device}")
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]
    timed = history[1:] or history
    seconds = sum(r["epoch_seconds"] for r in timed)
    return {"train_loss": [r["train_loss"] for r in history],
            "evaluate": evaluation, "final_state": final_state(est),
            "launches": launches,
            "samples_s": len(timed) * steps * DLRM_RUN["batch"] / seconds,
            "stream_stats": dict(est.stream_stats_)}


def require_same_fit(got: dict, ref: dict, what: str) -> bool:
    """Every loss, the evaluation and every parameter equal, bit for bit,
    and as many K1 launches."""
    same = (got["train_loss"] == ref["train_loss"]
            and got["evaluate"] == ref["evaluate"]
            and got["final_state"].keys() == ref["final_state"].keys()
            and all(torch.equal(got["final_state"][k], ref["final_state"][k])
                    for k in got["final_state"]))
    require(same, f"{what}: losses {got['train_loss']} vs {ref['train_loss']}, "
            f"evaluate {got['evaluate']} vs {ref['evaluate']}, or a parameter "
            "differs")
    require(got["launches"] == ref["launches"],
            f"{what}: interaction_fwd launched {got['launches']} times, "
            f"{ref['launches']} in the fit it is held to")
    return same


def executor_cuda_report(session) -> dict:
    """The executors' pids and CUDA state, from a ``map_batches`` probe in
    4 partitions per executor slot (one row each: the process's pid, and
    whether torch is imported there with ``torch.cuda.is_initialized()``),
    and the pids with a CUDA context on the card
    (``nvidia-smi --query-compute-apps=pid``) among the session's
    processes; this driver's own pid is left out."""
    from raydp_tpu_torch.cluster import api as capi

    def probe(table):  # pickled by value: the executors import nothing here
        import os
        import sys

        import pyarrow as pa

        torch_mod = sys.modules.get("torch")
        held = bool(torch_mod is not None and torch_mod.cuda.is_initialized())
        return pa.table({"pid": [os.getpid()], "cuda": [held]})

    slots = ETL_SESSION["num_executors"] * ETL_SESSION["executor_cores"]
    seen = session.range(4 * slots, num_partitions=4 * slots).map_batches(
        probe).to_pandas()
    pids = sorted(set(int(p) for p in seen["pid"]))
    require(os.getpid() not in pids, "the probe ran in the driver")
    require(not seen["cuda"].any(),
            f"an ETL executor holds a CUDA context: {seen.to_dict('list')}")
    session_pids = set(_session_procs(capi.session_dir())) | set(pids)
    holders = sorted(session_pids & set(cuda_context_pids()))
    require(not holders, f"processes of the ETL session hold a CUDA context "
            f"on the card: {holders}")
    return {"executor_pids": pids, "session_pids": sorted(session_pids),
            "cuda_context_pids": holders}


def cuda_context_pids() -> list:
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists (no card:
    none)."""
    if not torch.cuda.is_available():
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [int(line) for line in out.split() if line.strip().isdigit()]


def etl_teardown(session_dirs: list, pids: list) -> dict:
    """After ``cluster.shutdown()``: within ``ETL_DEADLINE_S`` no process
    of the sessions and none of ``pids`` alive, and no ``rtpt-`` segment
    of this process's shm namespace (the phase's alone)."""
    from raydp_tpu_torch.cluster.common import _probe_pid

    t0 = time.perf_counter()
    _wait_for(lambda: not any(_session_procs(d) for d in session_dirs)
              and not any(_probe_pid(p) == "alive" for p in pids),
              ETL_DEADLINE_S, f"the ETL session's processes {pids} to exit")
    gone_s = time.perf_counter() - t0
    _wait_for(lambda: not _rtpt_segments(), ETL_DEADLINE_S,
              "the ETL session's segments to be unlinked")
    return {"gone_after_shutdown_s": gone_s,
            "segments_left": sorted(_rtpt_segments())}


def phase_etl(device, dlrm: dict = None) -> dict:
    """bench.py's DLRM cell end to end on the port (``bench_dlrm``): the ETL
    query, its blocks in the store, the fit on ``device`` (K1 on the card).
    In a cluster of the port with the session-local zygote and its own shm
    namespace:

    1. ``init_etl("smoke-etl", 2 executors, 2 cores, 1G)``; the source
       (``make_criteo_source``, ``DLRM_RUN``'s rows), ``make_criteo_frame``
       in 4 partitions (the label the parity of the hashed c5),
       ``dataframe_to_dataset(df, _use_owner=True)``, then
       ``stop_etl(cleanup_data=False, del_obj_holder=False)``;
    2. 4 blocks and every row; ids and label bit for bit those numpy and
       pandas give, dense within 1 ulp of ``np.log1p`` (reported);
    3. phase_dlrm's staged fit (3 epochs, then ``evaluate``) from the
       ``Dataset``, bit for bit (losses, evaluation, parameters) the same fit
       from an ``ArrayDataset`` of its blocks' columns, with one
       ``interaction_fwd`` launch a forward pass;
    4. on a second session, alive through the fit, ``fit_on_etl`` of the
       same query with ``streaming=True``: the spans decoded on the
       executors (``stream_stats_["executor_decode"]``), bit for bit the
       streamed fit from the ``ArrayDataset``; no process of the session
       holds a CUDA context (each executor's own report, and
       ``nvidia-smi``'s compute apps); ``stop_etl``;
    5. the master actor killed, ``cluster.shutdown()``: no process of the
       sessions left, no ``rtpt-`` segment of the namespace.

    Host numbers (seconds, bytes, samples/s) are printed beside the card's
    name, its power limit and the host's CPU count. The whole phase takes
    at most ``ETL_LIMIT_S``."""
    import raydp_tpu_torch as rt
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV
    from raydp_tpu_torch.etl import session as etl_session
    from raydp_tpu_torch.etl.session import MASTER_ACTOR_SUFFIX

    t_phase = time.perf_counter()
    rows, parts = DLRM_RUN["rows"], ETL_PARTS
    steps = rows // DLRM_RUN["batch"]
    epochs = DLRM_RUN["epochs"]
    forwards = epochs * steps + -(-rows // DLRM_RUN["batch"])
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1",
             SHM_NS_ENV: f"etl{os.getpid()}"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    rec: dict = {"rows": rows, "host_cpus": os.cpu_count(),
                 "label": "parity of the hashed c5 (bench.py: random)"}
    sessions, pids = [], []
    try:
        source = make_criteo_source(rows)
        expected = criteo_expected(source)

        # 1. the query, its blocks transferred to the master actor
        t0 = time.perf_counter()
        session = rt.init_etl("smoke-etl", **ETL_SESSION)
        rec["init_s"] = time.perf_counter() - t0
        sessions.append(capi.session_dir())
        t0 = time.perf_counter()
        ds = rt.dataframe_to_dataset(
            make_criteo_frame(session, source, parts), _use_owner=True)
        stats = session.last_query_stats
        rt.stop_etl(cleanup_data=False, del_obj_holder=False)
        rec["query_s"] = time.perf_counter() - t0
        rec["query_stats"] = {k: stats.get(k) for k in (
            "seconds", "stages", "output_partitions", "fusion", "plan_cache")}
        rec["blocks"] = ds.num_blocks
        rec["block_bytes"] = [b.size for b in ds.blocks]
        log(f"etl: init_etl {rec['init_s']:.3f} s, query and conversion "
            f"{rec['query_s']:.3f} s ({rec['query_stats']}), blocks "
            f"{rec['block_bytes']} bytes")

        # 2. the columns against numpy and pandas
        rec.update(check_etl_columns(ds, expected, rows, parts))

        # 3. the staged fit from the Dataset and from its blocks as numpy
        arrays = blocks_as_arrays(ds)

        def staged(data):
            def fit(est):
                return est.fit(data), est.evaluate(data)
            return fit

        from_ds = etl_fit(device, staged(ds), epochs)
        from_arrays = etl_fit(device, staged(arrays), epochs)
        rec["staged_bitwise"] = require_same_fit(
            from_ds, from_arrays, "the staged fit from the ETL Dataset")
        rec["launches"] = from_ds["launches"]
        if device.type == "cuda":
            require(from_ds["launches"] == forwards,
                    f"interaction_fwd launched {from_ds['launches']} times, "
                    f"expected {forwards}")
        require(from_ds["train_loss"][-1] < 0.9 * from_ds["train_loss"][0],
                "the loss of the fit from the ETL Dataset did not fall by 10%")
        rec["staged_samples_s"] = from_ds["samples_s"]
        rec["train_loss"] = from_ds["train_loss"]

        # 4. fit_on_etl, streamed, with the session alive
        streamed = rt.init_etl("smoke-etl-stream", **ETL_SESSION)
        frame = make_criteo_frame(streamed, source, parts)
        on_etl = etl_fit(device, lambda est: (est.fit_on_etl(frame), None),
                         epochs, streaming=True)
        rec["executor_decode"] = on_etl["stream_stats"]["executor_decode"]
        require(rec["executor_decode"] is True,
                "the streamed fit_on_etl did not decode on the executors")
        rec.update(executor_cuda_report(streamed))
        pids = rec["executor_pids"] + rec["session_pids"]
        rt.stop_etl()
        from_arrays_streamed = etl_fit(
            device, lambda est: (est.fit(arrays), None), epochs,
            streaming=True)
        rec["streamed_bitwise"] = require_same_fit(
            on_etl, from_arrays_streamed, "the streamed fit_on_etl")
        rec["launches"] += on_etl["launches"]
        if device.type == "cuda":
            require(on_etl["launches"] == epochs * steps,
                    f"interaction_fwd launched {on_etl['launches']} times in "
                    f"the streamed fit, expected {epochs * steps}")
        rec["streamed_samples_s"] = on_etl["samples_s"]
        rec["dlrm_samples_s"] = dlrm["samples_s"] if dlrm else None
        log(f"etl: columns {rec['ids_bitwise']}/{rec['label_bitwise']} "
            f"bitwise, dense within {rec['dense_max_ulp']} ulp; fits from "
            f"the Dataset bitwise the ArrayDataset's (staged "
            f"{rec['staged_bitwise']}, streamed {rec['streamed_bitwise']}, "
            f"executor decode {rec['executor_decode']}); K1 launches "
            f"{rec['launches']}; samples/s staged {rec['staged_samples_s']:.1f}, "
            f"streamed {rec['streamed_samples_s']:.1f}, phase_dlrm's "
            f"{rec['dlrm_samples_s']}; executors {rec['executor_pids']}, "
            f"CUDA contexts among the session's processes "
            f"{rec['cuda_context_pids']}")

        # 5. teardown
        capi.get_actor(f"smoke-etl{MASTER_ACTOR_SUFFIX}").kill()
        capi.shutdown()
        rec.update(etl_teardown(sessions, pids))
    finally:
        while etl_session.active_session() is not None:
            etl_session.stop_etl()
        if capi.is_initialized():
            capi.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["phase_s"] = time.perf_counter() - t_phase
    require(rec["phase_s"] <= ETL_LIMIT_S,
            f"phase_etl took {rec['phase_s']:.1f} s")
    log(f"etl: no process or segment of the sessions left "
        f"{rec['gone_after_shutdown_s']:.3f} s after shutdown; host CPUs "
        f"{rec['host_cpus']}; phase {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase_estimators: bench.py's DLRM cell through TorchEstimator's DDP ranks
# ---------------------------------------------------------------------------

# the whole phase: three fits' fresh rank processes (each rank's imports,
# then DDP's first construction, which imports torch's compiler stack)
# took 86.8-140.8 s with the gloo probes on the card's host
ESTIMATORS_LIMIT_S = 240.0
# the TorchEstimator fits' epochs over DLRM_RUN's rows (DLRM_RUN's 3 until
# phase_examples came: its time is the ranks' start, not their steps)
ESTIMATORS_EPOCHS = 2
ESTIMATORS_SESSION = dict(num_executors=2, executor_cores=2, executor_memory="1G")
# the held-out rows both worlds evaluate on (dlrm_columns with another seed),
# an equal block a rank at world 2
ESTIMATORS_HELDOUT = dict(rows=2048, data_seed=12, blocks=2)
# the native GBDT at world 2 on the dense columns
GBDT_RUN = dict(rounds=10, params={"objective": "binary:logistic", "eta": 0.3,
                                   "max_depth": 4})
# what DDP issues over gloo at world 2: at construction the parameters'
# shape check (an all-gather, then a broadcast) and the module state's
# broadcast; in each backward the gradient buckets' all-reduce (and the
# evaluation's sums)
DDP_OPS = ("all_gather", "broadcast", "all_reduce")
ESTIMATORS_KEYS = ("world1", "world2", "gbdt", "launches", "gloo_takes",
                   "dlrm_samples_s", "dlrm_step_ms", "phase_s")


class CommTimer:
    """The state of ``ddp_comm_hook`` on one rank: what it does to each
    gradient bucket (``mode``) and the file it reports to
    (``<path>.<rank>``: its calls and their seconds, rewritten after each
    call). "mean" is DDP's own reduce (divide by the world, all-reduce the
    sum); "sum" and "local" are planted faults: the gradients summed over
    the ranks, or each rank keeping its own."""

    def __init__(self, path: str, mode: str = "mean"):
        self.path, self.mode = path, mode
        self.calls, self.seconds = 0, 0.0


def ddp_comm_hook(state: CommTimer, bucket):
    """DDP's gradient reduce for ``state.mode``, the all-reduce timed on the
    host with the device drained before and after (gloo blocks the host for
    a CUDA tensor's collective anyway)."""
    import torch.distributed as dist

    buf = bucket.buffer()
    if state.mode == "mean":
        buf.div_(dist.get_world_size())  # x / 2 is x * 0.5, DDP's scaling
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    if state.mode != "local":
        dist.all_reduce(buf)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    state.calls += 1
    state.seconds += time.perf_counter() - t0
    Path(f"{state.path}.{dist.get_rank()}").write_text(
        json.dumps({"calls": state.calls, "seconds": state.seconds}))
    done = torch.futures.Future()
    done.set_result(buf)
    return done


def dlrm_creator(device):
    """The model creator the estimator ships: the full DLRM (f32, K1 in
    the forward), built on the rank's current card or on the CPU."""
    return functools.partial(DLRM, **DLRM_MODEL,
                             device=None if device.type == "cuda" else "cpu")


def dlrm_column_names():
    """``dlrm_columns``' dense and id column names."""
    return ([f"i{i}" for i in range(DLRM_MODEL["num_dense"])],
            [f"c{j}" for j in range(len(DLRM_MODEL["vocab_sizes"]))])


def torch_estimator(device, world: int, comm_hook=None):
    """``TorchEstimator`` on DLRM_RUN's fit: Adam, BCE with logits, the dense
    and id columns as one f32 matrix, ``batch`` rows a rank a step."""
    from raydp_tpu_torch.estimator import TorchEstimator

    dense_cols, cat_cols = dlrm_column_names()
    return TorchEstimator(
        model=dlrm_creator(device), optimizer="Adam",
        loss=torch.nn.BCEWithLogitsLoss, feature_columns=dense_cols + cat_cols,
        label_column="label", batch_size=DLRM_RUN["batch"],
        num_epochs=ESTIMATORS_EPOCHS, num_workers=world,
        learning_rate=DLRM_RUN["lr"], seed=SEED, device=device.type,
        comm_hook=comm_hook)


def shard_arrays(ds, world: int, columns) -> list:
    """Each rank's equal share of ``ds`` as (features, labels) numpy."""
    return [shard.to_numpy(columns, "label") for shard in ds.split(world)]


def shard_eval(model, shares, device) -> float:
    """The estimator's evaluation of ``shares`` (each rank's batches of
    DLRM_RUN's, the losses times their rows summed in f32, the ranks' sums
    added) by ``model`` in this process."""
    loss_fn, batch = torch.nn.BCEWithLogitsLoss(), DLRM_RUN["batch"]
    total = torch.zeros(1, device=device)
    count = torch.zeros(1, device=device)
    model.eval()
    with torch.no_grad():
        for features, labels in shares:
            x = torch.from_numpy(features).to(device)
            y = torch.from_numpy(labels).to(device)
            for s in range(0, len(x), batch):
                xb, yb = x[s:s + batch], y[s:s + batch]
                loss = loss_fn(model(xb).reshape(yb.shape), yb)
                total += (loss.double() * len(xb)).float()
                count += len(xb)
    return float(total) / max(float(count), 1.0)


def reference_loop(device, shares, heldout) -> dict:
    """The plain loop the estimator's fits are held to, in this process
    with no DDP: the creator after ``torch.manual_seed(SEED)``, Adam,
    BCE with logits; each step the rows every rank takes at that step (its
    own order, ``default_rng(SEED + epoch)``) concatenated rank after rank,
    ``loss.backward()`` and ``Adam.step()``; an epoch's loss the f64 sum of
    its steps' losses over their count; after each epoch ``shard_eval`` of
    the held-out shares. With one share it is the world-1 rank's fit, so
    the two must agree bit for bit. Its K1 launches are counted."""
    torch.manual_seed(SEED)
    model = dlrm_creator(device)().to(device)
    opt = torch.optim.Adam(model.parameters(), lr=DLRM_RUN["lr"])
    loss_fn, batch = torch.nn.BCEWithLogitsLoss(), DLRM_RUN["batch"]
    xs = [(torch.from_numpy(f).to(device), torch.from_numpy(l).to(device))
          for f, l in shares]
    n = len(xs[0][0])
    steps = n // batch
    history = []
    ia.reset_launches()
    for epoch in range(ESTIMATORS_EPOCHS):
        model.train()
        order = np.arange(n)
        np.random.default_rng(SEED + epoch).shuffle(order)
        order = torch.from_numpy(order).to(device)
        total = 0.0
        for s in range(steps):
            idx = order[s * batch:(s + 1) * batch]
            xb = torch.cat([x.index_select(0, idx) for x, _ in xs])
            yb = torch.cat([y.index_select(0, idx) for _, y in xs])
            opt.zero_grad()
            loss = loss_fn(model(xb).reshape(yb.shape), yb)
            loss.backward()
            opt.step()
            total += float(loss.detach())
        history.append({"train_loss": total / max(steps, 1),
                        "eval_loss": shard_eval(model, heldout, device)})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"history": history, "launches": ia.LAUNCHES["interaction_fwd"],
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def reference_step(device, shares) -> dict:
    """One step of the world-1 loop (``reference_loop``'s first step, every
    rank's first batch concatenated): the loss, every gradient, the
    parameters before and after."""
    torch.manual_seed(SEED)
    model = dlrm_creator(device)().to(device)
    opt = torch.optim.Adam(model.parameters(), lr=DLRM_RUN["lr"])
    batch = DLRM_RUN["batch"]
    rows = np.arange(len(shares[0][0]))
    np.random.default_rng(SEED).shuffle(rows)
    rows = rows[:batch]
    xb = torch.from_numpy(np.concatenate([f[rows] for f, _ in shares])).to(device)
    yb = torch.from_numpy(np.concatenate([l[rows] for _, l in shares])).to(device)
    named = list(model.named_parameters())
    start = {n: p.detach().cpu().clone() for n, p in named}
    opt.zero_grad()
    loss = torch.nn.BCEWithLogitsLoss()(model(xb).reshape(yb.shape), yb)
    loss.backward()
    opt.step()
    return {"loss": float(loss.detach()), "start": start,
            "grads": {n: p.grad.detach().cpu().clone() for n, p in named},
            "params": {n: p.detach().cpu().clone() for n, p in named}}


def estimator_step_rank(worker_fn, ctx) -> dict:
    """One training step of the estimator's own rank program (its
    ``start``, ``stage``, ``order`` and ``step``) on the first batch of
    epoch 0: the loss, every gradient after DDP's reduce, the parameters
    before and after, this rank's pid."""
    import torch.distributed as dist

    device, model, optimizer, loss_fn = worker_fn.start(ctx)
    try:
        x, y = worker_fn.stage(worker_fn.shards[ctx.rank], device)
        batch = worker_fn.est_config["batch_size"]
        idx = torch.from_numpy(worker_fn.order(len(x), 0)[:batch]).to(device)
        named = list(model.module.named_parameters())
        start = {n: p.detach().cpu().clone() for n, p in named}
        loss = worker_fn.step(model, optimizer, loss_fn, x.index_select(0, idx),
                              y.index_select(0, idx))
        return {"rank": ctx.rank, "pid": os.getpid(),
                "loss": float(loss.detach()), "start": start,
                "grads": {n: p.grad.detach().cpu().clone() for n, p in named},
                "params": {n: p.detach().cpu().clone() for n, p in named}}
    finally:
        dist.destroy_process_group()


def estimator_rates(history: list, steps: int, rows: int) -> dict:
    """A rank's samples/s and step ms over the epochs after the first
    (``steps`` an epoch of ``rows`` each), from its history's
    ``epoch_seconds``."""
    seconds = [r["epoch_seconds"] for r in history]
    timed_steps = (len(seconds) - 1) * steps
    timed = sum(seconds[1:])
    return {"samples_s": timed_steps * rows / timed,
            "step_ms": 1e3 * timed / timed_steps, "epoch_seconds": seconds}


def fit_record(est, history, world: int, steps: int, wall: float) -> dict:
    """A fit's losses and its ranks' records (``steps`` a rank an epoch):
    launches, device, backend, peak memory, parameters' digest, rates; the
    fit's seconds from ``wall`` (the wall clock at its call), split into
    before the ranks' program (the conversion, the job's start, the
    program's unpickling), the ranks' program and after it (the results
    back, the job's stop)."""
    end = time.time()
    stats = est.rank_stats_
    ranks = [{
        "pid": r["pid"], "device": r["device"], "setup_s": r["setup_s"],
        "setup": r["setup"], "backend": r["backend"],
        "peak_bytes": r["peak_bytes"],
        "launches": r["launches"].get("interaction_fwd", 0),
        "params_sha256": r["params_sha256"],
        "train_loss": [h["train_loss"] for h in r["history"]],
        **estimator_rates(r["history"], steps, DLRM_RUN["batch"])}
        for r in stats]
    return {"world": world, "train_loss": [r["train_loss"] for r in history],
            "eval_loss": [r["eval_loss"] for r in history], "ranks": ranks,
            "fit_s": end - wall,
            "fit_split_s": {
                "before_ranks": min(r["started_at"] for r in stats) - wall,
                "ranks": max(r["ended_at"] - r["started_at"] for r in stats),
                "after_ranks": end - max(r["ended_at"] for r in stats)}}


def estimators_world1(device, frame, heldout_frame, ds, heldout_ds) -> dict:
    """World 1: one rank over NCCL (gloo on the CPU) through
    ``fit_on_etl``, against ``reference_loop`` on the same rows."""
    columns = sum(dlrm_column_names(), [])
    share = shard_arrays(ds, 1, columns)[0]
    heldout = shard_arrays(heldout_ds, 1, columns)
    rows, batch, epochs = len(share[0]), DLRM_RUN["batch"], ESTIMATORS_EPOCHS
    steps = rows // batch
    est = torch_estimator(device, 1)
    wall = time.time()
    history = est.fit_on_etl(frame, heldout_frame)
    rec = fit_record(est, history, 1, steps, wall)
    rec["forwards"] = epochs * (steps + -(-len(heldout[0][0]) // batch))
    t0 = time.perf_counter()
    loop = reference_loop(device, [share], heldout)
    rec["loop_s"] = time.perf_counter() - t0
    model = est.get_model()
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rec["bitwise"] = (
        rec["train_loss"] == [r["train_loss"] for r in loop["history"]]
        and rec["eval_loss"] == [r["eval_loss"] for r in loop["history"]]
        and state.keys() == loop["state"].keys()
        and all(torch.equal(state[k], loop["state"][k]) for k in state))
    rec["loop_launches"] = loop["launches"]
    rec.update(driver_model(model, heldout, device, rec))
    return rec


def driver_model(model, heldout, device, rec: dict) -> dict:
    """Whether ``get_model()``'s module is on ``device`` and reproduces the
    ranks' last evaluation bit for bit (``shard_eval`` on each rank's
    held-out share: its logits are the ranks')."""
    return {"driver_on_device": all(p.device.type == device.type
                                    for p in model.parameters()),
            "driver_eval_bitwise": (shard_eval(model, heldout, device)
                                    == rec["eval_loss"][-1])}


def estimators_world2(device, frame, heldout_frame, ds, heldout_ds,
                      comm_mode: str = "mean") -> dict:
    """World 2: two ranks over gloo on the one card through ``fit_on_etl``
    (DDP's reduce through ``ddp_comm_hook`` in ``comm_mode``, timed),
    against ``reference_loop`` on both ranks' batches concatenated; then
    one step of the estimator's rank program at world 2 against
    ``reference_step``."""
    from raydp_tpu_torch.estimator.torch_estimator import (_TorchWorkerFn,
                                                           params_digest)
    from raydp_tpu_torch.spmd import create_spmd_job

    here = importlib.import_module("chip_smoke")  # the hook by reference
    columns = sum(dlrm_column_names(), [])
    shares = shard_arrays(ds, 2, columns)
    heldout = shard_arrays(heldout_ds, 2, columns)
    rows, batch, epochs = len(shares[0][0]), DLRM_RUN["batch"], ESTIMATORS_EPOCHS
    steps = rows // batch
    root = BUILD_DIR / "estimators"
    root.mkdir(parents=True, exist_ok=True)
    timer = here.CommTimer(str(root / f"comm-{comm_mode}"), comm_mode)
    hook = (timer, here.ddp_comm_hook)
    est = torch_estimator(device, 2, comm_hook=hook)
    wall = time.time()
    history = est.fit_on_etl(frame, heldout_frame)
    rec = fit_record(est, history, 2, steps, wall)
    rec["forwards"] = epochs * (steps + -(-len(heldout[0][0]) // batch))
    rec["comm_mode"] = comm_mode
    comm = [json.loads(Path(f"{timer.path}.{r}").read_text()) for r in range(2)]
    for rank, calls in zip(rec["ranks"], comm):
        rank["comm_calls"] = calls["calls"]
        rank["comm_share"] = calls["seconds"] / sum(rank["epoch_seconds"])
    rec["ranks_bitwise"] = len({r["params_sha256"] for r in rec["ranks"]}) == 1

    t0 = time.perf_counter()
    loop = reference_loop(device, shares, heldout)
    rec["loop_s"] = time.perf_counter() - t0
    mean_losses = [(a + b) / 2 for a, b in zip(*(r["train_loss"]
                                                 for r in rec["ranks"]))]
    pairs = list(zip(mean_losses + rec["eval_loss"],
                     [r["train_loss"] for r in loop["history"]]
                     + [r["eval_loss"] for r in loop["history"]]))
    rec["loss_gap"] = max(abs(a - b) for a, b in pairs)
    rec["mean_train_loss"] = mean_losses
    model = est.get_model()
    rec["driver_params_bitwise"] = (params_digest(model)
                                    == rec["ranks"][0]["params_sha256"])
    rec.update(driver_model(model, heldout, device, rec))

    t0 = time.perf_counter()
    ref = reference_step(device, shares)
    t_job = time.perf_counter()
    job = create_spmd_job("estimator-step", world_size=2,
                          timeout=SHARDED_LIMIT_S).start()
    rec["step_job_start_s"] = time.perf_counter() - t_job
    try:
        fn = _TorchWorkerFn(est, [ArrayShard(*s) for s in shares], None,
                            job.rendezvous_address())
        got = job.run(functools.partial(here.estimator_step_rank, fn),
                      timeout=SHARDED_LIMIT_S)
    finally:
        t_stop = time.perf_counter()
        job.stop()
        rec["step_job_stop_s"] = time.perf_counter() - t_stop
    step = step_gaps(dict(got[0], loss=(got[0]["loss"] + got[1]["loss"]) / 2),
                     ref)
    step["ranks_agree"] = all(torch.equal(got[0]["params"][k], got[1]["params"][k])
                              for k in got[0]["params"])
    rec["step"] = step
    rec["step_s"] = time.perf_counter() - t0
    rec["pids"] = [r["pid"] for r in rec["ranks"]] + [g["pid"] for g in got]
    return rec


class ArrayShard:
    """A rank's share as numpy (what a store shard's ``to_numpy`` gives)."""

    def __init__(self, features, labels):
        self.features, self.labels = features, labels

    def to_numpy(self, feature_columns, label_column):
        return self.features, self.labels


class InProcessRanks:
    """A job of ``world`` ranks run in this process one after another, each
    with its own ``gbdt_native`` rank state (the module's ``_STATE`` is
    swapped around each call)."""

    job_name = "in-process"

    def __init__(self, module, world: int):
        self.module, self.world = module, world
        self.states = [{} for _ in range(world)]

    def run(self, fn, timeout=None):
        from types import SimpleNamespace

        saved, out = self.module._STATE, []
        try:
            for rank in range(self.world):
                self.module._STATE = self.states[rank]
                out.append(fn(SimpleNamespace(rank=rank, world_size=self.world)))
        finally:
            self.module._STATE = saved
        return out


def estimators_gbdt(frame, ds, heldout_ds) -> dict:
    """``XGBoostEstimator`` at world 2 through ``fit_on_etl`` on the dense
    columns (the native backend: no xgboost on the card's machine), its
    predictions on the held-out rows against the two-rank in-process run
    of ``gbdt_native`` on the same shares, bit for bit."""
    from raydp_tpu_torch.estimator import XGBoostEstimator, gbdt_native

    dense_cols = dlrm_column_names()[0]
    est = XGBoostEstimator(params=GBDT_RUN["params"],
                           num_boost_round=GBDT_RUN["rounds"],
                           feature_columns=dense_cols, label_column="label",
                           num_workers=2)
    t0 = time.perf_counter()
    est.fit_on_etl(frame)
    fit_s = time.perf_counter() - t0
    shares = [ArrayShard(*s) for s in shard_arrays(ds, 2, dense_cols)]
    t0 = time.perf_counter()
    ref, history = gbdt_native.train_distributed(
        InProcessRanks(gbdt_native, 2), shares, GBDT_RUN["params"],
        GBDT_RUN["rounds"], dense_cols, "label")
    in_process_s = time.perf_counter() - t0
    probe = heldout_ds.to_numpy(dense_cols, "label")[0]
    model = est.get_model()
    return {"backend": est.backend, "rounds": GBDT_RUN["rounds"],
            "predictions_bitwise": bool(np.array_equal(model.predict(probe),
                                                       ref.predict(probe))),
            "history_equal": est.history == history,
            "train_loss": [h["train_loss"] for h in est.history],
            "fit_s": fit_s, "s_per_round": fit_s / GBDT_RUN["rounds"],
            "in_process_s_per_round": in_process_s / GBDT_RUN["rounds"]}


def estimators_verdict(rec: dict, device) -> None:
    """The phase's checks of its record; each fails the phase."""
    on_card = device.type == "cuda"
    for name in ("world1", "world2"):
        run = rec[name]
        losses = run["train_loss"]
        require(all(math.isfinite(x) for x in losses + run["eval_loss"]),
                f"estimators {name}: a loss is not finite")
        for rank, r in enumerate(run["ranks"]):
            want = run["forwards"] if on_card else 0
            require(r["launches"] == want,
                    f"estimators {name} rank {rank}: interaction_fwd launched "
                    f"{r['launches']} times, expected {want}")
            require(r["device"].split(":")[0] == device.type,
                    f"estimators {name} rank {rank} ran on {r['device']}")
        require(run["driver_on_device"] and run["driver_eval_bitwise"],
                f"estimators {name}: get_model() is off {device} or does not "
                "reproduce the ranks' evaluation bit for bit")
    w1, w2 = rec["world1"], rec["world2"]
    require(w1["ranks"][0]["backend"] == ("nccl" if on_card else "gloo"),
            f"estimators world 1 over {w1['ranks'][0]['backend']}")
    require(w1["bitwise"], "estimators world 1: not bit for bit the plain "
            f"loop (losses {w1['train_loss']}, evaluation {w1['eval_loss']})")
    require(w1["loop_launches"] == w1["ranks"][0]["launches"],
            f"estimators world 1: {w1['ranks'][0]['launches']} K1 launches, "
            f"the plain loop {w1['loop_launches']}")
    world2_verdict(w2)
    gbdt = rec["gbdt"]
    require(gbdt["backend"] == "native",
            f"XGBoostEstimator took the {gbdt['backend']} backend")
    require(gbdt["predictions_bitwise"] and gbdt["history_equal"],
            "XGBoostEstimator's booster differs from the in-process two-rank "
            "gbdt_native run's")


def world2_verdict(w2: dict) -> None:
    """The world-2 fit's own checks: gloo, both ranks' parameters equal and
    rank 0's on the driver, one step against world 1's, the losses against
    the world-1 loop's, falling by 10%."""
    require(all(r["backend"] == "gloo" for r in w2["ranks"]),
            "estimators world 2: not over gloo")
    require(w2["ranks_bitwise"], "estimators world 2: the ranks' parameters "
            "differ after the fit")
    require(w2["driver_params_bitwise"], "estimators world 2: get_model()'s "
            "parameters are not rank 0's")
    step = w2["step"]
    require(step["start_bitwise"] and step["ranks_agree"]
            and step["loss_rel"] <= SHARDED_STEP_RTOL
            and step["worst_grad_rel"] <= SHARDED_STEP_RTOL
            and step["worst_table_update_rel"] <= SHARDED_TABLE_UPDATE_RTOL,
            f"estimators world 2: one step against world 1's {step} (limits "
            f"{SHARDED_STEP_RTOL}, tables' update {SHARDED_TABLE_UPDATE_RTOL})")
    require(w2["loss_gap"] <= SHARDED_FIT_LOSS_ATOL,
            f"estimators world 2: losses {w2['mean_train_loss']} against the "
            f"world-1 loop's, gap {w2['loss_gap']:.3e} (limit "
            f"{SHARDED_FIT_LOSS_ATOL})")
    losses = w2["mean_train_loss"]
    require(losses[-1] < 0.9 * losses[0],
            f"estimators world 2: the loss did not fall by 10%: {losses}")


@contextlib.contextmanager
def estimators_session():
    """An ETL session in a cluster of the port with the session-local
    zygote and its own shm namespace: (the session, the train frame (the
    columns of ``dlrm_data`` in DLRM_RUN's blocks), the held-out frame (in
    ESTIMATORS_HELDOUT's), and the ``Dataset`` of each). Everything is
    stopped on exit."""
    import pandas as pd

    import raydp_tpu_torch as rt
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV
    from raydp_tpu_torch.etl import session as etl_session

    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1",
             SHM_NS_ENV: f"est{os.getpid()}"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    try:
        session = rt.init_etl("smoke-estimators", **ESTIMATORS_SESSION)
        frame = session.from_pandas(pd.DataFrame(dlrm_columns()[0]),
                                    num_partitions=DLRM_RUN["blocks"])
        held = dlrm_columns(dict(DLRM_RUN, **ESTIMATORS_HELDOUT))[0]
        heldout_frame = session.from_pandas(
            pd.DataFrame(held), num_partitions=ESTIMATORS_HELDOUT["blocks"])
        yield (session, frame, heldout_frame, rt.dataframe_to_dataset(frame),
               rt.dataframe_to_dataset(heldout_frame))
    finally:
        while etl_session.active_session() is not None:
            etl_session.stop_etl()
        if capi.is_initialized():
            capi.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def phase_estimators(device, dlrm: dict = None) -> dict:
    """bench.py's DLRM cell fitted through ``TorchEstimator`` (DDP ranks of
    the SPMD launcher, K1 in every rank's forward), and the native GBDT
    through ``XGBoostEstimator``, in an ETL session (``estimators_session``:
    the columns of ``dlrm_data``, 100,000 rows in 4 blocks; 2,048 held-out
    rows in 2):

    - world 1: one rank over NCCL through ``fit_on_etl`` (Adam 1e-3, batch
      2048, 2 epochs, the held-out rows evaluated each epoch), bit for bit
      the plain loop in this process (``reference_loop``: losses,
      evaluation, parameters, as many K1 launches);
    - world 2: two ranks over gloo on the one card, 2048 rows a rank a
      step, DDP's reduce timed by ``ddp_comm_hook``: both ranks'
      parameters bit for bit equal, ``get_model()``'s parameters rank 0's;
      the ranks' mean loss within SHARDED_FIT_LOSS_ATOL of the world-1 loop
      on their batches concatenated, falling by 10%; one step of the
      estimator's rank program (``estimator_step_rank``) within
      SHARDED_STEP_RTOL and SHARDED_TABLE_UPDATE_RTOL of the world-1 step
      on the 4096 rows; on the card gloo must take every op of DDP_OPS;
    - both: K1 once a forward on every rank (none on the CPU), every rank on
      ``device``, the driver's ``get_model()`` reproducing the ranks' last
      evaluation bit for bit (``shard_eval``: its logits are theirs);
    - ``XGBoostEstimator`` (native) at world 2 on the dense columns, its
      predictions bit for bit the in-process two-rank ``gbdt_native`` run's.

    Reported: samples/s and step ms a rank at each world beside
    phase_dlrm's staged fit, the share of a world-2 rank's epochs in DDP's
    all-reduces, peak memory and K1 launches a rank, the GBDT's seconds a
    round. After ``cluster.shutdown()`` no process or ``rtpt-`` segment
    of the session is left. On the CPU the same runs go over gloo with
    the plain versions."""
    from raydp_tpu_torch.cluster import api as capi

    t_phase = time.perf_counter()
    rec: dict = {"dlrm_samples_s": dlrm["samples_s"] if dlrm else None,
                 "dlrm_step_ms": dlrm["step_ms"] if dlrm else None}
    rec["gloo_takes"] = require_gloo_takes(device, DDP_OPS, "TorchEstimator")
    seconds = {"probe": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    with estimators_session() as (session, frame, heldout_frame, ds,
                                  heldout_ds):
        session_dir = capi.session_dir()
        seconds["session"] = time.perf_counter() - t0
        rec["world1"] = estimators_world1(device, frame, heldout_frame, ds,
                                          heldout_ds)
        rec["world2"] = estimators_world2(device, frame, heldout_frame, ds,
                                          heldout_ds)
        rec["gbdt"] = estimators_gbdt(frame, ds, heldout_ds)
        pids = ([r["pid"] for r in rec["world1"]["ranks"]]
                + rec["world2"]["pids"])
        t0 = time.perf_counter()
        capi.shutdown()
        rec.update(etl_teardown([session_dir], pids))
        seconds["teardown"] = time.perf_counter() - t0
    for name in ("world1", "world2"):
        for key in ("fit_s", "loop_s", "step_s"):
            if key in rec[name]:
                seconds[f"{name}_{key[:-2]}"] = rec[name][key]
    seconds["gbdt_fit"] = rec["gbdt"]["fit_s"]
    seconds["gbdt_in_process"] = (rec["gbdt"]["in_process_s_per_round"]
                                  * rec["gbdt"]["rounds"])
    rec["seconds"] = seconds
    rec["launches"] = sum(r["launches"] for name in ("world1", "world2")
                          for r in rec[name]["ranks"])
    rec["phase_s"] = time.perf_counter() - t_phase
    log("estimators: " + json.dumps(estimators_summary(rec, "")["estimators"])
        + f"; seconds {seconds}")
    estimators_verdict(rec, device)
    require(rec["phase_s"] <= ESTIMATORS_LIMIT_S,
            f"phase_estimators took {rec['phase_s']:.1f} s")
    return rec


def estimators_summary(rec: dict, nvidia_smi: str) -> dict:
    """The phase's line: each world's ranks (samples/s, step ms, peak
    memory, K1 launches, at world 2 the share in DDP's all-reduces) beside
    phase_dlrm's staged fit, the checks' gaps, the GBDT's seconds a
    round."""
    def ranks(run):
        keys = ("samples_s", "step_ms", "peak_bytes", "launches",
                "comm_share", "comm_calls", "setup_s", "setup")
        return [{k: r[k] for k in keys if k in r} for r in run["ranks"]]

    w1, w2 = rec["world1"], rec["world2"]
    return {"estimators": {
        "world1": {"bitwise": w1["bitwise"], "train_loss": w1["train_loss"],
                   "fit_split_s": w1["fit_split_s"], "ranks": ranks(w1)},
        "world2": {"ranks_bitwise": w2["ranks_bitwise"],
                   "mean_train_loss": w2["mean_train_loss"],
                   "loss_gap": w2["loss_gap"], "step": w2["step"],
                   "step_job_start_s": w2["step_job_start_s"],
                   "step_job_stop_s": w2["step_job_stop_s"],
                   "fit_split_s": w2["fit_split_s"],
                   "ranks": ranks(w2)},
        "gbdt": {k: rec["gbdt"][k] for k in (
            "backend", "predictions_bitwise", "s_per_round",
            "in_process_s_per_round")},
        "dlrm_samples_s": rec["dlrm_samples_s"],
        "dlrm_step_ms": rec["dlrm_step_ms"], "launches": rec["launches"],
        "gloo_takes": rec["gloo_takes"]["ops"], "seconds": rec["seconds"],
        "phase_s": rec["phase_s"]},
        "nvidia_smi": nvidia_smi}


# ---------------------------------------------------------------------------
# phase 4, continued: the serving plane, replicas on the card
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase_sharded_dlrm: examples/dlrm_criteo.py's dp x tp fit at full width
# ---------------------------------------------------------------------------

SHARDED_CLUSTER = dict(num_cpus=4)
SHARDED_LIMIT_S = 600.0  # the world-2 job's every run
SHARDED_DEADLINE_S = 15.0  # no process of the session after shutdown
# the runs at world 2, two ranks on the one card over gloo through
# create_spmd_job: (a) the tables split in two, Adam: bitwise world 1;
# (b) the batch split in two, Adam, in order: held to a world-1 fit of the
# same global batches; (c) the tables split, dlrm_optimizer(): held to its
# world-1 fit
SHARDED_RUNS = {
    "model2_adam": dict(mesh={"data": 1, "model": 2}, optimizer="adam"),
    "data2_adam": dict(mesh={"data": 2, "model": 1}, optimizer="adam",
                       shuffle=False),
    "model2_dlrm_optimizer": dict(mesh={"data": 1, "model": 2},
                                  optimizer="dlrm_optimizer"),
}
# (b) and (c) against world 1, step by step: one step from the same
# weights on the same global batch, its loss and every gradient (after the
# data axis's average) relative, per tensor in norm; the tables' first
# Adafactor update relative in norm (the whole table's means against a
# block's sums all-reduced: rounding only)
SHARDED_STEP_RTOL, SHARDED_TABLE_UPDATE_RTOL = 1e-5, 1e-4
# and fit by fit: each epoch's loss and the evaluation's, absolute. Adam
# takes the sign of a gradient near rounding noise as a full step, so two
# world-1 fits of the same batches summed in another order part by ~0.03
# in parameters within two epochs and 1e-4 in a loss; the fits are held
# by their losses, the steps by their bits' worth
SHARDED_FIT_LOSS_ATOL = 1e-3
SHARDED_KEYS = ("world1_bitwise", "world1_samples_s", "order_yardstick",
                "runs", "phase_s")


@contextlib.contextmanager
def timed_calls(owner, name: str, device):
    """Each call of ``owner.<name>`` while the block runs (a collective of
    ``torch.distributed``, the pipeline's shift, the experts' all-to-all),
    timed on the host with the device's queue drained before and after,
    so the time is the call's own: [(its arguments, seconds)] in call
    order. gloo blocks the host for a CUDA tensor's collective anyway."""
    calls = []
    plain = getattr(owner, name)

    def timed(*args, **kwargs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            return plain(*args, **kwargs)
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            calls.append((args, time.perf_counter() - t0))

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        setattr(owner, name, plain)


def sharded_fit(device, run: dict, ds=None, order=None, ckpt=None) -> dict:
    """One DLRM fit of DLRM_RUN's epochs on ``run["mesh"]`` (a mesh of this
    process group's ranks) with ``dlrm_sharding_rules``, and its
    evaluation; K1's launches counted from 0 around both. The batch is
    DLRM_RUN's over the data axis, so the global batch is DLRM_RUN's.
    ``order`` feeds the fit the rows so (a world-1 fit of (b)'s global
    batches); the evaluation is of ``ds`` as it is. With ``ckpt`` every
    epoch ends in a checkpoint there (whole tensors, rank 0 writes).
    Returns the losses, the evaluation, the parameters gathered whole, the
    launches and the forward passes they must equal, whether every
    parameter is on ``device``, samples/s and step ms over the epochs after
    the first, the peak memory, and the share of those epochs inside
    all-reduces."""
    import torch.distributed as dist

    from raydp_tpu_torch.models import dlrm_sharding_rules
    from raydp_tpu_torch.parallel import make_mesh
    from raydp_tpu_torch.parallel.sharding import gather_state

    if ds is None:
        ds, _, _ = dlrm_data()
    dense_cols = [f"i{i}" for i in range(DLRM_MODEL["num_dense"])]
    cat_cols = [f"c{j}" for j in range(len(DLRM_MODEL["vocab_sizes"]))]
    train = ds if order is None else ArrayDataset(
        {k: v[order] for k, v in ds.columns.items()})
    mesh = make_mesh(run["mesh"])
    data = mesh.shape["data"]
    batch = DLRM_RUN["batch"] // data
    optimizer = (dlrm_optimizer() if run["optimizer"] == "dlrm_optimizer"
                 else run["optimizer"])
    est = dlrm_estimator(device, dense_cols, cat_cols, optimizer,
                         DLRM_RUN["epochs"], mesh=mesh, batch_size=batch,
                         param_sharding_rules=dlrm_sharding_rules(),
                         shuffle=run.get("shuffle", True),
                         checkpoint_dir=None if ckpt is None else str(ckpt))
    base = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    ia.reset_launches()
    with timed_calls(dist, "all_reduce", device) as reduces:
        history = est.fit(train)
        fit_collective_s = sum(s for _, s in reduces)
        evaluation = est.evaluate(ds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = ia.LAUNCHES["interaction_fwd"]
    model = est.get_model()
    steps = -(-len(train.columns["label"]) // data) // batch
    eval_per = -(-len(ds.columns["label"]) // data)
    timed = history[1:]
    seconds = sum(r["epoch_seconds"] for r in timed)
    return {
        "mesh": dict(mesh.shape), "batch": batch,
        "train_loss": [r["train_loss"] for r in history],
        "evaluate": evaluation,
        "final_state": {k: v.detach().cpu().clone() for k, v in gather_state(
            model.state_dict(), model.placements).items()},
        "table_rows": model.embedding_0.shape[0],
        "launches": launches,
        "forward_passes": DLRM_RUN["epochs"] * steps + -(-eval_per // batch),
        "on_device": all(p.device.type == device.type
                         for p in model.parameters()),
        "samples_s": len(timed) * steps * batch * data / seconds,
        "step_ms": 1e3 * seconds / (len(timed) * steps),
        "peak_bytes": (torch.cuda.max_memory_allocated(device) - base
                       if device.type == "cuda" else None),
        "collective_calls": len(reduces),
        "collective_share": fit_collective_s / sum(
            r["epoch_seconds"] for r in history),
    }


def sharded_step(device, run: dict, split: int) -> dict:
    """One step of ``run``'s mesh and optimizer from SEED's weights on the
    first global batch of DLRM_RUN's rows fed in order to ``split`` data
    coordinates (``interleaved_order``), each rank on its block of it (the
    driver-staged partitioner cuts the global batch, the rows the fit's
    staging gives the rank): the loss and every gradient after
    ``partition_step``, and the parameters after one optimizer step, whole
    (split ones gathered)."""
    from raydp_tpu_torch.estimator.estimator import LOSSES
    from raydp_tpu_torch.models import dlrm_sharding_rules
    from raydp_tpu_torch.optim import OPTIMIZERS
    from raydp_tpu_torch.parallel import DataParallelPartitioner, make_mesh
    from raydp_tpu_torch.parallel.sharding import gather_full, shard_module

    ds, dense_cols, cat_cols = dlrm_data()
    mesh = make_mesh(run["mesh"])
    data = mesh.shape["data"]
    rows = interleaved_order(DLRM_RUN["rows"], DLRM_RUN["batch"] // split,
                             split)[:DLRM_RUN["batch"]]
    (dense, ids), labels = ds.to_numpy_grouped(
        [(dense_cols, np.float32), (cat_cols, np.int32)], "label")
    part = DataParallelPartitioner(mesh, shard_direct=False, device=device)
    x, y = part.shard_inputs(((dense[rows], ids[rows]), labels[rows]))
    model = DLRM(**DLRM_MODEL, device=device, seed=SEED)
    shard_module(model, dlrm_sharding_rules()(mesh, model))
    named = list(model.named_parameters())
    opt = (dlrm_optimizer() if run["optimizer"] == "dlrm_optimizer"
           else OPTIMIZERS[run["optimizer"]](DLRM_RUN["lr"]))(named)

    def grads(x, y):
        loss = LOSSES["bce"](model(x), y)
        loss.backward()
        return loss

    loss = part.partition_step(grads, params=[p for _, p in named])(x, y)

    def whole(t, p):
        return gather_full(t.detach().clone(), getattr(p, "placement", None)).cpu()

    out = {"loss": float(loss.detach()),
           "grads": {n: whole(p.grad, p) for n, p in named},
           "start": {n: whole(p, p) for n, p in named}}
    opt.step()
    out["params"] = {n: whole(p, p) for n, p in named}
    return out


def step_gaps(got: dict, ref: dict) -> dict:
    """One step against its world-1 step: the loss's relative gap, the
    worst gradient's (per tensor, in norm), and the worst table's first
    update's (``params - start``, in norm)."""
    worst_grad, _ = grad_gap(got["grads"], ref["grads"])
    tables = [n for n in ref["params"] if n.startswith("embedding_")]
    updates = {n: got["params"][n] - got["start"][n] for n in tables}
    ref_updates = {n: ref["params"][n] - ref["start"][n] for n in tables}
    worst_update, _ = grad_gap(updates, ref_updates)
    return {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "worst_grad_rel": worst_grad, "worst_table_update_rel": worst_update,
            "start_bitwise": all(torch.equal(got["start"][n], ref["start"][n])
                                 for n in ref["start"])}


def sharded_dlrm_rank(device_type: str, config: dict, runs: dict,
                      ckpt_root: str, ctx) -> dict:
    """One rank of the world-2 job (``create_spmd_job``, its group brought
    up by ``bootstrap_torch``): every run of ``runs`` in turn through
    ``sharded_fit``, on the card (or the CPU), its epoch checkpoints under
    ``ckpt_root/<run>``."""
    globals().update(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = _rank_device(device_type)
    steps = {name: sharded_step(device, run, run["mesh"]["data"])
             for name, run in runs.items() if name != "model2_adam"}
    return {"rank": ctx.rank, "pid": os.getpid(), "steps": steps,
            "runs": {name: sharded_fit(device, run,
                                       ckpt=Path(ckpt_root) / name)
                     for name, run in runs.items()}}


def sharded_summary(rec: dict, nvidia_smi: str) -> dict:
    """The phase's line: each run's samples/s, step ms, peak memory and
    all-reduce share (rank 0's, then rank 1's) beside the world-1 fit's."""
    return {"sharded_dlrm": {
        "world1_bitwise": rec["world1_bitwise"],
        "world1_samples_s": rec["world1_samples_s"],
        "world1_step_ms": rec["world1_step_ms"],
        "order_yardstick": rec["order_yardstick"],
        "runs": {name: {k: run[k] for k in (
            "mesh", "bitwise", "loss_gap", "step", "epoch_gaps", "samples_s",
            "step_ms", "peak_bytes", "collective_share", "launches",
            "reference_samples_s")} for name, run in rec["runs"].items()},
        "phase_s": rec["phase_s"]}, "nvidia_smi": nvidia_smi}


def interleaved_order(rows: int, batch: int, data: int) -> np.ndarray:
    """The rows of the global batches a mesh of ``data`` coordinates feeds
    in order (no shuffle), ``batch`` rows a coordinate: batch s is
    coordinate 0's batch s, then coordinate 1's, and so on (coordinate d
    holds rows [d * rows/data, (d + 1) * rows/data))."""
    per = -(-rows // data)
    steps = per // batch
    return np.concatenate([(np.arange(s * batch, (s + 1) * batch) + d * per) % rows
                           for s in range(steps) for d in range(data)])


def params_gap(got: dict, ref: dict) -> float:
    require(got.keys() == ref.keys(), "the parameters differ in names")
    return max(float((got[k].float() - ref[k].float()).abs().max()) for k in got)


def epoch_gaps(got_dir: Path, ref_dir: Path, epochs: int) -> list:
    """The parameter gap at the end of each epoch, from the two fits'
    epoch checkpoints."""
    from raydp_tpu_torch.estimator import checkpoint as ckpt

    return [params_gap(ckpt.load_state(str(got_dir), e)["params"],
                       ckpt.load_state(str(ref_dir), e)["params"])
            for e in range(epochs)]


def sharded_verdict(name: str, run: dict, device) -> None:
    losses = run["train_loss"]
    require(all(math.isfinite(x) for x in losses + [run["evaluate"]["eval_loss"]]),
            f"sharded {name}: a loss is not finite")
    require(losses[-1] < 0.9 * losses[0],
            f"sharded {name}: the loss did not fall by 10%: {losses}")
    want = run["forward_passes"] if device.type == "cuda" else 0
    require(run["launches"] == want,
            f"sharded {name}: interaction_fwd launched {run['launches']} "
            f"times, expected {want}")
    require(run["on_device"], f"sharded {name}: a parameter left {device}")


def phase_sharded_dlrm(device, dlrm: dict) -> dict:
    """examples/dlrm_criteo.py's dp x tp fit on the port at full width
    (DLRM_MODEL on DLRM_RUN's data, f32, ``dlrm_sharding_rules``), held to
    ``phase_dlrm``'s fit (``dlrm``, its ``final_state`` included):

    - world 1 over NCCL in this process, mesh {"data": 1, "model": 1},
      Adam: the losses, the evaluation and every parameter bit for bit
      phase_dlrm's, as many K1 launches;
    - world 2, two ranks of the cluster runtime on the one card over gloo,
      launched by ``create_spmd_job`` and brought up by
      ``bootstrap_torch``: SHARDED_RUNS (a), (b) and (c). (a) splits every
      table in two, and each row looked up is its block's value plus
      zeros, so the losses, evaluation and the tables gathered whole must
      be phase_dlrm's bit for bit; (b) splits the batch, fed in order, and
      is held to a world-1 fit of the same global batches
      (``interleaved_order``), (c) is held to a world-1
      ``dlrm_optimizer()`` fit: one step (``sharded_step``) within
      SHARDED_STEP_RTOL and SHARDED_TABLE_UPDATE_RTOL, the fit's losses
      within SHARDED_FIT_LOSS_ATOL, the epochs' parameter gaps reported
      beside two world-1 fits of (b)'s batches summed in another order
      (``order_yardstick``); both ranks report the same losses.

    Every run: the loss falls by 10%, K1 launched once a forward pass on
    every rank (none on the CPU), no parameter off the device; samples/s,
    step ms, peak memory and the share of the epochs inside all-reduces.
    The job's session has its own zygote; within SHARDED_DEADLINE_S of
    ``cluster.shutdown()`` no process of it is left. On the CPU the same
    runs go over gloo with the plain versions."""
    import torch.distributed as dist

    from raydp_tpu_torch.cluster import api as cluster
    from raydp_tpu_torch.cluster.common import _probe_pid
    from raydp_tpu_torch.spmd import create_spmd_job

    t0 = time.perf_counter()
    here = importlib.import_module("chip_smoke")  # the rank program by reference
    ref_state = dlrm["final_state"]
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        world1 = sharded_fit(device, {"mesh": {"data": 1, "model": 1},
                                      "optimizer": "adam"})
    finally:
        dist.destroy_process_group()
    sharded_verdict("world 1", world1, device)
    bitwise = (world1["train_loss"] == dlrm["train_loss"]
               and world1["evaluate"] == dlrm["evaluate"]
               and world1["final_state"].keys() == ref_state.keys()
               and all(torch.equal(world1["final_state"][k], ref_state[k])
                       for k in ref_state))
    require(bitwise, f"sharded world 1: losses {world1['train_loss']} vs "
            f"{dlrm['train_loss']}, or the evaluation or a parameter differs")
    require(world1["launches"] == dlrm["launches"],
            f"sharded world 1: {world1['launches']} K1 launches, "
            f"phase_dlrm {dlrm['launches']}")

    # the world-1 fits (b) and (c) are held to
    ds, _, _ = dlrm_data()
    rows = DLRM_RUN["rows"]
    root = BUILD_DIR / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    step_refs = {name: sharded_step(device, dict(run, mesh={"data": 1,
                                                           "model": 1}),
                                    run["mesh"]["data"])
                 for name, run in SHARDED_RUNS.items() if name != "model2_adam"}
    order = interleaved_order(rows, DLRM_RUN["batch"] // 2, 2)
    in_order = {"mesh": {"data": 1, "model": 1}, "optimizer": "adam",
                "shuffle": False}
    refs = {
        "data2_adam": sharded_fit(device, in_order, ds, order,
                                  ckpt=root / "world1" / "data2_adam"),
        # the same global batches with their halves swapped: the fit's own
        # sensitivity to the order of its sums, the yardstick of (b)'s gaps
        "swapped": sharded_fit(
            device, in_order, ds,
            order.reshape(-1, 2, DLRM_RUN["batch"] // 2)[:, ::-1].reshape(-1),
            ckpt=root / "world1" / "swapped"),
        "model2_dlrm_optimizer": sharded_fit(
            device, {"mesh": {"data": 1, "model": 1},
                     "optimizer": "dlrm_optimizer"}, ds,
            ckpt=root / "world1" / "model2_dlrm_optimizer"),
    }
    config = {"DLRM_MODEL": DLRM_MODEL, "DLRM_RUN": DLRM_RUN, "SEED": SEED}
    # a session-local zygote, which ends with the session (the machine-wide
    # one outlives the script)
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    try:
        session = cluster.init(**SHARDED_CLUSTER)
        job = create_spmd_job("sharded-dlrm", world_size=2,
                              timeout=SHARDED_LIMIT_S).start()
        try:
            sizes = job.bootstrap_torch()
            require(sizes == [2, 2], f"the job's group: {sizes}")
            ranks = job.run(functools.partial(here.sharded_dlrm_rank,
                                              device.type, config,
                                              SHARDED_RUNS,
                                              str(root / "world2")),
                            timeout=SHARDED_LIMIT_S)
        finally:
            job.stop()
        cluster.shutdown()
        pids = [r["pid"] for r in ranks]
        t_gone = time.perf_counter()
        _wait_for(lambda: not _session_procs(session)
                  and not any(_probe_pid(p) == "alive" for p in pids),
                  SHARDED_DEADLINE_S,
                  f"the job's processes (ranks {pids}) to exit after shutdown")
        gone_s = time.perf_counter() - t_gone
    finally:
        if cluster.is_initialized():
            cluster.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    require(len(set(pids) | {os.getpid()}) == 3,
            "the ranks are not two processes of their own")

    swapped = refs["swapped"]
    out = {"world1_bitwise": bitwise, "world1_samples_s": world1["samples_s"],
           "world1_step_ms": world1["step_ms"], "runs": {},
           "gone_after_shutdown_s": gone_s,
           "launches": world1["launches"],
           "order_yardstick": {
               "epoch_gaps": epoch_gaps(root / "world1" / "swapped",
                                        root / "world1" / "data2_adam",
                                        DLRM_RUN["epochs"]),
               "loss_gap": max(abs(a - b) for a, b in zip(
                   swapped["train_loss"] + [swapped["evaluate"]["eval_loss"]],
                   refs["data2_adam"]["train_loss"]
                   + [refs["data2_adam"]["evaluate"]["eval_loss"]]))}}
    for name in SHARDED_RUNS:
        per_rank = [r["runs"][name] for r in ranks]
        out["launches"] += sum(run["launches"] for run in per_rank)
        first = per_rank[0]
        if name == "model2_adam":
            ref = {"train_loss": dlrm["train_loss"], "evaluate": dlrm["evaluate"],
                   "final_state": ref_state}
            gaps = step = None
        else:
            ref = refs[name]
            gaps = epoch_gaps(root / "world2" / name, root / "world1" / name,
                              DLRM_RUN["epochs"])
            step = step_gaps(ranks[0]["steps"][name], step_refs[name])
        pairs = list(zip(first["train_loss"] + [first["evaluate"]["eval_loss"]],
                         ref["train_loss"] + [ref["evaluate"]["eval_loss"]]))
        loss_rels = [abs(a - b) / abs(b) for a, b in pairs]
        gap = params_gap(first["final_state"], ref["final_state"])
        same = (first["train_loss"] == ref["train_loss"]
                and first["evaluate"] == ref["evaluate"] and gap == 0.0)
        out["runs"][name] = {
            "mesh": first["mesh"], "batch_per_rank": first["batch"],
            "table_rows_per_rank": first["table_rows"],
            "train_loss": first["train_loss"],
            "ranks_agree": all(run["train_loss"] == first["train_loss"]
                               for run in per_rank),
            "bitwise": same, "loss_rel": max(loss_rels),
            "loss_rels": loss_rels,
            "loss_gap": max(abs(a - b) for a, b in pairs), "step": step,
            "param_gap": gap, "epoch_gaps": gaps,
            "launches": [run["launches"] for run in per_rank],
            "forward_passes": first["forward_passes"],
            "samples_s": [run["samples_s"] for run in per_rank],
            "step_ms": [run["step_ms"] for run in per_rank],
            "peak_bytes": [run["peak_bytes"] for run in per_rank],
            "collective_share": [run["collective_share"] for run in per_rank],
            "collective_calls": [run["collective_calls"] for run in per_rank],
            "reference_samples_s": (world1["samples_s"] if name == "model2_adam"
                                    else refs[name]["samples_s"]),
        }
    out["phase_s"] = time.perf_counter() - t0
    log("sharded dlrm: world 1 bitwise phase_dlrm's, "
        f"{world1['samples_s']:.1f} samples/s; "
        + "; ".join(f"{name} {run['mesh']}: {run['samples_s'][0]:.1f} samples/s, "
                    f"step {run['step_ms'][0]:.2f} ms, all-reduce share "
                    f"{run['collective_share'][0]:.3f}, losses "
                    f"{run['train_loss']}, loss rels {run['loss_rels']}, "
                    f"epoch parameter gaps {run['epoch_gaps']}, one step "
                    f"{run['step']}"
                    for name, run in out["runs"].items())
        + f"; two world-1 fits of (b)'s batches, each batch's halves "
        f"swapped: {out['order_yardstick']}; phase {out['phase_s']:.1f} s")
    for name, run in out["runs"].items():
        for rank, got in enumerate(r["runs"][name] for r in ranks):
            sharded_verdict(f"{name} rank {rank}", got, device)
        require(run["ranks_agree"], f"sharded {name}: the ranks report other "
                "losses")
        if name == "model2_adam":
            require(run["bitwise"], f"sharded {name}: not bit for bit "
                    f"phase_dlrm's fit (loss rel {run['loss_rel']:.3e}, "
                    f"parameter gap {run['param_gap']:.3e})")
        else:
            step = run["step"]
            require(step["start_bitwise"]
                    and step["loss_rel"] <= SHARDED_STEP_RTOL
                    and step["worst_grad_rel"] <= SHARDED_STEP_RTOL
                    and step["worst_table_update_rel"]
                    <= SHARDED_TABLE_UPDATE_RTOL,
                    f"sharded {name}: one step against world 1's {step} "
                    f"(limits {SHARDED_STEP_RTOL}, tables' update "
                    f"{SHARDED_TABLE_UPDATE_RTOL})")
            require(run["loss_gap"] <= SHARDED_FIT_LOSS_ATOL,
                    f"sharded {name}: losses {run['train_loss']} against the "
                    f"world-1 fit's, gap {run['loss_gap']:.3e} (limit "
                    f"{SHARDED_FIT_LOSS_ATOL})")
    return out


DEPLOY_CLUSTER = dict(num_cpus=4, resources={"GPU": 1.0})
DEPLOY_LIMIT_S = 150.0  # the whole phase
DEPLOY_DEADLINE_S = 15.0  # a pool healed, the card's memory back
# the DLRM cell's deployment: 2 replicas; 4 closed-loop clients for 3 s of
# requests of 1-32 seeded rows on the default bucket ladder; then, on the
# one bucket of 256, 160 fixed requests from 4 clients, once clean, once
# with replica 0 SIGKILLed 50 ms in, and under a rolling reload to epoch 1
# (the top MLP perturbed by a seeded draw of scale 0.05); the profiled
# call's rows
DEPLOY_DLRM = dict(replicas=2, max_batch=256, clients=4, load_s=3.0,
                   max_rows=32, requests=160, kill_after_s=0.05, seed=21,
                   noise=0.05, profile_rows=64)
# the LM deployments: 2 replicas of the full-width model at max_len 2048,
# one client thread a stream
DEPLOY_LM = dict(replicas=2, max_len=2048)
# what phase_deploy's summary line prints (the record holds more)
DEPLOY_KEYS = ("dlrm_requests_s", "dlrm_p50_ms", "dlrm_p99_ms",
               "dlrm_batch_fill", "dlrm_stage_ms", "dlrm_kill_dropped",
               "dlrm_heal_s", "lm_heal_s", "dlrm_replica_load_s",
               "dlrm_replacement_load_s", "warm_split", "dlrm_reload",
               "k1_profile_us",
               "lm_kill_to_first_token_s", "lm_failovers", "lm_ttft_ms_p50",
               "lm_tpot_ms_p50", "lm_head_latency", "lm_int8_bitwise",
               "bf16_streams_differing", "deploy_s", "launches",
               "driver_exit_leaks", "phase_s")


def publish_checkpoint(directory: Path, epoch: int, model) -> None:
    """Write ``model``'s weights as the serving checkpoint of ``epoch``
    (the replicas' weight channel), through the estimator's checkpoint
    module."""
    from raydp_tpu_torch.estimator import checkpoint as ckpt

    ckpt.save_checkpoint(str(directory), epoch, None, model,
                         torch.optim.Adam(model.parameters()))


def reference_estimator(model, directory: Path) -> Estimator:
    """The driver's ``Estimator`` holding ``model``'s weights, loaded from
    a checkpoint of its own in ``directory`` (never the replicas')."""
    from raydp_tpu_torch.estimator import checkpoint as ckpt

    ckpt.save_checkpoint(str(directory), 0, None, model,
                         torch.optim.Adam(model.parameters()))
    est = Estimator(model=model, checkpoint_dir=str(directory),
                    device=model.device)
    est.load_latest_checkpoint()
    return est


def _dlrm_payload(dense, ids, rng, max_rows):
    n = int(rng.integers(1, max_rows + 1))
    start = int(rng.integers(0, len(dense) - n + 1))
    return dense[start:start + n], ids[start:start + n]


def _client_threads(clients: int, body) -> list:
    """``clients`` started threads running ``body(i)``; an exception is
    kept on the thread's ``error`` attribute."""
    import threading

    def run(i, thread):
        try:
            body(i)
        except BaseException as exc:  # noqa: BLE001 - surfaced by _join_clients
            thread.error = exc

    pool = []
    for i in range(clients):
        thread = threading.Thread(target=lambda i=i: run(i, pool[i]),
                                  daemon=True)
        thread.error = None
        pool.append(thread)
    for thread in pool:
        thread.start()
    return pool


def _join_clients(pool, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    for thread in pool:
        thread.join(max(0.0, deadline - time.monotonic()))
        require(not thread.is_alive(), f"{what}: a client did not finish")
        require(thread.error is None, f"{what}: a client raised {thread.error!r}")


def _fixed_requests(dep, payloads, clients, during=None) -> list:
    """Every payload predicted once, payload i by client i % clients in
    order; ``during()`` runs on this thread meanwhile."""
    outs = [None] * len(payloads)

    def client(c):
        for i in range(c, len(payloads), clients):
            outs[i] = dep.predict(payloads[i], timeout=120.0)

    pool = _client_threads(clients, client)
    if during is not None:
        during()
    _join_clients(pool, 180.0, "the fixed requests")
    return outs


def _replica_launches(dep) -> dict:
    """Each live replica's kernel launches so far, by pid, as the head
    holds them: ``dep.infos()`` has every replica ship its telemetry, whose
    ``ops.launches.<kernel>`` gauges carry its wrappers' counts
    (``obs.profiler.sample_launches``)."""
    from raydp_tpu_torch import cluster

    live = {info["pid"] for info in dep.infos()}
    out = {}
    for proc, snap in cluster.dump_metrics().items():
        pid = int(proc.rsplit(":", 1)[-1])
        if proc.startswith("worker:") and pid in live:
            out[pid] = {name[len("ops.launches."):]: int(value["value"])
                        for name, value in snap.items()
                        if name.startswith("ops.launches.")}
    require(set(out) == live, f"the head holds no launch counts of the "
            f"replicas {sorted(live - set(out))}")
    return out


def _launch_delta(before: dict, after: dict) -> dict:
    """Launches made between two ``_replica_launches`` reads, summed over
    the replicas alive at the second (a replica spawned between the reads
    counts from its start)."""
    out: dict = {}
    for pid, counts in after.items():
        for name, n in counts.items():
            out[name] = out.get(name, 0) + n - before.get(pid, {}).get(name, 0)
    return out


def _add_launches(total: dict, delta: dict) -> None:
    for name, n in delta.items():
        total[name] = total.get(name, 0) + n


def trace_kernel_us(path: str, pattern: str) -> list:
    """The device time (us) of each kernel event in a Chrome trace whose
    name contains ``pattern``."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e["dur"] for e in events
            if e.get("cat") == "kernel" and pattern in e.get("name", "")]


def _wait_healed(dep, replicas: int, replaced_before: float, metrics) -> float:
    t0 = time.perf_counter()
    _wait_for(lambda: dep.replica_count() == replicas
              and metrics.counter("serve.replica_replacements").value
              > replaced_before, DEPLOY_DEADLINE_S, "the pool to heal")
    return time.perf_counter() - t0


def deploy_references(device, state: dict, workdir: Path, prompts) -> dict:
    """Everything the driver computes on the card for ``phase_deploy``,
    before the phase's memory baseline: the DLRM reference estimators
    (epoch 0 and the perturbed epoch 1) and the kill probe's payloads with
    their padded answers; the LM checkpoints and the driver's
    ``DecodeEngine`` tokens (f32 model with f32 and int8 caches, bf16 model
    with an f32 cache). Epoch 0 of each model is published for the
    replicas; the DLRM's epoch 1 only at the reload."""
    from raydp_tpu_torch.exchange.features import pad_rows

    cfg = DEPLOY_DLRM
    columns, dense_cols, cat_cols = dlrm_columns()
    dense = np.stack([columns[c] for c in dense_cols], axis=1)
    ids = np.stack([columns[c] for c in cat_cols], axis=1)
    make = functools.partial(DLRM, **DLRM_MODEL)
    model = make(device=device, seed=SEED)
    model.load_state_dict(state)
    model.eval()
    publish_checkpoint(workdir / "dlrm", 0, model)
    est = reference_estimator(model, workdir / "dlrm_ref")
    # epoch 1: the top MLP perturbed by a seeded draw
    noise = torch.Generator().manual_seed(cfg["seed"])
    bumped = {k: v.clone() for k, v in state.items()}
    top = len(DLRM_MODEL["bottom_mlp"])
    for i in range(top, top + len(DLRM_MODEL["top_mlp"])):
        w = bumped[f"dense.{i}.weight"]
        w += cfg["noise"] * torch.randn(w.shape, generator=noise)
    new_model = make(device=device, seed=SEED)
    new_model.load_state_dict(bumped)
    new_model.eval()
    rng = np.random.default_rng(cfg["seed"])
    payloads = [_dlrm_payload(dense, ids, rng, cfg["max_rows"])
                for _ in range(cfg["requests"])]

    def padded(predictor):
        return [predictor.predict(pad_rows(p, cfg["max_batch"]))[:len(p[0])]
                for p in payloads]

    refs = {"dense": dense, "ids": ids, "dlrm": make, "dlrm_est": est,
            "dlrm_new": new_model, "payloads": payloads,
            "old_ref": padded(est),
            "new_ref": padded(reference_estimator(new_model,
                                                  workdir / "dlrm_ref1"))}
    require(not any(np.array_equal(a, b) for a, b in
                    zip(refs["old_ref"], refs["new_ref"])),
            "the perturbed weights answer as the old ones")

    f32 = functools.partial(TransformerLM, **MODEL,
                            max_len=DEPLOY_LM["max_len"], attn_impl="flash",
                            dtype=torch.float32)
    lm = f32(device=device, seed=SEED).eval()
    publish_checkpoint(workdir / "lm_f32", 0, lm)
    refs.update(lm_f32=f32,
                lm_ref=serve(lm, prompts, False, device)["tokens_by_stream"],
                lm_ref_int8=serve(lm, prompts, True, device)["tokens_by_stream"])
    bf16 = functools.partial(TransformerLM, **MODEL, attn_impl="flash")
    lm = bf16(device=device, seed=SEED).eval()
    publish_checkpoint(workdir / "lm_bf16", 0, lm)
    refs.update(lm_bf16=bf16,
                lm_ref_bf16=serve(lm, prompts, False, device)["tokens_by_stream"])
    return refs


def deploy_dlrm(device, refs: dict, workdir: Path, rec: dict, pids: set,
                launches: dict) -> None:
    """Step A of ``phase_deploy``: the DLRM cell's predictions."""
    from raydp_tpu_torch import serve as serving
    from raydp_tpu_torch.exchange.features import f_concat
    from raydp_tpu_torch.obs.metrics import metrics

    cfg = DEPLOY_DLRM
    dense, ids, make, est = refs["dense"], refs["ids"], refs["dlrm"], refs["dlrm_est"]
    payloads, old_ref, new_ref = refs["payloads"], refs["old_ref"], refs["new_ref"]
    served = workdir / "dlrm"
    conf = {"serve.max_batch_size": cfg["max_batch"]}
    example = (dense[:1], ids[:1])

    # 1. the load window on the default ladder, then K1 in a replica's
    # capture
    t0 = time.perf_counter()
    with serving.deploy(model=make, checkpoint_dir=str(served),
                        replicas=cfg["replicas"], device=str(device),
                        example=example, conf=conf) as dep:
        rec["deploy_s"] = {"dlrm": time.perf_counter() - t0}
        rec["dlrm_replica_load_s"] = [info["load_s"] for info in dep.infos()]
        before = _replica_launches(dep)
        pids.update(before)
        fill = metrics.histogram("serve.batch_fill")
        fill0 = (fill.count, fill.sum)
        records = [[] for _ in range(cfg["clients"])]
        t_end = time.monotonic() + cfg["load_s"]

        def client(i):
            rng = np.random.default_rng([cfg["seed"], i])
            while time.monotonic() < t_end:
                payload = _dlrm_payload(dense, ids, rng, cfg["max_rows"])
                t1 = time.perf_counter()
                out = dep.predict(payload, timeout=120.0)
                records[i].append((payload, out, time.perf_counter() - t1))

        t1 = time.perf_counter()
        _join_clients(_client_threads(cfg["clients"], client),
                      cfg["load_s"] + 120.0, "the load window")
        wall = time.perf_counter() - t1
        done = [r for rs in records for r in rs]
        got = np.concatenate([out for _, out, _ in done])
        ref = est.predict(f_concat([p for p, _, _ in done]))
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        require(rel <= 1e-5, f"DLRM responses differ from the driver's "
                f"predict by {rel:.3e} relative (limit 1e-5)")
        lat = sorted(1e3 * s for _, _, s in done)
        rec.update(
            dlrm_requests=len(done), dlrm_requests_s=len(done) / wall,
            dlrm_p50_ms=lat[len(lat) // 2],
            dlrm_p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            dlrm_rel_err=rel,
            dlrm_batch_fill=(fill.sum - fill0[1]) / max(1, fill.count - fill0[0]),
            dlrm_stage_ms={k: v["mean_ms"] for k, v in
                           dep.stats()["stage_latency"].items()})
        cap = dep.profile((dense[:cfg["profile_rows"]],
                           ids[:cfg["profile_rows"]]))
        rec["k1_profile_us"] = (trace_kernel_us(cap["trace_path"],
                                                "interaction_fwd_kernel")
                                if cap["trace_path"] else [])
        if device.type == "cuda":
            require(rec["k1_profile_us"] and min(rec["k1_profile_us"]) > 0,
                    "a replica's capture shows no interaction_fwd_kernel")
        after = _replica_launches(dep)
        _add_launches(launches, _launch_delta(before, after))
    log(f"deploy dlrm: 2 replicas up in {rec['deploy_s']['dlrm']:.3f} s "
        f"(their loads {rec['dlrm_replica_load_s']}); {len(done)} requests in {wall:.2f} s = "
        f"{rec['dlrm_requests_s']:.1f}/s, p50 {rec['dlrm_p50_ms']:.2f} ms, p99 "
        f"{rec['dlrm_p99_ms']:.2f} ms, batch fill {rec['dlrm_batch_fill']:.3f}, "
        f"stages (mean ms) {rec['dlrm_stage_ms']}, max rel err {rel:.2e}; "
        f"K1 in a replica's capture {rec['k1_profile_us']} us")

    # 2-3. one bucket: the kill probe and the rolling reload
    bucket = cfg["max_batch"]
    with serving.deploy(model=make, checkpoint_dir=str(served),
                        replicas=cfg["replicas"], device=str(device),
                        example=example,
                        conf=conf | {"serve.batch_buckets": [bucket]}) as dep:
        before = _replica_launches(dep)
        pids.update(before)
        clean = _fixed_requests(dep, payloads, cfg["clients"])
        require(all(np.array_equal(a, b) for a, b in zip(clean, old_ref)),
                "DLRM responses at the one bucket differ from the driver's "
                "predict of the rows padded to it")
        dropped = metrics.counter("serve.dropped_requests")
        replaced = metrics.counter("serve.replica_replacements")
        dropped0, replaced0 = dropped.value, replaced.value
        victim = dep.infos()[0]["pid"]
        mid = _replica_launches(dep)
        _add_launches(launches, _launch_delta(before, mid))

        def kill():
            time.sleep(cfg["kill_after_s"])
            os.kill(victim, signal.SIGKILL)

        killed = _fixed_requests(dep, payloads, cfg["clients"], during=kill)
        require(dropped.value == dropped0, "the kill dropped requests")
        require(all(np.array_equal(a, b) for a, b in zip(killed, clean)),
                "a response through the kill differs from the clean run's")
        rec["dlrm_kill_dropped"] = dropped.value - dropped0
        rec["dlrm_heal_s"] = _wait_healed(dep, cfg["replicas"], replaced0,
                                          metrics)
        rec["dlrm_replacement_load_s"] = [
            info["load_s"] for info in dep.infos() if info["pid"] not in pids]
        rec["dlrm_replacements"] = replaced.value - replaced0
        before = _replica_launches(dep)
        pids.update(before)

        publish_checkpoint(served, 1, refs["dlrm_new"])
        import threading

        stop = threading.Event()
        seen = [[] for _ in range(cfg["clients"])]

        def client(c):
            while not stop.is_set():
                for i in range(c, len(payloads), cfg["clients"]):
                    seen[c].append((i, dep.predict(payloads[i], timeout=120.0)))

        pool = _client_threads(cfg["clients"], client)
        _wait_for(lambda: sum(map(len, seen)) >= cfg["requests"] // 2, 60.0,
                  "traffic before the reload")
        t1 = time.perf_counter()
        infos = dep.reload()
        reload_s = time.perf_counter() - t1
        stop.set()
        _join_clients(pool, 120.0, "the reload's traffic")
        kinds = {"old": 0, "new": 0, "other": 0}
        for i, out in (r for rs in seen for r in rs):
            kinds["old" if np.array_equal(out, old_ref[i]) else
                  "new" if np.array_equal(out, new_ref[i]) else "other"] += 1
        require(kinds["other"] == 0,
                f"responses during the reload were neither weights': {kinds}")
        require([i["epoch"] for i in infos] == [1] * cfg["replicas"],
                f"the reload left epochs {[i['epoch'] for i in infos]}")
        after = _fixed_requests(dep, payloads, cfg["clients"])
        require(all(np.array_equal(a, b) for a, b in zip(after, new_ref)),
                "a response after the reload is not the new weights'")
        rec["dlrm_reload"] = kinds | {"reload_s": reload_s}
        _add_launches(launches, _launch_delta(before, _replica_launches(dep)))
    log(f"deploy dlrm kill probe: {cfg['requests']} requests bitwise the clean "
        f"run through replica {victim}'s SIGKILL, {rec['dlrm_kill_dropped']} "
        f"dropped, healed in {rec['dlrm_heal_s']:.3f} s; reload in "
        f"{reload_s:.3f} s, responses meanwhile {kinds}, after it all new; "
        f"the replacement's load {rec['dlrm_replacement_load_s']}")


def _stream_clients(dep, prompts, max_new, kill_pid=None) -> dict:
    """One client thread a prompt through ``dep.stream``; with
    ``kill_pid``, SIGKILL that replica once every stream has emitted two
    tokens. Returns each stream's tokens and their arrival times, the
    tokens each stream had at the kill, and the kill's time."""
    tokens = [[] for _ in prompts]
    stamps = [[] for _ in prompts]

    def client(i):
        for tok in dep.stream(prompts[i], max_new, timeout=300.0):
            tokens[i].append(tok)
            stamps[i].append(time.monotonic())

    t_start = time.monotonic()
    pool = _client_threads(len(prompts), client)
    out = {"t_start": t_start, "t_kill": None, "at_kill": None}
    if kill_pid is not None:
        _wait_for(lambda: all(len(t) >= 2 for t in tokens)
                  or any(th.error for th in pool), 120.0,
                  "every stream's second token")
        out["at_kill"] = [len(t) for t in tokens]
        out["t_kill"] = time.monotonic()
        os.kill(kill_pid, signal.SIGKILL)
    _join_clients(pool, 300.0, "the streams")
    out.update(tokens=tokens, stamps=stamps)
    return out


def _client_latency(run: dict) -> dict:
    ttft = [1e3 * (s[0] - run["t_start"]) for s in run["stamps"]]
    tpot = [1e3 * (s[-1] - s[0]) / (len(s) - 1) for s in run["stamps"]
            if len(s) > 1]
    return {"ttft_ms_p50": statistics.median(ttft),
            "tpot_ms_p50": statistics.median(tpot)}


def _kill_to_first_token(run: dict) -> float:
    """The longest wait, over the streams, from the kill to the stream's
    first token after it: a stream that failed over waits for the heal and
    its re-prefill on a survivor."""
    t_kill = run["t_kill"]
    return max(min((s for s in stamps if s > t_kill), default=t_kill) - t_kill
               for stamps in run["stamps"])


def _head_latency(cluster) -> dict:
    """``serve.ttft_ms`` / ``serve.tpot_ms`` and the engine's
    ``serve.decode.prefill_s`` of each replica process as the head last
    received them: p50 and count."""
    out = {}
    for proc, snap in cluster.dump_metrics().items():
        if not proc.startswith("worker:"):
            continue
        for name in ("serve.ttft_ms", "serve.tpot_ms", "serve.decode.prefill_s"):
            hist = snap.get(name) or {}
            if hist.get("count"):
                out.setdefault(proc, {})[name] = {"p50": hist["p50"],
                                                  "count": hist["count"]}
    return out


def deploy_lm(device, refs: dict, workdir: Path, rec: dict, pids: set,
              launches: dict, prompts) -> None:
    """Step B of ``phase_deploy``: full-width ``TransformerLM`` streams."""
    from raydp_tpu_torch import cluster
    from raydp_tpu_torch import serve as serving
    from raydp_tpu_torch.obs.metrics import metrics

    new_tokens = ENGINE["max_new_tokens"]
    conf = {"serve.decode.enabled": True,
            "serve.decode.capacity_tokens": ENGINE["capacity_tokens"],
            "serve.decode.page_tokens": ENGINE["page_tokens"],
            "serve.decode.max_seqs": ENGINE["max_seqs"],
            "serve.decode.max_new_tokens": new_tokens}
    f32, ref, ref_int8 = refs["lm_f32"], refs["lm_ref"], refs["lm_ref_int8"]
    failovers = metrics.counter("serve.decode.failovers")
    replaced = metrics.counter("serve.replica_replacements")
    cuda = device.type == "cuda"

    # 1-2. f32 model, f32 cache: clean, then through a SIGKILL
    t0 = time.perf_counter()
    with serving.deploy(model=f32, checkpoint_dir=str(workdir / "lm_f32"),
                      replicas=DEPLOY_LM["replicas"], device=str(device),
                      conf=conf) as dep:
        rec["deploy_s"]["lm_f32"] = time.perf_counter() - t0
        rec["lm_replica_load_s"] = [info["load_s"] for info in dep.infos()]
        before = _replica_launches(dep)
        pids.update(before)
        clean = _stream_clients(dep, prompts, new_tokens)
        require(clean["tokens"] == ref, "the replicas' f32 streams differ "
                "from the driver's DecodeEngine")
        if not cuda:  # there the KV pools are arenas of the store
            require(_rtpt_segments(), "no KV arena in the session's namespace")
        mid = _replica_launches(dep)
        delta = _launch_delta(before, mid)
        if cuda:
            require(delta["flash_fwd_f32"] > 0 and delta["flash_decode"] > 0,
                    f"K2a's f32 body or K4a never launched in a replica: "
                    f"{delta}")
        _add_launches(launches, delta)
        rec.update({f"lm_{k}": v for k, v in _client_latency(clean).items()})
        failovers0, replaced0 = failovers.value, replaced.value
        victim = dep.infos()[0]["pid"]
        killed = _stream_clients(dep, prompts, new_tokens, kill_pid=victim)
        require(killed["tokens"] == ref, "an f32 stream through the kill "
                "differs from the clean run")
        rec["lm_failovers"] = failovers.value - failovers0
        require(rec["lm_failovers"] >= 1, "no stream failed over")
        rec["lm_kill_to_first_token_s"] = _kill_to_first_token(killed)
        rec["lm_heal_s"] = _wait_healed(dep, DEPLOY_LM["replicas"], replaced0,
                                        metrics)
        after = _replica_launches(dep)
        pids.update(after)
        delta = _launch_delta(mid, after)
        if cuda:
            require(delta["flash_fwd_f32"] > 0 and delta["flash_decode"] > 0,
                    f"K2a's f32 body or K4a never launched in a replica "
                    f"through the kill: {delta}")
        _add_launches(launches, delta)
        rec["lm_head_latency"] = _head_latency(cluster)
    log(f"deploy lm f32: streams bitwise the driver's engine, clean and "
        f"through replica {victim}'s SIGKILL ({rec['lm_failovers']:.0f} "
        f"failovers, kill to first token {rec['lm_kill_to_first_token_s']:.3f}"
        f" s, healed in {rec['lm_heal_s']:.3f} s); client TTFT p50 "
        f"{rec['lm_ttft_ms_p50']:.2f} ms, TPOT p50 {rec['lm_tpot_ms_p50']:.2f} "
        f"ms; head {rec['lm_head_latency']}")

    # 3. the int8 cache, clean
    t0 = time.perf_counter()
    with serving.deploy(model=f32, checkpoint_dir=str(workdir / "lm_f32"),
                      replicas=DEPLOY_LM["replicas"], device=str(device),
                      conf=conf | {"serve.decode.int8_kv": True}) as dep:
        rec["deploy_s"]["lm_int8_cache"] = time.perf_counter() - t0
        before = _replica_launches(dep)
        pids.update(before)
        run = _stream_clients(dep, prompts, new_tokens)
        rec["lm_int8_bitwise"] = run["tokens"] == ref_int8
        require(rec["lm_int8_bitwise"], "the replicas' int8-cache streams "
                "differ from the driver's int8-cache engine")
        delta = _launch_delta(before, _replica_launches(dep))
        if cuda:
            require(delta["flash_decode_int8"] > 0 and delta["quantize_int8"] > 0,
                    f"K4b or quantize_rows_kernel never launched in a "
                    f"replica: {delta}")
        _add_launches(launches, delta)

    # 4. the bf16 model (phase_serve's weights), f32 cache, through a kill
    bf16, ref_bf16 = refs["lm_bf16"], refs["lm_ref_bf16"]
    t0 = time.perf_counter()
    with serving.deploy(model=bf16, checkpoint_dir=str(workdir / "lm_bf16"),
                      replicas=DEPLOY_LM["replicas"], device=str(device),
                      conf=conf) as dep:
        rec["deploy_s"]["lm_bf16"] = time.perf_counter() - t0
        before = _replica_launches(dep)
        pids.update(before)
        victim = dep.infos()[0]["pid"]
        replaced0 = replaced.value
        run = _stream_clients(dep, prompts, new_tokens, kill_pid=victim)
        prefix_equal = all(t[:n] == r[:n] for t, r, n in
                           zip(run["tokens"], ref_bf16, run["at_kill"]))
        require(prefix_equal, "a bf16 stream's tokens before the kill differ "
                "from the driver's engine")
        rec["bf16_streams_differing"] = sum(t != r for t, r in
                                            zip(run["tokens"], ref_bf16))
        _wait_healed(dep, DEPLOY_LM["replicas"], replaced0, metrics)
        after = _replica_launches(dep)
        pids.update(after)
        delta = _launch_delta(before, after)
        if cuda:
            require(delta["flash_fwd"] > 0,
                    f"K2a's bf16 body never launched in a replica: {delta}")
        _add_launches(launches, delta)
    log(f"deploy lm int8 cache: bitwise the driver's int8-cache engine; bf16 "
        f"model through a SIGKILL: tokens before the kill equal, "
        f"{rec['bf16_streams_differing']} of {len(prompts)} streams differ "
        f"after it (reported, not gated)")


class WarmProbe:
    """An actor forked from the zygote as a replica is, which splits what a
    DLRM replica's first warm pays, in the replica's order: the lazy
    imports of a first ``FlopCounterMode`` dispatch (``count_flops``), the
    CUDA context, the model built on the device, its first forward (the
    kernel libraries loaded: the port's, cuBLAS), then one forward counted
    by ``count_flops`` and one plain, as a warm in a warmed process."""

    def __init__(self, device: str):
        self.device = torch.device(device)

    def split(self, rows: int) -> dict:
        from torch.utils.flop_counter import FlopCounterMode

        from raydp_tpu_torch.obs.costmodel import count_flops

        cuda = self.device.type == "cuda"
        out = {"pid": os.getpid(),
               "dynamo_in_fork": "torch._dynamo" in sys.modules,
               "cuda_in_fork": torch.cuda.is_initialized()}

        def timed(key, fn):
            t0 = time.perf_counter()
            result = fn()
            if cuda:
                torch.cuda.synchronize(self.device)
            out[key] = time.perf_counter() - t0
            return result

        def first_dispatch():
            with FlopCounterMode(display=False):
                return torch.ones(2) + 1  # on the host: no CUDA here

        timed("import_s", first_dispatch)
        if cuda:
            timed("context_s", lambda: torch.zeros(1, device=self.device))
        model = timed("model_s", lambda: DLRM(
            **DLRM_MODEL, device=self.device, seed=SEED).eval())
        rng = np.random.default_rng(SEED)
        x = (rng.standard_normal((rows, DLRM_MODEL["num_dense"]),
                                 dtype=np.float32),
             np.stack([rng.integers(0, v, rows, dtype=np.int32)
                       for v in DLRM_MODEL["vocab_sizes"]], axis=1))
        with torch.no_grad():
            timed("first_forward_s", lambda: model(x))
            timed("counted_forward_s", lambda: count_flops(lambda: model(x)))
            timed("forward_s", lambda: model(x))
        return out


def warm_split(device) -> dict:
    """``WarmProbe.split`` at the one bucket of ``DEPLOY_DLRM``, in a light
    actor forked from the running session's zygote; the actor is killed
    after it."""
    from raydp_tpu_torch import cluster

    here = importlib.import_module("chip_smoke")  # actor classes by reference
    probe = cluster.spawn(here.WarmProbe, str(device), name="warm-probe",
                          light=True)
    try:
        return probe.split(DEPLOY_DLRM["max_batch"])
    finally:
        probe.kill()


def _rtpt_segments() -> set:
    """The store segments of this process's shm namespace, which
    ``phase_deploy`` gives its session alone: another session's segments
    on the same host are never counted."""
    import glob

    from raydp_tpu_torch.cluster.common import SHM_PREFIX, shm_namespace

    ns = shm_namespace()
    require(ns, "no shm namespace: the segment check would see the host's")
    return set(glob.glob(f"/dev/shm/{SHM_PREFIX}{ns}-*"))


def phase_deploy(device, dlrm_state: dict, prompts=None) -> dict:
    """The port's serving plane (``serve.deploy``) on the card, in a
    cluster of the port (4 CPUs, the card as ``GPU``; the session-local
    zygote with the torch warm set; lockdep and the leak audit armed), 2
    light replicas a deployment:

    A. the uncut DLRM cell (``DLRM_MODEL``, ``phase_dlrm``'s final state
       as epoch 0): (1) 4 closed-loop clients for 3 s, each response within
       1e-5 relative of the driver's ``Estimator.predict``, with requests/s,
       p50/p99, the mean batch fill and the stage split; ``dep.profile``
       lists ``interaction_fwd_kernel`` with its device time; (2) at the one
       bucket of 256, 160 fixed requests clean, then with replica 0
       SIGKILLed 50 ms in: none dropped, each bitwise the clean run's and the
       driver's predict of the rows padded to 256, the pool back to 2
       within 15 s; (3) a rolling reload to epoch 1 (the top MLP perturbed)
       under the same load: each response bitwise the old weights' or the
       new's, and all new after ``reload`` returns;
    B. the full-width ``TransformerLM`` in f32 (``MODEL`` at max_len 2048)
       through ``Deployment.stream`` (``ENGINE``'s conf, 8 prompts, a client
       thread each): (1) tokens bitwise the driver's ``DecodeEngine``'s;
       (2) again with replica 0 SIGKILLed once every stream has two tokens:
       the same tokens, at least one failover, the pool healed, the longest
       wait from the kill to a stream's next token; (3) the int8 cache,
       bitwise the driver's int8-cache engine; (4) the bf16 model
       (``phase_serve``'s weights, f32 cache) through a kill: the tokens
       before the kill equal, the streams that differ after it counted.
       ``flash_fwd_f32`` and ``flash_decode`` launch in the replicas in (1)
       and (2), ``flash_decode_int8`` and ``quantize_int8`` in (3),
       ``flash_fwd`` in (4) (each replica's ``ops.launches.*`` gauges on the
       head, read before and after);
    C. every deployment closed, ``shutdown()``: no replica process alive,
       no ``rtpt-`` segment left in the session's own shm namespace (its
       CPU KV arenas' home), the card's free memory back within
       ``CARD_MEMORY_SLACK`` of before the cluster, the driver's leak audit
       at 0.

    The whole phase takes at most ``DEPLOY_LIMIT_S``."""
    from raydp_tpu_torch import cluster
    from raydp_tpu_torch.cluster import api as capi
    from raydp_tpu_torch.cluster.common import SHM_NS_ENV, _probe_pid
    from raydp_tpu_torch.cluster.zygote import WARM_TORCH_ENV
    from raydp_tpu_torch.obs.metrics import metrics
    from raydp_tpu_torch.obs.profiler import ARTIFACTS_DIR_ENV

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    workdir = BUILD_DIR / "deploy"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    if prompts is None:
        prompts = make_prompts(N_STREAMS, *PROMPT_LENS, MODEL["vocab_size"])
    # the session's own shm namespace: its segments are rtpt-<ns>-*, so
    # the teardown's check never counts another session's on this host
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", WARM_TORCH_ENV: "1",
             SHM_NS_ENV: f"deploy{os.getpid()}",
             "RAYDP_TPU_SANITIZE": "lockdep,leaks",
             ARTIFACTS_DIR_ENV: str(workdir / "artifacts")}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    rec: dict = {"replicas": DEPLOY_LM["replicas"]}
    launches: dict = {}
    pids: set = set()
    try:
        refs = deploy_references(device, dlrm_state, workdir, prompts)

        def free_bytes():
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            return torch.cuda.mem_get_info(device)[0]

        mem_base = free_bytes() if cuda else None
        session = cluster.init(**DEPLOY_CLUSTER)
        _wait_for(lambda: _zygote_serves(session), 30.0, "the zygote's warm-up")
        rec["warm_split"] = warm_split(device)
        pids.add(rec["warm_split"]["pid"])
        log(f"deploy: a forked replica's first warm, split (s): "
            f"{rec['warm_split']}")
        deploy_dlrm(device, refs, workdir, rec, pids, launches)
        deploy_lm(device, refs, workdir, rec, pids, launches, prompts)
        rec["launches"] = launches
        t0 = time.perf_counter()
        cluster.shutdown()
        _wait_for(lambda: not any(_probe_pid(p) == "alive" for p in pids),
                  DEPLOY_DEADLINE_S, f"the replica processes {sorted(pids)} to exit")
        rec["gone_after_shutdown_s"] = time.perf_counter() - t0
        left = _rtpt_segments()
        require(not left, f"segments left after shutdown: {sorted(left)}")
        rec["driver_exit_leaks"] = {
            name: snap["value"] for name, snap in metrics.snapshot().items()
            if name.startswith("sanitize.leaked")}
        require(rec["driver_exit_leaks"].get("sanitize.leaked_shm_segments") == 0,
                f"the driver's leak audit: {rec['driver_exit_leaks']}")
        if cuda:
            rec["memory_back_s"] = _wait_for(
                lambda: (time.perf_counter() - t0)
                if free_bytes() >= mem_base - CARD_MEMORY_SLACK else 0.0,
                DEPLOY_DEADLINE_S, "the replicas' device memory")
            rec["memory_free_delta_bytes"] = free_bytes() - mem_base
        else:  # no card: nothing to give back
            rec["memory_back_s"] = None
    finally:
        if capi.is_initialized():
            cluster.shutdown()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["replica_pids"] = sorted(pids)
    rec["phase_s"] = time.perf_counter() - t_phase
    require(rec["phase_s"] <= DEPLOY_LIMIT_S,
            f"phase_deploy took {rec['phase_s']:.1f} s")
    log(f"deploy: {len(pids)} replica processes, none left "
        f"{rec['gone_after_shutdown_s']:.3f} s after shutdown, card memory back "
        f"after {rec['memory_back_s']} s, driver exit leaks "
        f"{rec['driver_exit_leaks']}, launches in replicas {launches}, deploy "
        f"walls {rec['deploy_s']}, phase {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 4, continued: the estimator's streamed, checkpointed and retried fit
# ---------------------------------------------------------------------------

# per row on the wire: 8 dense f32 (32 bytes; int8 wire: 8 int8 and one f32
# scale, 12), 6 int32 ids (24), an f32 label (4)
DENSE_ROW_BYTES = 4 * DLRM_MODEL["num_dense"]
WIRE_DENSE_ROW_BYTES = DLRM_MODEL["num_dense"] + 4
OTHER_ROW_BYTES = 4 * len(DLRM_MODEL["vocab_sizes"]) + 4
STREAM_MODES = {"streamed": dict(streaming=True),
                "hybrid": dict(streaming="hybrid"),
                "int8 wire": dict(streaming=True, stream_wire_quant="int8")}


def epoch_timing(history, steps: int) -> dict:
    """Samples/s and step ms of epochs 2 on (the first holds set-up)."""
    timed = history[1:]
    seconds = sum(r["epoch_seconds"] for r in timed)
    return {"samples_s": len(timed) * steps * DLRM_RUN["batch"] / seconds,
            "step_ms": 1e3 * seconds / (len(timed) * steps)}


def streamed_fits(device, ds, dense_cols, cat_cols, staged=None) -> dict:
    """Step 1: the three streamed fits at full width, 3 epochs each: losses
    finite and falling 10%, one K1 launch per forward pass, the bytes each
    epoch uploads (hybrid epochs 2-3 none; the int8 wire 12 of the 32 dense
    bytes a row); their times beside the staged fit's (``staged``,
    phase_dlrm's record) where given."""
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]
    rows = steps * DLRM_RUN["batch"]
    epochs = DLRM_RUN["epochs"]
    out = {}
    for name, kw in STREAM_MODES.items():
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ia.reset_launches()
        history = est.fit(ds)
        torch.cuda.synchronize()
        launches = ia.LAUNCHES["interaction_fwd"]
        losses = [r["train_loss"] for r in history]
        stats = est.stream_stats_
        dense = WIRE_DENSE_ROW_BYTES if "wire" in name else DENSE_ROW_BYTES
        expect = {e: rows * (dense + OTHER_ROW_BYTES) for e in range(epochs)}
        if name == "hybrid":
            expect = {0: expect[0]}
        got_dense = (stats["bytes_by_epoch"][0] / rows) - OTHER_ROW_BYTES
        row = {"train_loss": losses, "launches": launches,
               "forward_passes": epochs * steps,
               "bytes_by_epoch": stats["bytes_by_epoch"],
               "dense_bytes_a_row": got_dense,
               "cached_epochs": stats["cached_epochs"],
               "producer_idle_s": stats["producer_idle_s"],
               "consumer_idle_s": stats["consumer_idle_s"],
               **epoch_timing(history, steps),
               "fit_stats": est.fit_stats_}
        log(f"fit step 1, {name}: train_loss {losses}; interaction_fwd "
            f"launches {launches} for {epochs * steps} forward passes; bytes "
            f"by epoch {stats['bytes_by_epoch']} ({got_dense:g} dense bytes "
            f"a row), cached epochs {stats['cached_epochs']}; "
            f"{row['samples_s']:.1f} samples/s, step {row['step_ms']:.3f} ms"
            + (f" (staged {staged['samples_s']:.1f} samples/s, step "
               f"{staged['step_ms']:.3f} ms)" if staged else "")
            + f"; idle: producer "
            f"{stats['producer_idle_s']:.3f} s, consumer "
            f"{stats['consumer_idle_s']:.3f} s")
        require(all(math.isfinite(x) for x in losses), f"{name} loss not finite")
        require(losses[-1] < 0.9 * losses[0], f"{name} loss did not fall by 10%")
        require(launches == epochs * steps,
                f"{name}: interaction_fwd launched {launches} times, "
                f"expected {epochs * steps}")
        require(stats["bytes_by_epoch"] == expect,
                f"{name}: bytes by epoch {stats['bytes_by_epoch']}, "
                f"expected {expect}")
        require(stats["cached_epochs"] == (epochs - 1 if name == "hybrid" else 0),
                f"{name}: {stats['cached_epochs']} cached epochs")
        out[name] = row
        out[name]["estimator"] = est
    return out


def wire_round_trip(ds, dense_cols):
    """``ds`` with its dense features replaced by their int8 wire round trip
    on the host, ``dequantize_rows(quantize_rows(.))`` per row: the values a
    wire-quant fit trains on."""
    dense = np.stack([ds.columns[c] for c in dense_cols], axis=1)
    back = torch_io.dequantize_rows(*torch_io.quantize_rows(dense))
    columns = dict(ds.columns) | {c: back[:, i] for i, c in enumerate(dense_cols)}
    return ArrayDataset(columns, ds.counts)


def segment_parity(device, ds, dense_cols, cat_cols, streamed) -> dict:
    """Step 1, continued: segment memory reuse across streams. The segmented
    fits (pinned slots, copies on side streams, events, ``record_stream``,
    the hybrid cache on the card) against fits fed one batch at a time on
    the compute stream (``stream_scan_steps=0``), bit for bit in their
    train_loss histories and final parameters:

    - the streamed fit against the per-step fit on the same data;
    - the int8-wire fit against the per-step fit on the data's wire round
      trip (``widen_wire`` equals ``dequantize_rows``, step 2);
    - the hybrid fit's first epoch, the one it uploads, against the
      per-step fit's; and a hybrid fit without shuffle, whose cached epochs
      replay the first in order, against a per-step fit without shuffle,
      every epoch and the parameters.

    Each new fit launches K1 once a forward pass."""
    epochs = DLRM_RUN["epochs"]
    forwards = epochs * (DLRM_RUN["rows"] // DLRM_RUN["batch"])
    launches = []

    def fit(data, **kw):
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs,
                             **kw)
        ia.reset_launches()
        history = est.fit(data)
        torch.cuda.synchronize()
        launches.append(ia.LAUNCHES["interaction_fwd"])
        require(launches[-1] == forwards,
                f"{kw}: interaction_fwd launched {launches[-1]} times, "
                f"expected {forwards}")
        return [r["train_loss"] for r in history], params_of(est)

    def per_step(data, **kw):
        return fit(data, streaming=True, stream_scan_steps=0, **kw)

    def of(name):
        est = streamed[name]["estimator"]
        return streamed[name]["train_loss"], params_of(est)

    ref = per_step(ds)
    ref_still = per_step(ds, shuffle=False)
    hybrid = of("hybrid")
    pairs = {
        "streamed": (of("streamed"), ref),
        "int8 wire": (of("int8 wire"), per_step(wire_round_trip(ds, dense_cols))),
        "hybrid, epoch 0": ((hybrid[0][:1], []), (ref[0][:1], [])),
        "hybrid, no shuffle": (fit(ds, streaming="hybrid", shuffle=False),
                               ref_still),
    }
    out = {"launches": sum(launches), "forward_passes": len(launches) * forwards}
    for name, ((losses, params), (ref_losses, ref_params)) in pairs.items():
        same = losses == ref_losses and bits_equal(params, ref_params)
        out[name] = same
        log(f"fit step 1, {name} vs one batch at a time: train_loss {losses} "
            f"vs {ref_losses}; histories and parameters bitwise equal: {same}")
        require(same, f"{name}: the segmented fit disagrees with the per-step "
                "fit in its bits")
    return out


def check_widen(device, ds, dense_cols) -> dict:
    """Step 2: ``widen_wire`` on the card equals ``dequantize_rows`` on the
    host bit for bit, on one batch's dense features [2048, 8] and on a
    segment of 32 batches [32, 2048, 8] (the streamed fit's shape)."""
    dense = ds.to_numpy(dense_cols)[0]
    batch = DLRM_RUN["batch"]
    out = {}
    for shape in ((batch, len(dense_cols)), (32, batch, len(dense_cols))):
        x = dense[:math.prod(shape[:-1])].reshape(shape)
        q, s = torch_io.quantize_rows(x)
        ref = torch_io.dequantize_rows(q, s)
        got = torch_io.widen_wire(torch.from_numpy(q).to(device),
                                  torch.from_numpy(s).to(device))
        got = got.cpu().numpy()
        bad = int((got.view(np.uint32) != ref.view(np.uint32)).sum())
        out[str(list(shape))] = bad
        log(f"fit step 2: widen_wire {list(shape)} on the card vs "
            f"dequantize_rows on the host: {bad} elements differ in their bits")
        require(bad == 0, f"widen_wire {list(shape)} disagrees with "
                f"dequantize_rows in {bad} elements")
    return out


def params_of(est) -> list:
    return [p.detach().clone() for p in est.get_model().parameters()]


def bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def crash_and_retry(device, ds, dense_cols, cat_cols, ckpt_dir: Path,
                    **kw) -> dict:
    """A 2-epoch fit with step checkpoints every 16 steps and a crash planted
    after epoch 1's step-32 checkpoint, run with ``max_retries=1``."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    at = FIT_RUN["crash_at"]
    est = dlrm_estimator(device, dense_cols, cat_cols, "adam",
                         FIT_RUN["retry_epochs"], checkpoint_dir=str(ckpt_dir),
                         save_every_steps=FIT_RUN["save_every_steps"], **kw)
    save = est._save_checkpoint
    planted = {"left": 1}

    def crashing(model, opt, epoch, step=None):
        save(model, opt, epoch, step)
        if (epoch, step) == at and planted["left"]:
            planted["left"] -= 1
            raise RuntimeError(f"planted crash after {at}")

    est._save_checkpoint = crashing
    resumes = []
    fit_once = est._fit_once

    def spying(train_ds, evaluate_ds):
        resumes.append(est.resume_from_epoch)
        return fit_once(train_ds, evaluate_ds)

    est._fit_once = spying
    ia.reset_launches()
    history = est.fit(ds, max_retries=1)
    torch.cuda.synchronize()
    stats = est.checkpoint_stats_  # of the attempt that finished
    return {"estimator": est, "history": history, "resumes": resumes,
            "retried_errors": est.retried_errors_,
            "launches": ia.LAUNCHES["interaction_fwd"],
            "dirs": sorted(os.listdir(ckpt_dir)),
            "checkpoint_ms": 1e3 * stats["seconds"] / max(stats["saves"], 1),
            "checkpoint_bytes": stats["bytes"] // max(stats["saves"], 1),
            "checkpoints": stats["saves"]}


def check_retries(device, ds, dense_cols, cat_cols) -> dict:
    """Step 3: the crash-and-retry fit, staged and streamed, resumes at (1,
    32) with the planted crash its only absorbed error, and ends on the
    uninterrupted fit's parameters bit for bit; only epoch checkpoints are
    left after it, and with ``keep_checkpoints=1`` (the streamed run) one."""
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]
    epochs = FIT_RUN["retry_epochs"]
    at = FIT_RUN["crash_at"]
    # the 80 steps before the crash and the 16 the retry runs
    forwards = epochs * steps
    root = BUILD_DIR / "checkpoints"
    out = {}
    for name, kw, keep in (("staged", {}, None),
                           ("streamed", dict(streaming=True), 1)):
        ref_a = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ref_a.fit(ds)
        ref_b = dlrm_estimator(device, dense_cols, cat_cols, "adam", epochs, **kw)
        ref_b.fit(ds)
        torch.cuda.synchronize()
        repeat = bits_equal(params_of(ref_a), params_of(ref_b))
        run = crash_and_retry(device, ds, dense_cols, cat_cols, root / name,
                              keep_checkpoints=keep, **kw)
        same = bits_equal(params_of(run.pop("estimator")), params_of(ref_a))
        expect_dirs = ([f"epoch_{epochs - 1}"] if keep == 1
                       else [f"epoch_{e}" for e in range(epochs)])
        row = {k: v for k, v in run.items() if k != "history"}
        row |= {"repeat_bitwise": repeat, "resumed_bitwise": same,
                "forward_passes": forwards}
        log(f"fit step 3, {name}: resumes {run['resumes']}, absorbed "
            f"{run['retried_errors']}; two uninterrupted fits bitwise equal: "
            f"{repeat}; the retried fit's parameters bitwise equal to the "
            f"uninterrupted fit's: {same}; interaction_fwd launches "
            f"{run['launches']} for {row['forward_passes']} forward passes; "
            f"left {run['dirs']}; {run['checkpoints']} checkpoints of the "
            f"retried attempt, {run['checkpoint_ms']:.2f} ms and "
            f"{run['checkpoint_bytes']} bytes each")
        require(run["resumes"] == [None, at],
                f"{name}: the retry resumed at {run['resumes']}, expected {at}")
        require(run["retried_errors"] == [f"RuntimeError: planted crash after {at}"],
                f"{name}: the retry absorbed {run['retried_errors']}")
        require(repeat, f"{name}: two uninterrupted fits disagree in their "
                "parameters' bits")
        require(same, f"{name}: the retried fit disagrees with the "
                "uninterrupted fit in its parameters' bits")
        require(run["launches"] == row["forward_passes"],
                f"{name}: interaction_fwd launched {run['launches']} times, "
                f"expected {row['forward_passes']}")
        require(run["dirs"] == expect_dirs,
                f"{name}: {run['dirs']} left, expected {expect_dirs}")
        out[name] = row
    shutil.rmtree(root, ignore_errors=True)
    return out


def fit_attribution(device, ds, dense_cols, cat_cols, streamed) -> dict:
    """Step 4: ``explain_last_fit()`` of the streamed fit (its phase split
    and the share of the fit's wall time the split covers), a trace written
    by ``profile_dir``, and the card's busy share of one streamed epoch."""
    from torch.profiler import ProfilerActivity, profile

    est = streamed["estimator"]
    report = est.explain_last_fit()
    phases = est.fit_stats_["step_phase_seconds"]
    covered = sum(phases.values()) / report["total_s"]
    log("fit step 4, explain_last_fit() of the streamed fit:\n" + report["text"])
    log(f"fit step 4: step phases {phases} cover {covered:.1%} of the fit's "
        f"{report['total_s']:.3f} s; flops/step {est.fit_stats_['flops_per_step']},"
        f" MFU {est.fit_stats_['mfu']} ({est.fit_stats_['peak_op_type']} peak)")
    trace_dir = BUILD_DIR / "fit_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    dlrm_estimator(device, dense_cols, cat_cols, "adam", 1, streaming=True,
                   profile_dir=str(trace_dir)).fit(ds)
    trace = trace_dir / "trace.json"
    require(trace.is_file() and trace.stat().st_size > 0,
            "profile_dir wrote no trace")
    trace_bytes = trace.stat().st_size
    shutil.rmtree(trace_dir)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dlrm_estimator(device, dense_cols, cat_cols, "adam", 1,
                       streaming=True).fit(ds)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    share = device_share(prof, wall_ms)
    log(f"fit step 4: profile_dir trace {trace_bytes} bytes; "
        f"profiled streamed epoch (a fit of one epoch): wall {wall_ms:.1f} ms, "
        f"device busy {share['device_busy_ms']} ms, share "
        f"{share['device_busy_share']}")
    return {"by_category": report["by_category"],
            "attributed_frac": report["attributed_frac"],
            "total_s": report["total_s"], "step_phase_seconds": phases,
            "phase_coverage": covered, "stalls": report["stalls"],
            "trace_bytes": trace_bytes, "profile": share}


def fit_checks(device, staged=None) -> dict:
    """Steps 1-3 (alone: ``--fit-checks``): the streamed fits and their
    per-step parity, the widen on the card and the crash-and-retry fits."""
    _build.load()
    ds, dense_cols, cat_cols = dlrm_data()
    streamed = streamed_fits(device, ds, dense_cols, cat_cols, staged)
    return {"streamed": streamed,
            "segment_parity": segment_parity(device, ds, dense_cols, cat_cols,
                                             streamed),
            "widen": check_widen(device, ds, dense_cols),
            "retries": check_retries(device, ds, dense_cols, cat_cols)}


def phase_fit(device, staged: dict) -> dict:
    """The estimator's streamed, checkpointed and retried fit at bench.py's
    full DLRM width (steps 1-4; ``staged`` is phase_dlrm's record)."""
    out = fit_checks(device, staged)
    streamed = out["streamed"]
    ds, dense_cols, cat_cols = dlrm_data()
    out["attribution"] = fit_attribution(device, ds, dense_cols, cat_cols,
                                         streamed["streamed"])
    for row in streamed.values():
        row.pop("estimator")
    out["launches"] = (sum(row["launches"] for row in streamed.values())
                       + out["segment_parity"]["launches"]
                       + sum(row["launches"] for row in out["retries"].values()))
    return out


# ---------------------------------------------------------------------------
# phase 5: kernel times beside their bounds
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 4b: what the obs layer counts and costs
# ---------------------------------------------------------------------------


def lm_counted_flops(batch: int, seq: int) -> dict:
    """``count_flops`` of one ``TransformerLM`` training step on the card,
    by its two parts: ``FlopCounterMode``'s (every matmul but attention:
    ``lm_nonattn_flops_per_step``) and the attention kernels' reports, 4 *
    D, 6 * D and 8 * D a live pair for the forward, dq and dk/dv: 18 * D a
    pair, where ``lm_train_flops_per_step`` takes three times the
    forward's 4 * D. So the count is (nonattn + 18 D P) / (nonattn + 12 D
    P) of ``lm_train_flops_per_step``, P the step's live pairs."""
    d, layers, vocab = MODEL["d_model"], MODEL["num_layers"], MODEL["vocab_size"]
    pairs = batch * MODEL["num_heads"] * layers * seq * (seq + 1) // 2
    head_dim = d // MODEL["num_heads"]
    return {"mode": lm_nonattn_flops_per_step(batch, seq, d, layers, vocab),
            "kernels": 18 * head_dim * pairs}


def flop_counts(device, dlrm: dict) -> dict:
    """``count_flops`` on the card: one ``TransformerLM`` training step at
    the training shape, split into the mode's part and the kernels'
    reports, each required equal to ``lm_counted_flops``; and the staged
    DLRM fit's count of its first step (``phase_dlrm``) equal to
    ``dlrm_counted_flops``, K1's report in it."""
    from raydp_tpu_torch.obs.costmodel import count_flops
    from raydp_tpu_torch.ops import _flops

    b, t = TRAIN["batch"], TRAIN["seq"]
    tokens, targets = train_tokens(b, t, MODEL["vocab_size"], device)
    model = lm("flash", device, t + 1)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN["lr"])
    kernels = {}

    def step():
        with _flops.counting() as reported:
            loss = train_step(model, opt, tokens, targets)
        kernels["flops"] = reported.total
        return loss

    loss, total = count_flops(step)
    require(math.isfinite(loss.item()), "the counted step's loss is not finite")
    del model, opt
    want = lm_counted_flops(b, t)
    got = {"mode": total - kernels["flops"], "kernels": kernels["flops"]}
    require(got == want, f"the LM step counted {got}, expected {want}")
    analytic = lm_train_flops_per_step(b, t, MODEL["d_model"],
                                       MODEL["num_layers"], MODEL["vocab_size"])
    dlrm_want = dlrm_counted_flops(DLRM_RUN["batch"])
    require(dlrm["counted_flops_per_step"] == dlrm_want,
            f"the DLRM step counted {dlrm['counted_flops_per_step']}, "
            f"expected {dlrm_want}")
    out = {"lm_step": total, "lm_parts": got, "lm_analytic": analytic,
           "lm_ratio": total / analytic,
           "lm_ratio_without_kernels": got["mode"] / analytic,
           "dlrm_step": dlrm["counted_flops_per_step"]}
    log(f"count_flops: the LM training step [{b}, {t}] {total:.6e} FLOPs "
        f"(mode {got['mode']:.6e} + attention kernels {got['kernels']:.6e}) = "
        f"{out['lm_ratio']:.4f} of lm_train_flops_per_step {analytic:.6e} "
        f"(the mode alone: {out['lm_ratio_without_kernels']:.4f}); the staged "
        f"DLRM step {out['dlrm_step']} (K1 reported)")
    return out


RECORDER_PROBE_ROUNDS = 4


def step_recorder_probe(device) -> dict:
    """bench.py's ``fit_profile_probe`` at full width: one-epoch staged
    DLRM fits with the step recorder on (``set_step_profiler(True)``) and
    off, 4 rounds with the lead alternating, after one warm fit of each;
    a fit's ms a step is its epoch's seconds less its first step (the
    count of its FLOPs, ``estimator.compile``) over the other 47 steps;
    the median of each arm's. Reported, not gated."""
    from raydp_tpu_torch.obs import profiler

    ds, dense_cols, cat_cols = dlrm_data()
    steps = DLRM_RUN["rows"] // DLRM_RUN["batch"]

    def one_fit(on: bool) -> float:
        profiler.set_step_profiler(on)
        est = dlrm_estimator(device, dense_cols, cat_cols, "adam", 1)
        (record,) = est.fit(ds)
        first = sum(r["dur"] for r in est.last_fit_records_
                    if r["name"] == "estimator.compile"
                    and r["args"].get("what") == "first_step") / 1e6
        return 1e3 * (record["epoch_seconds"] - first) / (steps - 1)

    was_on = profiler.step_profiler_enabled()
    try:
        one_fit(True)
        one_fit(False)
        ms = {True: [], False: []}
        for i in range(RECORDER_PROBE_ROUNDS):
            for on in ((True, False), (False, True))[i % 2]:
                ms[on].append(one_fit(on))
    finally:
        profiler.set_step_profiler(was_on)
    on_ms, off_ms = statistics.median(ms[True]), statistics.median(ms[False])
    out = {"step_ms_on": on_ms, "step_ms_off": off_ms,
           "step_ms_on_samples": ms[True], "step_ms_off_samples": ms[False],
           "overhead_frac": on_ms / off_ms - 1.0,
           "rounds": RECORDER_PROBE_ROUNDS}
    log(f"step recorder probe: {on_ms:.4f} ms a step on, {off_ms:.4f} off "
        f"(fits {ms[True]} / {ms[False]}), overhead {out['overhead_frac']:+.4f}")
    return out


def custom_op_hop(device) -> dict:
    """What a ``torch.library.custom_op`` around a ctypes wrapper would
    cost a call: K1's wrapper at the DLRM path's shape, raw and through a
    custom op, by CUDA events over 1000 back-to-back calls (median of 5)
    and by the host's clock (``host_ms``). The port does not route its
    kernels through custom ops; this is the number for that decision."""
    from torch.library import custom_op

    @custom_op("raydp_tpu_torch_probe::interaction_fwd", mutates_args=())
    def wrapped(stacked: torch.Tensor) -> torch.Tensor:
        return ia.interaction_fwd(stacked)

    @wrapped.register_fake
    def _(stacked):
        b, f, _ = stacked.shape
        return stacked.new_empty((b, f * (f - 1) // 2))

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    t = _randn(gen, INTERACTION_SHAPES["path"], torch.float32, device)
    require(torch.equal(wrapped(t), ia.interaction_fwd(t)),
            "the custom op gave other values")
    calls = {"raw": lambda: ia.interaction_fwd(t), "custom_op": lambda: wrapped(t)}
    out = {name: {"events_ms": time_ms(fn, iters=HOST_CALLS, reps=5),
                  "host_ms": host_ms(fn)} for name, fn in calls.items()}
    out["hop_us"] = {key: 1e3 * (out["custom_op"][key] - out["raw"][key])
                     for key in ("events_ms", "host_ms")}
    log(f"custom_op hop on K1's wrapper [2048,7,16]: {json.dumps(out)}")
    return out


def phase_obs(device, dlrm: dict) -> dict:
    out = {"flops": flop_counts(device, dlrm),
           "step_recorder_probe": step_recorder_probe(device),
           "custom_op": custom_op_hop(device)}
    torch.cuda.synchronize()
    return out


def _bound(n_bytes: float, ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(device, heads=8, t=2048, d=128, lens=None) -> dict:
    lens = lens or DECODE_LENS
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    out = {}

    # prefill as the engine runs it: [1, H, capacity, Dh] bf16, causal
    q, k, v = (_randn(gen, (1, heads, t, d), torch.bfloat16, device)
               for _ in range(3))
    pairs = heads * t * (t + 1) // 2  # live (query, key) pairs
    n_bytes = 4 * q.numel() * 2 + 2 * heads * t * 4  # q, k, v, o; m, l
    bound, by = _bound(n_bytes, 4 * d * pairs, "bf16")

    def call():
        return fa.flash_attention_call(q, k, v, 0, 0, True, True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    out["flash_fwd"] = {
        "shape": f"q/k/v [1,{heads},{t},{d}] bf16 causal",
        # the surface the model calls (models/transformer.py _attend)
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: fa.flash_attention_call_plain(
            q, k, v, 0, 0, True, True), iters=3, reps=3),
        "library_ms": time_ms(sdpa),
        "bound_ms": bound, "bound_by": by, "ops": 4 * d * pairs,
        # a call this short can be bound by the host's time to issue it:
        # the wrapper below the surface, and the profiler's device time
        "call_ms": time_ms(call),
        "device_ms": device_ms(call), "library_device_ms": device_ms(sdpa),
    }

    out.update(f32_times(device, heads, t, d))

    # decode as the engine runs it: q [slots, H, 1, Dh] bf16, f32 cache
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    qd = _randn(gen, (b, heads, 1, d), torch.bfloat16, device)
    kc = _randn(gen, (b, heads, t, d), torch.float32, device)
    vc = _randn(gen, (b, heads, t, d), torch.float32, device)
    rows = sum(min(n, t) for n in lens) * heads
    mask = (torch.arange(t, device=device)[None, :] < kv_len[:, None])[:, None, None, :]
    io_bytes = 2 * qd.numel() * 2 + b * 4  # q, o (bf16); kv_len
    bound, by = _bound(rows * d * 2 * 4 + io_bytes, 4 * d * rows, "f32")

    def decode():
        return fa.flash_decode(qd, kc, vc, kv_len)

    def decode_sdpa():
        return F.scaled_dot_product_attention(qd.float(), kc, vc, attn_mask=mask)

    out["flash_decode"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, f32 cache [{b},{heads},{t},{d}], kv_len {lens}",
        # one call: the scores kernel, then the p.v kernel with the merge
        "ms": time_ms(decode), "device_ms": device_ms(decode),
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(qd, kc, vc, kv_len),
                            iters=3, reps=3),
        "library_ms": time_ms(decode_sdpa),
        "library_device_ms": device_ms(decode_sdpa),
        "bound_ms": bound, "bound_by": by,
    }

    k8, ks = quantize_int8(kc.reshape(-1, d))
    v8, vs = quantize_int8(vc.reshape(-1, d))
    k8, v8 = k8.reshape(kc.shape), v8.reshape(vc.shape)
    ks, vs = ks.reshape(kc.shape[:3]), vs.reshape(vc.shape[:3])
    bound, by = _bound(rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32")
    def decode_int8():
        return fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs)

    out["flash_decode_int8"] = {
        "shape": f"q [{b},{heads},1,{d}] bf16, int8 cache + f32 row scales, kv_len {lens}",
        "ms": time_ms(decode_int8), "device_ms": device_ms(decode_int8),
        "library_device_ms": None,
        "plain_ms": time_ms(lambda: fa.flash_decode_plain(
            qd, k8, v8, kv_len, k_scale=ks, v_scale=vs), iters=3, reps=3),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
    }
    out.update(small_head_times(device))
    out.update(wide_head_times(device))
    out.update(heads_past_256_times(device))
    out.update(train_times(device, heads, d))
    out.update(interaction_times(device))
    out.update(quant_times(device))
    for name, row in out.items():
        row["bound_ratio"] = row["ms"] / row["bound_ms"]
        if "ops" in row:  # 4 * D (forward), 6 * D, 8 * D per live pair
            row["tflop_s"] = row["ops"] / row["ms"] / 1e9
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        dev = (f"; device {row['device_ms']}, plain {row.get('plain_device_ms')}, "
               f"library {row['library_device_ms']} ms"
               if "device_ms" in row else "")
        rate = f", {row['tflop_s']:.1f} TFLOP/s" if "tflop_s" in row else ""
        if "call_ms" in row:
            rate += f" (flash_attention_call {row['call_ms']:.4f} ms)"
        log(f"time {name} [{row['shape']}]: {row['ms']:.4f} ms{rate}, "
            f"{row['bound_ratio']:.2f}x its bound, plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){dev}")
    return out


def time_row(shape, fn, plain, library, library_device, n_bytes, ops,
             op_type) -> dict:
    """One kernel's times: CUDA events (10 calls a sample, median of five),
    the profiler's device time (20 calls), the plain version once after a
    warm call, the library call by events (or None) and its device time as
    given, and the bound (``ops`` at ``op_type``'s peak, or ``n_bytes``)."""
    bound = _bound(n_bytes, ops, op_type)
    return {"shape": shape, "ms": time_ms(fn, iters=10, reps=5),
            "device_ms": device_ms(fn, calls=20),
            "plain_ms": time_ms(plain, iters=1, reps=1, warm=1),
            "library_ms": None if library is None else time_ms(
                library, iters=10, reps=5),
            "library_device_ms": library_device,
            "bound_ms": bound[0], "bound_by": bound[1], "ops": ops}


def attention_pair_rows(rows: dict, shape: str, args, kind: str, size: int,
                        suffix: str, pairs: int, pick: bool = False) -> None:
    """Rows ``flash_bwd_dq<suffix>`` and ``flash_bwd_dkv<suffix>`` of the
    backward pair on ``args`` (q, k, v, lse, dsum, g, 0, 0, causal) into
    ``rows``, beside SDPA's backward in the same type (forward+backward
    less forward, by events and by device time, the same figure on both
    rows; ``library`` names its backend: PyTorch's own choice, "pair", or
    with ``pick`` the first that takes the backward, ``sdpa_with_backend``);
    bounds at 6 and 8 * D operations a live pair."""
    q, k, v, _, _, g = args[:6]
    heads, t, d = q.shape[1:]
    elems = q.numel()
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    if pick:
        backend, sdpa_fwd = sdpa_with_backend(qr, kr, vr, grad=g,
                                              is_causal=True)
        require(sdpa_fwd is not None, "no SDPA backend takes the backward")
    else:
        backend = "pair"

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), g)

    pair_ms = (time_ms(sdpa_fwd_bwd, iters=10, reps=5)
               - time_ms(sdpa_fwd, iters=10, reps=5))
    both, fwd_only = (device_ms(sdpa_fwd_bwd, calls=20),
                      device_ms(sdpa_fwd, calls=20))
    for key, fn, plain, n_out, ops in (
        ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        name = f"{key}{suffix}"
        rows[name] = time_row(
            shape, lambda fn=fn: fn(*args), lambda plain=plain: plain(*args),
            None, None if None in (both, fwd_only) else both - fwd_only,
            (4 + n_out) * elems * size + 2 * q.shape[0] * heads * t * 4,
            ops * d * pairs, kind)
        rows[name]["library_ms"] = pair_ms
        rows[name]["library"] = backend


def wide_head_times(device) -> dict:
    """Every attention family at head dim 256, each row named ``<kernel>
    D256`` (``time_row``): the bf16 forward on the prefill [1, 8, 2048,
    256] and (``flash_fwd D256 train``) the training step's [2, 8, 8192,
    256], causal, through ``flash_attention``, beside SDPA; the bf16
    backward pair at the training shape and the f32 forward and pair at
    [1, 8, 2048, 256], beside SDPA's backward (``attention_pair_rows``);
    K4a (f32 q and cache) and K4b (f32 q) on q [4, 8, 1, 256] against a
    cache [4, 8, 2048, 256] at DECODE_LENS, K4a beside SDPA with a length
    mask. Bounds: 4, 6 and 8 * D operations a live pair at the type's
    peak; the decodes by the cache bytes their lengths need."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    heads, t, d = WIDE_HEADS, SMALL_HEADS_T, 256
    out = {}
    for key, dtype, shape4 in (
            ("flash_fwd D256", torch.bfloat16, (1, heads, t, d)),
            ("flash_fwd D256 train", torch.bfloat16,
             (TRAIN["batch"], heads, TRAIN["seq"], d)),
            ("flash_fwd_f32 D256", torch.float32, (1, heads, t, d))):
        b, _, tt, _ = shape4
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        size = 2 if dtype == torch.bfloat16 else 4
        pairs = b * heads * tt * (tt + 1) // 2
        args = bwd_inputs(gen, shape4, dtype, device)
        q, k, v = args[:3]
        shape = f"q/k/v [{','.join(map(str, shape4))}] {kind} causal"

        def sdpa(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        out[key] = time_row(
            shape, lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True),
            sdpa, device_ms(sdpa, calls=20),
            4 * q.numel() * size + 2 * b * heads * tt * 4, 4 * d * pairs, kind)
        if key != "flash_fwd D256":  # the pair at the paths' own shapes
            attention_pair_rows(out, shape, (*args, 0, 0, True), kind, size,
                                ("_f32" if kind == "f32" else "") + " D256",
                                pairs)
    b = len(DECODE_LENS)
    kv_len = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    mask = (torch.arange(t, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = sum(min(n, t) for n in DECODE_LENS) * heads
    qd = _randn(gen, (b, heads, 1, d), torch.float32, device)
    kc, vc = (_randn(gen, (b, heads, t, d), torch.float32, device)
              for _ in range(2))
    io_bytes = 2 * qd.numel() * 4 + b * 4

    def decode_sdpa():
        return F.scaled_dot_product_attention(qd, kc, vc, attn_mask=mask)

    out["flash_decode D256"] = time_row(
        (f"q [{b},{heads},1,{d}] f32, f32 cache [{b},{heads},{t},{d}], "
         f"kv_len {DECODE_LENS}"),
        lambda: fa.flash_decode(qd, kc, vc, kv_len),
        lambda: fa.flash_decode_plain(qd, kc, vc, kv_len),
        decode_sdpa, device_ms(decode_sdpa, calls=20),
        rows * d * 2 * 4 + io_bytes, 4 * d * rows, "f32")
    k8, ks = quantize_int8(kc)
    v8, vs = quantize_int8(vc)
    ks, vs = ks[..., 0], vs[..., 0]
    out["flash_decode_int8 D256"] = time_row(
        (f"q [{b},{heads},1,{d}] f32, int8 cache + f32 row scales, "
         f"kv_len {DECODE_LENS}"),
        lambda: fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs),
        lambda: fa.flash_decode_plain(qd, k8, v8, kv_len, ks, vs),
        None, None, rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32")
    return out


def sdpa_with_backend(q, k, v, grad=None, **kwargs):
    """SDPA on these inputs under the first of PyTorch's backends (flash,
    memory-efficient, cuDNN, math) that takes them, with ``grad`` (the
    cotangent; q, k and v require grad) its backward too: (backend name, a
    function that calls the forward), or ("none", None). The flash backend
    refuses head dims past 256."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, **kwargs)

        try:
            out = call()
            if grad is not None:
                torch.autograd.grad(out, (q, k, v), grad)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, call
    return "none", None


def heads_past_256_times(device, d: int = 512) -> dict:
    """Every attention family at head dim ``d`` (512: bench.py's LM at
    d_model 4096), each row named ``<kernel> D<d>`` (``time_row``): the
    forward in bf16 (``flash_fwd``) and f32 (``flash_fwd_f32``) on the
    prefill [1, 8, 2048, D] causal through ``flash_attention``, beside SDPA
    under the backend that takes the shape (``library`` names it); the
    backward pair in bf16 and f32 at the 4096-wide LM's training shapes
    (``LM_4096``: [2, 8, 8192, D] and [1, 8, 2048, D], causal), beside
    SDPA's backward under the first backend that takes it
    (``attention_pair_rows``); K4a (f32 q and cache) and K4b (f32 q) on q
    [4, 8, 1, D] against a cache [4, 8, 2048, D] at DECODE_LENS, K4a
    beside SDPA with a length mask. Bounds: 4, 6 and 8 * D operations a
    live pair at the type's peak; the decodes by the cache bytes their
    lengths need. ``recompute``: the chunked bodies' operations over one
    pass, n = D / 256: (n + 1) / 2 for the forward (every column chunk's
    block computes all of S) and for K4b (each column chunk's block its
    scores), (4 m + 2) / 6 for dq (S and dP over all of D in each of a
    row block's m blocks, dS K over their own columns), (m + 1) / 2 for
    dk/dv (S^T and dP^T likewise, against dK's and dV's own columns; the
    bf16 body's second S^T not counted), m = n for the bf16 bodies (a
    chunk a block) and ceil(n / 2) for the f32 ones (two chunks a block),
    about 1 for K4a (its scores once; each column chunk's block repeats p
    only); not counted in the bound."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    heads, t = WIDE_HEADS, SMALL_HEADS_T
    factor = (d / fa.HEAD_CHUNK + 1) / 2
    out = {}
    pairs = heads * t * (t + 1) // 2
    for key, dtype in ((f"flash_fwd D{d}", torch.bfloat16),
                       (f"flash_fwd_f32 D{d}", torch.float32)):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        size = 2 if dtype == torch.bfloat16 else 4
        q, k, v = (_randn(gen, (1, heads, t, d), dtype, device)
                   for _ in range(3))
        backend, sdpa = sdpa_with_backend(q, k, v, is_causal=True)
        out[key] = time_row(
            f"q/k/v [1,{heads},{t},{d}] {kind} causal",
            lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True),
            sdpa, None if sdpa is None else device_ms(sdpa, calls=20),
            4 * q.numel() * size + 2 * heads * t * 4, 4 * d * pairs, kind)
        out[key] |= {"library": backend, "recompute": factor}
    n_dc = d / fa.HEAD_CHUNK
    for dtype, shape4 in (
            (torch.bfloat16, (LM_4096["bf16"]["batch"], heads,
                              LM_4096["bf16"]["seq"], d)),
            (torch.float32, (LM_4096["f32"]["batch"], heads,
                             LM_4096["f32"]["seq"], d))):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        suffix = ("_f32" if kind == "f32" else "") + f" D{d}"
        b, _, tt, _ = shape4
        attention_pair_rows(
            out, f"q/k/v [{','.join(map(str, shape4))}] {kind} causal",
            (*bwd_inputs(gen, shape4, dtype, device), 0, 0, True), kind,
            2 if kind == "bf16" else 4, suffix, b * heads * tt * (tt + 1) // 2,
            pick=True)
        # blocks a row block computing s and dp: the f32 bodies take two
        # gradient chunks a block, the bf16 bodies one
        m = -(-n_dc // 2) if kind == "f32" else n_dc
        out[f"flash_bwd_dq{suffix}"]["recompute"] = (4 * m + 2) / 6
        out[f"flash_bwd_dkv{suffix}"]["recompute"] = (m + 1) / 2
    b = len(DECODE_LENS)
    kv_len = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    mask = (torch.arange(t, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = sum(min(n, t) for n in DECODE_LENS) * heads
    qd = _randn(gen, (b, heads, 1, d), torch.float32, device)
    kc, vc = (_randn(gen, (b, heads, t, d), torch.float32, device)
              for _ in range(2))
    io_bytes = 2 * qd.numel() * 4 + b * 4
    backend, decode_sdpa = sdpa_with_backend(qd, kc, vc, attn_mask=mask)
    out[f"flash_decode D{d}"] = time_row(
        (f"q [{b},{heads},1,{d}] f32, f32 cache [{b},{heads},{t},{d}], "
         f"kv_len {DECODE_LENS}"),
        lambda: fa.flash_decode(qd, kc, vc, kv_len),
        lambda: fa.flash_decode_plain(qd, kc, vc, kv_len),
        decode_sdpa, None if decode_sdpa is None else device_ms(decode_sdpa,
                                                                calls=20),
        rows * d * 2 * 4 + io_bytes, 4 * d * rows, "f32") | {
            "library": backend, "recompute": 1.0}
    k8, ks = quantize_int8(kc)
    v8, vs = quantize_int8(vc)
    ks, vs = ks[..., 0], vs[..., 0]
    out[f"flash_decode_int8 D{d}"] = time_row(
        (f"q [{b},{heads},1,{d}] f32, int8 cache + f32 row scales, "
         f"kv_len {DECODE_LENS}"),
        lambda: fa.flash_decode(qd, k8, v8, kv_len, k_scale=ks, v_scale=vs),
        lambda: fa.flash_decode_plain(qd, k8, v8, kv_len, ks, vs),
        None, None, rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32") | {
            "library": "none", "recompute": factor}
    return out


def small_head_times(device) -> dict:
    """Every attention family at the small LMs' head dims
    (``SMALL_HEAD_DIMS``; D 24 zero-padded to 32, the padding's copies
    counted in its times), each row named ``<kernel> D<d>``: the forward
    (``flash_fwd_f32`` f32, ``flash_fwd`` bf16) on q/k/v [1, 2, 2048, D]
    causal through ``flash_attention``, beside SDPA in the same type; the
    backward pair (``flash_bwd_dq_f32`` / ``flash_bwd_dkv_f32`` f32,
    ``flash_bwd_dq`` / ``flash_bwd_dkv`` bf16) on the same shape, beside
    SDPA's backward (forward+backward less forward, the same figure on both
    rows); K4a (``flash_decode``, f32 q and cache) and K4b
    (``flash_decode_int8``, f32 q) on decode rows q [4, 2, 1, D] against a
    cache [4, 2, 2048, D] at the serving lengths, beside SDPA with a length
    mask (K4a; none for K4b). Each row: CUDA events (10 calls a sample,
    median of five), the profiler's device time (20 calls), the plain
    version once after a warm call, and the bound (operations at the
    type's peak, or bytes)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    heads, t = TRACE_LM["heads"], SMALL_HEADS_T
    pairs = heads * t * (t + 1) // 2
    b = len(DECODE_LENS)
    kv_len = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    mask = (torch.arange(t, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = sum(min(n, t) for n in DECODE_LENS) * heads
    out = {}
    for d in SMALL_HEAD_DIMS:
        for dtype, fwd_name, bwd_suffix in ((torch.float32, "flash_fwd_f32", "_f32"),
                                            (torch.bfloat16, "flash_fwd", "")):
            size = 2 if dtype == torch.bfloat16 else 4
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            shape = f"q/k/v [1,{heads},{t},{d}] {kind} causal"
            q, k, v, lse, dsum, g = bwd_inputs(gen, (1, heads, t, d), dtype,
                                               device)
            elems = q.numel()

            def sdpa(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)

            out[f"{fwd_name} D{d}"] = time_row(
                shape, lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=True),
                lambda q=q, k=k, v=v: fa.flash_attention_call_plain(
                    q, k, v, 0, 0, True, True),
                sdpa, device_ms(sdpa, calls=20),
                4 * elems * size + 2 * heads * t * 4, 4 * d * pairs, kind)
            attention_pair_rows(out, shape, (q, k, v, lse, dsum, g, 0, 0, True),
                                kind, size, f"{bwd_suffix} D{d}", pairs)
        qd = _randn(gen, (b, heads, 1, d), torch.float32, device)
        kc, vc = (_randn(gen, (b, heads, t, d), torch.float32, device)
                  for _ in range(2))
        io_bytes = 2 * qd.numel() * 4 + b * 4

        def decode_sdpa(qd=qd, kc=kc, vc=vc):
            return F.scaled_dot_product_attention(qd, kc, vc, attn_mask=mask)

        out[f"flash_decode D{d}"] = time_row(
            (f"q [{b},{heads},1,{d}] f32, f32 cache [{b},{heads},{t},{d}], "
             f"kv_len {DECODE_LENS}"),
            lambda qd=qd, kc=kc, vc=vc: fa.flash_decode(qd, kc, vc, kv_len),
            lambda qd=qd, kc=kc, vc=vc: fa.flash_decode_plain(qd, kc, vc, kv_len),
            decode_sdpa, device_ms(decode_sdpa, calls=20),
            rows * d * 2 * 4 + io_bytes, 4 * d * rows, "f32")
        k8, ks = quantize_int8(kc)
        v8, vs = quantize_int8(vc)
        ks, vs = ks[..., 0], vs[..., 0]
        out[f"flash_decode_int8 D{d}"] = time_row(
            (f"q [{b},{heads},1,{d}] f32, int8 cache + f32 row scales, "
             f"kv_len {DECODE_LENS}"),
            lambda qd=qd, k8=k8, v8=v8, ks=ks, vs=vs: fa.flash_decode(
                qd, k8, v8, kv_len, k_scale=ks, v_scale=vs),
            lambda qd=qd, k8=k8, v8=v8, ks=ks, vs=vs: fa.flash_decode_plain(
                qd, k8, v8, kv_len, ks, vs),
            None, None, rows * (d + 4) * 2 + io_bytes, 4 * d * rows, "f32")
    return out


def f32_times(device, heads=8, t=2048, d=128) -> dict:
    """The CUDA-core f32 bodies at the f32 model's prefill shape, q/k/v [1,
    H, capacity, Dh] f32 causal: the forward as phase_deploy's replicas run
    it (``flash_fwd_f32``, through ``flash_attention``, the wrapper below it
    beside), its two-term body, and the backward pair (one warm call, 20
    calls a sample, median of seven; plain versions median of three), each
    also by the profiler's device time. Bounds at the f32 peak (67 TFLOP/s):
    4, 6 and 8 * D operations a live pair. Library yardsticks: SDPA in f32,
    and for the backward pair its backward (forward+backward less forward),
    the same figure on both rows. ``prefill_f32_turns.py`` times these rows
    for two trees in turns."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    pairs = heads * t * (t + 1) // 2  # live (query, key) pairs
    q, k, v, lse, dsum, g = bwd_inputs(gen, (1, heads, t, d), torch.float32,
                                       device)
    elems, rows_bytes = q.numel(), 2 * heads * t * 4
    shape = f"q/k/v [1,{heads},{t},{d}] f32 causal"

    def call(onepass):
        return lambda: fa.flash_attention_call(q, k, v, 0, 0, True, True,
                                               onepass)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), g)

    library = {"library_ms": time_ms(sdpa), "library_device_ms": device_ms(sdpa)}
    both, fwd_only = device_ms(sdpa_fwd_bwd, calls=20), device_ms(sdpa_fwd, calls=20)
    pair = {"library_ms": time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd),
            "library_device_ms": (None if None in (both, fwd_only)
                                  else both - fwd_only), "library": "pair"}
    fwd_bound = _bound(4 * elems * 4 + rows_bytes, 4 * d * pairs, "f32")
    out = {
        "flash_fwd_f32": {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
            "call_ms": time_ms(call(True)), "device_ms": device_ms(call(True)),
            "plain_ms": time_ms(lambda: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True), iters=3, reps=3),
        },
        "flash_fwd_twoterm_f32": {
            "ms": time_ms(call(False)), "device_ms": device_ms(call(False)),
            "plain_ms": time_ms(lambda: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True, False), iters=3, reps=3),
        },
    }
    for row in out.values():
        row.update(library, shape=shape, bound_ms=fwd_bound[0],
                   bound_by=fwd_bound[1], ops=4 * d * pairs)
    args = (q, k, v, lse, dsum, g, 0, 0, True)
    for key, fn, plain, n_out, ops in (
        ("flash_bwd_dq_f32", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv_f32", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        bound = _bound((4 + n_out) * elems * 4 + rows_bytes, ops * d * pairs,
                       "f32")
        out[key] = pair | {
            "shape": shape,
            "ms": time_ms(lambda fn=fn: fn(*args)),
            "device_ms": device_ms(lambda fn=fn: fn(*args), calls=20),
            "plain_ms": time_ms(lambda plain=plain: plain(*args), iters=1,
                                reps=3, warm=1),
            "bound_ms": bound[0], "bound_by": bound[1], "ops": ops * d * pairs,
        }
    return out


def train_times(device, heads, d) -> dict:
    """The training path's kernels at its shape, q/k/v [2, H, 8192, D] bf16
    causal, and their plain versions on the same inputs (one warm call,
    median of three: their Python tile loops take a fraction of a second
    here). flash_fwd and flash_fwd_twoterm are timed in turn, A B B A twice,
    each row the median of its four, 20 calls a sample (the host's time to
    issue the first call counts once in each); flash_bwd_dq and
    flash_bwd_dkv 20 calls a sample, median of five; each also by the
    profiler's device time. Library yardstick for the backward pair: the
    backward of F.scaled_dot_product_attention (forward+backward less
    forward), timed the same two ways, the same figure on both rows."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    b, t = TRAIN["batch"], TRAIN["seq"]
    shape = (b, heads, t, d)
    q, k, v, lse, dsum, g = bwd_inputs(gen, shape, torch.bfloat16, device)
    pairs = b * heads * t * (t + 1) // 2  # live (query, key) pairs
    elems = q.numel()
    rows_bytes = 2 * b * heads * t * 4  # two f32 row statistics
    name = f"q/k/v [{b},{heads},{t},{d}] bf16 causal"

    def plain_ms(fn):
        return time_ms(fn, iters=1, reps=3, warm=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), g)

    pair_ms = (time_ms(sdpa_fwd_bwd, iters=20, reps=5)
               - time_ms(sdpa_fwd, iters=20, reps=5))
    both, fwd_only = device_ms(sdpa_fwd_bwd, calls=10), device_ms(sdpa_fwd, calls=10)
    pair_device_ms = None if None in (both, fwd_only) else both - fwd_only
    fwd_runs = {True: [], False: []}
    for onepass in (True, False, False, True) * 2:
        fwd_runs[onepass].append(time_ms(
            lambda onepass=onepass: fa.flash_attention_call(
                q, k, v, 0, 0, True, True, onepass), iters=20, reps=5))
    fwd_bound = _bound(4 * elems * 2 + rows_bytes, 4 * d * pairs, "bf16")
    out = {}
    for key, onepass in (("flash_fwd_train", True), ("flash_fwd_twoterm", False)):
        out[key] = {
            "device_ms": device_ms(lambda onepass=onepass: fa.flash_attention_call(
                q, k, v, 0, 0, True, True, onepass), calls=10),
            "library_device_ms": device_ms(sdpa, calls=10),
            "shape": name,
            "ms": statistics.median(fwd_runs[onepass]),
            "ms_runs": fwd_runs[onepass],
            "plain_ms": plain_ms(lambda onepass=onepass: fa.flash_attention_call_plain(
                q, k, v, 0, 0, True, True, onepass)),
            "library_ms": time_ms(sdpa, iters=20, reps=5),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "ops": 4 * d * pairs,
        }
    args = (q, k, v, lse, dsum, g, 0, 0, True)
    for key, fn, plain, n_out, ops in (
        ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 1, 6),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, 2, 8),
    ):
        bound = _bound((4 + n_out) * elems * 2 + rows_bytes, ops * d * pairs, "bf16")
        out[key] = {
            "shape": name,
            "ms": time_ms(lambda fn=fn: fn(*args), iters=20, reps=5),
            "device_ms": device_ms(lambda fn=fn: fn(*args), calls=10),
            "plain_ms": plain_ms(lambda plain=plain: plain(*args)),
            "library_ms": pair_ms, "library_device_ms": pair_device_ms,
            "library": "pair",
            "bound_ms": bound[0], "bound_by": bound[1],
            "ops": ops * d * pairs,
        }
    log(f"flash_fwd vs flash_fwd_twoterm at the training shape, A B B A x2: "
        f"one-pass {fwd_runs[True]} ms, two-term {fwd_runs[False]} ms")
    return out


def device_ms(fn, calls: int = 100) -> float | None:
    """Device time per call of ``fn`` (all its kernels), from the profiler
    over ``calls`` calls (``per_call_device_ms``): what the card spends,
    without the host's time to issue the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return per_call_device_ms(prof, calls)


def per_call_device_ms(prof, calls: int) -> float | None:
    """A profiled window of ``calls`` calls as device ms a call. The
    profiler can lose launches (it recorded 5 of 20 in one window), so each
    port kernel counts by the launches it recorded: its mean time a
    recorded launch, once a call, as each wrapper launches each of its
    kernels once a call. A port kernel recorded more often than ``calls``
    fails the row (None): several launches a call, where lost ones cannot
    be told apart. Other kernels (the library's) count their total over the
    calls made. None where the profiler saw no device time. Logs the
    recorded launches where they are not ``calls``, and each port kernel's
    time a call where a call launches more than one."""
    seen = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and port_kernel_pattern().match(evt.key)):
            seen[evt.key] = seen.get(evt.key, 0) + evt.count
    if any(n != calls for n in seen.values()):
        log(f"device_ms: the profiler recorded {seen} launches of {calls} calls")
    if any(n > calls for n in seen.values()):
        return None
    by_name = device_ms_by_name(prof)
    split = {name: ms / seen[name] for name, ms in by_name.items()
             if seen.get(name)}
    if len(split) > 1:
        log(f"device_ms: per call by kernel {split}")
    total = sum(split.values()) + sum(
        ms / calls for name, ms in by_name.items() if name not in split)
    return total if by_name else None


def interaction_times(device) -> dict:
    """interaction_fwd at the DLRM path's shape and the Kaggle shape (f32),
    its plain version, and the library pair torch.bmm(T, T^T) plus the
    triangle gather (two calls: no one PyTorch call computes this). ``ms``
    and the others by CUDA events over back-to-back calls, as for every
    kernel; a call this short may be bound by the host's time to issue it,
    so each also gets its device time from the profiler (``*device_ms``).
    Bound: T read once and the triangle written once, over the HBM rate
    (2 * D operations per pair are far below the f32 peak). Beside them the
    launch floor, a launch that does no work (``torch.cuda._sleep(0)``),
    by events and by the profiler."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    floor = {"launch_floor_ms": time_ms(lambda: torch.cuda._sleep(0), iters=50),
             "launch_floor_device_ms": device_ms(lambda: torch.cuda._sleep(0))}
    log(f"launch floor (torch.cuda._sleep(0)): events {floor['launch_floor_ms']:.5f}"
        f" ms, device {floor['launch_floor_device_ms']} ms a launch")
    out = {}
    for key, (b, f, d) in INTERACTION_SHAPES.items():
        t = _randn(gen, (b, f, d), torch.float32, device)
        rows, cols = (torch.from_numpy(x).to(device)
                      for x in np.tril_indices(f, k=-1))
        pairs = f * (f - 1) // 2
        bound = _bound(4 * (t.numel() + b * pairs), 2 * d * b * pairs, "f32")
        calls = {
            "": lambda t=t: ia.interaction_fwd(t),
            "plain_": lambda t=t: ia.dot_interaction_plain(t),
            "library_": lambda t=t, rows=rows, cols=cols:
                torch.bmm(t, t.transpose(1, 2))[:, rows, cols],
        }
        row = {"shape": f"T [{b},{f},{d}] f32", "library": "pair",
               "bound_ms": bound[0], "bound_by": bound[1]} | floor
        for prefix, fn in calls.items():
            row[f"{prefix}ms"] = time_ms(fn, iters=50)
            row[f"{prefix}device_ms"] = device_ms(fn)
        out["interaction_fwd" if key == "path" else f"interaction_fwd {key}"] = row
    return out


HOST_CALLS = 1000


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """The host's time to issue one call of ``fn``: time.perf_counter over
    ``calls`` back-to-back calls after 50 warm ones, with no synchronise
    inside (the calls here are far shorter on the card than on the host, so
    the launch queue never fills)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def launch_times(device) -> dict:
    """Where a short kernel's call spends the host's time: each step of the
    K1 and K5 wrappers (the library's lookup, a device context, the current
    stream, what the wrappers now take in place of those two
    (``launch_context``, ``raw_stream``), ``contiguous``, the output's
    ``torch.empty``, K1's pair table, the pointers, the ctypes call alone,
    the error check, K5's key) and a launch that does no work
    (``torch.cuda._sleep(0)``) timed alone by ``host_ms``, beside the whole
    wrappers (K1 at the DLRM path's shape, and through its autograd node as
    the model calls it; K5 at [64, 1024], where the card is not the limit)
    and, for the ROADMAP's later work, the host's time of the other short
    wrappers at the serving shape: the int8 product at decode's N 4 with
    its quantize launch, and the f32-cache decode."""
    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    out = {}
    b, f, d = INTERACTION_SHAPES["path"]
    t = _randn(gen, (b, f, d), torch.float32, device)
    t_grad = t.clone().requires_grad_()
    res = torch.empty((b, f * (f - 1) // 2), device=device)
    table = ia._pair_table(f, device)
    ptrs = (t.data_ptr(), table.data_ptr(), res.data_ptr())
    x = _randn(gen, (64, 1024), torch.float32, device)
    vals = torch.empty(x.shape, dtype=torch.int8, device=device)
    scales = torch.empty((64, 1), device=device)

    def context():
        with torch.cuda.device(device):
            pass

    steps = {
        "_build.load": _build.load,
        "torch.cuda._sleep(0)": lambda: torch.cuda._sleep(0),
        "torch.cuda.device context": context,
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "_build.launch_context": lambda: _build.launch_context(device),
        "_build.raw_stream": lambda: _build.raw_stream(device),
        "contiguous": t.contiguous,
        "torch.empty": lambda: torch.empty(res.shape, device=device),
        "pair table": lambda: ia._pair_table(f, device),
        "data_ptr x3": lambda: (t.data_ptr(), table.data_ptr(), res.data_ptr()),
        "ctypes call (K1)": lambda: lib.rtt_interaction_fwd(
            *ptrs, b, f, d, _build.DTYPE_F32, stream),
        "_build.check": lambda: _build.check(0, "interaction_fwd"),
        "K5 key": lambda: qz._key(7),
        "ctypes call (K5)": lambda: lib.rtt_quantize_stochastic(
            x.data_ptr(), vals.data_ptr(), scales.data_ptr(), 64, 1024, 7, 0,
            stream),
        "interaction_fwd": lambda: ia.interaction_fwd(t),
        "dot_interaction_fused (autograd)": lambda: ia.dot_interaction_fused(t_grad),
        "quantize_int8_stochastic [64,1024]": lambda: quantize_int8(
            x, seed=7, stochastic=True),
    }
    xd = _randn(gen, (4, 1024), torch.bfloat16, device)
    wd = _randn(gen, (4096, 1024), torch.bfloat16, device)
    _, _, (xq, xs, wq, ws) = quantized_operands(gen, device, 4, 1024, 4096)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=device)
    heads, hd = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"]
    qd = _randn(gen, (len(DECODE_LENS), heads, 1, hd), torch.bfloat16, device)
    kc, vc = (_randn(gen, (len(DECODE_LENS), heads, ENGINE["capacity_tokens"], hd),
                     torch.float32, device) for _ in range(2))
    steps |= {
        "quantize_int8 decode x + w (other wrapper)": lambda: qz._quantize_rows_kernel(
            [xd, wd], qz._pitch(1024)),
        "int8_gemm N 4 (other wrapper)": lambda: qz.int8_gemm(
            xq, xs, wq, ws, torch.bfloat16),
        "flash_decode f32 cache (other wrapper)": lambda: fa.flash_decode(
            qd, kc, vc, lens),
    }
    out["host_ms"] = {name: host_ms(fn) for name, fn in steps.items()}
    log("host ms a call (perf_counter over "
        f"{HOST_CALLS} calls): {json.dumps(out['host_ms'])}")
    return out


def quant_times(device) -> dict:
    """K5 at the training step's two MLP activation shapes, the
    deterministic quantize and int8_gemm as the int8 product calls them
    (bf16 out), at the training step's two products and at decode's N 4.

    K5's bound: x read once, values and scales written once, over the HBM
    rate (its ~6 f32 operations per element are far below the f32 peak;
    Philox's integer operations have no tensor-core rate); no single
    PyTorch call rounds stochastically, so no library time; beside it
    ``same_bytes_ms``, ``x.to(torch.int8)``, which moves the same bytes.
    quantize_int8: one launch for x and w together, as int8_matmul makes
    it; bound by bytes (bf16 read, int8 and f32 scales written); plain_ms
    the torch chain on both (the path before this kernel); no library call.
    int8_gemm's bound: 2 N M K int8 operations over the int8 peak, or xq,
    wq, the scales and the bf16 output over the HBM rate, the larger;
    library: torch._int_mm, the int32 product alone, without the scales or
    the cast (the port never calls it), which takes more than 16 rows: at
    N 4 it multiplies xq padded with zero rows to 32. The short rows (N 4,
    the quantize launches) are also timed by the profiler's device time,
    since a call that short can be bound by the host's time to issue it."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    out = {}
    for key in ("fc2", "fc1"):
        n, d = QUANT_SHAPES[key]
        x = _randn(gen, (n, d), torch.float32, device)
        bound = _bound(4 * n * d + n * d + 4 * n, 6 * n * d, "f32")
        name = ("quantize_int8_stochastic" if key == "fc2"
                else f"quantize_int8_stochastic {key}")
        out[name] = {
            "shape": f"x [{n},{d}] f32",
            "ms": time_ms(lambda x=x: quantize_int8(x, seed=7, stochastic=True)),
            "device_ms": device_ms(
                lambda x=x: quantize_int8(x, seed=7, stochastic=True)),
            "library_device_ms": None,
            # a PyTorch call that moves the same bytes (x read, an int8 per
            # element written) and computes nothing: what the card's memory
            # gives such a pass, beside the bound's 3.35 TB/s
            "same_bytes_ms": time_ms(lambda x=x: x.to(torch.int8)),
            "plain_ms": time_ms(lambda x=x: qz.quantize_int8_stochastic_plain(x, 7),
                                iters=3, reps=3),
            "library_ms": None,
            "bound_ms": bound[0], "bound_by": bound[1],
        }
    for key in ("fc1", "decode"):
        n, k, m = GEMM_SHAPES[key]
        x = _randn(gen, (n, k), torch.bfloat16, device)
        w = _randn(gen, (m, k), torch.bfloat16, device)
        rows = n + m
        bound = _bound(2 * rows * k + rows * qz._pitch(k) + 4 * rows,
                       3 * rows * k, "f32")

        def kernel(x=x, w=w, k=k):
            return qz._quantize_rows_kernel([x, w], qz._pitch(k))

        def plain(x=x, w=w):
            return qz.quantize_int8_plain(x), qz.quantize_int8_plain(w)

        name = "quantize_int8" if key == "fc1" else f"quantize_int8 {key}"
        out[name] = {
            "shape": f"x [{n},{k}] + w [{m},{k}] bf16, one launch",
            "ms": time_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": bound[0], "bound_by": bound[1],
        }
    for key in ("fc1", "fc2", "decode", "decode fc2"):
        n, k, m = GEMM_SHAPES[key]
        _, _, (xq, xs, wq, ws) = quantized_operands(gen, device, n, k, m)
        bound = _bound(n * k + m * k + 4 * (n + m) + 2 * n * m, 2 * n * m * k,
                       "int8")
        name = "int8_gemm" if key == "fc1" else f"int8_gemm {key}"
        lib_x = xq if n > 16 else torch.nn.functional.pad(xq, (0, 0, 0, 32 - n))

        def call(xq=xq, xs=xs, wq=wq, ws=ws):
            return qz.int8_gemm(xq, xs, wq, ws, torch.bfloat16)

        def library(lib_x=lib_x, wq=wq):
            return torch._int_mm(lib_x, wq.t())

        row = {
            "shape": f"xq [{n},{k}] x wq [{m},{k}] int8 -> bf16",
            "ms": time_ms(call),
            "plain_ms": time_ms(lambda xq=xq, xs=xs, wq=wq, ws=ws: qz.int8_gemm_plain(
                xq, xs, wq, ws, torch.bfloat16), iters=3, reps=3),
            "library_ms": time_ms(library),
            "library": ("torch._int_mm: the int32 product, no scales or cast"
                        + ("" if n > 16 else f"; xq padded to 32 rows")),
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        if n <= 16:
            row |= {"device_ms": device_ms(call),
                    "library_device_ms": device_ms(library)}
        out[name] = row
    return out


def kernels_line(checks: dict, served: dict, trained: dict, times: dict,
                 dlrm: dict, trained_int8: dict, stochastic: dict,
                 fit: dict, deployed: dict, trained_f32: dict,
                 etl: dict, seqpar: dict, sharded: dict,
                 pipelined: dict, estimators: dict, examples: dict,
                 small_lm: dict, wide_lm: dict, lm_4096: dict) -> dict:
    """One entry per kernel. Launches: each kernel's count from the run of
    the path it serves (serving for flash_fwd and the decode kernels, plus
    training for flash_fwd; training for the backward pair; the f32
    training steps for the f32 backward pair (its wrappers' counts there,
    where every launch is of the f32 bodies) and, with phase_deploy's f32
    replicas, for flash_fwd_f32; phase_seqpar's ring_flash and
    ulysses_flash steps and phase_pipeline's steps (every rank's) for the
    three f32 kernels; the full-width
    RAYDP_TPU_FLASH_ONEPASS=0 step for flash_fwd_twoterm; the DLRM fit with
    its evaluation, the dlrm_optimizer epoch, the streamed and retried
    fits of phase_fit, phase_etl's fits from the ETL Dataset and
    phase_sharded_dlrm's fits (world 1 and every rank of world 2) and
    phase_estimators' TorchEstimator fits (every rank of world 1 and 2)
    and phase_examples' dlrm_criteo fit for interaction_fwd; the
    int8-MLP training steps and serving run for int8_gemm, and with the
    int8-cache serving run for quantize_int8; the entry point's run for
    quantize_int8_stochastic), plus the launches phase_deploy's replicas
    made (K1, flash_fwd_f32 for the f32 model and flash_fwd for the bf16
    one, the decode kernels and quantize_int8, counted in the replica
    processes alive at each read), those of phase_examples' trace_smoke
    replica (flash_fwd_f32 and flash_decode at head dim 16) and those of
    phase_small_lm (its training steps and its replicas, at head dims 16
    and 8) and those of phase_wide_lm (its training steps and engines, at
    head dim 256; with its int8 cache's rows for quantize_int8), which each
    attention kernel's ``launches_by_head_dim`` splits out from the rest
    (head dim 128). Each attention kernel's ``head_dim_256`` holds its
    times at D 256 (``wide_head_times``: the forward at the prefill
    [1,8,2048,256], the bf16 pair at the training shape [2,8,8192,256],
    the f32 pair at [1,8,2048,256], the decodes at the serving shape), its
    worst error there (``check_wide_heads``) and its launches in
    phase_wide_lm; ``head_dim_512`` the same at D 512 for the serving
    kernels (``heads_past_256_times`` at the prefill and serving shapes,
    ``check_heads_past_256``, and phase_lm_4096's launches, which
    ``launches_by_head_dim["512"]`` also holds). A count is of wrapper calls that launched
    the kernel: each flash_decode call is two launches (its scores kernel,
    then its p.v kernel with the merge). Errors: at the shapes of the kernel's path
    (flash_fwd: the larger of serving's and training's; flash_fwd_f32 at
    the f32 prefill [1,8,2048,128], causal; K5 at
    [16384,4096], int8_gemm at the step's first product in bf16,
    quantize_int8 at its activations). Times: K5 at [16384,4096],
    int8_gemm at [16384,1024]x[4096,1024], quantize_int8 on that product's
    x and w; the other shapes are in the record's times."""
    launches = {}
    for counts in ([run["launches"] for run in served["runs"]]
                   + [trained["launches"]]):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_decode", "flash_decode_int8"):
            launches[name] = launches.get(name, 0) + counts[name]
    launches["flash_fwd_twoterm"] = \
        trained["twoterm_step"]["launches"]["flash_fwd_twoterm"]
    launches["interaction_fwd"] = (dlrm["launches"]
                                   + dlrm["dlrm_optimizer"]["launches"]
                                   + fit["launches"] + etl["launches"]
                                   + sharded["launches"]
                                   + estimators["launches"])
    int8_runs = [trained_int8, served["int8_mlp_run"], served["runs"][1]]
    for name in ("int8_gemm", "quantize_int8"):
        launches[name] = sum(run["launches"][name] for run in int8_runs)
    launches["quantize_int8_stochastic"] = \
        stochastic["launches"]["quantize_int8_stochastic"]
    launches["flash_fwd_f32"] = (trained_f32["launches"]["flash_fwd_f32"]
                                 + seqpar["launches"]["flash_fwd_f32"]
                                 + pipelined["launches"]["flash_fwd_f32"])
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        launches[f"{name}_f32"] = (trained_f32["launches"][name]
                                   + seqpar["launches"][name]
                                   + pipelined["launches"][name])
    for name, n in deployed["launches"].items():
        if name in launches:
            launches[name] += n
    for name, n in examples["launches"].items():
        launches[name] += n
    small = dict(small_lm["launches_by_head_dim"], **{
        "256": wide_lm["launches"], "512": lm_4096["launches"]})
    for counts in small.values():
        for name, n in counts.items():
            if name in launches:
                launches[name] += n
    by_head_dim = {}
    for name in launches:
        if not name.startswith("flash_"):
            continue
        by = {d: counts.get(name, 0) for d, counts in small.items()}
        by["16"] = by.get("16", 0) + examples["launches"].get(name, 0)
        by["128"] = launches[name] - sum(by.values())
        by_head_dim[name] = by
    case = "bfloat16 causal=True offsets=(0,0)"
    train = "train [{batch},{heads},{seq},{d}] bfloat16 causal=True".format(
        heads=MODEL["num_heads"], d=MODEL["d_model"] // MODEL["num_heads"],
        **TRAIN)
    errors = {
        "flash_fwd": max(checks[f"flash_fwd {case} normalize=True"],
                         checks[f"flash_fwd {train}"]),
        "flash_fwd_f32": checks["flash_fwd float32 causal=True offsets=(0,0) "
                                "normalize=True"],
        "flash_fwd_twoterm": checks[f"flash_fwd_twoterm {train}"],
        "flash_bwd_dq": checks[f"flash_bwd_dq {train}"],
        "flash_bwd_dkv": checks[f"flash_bwd_dkv {train}"],
        # at the f32 training step's shape, [1,8,2048,128] causal
        "flash_bwd_dq_f32": checks["flash_bwd_dq float32 causal=True "
                                   "offsets=(0,0)"],
        "flash_bwd_dkv_f32": checks["flash_bwd_dkv float32 causal=True "
                                    "offsets=(0,0)"],
        "flash_decode": checks[f"flash_decode q bfloat16 kv_len={DECODE_LENS}"],
        "flash_decode_int8": checks["flash_decode_int8 q bfloat16"],
        "interaction_fwd": checks[interaction_case(
            *INTERACTION_SHAPES["path"], torch.float32)],
        "quantize_int8_stochastic": checks[stochastic_case(*QUANT_SHAPES["fc2"])],
        "int8_gemm": checks[gemm_case(*GEMM_SHAPES["fc1"], torch.bfloat16)],
        "quantize_int8": checks[quantize_case(
            "train x fc1", *QUANT_ROWS_SHAPES["train x fc1"])],
    }
    wide = {}
    for d, key in ((256, "wide_heads"), (512, "heads_past_256")):
        worst = checks[key]["worst"]
        for name in by_head_dim:
            family = name.replace("flash_fwd_twoterm", "flash_fwd")
            row = times.get(f"{name} D{d}", {})
            wide.setdefault(name, {})[f"head_dim_{d}"] = {
                k: row.get(k) for k in TIME_KEYS} | {
                "max_abs_err": worst.get(f"{family} D{d}", {}).get("max_abs_err"),
                "launches": by_head_dim[name][str(d)]}
    return {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         # the profiler's device time, beside the CUDA-event times above;
         # null where it was not measured or the profiler saw none
         **{f"{key}device_ms": times[name].get(f"{key}device_ms")
            for key in ("", "plain_", "library_")},
         **({"launches_by_head_dim": by_head_dim[name], **wide[name]}
            if name in by_head_dim else {})}
        for name, (source, replaces) in KERNELS.items()
    ]}


def small_heads_summary(checks: dict, times: dict, nvidia_smi: str) -> dict:
    """The ``{"small_heads": {...}}`` line: every attention family at the
    head dims of ``SMALL_HEAD_DIMS``, each one's worst error against its
    plain version over ``check_small_heads`` (and, bf16, its worst error
    over its limit) and its times at [.., 2048, D] (``small_head_times``),
    beside the card's name and power limit."""
    return {"small_heads": head_dim_rows(checks, times),
            "nvidia_smi": nvidia_smi}


TIME_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
             "bound_ms", "bound_by")


def head_dim_rows(checks: dict, times: dict) -> dict:
    """Per family and head dim of ``checks["worst"]``: its times (``TIME_KEYS``
    of the row of the same name in ``times``, None where not timed) and its
    worst errors."""
    return {name: {k: times.get(name, {}).get(k) for k in TIME_KEYS} | worst
            for name, worst in checks["worst"].items()}


def bf16_checks(device) -> None:
    """Phase 2's bf16 checks at the main path's shapes alone, with the f32
    bodies': the forward at the serving prefill [1,8,2048,128] in bf16
    and f32 (normalized, and the stats surface with offsets) and at the
    training shape [2,8,8192,128], causal; the f32 forward's edges
    (``check_forward_f32``); the f32 backward's hard cases
    (``check_backward_f32``); the backward at the training shape; decode at
    the serving shape (f32 and int8 caches) and the f32/bf16-cache decode's
    bitwise contracts (``check_decode_bits``, also at an odd capacity); the
    int8 product, bitwise, at the training step's first product and
    decode's two; every family at head dims 256 and 192
    (``check_wide_heads``); every family past 256, the backward's too
    (``check_heads_past_256``); and K1's and K5's own checks
    (``check_interaction``, ``check_stochastic``), the path's shapes and
    their layouts' edges."""
    _build.load()
    gen = torch.Generator(device=device).manual_seed(SEED)
    heads, d = MODEL["num_heads"], MODEL["d_model"] // MODEL["num_heads"]
    for dtype in (torch.bfloat16, torch.float32):
        for q_off, k_off, normalize in ((0, 0, True), (512, 256, False)):
            t = ENGINE["capacity_tokens"]
            q, k, v = (_randn(gen, (1, heads, t, d), dtype, device)
                       for _ in range(3))
            check_forward(q, k, v, q_off, k_off, True, normalize,
                          f"{str(dtype)[6:]} [1,{heads},{t},{d}] causal=True "
                          f"offsets=({q_off},{k_off}) normalize={normalize}")
    check_forward_f32(gen, device, heads)
    check_backward_f32(gen, device, heads)
    check_train_shape(gen, device, heads, d)
    check_decode_bits(gen, device, heads, ENGINE["capacity_tokens"], DECODE_LENS)
    check_decode_bits(gen, device, heads, *DECODE_BITS_ODD)
    check_decode(gen, device, heads, ENGINE["capacity_tokens"], d, DECODE_LENS,
                 (torch.bfloat16,))
    check_int8_gemm(gen, device, grads=False, cases=[
        GEMM_SHAPES[key] for key in ("fc1", "decode", "decode fc2")])
    check_wide_heads(gen, device)
    check_heads_past_256(gen, device)
    check_interaction(gen, device)
    check_stochastic(gen, device)


def k1_k5(device) -> dict:
    """K1 and K5 alone: phase 1's build and report, both kernels' checks
    (``check_interaction``, ``check_stochastic``) and K5's entry-point run,
    their times beside their bounds, the launch floor and the host's split.
    Prints one JSON line and writes ``chiprun_out/k1_k5.json``."""
    record = {"device": phase_device()}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k1_k5.sass").write_text("".join(
        f"Function : {chunk}" for chunk in
        re.split(r"\n\s*Function : ", sass_text(_build.library_path()))[1:]
        if any(re.search(p, chunk.split("\n", 1)[0])
               for p in K1_K5_KERNELS.values())))
    gen = torch.Generator(device=device).manual_seed(SEED)
    record["checks"] = check_interaction(gen, device) | check_stochastic(gen, device)
    record["stochastic"] = phase_stochastic(device)
    times = interaction_times(device) | quant_times(device)
    record["times"] = {name: row | {"bound_ratio": row["ms"] / row["bound_ms"]}
                       for name, row in times.items()
                       if name.startswith(("interaction", "quantize_int8_stochastic"))}
    record["launch"] = launch_times(device)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "k1_k5.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"times": record["times"], "launch": record["launch"]}))
    return record


# Faults planted one at a time by ``--planted-faults``, each in a copy of
# the source it names: (source, the text at the fault's site, its
# replacement). Each site occurs exactly once in its source.
PLANTED_FAULTS = {
    # the forward's P.V reads the V tile of the other ring stage
    "other_stage_v": (SM90_SOURCE,
                      "sw128_desc(s_v + s * L::kTile + kk * 16 * 128",
                      "sw128_desc(s_v + (s ^ 1) * L::kTile + kk * 16 * 128"),
    # the forward, past key 2048: the last 16 keys of each tile meet the V
    # rows of the 16 keys before them: long rows only
    "long_row_v_rows": (SM90_SOURCE,
                        "s_v + s * L::kTile + kk * 16 * 128",
                        "s_v + s * L::kTile + "
                        "(kk == 7 && it >= 16 ? 6 : kk) * 16 * 128"),
    # dK += dS^T Q reads the Q tile of the other ring stage
    "dkv_other_stage_q": (SM90_BWD_SOURCE,
                          "sw128_desc(ring_q + kk * 16 * 128",
                          "sw128_desc(s_q + (s ^ 1) * L::kRing + kk * 16 * 128"),
    # dQ += dS K, past key 2048: the last 16 keys of each tile meet the K
    # rows of the 16 keys before them: long rows only
    "dq_long_row_k": (SM90_BWD_SOURCE,
                      "sw128_desc(ring_k + kk * 16 * 128",
                      "sw128_desc(ring_k + (kk == 3 && it >= 32 ? 2 : kk) "
                      "* 16 * 128"),
    # decode, past key 1024: a tile keeps the previous tile's V
    "decode_long_row_v": (
        DECODE_SOURCE,
        "stage_tile<D>(v + (bh * tk + kt0) * dt + col0,",
        "stage_tile<D>(v + (bh * tk + kt0 - (kt0 >= 1024 ? kBlockK : 0)) * dt "
        "+ col0,"),
    # decode: a tile's p and merge against the max of its own block's
    # tiles, not of every earlier tile of the row
    "decode_block_max": (
        DECODE_SOURCE,
        "for (int u = lane; u < tile; u += 32)",
        "for (int u = chunk * kWarps + lane; u < tile; u += 32)"),
    # decode: the last block's tiles merged ahead of the first block's
    # (their partials swap places in the workspace)
    "decode_last_block_first": (
        DECODE_SOURCE,
        "float* pt = part + (row * n_tiles + tile) * (2 + dt);",
        "float* pt = part + (row * n_tiles + (chunk == 0 ? tile + "
        "(live_chunks - 1) * kWarps : chunk == live_chunks - 1 ? warp : tile))"
        " * (2 + dt);"),
    # the s8 GEMM's consumers read their A tile from the next ring stage
    "gemm_other_stage": (QUANT_SOURCE,
                         "sw128_desc(s_a + s * C::kAStage",
                         "sw128_desc(s_a + ((s + 1) % kGemmStages) * C::kAStage"),
    # K5's register body: a group past column 2048 draws its right
    # neighbour's Philox block
    "stochastic_neighbour_block": (
        QUANT_SOURCE,
        "philox_block(block0 + g, keys)",
        "philox_block(block0 + g + (g >= 512), keys)"),
    # K1: the last pair of each row reads feature 0 for its j
    "interaction_last_pair_j": (
        INTERACTION_SOURCE,
        "const int j = static_cast<int>(ij & 0xffff);",
        "const int j = static_cast<int>(o - r * pairs == pairs - 1 ? 0 : "
        "ij & 0xffff);"),
    # the f32 prefill: p_sum of a row's keys in another tree order (j^4
    # first, then j^8, j^16): within 1e-5, but off decode's bits
    "f32_psum_tree_order": (
        FWD_SOURCE,
        "x[i] = __fadd_rn(x[i], x[i + w]);",
        "x[i] = __fadd_rn(x[2 * i], x[2 * i + 1]);"),
    # the f32 prefill, past key 1024: a tile's scores read the K of the
    # neighbouring slot of the staged group
    "f32_group_neighbour_tile": (
        FWD_SOURCE,
        "const float* kr = ks + (tile * kBlockK + g) * L::kPitch;",
        "const float* kr = ks + (((tile + (kt0 >= 1024)) % L::kGroup) * "
        "kBlockK + g) * L::kPitch;"),
    # the f32 dq, past key 1024: ds K reads the K of the other ring stage
    "f32_dq_neighbour_stage_k": (
        BWD_SOURCE,
        "kt + group * kHalfTile * P + first_col<D>(lo)",
        "(kt0 >= 1024 ? smem + L::kDqK + (stage ^ 1) * L::kArray : kt) + "
        "group * kHalfTile * P + first_col<D>(lo)"),
    # the f32 dk/dv under a causal mask: a key block starts one query tile
    # late, past its first live one
    "f32_dkv_first_tile_late": (
        BWD_SOURCE,
        "return q_start <= 0 ? 0 : min(n_qtiles, q_start / kTile);",
        "return q_start <= 0 ? 0 : min(n_qtiles, q_start / kTile + 1);"),
    # head dim 256. The bf16 forward's S reads K's 64-column sub-tiles a
    # Q sub-tile apart (the 128-row stride, not the 64-key tile's)
    "d256_fwd_k_subtile": (
        SM90_SOURCE,
        "sw128_desc(s_k + s * L::kTile + (kk / 4) * L::kKVSub + along, 16,",
        "sw128_desc(s_k + s * L::kTile + (kk / 4) * (kN == 64 ? L::kQSub : "
        "L::kKVSub) + along, 16,"),
    # the bf16 dk/dv split: warpgroup 1's dK += dS^T Q reads the dO tile
    "d256_dkv_dk_reads_do": (
        SM90_BWD_SOURCE,
        "const uint32_t grad_b = wg == 0 ? s_do : s_q;",
        "const uint32_t grad_b = s_do;"),
    # the bf16 dk/dv hand-off: warpgroup 1 reads the other buffer's P^T
    # (the tile before's, or the next tile's as it is written)
    "d256_dkv_other_pt_buffer": (
        SM90_BWD_SOURCE,
        "const float4 p4 = handoff[(kStep / 8 * buf + j) * 128];",
        "const float4 p4 = handoff[(kStep / 8 * (buf ^ 1) + j) * 128];"),
    # the f32 forward's 4 x 4 score tiles take rows 8 apart, as the 8 x 4
    # tiles of D 128 do: a thread's rows overlap its neighbours'
    "d256_f32_score_rows": (
        FWD_SOURCE,
        "qr + L::kRowGroups * r * L::kPitch + c);",
        "qr + 8 * r * L::kPitch + c);"),
    # the f32 dk/dv's one Q stage: the second live query tile keeps the
    # first tile's Q
    "d256_f32_dkv_stale_q": (
        BWD_SOURCE,
        "if (L::kStages == 1 && qi > first) {",
        "if (L::kStages == 1 && qi > first + 1) {"),
    # head dims past 256. The f32 forward's chunked body leaves the last
    # 256-column chunk of q and k out of every score
    "past256_f32_drop_last_chunk": (
        FWD_SOURCE,
        "score_chains<D>(smem + L::kQ, smem + L::kK, kt0, s);",
        "if (dc + 1 < n_dc) score_chains<D>(smem + L::kQ, smem + L::kK, kt0, s);"),
    # the bf16 forward's chunked body leaves the last 64-column sub-tile of
    # q and k out of S (its stage still waited on and released)
    "past256_bf16_drop_last_subtile": (
        SM90_SOURCE,
        "for (int kk = 0; kk < 4; ++kk) {",
        "for (int kk = 0; kk < (j + 1 < n_sub ? 4 : 0); ++kk) {"),
    # K4a's chunked scores restart each chunk's chain at 0 and add the
    # chains: within 1e-5, off the f32 prefill row's bits
    "past256_decode_chain_restart": (
        DECODE_SOURCE,
        "qs, krow, dc == 0 ? 0.f : *s_at);",
        "qs, krow, 0.f) + (dc == 0 ? 0.f : *s_at);"),
    # the f32 dq's chunked body leaves the last 256-column chunk (its
    # pieces) of q, k, do and v out of every s and dp
    "past256_f32_dq_drop_last_chunk": (
        BWD_SOURCE,
        "      piece_dots(st + ((group ? kRows : 0) + hi) * PP,\n"
        "                 st + (2 * kRows + (group ? kTile : 0) + lo) * PP, sd);\n"
        "      if (s == n_pieces - 1) {  // p and ds:",
        "      if (s + kHeadChunk / kPiece < n_pieces)\n"
        "      piece_dots(st + ((group ? kRows : 0) + hi) * PP,\n"
        "                 st + (2 * kRows + (group ? kTile : 0) + lo) * PP, sd);\n"
        "      if (s == n_pieces - 1) {  // p and ds:"),
    # the f32 dk/dv's chunked body restarts its s^T and dp^T chains at 0 at
    # every 256-column chunk: only the last chunk's columns count
    "past256_f32_dkv_chain_restart": (
        BWD_SOURCE,
        "if (s == 0) {  // a new tile's s^T or dp^T",
        "if (s % (kHeadChunk / kPiece) == 0) {  // a new tile's s^T or dp^T"),
    # the f32 dk/dv's chunked body takes the products of the block's second
    # chunk against the first chunk's Q and dO
    "past256_f32_dkv_second_chunk_first_operand": (
        BWD_SOURCE,
        "if (n_own > 1) chunk_accumulate<kKvStepQueries>(w, m + kSlab, acc[1]);",
        "if (n_own > 1) chunk_accumulate<kKvStepQueries>(w, m, acc[1]);"),
    # the bf16 chunked backward keeps only the last 256-column chunk's
    # share of S and dP (the chunks' f32 sum restarted at each)
    "past256_bf16_bwd_chain_restart": (
        SM90_BWD_SOURCE,
        "total[i] = __fadd_rn(total[i], part[i]);",
        "total[i] = part[i];"),
    # the bf16 dk/dv's last column chunk writes dV 256 columns early, over
    # the chunk before it
    "past256_bf16_dkv_dv_chunk_offset": (
        SM90_BWD_SOURCE,
        "__nv_bfloat16* out = wg == 0 ? dv : dk;",
        "__nv_bfloat16* out = wg == 0 ? dv - (col0 + kHeadChunk == d ? "
        "kHeadChunk : 0) : dk;"),
    # the dq wrapper past 256 takes its plain version on a CUDA tensor, as a
    # quiet fallback would
    "past256_dq_plain_fallback": (
        "raydp_tpu_torch/ops/flash_attention.py",
        "    (dq,) = _bwd_launch(\"rtt_flash_bwd_dq\", \"flash_bwd_dq\", q, k, v, lse,",
        "    if q.shape[-1] > 256:\n"
        "        return flash_bwd_dq_plain(q, k, v, lse, dsum, g, int(q_offset),\n"
        "                                  int(k_offset), causal)\n"
        "    (dq,) = _bwd_launch(\"rtt_flash_bwd_dq\", \"flash_bwd_dq\", q, k, v, lse,"),
    # K4b's combine drops the last chunk where the cache runs past key 1024
    "decode_int8_drop_last_chunk": (
        DECODE_INT8_SOURCE,
        "for (int c = 0; c < live_chunks; ++c) {",
        "for (int c = 0; c < live_chunks - (live_chunks * kChunk > 1024); "
        "++c) {"),
    # the estimator: a resume at (epoch, step) replays from step + 1
    "resume_skips_a_step": (
        "raydp_tpu_torch/estimator/estimator.py",
        "else (epoch, step))",
        "else (epoch, step + 1))"),
    # the wire's widen takes the scale of the next row
    "widen_next_row_scale": (
        "raydp_tpu_torch/exchange/torch_io.py",
        "return (q.to(dtype) * scale).to(dtype)",
        "return (q.to(dtype) * torch.roll(scale, -1, dims=-2)).to(dtype)"),
    # a segment's last step reads its first step's batch again, as a step
    # would read memory that another upload's data took over
    "segment_last_step_rereads": (
        "raydp_tpu_torch/estimator/stream.py",
        "segment.y[i]) for i in range(n)),",
        "segment.y[i]) for i in [*range(n - 1), 0]),"),
}


PLANTED_BUILD_GIB = 4  # the host memory one copy's build may take


def planted_check_mode(source: str) -> str:
    """The checks a planted fault in ``source`` must fail: the kernel
    layer's (a CUDA source or a kernel wrapper under ``ops/``) under
    ``--bf16-checks``, a fit's Python modules under ``--fit-checks``."""
    kernel_layer = "/csrc/" in source or "/ops/" in source
    return "--bf16-checks" if kernel_layer else "--fit-checks"


def planted_faults(names=None) -> int:
    """Each fault of PLANTED_FAULTS (or those of ``names``) in its own copy
    of the port under build/planted/<fault>/, held to ``planted_check_mode``
    's checks: 0 if every copy fails them with a disagreement, else 1. The
    port's library is built first; each copy starts from its objects
    (``_build`` names them by their sources), so it compiles only the
    source its fault changed, and the copies compile in parallel, one nvcc
    each, before their checks run one copy at a time. A copy that does not
    build is reported as such (its build's output logged), not run, and
    fails the run as a fault not caught would."""
    root = Path(__file__).resolve().parent
    unknown = sorted(set(names or ()) - set(PLANTED_FAULTS))
    require(not unknown, f"no planted fault named {unknown}")
    _build.build()
    copies = {}
    for name, (source, site, fault) in PLANTED_FAULTS.items():
        if names and name not in names:
            continue
        copy = root / "build" / "planted" / name
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "raydp_tpu_torch", copy / "raydp_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(_build.BUILD_DIR, copy / "build" / "raydp_tpu_torch",
                        ignore=shutil.ignore_patterns("*.lock", "*.tmp*"))
        shutil.copy2(root / "chip_smoke.py", copy / "chip_smoke.py")
        src = copy / source
        text = src.read_text()
        require(text.count(site) == 1, f"{name}: its site is not in {source}")
        src.write_text(text.replace(site, fault))
        copies[name] = (source, copy)
    t0 = time.perf_counter()
    # one build a core, and at most one for each PLANTED_BUILD_GIB of the
    # host's free memory
    free_gib = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2**30
    slots = max(1, min(len(os.sched_getaffinity(0)),
                       int(free_gib // PLANTED_BUILD_GIB)))
    builds, pending = {}, list(copies)
    while pending or any(p.poll() is None for p, _ in builds.values()):
        running = sum(p.poll() is None for p, _ in builds.values())
        while pending and running < slots:
            name = pending.pop(0)
            out = open(copies[name][1] / "build.log", "w")
            builds[name] = (subprocess.Popen(
                [sys.executable, "-c",
                 "from raydp_tpu_torch.ops import _build; _build.build()"],
                cwd=copies[name][1], stdout=out, stderr=subprocess.STDOUT), out)
            running += 1
        time.sleep(0.5)
    for _, out in builds.values():
        out.close()
    failed = sorted(n for n, (p, _) in builds.items() if p.returncode != 0)
    log(f"planted copies built: {len(builds)} in "
        f"{time.perf_counter() - t0:.1f} s, {slots} at a time; failed "
        f"{failed}")
    caught = {}
    for name in failed:
        source, copy = copies.pop(name)
        caught[name] = {"source": source, "rc": builds[name][0].returncode,
                        "caught": False, "build_failed": True,
                        "last_check": None}
        log(f"planted fault {name} ({source}): its copy did not build\n"
            + (copy / "build.log").read_text()[-4000:])
    for name, (source, copy) in copies.items():
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", planted_check_mode(source)],
            cwd=copy, capture_output=True, text=True, timeout=600)
        found = run.returncode != 0 and "disagrees" in run.stderr
        lines = run.stdout.strip().splitlines()
        caught[name] = {"source": source, "rc": run.returncode,
                        "caught": found,
                        "last_check": lines[-1] if lines else None}
        log(f"planted fault {name} ({source}): exit {run.returncode}, "
            f"caught {found}; {caught[name]['last_check']}")
        if not found:
            log(run.stderr[-2000:])
    log(json.dumps({"planted_faults": caught}))
    return 0 if all(row["caught"] for row in caught.values()) else 1


# ---------------------------------------------------------------------------
# phase_chaos: tools/chaos.py's scenarios on the port, the fit on the card
# ---------------------------------------------------------------------------

CHAOS_MODES = "donation,lockdep,leaks-strict"  # the chaos runner's default
CHAOS_FIT_ROWS = 2048  # scenario_mid_fit's size in tools/chaos.py
# the scenarios run on the card's host, at the tool's sizes
CHAOS_HOST_ROWS = {"executor_kill_with_service": 120_000, "host_death": 60_000}
# the model scenarios, their replicas on the card at the tool's sizes: the
# MLP's 240 requests through a replica's SIGKILL, and chaos.DECODE_LM's four
# streams of 12 tokens (f32, D 16) through another's
CHAOS_MODEL_SCENARIOS = ("replica_kill_during_load", "replica_kill_during_decode")
CHAOS_KEYS = ("seconds", "scenarios", "donation", "params_device")


def chaos_scenarios(device, rows: int, host_rows: dict, fits: list,
                    models=CHAOS_MODEL_SCENARIOS) -> list:
    """The runner's scenarios: ``scenario_mid_fit`` on ``device`` (its two
    fits' ``state_dict()``s appended to ``fits``), then each scenario of
    ``host_rows`` at its rows, then each of ``models`` with its replicas on
    ``device``, its report with the replicas the deployment replaced while
    it ran (``replacements``). Named as the runner names them."""
    from raydp_tpu_torch import chaos
    from raydp_tpu_torch.obs.metrics import metrics

    def scenario_mid_fit():
        return chaos.scenario_mid_fit(rows=rows, device=device, fits=fits)

    def on_host(name):
        def scenario():
            return getattr(chaos, "scenario_" + name)(rows=host_rows[name])

        scenario.__name__ = "scenario_" + name
        return scenario

    def with_replicas(name):
        def scenario():
            replaced = metrics.counter("serve.replica_replacements")
            before = replaced.value
            rep = getattr(chaos, "scenario_" + name)(device=device)
            return rep | {"replacements": int(replaced.value - before)}

        scenario.__name__ = "scenario_" + name
        return scenario

    return ([scenario_mid_fit] + [on_host(name) for name in host_rows]
            + [with_replicas(name) for name in models])


def chaos_model_verdict(entries: dict) -> None:
    """The model scenarios' gates, where they ran: none of the load's
    requests dropped and every response bitwise the unkilled run's; every
    decode stream whole, its tokens the clean run's, with no error; at
    least one failover (a replica replaced under load, a stream moved off
    the killed replica); the pool healed."""
    load = entries.get("replica_kill_during_load")
    if load is not None:
        require(load.get("ok") and load.get("dropped_requests") == 0
                and load.get("byte_identical")
                and load.get("replacements", 0) >= 1 and load.get("pool_healed"),
                f"chaos: the replica killed under load: {load}")
    decode = entries.get("replica_kill_during_decode")
    if decode is not None:
        require(decode.get("ok") and decode.get("token_identical")
                and decode.get("streams_complete") and not decode.get("errors")
                and decode.get("failovers", 0) >= 1 and decode.get("pool_healed"),
                f"chaos: the replica killed mid-decode: {decode}")


def chaos_verdict(report: dict, fits: list, device, leftover: list) -> None:
    """The phase's gates over the runner's report: every scenario ok (the
    mid-fit bitwise with a re-executed task, the model scenarios by
    ``chaos_model_verdict``), the fits' parameters on ``device``, no
    stranded thread, a clean strict leak audit, no segment left."""
    entries = {e["name"]: e for e in report["scenarios"]}
    fit = entries.get("mid_streaming_fit_kill", {})
    require(fit.get("ok") and fit.get("byte_identical")
            and fit.get("reexecuted_tasks", 0) >= 1,
            f"chaos: the killed fit is not the unkilled one's: {fit}")
    chaos_model_verdict(entries)
    want = torch.device(device).type
    require(len(fits) == 2 and all(t.device.type == want
                                   for state in fits for t in state.values()),
            f"chaos: the fits' parameters are not on {want}")
    require(all(e.get("sanitizer", {}).get("threads", 0) == 0
                for e in report["scenarios"]),
            f"chaos: a scenario stranded a thread: {report['scenarios']}")
    require(report["sanitizer_findings"] == 0
            and "cluster_shutdown" not in entries,
            f"chaos: the strict leak audit at shutdown failed: {entries}")
    require(report["ok"], f"chaos: a scenario failed: {report['scenarios']}")
    require(not leftover, f"chaos: segments outlived the phase: {leftover}")


def chaos_segments() -> set:
    """The port's store segments on this host. The sessions of
    ``phase_chaos`` keep the default namespace (a namespace of the
    driver's own keeps the block service from owning the blocks, in both
    packages), so the phase compares the host's set before and after it:
    on the card's machine nothing else makes them."""
    from raydp_tpu_torch.cluster.common import SHM_PREFIX

    return {name for name in os.listdir("/dev/shm")
            if name.startswith(SHM_PREFIX)}


def phase_chaos(device, rows: int = CHAOS_FIT_ROWS,
                host_rows: dict = None, models=CHAOS_MODEL_SCENARIOS) -> dict:
    """``raydp_tpu_torch.chaos.run`` of ``chaos_scenarios`` under
    ``CHAOS_MODES`` (the environment restored after), then
    ``chaos_verdict`` with the segments the phase left. Records the
    runner's report, each scenario's seconds and the donation guard's
    checks and registered ranges over the phase. The cluster comes up with
    the first scenario and its fork template with it, armed with torch and
    the serving modules (``WARM_TORCH_ENV``, as for a serving deployment):
    a cold replica on the card imports them itself before it is up, which
    can outlast the model scenarios' wait for the pool to heal."""
    from raydp_tpu_torch import chaos, sanitize
    from raydp_tpu_torch.cluster.zygote import WARM_TORCH_ENV

    host_rows = CHAOS_HOST_ROWS if host_rows is None else host_rows
    armed = {"RAYDP_TPU_SANITIZE": CHAOS_MODES,
             "RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", WARM_TORCH_ENV: "1"}
    saved_env = {key: os.environ.get(key) for key in armed}
    os.environ.update(armed)
    fits: list = []
    segments = chaos_segments()
    before = sanitize.donation_stats()
    t0 = time.perf_counter()
    try:
        report = chaos.run(chaos_scenarios(device, rows, host_rows, fits,
                                           models))
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    seconds = time.perf_counter() - t0
    after = sanitize.donation_stats()
    leftover = sorted(chaos_segments() - segments)
    rec = {
        "seconds": seconds,
        "scenarios": report["scenarios"],
        "donation": {"checks": after["checks"] - before["checks"],
                     "registered": after["registered"] - before["registered"],
                     "live": after["live"]},
        "params_device": sorted({str(t.device) for state in fits
                                 for t in state.values()}),
    }
    log(f"chaos: {seconds:.3f} s; " + "; ".join(
        f"{e['name']} {'ok' if e.get('ok') else 'FAILED'} {e['seconds']} s"
        for e in report["scenarios"]))
    chaos_verdict(report, fits, device, leftover)
    return rec


EXAMPLES_LIMIT_S = 180.0  # the whole phase
EXAMPLES_KNOBS = ("EXAMPLE_ROWS", "EXAMPLE_EPOCHS", "EXAMPLE_ROUNDS")
EXAMPLES_KEYS = ("seconds", "examples", "trace_smoke", "launches",
                 "segments_left")


@contextlib.contextmanager
def counted_forwards(cls):
    """Count the calls of ``cls.forward`` while inside, with the devices
    of the module's parameters at each call."""
    calls = {"n": 0, "devices": set()}
    original = cls.forward

    def forward(self, *args, **kw):
        calls["n"] += 1
        calls["devices"].add(str(next(self.parameters()).device))
        return original(self, *args, **kw)

    cls.forward = forward
    try:
        yield calls
    finally:
        cls.forward = original


def captured_main(module: str, argv: list) -> tuple:
    """``main(argv)`` of ``module`` with its standard output captured and
    logged: (its return value, the output, seconds)."""
    import io

    main_fn = importlib.import_module(module).main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main_fn(argv)
    seconds = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"  {module.rsplit('.', 1)[-1]}| {line}")
    return result, out.getvalue(), seconds


def example_record(name: str, history_losses: list, params, stdout: str,
                   expected: tuple, seconds: float, device) -> dict:
    """One example's verdict: every fitted parameter on ``device``, the
    first loss above the last, the lines tests/test_examples.py asserts."""
    devices = sorted({str(p.device) for p in params})
    rec = {"seconds": seconds, "losses": history_losses,
           "params_device": devices}
    log(f"example {name}: {seconds:.2f} s, losses {history_losses}, "
        f"parameters on {devices}")
    require(devices == [str(device)], f"{name}: parameters on {devices}")
    require(history_losses[0] > history_losses[-1],
            f"{name}: the loss did not fall {history_losses}")
    for text in expected:
        require(text in stdout, f"{name} printed no {text!r}")
    return rec


def phase_examples(device, argv=(), knobs=None) -> dict:
    """The port's examples that reach the card, each through ``main([])``
    (no ``--device``: the card is the default) at the JAX scripts' default
    sizes: ``nyctaxi`` (100,000 rows, 5 epochs), ``dlrm_criteo`` (50,000
    rows, 3 epochs, W 1: no process group) and ``long_context_lm`` (W 1,
    seq 128, a group of one of its own). Each: every fitted parameter on
    the card, the first epoch's (step's) loss above the last, the lines
    tests/test_examples.py asserts; for ``dlrm_criteo`` one K1 launch a
    DLRM forward pass and every forward on the card. Then
    ``raydp_tpu_torch.tools.trace_smoke.main([])``: its ``trace ok`` line
    and its replica's ``flash_fwd_f32`` and ``flash_decode`` launches
    above 0 at head dim 16, read from the head before the deployment
    closed. No ``rtpt-`` segment of the phase is left; every session
    runs with a zygote of its own (``phase_leftovers`` checks the
    processes at the end of the run).

    ``argv`` and ``knobs`` (``EXAMPLE_*`` values, None for the scripts'
    defaults) are for a run on the CPU (``--device cpu``), where the plain
    versions launch nothing: there every launch count must be 0."""
    from raydp_tpu_torch.models.dlrm import DLRM

    argv = list(argv)
    on_card = device.type == "cuda"
    armed = {"RAYDP_TPU_TORCH_NO_GLOBAL_ZYGOTE": "1", **(knobs or {})}
    saved = {k: os.environ.get(k) for k in (*armed, *EXAMPLES_KNOBS)}
    for knob in EXAMPLES_KNOBS:  # the scripts' defaults
        os.environ.pop(knob, None)
    os.environ.update(armed)
    segments = chaos_segments()
    t0 = time.perf_counter()
    rec: dict = {"examples": {}}
    try:
        result, stdout, sec = captured_main(
            "raydp_tpu_torch.examples.nyctaxi", argv)
        est = result["estimator"]
        rec["examples"]["nyctaxi"] = example_record(
            "nyctaxi", [r["train_loss"] for r in result["history"]],
            est.get_model().parameters(), stdout, ("train_loss",), sec, device)

        ia.reset_launches()
        with counted_forwards(DLRM) as forwards:
            result, stdout, sec = captured_main(
                "raydp_tpu_torch.examples.dlrm_criteo", argv)
        if on_card:
            torch.cuda.synchronize()
        launches = ia.LAUNCHES["interaction_fwd"]
        est = result["estimator"]
        rec["examples"]["dlrm_criteo"] = example_record(
            "dlrm_criteo", [r["train_loss"] for r in result["history"]],
            est.get_model().parameters(), stdout, ("train_loss",), sec, device
        ) | {"world": result["world"], "forwards": forwards["n"],
             "forward_devices": sorted(forwards["devices"]),
             "interaction_fwd": launches}
        log(f"example dlrm_criteo: interaction_fwd {launches} launches for "
            f"{forwards['n']} DLRM forward passes on {forwards['devices']}")
        require(result["world"] == 1, "dlrm_criteo did not run at W 1")
        require(forwards["n"] > 0
                and launches == (forwards["n"] if on_card else 0),
                f"interaction_fwd launched {launches} times for "
                f"{forwards['n']} DLRM forward passes")
        require(forwards["devices"] == {str(device)},
                f"DLRM forward passes on {forwards['devices']}")

        fa.reset_launches()
        result, stdout, sec = captured_main(
            "raydp_tpu_torch.examples.long_context_lm", argv)
        rec["examples"]["long_context_lm"] = example_record(
            "long_context_lm", result["losses"], result["model"].parameters(),
            stdout, ("step 4",), sec, device) | {
                "world": result["world"],
                "flash_launches": sum(fa.LAUNCHES.values())}
        # attn_impl="ring", as the JAX script: the ring's products in torch ops
        require(sum(fa.LAUNCHES.values()) == 0,
                f"long_context_lm launched attention kernels {fa.LAUNCHES}")

        _, stdout, sec = captured_main("raydp_tpu_torch.tools.trace_smoke",
                                       argv)
        line = next((x for x in stdout.splitlines()
                     if x.startswith("replica launches:")), None)
        require(line is not None, "trace_smoke printed no replica launches")
        smoke = json.loads(line.split(":", 1)[1])
        rec["trace_smoke"] = {"seconds": sec, "replica_launches": smoke,
                              "trace_ok": "trace ok:" in stdout}
        log(f"trace_smoke: {sec:.2f} s, replica launches {smoke}")
        require("trace ok:" in stdout, "trace_smoke printed no 'trace ok'")
        require(smoke["head_dim"] == 16 and all(
            (smoke[k] > 0) == on_card for k in ("flash_fwd_f32", "flash_decode")),
            f"trace_smoke's replica launched {smoke}")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {
        "interaction_fwd": rec["examples"]["dlrm_criteo"]["interaction_fwd"],
        "flash_fwd_f32": rec["trace_smoke"]["replica_launches"]["flash_fwd_f32"],
        "flash_decode": rec["trace_smoke"]["replica_launches"]["flash_decode"],
    }
    rec["segments_left"] = sorted(chaos_segments() - segments)
    log(f"examples: {rec['seconds']:.1f} s; " + ", ".join(
        f"{name} {r['seconds']:.1f} s" for name, r in rec["examples"].items())
        + f", trace_smoke {rec['trace_smoke']['seconds']:.1f} s; launches "
        f"{rec['launches']}; segments left {rec['segments_left']}")
    require(not rec["segments_left"],
            f"the examples left segments {rec['segments_left']}")
    require(rec["seconds"] <= EXAMPLES_LIMIT_S,
            f"phase_examples took {rec['seconds']:.1f} s")
    return rec


LEFTOVER_DEADLINE_S = 15.0  # the script's processes gone at its end


def own_processes() -> list:
    """The live processes, other than this one, that the script started:
    its descendants, and every process of the port's cluster runtime (a
    head or zygote is re-parented when the process that started it
    exits; one started before the script is not its). Zombies are already
    dead, and this process's ancestors (a shell that names the repo) did
    not come from it; both are left out."""
    parents, started, runtime = {}, {}, set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read()
        except (OSError, ValueError):
            continue
        if fields[0] == "Z":
            continue
        # the state, the parent, ..., the start time in clock ticks
        parents[int(entry)], started[int(entry)] = int(fields[1]), int(fields[19])
        if b"raydp_tpu_torch" in cmdline:
            runtime.add(int(entry))
    runtime = {pid for pid in runtime
               if started[pid] >= started.get(os.getpid(), 0)}

    def chain(pid):
        seen = []
        while pid in parents and pid not in seen:
            seen.append(pid)
            pid = parents[pid]
        return seen

    ancestors = set(chain(os.getpid()))
    return sorted(pid for pid in parents if pid not in ancestors
                  and (pid in runtime or os.getpid() in chain(pid)))


def phase_leftovers() -> dict:
    """At the script's end: within LEFTOVER_DEADLINE_S no process that it
    started is alive. Any still alive after that are named, killed, and
    fail the run. multiprocessing's resource tracker, which the spawned
    ranks started, is stopped first: it would end with the script, and
    stopped it leaves nothing alive to tell apart from a leftover."""
    import threading
    from multiprocessing import resource_tracker

    t0 = time.perf_counter()
    deadline = time.monotonic() + LEFTOVER_DEADLINE_S
    # closes its pipe and reaps it; in a thread, since a process still
    # holding the pipe would keep it alive (and is then named below)
    threading.Thread(target=resource_tracker._resource_tracker._stop,
                     daemon=True).start()
    left = own_processes()
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = own_processes()
    named = {}
    for pid in left:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                named[pid] = f.read().replace(b"\0", b" ").decode(
                    errors="replace")
            os.kill(pid, signal.SIGKILL)
        except OSError:
            continue
    require(not named, f"processes the script started outlived it: {named}")
    gone_s = time.perf_counter() - t0
    log(f"leftovers: none ({gone_s:.3f} s)")
    return {"gone_s": gone_s}


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--planted-faults"]:
        return planted_faults(argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if argv == ["--bf16-checks"]:
        bf16_checks(device)
        return 0
    if argv == ["--k1-k5"]:
        k1_k5(device)
        return 0
    if argv == ["--fit-checks"]:
        fit_checks(device)
        return 0
    if argv == ["--store"]:
        phase_device()
        dlrm = phase_dlrm(device)
        phase_store(device, dlrm)
        return 0
    if argv == ["--etl"]:
        dev = phase_device()
        etl = phase_etl(device, phase_dlrm(device))
        log(json.dumps({"etl": {k: etl[k] for k in ETL_KEYS}
                        | {"nvidia_smi": dev["nvidia_smi"]}}))
        return 0
    if argv == ["--seqpar"]:
        dev = phase_device()
        log(json.dumps(seqpar_summary(phase_seqpar(device), dev["nvidia_smi"])))
        return 0
    if argv == ["--pipeline"]:
        dev = phase_device()
        log(json.dumps(pipeline_summary(phase_pipeline(device),
                                        dev["nvidia_smi"])))
        return 0
    if argv == ["--moe"]:
        dev = phase_device()
        log(json.dumps(moe_summary(phase_moe(device), dev["nvidia_smi"])))
        return 0
    if argv == ["--estimators"]:
        dev = phase_device()
        estimators = phase_estimators(device, phase_dlrm(device))
        log(json.dumps(estimators_summary(estimators, dev["nvidia_smi"])))
        return 0
    if argv == ["--sharded"]:
        dev = phase_device()
        sharded = phase_sharded_dlrm(device, phase_dlrm(device))
        log(json.dumps(sharded_summary(sharded, dev["nvidia_smi"])))
        return 0
    if argv == ["--examples"]:
        dev = phase_device()
        rec = phase_examples(device)
        log(json.dumps({"examples": {k: rec[k] for k in EXAMPLES_KEYS}
                        | {"nvidia_smi": dev["nvidia_smi"]}}))
        phase_leftovers()
        return 0
    if argv == ["--small-heads"]:
        dev = phase_device()
        gen = torch.Generator(device=device).manual_seed(SEED)
        checks = check_small_heads(gen, device)
        log(json.dumps(small_heads_summary(checks, small_head_times(device),
                                           dev["nvidia_smi"])))
        return 0
    if argv == ["--wide-heads"]:
        dev = phase_device()
        gen = torch.Generator(device=device).manual_seed(SEED)
        checks = check_wide_heads(gen, device)
        log(json.dumps(wide_heads_summary(checks, wide_head_times(device),
                                          dev["nvidia_smi"])))
        return 0
    if argv == ["--wide-lm"]:
        dev = phase_device()
        log(json.dumps(wide_lm_summary(phase_wide_lm(device),
                                       dev["nvidia_smi"])))
        return 0
    if argv == ["--heads-past-256"]:
        dev = phase_device()
        gen = torch.Generator(device=device).manual_seed(SEED)
        checks = check_heads_past_256(gen, device)
        log(json.dumps(heads_past_256_summary(
            checks, heads_past_256_times(device), dev["nvidia_smi"])))
        return 0
    if argv == ["--lm-4096"]:
        dev = phase_device()
        log(json.dumps(lm_4096_summary(phase_lm_4096(device),
                                       dev["nvidia_smi"])))
        return 0
    if argv == ["--small-lm"]:
        dev = phase_device()
        log(json.dumps(small_lm_summary(phase_small_lm(device),
                                        dev["nvidia_smi"])))
        phase_leftovers()
        return 0
    if argv == ["--chaos"]:
        dev = phase_device()
        chaos_rec = phase_chaos(device)
        log(json.dumps({"chaos": {k: chaos_rec[k] for k in CHAOS_KEYS}
                        | {"nvidia_smi": dev["nvidia_smi"]}}))
        phase_leftovers()
        return 0
    if argv == ["--deploy"]:
        dev = phase_device()
        deployed = phase_deploy(device, phase_dlrm(device)["final_state"])
        log(json.dumps({"deploy": {k: deployed[k] for k in DEPLOY_KEYS}
                        | {"nvidia_smi": dev["nvidia_smi"]}}))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    wall = {}  # each phase's seconds on the host's clock

    def timed(key, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        wall[key] = time.perf_counter() - t0
        return out

    record = {"device": timed("device", phase_device)}
    record["checks"] = timed("checks", phase_kernels, device)
    record["serve"] = timed("serve", phase_serve, device)
    record["cluster"] = timed("cluster", phase_cluster, device,
                              record["serve"]["runs"][0])
    record["train"] = timed("train", phase_train, device)
    record["train_f32"] = timed("train_f32", phase_train_f32, device)
    record["small_lm"] = timed("small_lm", phase_small_lm, device)
    record["wide_lm"] = timed("wide_lm", phase_wide_lm, device)
    record["lm_4096"] = timed("lm_4096", phase_lm_4096, device)
    record["seqpar"] = timed("seqpar", phase_seqpar, device)
    record["pipeline"] = timed("pipeline", phase_pipeline, device)
    record["moe"] = timed("moe", phase_moe, device)
    record["train_int8"] = timed("train_int8", phase_train_int8, device,
                                 record["train"]["first_loss"])
    record["stochastic"] = timed("stochastic", phase_stochastic, device)
    record["dlrm"] = timed("dlrm", phase_dlrm, device)
    dlrm_state = record["dlrm"].pop("final_state")  # tensors, kept out of the record
    record["store"] = timed("store", phase_store, device,
                            dict(record["dlrm"], final_state=dlrm_state))
    record["sharded"] = timed("sharded", phase_sharded_dlrm, device,
                              dict(record["dlrm"], final_state=dlrm_state))
    record["etl"] = timed("etl", phase_etl, device, record["dlrm"])
    record["estimators"] = timed("estimators", phase_estimators, device,
                                 record["dlrm"])
    record["examples"] = timed("examples", phase_examples, device)
    record["deploy"] = timed("deploy", phase_deploy, device, dlrm_state)
    del dlrm_state
    record["fit"] = timed("fit", phase_fit, device, record["dlrm"])
    record["obs"] = timed("obs", phase_obs, device, record["dlrm"])
    record["times"] = timed("times", phase_times, device)
    record["chaos"] = timed("chaos", phase_chaos, device)
    record["leftovers"] = phase_leftovers()
    record["phase_wall_s"] = wall
    log(json.dumps({"phase_wall_s": {k: round(v, 1) for k, v in wall.items()}}))
    kernels = kernels_line(record["checks"], record["serve"], record["train"],
                           record["times"], record["dlrm"],
                           record["train_int8"], record["stochastic"],
                           record["fit"], record["deploy"],
                           record["train_f32"], record["etl"],
                           record["seqpar"], record["sharded"],
                           record["pipeline"], record["estimators"],
                           record["examples"], record["small_lm"],
                           record["wide_lm"], record["lm_4096"])
    record["kernels"] = kernels["kernels"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"serving": [
        {k: run[k] for k in ("cache", "decode_tok_s", "ttft_ms_p50",
                             "tpot_ms_p50", "prefill_ms_p50")}
        for run in record["serve"]["runs"]]}))
    log(json.dumps({"training": {k: record["train"][k] for k in (
        "tokens_s", "step_ms", "mfu", "attention_share", "skip_mfu")}}))
    log(json.dumps({"training_f32": {k: record["train_f32"][k] for k in (
        "step_ms", "tokens_s", "loss_rel", "worst_grad_rel")}
        | {"nvidia_smi": record["device"]["nvidia_smi"]}}))
    log(json.dumps(seqpar_summary(record["seqpar"],
                                  record["device"]["nvidia_smi"])))
    log(json.dumps(pipeline_summary(record["pipeline"],
                                    record["device"]["nvidia_smi"])))
    log(json.dumps(moe_summary(record["moe"], record["device"]["nvidia_smi"])))
    log(json.dumps({"training_int8_mlp": {k: record["train_int8"][k] for k in (
        "tokens_s", "step_ms", "mfu_int8_mlp", "first_loss_rel")}}))
    log(json.dumps({"dlrm_training": {k: record["dlrm"][k] for k in (
        "samples_s", "step_ms", "mfu", "peak_bytes", "train_loss")}
        | {"device_busy_share": record["dlrm"]["profile"]["device_busy_share"]}}))
    fit = record["fit"]
    log(json.dumps({"dlrm_fit": {
        name: {k: row[k] for k in ("samples_s", "step_ms", "bytes_by_epoch")}
        for name, row in fit["streamed"].items()}
        | {"retries": {name: {k: row[k] for k in (
            "resumes", "resumed_bitwise", "checkpoint_ms", "checkpoint_bytes")}
            for name, row in fit["retries"].items()},
           "phase_coverage": fit["attribution"]["phase_coverage"],
           "streamed_device_busy_share":
               fit["attribution"]["profile"]["device_busy_share"]}}))
    dev, probe = record["device"], record["obs"]
    log(json.dumps({"cluster": {k: record["cluster"][k] for k in CLUSTER_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"],
                       "toolchain": dev["toolchain"]}}))
    log(json.dumps({"store": {k: record["store"][k] for k in STORE_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"]}}))
    log(json.dumps(sharded_summary(record["sharded"], dev["nvidia_smi"])))
    log(json.dumps({"etl": {k: record["etl"][k] for k in ETL_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"]}}))
    log(json.dumps(estimators_summary(record["estimators"], dev["nvidia_smi"])))
    log(json.dumps(small_heads_summary(record["checks"]["small_heads"],
                                       record["times"], dev["nvidia_smi"])))
    log(json.dumps(small_lm_summary(record["small_lm"], dev["nvidia_smi"])))
    log(json.dumps(wide_heads_summary(record["checks"]["wide_heads"],
                                      record["times"], dev["nvidia_smi"])))
    log(json.dumps(wide_lm_summary(record["wide_lm"], dev["nvidia_smi"])))
    log(json.dumps(heads_past_256_summary(record["checks"]["heads_past_256"],
                                          record["times"], dev["nvidia_smi"])))
    log(json.dumps(lm_4096_summary(record["lm_4096"], dev["nvidia_smi"])))
    log(json.dumps({"examples": {k: record["examples"][k]
                                 for k in EXAMPLES_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"]}}))
    log(json.dumps({"deploy": {k: record["deploy"][k] for k in DEPLOY_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"]}}))
    log(json.dumps({"chaos": {k: record["chaos"][k] for k in CHAOS_KEYS}
                    | {"nvidia_smi": dev["nvidia_smi"]}}))
    log(json.dumps({"obs": {
        "decode_obs_overhead": record["serve"]["decode_obs_probe"]["overhead_frac"],
        "step_recorder_overhead": probe["step_recorder_probe"]["overhead_frac"],
        "custom_op_hop_us": probe["custom_op"]["hop_us"],
        "lm_count_over_analytic": probe["flops"]["lm_ratio"],
        "nvidia_smi": dev["nvidia_smi"], "toolchain": dev["toolchain"]}}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
