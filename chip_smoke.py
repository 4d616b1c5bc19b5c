"""Chip smoke for the PyTorch/CUDA port (``ml_trainer_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --only serve    # kernel checks + the serving
                                          # runs (fp32, int8, bf16, bf16
                                          # int8; decode step as a CUDA
                                          # graph and eagerly) + the int8
                                          # quality gate
    python3 chip_smoke.py --only train    # kernel checks + training only
    python3 chip_smoke.py --only dp       # kernel checks + data-parallel
                                          # training only
    python3 chip_smoke.py --only models   # kernel checks + the image and
                                          # encoder families
    python3 chip_smoke.py --only graphs   # kernel checks + every family
                                          # at steps_per_execution 1 and 4
                                          # (CUDA graph replays)
    python3 chip_smoke.py --only resume   # kernel checks + checkpoints
                                          # and fit(resume=True)
    python3 chip_smoke.py --only data     # kernel checks + the native
                                          # loader, image shards, BPE and
                                          # WordPiece data, loss_chunk
    python3 chip_smoke.py --only llama    # kernel checks + Llama 124.7M
                                          # (train fp32/bf16 at K = 1 and
                                          # 4, 2 sharded replicas,
                                          # generate) + gpt2_medium/large
    python3 chip_smoke.py --only cli      # kernel checks + the training
                                          # CLI (resumed bit for bit),
                                          # remat, dropout, the EMA and
                                          # predict()
    python3 chip_smoke.py --only lora     # kernel checks + LoRA: train
                                          # (fp32, bf16 K = 1 and 4),
                                          # export, serve from the adapter
                                          # pool in the decode graph;
                                          # export_torch card vs CPU
    python3 chip_smoke.py --only examples # kernel checks + the notebook
                                          # flows (examples/torch_port
                                          # 01-05) and lamb, lion and
                                          # adafactor at K = 4
    python3 chip_smoke.py --only dist     # kernel checks + one process
                                          # per replica (NCCL at world
                                          # size 1, two gloo processes
                                          # on cuda:0) and the committed
                                          # JPEG shards
    python3 chip_smoke.py --only decode   # kernel checks + speculative
                                          # serving (n-gram and draft
                                          # model), chunked prefill and
                                          # generate()'s modes
    python3 chip_smoke.py --only front    # kernel checks + the serving
                                          # front end: two weighted
                                          # tenants over HTTP, the
                                          # endpoints, the overload
                                          # ladder, the decode watchdog
    python3 chip_smoke.py --only router   # kernel checks + KV migration
                                          # and the router: disaggregated,
                                          # colocated, a replica killed,
                                          # two worker processes over HTTP
    python3 chip_smoke.py --only deploy   # kernel checks + deploy
                                          # generations: a wedged canary
                                          # rolled back, a shadow deploy,
                                          # the autoscaler's repair, a
                                          # canary promoted under open-loop
                                          # traffic, a fleet worker deployed

Phases, one line of output each (or a few):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel source in ``ml_trainer_tpu_torch/csrc/``
   with ``nvcc`` for sm_90a (one process per source, started together),
   with the build seconds and the ``-Xptxas -v`` lines;
3. kernels vs plain, each timed with CUDA events beside its plain
   version, one PyTorch library call where one exists, and its bound:
   the flash-attention forward (K1) on float32 [2, 12, 1024, 64] causal
   (the main row: one training microbatch), the serving prefill rows
   [1, 12, S, 64] causal (S in 128/512/1024, plus kv_len 700 at 1024),
   [8, 12, 1024, 64] non-causal with kv_lens, [2, 8, 1024, 128] causal,
   [5467, 12, 64, 64] causal (``bh_over_65535``: B*H = 65,604, past
   the old grid's cap) and ``bert``, BERT-base fine-tuning's launch
   [32, 12, 128, 64] non-causal with kv_lens ragged in 8..128, out and
   lse each within 1e-4 absolute of the plain version, at the main row,
   [1, 12, 1024, 64] and ``bert`` also bitwise-equal results from two
   calls and device times from profiler events (K1 and SDPA's fp32
   forward with the same boolean mask); its ``bound_ms`` is at the
   3xTF32 rate, ``bound_fp32_core_ms`` at the fp32 CUDA-core rate, as
   for K2/K3 below; the paged-attention decode
   (K6) on B=8, H=12, D=64, page 16, 64 pages per row, 513 pool pages,
   ragged lengths and an all-trash row (the main row), one row of 1024
   positions (``b1_1024``), eight (``b8_full``), D=128 with H=8, D=32,
   and page 8 with lengths at the split boundaries, each within 1e-4
   absolute of its plain version and bitwise equal across two calls,
   its device time taken from CUDA graph replays with the pools cycled
   through copies whose live K/V exceed 2 x L2 (``ms_eager`` beside it:
   the host's rate), the main rows also at each split size; K6's bf16
   entry (q and pools in bf16, a row's splits one thread block cluster)
   at the main row, ``b1_1024``, D=128, D=32 and ``b1_2048`` (16 splits:
   the non-portable cluster size), each within 2 bf16 ulps of its plain
   version (|diff| <= 2^-7 |plain| + 1e-3 max|plain|) and bitwise across
   two calls, timed as the float32 rows, then the planted row (two
   positions, values of opposite sign large against the output) on which
   the kernel must sit within that bar of the plain version and rounding
   the normalised weights, rounding the unnormalised exp(s - m) and not
   rounding must land more than a bar apart; then runs of
   K6 calls with changing B and lengths and of K7 calls with changing M,
   after which every K6 ticket counter of the split merge must be 0; the
   flash backward, K2 (dQ) and K3 (dK/dV), on
   [2, 12, 1024, 64] causal (the main row: one training microbatch),
   [8, 12, 1024, 64] causal (``b8``, the row of earlier figures),
   [8, 12, 1024, 64] non-causal with kv_lens, [2, 8, 1024, 128] causal
   and ``bert`` (as K1's), within atol 2e-4 / rtol 1e-4 of the plain
   backward, with exact-zero dK/dV past kv_lens, plus the padded path's
   gradients (S 1000, head_dim 48) through
   ``attention(implementation="flash")`` against the plain attention; at
   the main row and ``bert`` also bitwise-equal results from two calls
   and device times from profiler events (K2, K3 and SDPA's backward)
   beside the CUDA-event times.  Their ``bound_ms``
   is the operations at the 3xTF32 tensor-core rate (494.7 / 3 TFLOP/s),
   ``bound_fp32_core_ms`` the same at the 67 TFLOP/s fp32 CUDA-core rate;
   K1's bf16 entry point (its own bf16 tensor-core kernel) at every
   float32 row and a ragged S (1000) with bf16 inputs (out within 2 bf16
   ulps of the plain version on the same inputs, |diff| <= 2^-7 |plain|
   + 1e-3 max|plain|; lse within 1e-4; bitwise across two calls), and
   K2's and K3's (their own bf16 tensor-core kernels) at the float32
   rows' coverage, a ragged S (1000) and ``bert``: dQ, dK, dV within the
   same 2-ulp gate, dK/dV exactly 0 past kv_lens, bitwise across two
   calls; K1's out and K2's and K3's gradients each element equal to the
   float32 kernels' result on the widened inputs rounded to bf16, one
   bf16 step from it or within 1e-3 x its max (``ulps_from_f32_kernel``);
   all timed beside SDPA with bf16 inputs (none at ``bh_over_65535``),
   ``bound_ms`` at the 989 TFLOP/s bf16 rate with bf16 values at 2 bytes;
   the int8 matmul (K7) at the four GPT-2 124M decode projections (M=8:
   qkv 768x2304, proj 768x768, fc_in 768x3072, fc_out 3072x768), at M=1,
   ragged M=13 K=130 N=100, the JAX package's bench shape M=8 K=256
   N=1024 and a weight with an all-zero column, each within 1e-5 x
   max|plain| of its plain version and bitwise equal across two calls
   (the projections also timed at each K slice), its device time taken
   from CUDA
   graph replays (an eager call costs the host more than the kernel
   runs) with the weights cycled through more copies than the 50 MB L2
   holds (as a decode step finds them), beside ``F.linear`` on the fp32
   weights (``fp32_dense_ms``) and ``torch._weight_int8pack_mm``
   (``library_ms``, timed only; its refusal is recorded); K7's bf16
   entry (bf16 x and out, the bias added with the JAX layer's two
   roundings) at the four projections, within 2 bf16 ulps of its plain
   version, bitwise across two calls, timed by graph replays beside
   ``torch._weight_int8pack_mm`` on the same bf16 x; the sharded update's optimizer tail, K4
   (unscale + squared sum) and K5 (clip + Adam + write), each one launch
   over a list of leaves: the main row ``step_list`` is one 2-replica
   GPT-2 124M step's lists (each replica's 148 leaves as the plan splits
   them, one launch of each kernel per replica), timed per step by CUDA
   graph replays, eagerly and by profiler device time, beside
   ``torch._foreach_norm`` (K4) and one ``torch._fused_adam_`` (K5) over
   the same lists, both timed only; then one-leaf rows at GPT-2 124M's
   2-replica shapes (the replicated tok_embed, the qkv.weight,
   fc_out.weight and bias shards) and ragged sizes; K4's quotients and
   K5's four outputs bitwise, K4's sums (each leaf's, and sq_loc/sq_rep)
   within 1e-5 relative of the plain versions, every call bitwise across
   two calls;
4. serving: GPT-2 124M at full width (12 layers, 768 wide, 12 heads,
   vocab 50257, max_len 1024) with seeded random weights behind
   ``Server(max_batch=8, kv_page_size=16, paged_kernel=True)``; 8 greedy
   requests of 32 new tokens, prompts of 5..900 tokens, two sharing a
   256-token prefix.  Checks that all complete, that both kernels'
   launch counters advanced as the path requires (the profiled second
   pass also gives K6's and K7's device ms per decode step by kernel
   name), and that every served token is within 1e-3 of the best logit when the sequence is run
   again through the plain attention path.  Then the same requests
   through a second ``Server(..., quant_int8=True)``: K7 must launch
   exactly 4 x 12 times per decode step and nowhere else; a replay of
   each request (fp32 prefill of the prompt, then the served tokens one
   at a time through the S == 1 step with the plain int8 matmul and the
   plain attention) must put every served token within 1e-3 of the best
   logit; the int8 step's relative logit error against the fp32 step's
   and their argmax agreement are reported, not gated (random weights:
   near-ties, and a few percent of error through 12 random layers);
   then the same two runs of the same weights at ``precision="bf16"``
   (bf16 caches and page pools: K1's bf16 prefill, K6 over bf16 pools,
   K7 with bf16 activations), each with exact launch counts (K6 12 per
   decode step, K7 48 per decode step in the int8 run and none in the
   other, K1 the fp32 run's count), the per-call check (every K1, K6
   and K7 call of one prefill and one decode step recorded and held to
   the JAX function computed in float64, rounded where it rounds, within
   2 bf16 ulps), and every served token within max(1e-3, 2 d) of the
   best logit on a teacher-forced replay through the plain versions, d
   the largest logit difference between the replay through the kernels
   and through the plain versions (both printed); reported: the share of
   bf16 greedy tokens equal to fp32's and the int8 run's logit error and
   argmax agreement against bf16;
   each of the four runs is made twice, with the engine's decode step as
   one CUDA graph replay (after its warm-up step and its capture, both
   in the uncounted warm-up request) and eagerly (the baseline): the
   graph run's tokens must equal the eager run's and the launch counts
   must be equal (replays counted), every K6 ticket must be back at 0;
   then a window of decode steps only on an engine of the same shape
   with all 8 slots live, both ways (step ms on the host clock, busy and
   idle share and K6/K7 device ms a step from the profiler, which must
   name K6 under the replays; the capture's seconds and bytes), and the
   logits gate: from one state the step run eagerly, the state
   restored, one replay, bitwise equal logits; the gate once more on a
   contiguous fp32 engine (the plain masked attention); each precision's
   eager and graph numbers on one line (``eager vs graph``);
   then the JAX package's int8 quality gate at full width (``QGATE``): a
   GPT-2 124M trained by the port's ``Trainer`` on a successor map (at
   ``steps_per_execution=4``: its steps as graph replays), whose
   int8 full forward (K7) and int8-served replay must both keep argmax
   agreement >= 0.995 and relative logit error <= 0.02;
5. training: the same model, fp32, through ``Trainer(...).fit()`` with
   the real config of examples/04_gpt2_pretrain.py (seq 1024, batch 8 in
   4 microbatches, adamw, cosine restarts, clip 1.0), 6 optimizer steps
   and 2 validation batches.  First the kernel path's loss and every
   parameter gradient on one microbatch against the plain attention
   path; then the run, which must give finite losses, skip no step and
   launch K1 12 x (24 microbatches + 2 validation batches) times and K2
   and K3 12 x 24 times; then the optimizer-step time (CUDA events),
   tokens/s, peak memory and a profiler split of one step, with K1's,
   K2's and K3's device ms per step beside 48 x their main-row bound;
   then the same run with ``precision="bf16"`` (dynamic loss scale, the
   bf16 K1-K3): its first microbatch loss within 2e-2 of the fp32 run's,
   the kernel path against the kernels' plain versions (loss 2e-3) and
   against exact attention (gradients: ``BF16_*``), the same launch
   counts, its final loss scale, and the per-call check of one step
   (every K1, K2 and K3 call's bf16 inputs and dO recorded, each output
   within 2 bf16 ulps of the float64 JAX function on them);
6. data-parallel training: the same model through ``Trainer(...,
   is_parallel=True, mesh_shape={"data": 2}, device=[cuda, cuda],
   dp_update="sharded")`` (2 replicas sharing the card, global batch 8 =
   4 rows per replica in 2 microbatches, adam with no weight decay: the
   fused tail's configuration), 6 optimizer steps and 2 validation
   batches.  First, from one state and one batch, the single-card step,
   the sharded step with the plain tail and the sharded step with K4/K5:
   losses within 1e-5 relative, kernel vs plain params within 1e-6, one
   card vs sharded within 1e-3; then ``fit()``, which must give finite
   losses, skip no step and launch K4 = K5 = 2 per step, one per replica
   (and the attention kernels per replica microbatch); then the step time,
   tokens/s, peak memory and a profiler split with K1's to K5's device
   ms per step beside their bounds; then a 3-step bf16 run of the same
   (the loss scale folded into K4's denominator; sharded plain vs K4/K5
   at the same bars and with an equal loss scale, no single-card step);
7. the image and encoder families at full width through
   ``Trainer(...).fit()`` on seeded synthetic data (``MODEL_RUNS``):
   ResNet-18 (CIFAR stem, ``SyntheticCIFAR10`` through
   ``custom_pre_process_function``, batch 256), ResNet-50 and ViT-B/16
   (at its default bf16, ``precision="bf16"``) on seeded 224x224 images
   (batch 64 and 32), BERT-base (``right_padded``, batch 32 at sequence
   128, right-padded lengths 8..128; fp32, then bf16) and MLModel (CIFAR
   transforms, batch 32).  First the TF32
   switches (both must be off); ResNet-18's first 32 rows through one
   training step on the card against the same step of the port on the
   CPU from the same weights: in float64 the whole step (loss 1e-4
   relative, gradients 1e-3 and running statistics 1e-4 of their
   largest entry), in float32 the loss and statistics at those bars and
   each layer from its own inputs (outputs 1e-4, gradients 1e-3); BERT's
   kernel path against its plain path on the first batch (as in 5, by
   precision), and in bf16 the per-call check of one step as in 5.
   Each run must give finite losses and skip no step; BERT launches
   exactly 12 K1, K2 and K3 a training step and 12 K1 an eval batch,
   the others no kernel.  Each family's line has its optimizer-step time
   (CUDA events), samples/s, peak memory and a profiler split of one
   step; BERT's also K1-K3 device ms per step beside their bounds;
8. ``steps_per_execution`` (``GRAPH_RUNS``): GPT-2 124M fp32 and bf16
   (``TRAIN``'s config), BERT-base bf16, ViT-B/16 bf16, ResNet-50 and
   MLModel (``MODEL_RUNS``' configs; the four transformers at their
   widths with depth cut to ``CUT_DEPTH`` blocks), each through ``Trainer.fit()`` at
   K = 1 (the eager step) and at K = 4 (each full chunk of 4 batches one
   replay of a CUDA graph of the 4 steps; 9 steps: two chunks, the
   first eager before the capture, and a tail of one; 9 validation
   batches: the eval graph's chunk and a tail) from the same weights and
   data.  Gates: finite losses, no skipped step, exact launch counts in
   both runs (K1 depth a microbatch and a validation batch, K2/K3 depth
   a microbatch, replays counted), the K = 4 run's parameters, buffers
   and optimizer state bitwise those of K = 1 and its epoch losses and
   metrics within 1e-6 relative (the sums' order), for every family
   (cuDNN's deterministic algorithms are the port's default).  Printed
   per family: the optimizer-step time (CUDA events)
   eager, graph, graph, eager on one chunk, tokens/s or samples/s, peak
   memory of both fits, the capture's seconds, device-busy ms and idle
   share of one profiled graph dispatch and of one eager step, the eager
   step's host enqueue time and the input path's host time per batch;
9. full-state checkpoints and ``fit(resume=True)`` (``RESUME_*``), each
   against its uninterrupted fit: GPT-2 124M pretraining as
   examples/04_gpt2_pretrain.py's full-size line sets it, depth cut to
   ``CUT_DEPTH`` blocks (fp32, adamw,
   wd 0.01, cosine restarts, 8 x 1024 tokens in 4 microbatches, K = 4;
   2 epochs of 4 steps: epoch 2 a replay), a new Trainer resuming from the first run's
   checkpoint_1 alone (epoch 2 through a fresh capture); ``dp_train``'s
   configuration in bf16 (2 replicas, K4/K5; 2 epochs of 4 steps) with
   ``save_every_steps=2`` preempted at step 7 (``preempt`` fault) and
   resumed from its emergency checkpoint, consuming ``PREEMPTED.json``;
   ResNet-18 (batch 256, 2 epochs of 3 steps) preempted at step 5 and
   resumed.  Gates: every parameter, buffer, optimizer-state leaf and
   counter, the step and every history list bitwise the uninterrupted
   run's; exact launch counts in every run; one checkpoint of the GPT-2
   state saved and loaded back leaves it bitwise.  Printed: checkpoint
   bytes, the host snapshot's seconds, the writer's, the verification's
   and the restore's.  Every fit of the other phases must end
   unpreempted (``fit_whole``);
10. the data layer and the chunked LM loss (``DATA_*``): the C++ batch
   worker built with ``g++`` from ``csrc/`` into ``build/native/`` (its
   seconds; a missing compiler or a failed build fails the phase), its
   pass on 224 x 224 images with pad 0 and no flip within
   NATIVE_PLAIN_ATOL of the Python Loader's ``ToFloat + Normalize``, two
   iterations of one epoch bitwise and a new epoch different; ResNet-50
   (224, batch 64, fp32, K = 4, 3 epochs of 8 steps) through ``fit()``
   with ``loader="python"`` and then ``loader="native"`` (asked for
   explicitly, never taken by default), on seeded uint8 images in memory
   and as raw shards written by ``write_sharded_dataset``: samples/s of
   the second epoch, each loader's host ms a batch timed alone, and
   device-busy ms a step and idle share of the third epoch under the
   profiler; GPT-2 124M's widths at ``CUT_DEPTH`` blocks in bf16
   (``TRAIN``'s batch, ``GPT2_OPT``, K = 4) on ``PackedLMDataset`` blocks of the fixture byte-level BPE's
   encoding of synthetic text (``examples/04_gpt2_pretrain.py``'s
   recipe) with ``loss_chunk=128`` against the dense head: in float32
   the chunked loss function at [8, 1024, 768] x [50257, 768] and one
   microbatch of the model (loss within CHUNK_LOSS_RTOL, every gradient
   within CHUNK_GRAD_RTOL of its largest entry), in bf16 one microbatch
   through the trainer's loss function (losses within CHUNK_LOSS_RTOL;
   the chunked gradients no farther from the float32 dense ones than
   BF16_NOISE_FACTOR times the bf16 dense gradients, or BF16_GRAD_RTOL),
   then ``fit()`` with loss_chunk at K = 4 and K = 1 (state bitwise,
   losses within GRAPH_LOSS_RTOL) and the dense head at K = 4, exact
   K1-K3 launches in each, peak memory of each fit, ms a step of both
   graphs by CUDA events (dense, chunked, chunked, dense); BERT-base bf16
   (right_padded, 32 x 128, K = 4, 8 steps) on the fixture WordPiece's
   encoding of synthetic sentences (``TokenizedDataset.from_texts``):
   exact launches and ms a step.  The JPEG shard path runs in the dist
   phase, on the shards committed in ``tests/fixtures/jpeg224``.
11. llama (``LLAMA``): ``llama`` at full width (124,668,672 parameters,
   12 query heads over 4 kv heads) on ``SyntheticTokens`` of 2048 x
   32000, batch 4, 8 steps, through ``fit()`` at K = 1 and K = 4 (one
   graph replay a chunk) in float32 with the dense head and in bf16 with
   ``loss_chunk=256``: K = 4 bitwise K = 1, exact K1-K3 launches (12 a
   forward and 12 a backward, replays counted), finite losses, the
   graph's ms a step and tokens/s, each fit's peak memory, and in bf16
   one step under the per-call check; the bf16 chunked fit on 2 sharded
   replicas, 4 steps (K4/K5 exact, the K4/K5 tail against the plain one
   from one state); ``generate()`` in float32 and bf16, [4, 128] prompts
   (K1 prefills), 32 greedy tokens through the kernels and the plain path
   (``attention_impl="xla"``: prefill logits within the bar, tokens equal
   up to a near-tie of the plain logits), the cache at [4, 4, L, 64] and
   its bytes, a seeded sampled run twice; then one bf16 fit each of
   ``gpt2_medium`` and ``gpt2_large`` at [4, 1024], 8 blocks deep
   (exact launches, ms a step).  The kernel checks hold K1-K3 at ``llama_2048`` [4, 12, 2048,
   64] causal in both dtypes beside SDPA.
12. cli (``CLI_*``): ``python -m ml_trainer_tpu_torch`` with
   ``CLI_ARGV`` (GPT-2 124M bf16 at [8, 1024], ``--remat --remat_policy
   dots --ema_decay 0.999 --steps_per_execution 4``, adamw, clip 1.0) for
   1 epoch in a subprocess beside the same for 2 epochs through
   ``cli.main`` in this process (K1-K3 launches exact), then the first
   continued with ``--resume --epochs 2``: each exits 0, the resumed
   checkpoint_2 (params, ``ema_params``, optimizer state, step,
   counters) and history bitwise the uninterrupted run's; while the
   subprocesses run: one dropout site's mask on the card bitwise the
   CPU's and its kept share within 4 sigma of 0.9; Llama 124.7M bf16
   ``loss_chunk=256`` with 'dots' at K = 1 and 4, bitwise; dropout 0.1
   at K = 1 and K = 4 bitwise for GPT-2 124M's widths at ``CUT_DEPTH``
   blocks (so the GPT-2 runs below) in bf16 with the EMA,
   BERT-base bf16 (the SST-2 recipe) and ViT-B/16 bf16 with the EMA
   (one epoch each, ``_train_one_epoch``); BERT ``test()`` bitwise the
   same weights without dropout and ``predict()`` bitwise the test
   path's softmax; the EMA after a step within 8 float32 ulps of its
   float64 recompute, kept on a ViT step with a NaN batch; dropout and
   the EMA on 2 sharded replicas against one card (``dp_step_check``)
   and one sharded step with K4 = K5 = 2; then, alone on the card,
   GPT-2 124M bf16 in ``CLI_VARIANTS`` (plain, remat 'none' and 'dots',
   dropout 0.1, the EMA) from one seeded init: one step's gradients,
   remat bitwise plain and dropout under 'dots' bitwise dropout alone,
   K1 2 x depth a microbatch under remat (K2/K3 depth), the step's
   peak, then
   each variant's K = 4 graph in turns (ms a step: remat's, the masks'
   and the EMA's cost); ``gpt2_large`` bf16 [4, 1024] at K = 1 with
   remat off and 'none' (the step's peak, ms a step).
13. lora (``LORA_*``): GPT-2 124M with a rank-8 adapter on qkv/proj
   (alpha 16) over the frozen seeded base, the training phase's shape
   ([8, 1024] in 4 microbatches, adamw, clip 1.0; 8 steps): fp32 at
   K = 1, bf16 at K = 1 and 4 (the K = 4 state bitwise K = 1's); each
   fit's K1-K3 launches exact, K4/K5/K7 none, the base bitwise the
   seeded weights, every adapter leaf moved; ``export_lora`` (the meta's
   base fingerprint the base's); a LoRA step against a full fine-tune
   at the same shape in fp32 and bf16 (an eager step's peak over what
   the trainer holds, ms a step of the K = 4 graph in turns); then a
   paged server (8 slots, ``paged_kernel``) with a pool of 4 rank-16
   slots over qkv/proj/fc_in/fc_out serving six prompts of 130-300
   tokens (K1 in every prefill), two with no adapter, two with the
   trained one, two with a second of rank 16 on all four projections,
   16 tokens each, in fp32 and bf16, through three engines (adapters
   with the decode graph, none with the graph, adapters eagerly):
   the base rows' logits bitwise the adapter-free engine's at every
   decode step, the graph's bitwise the eager engine's, the adapter rows
   against ``generate()`` of their train-mode models (fp32: greedy
   tokens equal, or a near-tie within LOGIT_SLACK; bf16: logits within
   3e-2 of the largest), K1/K6 launches exact; a third adapter hot-loaded
   after the capture, served with no second capture, bitwise the eager
   engine; the decode step's replay ms with and without adapters in
   turns, one hot-load's prepare and upload ms; ``export_torch`` of an
   MLModel trained on the card with an EMA bitwise the CPU's export of
   the same state, with and without ``ddp_prefix``.
14. examples (``EX_*``): the notebook flows of ``examples/torch_port/``
   as a user runs them, each script's ``main()`` through ``runpy`` in
   this process (its launches counted): 01 at its defaults (MLModel, 6
   epochs of 2048 synthetic images; wall, samples/s, history, test
   metrics), then 03 on 01's directory and on the same trainer's
   ``export_torch`` file (the loaded weights bitwise the trained ones,
   leaf for leaf; loss and accuracy within EX_METRIC_ATOL of
   ``trainer.test`` of the in-memory model); 02 at its defaults
   (ResNet-18 b 256, 2 epochs of 4096, 2 replicas on the card); 04 at
   BASELINE config 5's widths (EX_04: GPT-2 124M [8, 1024] in 4
   microbatches, remat, K = 4, 8 steps), then ``RESUME=1 EPOCHS=2``,
   each with its sampled continuation (K1-K3 exact: K1 twice a
   microbatch under remat); 05 at EX_05 (BERT-base [32, 128],
   right-padded: K1-K3's kv_lens path, exact); then GPT-2 124M bf16 at
   TRAIN's shape under adamw, lamb, lion and adafactor at K = 4: one
   replay of the captured chunk bitwise 4 eager steps from one state
   (every parameter and state leaf), the replay's ms a step (CUDA
   events), the optimizer state's bytes, exact launches.
15. dist (``DIST_*``): one process per replica over ``torch.distributed``,
   each process started by this one (``--dist-worker``), while this
   process runs the one-process references.  (a) GPT-2 124M fp32,
   ``dp_update="sharded"``, 4 steps at K = 1 in an NCCL group of one
   process: every state leaf bitwise the same fit with no process group
   (sha1 of each leaf), K1-K5 exact (K4/K5 one a step); the same at
   K = 4 with the fused step, 8 steps (the group's all-reduces captured
   in the CUDA graph and replayed).  (b) Two gloo
   processes sharing cuda:0, GPT-2 124M bf16 at [8, 1024] global, the
   sharded step, clip 1.0, 4 steps: each rank's parameters and its
   blocks of the moments bitwise the one-process 2-replica fit on the
   same global batches (a two-term sum commutes); the format-3
   checkpoint the ranks write at the epoch's end, resumed by two fresh
   trainers bitwise, and restored into one process of two replicas
   bitwise the stitched arrays and that fit's state; each rank's peak
   memory and optimizer-state bytes beside the one-process run's.  (c)
   The two gloo processes, ResNet-50 224 on the committed JPEG shards
   (64 images: 2 epochs of 2 steps at global batch 32, SGD momentum 0.9
   at lr 1e-3: DIST_RESNET_OPT), each rank's 16
   rows a step through the native loader, ``dp_update="fused"`` with the
   BatchNorm statistics synced (flax's E[x^2] - E[x]^2): parameters and
   BatchNorm buffers (||diff|| / ||reference|| over all parameters, and
   over all buffers) against the one-process fit of two replicas on the
   ranks' batches joined, in the same arithmetic, within
   DIST_BN_FLOOR_FACTOR times that fit's distance from itself with the
   ranks' rows swapped (the reorder floor), and the distance to the
   port's one-process fit (cuDNN's statistics) beside it, while
   per-replica statistics in flax's arithmetic must land beyond that bar
   on both norms; the ranks bitwise each other; every image's decode here bitwise the CPU decode's digest in the fixture,
   the native loader's pixels bitwise that decode; the JPEG loader's
   host ms a batch of 64 and of 16.  (d) The planted desync: rank 1
   scales its largest leaf by DIST_PLANT; ``check_desync`` raises on
   rank 1 naming the step and not on rank 0.  Two NCCL ranks on
   distinct cards need a machine with several and are not run.
16. decode (``DECODE_*``, run right after serving): GPT-2 124M fp32
   behind ``Server(max_batch=8)``, eight prompts of 130-300 tokens whose
   tails repeat a 24-token span, 48 greedy tokens each, through
   ``spec_k=4`` (contiguous, then ``kv_page_size=16``) and ``spec_k=0``
   with its decode graph: the spec tokens equal the vanilla ones or part
   first where the vanilla sequence's top-2 margin (teacher forced,
   plain attention) is within LOGIT_SLACK (parted rows counted), K1
   exactly 12 a prefill, acceptance, tokens per verify step, the verify
   step's ms and tokens/s beside the vanilla run's; a sampled spec pass
   twice (equal); bf16 spec against the bf16 vanilla engine (the same
   rule at 3e-2 of the largest logit, every served token within it of
   the best).  ``gpt2_mini`` with its registered draft ``gpt2_nano``
   through ``speculative_generate`` and ``Server(drafter=...)`` against
   ``generate()`` (the same rule).  Chunked prefill: a 900-token prompt
   (4 windows of ``prefill_chunk=256``) queued ahead of three of at most
   64 tokens on a paged ``paged_kernel`` server, with the decode graph:
   tokens against the unchunked engine's (the rule), the short requests'
   first tokens before the long one's (after it unchunked), K6 exactly
   12 a decode step, the windows and TTFTs; the chunked run once more
   eagerly.  ``generate()`` at [2, 128], 32 tokens: ``top_k=1`` and a
   tight ``top_p`` equal to greedy, a top-k/top-p sampled run twice
   (equal), ``beam_search`` (4 beams scoring at least greedy's sequence,
   1 beam greedy's tokens under the rule), ``generate_ragged`` on three
   lengths equal to ``generate`` per length; K1 exact.  Every eager K1
   and K6 call of the sampled, bf16, draft-model, eager chunked and
   ``generate()`` runs is held at once to the float64 JAX function on
   its own inputs (float32 within 1e-4, bf16 within 2 ulps).
17. front (``FRONT_*``, run after decode): GPT-2 124M fp32 behind
   ``Server(max_batch=8, kv_page_size=16, paged_kernel=True)`` with the
   prefix cache and its HTTP front end on 127.0.0.1:0, tenant a at
   weight 3 and tenant b at weight 1 with ``max_active=4``, under a
   stated ``SloPolicy``.  After an uncounted warm-up pass, four counted
   passes of 16 fresh prompts of 130-300 tokens and 32 greedy tokens:
   over HTTP (16 client threads of a process of their own POST
   ``/v1/generate``), the same at a 0.5 ms GIL switch interval,
   in-process, and in-process with ``/metrics`` scraped at 10 Hz by
   another process: K1 exactly 12 a prefill, K6 12 a decode step; the HTTP tokens against the same server's in-process
   ``complete()`` of the same prompts (the near-tie rule), every eager
   K1 and K6 call of the warm-up and of that check held to the float64
   JAX function; of the first (HTTP) pass's admissions made while
   both tenants had queued requests, a takes 0.65-0.85 (its weight's
   0.75; a FIFO's 0.5 and a starved b's 1.0 fail).  ``/metrics`` parses as
   Prometheus text with TTFT and TPOT buckets for each tenant,
   ``/metrics.json`` has the JAX snapshot's keys, ``/slo`` each
   tenant's attainment, ``/healthz`` 200, an unknown path 404, a
   malformed body 400.  The ladder: rung 1 clamps a fresh request and
   spares the running one, rung 2 mid-stream on a ``spec_k=4`` server
   keeps the vanilla tokens, rung 3 answers a prefix miss 503 with
   Retry-After and serves a hit, rung 4 sheds the queued priority-0
   request and keeps the priority-1 and the running ones.  The wedge:
   ``Server(watchdog_timeout=2.0, max_queue=2)`` answers a full queue
   429, then under ``decode_wedge@step=N,secs=60`` the HTTP client gets
   503 "wedged" within 2.0 s + a poll + 2 s, ``/healthz`` 503, a new POST
   503, one trip; after the release and ``close()`` the card's allocated
   memory is back within 1% and a fresh ``Server`` serves the prompt
   with the same tokens.  Printed: tokens/s over HTTP and in-process,
   TTFT/TPOT/queue wait/e2e per tenant, the HTTP overhead a request, the
   decode step ms scraped and not, the watchdog's detection seconds and
   the capture seconds it sees.
18. router (``ROUTER``, run after front): GPT-2 124M fp32 (12 blocks,
   768 wide, seeded), paged at page 16, max_len 1024, 8 slots a replica,
   ``paged_kernel``; 16 prompts of 130-300 tokens (the even ones open
   with one 128-token system prompt), 32 greedy tokens each.  A single
   ``Server``'s tokens are the reference.  ``Router.build(["prefill",
   "decode", "decode"])``: an uncounted warm-up (its eager K1 and K6
   calls held to float64), a counted pass (every request migrates once;
   tokens against the reference by the near-tie rule), then the same
   traffic with ``decode1`` held before a decode step, killed and
   released (redistributions counted; tokens against the first pass).
   ``["both"] * 3`` on the same traffic: no migration, tokens against
   the disaggregated pass.  Two worker processes on the card
   (``Fleet(["prefill", "decode"])``, started at the phase's start from
   a ``--ckpt`` written here) behind ``make_router()``: a warm-up whose
   first payload has one bit flipped (``migration_corrupt``: the decode
   worker's CRC check refuses it), then 8 of the prompts counted through
   each worker's ``/v1/spec``.  Gates: K1 12 a full prefill (a prefix hit
   runs the plain paged path) and K6 12 a decode step, exactly, in every
   counted pass and worker; one decode-graph capture per decoding engine
   whatever was imported; the card's allocated memory back within 1%.
   Printed: tokens/s and TTFT p50 of each layout, the bytes of a
   migration (``router_kv_migrated_bytes_total``; the padded payload is
   the same whatever the prompt), export, adopt and import ms in process
   and adopt ms over HTTP, the phase's seconds.
19. deploy (``DEPLOY``, run after router): GPT-2 124M fp32 from seeds 0
   and 1, each written by ``Trainer.save_model`` (``model.pth`` and
   ``model_manifest.json``), served at page 16, max_len 1024, 8 slots a
   replica, ``paged_kernel``; 8 prompts of 130-300 tokens and an
   open-loop ``poisson_schedule`` of 16 more (two tenants), 32 greedy
   tokens each; one ``Server`` on each seed gives the reference tokens.
   On ``Router.build(["both", "both"])`` over seed 0 (an uncounted
   warm-up, its eager K1 and K6 calls held to float64), counted
   together: (b) ``Router.deploy`` of seed 1 with its ``submit_request``
   wedged 3 s: rolled back at the first poll that sees the canary's
   burn, no stream dropped, stable tenants on seed 0's tokens; (c) a
   shadow deploy rolled back on the token diff with the split never
   raised; (d) ``rep1`` killed and the ``Autoscaler``'s next tick a
   ``scale_up``, tokens unchanged; (a) with (e) the seed-1 deploy
   (canary 0.25, stages 0.5 and 1.0) under ``run_open_loop`` traffic:
   the canary tenant on seed 1's tokens, the other on seed 0's, then
   ``done``, the old generation retired, ``weights_fp`` the manifest's,
   every tenant on seed 1's tokens.  (f) A one-worker ``Fleet`` (its
   process started at the phase's start from the seed-0 ``--ckpt``)
   deployed through ``Fleet.deploy_factory`` onto the seed-1 checkpoint
   (stages (1.0,)): the new worker's tokens are seed 1's, counted
   through its ``/v1/spec``.  Gates: K1 12 a full prefill of 128 tokens
   or more and K6 12 a decode step, exactly, on every engine and the
   new worker; one decode-graph capture per decoding engine; tokens by
   the near-tie rule; the card's allocated memory back within 1%.
   Printed: the staging seconds (spawn, warm-up and capture), the
   seconds from the burn crossing to the split's teardown, the
   rollback's drain seconds, the open-loop report (TTFT p50/p99,
   attainment and tokens/s by generation), the phase's seconds.

The counters are set to 0 just before each serving run and each training
run and read just after each; a kernel's ``launches`` in the JSON record
is the sum over the runs.  The second-to-last line is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero and prints no ok line.  Exits non-zero at once
without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12    # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
TOL = 1e-4
BWD_ATOL, BWD_RTOL = 2e-4, 1e-4  # K2/K3 vs the plain backward (float32)
LOGIT_SLACK = 1e-3
INT8_REL = 1e-5       # K7 vs plain: of max|plain output| (f32 sums reordered)
INT8_LOGIT_REL = 0.02  # int8 vs fp32 logits, and argmax agreement: the
INT8_AGREEMENT = 0.995  # JAX package's gate (tests/test_kernels.py)
L2_BYTES = 50e6       # H100 L2; K7 timings cycle weights through 2x this
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# Seeded weights by (config, seed, kwargs): a model's draw on the host
# generator takes ~0.8 s for GPT-2 124M, and the phases build the same
# seeded models many times.
_SEEDED: dict = {}


def _seeded_model(config, seed: int, device, **kwargs):
    """``mt.init_model(config, seed, device, **kwargs)``: drawn once, then
    the same weights (bitwise) copied into each new model."""
    import ml_trainer_tpu_torch as mt

    key = (config, seed, tuple(sorted((k, repr(v))
                                      for k, v in kwargs.items())))
    state = _SEEDED.get(key)
    if state is None:
        model = mt.init_model(config, seed=seed, device=device, **kwargs)
        _SEEDED[key] = {k: v.detach().to("cpu", copy=True)
                        for k, v in model.state_dict().items()}
        return model
    model = mt.get_model(config, device=device, **kwargs)
    model.load_state_dict(state)
    return model


_DISCARDS = []  # the threads removing discarded directories


def _discard(path: str) -> None:
    """Remove a run's directory off the critical path: renamed at once
    (the path is free for the next run), deleted by a background thread;
    ``_discards_done`` joins them before the script ends."""
    import threading

    if not os.path.exists(path):
        return
    trash = f"{path}.discard{len(_DISCARDS)}"
    os.rename(path, trash)
    worker = threading.Thread(target=shutil.rmtree, args=(trash, True))
    worker.start()
    _DISCARDS.append(worker)


def _discards_done() -> None:
    for worker in _DISCARDS:
        worker.join()


def fit_whole(trainer, what: str) -> None:
    """``trainer.fit()``, which must end with every epoch trained: a
    SIGTERM handled as a preemption must not pass for a finished run."""
    trainer.fit()
    if trainer.preempted:
        raise AssertionError(f"{what}: fit() ended preempted")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phase 3
# BERT-base fine-tuning's attention: batch 32 at sequence 128, d 64, the
# rows' valid lengths ragged in 8..128 (seeded; right padding).
BERT_LENS = [128, 8, 124, 42, 21, 80, 88, 102, 85, 94, 118, 118, 120, 112,
             95, 119, 9, 11, 104, 60, 98, 66, 117, 15, 89, 8, 25, 108, 43,
             126, 50, 102]
# Llama's training launch: batch 4 at its max_len 2048, 12 query heads
# (the 4 kv heads repeated to 12 before the call), d 64.
LLAMA_CASE = ("llama_2048", 4, 12, 2048, 64, True, None)
FWD_CASES = [  # (name, b, h, s, d, causal, kv_lens); the first is the main
    ("main", 2, 12, 1024, 64, True, None),  # one training microbatch
    ("serve_128", 1, 12, 128, 64, True, None),  # serving prefill buckets
    ("serve_512", 1, 12, 512, 64, True, None),
    ("serve_1024", 1, 12, 1024, 64, True, None),
    ("serve_1024_kv700", 1, 12, 1024, 64, True, [700]),
    ("kv_lens", 8, 12, 1024, 64, False,
     [1024, 700, 1, 513, 64, 1000, 257, 900]),
    ("d128", 2, 8, 1024, 128, True, None),
    ("bh_over_65535", 5467, 12, 64, 64, True, None),  # B*H = 65,604
    ("bert", 32, 12, 128, 64, False, BERT_LENS),
    LLAMA_CASE,
]
# Rows with a bitwise two-call check and profiler device times (K1 and
# SDPA's fp32 forward): at ~0.1 ms an eager loop is host-bound.
FWD_PROFILED = ("main", "serve_1024", "bert", "llama_2048")
# K1's kernel names (float32, bf16), as the profiler lists them.
FWD_MARKS = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_bf16_kernel")}


def fwd_bounds(b, h, s, d, causal, lens, bf16: bool = False) -> dict:
    """K1's bounds: ``bound_ms``/``bound_by`` with its two length-d
    products per kept pair at the 3xTF32 tensor-core rate,
    ``bound_fp32_core_ms`` at the fp32 CUDA-core rate.  q read once,
    k and v once over their live rows, out and lse written once.  With
    ``bf16``: q, k, v and out at 2 bytes a value (lse 4) and the
    products at the bf16 dense rate."""
    flops = 2 * 2.0 * d * kept_pairs(b, s, causal, lens) * h
    size = 2 if bf16 else 4
    nbytes = (2 * b * s + 2 * live_rows(b, s, lens)) * h * d * size \
        + b * h * s * 4
    if bf16:
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        return dict(bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOPS_PER_S / 3)
    return dict(bound_ms=b_ms, bound_by=b_by,
                bound_fp32_core_ms=bound_ms(nbytes, flops)[0])


def check_flash(dev):
    """K1 against its plain version (out and lse within ``TOL``) on every
    ``FWD_CASES`` row, timed beside the plain version and SDPA's fp32
    forward (none at ``bh_over_65535``, whose point is the grid)."""
    import torch
    import torch.nn.functional as F

    from ml_trainer_tpu_torch.ops.attention import (
        flash_attention, flash_attention_reference)

    rows = []
    for i, (name, b, h, s, d, causal, lens) in enumerate(FWD_CASES):
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + i)
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   for _ in range(3))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        out, lse = flash_attention(q, k, v, kv, causal)
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv, causal)
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        del ref_out, ref_lse
        if not err <= TOL:
            raise AssertionError(
                f"flash_fwd {name}: max abs err {err} > {TOL}")
        extra = {}
        if name in FWD_PROFILED:  # no atomics: a second call repeats it
            again = flash_attention(q, k, v, kv, causal)
            if not (torch.equal(out, again[0])
                    and torch.equal(lse, again[1])):
                raise AssertionError(f"flash_fwd {name}: two calls differ")
            del again
            extra["bitwise_repeat"] = True
        big = b * h > 65535
        ms = time_ms(lambda: flash_attention(q, k, v, kv, causal),
                     iters=10 if big else 50)
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, kv, causal), iters=10 if big else 50)
        if kv is None:
            def lib_fn():
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
        else:
            keep = (torch.arange(s, device=dev)[None, :]
                    < kv.long()[:, None])[:, None, None, :]
            if causal:
                keep = keep & torch.ones(s, s, dtype=torch.bool,
                                         device=dev).tril()
            def lib_fn():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=keep)
        lib = None if big else time_ms(lib_fn)
        if name in FWD_PROFILED:
            extra.update(
                device_ms=profiled_ms(
                    lambda: flash_attention(q, k, v, kv, causal),
                    FWD_MARKS["flash_fwd"]),
                library_device_ms=profiled_ms(lib_fn, ("",)))
        row = dict(case=name, shape=[b, h, s, d], causal=causal,
                   kv_lens=lens, max_abs_err=err, ms=ms, plain_ms=plain,
                   library_ms=lib, **fwd_bounds(b, h, s, d, causal, lens),
                   **extra)
        log("kernel flash_fwd " + json.dumps(row))
        rows.append(row)
        del q, k, v, kv, out, lse
        torch.cuda.empty_cache()
    return rows


def bwd_case(dev, b, h, s, d, lens, seed):
    """q, k, v, kv_lens (or None) and the output cotangent, seeded."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, s, d, generator=gen).to(dev)
                     for _ in range(4))
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    return q, k, v, kv, dout


def live_rows(b: int, s: int, lens) -> int:
    """Key rows below ``kv_lens`` summed over the batch: the rows of k
    and v that the kernels read."""
    return sum(min(s, n) for n in (lens or [s] * b))


def kept_pairs(b: int, s: int, causal: bool, lens) -> int:
    """Kept (query, key) pairs summed over the batch, per head."""
    total = 0
    for n in (lens or [s] * b):
        live = min(s, n)
        total += (sum(min(i + 1, live) for i in range(s)) if causal
                  else s * live)
    return total


BWD_CASES = [  # (name, b, h, s, d, causal, kv_lens); the first is the main
    ("main", 2, 12, 1024, 64, True, None),  # one training microbatch
    ("b8", 8, 12, 1024, 64, True, None),
    ("kv_lens", 8, 12, 1024, 64, False,
     [1024, 700, 1, 513, 64, 1000, 257, 900]),
    ("d128", 2, 8, 1024, 128, True, None),
    ("bert", 32, 12, 128, 64, False, BERT_LENS),
    LLAMA_CASE,
]
# Rows with a bitwise two-call check and profiler device times.
BWD_PROFILED = ("main", "bert", "llama_2048")
PADDED_CASE = (2, 4, 1000, 48)  # off-tile S and head_dim
# K2's and K3's kernel names, as the profiler lists them.
BWD_MARKS = {"flash_bwd_dq": ("flash_bwd_dq_kernel",
                              "flash_bwd_dq_bf16_kernel"),
             "flash_bwd_dkv": ("flash_bwd_dkv_kernel",
                               "flash_bwd_dkv_bf16_kernel")}
ATTN_MARKS = dict(FWD_MARKS, **BWD_MARKS)  # K1-K3 in a profiled step


def bwd_bounds(b, h, s, d, causal, lens, bf16: bool = False) -> dict:
    """K2's and K3's bounds: ``bound_ms``/``bound_by`` with the products
    at the 3xTF32 tensor-core rate (three TF32 products per fp32-accurate
    product), ``bound_fp32_core_ms`` at the fp32 CUDA-core rate.  Each
    input read once (k and v over their live rows), each output written
    once (dK and dV in full: zeros past ``kv_lens``); 3 (K2) or 4 (K3)
    length-d products per kept pair.  With ``bf16``: q, k, v, dO and
    the gradients at 2 bytes a value (lse and delta 4) and the products
    at the bf16 dense rate."""
    pairs = kept_pairs(b, s, causal, lens) * h
    size = 2 if bf16 else 4
    arr = b * h * s * d * size
    kv = 2 * live_rows(b, s, lens) * h * d * size
    rows_b = b * h * s * 4
    out = {}
    for kname, nbytes, prods in (
            ("flash_bwd_dq", 2 * arr + kv + 2 * rows_b + arr, 3),
            ("flash_bwd_dkv", 2 * arr + kv + 2 * rows_b + 2 * arr, 4)):
        flops = prods * 2.0 * d * pairs
        if bf16:
            b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
            out[kname] = dict(bound_ms=b_ms, bound_by=b_by)
            continue
        b_ms, b_by = bound_ms(nbytes, flops, TF32_FLOPS_PER_S / 3)
        out[kname] = dict(bound_ms=b_ms, bound_by=b_by,
                          bound_fp32_core_ms=bound_ms(nbytes, flops)[0])
    return out


def attn_step_bounds(launches: int, bf16: bool = False) -> dict:
    """K1's, K2's and K3's bounds (3xTF32, or bf16) for a training step's
    ``launches`` launches of each at the main rows' shape (one microbatch
    of 2 x 1024)."""
    _, b, h, s, d, causal, lens = BWD_CASES[0]
    bounds = dict(bwd_bounds(b, h, s, d, causal, lens, bf16),
                  flash_fwd=fwd_bounds(*FWD_CASES[0][1:], bf16=bf16))
    return {k: launches * v["bound_ms"] for k, v in bounds.items()}


def _averages(prof):
    """``prof.key_averages()``, computed once a profile: it walks every
    event, and ``device_split`` and ``kernel_device_ms`` read the same
    window.  The profiles record the device's activity only: both read
    device events alone, and the host's op events took most of the
    parse's time (and slowed the host inside the window)."""
    avg = getattr(prof, "_smoke_averages", None)
    if avg is None:
        avg = prof._smoke_averages = prof.key_averages()
    return avg


def kernel_device_ms(prof, marks: dict) -> dict:
    """Device ms and calls in a profiled window per kernel, by name:
    ``marks`` maps a kernel to substrings of its device events' names."""
    from torch.autograd import DeviceType

    ms = {k: 0.0 for k in marks}
    calls = {k: 0 for k in marks}
    for evt in _averages(prof):
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        for kname, subs in marks.items():
            if any(m in evt.key for m in subs):
                ms[kname] += us / 1e3
                calls[kname] += evt.count
    return {"device_ms": ms, "device_calls": calls}


def profiled_ms(fn, marks, iters: int = 20):
    """Device ms per call of ``fn`` from profiler events whose names hold
    one of ``marks`` (``("",)`` takes every device event: a library
    call's several kernels).  A window in which the profiler recorded no
    such event (seen once for SDPA's bf16 forward on an H100) is taken
    again; None if the second shows none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rec = kernel_device_ms(prof, {"k": marks})
        if rec["device_calls"]["k"]:
            return rec["device_ms"]["k"] / iters
    return None


def check_flash_bwd(dev):
    """K2 (dQ) and K3 (dK/dV) against the plain backward on the same
    inputs (out and lse from the plain forward), then the padded path's
    gradients through ``attention(implementation="flash")`` against
    autograd of the plain attention path."""
    import torch
    import torch.nn.functional as F

    from ml_trainer_tpu_torch.ops.attention import (
        attention, flash_attention_backward_reference,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)

    rows = []
    for i, (name, b, h, s, d, causal, lens) in enumerate(BWD_CASES):
        q, k, v, kv, dout = bwd_case(dev, b, h, s, d, lens, SEED + 10 + i)
        scale = d ** -0.5
        out, lse = flash_attention_reference(q, k, v, kv, causal, scale)
        delta = (dout * out).sum(-1).contiguous()
        args = (q, k, v, kv, lse, delta, dout, causal, scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        want = flash_attention_backward_reference(q, k, v, kv, out, lse,
                                                  dout, causal, scale)
        torch.cuda.synchronize()
        errs = {}
        for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            errs[nm] = (got - ref).abs().max().item()
            torch.testing.assert_close(got, ref, atol=BWD_ATOL, rtol=BWD_RTOL,
                                       msg=lambda m: f"{name} {nm}: {m}")
        if lens is not None:
            pad = (torch.arange(s, device=dev)[None, None, :, None]
                   >= kv.long()[:, None, None, None]).expand_as(dk)
            if not (bool((dk[pad] == 0).all()) and bool((dv[pad] == 0).all())):
                raise AssertionError(f"{name}: dK/dV past kv_lens not zero")
        main = name in BWD_PROFILED
        if main:  # no atomics: a second call repeats the first bit for bit
            again = (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
            for nm, a, b2 in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
                if not torch.equal(a, b2):
                    raise AssertionError(f"{name} {nm}: two calls differ")
            del again
        ms_dq = time_ms(lambda: flash_bwd_dq(*args))
        ms_dkv = time_ms(lambda: flash_bwd_dkv(*args))
        plain = time_ms(lambda: flash_attention_backward_reference(
            q, k, v, kv, out, lse, dout, causal, scale), iters=10)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        if kv is None:
            o_lib = F.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal)
        else:
            keep = (torch.arange(s, device=dev)[None, :]
                    < kv.long()[:, None])[:, None, None, :]
            o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)

        def lib_fn():
            return torch.autograd.grad(o_lib, (qg, kg, vg), dout,
                                       retain_graph=True)

        lib = time_ms(lib_fn, iters=10)
        extra = {kn: {} for kn in BWD_MARKS}
        if main:  # device times: at ~0.05 ms an eager loop is host-bound
            lib_dev = profiled_ms(lib_fn, ("",), iters=10)
            for kn, fn in (("flash_bwd_dq", lambda: flash_bwd_dq(*args)),
                           ("flash_bwd_dkv", lambda: flash_bwd_dkv(*args))):
                extra[kn] = dict(device_ms=profiled_ms(fn, BWD_MARKS[kn]),
                                 library_device_ms=lib_dev,
                                 bitwise_repeat=True)
        bounds = bwd_bounds(b, h, s, d, causal, lens)
        for kname, ms, err in (
                ("flash_bwd_dq", ms_dq, errs["dq"]),
                ("flash_bwd_dkv", ms_dkv, max(errs["dk"], errs["dv"]))):
            row = dict(case=name, shape=[b, h, s, d], causal=causal,
                       kv_lens=lens, max_abs_err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, **bounds[kname], **extra[kname])
            log(f"kernel {kname} " + json.dumps(row))
            rows.append((kname, row))
        del qg, kg, vg, o_lib, want, out, lse, args
        torch.cuda.empty_cache()

    # Off-tile S and head_dim through the padding wrapper, gradients
    # end to end (K1 forward, K2/K3 backward on the padded shapes).
    gen = torch.Generator(device="cpu").manual_seed(SEED + 20)
    q, k, v, dout = (torch.randn(*PADDED_CASE, generator=gen).to(dev)
                     for _ in range(4))
    grads = {}
    for impl in ("flash", "xla"):
        leaves = [t.requires_grad_(True) for t in (q.clone(), k.clone(),
                                                   v.clone())]
        o = attention(*leaves, causal=True, implementation=impl)
        grads[impl] = torch.autograd.grad(o, leaves, dout)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item()
              for a, b in zip(grads["flash"], grads["xla"]))
    for a, b in zip(grads["flash"], grads["xla"]):
        torch.testing.assert_close(a, b, atol=BWD_ATOL, rtol=BWD_RTOL)
    log("kernel flash_bwd padded " + json.dumps(
        dict(shape=list(PADDED_CASE), causal=True, max_abs_err=err)))
    return rows, err


# K1's bf16 entry point at every FWD_CASES row (the bf16 training
# launches of GPT-2 124M and BERT-base, the bf16 serving prefills, ...)
# and a ragged S.
BF16_CASES = FWD_CASES[:-1] + [("ragged", 2, 12, 1000, 64, True, None),
                               LLAMA_CASE]
# K1's bf16 rows whose inputs K2's and K3's bf16 rows of the same name
# reuse (seeds SEED + 40, 41); K1's other rows take SEED + 70 + i.
BF16_SHARED = ("main", "bert")
# K2's and K3's bf16 rows: the float32 rows' coverage (BWD_CASES) and a
# ragged S; ``bert`` and ``llama_2048`` last, as there.
BF16_BWD_CASES = BWD_CASES[:-2] + [("ragged", 2, 12, 1000, 64, True, None),
                                   *BWD_CASES[-2:]]
F32_KERNEL_SLACK = 1e-3  # of max|result|: bf16 K1-K3 vs the float32 kernels


def bf16_gate(got, want) -> float:
    """The bf16 gate as a ratio: max over elements of |got - want| /
    (2^-7 |want| + 1e-3 max|want|), at most 1 within 2 bf16 ulps of the
    plain value."""
    got, want = got.float(), want.float()
    bar = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
    return ((got - want).abs() / bar).max().item()


def bf16_ulps(got, want):
    """Element by element, how many bf16 steps (``torch.nextafter`` in
    bf16) lie between two bf16 tensors: 0 where equal (+0 and -0 too), 1
    a step apart."""
    import torch

    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(got) - ordered(want)).abs()


def f32_kernel_ulps(got, f32) -> int:
    """A bf16 kernel's result ``got`` (K1's O, K2's and K3's gradients)
    against the float32 kernel's result on the widened inputs, rounded to
    bf16: each element must be equal to it, one bf16 step from it, or
    within ``F32_KERNEL_SLACK`` x max|it| of it (the two designs round P
    and dS apart: hi + lo bf16 terms against 3xTF32).  Returns the
    largest distance in bf16 steps over the elements outside that
    absolute slack; raises past one step."""
    want = f32.to(got.dtype)
    far = ((got.float() - want.float()).abs()
           > F32_KERNEL_SLACK * want.float().abs().max())
    ulps = bf16_ulps(got, want)[far]
    worst = int(ulps.max().item()) if ulps.numel() else 0
    if worst > 1:
        raise AssertionError(f"{worst} bf16 steps from the float32 kernels")
    return worst


def _sdpa_bwd(q, k, v, kv, dout, causal):
    """SDPA's backward on the same inputs and mask, timed only: a function
    returning dQ, dK, dV."""
    import torch
    import torch.nn.functional as F

    keep = None
    if kv is not None:
        s = k.shape[2]
        keep = (torch.arange(s, device=q.device)[None, :]
                < kv.long()[:, None])[:, None, None, :]
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=keep, is_causal=causal and keep is None)
    return lambda: torch.autograd.grad(o_lib, (qg, kg, vg), dout,
                                       retain_graph=True)


def check_flash_bf16(dev):
    """K1's bf16 entry point (``BF16_CASES``) against its plain version on
    the same bf16 inputs (out within 2 bf16 ulps: the ``bf16_gate`` ratio
    <= 1; lse within ``TOL``), two calls bitwise, and within one bf16
    step of the float32 kernel's result on the widened values rounded to
    bf16 (``f32_kernel_ulps``); then K2's and K3's (``BF16_BWD_CASES``):
    dQ, dK, dV within the 2-ulp gate of the plain version, dK/dV exactly
    0 past kv_lens, two calls bitwise, and within one bf16 step of the
    float32 kernels' result rounded to bf16 (``f32_kernel_ulps``).  Timed
    by CUDA events and profiler device time beside the plain versions and
    SDPA with bf16 inputs (the same boolean mask; timed only; none at
    ``bh_over_65535``, whose point is the grid)."""
    import torch
    import torch.nn.functional as F

    from ml_trainer_tpu_torch.ops.attention import (
        _backward_plain, _row_delta, flash_attention,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)

    def timed(kname, fn, plain, lib, marks, iters=50):
        lib_ms = {} if lib is None else dict(
            library_ms=time_ms(lib, iters=10),
            library_device_ms=profiled_ms(lib, ("",), iters=10))
        return dict(ms=time_ms(fn, iters=iters),
                    device_ms=profiled_ms(fn, marks[kname]),
                    plain_ms=time_ms(plain, iters=10),
                    **{"library_ms": None, "library_device_ms": None,
                       **lib_ms})

    rows = []
    for i, (name, b, h, s, d, causal, lens) in enumerate(BF16_CASES):
        seed = SEED + (40 + BF16_SHARED.index(name) if name in BF16_SHARED
                       else 70 + i)
        q, k, v, kv, _ = bwd_case(dev, b, h, s, d, lens, seed)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out, lse = flash_attention(q, k, v, kv, causal)
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv, causal)
        out32, lse32 = flash_attention(q.float(), k.float(), v.float(), kv,
                                       causal)
        torch.cuda.synchronize()
        if not (out.dtype == torch.bfloat16 and lse.dtype == torch.float32):
            raise AssertionError(f"bf16 {name}: output dtypes "
                                 f"{out.dtype} {lse.dtype}")
        gate = bf16_gate(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        if not (gate <= 1.0 and lse_err <= TOL):
            raise AssertionError(f"bf16 flash_fwd {name}: {gate} of the "
                                 f"2-ulp bar, lse err {lse_err}")
        ulps = f32_kernel_ulps(out, out32)
        again = flash_attention(q, k, v, kv, causal)
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            raise AssertionError(f"bf16 flash_fwd {name}: two calls differ")
        del out32, lse32, again

        keep = None if kv is None else (
            torch.arange(s, device=dev)[None, :]
            < kv.long()[:, None])[:, None, None, :]

        def lib_fwd():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep, is_causal=causal and keep is None)

        big = b * h > 65535
        row = dict(case=name, dtype="bfloat16", shape=[b, h, s, d],
                   causal=causal, kv_lens=lens,
                   max_abs_err=max((out.float() - ref_out.float()).abs()
                                   .max().item(), lse_err),
                   gate_ratio=gate, ulps_from_f32_kernel=ulps,
                   bitwise_repeat=True,
                   **timed("flash_fwd",
                           lambda: flash_attention(q, k, v, kv, causal),
                           lambda: flash_attention_reference(q, k, v, kv,
                                                             causal),
                           None if big else lib_fwd, FWD_MARKS,
                           iters=10 if big else 50),
                   **fwd_bounds(b, h, s, d, causal, lens, bf16=True))
        log("kernel flash_fwd bf16 " + json.dumps(row))
        rows.append(("flash_fwd", row))
        del q, k, v, kv, out, lse, ref_out, ref_lse, keep
        torch.cuda.empty_cache()

    for i, (name, b, h, s, d, causal, lens) in enumerate(BF16_BWD_CASES):
        seed = SEED + (40 + BF16_SHARED.index(name) if name in BF16_SHARED
                       else 50 + i)
        q, k, v, kv, dout = bwd_case(dev, b, h, s, d, lens, seed)
        q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
        scale = d ** -0.5
        ref_out, ref_lse = flash_attention_reference(q, k, v, kv, causal)
        delta = _row_delta(ref_out, dout)
        args = (q, k, v, kv, ref_lse, delta, dout, causal, scale)
        grads = (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
        want = _backward_plain(*args)
        wide = (q.float(), k.float(), v.float(), kv, ref_lse, delta,
                dout.float(), causal, scale)
        grads32 = (flash_bwd_dq(*wide),) + flash_bwd_dkv(*wide)
        torch.cuda.synchronize()
        if not all(g.dtype == torch.bfloat16 for g in grads):
            raise AssertionError(f"bf16 {name}: gradient dtypes "
                                 f"{[g.dtype for g in grads]}")
        gates = [bf16_gate(g, w) for g, w in zip(grads, want)]
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(grads, want)]
        ulps = [f32_kernel_ulps(g, g32) for g, g32 in zip(grads, grads32)]
        for nm, ratio in zip(("dq", "dk", "dv"), gates):
            if not ratio <= 1.0:
                raise AssertionError(f"bf16 {name} {nm}: {ratio} of the "
                                     "2-ulp bar")
        if lens is not None:
            pad = (torch.arange(s, device=dev)[None, None, :, None]
                   >= kv.long()[:, None, None, None]).expand_as(grads[1])
            if not (bool((grads[1][pad] == 0).all())
                    and bool((grads[2][pad] == 0).all())):
                raise AssertionError(f"bf16 {name}: dK/dV past kv_lens "
                                     "not zero")
        again = (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
        if not all(torch.equal(a, b2) for a, b2 in zip(again, grads)):
            raise AssertionError(f"bf16 {name}: two calls differ")
        del grads32, again, wide
        lib = _sdpa_bwd(q, k, v, kv, dout, causal)
        bounds = bwd_bounds(b, h, s, d, causal, lens, bf16=True)
        for kname, fn, sl in (
                ("flash_bwd_dq", lambda: flash_bwd_dq(*args), slice(0, 1)),
                ("flash_bwd_dkv", lambda: flash_bwd_dkv(*args),
                 slice(1, 3))):
            row = dict(case=name, dtype="bfloat16", shape=[b, h, s, d],
                       causal=causal, kv_lens=lens,
                       max_abs_err=max(errs[sl]), gate_ratio=max(gates[sl]),
                       ulps_from_f32_kernel=max(ulps[sl]),
                       bitwise_repeat=True,
                       **timed(kname, fn, lambda: _backward_plain(*args),
                               lib, BWD_MARKS),
                       **bounds[kname])
            log(f"kernel {kname} bf16 " + json.dumps(row))
            rows.append((kname, row))
        del q, k, v, kv, dout, ref_out, ref_lse, grads, want, args, lib
        torch.cuda.empty_cache()
    return rows


# K6 rows: (name, B, H, D, page, pages per row, lengths, trash rows); the
# first is the main row (the decode batch of the serving run's shape, one
# row at the full 1024 positions); pools hold B * pages + 1 pages.
PAGED_MIXED = [1, 16, 17, 1024, 300, 777, 64, 1]
PAGED_CASES = [
    ("main", 8, 12, 64, 16, 64, PAGED_MIXED, (7,)),
    ("b1_1024", 1, 12, 64, 16, 64, [1024], ()),
    ("b8_full", 8, 12, 64, 16, 64, [1024] * 8, ()),
    ("d128", 8, 8, 128, 16, 64, PAGED_MIXED, (7,)),
    ("d32", 8, 12, 32, 16, 64, PAGED_MIXED, (7,)),
    ("page8_boundary", 8, 12, 64, 8, 128,
     [63, 64, 65, 127, 128, 129, 1024, 8], ()),
]
PAGED_SWEPT = ("main", "b1_1024", "b8_full")  # rows timed at each split
# K6's and K7's kernel names, as the profiler lists them.
DECODE_MARKS = {"paged_attention": ("paged_attention_kernel",
                                     "paged_attention_bf16_kernel"),
                "int8_matmul": ("int8_matmul_kernel",)}


def paged_case(dev, b, h, d, ps, pages, lengths, trash, seed):
    import torch

    n = b * pages + 1
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, h, d, generator=gen).to(dev)
    kp = torch.randn(n, h, ps, d, generator=gen).to(dev)
    vp = torch.randn(n, h, ps, d, generator=gen).to(dev)
    table = (1 + torch.randperm(n - 1, generator=gen)).reshape(b, pages)
    for r in trash:
        table[r] = 0  # an all-trash row (an inactive slot)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, table.to(torch.int32).to(dev), lengths.to(dev)


def kernel_option(fn, name: str) -> bool:
    """Whether a kernel's launch function takes the option ``name`` (the
    split size; absent in a tree from before the split design)."""
    import inspect

    return name in inspect.signature(fn).parameters


def check_paged(dev):
    """K6 against its plain version (within ``TOL``) on every
    ``PAGED_CASES`` row, two calls bitwise equal, timed as device time
    (CUDA graph replays, ``ms``) with the pools cycled through copies
    whose live K/V exceed 2 x L2 together, as a decode step finds them,
    beside the eager rate (``ms_eager``, the host's) and the plain
    version.  The main rows are also timed at each split size."""
    import math
    from importlib import import_module

    import torch

    pa = import_module("ml_trainer_tpu_torch.ops.kernels.paged_attention")

    rows = []
    for i, (name, b, h, d, ps, pages, lens, trash) in enumerate(PAGED_CASES):
        q, kp, vp, table, lengths = paged_case(dev, b, h, d, ps, pages, lens,
                                               trash, SEED + 1 + i)
        out = pa.paged_attention(q, kp, vp, table, lengths)
        ref = pa.paged_attention_reference(q, kp, vp, table, lengths)
        again = pa.paged_attention(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"paged_attention {name}: max abs err {err} "
                                 f"> {TOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention {name}: two calls differ")
        L = pages * ps
        live = sum(min(max(n, 1), L) for n in lens)
        live_bytes = 2 * live * h * d * 4
        copies = [(q.clone(), kp.clone(), vp.clone())
                  for _ in range(1 + math.ceil(2 * L2_BYTES / live_bytes))]

        def kernel(a, k_, v_):
            return pa.paged_attention(a, k_, v_, table, lengths)

        def plain_fn(a, k_, v_):
            return pa.paged_attention_reference(a, k_, v_, table, lengths)

        ms = time_graph_ms(kernel, copies)
        ms_eager = time_cold_ms(kernel, copies)
        plain = time_cold_ms(plain_fn, copies, iters=20)
        extra = {}
        if kernel_option(pa._paged_kernel, "split"):
            extra["split"] = pa.split_positions(b, h, pages, ps)
            if name in PAGED_SWEPT:
                scale = d ** -0.5
                extra["split_ms"] = {
                    str(sp): time_graph_ms(
                        lambda a, k_, v_, sp=sp: pa._paged_kernel(
                            a, k_, v_, table, lengths, scale, split=sp),
                        copies)
                    for sp in (16, 32, 64)}
        nbytes = 2 * b * h * d * 4 + live_bytes + table.numel() * 4 + b * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * h * d)
        row = dict(case=name, B=b, H=h, D=d, page=ps, pages=pages,
                   lengths=lens, max_abs_err=err, bitwise_repeat=True, ms=ms,
                   ms_eager=ms_eager, plain_ms=plain, library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, pool_copies=len(copies),
                   **extra)
        log("kernel paged_attention " + json.dumps(row))
        rows.append(row)
        del q, kp, vp, copies, out, ref, again
        torch.cuda.empty_cache()
    return rows


def check_tickets(dev):
    """Runs of K6 calls with changing B and lengths, and of K7 calls with
    changing M and shapes (its clusters of 1-8 slices, passes of 8 rows),
    each against its plain version; then every K6 ticket counter must be
    back at 0 (a tree from before the split design has none)."""
    import torch

    from ml_trainer_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul, quantize_per_channel)
    from ml_trainer_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_reference)

    q, kp, vp, table, _ = paged_case(dev, 8, 12, 64, 16, 64, PAGED_MIXED,
                                     (7,), SEED + 60)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 61)
    worst = 0.0
    calls = 0
    for b in (8, 3, 1, 5, 8, 2, 1, 8):
        lengths = torch.randint(1, 1025, (b,), generator=gen,
                                dtype=torch.int32).to(dev)
        out = paged_attention(q[:b], kp, vp, table[:b], lengths)
        ref = paged_attention_reference(q[:b], kp, vp, table[:b], lengths)
        err = (out - ref).abs().max().item()
        if not err <= TOL:
            raise AssertionError(f"ticket run B={b}: max abs err {err}")
        worst = max(worst, err)
        calls += 1
    for m, k, n in ((8, 3072, 768), (1, 3072, 768), (13, 768, 2304),
                    (8, 768, 2304), (3, 130, 100)):
        x = torch.randn(m, k, generator=gen).to(dev)
        w_q, scale = quantize_per_channel(
            (torch.randn(k, n, generator=gen) * 0.02).to(dev))
        got = int8_matmul(x, w_q, scale)
        want = int8_matmul(x, w_q, scale, implementation="reference")
        if not (got - want).abs().max().item() <= (
                INT8_REL * want.abs().max().item()):
            raise AssertionError(f"ticket run int8 M={m} K={k} N={n}")
        calls += 1
    torch.cuda.synchronize()
    try:
        from ml_trainer_tpu_torch.ops.kernels import _split
    except ImportError:
        zero = "no ticket counters"
    else:
        zero = _split.all_zero()
        if not zero:
            raise AssertionError("a ticket counter is not back at 0")
    rec = dict(calls=calls, paged_max_abs_err=worst, tickets_all_zero=zero)
    log("kernel tickets " + json.dumps(rec))
    return rec


INT8_CASES = [  # (name, M, K, N, all-zero column); the first is the main row
    ("qkv", 8, 768, 2304, False), ("proj", 8, 768, 768, False),
    ("fc_in", 8, 768, 3072, False), ("fc_out", 8, 3072, 768, False),
    ("qkv_m1", 1, 768, 2304, False), ("ragged", 13, 130, 100, False),
    ("bench", 8, 256, 1024, False), ("zero_column", 8, 768, 768, True),
]


def time_cold_ms(fn, copies, iters: int = 60) -> float:
    """``time_ms`` of ``fn(args)`` cycling through ``copies`` (each an
    argument tuple with its own weights), so that the weights come from
    device memory and not from L2, as in a decode step.  Eager calls: for
    a kernel of a few microseconds this is the host's launch rate."""
    it = [0]

    def step():
        fn(*copies[it[0] % len(copies)])
        it[0] += 1

    return time_ms(step, iters=iters)


def time_graph_ms(fn, copies, iters: int = 60, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls of ``fn(args)`` cycling
    through ``copies``, captured in one CUDA graph and replayed between
    CUDA events, so that the host's per-call cost is not measured.  The
    warm-up runs on the capture stream (K6's ticket counters are made
    per stream, outside a capture)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for i in range(3):
            fn(*copies[i % len(copies)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*copies[i % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


INT8_SWEPT = ("qkv", "proj", "fc_in", "fc_out")  # timed at each K slice


def int8_library(x, w_q, scale, copies):
    """``torch._weight_int8pack_mm`` (x @ (w_q * scale)^T with w_q as
    [N, K]) timed on the same inputs, or the words with which it
    refuses.  Timed only: it dequantizes per weight, which rounds
    otherwise than the port's sum-then-scale, and the port never calls
    it."""
    import torch

    packed = [(w.T.contiguous(), sc) for w, sc, _ in copies]
    try:
        torch._weight_int8pack_mm(x, *packed[0])
        torch.cuda.synchronize()
        return time_graph_ms(
            lambda w, sc: torch._weight_int8pack_mm(x, w, sc), packed), None
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:200]


def check_int8(dev):
    """K7 against its plain version at the decode shapes, two calls
    bitwise equal, timed cold beside the plain version, ``F.linear`` on
    the fp32 weights and ``torch._weight_int8pack_mm`` (``library_ms``).
    The ``*_ms`` times are device times (CUDA graph replays); ``ms_l2``
    keeps one weight copy in L2; ``*_eager`` are CUDA events around eager
    calls, which for these few-microsecond calls is the host's rate.  The
    four GPT-2 projections are also timed at each K slice."""
    import math
    from importlib import import_module

    import torch
    import torch.nn.functional as F

    im = import_module("ml_trainer_tpu_torch.ops.kernels.int8_matmul")
    int8_matmul, quantize_per_channel = im.int8_matmul, im.quantize_per_channel

    rows = []
    for i, (name, m, k, n, zero_col) in enumerate(INT8_CASES):
        gen = torch.Generator(device="cpu").manual_seed(SEED + 30 + i)
        x = torch.randn(m, k, generator=gen).to(dev)
        w = (torch.randn(n, k, generator=gen) * 0.02).to(dev)  # nn.Linear
        if zero_col:
            w[5] = 0.0
        bias = (torch.randn(n, generator=gen) * 0.02).to(dev)
        w_q, scale = quantize_per_channel(w.T)
        w_q = w_q.contiguous()
        got = int8_matmul(x, w_q, scale, bias=bias)
        want = int8_matmul(x, w_q, scale, bias=bias,
                           implementation="reference")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        bar = INT8_REL * want.abs().max().item()
        if not err <= bar:
            raise AssertionError(f"int8_matmul {name}: max abs err {err} > "
                                 f"{bar} (1e-5 x max|plain|)")
        if zero_col and not (scale[5].item() == 1.0
                             and torch.equal(got[:, 5], bias[5].expand(m))):
            raise AssertionError("int8_matmul: the all-zero column is not "
                                 "scale 1 and bias only")
        if not torch.equal(got, int8_matmul(x, w_q, scale, bias=bias)):
            raise AssertionError(f"int8_matmul {name}: two calls differ")
        nq = max(1, math.ceil(2 * L2_BYTES / (k * n)))
        nf = max(1, math.ceil(2 * L2_BYTES / (4 * k * n)))
        q_copies = [(w_q.clone(), scale, bias) for _ in range(nq)]
        f_copies = [(w.clone(), bias) for _ in range(nf)]
        def kernel(a, b, c):
            return int8_matmul(x, a, b, bias=c)

        def plain_fn(a, b, c):
            return int8_matmul(x, a, b, bias=c, implementation="reference")

        def dense_fn(a, b):
            return F.linear(x, a, b)

        ms = time_graph_ms(kernel, q_copies)
        ms_l2 = time_graph_ms(kernel, q_copies[:1])
        ms_eager = time_cold_ms(kernel, q_copies)
        plain = time_graph_ms(plain_fn, q_copies, iters=20)
        dense = time_graph_ms(dense_fn, f_copies)
        dense_eager = time_cold_ms(dense_fn, f_copies)
        lib, lib_error = int8_library(x, w_q, scale, q_copies)
        extra = {} if lib_error is None else {"library_error": lib_error}
        if kernel_option(im._int8_kernel, "slice_k"):
            extra["slice"] = im.k_slice(k, n)
            if name in INT8_SWEPT:  # the least slice of each count, 1-8
                step, slices = im.SLICE_STEP, {}
                for sl in range(step, k + step, step):
                    slices.setdefault(-(-k // sl), sl)
                extra["slice_ms"] = {
                    str(sl): time_graph_ms(
                        lambda a, b, c, sl=sl: im._int8_kernel(
                            x, a, b, c, slice_k=sl), q_copies)
                    for count, sl in sorted(slices.items())
                    if count <= im.MAX_SLICES}
        # Each input read once, the output written once: int8 weights,
        # x, scale and bias in f32, out in f32; 2*M*K*N f32 operations.
        nbytes = k * n + 4 * m * k + 4 * n + 4 * n + 4 * m * n
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
        row = dict(case=name, M=m, K=k, N=n, max_abs_err=err, err_bar=bar,
                   bitwise_repeat=True, ms=ms, ms_l2=ms_l2, ms_eager=ms_eager,
                   plain_ms=plain, fp32_dense_ms=dense,
                   fp32_dense_ms_eager=dense_eager, library_ms=lib,
                   bound_ms=b_ms, bound_by=b_by, weight_copies=nq, **extra)
        log("kernel int8_matmul " + json.dumps(row))
        rows.append(row)
        del q_copies, f_copies
        torch.cuda.empty_cache()
    return rows


# K6's bf16 entry (a bf16 model's decode step): rows as PAGED_CASES with q
# and the pools in bf16 (the main row is the bf16 serving run's decode
# batch); ``b1_2048`` takes 16 splits of 128, the non-portable cluster
# size.  Then the planted row (``PLANTED``).
PAGED_BF16_CASES = [c for c in PAGED_CASES
                    if c[0] in ("main", "b1_1024", "d128", "d32")] + [
    ("b1_2048", 1, 12, 64, 16, 128, [2048], ())]
# The planted row: one row of two live positions, scores (0.828125, 0)
# (q = 6.625 e_0 against k rows e_0 and 0, scale 1/8 at D = 64) and
# values +16 and -36.25 on every channel.  Its output (0.0801) is small
# against the values, and the weights' f32 values lie over 0.16 of a bf16
# ulp from a rounding midpoint, so rounding the normalised weights (the
# JAX function), rounding the unnormalised exp(s - m) and not rounding
# give outputs 0.0801, 0.0977 and 0.1138: over 20 bars apart.
PLANTED = dict(q=6.625, v=(16.0, -36.25), d=64, heads=12)


def planted_case(dev):
    import torch

    d, h = PLANTED["d"], PLANTED["heads"]
    q = torch.zeros(1, h, d)
    q[..., 0] = PLANTED["q"]
    kp = torch.zeros(2, h, 16, d)
    vp = torch.zeros(2, h, 16, d)
    kp[1, :, 0, 0] = 1.0
    vp[1, :, 0], vp[1, :, 1] = PLANTED["v"]
    bf = torch.bfloat16
    return (q.to(bf).to(dev), kp.to(bf).to(dev), vp.to(bf).to(dev),
            torch.tensor([[1]], dtype=torch.int32, device=dev),
            torch.tensor([2], dtype=torch.int32, device=dev))


def planted_designs(q, kp, vp, table, lengths):
    """The planted row through the two designs that are not the JAX
    function: the unnormalised exp(s - m) rounded to bf16 before PV and
    divided by l after, and no rounding of the weights."""
    import torch

    n = int(lengths[0])
    pos = torch.arange(n, device=q.device)
    page = table[0, pos // kp.shape[2]].long()
    k = kp[page, :, pos % kp.shape[2]].float()
    v = vp[page, :, pos % kp.shape[2]].float()
    sc = torch.einsum("bhd,nhd->bhn", q.float(), k) * q.shape[-1] ** -0.5
    p = torch.exp(sc - sc.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    unnorm = torch.einsum("bhn,nhd->bhd", p.to(torch.bfloat16).float(), v) / l
    exact = torch.einsum("bhn,nhd->bhd", p, v) / l
    return unnorm.to(torch.bfloat16), exact.to(torch.bfloat16)


def check_paged_bf16(dev):
    """K6's bf16 entry against its plain version on the same bf16 inputs
    (within 2 bf16 ulps: ``bf16_gate`` <= 1), two calls bitwise, timed as
    ``check_paged`` times the float32 rows (graph replays over pool copies
    past 2 x L2, eager, plain), beside its bound with the pools at 2 bytes
    a value.  Then the planted row: the kernel within the bar of the plain
    version, and the three rounding designs more than a bar apart."""
    import math
    from importlib import import_module

    import torch

    pa = import_module("ml_trainer_tpu_torch.ops.kernels.paged_attention")
    rows = []
    for i, (name, b, h, d, ps, pages, lens, trash) in enumerate(
            PAGED_BF16_CASES):
        q, kp, vp, table, lengths = (
            t.to(torch.bfloat16) if t.is_floating_point() else t
            for t in paged_case(dev, b, h, d, ps, pages, lens, trash,
                                SEED + 70 + i))
        out = pa.paged_attention(q, kp, vp, table, lengths)
        ref = pa.paged_attention_reference(q, kp, vp, table, lengths)
        again = pa.paged_attention(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"paged_attention bf16 {name}: {out.dtype}")
        ratio = bf16_gate(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"paged_attention bf16 {name}: {ratio} of "
                                 "the 2-ulp bar")
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention bf16 {name}: two calls "
                                 "differ")
        L = pages * ps
        live = sum(min(max(n, 1), L) for n in lens)
        live_bytes = 2 * live * h * d * 2
        copies = [(q.clone(), kp.clone(), vp.clone())
                  for _ in range(1 + math.ceil(2 * L2_BYTES / live_bytes))]

        def kernel(a, k_, v_):
            return pa.paged_attention(a, k_, v_, table, lengths)

        def plain_fn(a, k_, v_):
            return pa.paged_attention_reference(a, k_, v_, table, lengths)

        ms = time_graph_ms(kernel, copies)
        ms_eager = time_cold_ms(kernel, copies)
        plain = time_cold_ms(plain_fn, copies, iters=20)
        nbytes = 2 * b * h * d * 2 + live_bytes + table.numel() * 4 + b * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * h * d)
        row = dict(case=name, B=b, H=h, D=d, page=ps, pages=pages,
                   lengths=lens, split=pa.cluster_split(pages, ps),
                   max_abs_err=err, gate_ratio=ratio, bitwise_repeat=True,
                   ms=ms, ms_eager=ms_eager, plain_ms=plain, library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, pool_copies=len(copies))
        log("kernel paged_attention bf16 " + json.dumps(row))
        rows.append(row)
        del q, kp, vp, copies, out, ref, again
        torch.cuda.empty_cache()

    case = planted_case(dev)
    out = pa.paged_attention(*case)
    ref = pa.paged_attention_reference(*case)
    unnorm, exact = planted_designs(*case)
    torch.cuda.synchronize()
    planted = dict(
        case="planted", kernel=out[0, 0, 0].item(), plain=ref[0, 0, 0].item(),
        unnormalised=unnorm[0, 0, 0].item(), unrounded=exact[0, 0, 0].item(),
        kernel_vs_plain=bf16_gate(out, ref),
        # The three designs' distances, in bars of the first named.
        normalised_vs_unnormalised=bf16_gate(unnorm, out),
        normalised_vs_unrounded=bf16_gate(exact, out),
        unnormalised_vs_unrounded=bf16_gate(exact, unnorm))
    log("kernel paged_attention bf16 " + json.dumps(planted))
    if not planted["kernel_vs_plain"] <= 1.0:
        raise AssertionError(f"paged_attention bf16 planted row: {planted}")
    if not min(planted[k] for k in ("normalised_vs_unnormalised",
                                    "normalised_vs_unrounded",
                                    "unnormalised_vs_unrounded")) > 1.0:
        raise AssertionError("the planted row does not tell the rounding "
                             f"designs apart: {planted}")
    rows.append(planted)
    return rows


INT8_BF16_CASES = [c for c in INT8_CASES if c[0] in INT8_SWEPT]


def check_int8_bf16(dev):
    """K7's bf16 entry at the four GPT-2 124M decode projections (M = 8,
    bf16 x and out, the bias fused with JAX's two roundings) against its
    plain version (``bf16_gate`` <= 1), two calls bitwise, timed by graph
    replays over weight copies past 2 x L2 beside the plain version and
    ``torch._weight_int8pack_mm`` on the same bf16 x (scales in bf16;
    timed only), its bound with x and out at 2 bytes a value."""
    import math
    from importlib import import_module

    import torch

    im = import_module("ml_trainer_tpu_torch.ops.kernels.int8_matmul")
    rows = []
    for i, (name, m, k, n, _) in enumerate(INT8_BF16_CASES):
        gen = torch.Generator(device="cpu").manual_seed(SEED + 80 + i)
        x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(n, k, generator=gen) * 0.02).to(dev)
        bias = (torch.randn(n, generator=gen) * 0.02).to(dev)
        w_q, scale = im.quantize_per_channel(w.T)
        w_q = w_q.contiguous()
        got = im.int8_matmul(x, w_q, scale, bias=bias)
        want = im.int8_matmul(x, w_q, scale, bias=bias,
                              implementation="reference")
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"int8_matmul bf16 {name}: {got.dtype}")
        ratio = bf16_gate(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"int8_matmul bf16 {name}: {ratio} of the "
                                 "2-ulp bar")
        if not torch.equal(got, im.int8_matmul(x, w_q, scale, bias=bias)):
            raise AssertionError(f"int8_matmul bf16 {name}: two calls differ")
        nq = max(1, math.ceil(2 * L2_BYTES / (k * n)))
        q_copies = [(w_q.clone(), scale, bias) for _ in range(nq)]

        def kernel(a, b, c):
            return im.int8_matmul(x, a, b, bias=c)

        def plain_fn(a, b, c):
            return im.int8_matmul(x, a, b, bias=c, implementation="reference")

        ms = time_graph_ms(kernel, q_copies)
        ms_eager = time_cold_ms(kernel, q_copies)
        plain = time_graph_ms(plain_fn, q_copies, iters=20)
        lib, lib_error = int8_library(
            x, w_q, scale, [(a, b.to(torch.bfloat16), c)
                            for a, b, c in q_copies])
        extra = {} if lib_error is None else {"library_error": lib_error}
        # int8 weights once, x and out at 2 bytes, scale and bias at 4;
        # 2*M*K*N f32 operations.
        nbytes = k * n + 2 * m * k + 4 * n + 4 * n + 2 * m * n
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
        row = dict(case=name, M=m, K=k, N=n, slice=im.k_slice(k, n),
                   max_abs_err=err, gate_ratio=ratio, bitwise_repeat=True,
                   ms=ms, ms_eager=ms_eager, plain_ms=plain, library_ms=lib,
                   bound_ms=b_ms, bound_by=b_by, weight_copies=nq, **extra)
        log("kernel int8_matmul bf16 " + json.dumps(row))
        rows.append(row)
        del q_copies
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- phase 4
def serve(dev):
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    t0 = time.perf_counter()
    model = _seeded_model("gpt2", seed=SEED, device=dev)
    model.eval()
    log(f"model gpt2 124M: {sum(p.numel() for p in model.parameters())} "
        f"params, built in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(SEED)
    vocab = model.vocab_size
    shared = rng.integers(0, vocab, 256)
    lengths = [5, 40, 100, 200, 300, 400, 640, 900]
    prompts = []
    for n in lengths:
        prompts.append(rng.integers(0, vocab, n).astype(np.int32))
    # Requests 4 and 5 share a 256-token prefix: 5 is admitted after 4
    # has registered its blocks, so it takes the continuation prefill.
    prompts[4][:256] = shared
    prompts[5][:256] = shared
    new_tokens = 32

    fp32 = serve_pair(model, prompts, new_tokens, quant_int8=False)
    outs, counts = fp32.pop("outs"), fp32["launches"]
    if counts["int8_matmul"] != 0:
        raise AssertionError(f"the fp32 server launched int8_matmul "
                             f"{counts['int8_matmul']}x")

    # Teacher-forced check through the plain attention path.
    worst = 0.0
    model.attention_impl = "xla"
    try:
        with torch.no_grad():
            for p, seq in zip(prompts, outs):
                ids = torch.as_tensor(seq.astype(np.int64), device=dev)[None]
                logits = model(ids)[0]
                n = len(p)
                pos = torch.arange(n - 1, n - 1 + new_tokens, device=dev)
                got = logits[pos, ids[0, n:]]
                gap = (logits[pos].max(-1).values - got).max().item()
                worst = max(worst, gap)
                if not torch.isfinite(logits).all():
                    raise AssertionError("non-finite logits in the check")
    finally:
        model.attention_impl = "auto"
    if not worst <= LOGIT_SLACK:
        raise AssertionError(
            f"a served token is {worst} below the best logit (> {LOGIT_SLACK})")
    fp32["worst_logit_gap"] = worst
    fp32["prompt_lens"] = lengths

    int8 = serve_pair(model, prompts, new_tokens, quant_int8=True)
    outs_q, counts_q = int8.pop("outs"), int8["launches"]
    steps = int8["decode_steps"]
    if counts_q["int8_matmul"] != 4 * model.depth * steps:
        raise AssertionError(
            f"int8_matmul launched {counts_q['int8_matmul']}x over {steps} "
            f"decode steps, expected 4 x {model.depth} per step")
    if counts_q["flash_fwd"] != counts["flash_fwd"]:
        raise AssertionError(f"int8 serving launched flash_fwd "
                             f"{counts_q['flash_fwd']}x, fp32 serving "
                             f"{counts['flash_fwd']}x")
    # Random weights: reported, not gated (see QGATE).
    int8.update(replay_int8(model, prompts, outs_q, new_tokens,
                            gate_quality=False))
    # The contiguous engine's decode step (the plain masked attention).
    fp32["contiguous_decode_window"] = decode_window(
        model, prompts, quant_int8=False, graph=True, paged=False)
    del model
    torch.cuda.empty_cache()
    return {"fp32": fp32, "int8": int8,
            **serve_bf16(dev, prompts, new_tokens, outs, counts)}


def graph_summary(run: dict) -> dict:
    """One serving precision's eager and graph numbers side by side
    ([eager, graph]): the ``Server`` runs' tokens/s, TTFT p50, decode
    step ms (host clock, ``ServingMetrics``) and the profiled pass's busy
    s and idle share; the decode windows' step ms (host clock), busy ms a
    step, idle share and K6/K7 device ms a step; the capture's seconds
    and bytes; whether the replayed logits were bitwise the eager step's."""
    eager, win = run["eager"], run["decode_window"]

    def pair(get):
        return [get(eager, win["eager"]), get(run, win["graph"])]

    return {
        "tokens_per_s": pair(lambda r, w: r["tokens_per_s"]),
        "ttft_p50_s": pair(lambda r, w: r["ttft_p50_s"]),
        "decode_step_mean_ms": pair(lambda r, w: r["decode_step_mean_ms"]),
        "pass_busy_s": pair(lambda r, w: r["profile"]["device_busy_s"]),
        "pass_idle_share": pair(
            lambda r, w: r["profile"].get("device_idle_share")),
        "window_step_ms": pair(lambda r, w: w["step_ms"]),
        "window_busy_ms_a_step": pair(
            lambda r, w: w["profile"].get("busy_ms_a_step")),
        "window_idle_share": pair(
            lambda r, w: w["profile"].get("device_idle_share")),
        # Busy ms a step (profiled) over step ms (host clock, unprofiled):
        # the idle share without the profiler's own host cost.
        "window_idle_share_unprofiled_wall": pair(
            lambda r, w: 1.0 - w["profile"]["busy_ms_a_step"] / w["step_ms"]
            if "busy_ms_a_step" in w["profile"] else None),
        "window_k6_k7_device_ms_a_step": pair(
            lambda r, w: w["profile"]["step_device_ms"]),
        "server_capture_s": run["capture_s"],
        "server_capture_bytes": run["capture_bytes"],
        "window_capture_s": win["graph"]["capture_s"],
        "window_capture_bytes": win["graph"]["capture_bytes"],
        "logits_bitwise": win["graph"]["logits_bitwise"],
        "tokens_equal": run["tokens_equal_to_eager"],
    }


def serve_bf16(dev, prompts, new_tokens: int, outs_fp32, counts_fp32):
    """The same weights at ``precision="bf16"`` (bf16 caches and page
    pools: K1's bf16 prefill, K6 over bf16 pools, K7 with bf16
    activations), the same requests, twice: bf16, then bf16 with
    ``quant_int8``.  Each run: exact launch counts (K6 depth per decode
    step, K7 4 x depth per decode step in the int8 run and none in the
    other, K1 the fp32 run's count), the per-call check of one prefill and
    one decode step (``serve_call_check``), and every served token within
    max(LOGIT_SLACK, 2 d) of the best logit on a teacher-forced replay
    through the plain versions, d the largest logit difference between
    the replay through the kernels and through the plain versions.
    Reported, not gated: the share of bf16 greedy tokens equal to fp32's,
    and the int8 run's relative logit error and argmax agreement against
    bf16 on the int8 run's sequences."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    model = _seeded_model("gpt2", seed=SEED, device=dev, precision="bf16")
    model.eval()
    runs = {}
    for quant_int8 in (False, True):
        run = serve_pair(model, prompts, new_tokens, quant_int8=quant_int8)
        got = run.pop("outs")
        for r in (run, run["eager"]):
            steps = r["decode_steps"]
            want = dict(counts_fp32, paged_attention=model.depth * steps,
                        int8_matmul=(4 * model.depth * steps if quant_int8
                                     else 0))
            if r["launches"] != want:
                raise AssertionError(
                    f"bf16 serving (quant_int8={quant_int8}, graph="
                    f"{r['graph']}) launches {r['launches']}, expected "
                    f"{want}")
        quant = mt.quantize_tree(model) if quant_int8 else None
        run["call_check"] = serve_call_check(model, prompts, quant_int8)
        kern = replay_served(model, prompts, got, new_tokens, quant, False)
        plain = replay_served(model, prompts, got, new_tokens, quant, True)
        d = max((a - b).abs().max().item() for a, b in zip(kern, plain))
        gap = 0.0
        for p, seq, lp in zip(prompts, got, plain):
            served = torch.as_tensor(np.asarray(seq[len(p):], np.int64),
                                     device=dev)
            rows = torch.arange(new_tokens, device=dev)
            gap = max(gap, (lp.max(-1).values - lp[rows, served]).max().item())
            if not torch.isfinite(lp).all():
                raise AssertionError("non-finite logits in the bf16 replay")
        bar = max(LOGIT_SLACK, 2 * d)
        run.update(worst_logit_gap=gap, kernel_vs_plain_logit_diff=d,
                   logit_gap_bar=bar)
        if not gap <= bar:
            raise AssertionError(
                f"a bf16-served token (quant_int8={quant_int8}) is {gap} "
                f"below the best plain logit (> {bar}, d = {d})")
        run["tokens_equal_to_fp32_share"] = float(np.mean([
            np.mean(np.asarray(a[len(p):]) == np.asarray(b[len(p):]))
            for p, a, b in zip(prompts, got, outs_fp32)]))
        if quant_int8:  # the int8 decode steps against bf16's
            ref = replay_served(model, prompts, got, new_tokens, None, True)
            diff = max((a[1:] - b[1:]).abs().max().item()
                       for a, b in zip(plain, ref))
            peak = max(b[1:].abs().max().item() for b in ref)
            agree = np.mean([(a[1:].argmax(-1) == b[1:].argmax(-1))
                             .float().mean().item()
                             for a, b in zip(plain, ref)])
            run.update(int8_vs_bf16_rel_logit_err=diff / peak,
                       int8_vs_bf16_argmax_agreement=float(agree))
        runs["bf16_int8" if quant_int8 else "bf16"] = run
    del model
    torch.cuda.empty_cache()
    return runs


def replay_served(model, prompts, outs, new_tokens: int, quant, plain: bool):
    """Teacher-forced logits of served sequences through the serving
    path's own calls: the prompt's batch-1 prefill into a contiguous
    cache of its power-of-two bucket (K1 from bucket 128 up), its K/V
    moved into a batch-1 paged cache of page 16, then the served tokens
    one at a time through the S == 1 step (K6; with ``quant`` the int8
    projections, K7).  ``plain``: the same calls through the kernels'
    plain versions (the flash Function routed as for a CPU tensor, the
    gather path, the plain int8 matmul).  Per request [new_tokens, V]
    float32 logits, row j scoring served token j."""
    import contextlib
    import importlib
    from unittest import mock

    import numpy as np
    import torch

    tatt = importlib.import_module("ml_trainer_tpu_torch.ops.attention")
    dev, ps = model.device, 16
    pages = model.max_len // ps
    route = (mock.patch.object(tatt, "_device_kind", lambda q: "cpu")
             if plain else contextlib.nullcontext())
    first = torch.zeros(1, dtype=torch.long, device=dev)
    out = []
    with torch.no_grad(), route:
        for p, seq in zip(prompts, outs):
            n = len(p)
            ids = torch.as_tensor(np.asarray(seq, np.int64), device=dev)
            bucket = min(1 << (n - 1).bit_length(), model.max_len)
            padded = torch.zeros((1, bucket), dtype=torch.long, device=dev)
            padded[0, :n] = ids[:n]
            c1 = model.new_cache(1, max_len=bucket)
            rows = [model(padded, c1, select=first + n - 1)[0]]
            cache = model.new_paged_cache(1, pages + 1, ps,
                                          paged_kernel=not plain)
            cache.table[0] = torch.arange(1, pages + 1, dtype=torch.int32,
                                          device=dev)
            pos = torch.arange(bucket, device=dev)
            for layer in range(model.depth):
                cache.k[layer][1 + pos // ps, :, pos % ps] = (
                    c1.k[layer][0].transpose(0, 1))
                cache.v[layer][1 + pos // ps, :, pos % ps] = (
                    c1.v[layer][0].transpose(0, 1))
            cache.index[0] = n
            for j in range(n, n + new_tokens - 1):
                rows.append(model(
                    ids[None, j:j + 1], cache, select=first, quant=quant,
                    quant_impl="reference" if plain else "auto")[0])
            out.append(torch.stack(rows).float())
            del c1, cache
    return out


# The launch functions of the kernels (module, attribute, kernel): the
# per-call check records their calls.
CALL_SITES = (
    ("ml_trainer_tpu_torch.ops.attention", "_flash_kernel", "flash_fwd"),
    ("ml_trainer_tpu_torch.ops.attention", "flash_bwd_dq", "flash_bwd_dq"),
    ("ml_trainer_tpu_torch.ops.attention", "flash_bwd_dkv", "flash_bwd_dkv"),
    ("ml_trainer_tpu_torch.ops.kernels.paged_attention", "_paged_kernel",
     "paged_attention"),
    ("ml_trainer_tpu_torch.ops.kernels.int8_matmul", "_int8_kernel",
     "int8_matmul"),
)


@contextlib.contextmanager
def capture_calls():
    """Inside, every call of a kernel's launch function (``CALL_SITES``)
    runs as it would and is recorded as (kernel, inputs, outputs), the
    tensors cloned."""
    import importlib
    from unittest import mock

    import torch

    def keep(t):
        return t.detach().clone() if torch.is_tensor(t) else t

    calls = []
    with contextlib.ExitStack() as stack:
        for mod, attr, kname in CALL_SITES:
            module = importlib.import_module(mod)

            def wrapped(*args, _real=getattr(module, attr), _k=kname, **kw):
                out = _real(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                calls.append((_k, [keep(a) for a in args],
                              [keep(o) for o in outs]))
                return out

            stack.enter_context(mock.patch.object(module, attr, wrapped))
        yield calls


def exact_outputs(kname: str, args) -> list:
    """A recorded call's outputs through the JAX function in float64,
    rounded where the JAX function rounds: the inputs widened; K1 the
    masked softmax and PV, out rounded once (lse in float32); K2/K3 the
    gradients from the call's lse and delta, each rounded once; K6 the
    masked softmax, the weights rounded to the pools' dtype, PV, out
    rounded once; K7 the scaled sum rounded to x's dtype, then the bias
    rounded to it and added, rounded once more."""
    import torch

    from ml_trainer_tpu_torch.ops.attention import (
        _backward_plain, flash_attention_reference)

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() else t

    if kname == "flash_fwd":
        q, k, v, kv_lens, causal, scale = args
        out, lse = flash_attention_reference(f64(q), f64(k), f64(v), kv_lens,
                                             causal, scale)
        return [out.to(q.dtype), lse.float()]
    if kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        q, k, v, kv_lens, lse, delta, dout, causal, scale = args
        grads = _backward_plain(f64(q), f64(k), f64(v), kv_lens, f64(lse),
                                f64(delta), f64(dout), causal, scale)
        grads = [g.to(q.dtype) for g in grads]
        return grads[:1] if kname == "flash_bwd_dq" else grads[1:]
    if kname == "paged_attention":
        q, kp, vp, table, lengths, scale = args[:6]
        b, h, d = q.shape
        L = table.shape[1] * kp.shape[2]
        tl = table.long()

        def gather(pool):  # [B, P, H, page, D] -> [B, H, L, D]
            return pool[tl].permute(0, 2, 1, 3, 4).reshape(b, h, L, d).double()

        sc = torch.einsum("bhd,bhld->bhl", q.double(), gather(kp)) * scale
        live = (torch.arange(L, device=q.device)[None, :]
                < lengths.long().clamp(1, L)[:, None])
        sc = sc.masked_fill(~live[:, None, :], -torch.inf)
        w = torch.softmax(sc, -1).to(vp.dtype).double()
        return [torch.einsum("bhl,bhld->bhd", w, gather(vp)).to(q.dtype)]
    if kname == "int8_matmul":
        x, w_q, scale, bias = args[:4]
        x2 = x.reshape(-1, x.shape[-1]).double()
        y = ((x2 @ w_q.double()) * scale.double()).to(x.dtype)
        if bias is not None:
            y = (y.double() + bias.to(x.dtype).double()).to(x.dtype)
        return [y.reshape(*x.shape[:-1], w_q.shape[1])]
    raise ValueError(kname)


def hold_call(kname: str, args, outs, rec: dict) -> None:
    """One kernel call's outputs against ``exact_outputs`` on its own
    inputs, into ``rec`` (the calls, the worst errors): float32 within
    TOL, bf16 within 2 bf16 ulps (``bf16_gate`` <= 1); K1's lse within
    TOL."""
    import torch

    want = exact_outputs(kname, args)
    rec["calls"] += 1
    if kname == "flash_fwd":
        lse_err = (outs[1].float() - want[1]).abs().max().item()
        rec["worst_lse_err"] = max(rec.get("worst_lse_err", 0.0), lse_err)
        if not lse_err <= TOL:
            raise AssertionError(f"{kname} call: lse {lse_err} from float64")
        outs, want = outs[:1], want[:1]
    for got, w in zip(outs, want):
        if got.shape != w.shape or got.dtype != w.dtype:
            raise AssertionError(f"{kname} call: {got.dtype} "
                                 f"{tuple(got.shape)} vs {tuple(w.shape)}")
        if got.dtype == torch.bfloat16:
            ratio = bf16_gate(got, w)
            rec["worst_gate_ratio"] = max(rec.get("worst_gate_ratio", 0.0),
                                          ratio)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"{kname} call: {ratio} of the 2-ulp bar against the "
                    "float64 JAX function")
        else:
            err = (got.float() - w.float()).abs().max().item()
            rec["worst_err"] = max(rec.get("worst_err", 0.0), err)
            if not err <= TOL:
                raise AssertionError(f"{kname} call: {err} from the float64 "
                                     "JAX function")


def call_check(calls) -> dict:
    """Every recorded call's outputs (``capture_calls``), each of them
    bf16, through ``hold_call`` on its own inputs.  Per kernel: the calls
    checked, the worst gate ratio and K1's worst lse error."""
    import torch

    rec = {}
    for i, (kname, args, outs) in enumerate(calls):
        if outs[0].dtype != torch.bfloat16:
            raise AssertionError(f"call {i} ({kname}): {outs[0].dtype}")
        hold_call(kname, args, outs,
                  rec.setdefault(kname, {"calls": 0, "worst_gate_ratio": 0.0}))
    return rec


def serve_call_check(model, prompts, quant_int8: bool) -> dict:
    """The per-call check in serving: a fresh paged engine as the
    ``Server``'s (8 slots, page 16, ``paged_kernel``) admits the prompts,
    the longest (bucket 1024: K1) last under ``capture_calls``; then
    one decode step of the 8 slots (K6; K7 with ``quant_int8``) under it.
    Each call's bf16 outputs against the float64 JAX function
    (``call_check``), with exact call counts."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.serving.scheduler import Request

    engine = mt.SlotDecodeEngine(model, max_batch=8, kv_page_size=16,
                                 paged_kernel=True, quant_int8=quant_int8,
                                 device=model.device)
    last = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    order = [i for i in range(len(prompts)) if i != last] + [last]
    for slot, i in enumerate(order[:-1]):
        engine.admit(Request(prompts[i], 4), slot)
    with capture_calls() as prefill:
        engine.admit(Request(prompts[last], 4), len(order) - 1)
    with capture_calls() as step:
        engine.step()
    torch.cuda.synchronize()
    # A fresh engine's first decode step is the graph's warm-up: it runs
    # for real (the capture comes at the second step), so the hooks saw
    # launches that ran.
    if engine._graph is None or engine._graph.capture_s is not None:
        raise AssertionError("the checked decode step was not the warm-up")
    got = {k: sum(1 for c in prefill + step if c[0] == k)
           for k in ("flash_fwd", "paged_attention", "int8_matmul")}
    want = dict(flash_fwd=model.depth, paged_attention=model.depth,
                int8_matmul=4 * model.depth if quant_int8 else 0)
    if got != want:
        raise AssertionError(f"per-call check captured {got}, expected {want}")
    rec = call_check(prefill + step)
    engine.close()
    del engine, prefill, step
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def decode_graph(on: bool):
    """Engines made inside run the decode step as a CUDA graph (``on``)
    or eagerly (the baseline)."""
    from ml_trainer_tpu_torch.serving import SlotDecodeEngine

    SlotDecodeEngine._decode_graph = on
    try:
        yield
    finally:
        SlotDecodeEngine._decode_graph = True


def serve_pair(model, prompts, new_tokens: int, quant_int8: bool) -> dict:
    """``run_server`` with the decode graph, then eagerly (the baseline),
    then ``decode_window`` both ways.  Gates: the graph run's tokens equal
    the eager run's, both runs' launch counts are equal (each run gates
    its own K6 count: depth per decode step), and every K6 ticket is back
    at 0.  Returns the graph run's record with ``eager`` (the eager run's,
    without its tokens) and ``decode_window`` ({"graph", "eager"})."""
    import numpy as np

    from ml_trainer_tpu_torch.ops.kernels import _split

    with decode_graph(True):
        run = run_server(model, prompts, new_tokens, quant_int8)
    with decode_graph(False):
        eager = run_server(model, prompts, new_tokens, quant_int8)
    for i, (a, b) in enumerate(zip(run["outs"], eager.pop("outs"))):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"request {i} (quant_int8={quant_int8}): the graph run's "
                f"tokens differ from the eager run's at "
                f"{np.flatnonzero(a != b)[:5].tolist()}")
    if run["decode_steps"] != eager["decode_steps"]:
        raise AssertionError(f"decode steps: graph {run['decode_steps']}, "
                             f"eager {eager['decode_steps']}")
    if run["launches"] != eager["launches"]:
        raise AssertionError(f"launches: graph {run['launches']}, eager "
                             f"{eager['launches']}")
    if not _split.all_zero():
        raise AssertionError("a K6 ticket counter is not back at 0 after "
                             "serving")
    run["tokens_equal_to_eager"] = True
    run["eager"] = eager
    run["decode_window"] = {
        "graph": decode_window(model, prompts, quant_int8, graph=True),
        "eager": decode_window(model, prompts, quant_int8, graph=False)}
    return run


# Decode steps of ``decode_window``: host-clocked, then profiled.
WINDOW_STEPS = 16


def decode_window(model, prompts, quant_int8: bool, graph: bool,
                  paged: bool = True) -> dict:
    """A window of decode steps only, on an engine as the ``Server``'s (8
    slots; paged: page 16 with ``paged_kernel``, else contiguous) with
    all 8 slots live: the prompts admitted, two steps (with the graph:
    the warm-up, then the capture and its first replay), then
    ``WINDOW_STEPS`` steps on the host clock (each ends in the step's
    host read) and ``WINDOW_STEPS`` under the profiler, which records the
    device's activity only (recording every host op too, as the serving
    pass's profile does, lengthens an eager step and costs seconds of
    processing a window): busy and idle share, K6's and K7's device ms a
    step by kernel name.  With the
    graph also the capture's seconds and bytes, and the logits gate:
    from one state, the step run eagerly (``_decode``), the state
    restored, then one replay; the two logits must be bitwise equal.
    The graph window gates that the profiler names K6 (paged) under the
    replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.serving.scheduler import Request

    with decode_graph(graph):
        engine = mt.SlotDecodeEngine(
            model, max_batch=8, kv_page_size=16 if paged else 0,
            paged_kernel=paged, quant_int8=quant_int8, device=model.device)
    for slot, p in enumerate(prompts):
        engine.admit(Request(p, 4 * WINDOW_STEPS), slot)
    engine.step()
    engine.step()
    rec = {"graph": graph, "paged": paged, "quant_int8": quant_int8,
           "steps": WINDOW_STEPS}
    if graph:
        rec.update(capture_s=engine._graph.capture_s,
                   capture_bytes=engine._graph.capture_bytes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOW_STEPS):
        engine.step()
    rec["step_ms"] = 1e3 * (time.perf_counter() - t0) / WINDOW_STEPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if engine.active_count() != len(prompts):
        raise AssertionError("a slot left the decode window early")
    split = device_split(prof, wall)
    if not isinstance(split["device_busy_s"], float):
        raise AssertionError("the profiler recorded no device time in the "
                             "decode window")
    split.pop("top_kernels", None)
    split.update(kernel_device_ms(prof, DECODE_MARKS))
    split["step_device_ms"] = {k: v / WINDOW_STEPS
                               for k, v in split["device_ms"].items()}
    if isinstance(split["device_busy_s"], float):
        split["busy_ms_a_step"] = 1e3 * split["device_busy_s"] / WINDOW_STEPS
    rec["profile"] = split
    if graph and paged and not split["device_calls"]["paged_attention"]:
        raise AssertionError("the profiler named no paged_attention kernel "
                             "under the graph replays")
    if graph:
        rec["logits_bitwise"] = logits_gate(engine)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return rec


def logits_gate(engine) -> bool:
    """From the engine's state (all slots live), ``last`` of the eager
    step against ``last`` of one replay from the same state: snapshot the
    tensors the step reads and writes, run ``_decode`` eagerly, restore
    them, replay.  Raises unless bitwise equal."""
    import torch

    cache = engine.cache
    state = [engine.tok, cache.index, *cache.k, *cache.v] + (
        [cache.table] if cache.paged else [])
    saved = [t.clone() for t in state]
    with torch.no_grad():
        want = engine._decode().clone()
    for t, v in zip(state, saved):
        t.copy_(v)
    got = engine._graph.replay().clone()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"a replay's logits differ from the eager "
                             f"step's by up to {diff}")
    return True


def run_server(model, prompts, new_tokens: int, quant_int8: bool) -> dict:
    """Serve ``prompts`` greedily through a fresh paged ``Server`` (after
    one uncounted warm-up request of two decode steps: with the decode
    graph, its warm-up and its capture), check completion, the prefix hit
    and the attention kernels' counts, and profile a second pass."""
    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.serving import SlotDecodeEngine

    graph = SlotDecodeEngine._decode_graph
    with mt.Server(model, max_batch=8, kv_page_size=16, paged_kernel=True,
                   quant_int8=quant_int8, device=model.device) as server:
        # Warm-up requests, not counted: two decode steps (cuBLAS
        # handles; with the graph, its warm-up and its capture, which
        # empties the allocator's cache), then, in both modes, one prefill
        # as long as each timed prompt and sharing no block with it, so
        # that the timed pass meets no shape for the first time.
        server.complete(prompts[0][:3], 3, timeout=600)
        captured = server.engine._graph
        if graph != (captured is not None and captured.capture_s is not None):
            raise AssertionError(f"decode graph {graph}, captured "
                                 f"{captured is not None}")
        for p in prompts:
            server.complete((p + 1) % model.vocab_size, 1, timeout=600)
        before = server.metrics.snapshot()
        steps_before = before["decode_steps_total"]
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [server.submit(p, new_tokens) for p in prompts]
        outs = [s.result(timeout=900) for s in streams]
        wall = time.perf_counter() - t0
        snap = settled_snapshot(server, before, len(prompts) * new_tokens)
        counts = mt.launch_counts()
        step_secs = list(server.metrics._step_secs)
        prefill_ms = [1e3 * t for t in
                      list(server.metrics._prefill_secs)[-len(prompts):]]
        profile = profile_serving(server, prompts)
    reqs = [s.request for s in streams]
    if not all(r.state == "done" and len(r.tokens) == new_tokens
               for r in reqs):
        raise AssertionError(f"not every request completed: "
                             f"{[(r.state, len(r.tokens)) for r in reqs]}")
    hits = [r.prefix_hit_tokens for r in reqs]
    if hits[5] != 256:
        raise AssertionError(f"expected a 256-token prefix hit, got {hits}")
    steps = snap["decode_steps_total"] - steps_before
    full = [len(p) for p, h in zip(prompts, hits) if h == 0]
    want_flash = model.depth * sum(
        1 for n in full if min(1 << (n - 1).bit_length(), model.max_len) >= 128)
    if counts["flash_fwd"] < want_flash or want_flash < 5 * model.depth:
        raise AssertionError(f"flash_fwd launched {counts['flash_fwd']}x, "
                             f"expected >= {want_flash}")
    if counts["paged_attention"] != model.depth * steps or steps == 0:
        raise AssertionError(
            f"paged_attention launched {counts['paged_attention']}x over "
            f"{steps} decode steps of {model.depth} layers")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    return dict(
        quant_int8=quant_int8, requests=len(reqs), new_tokens=new_tokens,
        prefix_hit_tokens=hits, wall_s=wall,
        tokens_per_s=len(reqs) * new_tokens / wall,
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        prefill_ms=prefill_ms,
        decode_step_mean_ms=1e3 * sum(step_secs[-steps:]) / steps,
        decode_steps=steps, launches=counts, profile=profile, outs=outs,
        graph=graph,
        capture_s=captured.capture_s if graph else None,
        capture_bytes=captured.capture_bytes if graph else None,
    )


def replay_int8(model, prompts, outs, new_tokens: int,
                gate_quality: bool) -> dict:
    """Teacher-forced replay of an int8 serving run through the plain
    versions: each prompt prefilled fp32 into a batch-1 cache (as served:
    prompt K/V are the fp32 model's), then the served tokens fed one at a
    time through the S == 1 step twice, with the int8 collection (plain
    int8 matmul, plain attention) and in fp32.  Every served token must
    be within LOGIT_SLACK of the int8 step's best logit.  The relative
    logit error is the reference's, max|l_fp - l_q| / max|l_fp| over the
    whole replay; with ``gate_quality`` it must be <= INT8_LOGIT_REL and
    the argmax agreement >= INT8_AGREEMENT."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    dev = model.device
    quant = mt.quantize_tree(model)
    gap = diff = peak = 0.0
    agree = total = 0
    model.attention_impl = "xla"
    try:
        with torch.no_grad():
            for p, seq in zip(prompts, outs):
                n = len(p)
                ids = torch.as_tensor(seq.astype(np.int64), device=dev)[None]
                at = torch.tensor([n - 1], device=dev)
                cq, cf = model.new_cache(1), model.new_cache(1)
                first = model(ids[:, :n], cq, select=at)
                model(ids[:, :n], cf, select=at)
                gap = max(gap, (first.max() - first[0, ids[0, n]]).item())
                for j in range(n, n + new_tokens - 1):
                    tok = ids[:, j:j + 1]
                    lq = model(tok, cq, quant=quant,
                               quant_impl="reference")[:, 0]
                    lf = model(tok, cf)[:, 0]
                    if not (torch.isfinite(lq).all()
                            and torch.isfinite(lf).all()):
                        raise AssertionError("non-finite logits in the replay")
                    gap = max(gap, (lq.max() - lq[0, ids[0, j + 1]]).item())
                    diff = max(diff, (lf - lq).abs().max().item())
                    peak = max(peak, lf.abs().max().item())
                    agree += int(lq.argmax() == lf.argmax())
                    total += 1
    finally:
        model.attention_impl = "auto"
    if not gap <= LOGIT_SLACK:
        raise AssertionError(f"an int8-served token is {gap} below the best "
                             f"int8 logit (> {LOGIT_SLACK})")
    rel, agreement = diff / peak, agree / total
    if gate_quality:
        check_quality(rel, agreement, "int8 serving replay")
    return dict(worst_logit_gap=gap, int8_vs_fp32_rel_logit_err=rel,
                int8_vs_fp32_argmax_agreement=agreement,
                replayed_steps=total)


def check_quality(rel: float, agreement: float, what: str) -> None:
    if not rel <= INT8_LOGIT_REL:
        raise AssertionError(f"{what}: int8 vs fp32 relative logit error "
                             f"{rel} > {INT8_LOGIT_REL}")
    if not agreement >= INT8_AGREEMENT:
        raise AssertionError(f"{what}: int8 vs fp32 argmax agreement "
                             f"{agreement} < {INT8_AGREEMENT}")


# The JAX package's int8 quality gate (tests/test_kernels.py::
# test_int8_quality_gate) at full width.  Random weights leave the top-1
# logits near-tied, and through 12 layers of random projections the int8
# logits land a few percent of max|logit| off the fp32 ones (2.2% at 6
# layers of width 768, a CPU measurement), so the gate runs on a model
# with real margins made as the reference makes its own: GPT-2 124M
# trained by the port's Trainer on a successor map, here over 256 tokens
# of the vocabulary.  Then (1) the reference's gate on a full forward
# (int8 through K7 vs fp32) and (2) an int8 Server run over successor
# chains whose replay (``replay_int8``) must pass the same two bounds.
QGATE = dict(tokens=256, seq_len=64, size=512, val_size=32, epochs=5,
             batch_size=16, lr=1e-3, new_tokens=16,
             prompt_lens=[5, 17, 33, 64, 100, 200, 300, 500])
QGATE_DIR = "build/chip_smoke_qgate"  # model.pth of the run; removed after


def quality_gate(dev, config="gpt2") -> dict:
    import shutil

    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data.datasets import ArrayDataset

    c = QGATE
    rng = np.random.default_rng(SEED + 40)
    model = _seeded_model(config, seed=SEED + 40, device=dev)
    vocab = rng.choice(model.vocab_size, c["tokens"], replace=False)
    succ = np.zeros(model.vocab_size, np.int64)
    succ[vocab] = vocab[rng.permutation(c["tokens"])]

    def chains(n: int, length: int) -> np.ndarray:
        out = np.zeros((n, length), np.int64)
        out[:, 0] = rng.choice(vocab, n)
        for t in range(1, length):
            out[:, t] = succ[out[:, t - 1]]
        return out

    def dataset(n: int) -> ArrayDataset:
        data = chains(n, c["seq_len"]).astype(np.int32)
        return ArrayDataset(data, np.roll(data, -1, axis=1))

    _discard(QGATE_DIR)
    t0 = time.perf_counter()
    trainer = mt.Trainer(
        model, datasets=(dataset(c["size"]), dataset(c["val_size"])),
        epochs=c["epochs"], batch_size=c["batch_size"], optimizer="adamw",
        lr=c["lr"], grad_clip_norm=1.0, metric=None, seed=SEED,
        model_dir=QGATE_DIR, device=dev,
        steps_per_execution=4)  # the same steps, 4 a graph replay
    fit_whole(trainer, "int8 quality gate")
    train_s = time.perf_counter() - t0
    _discard(QGATE_DIR)
    model.eval()

    toks = torch.as_tensor(chains(8, c["seq_len"]), device=dev)
    with torch.no_grad():
        lf = model(toks)
        lq = model(toks, quant=mt.quantize_tree(model))
    full = dict(
        rel_logit_err=((lf - lq).abs().max() / lf.abs().max()).item(),
        argmax_agreement=(lf.argmax(-1) == lq.argmax(-1)).float().mean()
        .item())
    check_quality(full["rel_logit_err"], full["argmax_agreement"],
                  "full forward")

    prompts = [chains(1, n)[0].astype(np.int32) for n in c["prompt_lens"]]
    with mt.Server(model, max_batch=8, kv_page_size=16, paged_kernel=True,
                   quant_int8=True, device=dev) as server:
        streams = [server.submit(p, c["new_tokens"]) for p in prompts]
        outs = [st.result(timeout=600) for st in streams]
    served = replay_int8(model, prompts, outs, c["new_tokens"],
                         gate_quality=True)
    return dict(train_s=train_s, history={
        k: trainer.history[k] for k in ("train_loss", "val_loss")},
        full_forward=full, served=served)


def device_split(prof, wall: float) -> dict:
    """Device-busy time of a profiled window (the sum of the device's own
    events: kernels, copies, sets; the host ops' device totals would count
    the same kernels again) against its wall time, with the kernels that
    took the most.  "not measured" when the profiler saw no device time."""
    from torch.autograd import DeviceType

    rows = []
    for evt in _averages(prof):
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {
        "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "device_events": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                        for us, k, n in rows[:10]],
    }


def settled_snapshot(server, before: dict, tokens: int) -> dict:
    """The server's metrics once its worker has recorded the prefills and
    decode steps that emitted ``tokens`` tokens (each prefill's first
    token counted) since the snapshot ``before``."""
    deadline = time.monotonic() + 60
    while True:
        snap = server.metrics.snapshot()
        if snap["tokens_total"] - before["tokens_total"] >= tokens:
            return snap
        if time.monotonic() > deadline:
            raise AssertionError(
                f"the server recorded {snap['tokens_total']} tokens, "
                f"expected {before['tokens_total'] + tokens}")
        time.sleep(1e-3)


def profile_serving(server, prompts, new_tokens: int = 16) -> dict:
    """Serve the same prompts again under ``torch.profiler`` and split
    the wall time into device-busy time (the serving path runs one
    stream) and idle time (``device_split``), with K6's and K7's device
    ms by kernel name, in all and per decode step of the pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = server.metrics.snapshot()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streams = [server.submit(p, new_tokens) for p in prompts]
        for st in streams:
            st.result(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = device_split(prof, wall)
    steps = settled_snapshot(server, before, len(prompts) * new_tokens)[
        "decode_steps_total"] - before["decode_steps_total"]
    split["decode_steps"] = steps
    split.update(kernel_device_ms(prof, DECODE_MARKS))
    split["decode_step_device_ms"] = {
        k: v / steps for k, v in split["device_ms"].items()} if steps else None
    return split


# ------------------------------------------------------------- phase 5
TRAIN = dict(model="gpt2", seq_len=1024, vocab_size=50257, batch_size=8,
             accum=4, steps=6, val_batches=2)
# Kernel path vs plain path (model.attention_impl="xla") on the first
# microbatch, float32: the loss within LOSS_RTOL, and each parameter's
# gradient within GRAD_RTOL of that parameter's largest plain gradient
# (the two paths sum over keys in another order, through 12 layers).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
# The same in bf16 (the policy's casts, the bf16 K1-K3).  There the plain
# path is the kernels' own plain versions (flash_attention_reference and
# the plain backward, P in float32 as in the kernels), not the plain
# attention, which rounds P to bf16 before PV (JAX's dot_product_
# attention): another function.  The loss within BF16_LOSS_RTOL of the
# plain path's.  The gradients are held against the plain versions run
# with float64 math inside ("exact attention"): every activation rounds
# to 8 significant bits, so any float32-level difference in the
# attention moves some values by a bf16 ulp, and 12 layers carry that
# to ~2% of a leaf's largest gradient (PERF.md §6: the float32 plain
# path is itself 2.06% (BERT-base) and 1.5% (GPT-2 124M) from exact
# attention on the card).  So each leaf of the kernel path must lie
# within 2e-2 of its largest exact-attention entry (the JAX package's
# own bf16 bar, tests/test_attention.py), or within BF16_NOISE_FACTOR
# times the float32 plain path's own worst distance from exact
# attention in the same run.
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_NOISE_FACTOR = 2e-3, 2e-2, 1.5
# The first bf16 loss against the fp32 run's first loss, same weights
# and batch.
BF16_VS_FP32_RTOL = 2e-2
TRAIN_DIR = "build/chip_smoke_train"  # model.pth of the run; removed after


def _worst_leaf(got: dict, want: dict):
    """(worst ratio, leaf): max |got - want| of a leaf against the leaf's
    largest ``want`` entry, over the leaves."""
    import torch

    worst, worst_name = 0.0, None
    for name, w in want.items():
        if got[name].dtype != torch.float32:
            raise AssertionError(f"gradient of {name} is {got[name].dtype}")
        ratio = ((got[name] - w).abs().max() / w.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def grad_check(trainer, x, y) -> dict:
    """Loss and every parameter gradient of one microbatch through the
    kernels and through the plain path (fp32: the plain attention; bf16:
    the kernels' plain versions, taken on the card by routing the
    attention Function as for a CPU tensor, and those with float64 math
    inside), each through the trainer's loss function (its precision
    policy's casts); float32 gradients either way.  Bars by the
    trainer's policy (``BF16_*`` above)."""
    import contextlib
    import importlib
    from unittest import mock

    import torch

    tatt = importlib.import_module("ml_trainer_tpu_torch.ops.attention")
    bf16 = trainer.precision.active
    model = trainer.model
    runs = ("auto", "xla") + (("exact",) if bf16 else ())
    out = {}
    for impl in runs:
        route = contextlib.ExitStack()
        if bf16:
            model.attention_impl = "auto"
            if impl != "auto":
                route.enter_context(mock.patch.object(
                    tatt, "_device_kind", lambda q: "cpu"))
            if impl == "exact":
                route.enter_context(mock.patch.object(
                    tatt, "_compute_dtype", lambda q: torch.float64))
        else:
            model.attention_impl = impl
        model.zero_grad(set_to_none=True)
        with route:
            loss = trainer._forward_loss(x, y)[0]
            loss.backward()
        out[impl] = (loss.item(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()})
    model.attention_impl = "auto"
    model.zero_grad(set_to_none=True)
    (l_k, g_k), (l_p, g_p) = out["auto"], out["xla"]
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    if not abs(l_k - l_p) <= loss_rtol * abs(l_p):
        raise AssertionError(f"kernel-path loss {l_k} vs plain {l_p}")
    worst, worst_name = _worst_leaf(g_k, g_p)
    rec = {}
    if bf16:
        g_x = out["exact"][1]
        k_exact, k_name = _worst_leaf(g_k, g_x)
        p_exact, p_name = _worst_leaf(g_p, g_x)
        bar = max(BF16_GRAD_RTOL, BF16_NOISE_FACTOR * p_exact)
        rec = dict(loss_exact=out["exact"][0], kernel_vs_exact=k_exact,
                   kernel_vs_exact_param=k_name, plain_vs_exact=p_exact,
                   plain_vs_exact_param=p_name, grad_bar=bar)
        if not k_exact <= bar:
            raise AssertionError(
                f"gradient of {k_name}: {k_exact} of its largest "
                f"exact-attention entry > {bar} (the float32 plain path: "
                f"{p_exact})")
    elif not worst <= GRAD_RTOL:
        raise AssertionError(
            f"gradient of {worst_name}: max diff {worst} of its largest "
            f"plain entry > {GRAD_RTOL}")
    qkv = [n for n in g_k if n.endswith("attn.qkv.weight")]  # a layer each
    if len(qkv) != model.depth:
        raise AssertionError(f"{len(qkv)} qkv weights for depth "
                             f"{model.depth}")
    for n in qkv:
        if not bool((g_k[n] != 0).any()):
            raise AssertionError(f"{n}: zero gradient")
    del g_k, g_p
    torch.cuda.empty_cache()
    return dict(precision=trainer.precision.label(), loss_kernel=l_k,
                loss_plain=l_p, worst_grad_ratio=worst,
                worst_grad_param=worst_name, **rec)


def loss_scale_record(trainer):
    """The run's loss scale, its finite-step counter and the rollback
    streak (None without loss scaling)."""
    state = trainer.state
    if state.loss_scale is None:
        return None
    return dict(loss_scale=state.loss_scale.item(),
                good_steps=int(state.good_steps),
                bad_streak=int(state.bad_streak))


def profile_step(trainer, x, y) -> dict:
    """One optimizer step under ``torch.profiler``, split into
    device-busy and idle time (``device_split``; the step's kernels run
    on one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_step(x, y, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = device_split(prof, wall)
    split.update(kernel_device_ms(prof, ATTN_MARKS))
    return split


def train(dev, precision=None, fp32_first_loss=None):
    """GPT-2 124M through ``Trainer(...).fit()``: the real config of
    examples/04_gpt2_pretrain.py (seq 1024, global batch 8 in 4
    microbatches, adamw 3e-4 / wd 0.01, cosine restarts, clip 1.0,
    accuracy), one epoch of 6 optimizer steps and 2 validation batches;
    fp32, or ``precision="bf16"`` (the bf16 K1-K3, dynamic loss scale),
    whose first microbatch loss is then held to the fp32 run's
    ``fp32_first_loss`` from the same weights and batch."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    c = TRAIN
    _discard(TRAIN_DIR)
    sets = (
        mt.SyntheticTokens(size=c["batch_size"] * c["steps"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED),
        mt.SyntheticTokens(size=c["batch_size"] * c["val_batches"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED + 1),
    )
    t0 = time.perf_counter()
    trainer = mt.Trainer(
        c["model"], datasets=sets, epochs=1, batch_size=c["batch_size"],
        grad_accum_steps=c["accum"], optimizer="adamw", lr=3e-4,
        weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
        grad_clip_norm=1.0, metric="accuracy", model_dir=TRAIN_DIR,
        seed=SEED, device=dev, precision=precision)
    model = trainer.model
    bf16 = trainer.precision.active
    log(f"train: Trainer({c['model']}, precision={precision}) built in "
        f"{time.perf_counter() - t0:.2f}s")
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    micro = c["batch_size"] // c["accum"]
    check = grad_check(trainer, x[:micro], y[:micro])
    if fp32_first_loss is not None:
        check["loss_fp32"] = fp32_first_loss
        rel = abs(check["loss_kernel"] - fp32_first_loss) / fp32_first_loss
        check["loss_vs_fp32_rel"] = rel
        if not rel <= BF16_VS_FP32_RTOL:
            raise AssertionError(f"first bf16 loss {check['loss_kernel']} "
                                 f"vs fp32 {fp32_first_loss}")
    log("train: first microbatch, kernels vs plain " + json.dumps(check))

    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, f"train ({precision})")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]):
        raise AssertionError(f"non-finite losses: {hist}")
    if hist["skipped_steps"] != [0]:
        raise AssertionError(f"skipped steps: {hist['skipped_steps']}")
    n_micro = c["steps"] * c["accum"]
    want = {"flash_fwd": model.depth * (n_micro + c["val_batches"]),
            "flash_bwd_dq": model.depth * n_micro,
            "flash_bwd_dkv": model.depth * n_micro, "paged_attention": 0,
            "int8_matmul": 0, "unscale_sqsum": 0, "fused_adam": 0}
    if counts != want:
        raise AssertionError(f"training launches {counts}, expected {want}")
    scale = loss_scale_record(trainer)

    # Optimizer-step time: CUDA events around steps on one batch (the
    # run above includes loading, validation and the weights' export).
    # In bf16 the warm-up step runs under the per-call check.
    n_time = 3
    calls = train_call_check(trainer, x, y, model.depth * c["accum"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_time):
        trainer._train_step(x, y, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_time
    profile = profile_step(trainer, x, y)
    profile["bound_ms"] = attn_step_bounds(model.depth * c["accum"], bf16)
    _discard(TRAIN_DIR)
    return dict(
        precision=trainer.precision.label(),
        history={k: hist[k] for k in ("train_loss", "val_loss",
                                      "train_metric", "val_metric",
                                      "skipped_steps")},
        fit_s=fit_s, launches=counts, step_ms=step_ms,
        tokens_per_s=c["batch_size"] * c["seq_len"] / (step_ms / 1e3),
        max_memory_allocated_bytes=peak, grad_check=check,
        call_check=calls, loss_scale=scale, profile=profile)


def train_call_check(trainer, x, y, launches: int):
    """One optimizer step on ``(x, y)``; in bf16 under ``capture_calls``,
    with every K1, K2 and K3 call (``launches`` of each: the step's
    microbatches times the layers) held to the float64 JAX function by
    ``call_check``.  None in float32 (the step runs as it is)."""
    if not trainer.precision.active:
        trainer._train_step(x, y, 1.0)
        return None
    with capture_calls() as calls:
        trainer._train_step(x, y, 1.0)
    got = {k: sum(1 for c in calls if c[0] == k)
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if got != dict.fromkeys(got, launches):
        raise AssertionError(f"per-call check captured {got}, expected "
                             f"{launches} of each")
    rec = call_check(calls)
    del calls
    return rec


# ------------------------------------------------------------- phase 6
# K4/K5 at the shapes the 2-replica GPT-2 124M step gives them.  The main
# row, ``step_list``, is one step's lists: each replica's 148 leaves (the
# dim-0 shards of the sharded leaves, the whole of tok_embed and
# pos_embed) as ``plan_grad_buckets`` splits them, one launch of each
# kernel per replica.  Then one-leaf rows: the replicated tok_embed, the
# shards of qkv.weight, fc_out.weight and a [768] bias, and ragged sizes.
FUSED_CASES = [("tok_embed", (50257, 768)), ("qkv_shard", (1152, 768)),
               ("fc_out_shard", (384, 3072)), ("bias_shard", (384,)),
               ("ragged_7", (7,)), ("ragged_4097", (4097,)),
               ("ragged_3x5x7", (3, 5, 7))]
SQ_RTOL = 1e-5  # K4's sums vs torch.sum: float32 sums in another order
# K4 (two kernels) and K5 by kernel name, as the profiler lists them.
FUSED_MARKS = {"unscale_sqsum": ("unscale_sqsum_list_kernel",
                                 "sum_leaves_kernel"),
               "fused_adam": ("fused_adam_list_kernel",)}


def _bitwise(what, got, want) -> None:
    import torch

    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{what}: leaf {i} not bitwise (max abs err "
                f"{(a - b).abs().max().item()})")


def _sums_close(what, got, want) -> float:
    """K4's sums within SQ_RTOL relative of the plain ones; the largest
    absolute difference."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        d = abs(a.item() - b.item())
        if not d <= SQ_RTOL * abs(b.item()):
            raise AssertionError(f"{what}: sum {i} {a.item()} vs plain "
                                 f"{b.item()}")
        err = max(err, d)
    return err


def dp_lists(dev, n: int):
    """The sharded step's per-replica leaf shapes and ``sharded`` flags for
    GPT-2 124M over ``n`` replicas (the trainer's ``plan_grad_buckets``)."""
    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.parallel.sharding import plan_grad_buckets

    params = dict(mt.get_model(DP["model"], device=dev).named_parameters())
    plan = plan_grad_buckets(params, n)
    shapes = [(p.shape[0] // n,) + tuple(p.shape[1:]) if sh
              else tuple(p.shape)
              for p, sh in zip(params.values(), plan.sharded)]
    return shapes, list(plan.sharded)


def check_fused_list(dev) -> dict:
    """The ``step_list`` row: one 2-replica GPT-2 124M step's lists, one
    launch of K4 and one of K5 per replica.  K4's quotients bitwise, each
    leaf's sum and sq_loc/sq_rep within SQ_RTOL relative (immediate and
    device-scalar denominators); K5 bitwise with and without the clip
    factor; two calls bitwise.  Timed per step (both replicas): CUDA
    graph replays (``ms``, device time with no host cost), eager calls
    (``ms_eager``, the host's rate), profiler device time of the kernels
    (``device_ms``); beside the plain versions, ``torch._foreach_norm``
    over the same lists (K4) and one ``torch._fused_adam_`` over the same
    lists (K5), both timed only."""
    import math

    import torch

    from ml_trainer_tpu_torch.ops.kernels.fused_adam import (
        fused_adam_update_list, unscale_sqsum_list)

    n = DP["replicas"]
    shapes, flags = dp_lists(dev, n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)

    def make(scale, fn=torch.randn):
        return [[fn(s, generator=gen, device=dev) * scale for s in shapes]
                for _ in range(n)]

    g, p, mu = make(1e-3), make(0.02), make(1e-4)
    nu = make(1e-7, torch.rand)
    elems = n * sum(math.prod(s) for s in shapes)
    err4 = 0.0
    for denom in (4.0, torch.tensor(6.0, device=dev)):
        for j in range(n):
            runs = [unscale_sqsum_list(g[j], denom, sharded=flags)
                    for _ in range(2)]
            want = unscale_sqsum_list(g[j], denom, sharded=flags,
                                      implementation="reference")
            torch.cuda.synchronize()
            what = f"unscale_sqsum step_list replica {j}"
            _bitwise(what, runs[0][0], want[0])
            _bitwise(what + " (two calls)", runs[0][0], runs[1][0])
            _bitwise(what + " sums (two calls)",
                     runs[0][1] + list(runs[0][2]),
                     runs[1][1] + list(runs[1][2]))
            err4 = max(err4, _sums_close(what, runs[0][1], want[1]),
                       _sums_close(what + " sq_loc/sq_rep", runs[0][2],
                                   want[2]))
    scal = dict(bc1=torch.tensor(0.271, device=dev),
                bc2=torch.tensor(0.002997, device=dev),
                step_size=torch.tensor(-3e-4, device=dev), lr_scale=1.0)
    for factor in (None, torch.tensor(0.37, device=dev)):
        for j in range(n):
            runs = [fused_adam_update_list(g[j], p[j], mu[j], nu[j],
                                           factor=factor, **scal)
                    for _ in range(2)]
            want = fused_adam_update_list(g[j], p[j], mu[j], nu[j],
                                          factor=factor,
                                          implementation="reference", **scal)
            torch.cuda.synchronize()
            for k, out in enumerate(("p", "mu", "nu", "u")):
                what = (f"fused_adam step_list replica {j} factor="
                        f"{factor is not None} {out}")
                _bitwise(what, runs[0][k], want[k])
                _bitwise(what + " (two calls)", runs[0][k], runs[1][k])
            del runs, want

    factor = torch.tensor(0.37, device=dev)

    def k4(impl="auto"):
        for j in range(n):
            unscale_sqsum_list(g[j], 4.0, sharded=flags, implementation=impl)

    def k5(impl="auto"):
        for j in range(n):
            fused_adam_update_list(g[j], p[j], mu[j], nu[j], factor=factor,
                                   implementation=impl, **scal)

    flat = [t for j in range(n) for t in g[j]]
    lib_p, lib_mu, lib_nu = ([t.clone() for j in range(n) for t in x[j]]
                             for x in (p, mu, nu))
    lib_steps = [torch.zeros((), dtype=torch.float32, device=dev)
                 for _ in flat]

    def lib_adam():
        torch._fused_adam_(lib_p, flat, lib_mu, lib_nu, [], lib_steps,
                           lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    b4 = bound_ms(8.0 * elems + 8 * n, 2.0 * elems)
    b5 = bound_ms(32.0 * elems + 20 * n, 15.0 * elems)
    lib5 = bound_ms(28.0 * elems, 15.0 * elems)
    rows = {
        "unscale_sqsum": dict(
            case="step_list", replicas=n, leaves=len(shapes),
            elements_per_step=elems, launches_per_step=n,
            ms=time_graph_ms(k4, [()], iters=4),
            ms_eager=time_ms(k4, iters=10, warmup=2),
            device_ms=profiled_ms(k4, FUSED_MARKS["unscale_sqsum"], 5),
            plain_ms=time_ms(lambda: k4("reference"), iters=3, warmup=1),
            library_ms=None,
            foreach_norm_ms=time_ms(lambda: torch._foreach_norm(flat),
                                    iters=10, warmup=2),
            bound_ms=b4[0], bound_by=b4[1], max_abs_err=err4),
        "fused_adam": dict(
            case="step_list", replicas=n, leaves=len(shapes),
            elements_per_step=elems, launches_per_step=n,
            ms=time_graph_ms(k5, [()], iters=4),
            ms_eager=time_ms(k5, iters=10, warmup=2),
            device_ms=profiled_ms(k5, FUSED_MARKS["fused_adam"], 5),
            plain_ms=time_ms(lambda: k5("reference"), iters=3, warmup=1),
            library_ms=time_ms(lib_adam, iters=10, warmup=2),
            library_device_ms=profiled_ms(lib_adam, ("",), 5),
            library_bound_ms=lib5[0],
            bound_ms=b5[0], bound_by=b5[1], max_abs_err=0.0),
    }
    for kname, row in rows.items():
        log(f"kernel {kname} " + json.dumps(row))
    del g, p, mu, nu, flat, lib_p, lib_mu, lib_nu
    torch.cuda.empty_cache()
    return rows


def check_fused_adam(dev):
    """The ``step_list`` row (``check_fused_list``), then the one-leaf
    rows: K4 against its plain version for an immediate and a
    device-scalar denominator (4 and 6: a power of two and not), with and
    without the sum: the quotient bitwise, the sum within SQ_RTOL; K5
    with and without the clip factor: all four outputs bitwise; every
    call bitwise across two calls.  Timed with CUDA events beside the
    plain versions, ``torch._foreach_norm`` (K4, timed only; no one
    PyTorch call divides and sums) and ``torch._fused_adam_`` (K5, timed
    only: its bias correction and schedule placement differ, and the port
    never calls it)."""
    import torch

    from ml_trainer_tpu_torch.ops.kernels.fused_adam import (
        fused_adam_update, unscale_sqsum)

    first = check_fused_list(dev)
    rows = {k: [v] for k, v in first.items()}
    gen = torch.Generator(device="cpu").manual_seed(SEED + 50)
    for name, shape in FUSED_CASES:
        g = (torch.randn(shape, generator=gen) * 1e-3).to(dev)
        p = (torch.randn(shape, generator=gen) * 0.02).to(dev)
        mu = (torch.randn(shape, generator=gen) * 1e-4).to(dev)
        nu = (torch.rand(shape, generator=gen) * 1e-7).to(dev)
        n = g.numel()
        err4 = 0.0
        for denom in (4.0, torch.tensor(6.0, device=dev)):
            for compute_sq in (True, False):
                got = unscale_sqsum(g, denom, compute_sq=compute_sq)
                again = unscale_sqsum(g, denom, compute_sq=compute_sq)
                want = unscale_sqsum(g, denom, compute_sq=compute_sq,
                                     implementation="reference")
                torch.cuda.synchronize()
                _bitwise(f"unscale_sqsum {name}", [got[0]], [want[0]])
                _bitwise(f"unscale_sqsum {name} (two calls)",
                         [got[0]] + ([got[1]] if compute_sq else []),
                         [again[0]] + ([again[1]] if compute_sq else []))
                if compute_sq:
                    err4 = max(err4, _sums_close(f"unscale_sqsum {name}",
                                                 [got[1]], [want[1]]))
                elif got[1] is not None:
                    raise AssertionError("compute_sq=False returned a sum")
        scal = dict(bc1=torch.tensor(0.271, device=dev),
                    bc2=torch.tensor(0.002997, device=dev),
                    step_size=torch.tensor(-3e-4, device=dev), lr_scale=1.0)
        for factor in (None, torch.tensor(0.37, device=dev)):
            got = fused_adam_update(g, p, mu, nu, factor=factor, **scal)
            again = fused_adam_update(g, p, mu, nu, factor=factor, **scal)
            want = fused_adam_update(g, p, mu, nu, factor=factor,
                                     implementation="reference", **scal)
            torch.cuda.synchronize()
            what = f"fused_adam {name} factor={factor is not None}"
            _bitwise(what, got, want)
            _bitwise(what + " (two calls)", got, again)
        main = name == "tok_embed"
        iters = 20 if main else 50
        k4 = time_ms(lambda: unscale_sqsum(g, 4.0), iters=iters)
        k4_plain = time_ms(lambda: unscale_sqsum(
            g, 4.0, implementation="reference"), iters=iters)
        norm = time_ms(lambda: torch._foreach_norm([g]), iters=iters)
        factor = torch.tensor(0.37, device=dev)
        k5 = time_ms(lambda: fused_adam_update(g, p, mu, nu, factor=factor,
                                               **scal), iters=iters)
        k5_plain = time_ms(lambda: fused_adam_update(
            g, p, mu, nu, factor=factor, implementation="reference", **scal),
            iters=iters)
        lib_p, lib_mu, lib_nu = p.clone(), mu.clone(), nu.clone()
        lib_step = torch.zeros((), dtype=torch.float32, device=dev)
        lib = time_ms(lambda: torch._fused_adam_(
            [lib_p], [g], [lib_mu], [lib_nu], [], [lib_step], lr=3e-4,
            beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
            amsgrad=False, maximize=False), iters=iters)
        b4 = bound_ms(8.0 * n + 4, 2.0 * n)
        b5 = bound_ms(32.0 * n + 20, 15.0 * n)
        rows["unscale_sqsum"].append(dict(
            case=name, shape=list(shape), max_abs_err=err4, ms=k4,
            plain_ms=k4_plain, library_ms=None, foreach_norm_ms=norm,
            bound_ms=b4[0], bound_by=b4[1]))
        rows["fused_adam"].append(dict(
            case=name, shape=list(shape), max_abs_err=0.0, ms=k5,
            plain_ms=k5_plain, library_ms=lib, bound_ms=b5[0],
            bound_by=b5[1]))
        for kname in ("unscale_sqsum", "fused_adam"):
            log(f"kernel {kname} " + json.dumps(rows[kname][-1]))
        del g, p, mu, nu, lib_p, lib_mu, lib_nu
        torch.cuda.empty_cache()
    return rows


# Data-parallel training: GPT-2 124M, 2 replicas on the one card,
# examples/04_gpt2_pretrain.py's config except the optimizer (below).
DP = dict(model="gpt2", seq_len=1024, vocab_size=50257, batch_size=8,
          replicas=2, accum=2, steps=6, val_batches=2)
DP_DIR = "build/chip_smoke_dp"  # model.pth of the run; removed after
DP_LOSS_RTOL = 1e-5
DP_KERNEL_ATOL = 1e-6  # sharded plain vs K4/K5: the clip factor's rounding
DP_SINGLE_ATOL = 1e-3  # one card vs sharded: Adam's first step is ~±lr
# K1 to K5 by kernel name in the profiled step (K4 is two kernels).
DP_MARKS = dict(ATTN_MARKS, **FUSED_MARKS)
DP_BF16_STEPS = 3  # the bf16 run's optimizer steps


def _snapshot(trainer):
    from ml_trainer_tpu_torch.ops.optimizers import tree_map

    st = trainer.state
    scale = (None if st.loss_scale is None
             else (st.loss_scale.clone(), st.good_steps.clone()))
    return ({k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()},
            tree_map(lambda t: t.clone(), st.opt_state), scale)


def _restore(trainer, snap):
    from ml_trainer_tpu_torch.ops.optimizers import tree_map

    trainer.model.load_state_dict(snap[0])
    trainer.state.opt_state = tree_map(lambda t: t.clone(), snap[1])
    trainer.state.step = 0
    if snap[2] is not None:
        trainer.state.loss_scale, trainer.state.good_steps = (
            t.clone() for t in snap[2])


def dp_step_check(trainer, single, x, y) -> dict:
    """From one state and one batch: the single-card step (``single``,
    or None to skip it), the sharded step with the plain tail and the
    sharded step with K4/K5; with loss scaling, the scale after the
    step must be equal on both sharded paths."""
    import torch

    snap = _snapshot(trainer)
    out = {}
    runs = [("sharded_plain", trainer, False),
            ("sharded_kernels", trainer, True)]
    if single is not None:
        runs.insert(0, ("single", single, None))
    for name, tr, fused in runs:
        if fused is not None:
            tr.fused_adam = fused
        _restore(tr, snap)
        loss, _ = tr._train_step(x, y, 1.0)
        out[name] = (loss.item(), {k: v.detach().clone() for k, v in
                                   tr.model.state_dict().items()},
                     loss_scale_record(tr))
    trainer.fused_adam = True
    _restore(trainer, snap)
    (l_p, p_p, s_p), (l_k, p_k, s_k) = (out[k] for k in (
        "sharded_plain", "sharded_kernels"))
    rec = {}
    if single is not None:
        _restore(single, snap)
        l_1, p_1, _ = out["single"]
        if not abs(l_1 - l_p) <= DP_LOSS_RTOL * abs(l_p):
            raise AssertionError(f"single loss {l_1} vs sharded plain {l_p}")
        d_single = max((p_k[k] - p_1[k]).abs().max().item() for k in p_p)
        if not d_single <= DP_SINGLE_ATOL:
            raise AssertionError(f"sharded vs single-card params differ by "
                                 f"{d_single} > {DP_SINGLE_ATOL}")
        rec = dict(loss_single=l_1, max_param_diff_sharded_vs_single=d_single)
    if not abs(l_k - l_p) <= DP_LOSS_RTOL * abs(l_p):
        raise AssertionError(f"sharded K4/K5 loss {l_k} vs sharded plain "
                             f"{l_p}")
    if s_k != s_p:
        raise AssertionError(f"loss scale after the step: K4/K5 {s_k}, "
                             f"plain {s_p}")
    d_kernel = max((p_k[k] - p_p[k]).abs().max().item() for k in p_p)
    moved = max((p_k[k] - snap[0][k]).abs().max().item() for k in p_p)
    if not d_kernel <= DP_KERNEL_ATOL:
        raise AssertionError(f"sharded K4/K5 vs plain params differ by "
                             f"{d_kernel} > {DP_KERNEL_ATOL}")
    if not moved > 0:
        raise AssertionError("the step did not move the params")
    del out, snap
    torch.cuda.empty_cache()
    return dict(rec, loss_sharded_plain=l_p, loss_sharded_kernels=l_k,
                max_param_diff_kernels_vs_plain=d_kernel,
                max_param_move=moved, loss_scale_plain=s_p,
                loss_scale_kernels=s_k)


def dp_train(dev, precision=None, steps=None):
    """GPT-2 124M through ``Trainer(..., is_parallel=True,
    mesh_shape={"data": 2}, device=[cuda, cuda], dp_update="sharded")``:
    examples/04_gpt2_pretrain.py's config (seq 1024, SyntheticTokens,
    global batch 8 = 4 rows per replica in 2 microbatches, cosine
    restarts, clip 1.0), except ``optimizer="adam"`` with
    ``weight_decay=0``: the one configuration the fused tail (K4/K5)
    accepts, as in the JAX package.  6 optimizer steps (or ``steps``),
    2 validation batches; fp32 or ``precision="bf16"`` (the loss scale
    folded into K4's denominator; no single-card comparison)."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.parallel import comm_stats

    c = dict(DP, steps=steps or DP["steps"])
    _discard(DP_DIR)
    sets = (
        mt.SyntheticTokens(size=c["batch_size"] * c["steps"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED),
        mt.SyntheticTokens(size=c["batch_size"] * c["val_batches"],
                           seq_len=c["seq_len"], vocab_size=c["vocab_size"],
                           seed=SEED + 1),
    )
    kw = dict(datasets=sets, epochs=1, batch_size=c["batch_size"],
              grad_accum_steps=c["accum"], optimizer="adam", lr=3e-4,
              weight_decay=0.0, scheduler="CosineAnnealingWarmRestarts",
              grad_clip_norm=1.0, metric="accuracy", model_dir=DP_DIR,
              seed=SEED, precision=precision)
    t0 = time.perf_counter()
    trainer = mt.Trainer(c["model"], is_parallel=True,
                         mesh_shape={"data": c["replicas"]},
                         device=[dev] * c["replicas"], dp_update="sharded",
                         **kw)
    if not (trainer.fused_adam and trainer.dp_update == "sharded"
            and trainer.mesh.size == c["replicas"]):
        raise AssertionError("the data-parallel trainer did not take the "
                             "sharded step with the fused tail")
    model = trainer.model
    bf16 = trainer.precision.active
    single = None if bf16 else mt.Trainer(model, device=dev, **kw)
    log(f"dp: Trainer({c['model']}, precision={precision}) x "
        f"{c['replicas']} replicas built in {time.perf_counter() - t0:.2f}s")
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    check = dp_step_check(trainer, single, x, y)
    log("dp: one state, one batch " + json.dumps(check))
    del single

    plan, n = trainer._bucket_plan, c["replicas"]
    shapes = [p.shape for p in model.parameters()]
    # K4/K5 elements per step: each sharded leaf once over the replicas'
    # shards, each replicated leaf once per replica.
    elems = sum(s.numel() if sh else s.numel() * n
                for s, sh in zip(shapes, plan.sharded))
    torch.cuda.reset_peak_memory_stats()
    comm_stats.reset_comm_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, f"dp ({precision})")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]):
        raise AssertionError(f"non-finite losses: {hist}")
    if hist["skipped_steps"] != [0]:
        raise AssertionError(f"skipped steps: {hist['skipped_steps']}")
    leaves = len(shapes)
    n_micro = c["steps"] * n * c["accum"]
    want = {"flash_fwd": model.depth * (n_micro + c["val_batches"]),
            "flash_bwd_dq": model.depth * n_micro,
            "flash_bwd_dkv": model.depth * n_micro, "paged_attention": 0,
            "int8_matmul": 0, "unscale_sqsum": n * c["steps"],
            "fused_adam": n * c["steps"]}
    if counts != want:
        raise AssertionError(f"dp launches {counts}, expected {want}")
    scale = loss_scale_record(trainer)
    comm = {"bytes": comm_stats.comm_bytes(), "calls": comm_stats.comm_calls()}

    n_time = 3
    trainer._train_step(x, y, 1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_time):
        trainer._train_step(x, y, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_step(x, y, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = device_split(prof, wall)
    split.update(kernel_device_ms(prof, DP_MARKS))
    split["bound_ms"] = {
        "unscale_sqsum": bound_ms(8.0 * elems, 2.0 * elems)[0],
        "fused_adam": bound_ms(32.0 * elems, 15.0 * elems)[0],
        **attn_step_bounds(model.depth * n * c["accum"], bf16)}
    _discard(DP_DIR)
    return dict(
        precision=trainer.precision.label(), steps=c["steps"],
        loss_scale=scale,
        history={k: hist[k] for k in ("train_loss", "val_loss",
                                      "train_metric", "val_metric",
                                      "skipped_steps")},
        replicas=n, leaves=leaves, buckets=len(plan.buckets),
        overlap_fraction=plan.overlap_fraction,
        optimizer_elements_per_step=elems, fit_s=fit_s, launches=counts,
        expected_launches=(
            "K1 = depth x (steps x replicas x accum + val_batches), "
            "K2 = K3 = depth x steps x replicas x accum, "
            "K4 = K5 = replicas x steps (one launch per replica over "
            "its list of leaves)"),
        step_ms=step_ms,
        tokens_per_s=c["batch_size"] * c["seq_len"] / (step_ms / 1e3),
        max_memory_allocated_bytes=peak, step_check=check, comm=comm,
        profile=split)


# ------------------------------------------------------------- phase 7
# The image and encoder families through Trainer.fit at full width:
# (registry name, model kwargs, optimizer config, data, global batch,
# optimizer steps).  ResNet-18, ResNet-50 and BERT-base take examples 02
# and 05's configs, MLModel example 01's; ViT-B/16 (no example) adamw.
# The examples phase runs those configs end to end: 3-4 steps here.
# BERT-base runs fp32 and bf16 (``precision="bf16"``: the bf16 K1-K3);
# ViT-B/16 computes in bf16, its default, under the bf16 policy.
SGD_02 = dict(optimizer="sgd", momentum=0.9, lr=0.01)
BERT_05 = dict(optimizer="adamw", lr=2e-4, weight_decay=0.01)
MODEL_RUNS = [
    ("resnet18", {"cifar_stem": True}, SGD_02, "cifar", 256, 3),
    ("resnet50", {}, SGD_02, "imagenet", 64, 4),
    ("bert_base", {"right_padded": True}, BERT_05, "tokens", 32, 3),
    ("bert_base", {"right_padded": True}, dict(BERT_05, precision="bf16"),
     "tokens", 32, 3),
    ("vit_b16", {},
     dict(optimizer="adamw", lr=3e-4, weight_decay=0.1, precision="bf16"),
     "imagenet", 32, 4),
    ("mlmodel", {}, dict(optimizer="sgd", momentum=0.9, lr=0.001,
                         scheduler="CosineAnnealingWarmRestarts"),
     "cifar", 32, 4),
]
VAL_BATCHES = 1
IMAGES_224 = 256  # seeded uint8 224x224x3 images, 1000 classes
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BERT_DATA = dict(vocab_size=30522, seq_len=128, min_len=8, classes=2)
MODELS_DIR = "build/chip_smoke_models"  # each run's model.pth; removed after
# ResNet-18's first RESNET_ROWS rows through one training step on the card
# against the same step of the port on the CPU, from the same weights.
# The card's float64 step is held to the CPU's float64 step over the whole
# network: loss 1e-4 relative, every gradient 1e-3 of its largest entry,
# every running statistic 1e-4 of its largest entry.  The card's float32
# step (the training path, cuDNN's float32 algorithms) is held to the
# CPU's float64 loss and running statistics at the same bars, and layer by
# layer: each conv, BatchNorm and the head, recomputed in float64 on the
# CPU from the input and output gradient that the float32 step gave it,
# must match in output (1e-4), input and parameter gradients (1e-3) and
# running statistics (1e-4), each of its largest entry.  Whole-network
# float32 gradients are read but not held to a bar: rounding flips ReLU
# masks where a pre-activation sits within float32's rounding of zero (24
# of 17.8M on this batch on the CPU, 3 on 8 rows), and each flip puts an
# error the size of one position's gradient into a weight gradient whose
# terms BatchNorm's zero-mean backward mostly cancels: 2.9% of a leaf's
# largest entry on the card, with the float64 gradient moving 8e-7 under a
# 1e-7 relative change of the input.
RESNET_ROWS = 32
RESNET_LOSS_RTOL, RESNET_GRAD_RTOL, RESNET_STATS_RTOL = 1e-4, 1e-3, 1e-4


def model_sets(data: str, batch: int, steps: int,
               val_batches: int = VAL_BATCHES):
    """(train, validation) datasets of ``steps`` and ``val_batches``
    batches, made from ``SEED`` with numpy (images drawn IMAGES_224 at a
    time, or as many as a set needs when it needs more)."""
    import numpy as np

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import Compose, Normalize, ToFloat

    n, n_val = batch * steps, batch * val_batches
    if data == "cifar":
        pre = mt.custom_pre_process_function
        return (mt.SyntheticCIFAR10(size=n, transform=pre(), seed=SEED),
                mt.SyntheticCIFAR10(size=n_val, transform=pre(),
                                    seed=SEED + 1))
    if data == "imagenet":
        def images(size, seed):
            rng = np.random.default_rng(seed)
            pool = max(IMAGES_224, size)
            x = rng.integers(0, 256, size=(pool, 224, 224, 3),
                             dtype=np.uint8)[:size]
            y = rng.integers(0, 1000, size=pool).astype(np.int32)
            return mt.ArrayDataset(x, y[:size], Compose(
                [ToFloat(), Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
        return images(n, SEED), images(n_val, SEED + 1)
    c = BERT_DATA
    rng = np.random.default_rng(SEED)

    def tokens(size):
        # Real tokens in [1, vocab) so that the mask has no holes, then
        # right padding with 0 from each row's length in min_len..seq_len.
        s = c["seq_len"]
        ids = rng.integers(1, c["vocab_size"], size=(size, s)).astype(
            np.int32)
        lens = rng.integers(c["min_len"], s + 1, size=size)
        ids[np.arange(s)[None, :] >= lens[:, None]] = 0
        labels = rng.integers(0, c["classes"], size=size).astype(np.int32)
        return mt.ArrayDataset(ids, labels)

    return tokens(n), tokens(n_val)


def _bars(what: str, errs: dict, bars: dict) -> None:
    for key, bar in bars.items():
        if not errs[key] <= bar:
            raise AssertionError(f"resnet18 {what}: {key} {errs[key]} > {bar}")


def _ratio(got, want) -> float:
    """Worst error against the reference's largest entry (a running mean
    near 0 has no relative error of its own)."""
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def resnet_cpu_check(trainer, x, y) -> dict:
    """ResNet-18's first ``RESNET_ROWS`` rows through one training step
    (train-mode forward, loss, backward) from the trainer's weights: on
    the card in float32 and float64 and on the CPU in float64, the card's
    float32 step also layer by layer against float64 on the CPU.  Returns
    every worst error; raises at the bars.  The card's model is restored
    after."""
    import torch

    import ml_trainer_tpu_torch as mt

    model = trainer.model
    card, cpu = x.device, torch.device("cpu")
    snap = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    layers = {n: m for n, m in model.named_modules()
              if isinstance(m, (mt.models.layers.Conv,
                                mt.models.layers.BatchNorm, torch.nn.Linear))}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, [i[0], o]))
        for n, m in layers.items()]
    hooks += [m.register_full_backward_hook(
        lambda m, gi, go, n=n: seen[n].extend([gi[0], go[0]]))
        for n, m in layers.items()]

    def fresh(dev, dtype):
        m = mt.get_model("resnet18", device=dev)
        m.load_state_dict(snap)
        return m.to(dtype)

    out = {}
    for where, dev, dtype in (("card_fp32", card, torch.float32),
                              ("card_fp64", card, torch.float64),
                              ("cpu_fp64", cpu, torch.float64)):
        m = model if where == "card_fp32" else fresh(dev, dtype)
        m.train()
        m.zero_grad(set_to_none=True)
        loss = trainer.criterion(m(x[:RESNET_ROWS].to(dev, dtype)),
                                 y[:RESNET_ROWS].to(dev))
        loss.backward()
        if where == "card_fp32":
            for h in hooks:
                h.remove()
        out[where] = (loss.item(),
                      {n: p.grad.detach().cpu().double()
                       for n, p in m.named_parameters()},
                      {n: b.detach().cpu().double()
                       for n, b in m.named_buffers()})
        del m, loss
    l_ref, g_ref, b_ref = out["cpu_fp64"]

    def step_errs(where):
        loss, grads, stats = out[where]
        return dict(loss_rel=abs(loss - l_ref) / abs(l_ref),
                    worst_grad_ratio=max(_ratio(grads[n], g)
                                         for n, g in g_ref.items()),
                    worst_stats_ratio=max(_ratio(stats[n], b)
                                          for n, b in b_ref.items()))

    res = {w: step_errs(w) for w in ("card_fp32", "card_fp64")}
    bars = {"loss_rel": RESNET_LOSS_RTOL, "worst_grad_ratio": RESNET_GRAD_RTOL,
            "worst_stats_ratio": RESNET_STATS_RTOL}
    _bars("card vs cpu (float64)", res["card_fp64"], bars)
    _bars("card (float32) vs cpu (float64)", res["card_fp32"],
          {k: bars[k] for k in ("loss_rel", "worst_stats_ratio")})

    # Each layer of the card's float32 step from its own inputs.
    _, grads, stats = out["card_fp32"]
    ref = dict(fresh(cpu, torch.float64).train().named_modules())
    worst = dict(out=0.0, grad_in=0.0, grad_params=0.0, stats=0.0)
    for n, (inp, o, g_in, g_out) in seen.items():
        i64 = inp.detach().cpu().double().requires_grad_(g_in is not None)
        o64 = ref[n](i64)
        o64.backward(g_out.cpu().double())
        worst["out"] = max(worst["out"], _ratio(o.detach().cpu(), o64))
        if g_in is not None:
            worst["grad_in"] = max(worst["grad_in"],
                                   _ratio(g_in.cpu(), i64.grad))
        for pn, p in ref[n].named_parameters():
            worst["grad_params"] = max(worst["grad_params"],
                                       _ratio(grads[f"{n}.{pn}"], p.grad))
        for bn, b in ref[n].named_buffers():
            worst["stats"] = max(worst["stats"],
                                 _ratio(stats[f"{n}.{bn}"], b))
    _bars("layers, card (float32) vs cpu (float64)", worst,
          dict(out=RESNET_STATS_RTOL, grad_in=RESNET_GRAD_RTOL,
               grad_params=RESNET_GRAD_RTOL, stats=RESNET_STATS_RTOL))
    del seen
    model.load_state_dict(snap)
    model.zero_grad(set_to_none=True)
    return dict(rows=RESNET_ROWS, loss_cpu_fp64=l_ref,
                loss_card_fp32=out["card_fp32"][0], **res,
                card_fp32_layers=dict(worst, layers=len(layers)))


def model_run(dev, name, model_kw, opt, data, batch, steps) -> dict:
    """One family through ``Trainer(...).fit()``: one epoch of ``steps``
    optimizer steps and ``VAL_BATCHES`` validation batches, then the
    step time, samples/s, peak memory and a profiled step."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    run_dir = f"{MODELS_DIR}/{name}"
    _discard(run_dir)
    t0 = time.perf_counter()
    model = _seeded_model(name, seed=SEED, device=dev, **model_kw)
    trainer = mt.Trainer(model, datasets=model_sets(data, batch, steps),
                         epochs=1, batch_size=batch, metric="accuracy",
                         model_dir=run_dir, seed=SEED, device=dev,
                         loader="python", **opt)
    model = trainer.model  # rebuilt at the policy's compute dtype
    bf16 = trainer.precision.active
    build_s = time.perf_counter() - t0
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    check = None
    if name == "resnet18":
        check = resnet_cpu_check(trainer, x, y)
        log("models: resnet18 one step, card vs cpu " + json.dumps(check))
    elif name == "bert_base":
        check = grad_check(trainer, x, y)
        log(f"models: bert_base ({trainer.precision.label()}) first batch, "
            "kernels vs plain " + json.dumps(check))

    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, name)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"] + hist["val_loss"]):
        raise AssertionError(f"{name}: non-finite losses: {hist}")
    if hist["skipped_steps"] != [0]:
        raise AssertionError(f"{name}: skipped steps {hist['skipped_steps']}")
    want = {k: 0 for k in counts}
    if name == "bert_base":  # grad_accum_steps 1: one microbatch a step
        want.update(flash_fwd=model.depth * (steps + VAL_BATCHES),
                    flash_bwd_dq=model.depth * steps,
                    flash_bwd_dkv=model.depth * steps)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    scale = loss_scale_record(trainer)

    n_time = 3
    calls = None
    if name == "bert_base":  # in bf16 the warm-up step is checked per call
        calls = train_call_check(trainer, x, y, model.depth)
    else:
        trainer._train_step(x, y, 1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_time):
        trainer._train_step(x, y, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n_time
    profile = profile_step(trainer, x, y)
    if name == "bert_base":
        # K1-K3's bounds at this batch's lengths, 12 launches of each.
        lens = torch.clamp((x != 0).sum(dim=1), min=1).tolist()
        b, s = x.shape
        attn = model.layers[0].attn
        heads, d = attn.num_heads, attn.head_dim
        bounds = dict(bwd_bounds(b, heads, s, d, False, lens, bf16),
                      flash_fwd=fwd_bounds(b, heads, s, d, False, lens,
                                           bf16=bf16))
        profile["bound_ms"] = {k: model.depth * v["bound_ms"]
                               for k, v in bounds.items()}
    else:
        for k in ("device_ms", "device_calls"):
            profile.pop(k)
    _discard(run_dir)
    label, cdt = trainer.precision.label(), str(getattr(model, "dtype", None))
    del trainer, model, x, y
    torch.cuda.empty_cache()
    return dict(
        model=name, precision=label, compute_dtype=cdt,
        config={**model_kw, **opt}, data=data, batch=batch,
        steps=steps, build_s=build_s, fit_s=fit_s, loss_scale=scale,
        history={k: hist[k] for k in ("train_loss", "val_loss",
                                      "train_metric", "val_metric",
                                      "skipped_steps")},
        launches=counts, step_ms=step_ms,
        samples_per_s=batch / (step_ms / 1e3),
        max_memory_allocated_bytes=peak, check=check, call_check=calls,
        profile=profile)


def models(dev) -> list:
    """Every ``MODEL_RUNS`` family through ``model_run``, after the TF32
    switches are checked off and cuDNN's on its deterministic algorithms
    (``device.resolve_device`` sets all four)."""
    import torch

    flags = dict(cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                 cuda_matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 cudnn_deterministic=torch.backends.cudnn.deterministic,
                 cudnn_benchmark=torch.backends.cudnn.benchmark)
    log("models: " + json.dumps(flags))
    if flags != dict(cudnn_allow_tf32=False, cuda_matmul_allow_tf32=False,
                     cudnn_deterministic=True, cudnn_benchmark=False):
        raise AssertionError(f"TF32 or cuDNN flags: {flags}")
    return [model_run(dev, *run) for run in MODEL_RUNS]


# ------------------------------------------------------------- phase 8
# steps_per_execution on the card: each family at K = 1 (the eager step)
# and at K = GRAPH_K (each full chunk of K batches one replay of a CUDA
# graph of the K steps), from the same weights and data.  GRAPH_STEPS is
# two full chunks and a tail of one: the first chunk runs eagerly before
# the capture, the second replays; GRAPH_VAL validation batches give the
# eval graph one replay and a tail of one.
GRAPH_K = 4
# The depth the graphs phase's transformer families and the resume
# phase's pretraining run are cut to, at their full widths: the script's
# time budget.  Their gates (a graph replay and a resumed fit each
# bitwise their reference) hold block by block at any depth.
CUT_DEPTH = 4
GRAPH_STEPS = 2 * GRAPH_K + 1
GRAPH_VAL = 2 * GRAPH_K + 1
GRAPH_LOSS_RTOL = 1e-6  # the epoch sums' order: a chunk's K losses first
GRAPH_DIR = "build/chip_smoke_graphs"  # each run's model.pth; removed after
GPT2_OPT = dict(grad_accum_steps=TRAIN["accum"], optimizer="adamw", lr=3e-4,
                weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
                grad_clip_norm=1.0)
_MODEL = {(name, opt.get("precision")): (name, kw, opt, data, batch)
          for name, kw, opt, data, batch, _ in MODEL_RUNS}
_CUT = {"depth": CUT_DEPTH}
GRAPH_RUNS = [  # (label, model name, model kwargs, trainer kwargs, data, batch)
    ("gpt2_fp32", "gpt2", _CUT, GPT2_OPT, "gpt2", TRAIN["batch_size"]),
    ("gpt2_bf16", "gpt2", _CUT, dict(GPT2_OPT, precision="bf16"), "gpt2",
     TRAIN["batch_size"]),
    *((label, name, dict(kw, **_CUT), opt, data, batch)
      for label, (name, kw, opt, data, batch) in (
          ("bert_base_bf16", _MODEL[("bert_base", "bf16")]),
          ("vit_b16_bf16", _MODEL[("vit_b16", "bf16")]))),
    ("resnet50", *_MODEL[("resnet50", None)]),
    ("mlmodel", *_MODEL[("mlmodel", None)]),
]


def graph_sets(data: str, batch: int):
    """(train, validation) sets of GRAPH_STEPS and GRAPH_VAL batches."""
    import ml_trainer_tpu_torch as mt

    if data != "gpt2":
        return model_sets(data, batch, GRAPH_STEPS, GRAPH_VAL)
    c = TRAIN
    return tuple(mt.SyntheticTokens(size=batch * n, seq_len=c["seq_len"],
                                    vocab_size=c["vocab_size"],
                                    seed=SEED + i)
                 for i, n in enumerate((GRAPH_STEPS, GRAPH_VAL)))


def _named_state(trainer, host: bool = True) -> dict:
    """The model's parameters and buffers and every state tensor, by name,
    copied to the host (``host=False``: cloned where they live, for a
    comparison that measures no memory)."""
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}

    def walk(path, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{path}.{k}", v)
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(f"{path}[{i}]", v)
        else:
            out[path] = t

    state = trainer.state
    walk("opt_state", state.opt_state)
    for field in ("skipped_steps", "bad_streak", "loss_scale", "good_steps"):
        if getattr(state, field) is not None:
            out[field] = getattr(state, field)
    for k, v in (state.ema_params or {}).items():
        out[f"ema_params.{k}"] = v
    where = "cpu" if host else None
    return {k: v.detach().to(where or v.device, copy=True)
            for k, v in out.items()}


def _leaf_distance(got: dict, want: dict):
    """(the first leaf that differs, the worst leaf, its distance): max
    |got - want| of a leaf over its largest |want|; (None, None, 0.0)
    when every leaf is bitwise equal."""
    import torch

    first = worst_name = None
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if g.dtype == w.dtype and torch.equal(g, w):
            continue
        first = first or name
        g64, w64 = g.double(), w.double()
        d = ((g64 - w64).abs().max()
             / w64.abs().max().clamp_min(1e-30)).item()
        if d >= worst:
            worst, worst_name = d, name
    return first, worst_name, worst


def _history_distance(got: dict, want: dict) -> float:
    """Largest difference of the epoch losses (relative) and metrics
    (absolute: an accuracy may be 0)."""
    worst = 0.0
    for key in ("train_loss", "val_loss", "train_metric", "val_metric"):
        for g, w in zip(got[key], want[key]):
            worst = max(worst, abs(g - w) / (
                max(abs(w), 1e-30) if key.endswith("loss") else 1.0))
    return worst


def profile_dispatch(trainer, xs, ys) -> dict:
    """One chunk, one graph replay, under ``torch.profiler``: device-busy
    time and idle share of the dispatch, busy ms per optimizer step, and
    K1-K3's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._dispatch("train", trainer._train_chunk, xs, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = device_split(prof, wall)
    if isinstance(split["device_busy_s"], float):
        split["device_busy_ms_per_step"] = (split["device_busy_s"] * 1e3
                                            / GRAPH_K)
    split.update(kernel_device_ms(prof, ATTN_MARKS))
    return split


def graph_run(dev, label, name, model_kw, opt, data, batch) -> dict:
    """One family at K = 1 and K = GRAPH_K through ``Trainer.fit()`` from
    the same seeded weights and data.  Gates: finite losses, no skipped
    step, the exact launch counts of both runs (replays counted), and the
    K-step run's parameters, buffers and state bitwise those of K = 1
    with the epoch losses within GRAPH_LOSS_RTOL (the order of the
    sums), every family alike (cuDNN's deterministic convolution
    algorithms, ``device.resolve_device``).  Then, on one chunk of
    batches, the
    optimizer-step time of the eager step and of the graph (CUDA events,
    in the order eager, graph, graph, eager), a profiled dispatch and a
    profiled eager step, the capture's seconds, the eager step's host
    enqueue time and the input path's host time per batch."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.trainer import _chunk_batches

    run_dir = f"{GRAPH_DIR}/{label}"
    attn = name in ("gpt2", "bert_base")
    launches = {k: 0 for k in mt.launch_counts()}

    def fit(k):
        _discard(run_dir)
        model = _seeded_model(name, seed=SEED, device=dev, **model_kw)
        trainer = mt.Trainer(model, datasets=graph_sets(data, batch),
                             epochs=1, batch_size=batch, metric="accuracy",
                             model_dir=run_dir, seed=SEED, device=dev,
                             steps_per_execution=k, loader="python", **opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        fit_whole(trainer, f"graphs {label} K={k}")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = mt.launch_counts()
        hist = trainer.history
        if not all(math.isfinite(v)
                   for v in hist["train_loss"] + hist["val_loss"]):
            raise AssertionError(f"graphs {label} K={k}: non-finite {hist}")
        if hist["skipped_steps"] != [0]:
            raise AssertionError(f"graphs {label} K={k}: skipped steps "
                                 f"{hist['skipped_steps']}")
        want = {kname: 0 for kname in counts}
        if attn:
            depth = trainer.model.depth
            micro = GRAPH_STEPS * trainer.grad_accum_steps
            want.update(flash_fwd=depth * (micro + GRAPH_VAL),
                        flash_bwd_dq=depth * micro,
                        flash_bwd_dkv=depth * micro)
        if counts != want:
            raise AssertionError(f"graphs {label} K={k}: launches {counts}, "
                                 f"expected {want}")
        for kname, n in counts.items():
            launches[kname] += n
        rec = dict(fit_s=fit_s, max_memory_allocated_bytes=(
            torch.cuda.max_memory_allocated()), launches=counts,
            history={key: hist[key] for key in (
                "train_loss", "val_loss", "train_metric", "val_metric",
                "skipped_steps")},
            loss_scale=loss_scale_record(trainer), step=trainer.state.step)
        return trainer, rec, _named_state(trainer)

    t0 = time.perf_counter()
    eager, rec_1, snap_1 = fit(1)
    del eager
    torch.cuda.empty_cache()
    trainer, rec_k, snap_k = fit(GRAPH_K)
    if rec_k["step"] != rec_1["step"] or rec_k["loss_scale"] != rec_1[
            "loss_scale"]:
        raise AssertionError(f"graphs {label}: step / loss scale "
                             f"{rec_k['step']} {rec_k['loss_scale']} vs "
                             f"{rec_1['step']} {rec_1['loss_scale']}")
    first, worst_name, dist = _leaf_distance(snap_k, snap_1)
    loss_rel = _history_distance(rec_k["history"], rec_1["history"])
    same = dict(bitwise=first is None, first_leaf=first,
                worst_leaf=worst_name, distance=dist, loss_rel=loss_rel)
    # Every family repeats bit for bit: the port's kernels add in a fixed
    # order, and resolve_device puts cuDNN on its deterministic
    # convolution algorithms (the default backward adds with atomics).
    if first is not None or loss_rel > GRAPH_LOSS_RTOL:
        raise AssertionError(
            f"graphs {label}: the graph run differs from K = 1 (first "
            f"{first}, worst {worst_name} {dist}, losses {loss_rel})")
    del snap_1, snap_k
    check_s = time.perf_counter() - t0

    # Step time on one chunk, eager (the K = 1 program, functional: after
    # it no replay runs on that state) and graph, interleaved.
    xs, ys = next(iter(prefetch_to_device(
        _chunk_batches(trainer.train_loader, GRAPH_K, []), size=1,
        device=dev)))
    trainer._lr_t.fill_(1.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(body, steps):
        start.record()
        body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / steps

    def eager_chunk():
        for x, y in zip(xs, ys):
            trainer._train_step(x, y, 1.0)

    def graph_chunks():
        trainer._dispatch("train", trainer._train_chunk, xs, ys)

    eager_ms = [timed(eager_chunk, GRAPH_K)]
    t1 = time.perf_counter()
    graph_chunks()  # the warm-up chunk and the capture
    torch.cuda.synchronize()
    first_dispatch_s = time.perf_counter() - t1
    capture_s = next(iter(trainer._graphs.values())).capture_s
    graph_ms = [timed(graph_chunks, GRAPH_K) for _ in range(2)]
    prof_graph = profile_dispatch(trainer, xs, ys)
    eager_ms.append(timed(eager_chunk, GRAPH_K))
    prof_eager = profile_step(trainer, xs[0], ys[0])
    if not attn:
        prof_eager.pop("device_ms")
        prof_eager.pop("device_calls")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer._train_step(xs[0], ys[0], 1.0)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    eager_wall_ms = (time.perf_counter() - t1) * 1e3
    trainer._graphs.clear()
    # The input path's host time per batch: the Loader alone (numpy
    # gathers and transforms), then with the pinned copies to the card.
    n = len(trainer.train_loader)
    t1 = time.perf_counter()
    for _ in trainer.train_loader:
        pass
    loader_ms = (time.perf_counter() - t1) * 1e3 / n
    t1 = time.perf_counter()
    for _ in prefetch_to_device(trainer.train_loader, size=2, device=dev):
        pass
    torch.cuda.synchronize()
    input_ms = (time.perf_counter() - t1) * 1e3 / n
    _discard(run_dir)
    per_step = (TRAIN["seq_len"] * batch if name == "gpt2" else batch)
    unit = "tokens_per_s" if name == "gpt2" else "samples_per_s"
    label_p = trainer.precision.label()
    depth = getattr(trainer.model, "depth", None)
    del trainer, xs, ys
    torch.cuda.empty_cache()
    return dict(
        label=label, model=name, precision=label_p, depth=depth,
        batch=batch, k=GRAPH_K, steps=GRAPH_STEPS, val_batches=GRAPH_VAL,
        same_as_k1=same, check_s=check_s,
        eager=rec_1, graph=rec_k, launches_total=launches,
        eager_step_ms=eager_ms, graph_step_ms=graph_ms,
        **{f"eager_{unit}": per_step * 1e3 / (sum(eager_ms) / 2),
           f"graph_{unit}": per_step * 1e3 / (sum(graph_ms) / 2)},
        peak_ratio=(rec_k["max_memory_allocated_bytes"]
                    / rec_1["max_memory_allocated_bytes"]),
        capture_s=capture_s, first_dispatch_s=first_dispatch_s,
        eager_enqueue_ms=enqueue_ms, eager_step_wall_ms=eager_wall_ms,
        input_loader_ms_per_batch=loader_ms,
        input_ms_per_batch=input_ms,
        profile_graph=prof_graph, profile_eager=prof_eager)


def graphs(dev) -> list:
    """Every ``GRAPH_RUNS`` family through ``graph_run``."""
    return [graph_run(dev, *run) for run in GRAPH_RUNS]


# ------------------------------------------------------------- phase 9
# Full-state checkpoints and fit(resume=True) on the card.  Each run's
# uninterrupted fit (A) against a fit that resumes from A's
# checkpoint_1 (pretrain) or from its own preemption (dp, resnet): every
# parameter, buffer, optimizer-state leaf, counter, the step and every
# history list bitwise equal.
RESUME_DIR = "build/chip_smoke_resume"  # each run's checkpoints; removed
# examples/04_gpt2_pretrain.py's full-size line (BASELINE.json config 4)
# without REMAT=1 (the examples phase runs it with remat), at K = 4: 2
# epochs of 4 steps (one chunk: A replays it in epoch 2, B captures it
# anew) and 2 validation batches.
PRETRAIN = dict(steps=4, val_batches=2, k=4, opt=dict(
    grad_accum_steps=TRAIN["accum"], optimizer="adamw", lr=3e-4,
    weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts"))
RESUME_DP_STEPS = 4  # the dp run's steps an epoch (2 epochs)
RESUME_RESNET = dict(batch=256, steps=3)  # ResNet-18, 2 epochs


def _token_sets(steps: int, val_batches: int, batch: int):
    import ml_trainer_tpu_torch as mt

    c = TRAIN
    return tuple(mt.SyntheticTokens(size=batch * n, seq_len=c["seq_len"],
                                    vocab_size=c["vocab_size"],
                                    seed=SEED + i)
                 for i, n in enumerate((steps, val_batches)))


def _resume_fit(what: str, make, run_dir: str, resume=False, spec=None,
                preempt=False, **kw):
    """One fit of ``make(run_dir, **kw)`` with the counters set to 0 just
    before it (under the fault plan ``spec``, if any); it must end
    preempted exactly when ``preempt``."""
    import gc

    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.resilience import faults

    gc.collect()  # the previous run's trainer and its card memory
    torch.cuda.empty_cache()
    trainer = make(run_dir, **kw)
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    with faults.injected(spec) if spec else contextlib.nullcontext():
        trainer.fit(resume=resume)
    torch.cuda.synchronize()
    rec = dict(fit_s=time.perf_counter() - t0, launches=mt.launch_counts())
    if trainer.preempted != preempt:
        raise AssertionError(f"resume {what}: preempted={trainer.preempted}")
    return trainer, rec


def _resume_gate(what: str, got, want_snap: dict, want) -> dict:
    """``got`` (a resumed trainer) bitwise the uninterrupted run: its
    state (``_named_state``), step and history."""
    first, worst, dist = _leaf_distance(_named_state(got), want_snap)
    hist = [k for k in set(got.history) | set(want["history"])
            if got.history.get(k) != want["history"].get(k)]
    out = dict(bitwise=first is None and not hist
               and got.state.step == want["step"], first_leaf=first,
               worst_leaf=worst, distance=dist, history_keys_differ=hist,
               step=got.state.step, history=got.history)
    if not out["bitwise"]:
        raise AssertionError(f"resume {what}: not bitwise the uninterrupted "
                             f"run: {out}")
    return out


def _want_launches(what: str, got: dict, depth: int, micro: int,
                   val: int, tail: int = 0) -> None:
    """K1 ``depth`` a microbatch and a validation batch, K2/K3 ``depth`` a
    microbatch, K4/K5 ``tail`` (the sharded update's, one a replica a
    step)."""
    want = {k: 0 for k in got}
    if depth:
        want.update(flash_fwd=depth * (micro + val),
                    flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
    want.update(unscale_sqsum=tail, fused_adam=tail)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _checkpoint_costs(trainer, run_dir: str) -> dict:
    """One checkpoint of ``trainer``'s state: its bytes, the host copy
    (``save_checkpoint`` until it returns, the part a step waits on), the
    writer thread's seconds (the files and their CRC32s), the
    verification, the read and the load into the live tensors, which
    must leave the state bitwise as it was."""
    import os
    import shutil

    import torch

    from ml_trainer_tpu_torch.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
        verify_checkpoint,
        wait_for_checkpoints,
    )
    from ml_trainer_tpu_torch.train_state import load_state_tree, state_tree

    before = _named_state(trainer)
    out_dir = f"{run_dir}/costs"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(out_dir, state_tree(trainer.state, trainer.model),
                           trainer._partial_history(), 1, block=False)
    t1 = time.perf_counter()
    wait_for_checkpoints()
    t2 = time.perf_counter()
    verify_checkpoint(path)
    t3 = time.perf_counter()
    tree = restore_checkpoint(path)[0]
    t4 = time.perf_counter()
    load_state_tree(trainer.state, trainer.model, tree)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    shutil.rmtree(out_dir)
    first = _leaf_distance(_named_state(trainer), before)[0]
    if first is not None:
        raise AssertionError(f"resume: a save and load moved {first}")
    return dict(checkpoint_bytes=nbytes, snapshot_s=t1 - t0,
                writer_s=t2 - t1, verify_s=t3 - t2, restore_read_s=t4 - t3,
                restore_load_s=t5 - t4)


def resume_pretrain(dev) -> dict:
    """GPT-2 124M fp32 at K = 4 (``PRETRAIN``; ``CUT_DEPTH`` blocks, the
    init ``Trainer`` makes of the name): A uninterrupted; then
    A's checkpoint costs; then B, a new Trainer, resumes from A's
    checkpoint_1 alone (checkpoint_2 removed) and trains epoch 2 through
    a fresh graph capture."""
    import shutil

    import ml_trainer_tpu_torch as mt

    c = PRETRAIN
    run_dir = f"{RESUME_DIR}/pretrain"
    _discard(run_dir)

    def make(d):
        model = mt.init_model(TRAIN["model"], seed=SEED, device=dev,
                              depth=CUT_DEPTH)
        return mt.Trainer(model, datasets=_token_sets(
            c["steps"], c["val_batches"], TRAIN["batch_size"]), epochs=2,
            batch_size=TRAIN["batch_size"], model_dir=d, seed=SEED,
            device=dev, steps_per_execution=c["k"], **c["opt"])

    a, rec_a = _resume_fit("pretrain A", make, run_dir)
    depth, accum = a.model.depth, a.grad_accum_steps
    _want_launches("resume pretrain A", rec_a["launches"], depth,
                   2 * c["steps"] * accum, 2 * c["val_batches"])
    want = dict(history=a.history, step=a.state.step)
    snap = _named_state(a)
    costs = _checkpoint_costs(a, run_dir)
    del a
    shutil.rmtree(f"{run_dir}/checkpoints/checkpoint_2")
    b, rec_b = _resume_fit("pretrain B", make, run_dir, resume=True)
    _want_launches("resume pretrain B", rec_b["launches"], depth,
                   c["steps"] * accum, c["val_batches"])
    gate = _resume_gate("pretrain", b, snap, want)
    del b, snap
    shutil.rmtree(run_dir)
    return dict(config=dict(c, model=TRAIN["model"], depth=depth,
                            precision="float32",
                            batch=TRAIN["batch_size"],
                            seq_len=TRAIN["seq_len"]),
                A=rec_a, B=rec_b, gate=gate, **costs)


def resume_dp(dev) -> dict:
    """``dp_train``'s configuration in bf16 (2 replicas, the sharded
    update with K4/K5), 2 epochs of ``RESUME_DP_STEPS``: A uninterrupted;
    B with ``save_every_steps=2`` under ``preempt@step=7`` (the emergency
    checkpoint at epoch 2, batch 3); C resumes and runs batch 4 and the
    validation, consuming B's ``PREEMPTED.json``."""
    import json as json_
    import os
    import shutil

    import ml_trainer_tpu_torch as mt

    c, steps = DP, RESUME_DP_STEPS
    run_dir = f"{RESUME_DIR}/dp"
    _discard(run_dir)

    def make(d, **kw):
        return mt.Trainer(
            c["model"], datasets=_token_sets(steps, c["val_batches"],
                                             c["batch_size"]),
            epochs=2, batch_size=c["batch_size"], is_parallel=True,
            mesh_shape={"data": c["replicas"]}, device=[dev] * c["replicas"],
            dp_update="sharded", grad_accum_steps=c["accum"],
            optimizer="adam", lr=3e-4, weight_decay=0.0,
            scheduler="CosineAnnealingWarmRestarts", grad_clip_norm=1.0,
            model_dir=d, seed=SEED, precision="bf16", **kw)

    a, rec_a = _resume_fit("dp A", make, f"{run_dir}/a")
    if not (a.fused_adam and a.dp_update == "sharded"):
        raise AssertionError("resume dp: not the sharded step with K4/K5")
    depth, n, accum = a.model.depth, c["replicas"], c["accum"]
    _want_launches("resume dp A", rec_a["launches"], depth,
                   2 * steps * n * accum, 2 * c["val_batches"], 2 * steps * n)
    want = dict(history=a.history, step=a.state.step)
    snap = _named_state(a)
    del a
    shutil.rmtree(f"{run_dir}/a")
    d = f"{run_dir}/b"
    b, rec_b = _resume_fit("dp B", make, d, spec="preempt@step=7",
                           preempt=True, save_every_steps=2)
    _want_launches("resume dp B", rec_b["launches"], depth, 7 * n * accum,
                   c["val_batches"], 7 * n)
    marker = f"{d}/checkpoints/PREEMPTED.json"
    with open(marker) as fp:
        rec_b["marker"] = json_.load(fp)
    if (rec_b["marker"]["epoch"], rec_b["marker"]["batches_done"]) != (2, 3):
        raise AssertionError(f"resume dp: marker {rec_b['marker']}")
    del b
    cc, rec_c = _resume_fit("dp C", make, d, resume=True,
                            save_every_steps=2)
    if os.path.exists(marker):
        raise AssertionError("resume dp: PREEMPTED.json not consumed")
    _want_launches("resume dp C", rec_c["launches"], depth, n * accum,
                   c["val_batches"], n)
    gate = _resume_gate("dp", cc, snap, want)
    del cc, snap
    shutil.rmtree(run_dir)
    return dict(config=dict(model=c["model"], precision="bf16",
                            replicas=c["replicas"], accum=accum,
                            batch=c["batch_size"], steps=steps,
                            val_batches=c["val_batches"]),
                A=rec_a, B=rec_b, C=rec_c, gate=gate)


def resume_resnet(dev) -> dict:
    """ResNet-18 (CIFAR stem, batch 256, ``SGD_02``) at K = 1, 2 epochs of
    ``RESUME_RESNET["steps"]``: A uninterrupted; B with
    ``save_every_steps=2`` under ``preempt@step=5``; C resumes.  Bitwise
    only because cuDNN runs its deterministic algorithms."""
    import shutil

    import ml_trainer_tpu_torch as mt

    steps, batch = RESUME_RESNET["steps"], RESUME_RESNET["batch"]
    run_dir = f"{RESUME_DIR}/resnet"
    _discard(run_dir)

    def make(d, **kw):
        return mt.Trainer(
            _seeded_model("resnet18", seed=SEED, device=dev,
                          cifar_stem=True),
            datasets=model_sets("cifar", batch, steps), epochs=2,
            batch_size=batch, model_dir=d, seed=SEED, device=dev,
            loader="python", **SGD_02, **kw)

    a, rec_a = _resume_fit("resnet A", make, f"{run_dir}/a")
    want = dict(history=a.history, step=a.state.step)
    snap = _named_state(a)
    del a
    d = f"{run_dir}/b"
    _, rec_b = _resume_fit("resnet B", make, d, spec="preempt@step=5",
                           preempt=True, save_every_steps=2)
    cc, rec_c = _resume_fit("resnet C", make, d, resume=True,
                            save_every_steps=2)
    for what, rec in (("A", rec_a), ("B", rec_b), ("C", rec_c)):
        _want_launches(f"resume resnet {what}", rec["launches"], 0, 0, 0)
    gate = _resume_gate("resnet", cc, snap, want)
    del cc, snap
    shutil.rmtree(run_dir)
    return dict(config=dict(model="resnet18", batch=batch, steps=steps),
                A=rec_a, B=rec_b, C=rec_c, gate=gate)


# ------------------------------------------------------------- phase 10
# The data layer and the chunked LM loss on the card.  The C++ batch
# worker (data/native.py, built with g++ from csrc/ into build/native/)
# against the Python Loader's transforms; ResNet-50 fed by each loader
# from memory and from raw shards; GPT-2 124M bf16 on BPE-packed blocks
# with loss_chunk against the dense head; BERT-base bf16 on WordPiece
# data.  Every fit runs at K = 4 (graph replays), with exact launches.
DATA_DIR = "build/chip_smoke_data"  # shards and each run's files; removed
DATA_K = 4
NATIVE_PLAIN_ATOL = 1e-5  # the C++ pass x*(1/255) then *(1/std) vs numpy's /
# ResNet-50 224 b64 fp32, 3 epochs of 8 steps (2 chunks): epoch 2 timed
# (samples/s of the epoch, and of its steady state: the median interval
# between consecutive chunks' ends on the device; the graphs captured in
# epoch 1), epoch 3 profiled (busy / idle).
DATA_RESNET = dict(batch=64, steps=8, val_batches=1, epochs=3)
# GPT-2 124M bf16 (TRAIN's config: 8 x 1024 tokens in 4 microbatches,
# GPT2_OPT), 8 steps and 1 validation batch an epoch, loss_chunk 128.
DATA_GPT2 = dict(steps=8, val_batches=1, loss_chunk=128)
# The chunked head against the dense head in float32 (the same products,
# the sums in another order): the loss, and each gradient against its
# largest entry.  In bf16 the chunked run's gradients must lie as near
# the float32 dense gradients as the bf16 dense run's do (within
# BF16_NOISE_FACTOR, or BF16_GRAD_RTOL), the losses within CHUNK_LOSS_RTOL.
CHUNK_LOSS_RTOL, CHUNK_GRAD_RTOL = 1e-5, 1e-4
# BERT-base bf16 32 x 128 (right_padded), 8 steps and 1 validation batch.
DATA_BERT = dict(batch=32, steps=8, val_batches=1)


def native_checks(dev) -> dict:
    """Build the library (its seconds), then the C++ pass against the
    Python Loader's ToFloat + Normalize on 224 x 224 images (pad 0, no
    flip; within NATIVE_PLAIN_ATOL), two iterations of one epoch bitwise,
    and a new epoch's draws different."""
    import numpy as np

    from ml_trainer_tpu_torch.data import Loader, NativeLoader, native

    t0 = time.perf_counter()
    native.load_library()  # raises when g++ or the build fails
    build_s = time.perf_counter() - t0
    train, _ = model_sets("imagenet", 16, 4)
    plain = Loader(train, 16, shuffle=False)
    fused = NativeLoader(train, 16, shuffle=False, pad=0, flip=False,
                         normalize=(IMAGENET_MEAN, IMAGENET_STD))
    err = max(float(np.abs(a - b).max())
              for (a, _), (b, _) in zip(fused, plain))
    if not err <= NATIVE_PLAIN_ATOL:
        raise AssertionError(f"native vs plain transforms: {err}")
    aug = NativeLoader(train, 16, shuffle=True, pad=4, flip=True, seed=SEED,
                       normalize=(IMAGENET_MEAN, IMAGENET_STD))
    first = [x.copy() for x, _ in aug]
    again = [x.copy() for x, _ in aug]
    aug.set_epoch(1)
    other = [x.copy() for x, _ in aug]
    repeat = all(np.array_equal(a, b) for a, b in zip(first, again))
    differs = not all(np.array_equal(a, b) for a, b in zip(first, other))
    if not (repeat and differs):
        raise AssertionError(f"native epochs: repeat {repeat}, new epoch "
                             f"differs {differs}")
    aug.stop()
    fused.stop()
    return dict(library=native.BUILD_LOG["path"], build_s=build_s,
                cached=native.BUILD_LOG["cached"], plain_max_abs_err=err,
                epoch_repeats_bitwise=repeat, new_epoch_differs=differs)


def _epoch_clock(trainer, profile_epoch=None):
    """Wrap ``trainer._train_one_epoch``: each epoch's wall seconds (it
    ends with a host read, so the device has finished) and the device
    clock's intervals between consecutive train chunks' ends (a CUDA
    event after each dispatch), and epoch ``profile_epoch`` under
    ``torch.profiler`` (its ``device_split``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    inner, rec = trainer._train_one_epoch, {"epoch_s": [], "profile": None,
                                            "chunk_ms": []}
    dispatch, ends = trainer._dispatch, []

    def marked(kind, fn, xs, ys):
        out = dispatch(kind, fn, xs, ys)
        if kind == "train":
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        return out

    def timed(epoch):
        if epoch != profile_epoch:
            ends.clear()
            t0 = time.perf_counter()
            inner(epoch)
            rec["epoch_s"].append(time.perf_counter() - t0)
            rec["chunk_ms"].append([a.elapsed_time(b)
                                    for a, b in zip(ends, ends[1:])])
            return
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            inner(epoch)
            wall = time.perf_counter() - t0
        rec["epoch_s"].append(wall)
        split = device_split(prof, wall)
        split.pop("top_kernels", None)
        rec["profile"] = split

    trainer._train_one_epoch = timed
    trainer._dispatch = marked
    return rec


def _data_fit(what: str, trainer, depth: int = 0, micro: int = 0,
              val: int = 0) -> dict:
    """``fit_whole`` with the launches counted from 0 (``_want_launches``
    of ``depth``, ``micro``, ``val``), finite losses and no skipped step;
    the fit's seconds."""
    import math

    import torch

    import ml_trainer_tpu_torch as mt

    torch.cuda.synchronize()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, what)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    _want_launches(what, counts, depth, micro, val)
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"]
               + hist["val_loss"]):
        raise AssertionError(f"{what}: non-finite losses {hist}")
    if any(hist["skipped_steps"]):
        raise AssertionError(f"{what}: skipped steps "
                             f"{hist['skipped_steps']}")
    return dict(fit_s=fit_s, launches=counts, train_loss=hist["train_loss"],
                val_loss=hist["val_loss"])


def _graph_step_ms(trainers: dict, reps: int = 3,
                   profile: bool = False) -> dict:
    """Per trainer, ``step_ms``: ms an optimizer step of its K-step graph
    (CUDA events on ``reps`` replays of one chunk), after a capture of
    that chunk, in the order of ``trainers``, then reversed; with
    ``profile``, also ``profile``: one replay's ``device_split`` (busy
    ms a step, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.trainer import _chunk_batches

    chunks = {}
    for label, tr in trainers.items():
        tr.train_loader.set_epoch(0)
        xs, ys = next(iter(prefetch_to_device(
            _chunk_batches(tr.train_loader, DATA_K, []), size=1,
            device=tr.device)))
        tr._lr_t.fill_(1.0)
        tr._dispatch("train", tr._train_chunk, xs, ys)  # warm-up, capture
        chunks[label] = (xs, ys)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = {label: {"step_ms": []} for label in trainers}
    for label in list(trainers) + list(trainers)[::-1]:
        tr, (xs, ys) = trainers[label], chunks[label]
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            tr._dispatch("train", tr._train_chunk, xs, ys)
        end.record()
        torch.cuda.synchronize()
        out[label]["step_ms"].append(start.elapsed_time(end)
                                     / (reps * DATA_K))
    for label, tr in trainers.items():
        if profile:
            xs, ys = chunks[label]
            torch.cuda.synchronize()
            with profiler(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr._dispatch("train", tr._train_chunk, xs, ys)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            split = device_split(prof, wall)
            if isinstance(split["device_busy_s"], float):
                split["device_busy_ms_per_step"] = (
                    split["device_busy_s"] * 1e3 / DATA_K)
            out[label]["profile"] = split
        tr._graphs.clear()
    return out


def data_resnet(dev) -> dict:
    """ResNet-50 224, b 64, K = 4, fp32 through ``fit()`` with
    ``loader="python"`` and ``loader="native"``, on seeded uint8 images in
    memory and as raw shards (``write_sharded_dataset`` under
    DATA_DIR): end-to-end samples/s of the second epoch and of its
    steady state (after the prefetch's fill: the median interval between
    chunks' ends), the loader's host ms a batch timed alone, and
    device-busy ms a step and idle share of the third epoch under the
    profiler (and of the steady state: busy over the median interval)."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import (
        NativeLoader,
        ShardedImageDataset,
        write_sharded_dataset,
    )

    c = DATA_RESNET
    batch, steps = c["batch"], c["steps"]
    train, val = model_sets("imagenet", batch, steps, c["val_batches"])
    root = write_sharded_dataset(f"{DATA_DIR}/shards",
                                 [(train.data, train.targets)],
                                 samples_per_shard=4 * batch)
    sources = {"memory": train,
               "shards": ShardedImageDataset(root, transform=train.transform)}
    runs = []
    for source, train_set in sources.items():
        for loader in ("python", "native"):
            what = f"data resnet50 {source} {loader}"
            trainer = mt.Trainer(
                _seeded_model("resnet50", seed=SEED, device=dev),
                datasets=(train_set, val), epochs=c["epochs"],
                batch_size=batch, metric="accuracy", seed=SEED, device=dev,
                model_dir=f"{DATA_DIR}/resnet50", loader=loader,
                steps_per_execution=DATA_K, **SGD_02)
            if isinstance(trainer.train_loader, NativeLoader) != (
                    loader == "native"):
                raise AssertionError(f"{what}: {trainer.train_loader}")
            clock = _epoch_clock(trainer, profile_epoch=c["epochs"])
            rec = _data_fit(what, trainer)
            # The loader alone, over one epoch, on the host.
            trainer.train_loader.set_epoch(0)
            t0 = time.perf_counter()
            n = sum(1 for _ in trainer.train_loader)
            host_ms = (time.perf_counter() - t0) * 1e3 / n
            prof = clock["profile"]
            chunk_ms = float(np.median(clock["chunk_ms"][1]))
            steady = {"chunk_ms": chunk_ms,
                      "samples_per_s": DATA_K * batch * 1e3 / chunk_ms}
            if isinstance(prof["device_busy_s"], float):
                busy = prof["device_busy_s"] * 1e3 / steps
                prof["device_busy_ms_per_step"] = busy
                steady["device_idle_share"] = 1.0 - busy * DATA_K / chunk_ms
            runs.append(dict(
                source=source, loader=loader, **rec,
                epoch_s=clock["epoch_s"],
                samples_per_s=steps * batch / clock["epoch_s"][1],
                steady=steady, chunk_ms=clock["chunk_ms"][1],
                loader_host_ms_per_batch=host_ms, profiled_epoch=prof))
            log(f"data resnet50 {source} {loader}: "
                f"{runs[-1]['samples_per_s']:.1f} samples/s "
                f"({steady['samples_per_s']:.1f} steady), loader "
                f"{host_ms:.1f} ms a batch, idle "
                f"{prof.get('device_idle_share')} "
                f"({steady.get('device_idle_share')} steady)")
            del trainer
            torch.cuda.empty_cache()
    shutil.rmtree(f"{DATA_DIR}/shards")
    _discard(f"{DATA_DIR}/resnet50")
    return dict(config=dict(model="resnet50", batch=batch, steps=steps,
                            epochs=c["epochs"], k=DATA_K,
                            images=int(len(train))), runs=runs)


def packed_lm_sets(steps: int, val_batches: int, batch: int, seq_len: int):
    """``examples/04_gpt2_pretrain.py``'s data: the fixture byte-level
    BPE's encoding of synthetic text, packed into [seq_len] blocks
    (``PackedLMDataset``; validation from the stream's tail)."""
    import numpy as np

    from ml_trainer_tpu_torch.data import PackedLMDataset
    from ml_trainer_tpu_torch.data.tokenizers import (
        fixture_vocab_dir,
        load_tokenizer,
    )

    tok = load_tokenizer(fixture_vocab_dir(), prefer="bpe")
    n, n_val = steps * batch, val_batches * batch
    need = (n + n_val) * seq_len + 2
    stream, i = [], 0
    while len(stream) < need:
        stream.extend(tok.encode(
            f"training step {i}: the tiny gpt model fits the mesh "
            "and the loss goes down. "))
        i += 1
    stream = np.asarray(stream[:need], np.int32)
    split = n * seq_len + 1
    return (PackedLMDataset(stream[:split], seq_len),
            PackedLMDataset(stream[split - 1:], seq_len)), tok.vocab_size


def _step_grads(model, fn) -> tuple:
    """The loss ``fn()`` and every parameter's gradient of it, and the
    bytes the forward and backward allocated at their peak above what
    was allocated before."""
    import torch

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = fn()
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, peak


def chunked_head_check(dev, x, y) -> dict:
    """The chunked LM loss against the dense head in float32 on the card:
    the function alone at [8, 1024, 768] x [50257, 768] (loss, d hidden,
    d embedding), then GPT-2 124M's loss and every gradient on one
    microbatch, each within CHUNK_LOSS_RTOL / CHUNK_GRAD_RTOL.  Returns
    the float32 dense gradients (the bf16 check's reference)."""
    import torch
    import torch.nn.functional as F

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.ops.losses import chunked_lm_cross_entropy

    c = TRAIN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(c["batch_size"], c["seq_len"], 768, device=dev,
                    generator=gen)
    emb = 0.02 * torch.randn(c["vocab_size"], 768, device=dev, generator=gen)
    t = torch.randint(0, c["vocab_size"], (c["batch_size"], c["seq_len"]),
                      device=dev, generator=gen)
    out = {}
    for name in ("chunked", "dense"):
        hh = h.clone().requires_grad_()
        ee = emb.clone().requires_grad_()
        loss = (chunked_lm_cross_entropy(hh, ee, t, DATA_GPT2["loss_chunk"])
                if name == "chunked" else
                F.cross_entropy((hh @ ee.T).reshape(-1, c["vocab_size"]),
                                t.reshape(-1)))
        loss.backward()
        out[name] = (loss.item(), hh.grad, ee.grad)
        del hh, ee, loss
    (lc, hc, ec), (ld, hd, ed) = out["chunked"], out["dense"]
    fn = dict(loss_rel=abs(lc - ld) / abs(ld),
              d_hidden=((hc - hd).abs().max() / hd.abs().max()).item(),
              d_embedding=((ec - ed).abs().max() / ed.abs().max()).item())
    del out, hc, hd, ec, ed, h, emb
    if not (fn["loss_rel"] <= CHUNK_LOSS_RTOL
            and max(fn["d_hidden"], fn["d_embedding"]) <= CHUNK_GRAD_RTOL):
        raise AssertionError(f"chunked vs dense head, float32: {fn}")
    model = _seeded_model("gpt2", seed=SEED, device=dev,
                          loss_chunk=DATA_GPT2["loss_chunk"], **_CUT)
    lc, gc, _ = _step_grads(model, lambda: model(x, targets=y))
    ld, gd, _ = _step_grads(model, lambda: F.cross_entropy(
        model(x).reshape(-1, c["vocab_size"]), y.reshape(-1).long()))
    worst, worst_name = _worst_leaf(gc, gd)
    step = dict(loss_chunked=lc, loss_dense=ld,
                loss_rel=abs(lc - ld) / abs(ld), worst_grad_ratio=worst,
                worst_grad_param=worst_name)
    if not (step["loss_rel"] <= CHUNK_LOSS_RTOL and worst <= CHUNK_GRAD_RTOL):
        raise AssertionError(f"chunked vs dense GPT-2 step, float32: {step}")
    del model, gc
    torch.cuda.empty_cache()
    return dict(function=fn, step=step), gd


def data_gpt2(dev) -> dict:
    """GPT-2 124M's widths at ``CUT_DEPTH`` blocks (the budget's cut; the
    gates hold block by block), bf16, [8, 1024] in 4 microbatches, K = 4, on
    ``PackedLMDataset`` blocks: the float32 checks of
    ``chunked_head_check``; the bf16 chunked gradients of one microbatch
    against the float32 dense ones (no farther than the bf16 dense
    gradients are); ``fit()`` with ``loss_chunk`` at K = 4 and K = 1
    (bitwise, as the graphs phase holds it) and the dense head at K = 4,
    each with exact K1-K3 launches and its peak memory; then ms a step of
    the two K = 4 graphs (dense, chunked, chunked, dense)."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    c, g = TRAIN, DATA_GPT2
    batch, seq = c["batch_size"], c["seq_len"]
    (train, val), tok_vocab = packed_lm_sets(g["steps"], g["val_batches"],
                                             batch, seq)
    vocab = max(c["vocab_size"], tok_vocab)  # examples/04's rule
    x, y = next(iter(prefetch_to_device(
        mt.Loader(train, batch // c["accum"]), size=1, device=dev)))
    checks, ref = chunked_head_check(dev, x, y)
    launches = dict(depth=CUT_DEPTH, micro=g["steps"] * c["accum"],
                    val=g["val_batches"])

    def make(label, k, chunk):
        return mt.Trainer(
            _seeded_model("gpt2", seed=SEED, device=dev, vocab_size=vocab,
                          loss_chunk=chunk, **_CUT),
            datasets=(train, val), epochs=1, batch_size=batch, metric=None,
            seed=SEED, device=dev, precision="bf16",
            model_dir=f"{DATA_DIR}/{label}", steps_per_execution=k,
            **GPT2_OPT)

    runs, trainers = {}, {}
    for label, k, chunk in (("chunked", DATA_K, g["loss_chunk"]),
                            ("chunked_k1", 1, g["loss_chunk"]),
                            ("dense", DATA_K, 0)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = make(label, k, chunk)
        if label == "chunked":
            # One microbatch through the trainer's bf16 loss function, the
            # chunked head and the dense head.
            if not tr._takes_targets:
                raise AssertionError("loss_chunk model not self-loss")
            lc, gc, pc = _step_grads(tr.model,
                                     lambda: tr._forward_loss(x, y)[0])
            tr._takes_targets = False
            ld, gd, pd = _step_grads(tr.model,
                                     lambda: tr._forward_loss(x, y)[0])
            tr._takes_targets = True
            d_chunk, n_chunk = _worst_leaf(gc, ref)
            d_dense, n_dense = _worst_leaf(gd, ref)
            bar = max(BF16_GRAD_RTOL, BF16_NOISE_FACTOR * d_dense)
            checks["bf16_step"] = dict(
                loss_chunked=lc, loss_dense=ld,
                loss_rel=abs(lc - ld) / abs(ld),
                chunked_vs_fp32=d_chunk, chunked_vs_fp32_param=n_chunk,
                dense_vs_fp32=d_dense, dense_vs_fp32_param=n_dense,
                chunked_vs_dense=_worst_leaf(gc, gd)[0], grad_bar=bar,
                microbatch_peak_bytes=dict(chunked=pc, dense=pd))
            del gc, gd
            if not (abs(lc - ld) <= CHUNK_LOSS_RTOL * abs(ld)
                    and d_chunk <= bar):
                raise AssertionError(f"chunked vs dense GPT-2 step, bf16: "
                                     f"{checks['bf16_step']}")
            torch.cuda.reset_peak_memory_stats()
        rec = _data_fit(f"data gpt2 {label}", tr, **launches)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        rec["loss_scale"] = loss_scale_record(tr)
        runs[label] = rec
        if label == "chunked_k1":
            first, worst_name, dist = _leaf_distance(
                _named_state(tr), _named_state(trainers["chunked"]))
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
                trainers["chunked"].history["train_loss"]
                + trainers["chunked"].history["val_loss"],
                tr.history["train_loss"] + tr.history["val_loss"]))
            runs["k4_vs_k1"] = dict(bitwise=first is None, first_leaf=first,
                                    worst_leaf=worst_name, distance=dist,
                                    loss_rel=loss_rel)
            if first is not None or loss_rel > GRAPH_LOSS_RTOL:
                raise AssertionError(f"gpt2 loss_chunk K = 4 vs K = 1: "
                                     f"{runs['k4_vs_k1']}")
            del tr
            torch.cuda.empty_cache()
        else:
            trainers[label] = tr
    timed = _graph_step_ms({k: trainers[k] for k in ("dense", "chunked")},
                           profile=True)
    runs["step_ms"] = {k: v["step_ms"] for k, v in timed.items()}
    for k, v in timed.items():
        runs[k]["profile"] = v["profile"]
    del ref, trainers
    _discard(DATA_DIR)
    torch.cuda.empty_cache()
    return dict(config=dict(model="gpt2", depth=CUT_DEPTH, precision="bf16",
                            batch=batch, seq_len=seq, accum=c["accum"],
                            k=DATA_K,
                            steps=g["steps"], loss_chunk=g["loss_chunk"],
                            vocab=vocab, tokenizer_vocab=tok_vocab,
                            blocks=len(train)),
                checks=checks, runs=runs)


def wordpiece_sets(steps: int, val_batches: int, batch: int, seq_len: int):
    """SST-2-shaped (sentence, label) pairs of seeded synthetic sentences
    through the fixture WordPiece (``TokenizedDataset.from_texts``):
    [CLS] ... [SEP] then [PAD] (id 0) to ``seq_len``."""
    import numpy as np

    from ml_trainer_tpu_torch.data import TokenizedDataset
    from ml_trainer_tpu_torch.data.tokenizers import fixture_vocab_dir

    words = ("the fox sat on them and you like it over the training "
             "ended for quick jumping loader tiny model mesh").split()
    rng = np.random.default_rng(SEED)

    def make(n):
        texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 70))))
                 for _ in range(n)]
        labels = rng.integers(0, BERT_DATA["classes"], size=n)
        return TokenizedDataset.from_texts(
            texts, labels, max_len=seq_len, vocab_dir=fixture_vocab_dir(),
            tokenizer="wordpiece", vocab_size=BERT_DATA["vocab_size"])

    return make(steps * batch), make(val_batches * batch)


def data_bert(dev) -> dict:
    """BERT-base bf16 (right_padded: K1-K3 on the non-causal kv_lens
    path), 32 x 128, K = 4 on WordPiece data: exact launches and ms a
    step of the graph."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    c = DATA_BERT
    batch, seq = c["batch"], BERT_DATA["seq_len"]
    train, val = wordpiece_sets(c["steps"], c["val_batches"], batch, seq)
    lens = (train.data != 0).sum(axis=1)
    tr = mt.Trainer(
        _seeded_model("bert_base", seed=SEED, device=dev, right_padded=True),
        datasets=(train, val), epochs=1, batch_size=batch,
        metric="accuracy", seed=SEED, device=dev,
        model_dir=f"{DATA_DIR}/bert", steps_per_execution=DATA_K,
        **dict(BERT_05, precision="bf16"))
    rec = _data_fit("data bert", tr, depth=12, micro=c["steps"],
                    val=c["val_batches"])
    rec["step_ms"] = _graph_step_ms({"bert": tr})["bert"]["step_ms"]
    del tr
    _discard(DATA_DIR)
    torch.cuda.empty_cache()
    return dict(config=dict(model="bert_base", precision="bf16", batch=batch,
                            seq_len=seq, k=DATA_K, steps=c["steps"],
                            token_lens=[int(lens.min()), int(lens.max()),
                                        float(np.mean(lens))]), **rec)


def data(dev) -> dict:
    """Phase 10: ``native_checks``, ``data_resnet``, ``data_gpt2`` and
    ``data_bert``."""
    return dict(native=native_checks(dev), resnet50=data_resnet(dev),
                gpt2=data_gpt2(dev), bert=data_bert(dev))


# ------------------------------------------------------------- phase 11
# The Llama family (``models/llama.py``) at the full width of ``llama``
# (ml_trainer_tpu/models/llama.py:182-256): vocab 32000, 768 wide, 12
# deep, 12 query heads over 4 kv heads of 64, SwiGLU 2048, an untied
# float32 head, 124,668,672 parameters; at its max_len 2048, batch 4 in
# one microbatch: K1 at [4, 12, 2048, 64] causal, K2/K3 beside it, K/V
# repeated from 4 heads to 12 (autograd sums each group's dK/dV).
LLAMA = dict(seq_len=2048, vocab_size=32000, batch=4, steps=8,
             val_batches=1, k=DATA_K)  # _graph_step_ms times DATA_K
LLAMA_OPT = dict(optimizer="adamw", lr=3e-4, weight_decay=0.01,
                 grad_clip_norm=1.0)
LLAMA_RUNS = [  # (label, model kwargs, trainer kwargs)
    ("fp32_dense", {}, {}),
    ("bf16_chunked", {"loss_chunk": 256}, {"precision": "bf16"}),
]
LLAMA_DP_STEPS = 4  # the 2-replica sharded bf16 fit (K4/K5)
LLAMA_GEN = dict(batch=4, prompt=128, new_tokens=32, temperature=0.8)
LLAMA_BF16_LOGITS = 3e-2  # of max|plain logits|: bf16 prefill, kernel vs
#                           plain (the bf16 policy's CPU bar, Queue C 9)
LLAMA_DIR = "build/chip_smoke_llama"  # each fit's files; removed after
# The GPT-2 sizes (Queue A 6.2): one bf16 fit each at S = 1024, batch 4.
# The GPT-2 sizes at their published widths and heads, depth cut to 8
# blocks (24 and 36 published): the registrations' widths are what the
# fits check, and the epoch-end checkpoints of the full depths took most
# of the phase.
GPT2_SIZES = dict(names=("gpt2_medium", "gpt2_large"), seq_len=1024,
                  vocab_size=50257, batch=4, steps=4, val_batches=1,
                  depth=8)


def _token_fit(dev, what, name, model_kw, opt, c, k=1):
    """``Trainer.fit()`` of registry model ``name`` (seeded weights) on
    ``SyntheticTokens`` of ``c``: exact K1-K3 launches (depth a
    microbatch, replays counted; validation K1 only), finite losses, no
    skipped step.  Returns (trainer, record)."""
    import math
    import shutil

    import torch

    import ml_trainer_tpu_torch as mt

    run_dir = f"{LLAMA_DIR}/{what}"
    _discard(run_dir)
    sets = tuple(mt.SyntheticTokens(size=c["batch"] * n,
                                    seq_len=c["seq_len"],
                                    vocab_size=c["vocab_size"],
                                    seed=SEED + i)
                 for i, n in enumerate((c["steps"], c["val_batches"])))
    t0 = time.perf_counter()
    model = _seeded_model(name, seed=SEED, device=dev, **model_kw)
    init_s = time.perf_counter() - t0
    trainer = mt.Trainer(model, datasets=sets, epochs=1,
                         batch_size=c["batch"], metric=None,
                         model_dir=run_dir, seed=SEED, loader="python",
                         steps_per_execution=k, **opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, what)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    hist = trainer.history
    if not all(math.isfinite(v)
               for v in hist["train_loss"] + hist["val_loss"]):
        raise AssertionError(f"{what}: non-finite losses {hist}")
    if hist["skipped_steps"] != [0]:
        raise AssertionError(f"{what}: skipped steps "
                             f"{hist['skipped_steps']}")
    depth, n = trainer.model.depth, trainer.mesh.size
    micro = c["steps"] * n * trainer.grad_accum_steps
    want = {kname: 0 for kname in counts}
    want.update(flash_fwd=depth * (micro + c["val_batches"]),
                flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
    if trainer.dp_update == "sharded" and trainer.fused_adam:
        want.update(unscale_sqsum=n * c["steps"], fused_adam=n * c["steps"])
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    _discard(run_dir)
    return trainer, dict(
        init_s=init_s, fit_s=fit_s, peak_gb=torch.cuda.max_memory_allocated()
        / 1e9, launches=counts, step=trainer.state.step,
        loss_scale=loss_scale_record(trainer),
        history={key: hist[key] for key in ("train_loss", "val_loss",
                                            "skipped_steps")})


def llama_train(dev, label, model_kw, opt) -> dict:
    """One ``LLAMA_RUNS`` configuration at K = 1 and K = 4 (one CUDA
    graph replay a chunk) from the same seeded weights and data: the
    K = 4 run's parameters and optimizer state bitwise the K = 1 run's,
    the epoch losses within GRAPH_LOSS_RTOL; then the graph's step ms
    and tokens/s (``_graph_step_ms``, one replay profiled), and in bf16
    one step under the per-call check (every K1-K3 call within 2 bf16
    ulps of float64)."""
    import torch

    from ml_trainer_tpu_torch.data import prefetch_to_device

    c = LLAMA
    kw = dict(LLAMA_OPT, **opt)
    eager, rec_1 = _token_fit(dev, f"llama {label} K=1", "llama", model_kw,
                              kw, c, k=1)
    snap_1 = _named_state(eager)
    params = sum(p.numel() for p in eager.model.parameters())
    del eager
    torch.cuda.empty_cache()
    trainer, rec_k = _token_fit(dev, f"llama {label} K={c['k']}", "llama",
                                model_kw, kw, c, k=c["k"])
    first, worst_name, dist = _leaf_distance(_named_state(trainer), snap_1)
    loss_rel = _history_distance(
        dict(rec_k["history"], train_metric=[], val_metric=[]),
        dict(rec_1["history"], train_metric=[], val_metric=[]))
    if (first is not None or loss_rel > GRAPH_LOSS_RTOL
            or rec_k["step"] != rec_1["step"]
            or rec_k["loss_scale"] != rec_1["loss_scale"]):
        raise AssertionError(
            f"llama {label}: K = {c['k']} differs from K = 1 (first "
            f"{first}, worst {worst_name} {dist}, losses {loss_rel})")
    del snap_1
    timed = _graph_step_ms({label: trainer}, profile=True)[label]
    ms = timed["step_ms"]
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    depth = trainer.model.depth
    calls = train_call_check(trainer, x, y, depth)
    rec = dict(label=label, model="llama", parameters=params,
               precision=trainer.precision.label(),
               loss_chunk=trainer.model.loss_chunk, batch=c["batch"],
               seq_len=c["seq_len"], steps=c["steps"], k=c["k"],
               same_as_k1=dict(bitwise=True, loss_rel=loss_rel),
               eager=rec_1, graph=rec_k, graph_step_ms=ms,
               tokens_per_s=c["batch"] * c["seq_len"] * 1e3 / (sum(ms) / 2),
               profile_graph=timed["profile"], call_check=calls,
               launches_total={kn: rec_1["launches"][kn]
                               + rec_k["launches"][kn]
                               for kn in rec_1["launches"]})
    del trainer, x, y
    torch.cuda.empty_cache()
    return rec


def llama_dp(dev) -> dict:
    """One bf16 ``loss_chunk`` fit of LLAMA_DP_STEPS steps on 2 replicas
    sharing the card under ``dp_update="sharded"`` (adam, no decay: the
    fused tail), K4 = K5 = 2 launches a step; first, from one state and
    one batch, the sharded step with K4/K5 against the plain tail
    (``dp_step_check``)."""
    import torch

    from ml_trainer_tpu_torch.data import prefetch_to_device

    c = dict(LLAMA, steps=LLAMA_DP_STEPS)
    kw = dict(optimizer="adam", lr=3e-4, weight_decay=0.0,
              grad_clip_norm=1.0, precision="bf16", is_parallel=True,
              mesh_shape={"data": 2}, device=[dev] * 2,
              dp_update="sharded")
    trainer, rec = _token_fit(dev, "llama dp", "llama", {"loss_chunk": 256},
                              kw, c)
    if not (trainer.fused_adam and trainer.mesh.size == 2):
        raise AssertionError("llama dp: not the sharded step with K4/K5")
    x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
    rec["step_check"] = dp_step_check(trainer, None, x, y)
    del trainer, x, y
    torch.cuda.empty_cache()
    return rec


def llama_generate(dev, precision) -> dict:
    """``generate()`` of ``llama`` (seeded weights; ``precision``: None or
    "bf16") on [4, 128] prompts, 32 greedy tokens through the kernels
    (K1 for each layer's prefill) and through the plain path
    (``attention_impl="xla"``), then one seeded sampled run, twice.
    Gates: the prefill's logits from the kernels within the bar of the
    plain path's (float32 LOGIT_SLACK, bf16 LLAMA_BF16_LOGITS of their
    largest); the greedy tokens equal to the plain path's up to each
    row's first step whose top-2 margin (the plain path's logits, teacher
    forced) is within max(LOGIT_SLACK, 2 d) of a tie, d the prefill's
    logit difference; the cache at [4, 4, L, 64] per layer and K/V; K1
    12 launches a prefill; the sampled runs equal."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    g = LLAMA_GEN
    model = _seeded_model("llama", seed=SEED, device=dev, precision=precision)
    model.eval()
    depth, b, p, n = model.depth, g["batch"], g["prompt"], g["new_tokens"]
    prompts = np.random.default_rng(SEED + 9).integers(
        0, model.vocab_size, (b, p))
    ids = torch.as_tensor(prompts, device=dev)
    cache = model.new_cache(b, max_len=p + n)
    shape = tuple(cache.k[0].shape)
    if shape != (b, model.num_kv_heads, p + n, model.head_dim):
        raise AssertionError(f"llama cache {shape}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in cache.k + cache.v)
    logits, outs, ms = {}, {}, {}
    launches = {}
    for impl in ("flash", "xla"):
        model.attention_impl = impl
        want = depth if impl == "flash" else 0
        mt.reset_launch_counts()
        with torch.no_grad():
            logits[impl] = model(ids, model.new_cache(b, max_len=p + n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[impl] = mt.generate(model, prompts, n, device=dev)
        torch.cuda.synchronize()
        ms[impl] = (time.perf_counter() - t0) * 1e3
        counts = mt.launch_counts()
        if counts != dict(dict.fromkeys(counts, 0), flash_fwd=2 * want):
            raise AssertionError(f"llama generate {impl}: launches {counts}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    model.attention_impl = "auto"
    d = (logits["flash"] - logits["xla"]).abs().max().item()
    peak = logits["xla"].abs().max().item()
    bar = (LLAMA_BF16_LOGITS * peak if precision else LOGIT_SLACK)
    if not d <= bar:
        raise AssertionError(f"llama prefill ({precision}): kernel vs plain "
                             f"logits {d} > {bar}")
    # The plain path's margins along its own greedy sequences.
    model.attention_impl = "xla"
    with torch.no_grad():
        replay = model(outs["xla"][:, :-1])[:, p - 1:].float()
    model.attention_impl = "auto"
    top2 = replay.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    k_tok = outs["flash"][:, p:].cpu().numpy()
    x_tok = outs["xla"][:, p:].cpu().numpy()
    slack = max(LOGIT_SLACK, 2 * d)
    agree = []
    for row in range(b):
        diff = np.nonzero(k_tok[row] != x_tok[row])[0]
        if diff.size and not margin[row, diff[0]] <= slack:
            raise AssertionError(
                f"llama greedy ({precision}) row {row}: the kernels' token "
                f"{diff[0]} differs where the plain margin is "
                f"{margin[row, diff[0]]} > {slack}")
        agree.append(int(diff[0]) if diff.size else n)
    sampled = [mt.generate(model, prompts, n, temperature=g["temperature"],
                           rng=SEED, device=dev) for _ in range(2)]
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError(f"llama sampling ({precision}) does not repeat")
    if not bool((sampled[0] < model.vocab_size).all()):
        raise AssertionError("llama sampling: token out of the vocabulary")
    del model, cache, logits, replay
    torch.cuda.empty_cache()
    return dict(precision=precision or "float32", prompts=[b, p],
                new_tokens=n, cache_shape=list(shape),
                cache_bytes=cache_bytes, prefill_logit_diff=d,
                prefill_logit_bar=bar, margin_slack=slack,
                greedy_tokens_equal_before_divergence=agree,
                generate_ms=ms, tokens_per_s={
                    k: b * n * 1e3 / v for k, v in ms.items()},
                sampled_equal=True, launches=launches)


def gpt2_sizes(dev) -> list:
    """``gpt2_medium`` and ``gpt2_large`` (registrations only, the GPT2
    module at other widths) at ``GPT2_SIZES["depth"]`` blocks: one bf16
    fit each, exact launches, finite losses; step ms from CUDA events
    over 2 steps after the fit."""
    import torch

    from ml_trainer_tpu_torch.data import prefetch_to_device

    out = []
    c = GPT2_SIZES
    for name in c["names"]:
        trainer, rec = _token_fit(dev, f"gpt2 size {name}", name,
                                  {"depth": c["depth"]},
                                  dict(LLAMA_OPT, precision="bf16"), c)
        x, y = next(iter(prefetch_to_device(trainer.train_loader, 1, dev)))
        trainer._train_step(x, y, 1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            trainer._train_step(x, y, 1.0)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        out.append(dict(model=name, parameters=sum(
            p.numel() for p in trainer.model.parameters()),
            depth=trainer.model.depth, width=trainer.model.embed_dim,
            step_ms=ms, tokens_per_s=c["batch"] * c["seq_len"] * 1e3 / ms,
            **rec))
        del trainer, x, y
        torch.cuda.empty_cache()
    return out


def llama(dev) -> dict:
    """Phase 11: ``llama_train`` of each ``LLAMA_RUNS`` configuration,
    ``llama_dp``, ``llama_generate`` in float32 and bf16, and
    ``gpt2_sizes``."""
    import shutil

    rec = dict(train=[llama_train(dev, *run) for run in LLAMA_RUNS],
               dp=llama_dp(dev),
               generate=[llama_generate(dev, p) for p in (None, "bf16")],
               gpt2_sizes=gpt2_sizes(dev))
    _discard(LLAMA_DIR)
    return rec


# ------------------------------------------------------------- phase 12
# The training CLI, remat, dropout, the EMA and predict() at the JAX
# package's full widths.
CLI_DIR = "build/chip_smoke_cli"  # the CLI runs' files
# BASELINE config 5 from a shell: GPT-2 124M bf16 with remat 'dots' and
# an EMA in a CUDA graph of 4 steps; 4 steps and 2 validation batches an
# epoch (32 and 16 synthetic sequences of 1024).
CLI_ARGV = ["--model", "gpt2", "--synthetic_tokens", "--seq_len", "1024",
            "--vocab_size", "50257", "--dtype", "bf16", "--remat",
            "--remat_policy", "dots", "--ema_decay", "0.999",
            "--steps_per_execution", "4", "--optimizer", "adamw",
            "--grad_clip_norm", "1.0", "--batch_size", "8",
            "--synthetic_train_size", "32", "--synthetic_val_size", "16"]
CLI_TIMEOUT_S = 400
RATE = 0.1  # the BERT SST-2 recipe's dropout, used for every family here
EMA_DECAY = 0.999
# GPT-2 124M bf16 [8, 1024] in TRAIN's 4 microbatches, GPT2_OPT: 8 steps,
# two chunks of K = 4 (a warm-up with the capture, then a replay).
CLI_GPT2 = dict(seq_len=TRAIN["seq_len"], vocab_size=TRAIN["vocab_size"],
                batch=TRAIN["batch_size"], steps=8, val_batches=1)
# The variants timed as K = 4 graphs, each against the plain model.
CLI_VARIANTS = [  # (label, model kwargs, trainer kwargs)
    ("plain", {}, {}),
    ("remat_none", {"remat": True}, {}),
    ("remat_dots", {"remat": True, "remat_policy": "dots"}, {}),
    ("dropout", {"dropout_rate": RATE}, {}),
    ("ema", {}, {"ema_decay": EMA_DECAY}),
]
# gpt2_large bf16 [4, 1024] at K = 1, remat off then 'none' (full depth;
# remat off, it peaked near 35.6 GB): 2 steps timed after one.
CLI_LARGE = dict(seq_len=1024, vocab_size=50257, batch=4, steps=2)
# The EMA against its float64 recompute from the recorded params: d e
# rounds to float32, (1 - d) p too, and their sum.
EMA_F64_RTOL = 8 * 2.0 ** -24
# Dropout RATE at K = 1 and 4, one epoch of 8 steps each: GPT-2 124M's
# widths at CUT_DEPTH blocks, bf16 with the EMA, BERT-base bf16 (SST-2 recipe, 32 x 128 right
# padded) and ViT-B/16 bf16 (b 32) with the EMA.
CLI_FAMILIES = [  # (label, name, model kwargs, trainer kwargs, data, batch)
    ("gpt2", "gpt2", {"dropout_rate": RATE, "depth": CUT_DEPTH},
     dict(GPT2_OPT, precision="bf16", ema_decay=EMA_DECAY), "gpt2",
     TRAIN["batch_size"]),
    ("bert_base", "bert_base", {"right_padded": True, "dropout_rate": RATE},
     dict(BERT_05, precision="bf16"), "tokens", 32),
    ("vit_b16", "vit_b16", {"dropout_rate": RATE},
     dict(optimizer="adamw", lr=3e-4, weight_decay=0.1, precision="bf16",
          ema_decay=EMA_DECAY), "imagenet", 32),
]
CLI_STEPS = 8


def _cli_process(argv, model_dir):
    """``python -m ml_trainer_tpu_torch`` with ``argv`` and ``model_dir``,
    started from the checkout's root."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "ml_trainer_tpu_torch", *argv,
         "--model_dir", model_dir], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _cli_wait(what: str, proc, t0: float) -> float:
    """Wait for a CLI run; it must exit 0 and finish training.  Its
    seconds since ``t0``."""
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"cli {what}: no exit in {CLI_TIMEOUT_S} s")
    if proc.returncode != 0 or "Training Complete." not in out:
        raise AssertionError(f"cli {what}: exit {proc.returncode}\n"
                             + out[-4000:])
    return time.perf_counter() - t0


def _checkpoint_leaves(path: str) -> dict:
    """A checkpoint's leaves by path, as numpy (None stays None)."""
    from ml_trainer_tpu_torch.checkpoint import restore_checkpoint

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, tree

    return dict(walk(restore_checkpoint(path)[0]))


def _cli_in_process(argv, model_dir) -> dict:
    """``cli.main`` in this process, its K1-K5 launches counted."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch import cli

    torch.cuda.synchronize()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(cli.parse_args(argv + ["--model_dir", model_dir]))
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0,
                launches=mt.launch_counts())


def cli_compare(a_dir: str, c_dir: str, counts: dict) -> dict:
    """The resumed run (``a_dir``) against the uninterrupted one
    (``c_dir``): checkpoint_2's every leaf (params, EMA, optimizer state,
    step, counters) and the history bitwise; the in-process run's K1-K3
    launches exact (K1 twice a microbatch under remat, once a
    validation batch)."""
    import pickle

    import numpy as np

    got = _checkpoint_leaves(f"{a_dir}/checkpoints/checkpoint_2")
    want = _checkpoint_leaves(f"{c_dir}/checkpoints/checkpoint_2")
    differ = [k for k in want if k not in got or not (
        (got[k] is None and want[k] is None)
        or np.array_equal(np.asarray(got[k]), np.asarray(want[k])))]
    ema = [k for k in want if k.startswith("/ema_params/")]
    hist = []
    for d in (a_dir, c_dir):
        with open(f"{d}/history.pkl", "rb") as fp:
            hist.append(pickle.load(fp))
    keys = [k for k in hist[1] if hist[0].get(k) != hist[1][k]]
    if differ or not ema or keys or set(got) != set(want):
        raise AssertionError(f"cli: the resumed run differs: leaves "
                             f"{differ[:5]}, history {keys}, ema leaves "
                             f"{len(ema)}")
    # 2 epochs of 4 steps, each one microbatch of [8, 1024] (CLI_ARGV sets
    # no --grad_accum_steps), and 2 validation batches an epoch.
    epochs, steps, val, depth = 2, 4, 2, 12
    micro = epochs * steps
    want_counts = dict({k: 0 for k in counts},
                       flash_fwd=depth * (2 * micro + epochs * val),
                       flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
    if counts != want_counts:
        raise AssertionError(f"cli in process: launches {counts}, expected "
                             f"{want_counts}")
    return dict(bitwise=True, leaves=len(want), ema_leaves=len(ema),
                step=int(np.asarray(want["/step"])), history=hist[1])


def _seeded_pair(dev, name, model_kw):
    """Two models of ``name`` with one seeded init's weights."""
    import ml_trainer_tpu_torch as mt

    first = _seeded_model(name, seed=SEED, device=dev, **model_kw)
    second = mt.get_model(name, device=dev, **model_kw)
    second.load_state_dict(first.state_dict())
    return first, second


def _cli_trainer(dev, model, sets, batch, opt, k, metric=None):
    import ml_trainer_tpu_torch as mt

    return mt.Trainer(model, datasets=sets, epochs=1, batch_size=batch,
                      metric=metric, model_dir=f"{CLI_DIR}/fit", seed=SEED,
                      device=dev, loader="python", steps_per_execution=k,
                      **opt)


def _epoch_run(what: str, trainer) -> dict:
    """One training epoch through ``_train_one_epoch``, the loop ``fit()``
    runs (K = 1 batch by batch, K = 4 as graph replays), without the
    validation and checkpoint around it, the counters from 0: exact
    K1-K3 launches (the model's depth a forward, twice under remat, and
    a backward, each microbatch), finite losses, no skipped step."""
    import math

    import torch

    import ml_trainer_tpu_torch as mt

    torch.cuda.synchronize()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    trainer._train_one_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer._graphs.clear()
    counts = mt.launch_counts()
    want = {k: 0 for k in counts}
    depth = getattr(trainer.model, "depth", 0)
    if trainer.model.__class__.__name__ == "VisionTransformer":
        depth = 0  # 197 tokens: the plain attention path
    micro = (len(trainer.train_loader) * trainer.grad_accum_steps
             * trainer.mesh.size)
    fwd = micro * (2 if getattr(trainer.model, "remat", False) else 1)
    if depth:
        want.update(flash_fwd=depth * fwd, flash_bwd_dq=depth * micro,
                    flash_bwd_dkv=depth * micro)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    losses = trainer.train_losses
    if not all(math.isfinite(v) for v in losses) or (
            trainer.skipped_steps != [0]):
        raise AssertionError(f"{what}: losses {losses}, skipped "
                             f"{trainer.skipped_steps}")
    return dict(epoch_s=epoch_s, launches=counts, step=trainer.state.step,
                history=dict(train_loss=list(losses), val_loss=[],
                             train_metric=list(trainer.train_metrics),
                             val_metric=[]))


def _k_gate(what: str, rec_1: dict, snap_1: dict, trainer,
            rec_k: dict) -> dict:
    """The K = 4 run's state (``_named_state``: params, buffers, optimizer
    state, counters, EMA) bitwise the K = 1 run's, the losses within
    GRAPH_LOSS_RTOL (the epoch sums' order)."""
    first, worst, dist = _leaf_distance(_named_state(trainer), snap_1)
    loss_rel = _history_distance(rec_k["history"], rec_1["history"])
    if first is not None or loss_rel > GRAPH_LOSS_RTOL or (
            rec_k["step"] != rec_1["step"]):
        raise AssertionError(f"{what}: K = 4 differs from K = 1 (first "
                             f"{first}, worst {worst} {dist}, losses "
                             f"{loss_rel})")
    return dict(bitwise=True, loss_rel=loss_rel)


def _ema_f64_gate(what: str, trainer, before_ema: dict) -> float:
    """The EMA after one step against ``d e + (1 - d) p`` in float64 from
    the EMA before it and the params after it: each leaf within
    EMA_F64_RTOL of its largest entry.  The worst ratio."""
    d = trainer.ema_decay
    params = dict(trainer.model.named_parameters())
    worst = 0.0
    for k, e in trainer.state.ema_params.items():
        want = d * before_ema[k] + (1 - d) * params[k].detach().double().cpu()
        err = ((e.double().cpu() - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        if not err <= EMA_F64_RTOL:
            raise AssertionError(f"{what}: EMA {k} {err} from its float64 "
                                 f"recompute")
    return worst


def _family_sets(data: str, batch: int):
    if data == "gpt2":
        return _token_sets(CLI_STEPS, 1, batch)
    return model_sets(data, batch, CLI_STEPS)


def dropout_mask(dev) -> dict:
    """One dropout site of a GPT-2 step ([8, 1024, 768], site 7 of 25,
    step 5): the card's mask bitwise the CPU's, its kept share within 4
    sigma of 1 - RATE."""
    import torch

    from ml_trainer_tpu_torch.models.layers import DropoutStream

    shape, masks = (8, 1024, 768), []
    for device in (dev, "cpu"):
        stream = DropoutStream(sites=25, seed=SEED)
        stream.begin_step(torch.tensor(5, device=device))
        masks.append(stream.keep(7, shape, RATE, device).cpu())
    kept = masks[0].float().mean().item()
    sigma = (RATE * (1 - RATE) / masks[0].numel()) ** 0.5
    if not torch.equal(*masks) or abs(kept - (1 - RATE)) > 4 * sigma:
        raise AssertionError(f"cli mask: card vs CPU equal "
                             f"{torch.equal(*masks)}, kept {kept}")
    return dict(shape=list(shape), card_equals_cpu=True, kept=kept,
                sigmas=(kept - (1 - RATE)) / sigma)


def dropout_ema_fits(dev) -> dict:
    """Each CLI_FAMILIES run at K = 1 and K = 4 (``_epoch_run``) from one
    seeded init: bitwise (``_k_gate``).  Then on the K = 1 trainer:
    GPT-2's EMA after one more step against its float64 recompute;
    BERT's ``test()`` bitwise the same weights without dropout, and
    ``predict()`` bitwise the test path's softmax; ViT's EMA (and params)
    kept on a step whose batch is NaN (the ``nan_grad`` fault's
    ``_poison_batch``)."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.trainer import _poison_batch

    out = {}
    launches = {k: 0 for k in mt.launch_counts()}
    for label, name, model_kw, opt, data, batch in CLI_FAMILIES:
        sets = _family_sets(data, batch)
        metric = None if name == "gpt2" else "accuracy"
        m1, m4 = _seeded_pair(dev, name, model_kw)
        eager = _cli_trainer(dev, m1, sets, batch, opt, 1, metric)
        rec_1 = _epoch_run(f"cli {label} K=1", eager)
        snap_1 = _named_state(eager)
        graph = _cli_trainer(dev, m4, sets, batch, opt, DATA_K, metric)
        rec_k = _epoch_run(f"cli {label} K=4", graph)
        rec = dict(k1=rec_1, k4=rec_k, same_as_k1=_k_gate(
            f"cli {label}", rec_1, snap_1, graph, rec_k))
        for r in (rec_1, rec_k):
            for kname, n in r["launches"].items():
                launches[kname] += n
        del graph, snap_1, m4
        torch.cuda.empty_cache()
        x, y = next(iter(prefetch_to_device(eager.train_loader, 1, dev)))
        if label == "gpt2":
            before = {k: v.double().cpu()
                      for k, v in eager.state.ema_params.items()}
            eager._train_step(x, y, 1.0)
            rec["ema_f64_worst"] = _ema_f64_gate("cli gpt2 ema", eager,
                                                 before)
        elif label == "bert_base":
            # Eval: bitwise the same weights without dropout; predict()
            # bitwise the test path's softmax.
            _, built = eager.model.registry_config  # at the compute dtype
            plain = mt.get_model(name, **dict(built, dropout_rate=0.0))
            plain.load_state_dict(eager.model.state_dict())
            mt.reset_launch_counts()
            got = eager.test(None, eager.val_loader)
            want = eager.test(plain, eager.val_loader)
            if got != want:
                raise AssertionError(f"cli bert test(): {got} vs {want}")
            batches = [x for x, _ in prefetch_to_device(eager.val_loader,
                                                         1, dev)]
            pred = eager.predict(batches)
            with torch.no_grad():
                eager.model.eval()
                ref = np.concatenate([eager.pred_function(
                    eager._apply_model(eager.model, b)).cpu().numpy()
                    for b in batches])
            if not np.array_equal(pred, ref):
                raise AssertionError("cli bert predict() differs from the "
                                     "test path")
            counts = mt.launch_counts()
            for kname, n in counts.items():
                launches[kname] += n
            rec.update(test_bitwise_no_dropout=got, predict=dict(
                bitwise=True, shape=list(pred.shape), launches=counts))
            del plain
        else:
            # A NaN batch: the step is skipped, the EMA and params kept.
            ema = {k: v.clone() for k, v in eager.state.ema_params.items()}
            params = {k: v.detach().clone()
                      for k, v in eager.model.named_parameters()}
            skipped = int(eager.state.skipped_steps)
            eager._train_step(_poison_batch(x), y, 1.0)
            kept = all(torch.equal(v, ema[k]) for k, v in
                       eager.state.ema_params.items()) and all(
                torch.equal(v, params[k]) for k, v in
                eager.model.named_parameters())
            if not kept or int(eager.state.skipped_steps) != skipped + 1:
                raise AssertionError(f"cli {label}: a NaN step moved the "
                                     "EMA or was not skipped")
            rec["nan_step_keeps_ema"] = True
        out[label] = rec
        del eager, m1, x, y
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def dropout_ema_dp(dev) -> dict:
    """GPT-2 124M's widths at CUT_DEPTH blocks, bf16 with dropout RATE
    and the EMA on 2 sharded replicas (adam, no decay: K4/K5) against one
    card, from one state and batch (``dp_step_check``: the
    single-vs-sharded bar DP_SINGLE_ATOL, the masks of the whole batch on
    both); then one sharded step with K4 = K5 = 2 launches and its EMA
    against the float64 recompute."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    opt = dict(optimizer="adam", lr=3e-4, grad_clip_norm=1.0,
               grad_accum_steps=2, precision="bf16", ema_decay=EMA_DECAY)
    sets = _token_sets(2, 1, CLI_GPT2["batch"])
    one, two = _seeded_pair(dev, "gpt2", {"dropout_rate": RATE, **_CUT})
    single = _cli_trainer(dev, one, sets, CLI_GPT2["batch"], opt, 1)
    sharded = mt.Trainer(two, datasets=sets, epochs=1,
                         batch_size=CLI_GPT2["batch"], metric=None,
                         model_dir=f"{CLI_DIR}/dp", seed=SEED,
                         is_parallel=True, mesh_shape={"data": 2},
                         device=[dev, dev], dp_update="sharded",
                         loader="python", **opt)
    if not sharded.fused_adam:
        raise AssertionError("cli dp: the sharded step is not on K4/K5")
    x, y = next(iter(prefetch_to_device(sharded.train_loader, 1, dev)))
    check = dp_step_check(sharded, single, x, y)
    del single, one
    torch.cuda.empty_cache()
    before = {k: v.double().cpu() for k, v in sharded.state.ema_params.items()}
    mt.reset_launch_counts()
    sharded._train_step(x, y, 1.0)
    torch.cuda.synchronize()
    counts = mt.launch_counts()
    depth, micro = sharded.model.depth, 2 * sharded.grad_accum_steps
    want = dict({k: 0 for k in counts}, flash_fwd=depth * micro,
                flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro,
                unscale_sqsum=2, fused_adam=2)
    if counts != want:
        raise AssertionError(f"cli dp: launches {counts}, expected {want}")
    err = _ema_f64_gate("cli dp ema", sharded, before)
    del sharded, two, x, y
    torch.cuda.empty_cache()
    return dict(step_check=check, launches=counts, ema_f64_worst=err)


def llama_remat(dev) -> dict:
    """Llama 124.7M bf16 ``loss_chunk=256`` [4, 2048] with remat 'dots',
    one epoch of LLAMA's 8 steps at K = 1 and K = 4 (``_epoch_run``: 2 x
    depth K1 a microbatch) from one seeded init: bitwise."""
    import torch

    import ml_trainer_tpu_torch as mt

    c = LLAMA
    sets = tuple(mt.SyntheticTokens(size=c["batch"] * n,
                                    seq_len=c["seq_len"],
                                    vocab_size=c["vocab_size"],
                                    seed=SEED + i)
                 for i, n in enumerate((c["steps"], 1)))
    opt = dict(LLAMA_OPT, precision="bf16")
    m1, m4 = _seeded_pair(dev, "llama", {"loss_chunk": 256, "remat": True,
                                         "remat_policy": "dots"})
    eager = _cli_trainer(dev, m1, sets, c["batch"], opt, 1)
    rec_1 = _epoch_run("cli llama dots K=1", eager)
    snap_1 = _named_state(eager)
    del eager, m1
    torch.cuda.empty_cache()
    graph = _cli_trainer(dev, m4, sets, c["batch"], opt, c["k"])
    torch.cuda.reset_peak_memory_stats()
    rec_k = _epoch_run("cli llama dots K=4", graph)
    rec_k["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    same = _k_gate("cli llama dots", rec_1, snap_1, graph, rec_k)
    del graph, m4, snap_1
    torch.cuda.empty_cache()
    return dict(k1=rec_1, k4=rec_k, same_as_k1=same,
                launches={k: rec_1["launches"][k] + rec_k["launches"][k]
                          for k in rec_1["launches"]})


def _one_step_grads(trainer, x, y):
    """The summed gradients of one step's microbatches (``_local_grads``,
    the dropout keys of the trainer's step first) and its K1-K3
    launches; the card's peak over the state's bytes."""
    import torch

    import ml_trainer_tpu_torch as mt

    if trainer._dropout is not None:
        trainer._step_t.fill_(trainer.state.step)
        trainer._dropout.begin_step(trainer._step_t)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    grads, _, _ = trainer._local_grads(trainer._params(), x, y,
                                       trainer.state.loss_scale)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return ({k: v.detach().clone() for k, v in grads.items()},
            mt.launch_counts(),
            dict(peak_gb=peak / 1e9, above_state_gb=(peak - base) / 1e9))


def remat_dropout_ema_steps(dev) -> dict:
    """GPT-2 124M's widths at CUT_DEPTH blocks, bf16 [8, 1024],
    CLI_VARIANTS from one seeded init.  One step's gradients: remat
    'none' and 'dots' bitwise plain, dropout under 'dots' (the dropout
    model's own remat switched on) bitwise dropout alone, K1 launches 2
    x depth a microbatch under remat (K2/K3 depth), the peak of the
    step; then each variant's K = 4 graph, ms a step in turns
    (``_graph_step_ms``): remat's, the masks' and the EMA's cost beside
    the plain step."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    opt = dict(GPT2_OPT, precision="bf16")
    sets = _token_sets(CLI_GPT2["steps"], CLI_GPT2["val_batches"],
                       CLI_GPT2["batch"])
    weights = None
    trainers, recs, grads = {}, {}, {}
    launches = {k: 0 for k in mt.launch_counts()}

    def step_grads(label, tr, x, y):
        g, counts, mem = _one_step_grads(tr, x, y)
        depth, micro = tr.model.depth, tr.grad_accum_steps
        fwd = micro * (2 if tr.model.remat else 1)
        want = dict({k: 0 for k in counts}, flash_fwd=depth * fwd,
                    flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
        if counts != want:
            raise AssertionError(f"cli step {label}: launches {counts}, "
                                 f"expected {want}")
        for kname, n in counts.items():
            launches[kname] += n
        grads[label] = g
        return dict(launches=counts, step=mem)

    for label, model_kw, trainer_kw in CLI_VARIANTS:
        if weights is None:
            model = _seeded_model("gpt2", seed=SEED, device=dev, **model_kw,
                                  **_CUT)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model = mt.get_model("gpt2", device=dev, **model_kw, **_CUT)
            model.load_state_dict(weights)
        tr = _cli_trainer(dev, model, sets, CLI_GPT2["batch"],
                          dict(opt, **trainer_kw), DATA_K)
        x, y = next(iter(prefetch_to_device(tr.train_loader, 1, dev)))
        recs[label] = dict(model_kw=model_kw, trainer_kw=trainer_kw,
                           **step_grads(label, tr, x, y))
        if label == "dropout":
            tr.model.remat, tr.model.remat_policy = True, "dots"
            recs["dropout_dots"] = step_grads("dropout_dots", tr, x, y)
            tr.model.remat = False
        trainers[label] = tr
        del x, y
    del weights
    same = {}
    for got, ref in (("remat_none", "plain"), ("remat_dots", "plain"),
                     ("dropout_dots", "dropout")):
        first = next((k for k in grads[ref]
                      if not torch.equal(grads[got][k], grads[ref][k])), None)
        if first is not None:
            raise AssertionError(f"cli step: {got} gradients differ from "
                                 f"{ref} at {first}")
        same[f"{got}_vs_{ref}"] = "bitwise"
    if all(torch.equal(grads["dropout"][k], grads["plain"][k])
           for k in grads["plain"]):
        raise AssertionError("cli step: dropout did not change a gradient")
    del grads
    mt.reset_launch_counts()
    timed = _graph_step_ms(trainers, reps=1)
    for kname, n in mt.launch_counts().items():
        launches[kname] += n
    for label, t in timed.items():
        recs[label]["graph_step_ms"] = t["step_ms"]
    mean = {label: sum(t["step_ms"]) / len(t["step_ms"])
            for label, t in timed.items()}
    cost = {label: mean[label] - mean["plain"] for label in mean
            if label != "plain"}
    del trainers
    torch.cuda.empty_cache()
    return dict(config=dict(CLI_GPT2, k=DATA_K, accum=TRAIN["accum"],
                            precision="bf16", depth=CUT_DEPTH),
                variants=recs, gradients=same, ms_over_plain=cost,
                launches=launches)


def gpt2_large_remat(dev) -> dict:
    """gpt2_large bf16 [4, 1024], K = 1, remat off then 'none' on the same
    weights (``torch.manual_seed(SEED)``, the module's own init on the
    card): the peak of a training step and its ms (CUDA events over
    CLI_LARGE["steps"] steps after one)."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device

    c = CLI_LARGE
    sets = tuple(mt.SyntheticTokens(size=c["batch"] * n,
                                    seq_len=c["seq_len"],
                                    vocab_size=c["vocab_size"],
                                    seed=SEED + i)
                 for i, n in enumerate((c["steps"] + 1, 1)))
    out, weights = {}, None
    launches = {k: 0 for k in mt.launch_counts()}
    torch.manual_seed(SEED)
    for label, kw in (("off", {}), ("none", {"remat": True})):
        model = mt.get_model("gpt2_large", device=dev, **kw)
        if weights is not None:
            model.load_state_dict(weights)
            weights = None
        tr = _cli_trainer(dev, model, sets, c["batch"],
                          dict(GPT2_OPT, precision="bf16"), 1)
        batches = list(prefetch_to_device(tr.train_loader, 1, dev))
        mt.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr._train_step(*batches[0], 1.0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x, y in batches[1:]:
            tr._train_step(x, y, 1.0)
        end.record()
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        depth, micro = tr.model.depth, (c["steps"] + 1) * tr.grad_accum_steps
        fwd = micro * (2 if kw else 1)
        want = dict({k: 0 for k in counts}, flash_fwd=depth * fwd,
                    flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
        if counts != want:
            raise AssertionError(f"cli gpt2_large {label}: launches "
                                 f"{counts}, expected {want}")
        for kname, n in counts.items():
            launches[kname] += n
        out[label] = dict(peak_gb=peak / 1e9,
                          step_ms=start.elapsed_time(end) / c["steps"],
                          loss_scale=loss_scale_record(tr))
        if label == "off":
            weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
        del tr, model, batches
        torch.cuda.empty_cache()
    return dict(config=dict(c, model="gpt2_large", precision="bf16", k=1),
                runs=out, peak_ratio=out["none"]["peak_gb"]
                / out["off"]["peak_gb"], launches=launches)


def cli_phase(dev, smi: str) -> dict:
    """Phase 12.  The CLI as a user runs it, CLI_ARGV: a 1-epoch run in a
    subprocess beside a 2-epoch run through ``cli.main`` in this process
    (its launches counted), then the first continued with ``--resume
    --epochs 2`` in a subprocess (``cli_compare``).  While the
    subprocesses run, the parts that time nothing: ``dropout_mask``,
    ``llama_remat``, ``dropout_ema_fits``, ``dropout_ema_dp``; then,
    alone on the card, the timed parts: ``remat_dropout_ema_steps`` and
    ``gpt2_large_remat``.  Each part is printed as it ends."""
    import torch

    _discard(CLI_DIR)
    a_dir, c_dir = f"{CLI_DIR}/cli_a", f"{CLI_DIR}/cli_c"
    rec = {}

    def part(label, fn):
        t0 = time.perf_counter()
        rec[label] = fn(dev)
        rec[label]["part_s"] = time.perf_counter() - t0
        log(f"cli {label} on {smi}: " + json.dumps(rec[label]))

    t0 = time.perf_counter()
    a = _cli_process(CLI_ARGV + ["--epochs", "1"], a_dir)
    inproc = _cli_in_process(CLI_ARGV + ["--epochs", "2"], c_dir)
    torch.cuda.empty_cache()
    seconds = {"in_process_2_epochs": inproc["seconds"],
               "subprocess_1_epoch": _cli_wait("1 epoch", a, t0)}
    t1 = time.perf_counter()
    b = _cli_process(CLI_ARGV + ["--epochs", "2", "--resume"], a_dir)
    for label, fn in (("mask", dropout_mask), ("llama", llama_remat),
                      ("fits", dropout_ema_fits), ("dp", dropout_ema_dp)):
        part(label, fn)
    seconds["subprocess_resumed"] = _cli_wait("--resume --epochs 2", b, t1)
    rec["cli"] = dict(argv=CLI_ARGV, seconds=seconds,
                      launches=inproc["launches"],
                      resume=cli_compare(a_dir, c_dir, inproc["launches"]),
                      part_s=time.perf_counter() - t0)
    log(f"cli cli on {smi}: " + json.dumps(rec["cli"]))
    _discard(CLI_DIR)
    for label, fn in (("steps", remat_dropout_ema_steps),
                      ("gpt2_large", gpt2_large_remat)):
        part(label, fn)
    _discard(CLI_DIR)
    return rec


# LoRA (``--only lora``): GPT-2 124M trains a rank-8 adapter on qkv/proj
# over a frozen base at the training phase's shape, fp32 at K = 1 and
# bf16 at K = 1 and 4 (the gate: K = 4 bitwise K = 1), exports it, and a
# paged server with a pool of 4 rank-16 slots over all four projections
# serves it beside a second adapter and base rows.
LORA_TRAIN = dict(rank=8, alpha=16.0, targets=("qkv", "proj"))
LORA_POOL = dict(slots=4, rank=16,
                 targets=("qkv", "proj", "fc_in", "fc_out"))
LORA_STEPS, LORA_VAL, LORA_K = 8, 1, 4
LORA_DIR = "build/chip_smoke_lora"  # the runs' files; removed after
# The mixed batch: prompt lengths (each >= 128: K1 in every prefill) and
# adapters; two slots of the 8 stay free (they decode slot 0's zeros).
LORA_JOBS = [(130, None), (200, "trained"), (257, "second"), (140, None),
             (300, "second"), (180, "trained")]
LORA_NEW = 16
LORA_BF16_REL = 3e-2  # Queue C 9's bf16 logit bar: of the largest logit


def _lora_trainer(dev, model, precision, k, run_dir, lora=True):
    import ml_trainer_tpu_torch as mt

    c = TRAIN
    sets = _token_sets(LORA_STEPS, LORA_VAL, c["batch_size"])
    return mt.Trainer(
        model, datasets=sets, epochs=1, batch_size=c["batch_size"],
        grad_accum_steps=c["accum"], optimizer="adamw", lr=3e-4,
        weight_decay=0.01, scheduler="CosineAnnealingWarmRestarts",
        grad_clip_norm=1.0, metric=None, model_dir=run_dir, seed=SEED,
        loader="python", steps_per_execution=k, precision=precision,
        lora=mt.LoraConfig(**LORA_TRAIN) if lora else None, device=dev)


def lora_fit(dev, base, precision, k) -> tuple:
    """One LoRA fit over ``base`` (left untouched): exact K1-K3
    launches, none of K4-K7; finite losses, no skipped step; the frozen
    base bitwise ``base``'s weights, every adapter leaf moved."""
    import math

    import torch

    import ml_trainer_tpu_torch as mt

    what = f"lora {precision or 'fp32'} K={k}"
    run_dir = f"{LORA_DIR}/{what.replace(' ', '_')}"
    _discard(run_dir)
    trainer = _lora_trainer(dev, base, precision, k, run_dir)
    init = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
            if "_lora_" in n}
    torch.cuda.synchronize()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, what)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    hist = trainer.history
    if not all(math.isfinite(v) for v in hist["train_loss"]
               + hist["val_loss"]) or hist["skipped_steps"] != [0]:
        raise AssertionError(f"{what}: history {hist}")
    _want_launches(what, counts, trainer.model.depth,
                   LORA_STEPS * trainer.grad_accum_steps, LORA_VAL)
    own = dict(base.named_parameters())
    moved = 0
    for n, p in trainer.model.named_parameters():
        if "_lora_" in n:
            moved += int(not torch.equal(p, init[n]))
        elif not torch.equal(p, own[n]) or p.requires_grad:
            raise AssertionError(f"{what}: base leaf {n} moved")
    if moved != len(init):
        raise AssertionError(f"{what}: {len(init) - moved} adapter leaves "
                             "did not move")
    opt_bytes = sum(t.numel() * t.element_size() for t in
                    mt.ops.optimizers.tree_leaves(trainer.state.opt_state))
    _discard(run_dir)
    return trainer, dict(
        fit_s=fit_s, launches=counts, step=trainer.state.step,
        adapter_leaves=len(init), adapter_params=sum(
            t.numel() for t in init.values()),
        opt_state_bytes=opt_bytes, base_bitwise=True,
        history={key: hist[key] for key in ("train_loss", "val_loss",
                                            "skipped_steps")})


def lora_step_costs(dev, trainers: dict) -> dict:
    """Each trainer's eager step peak over what it holds before the step
    (CUDA allocator), then ms a step of its K = 4 graph, in turns
    (``_graph_step_ms``)."""
    import torch

    from ml_trainer_tpu_torch.data import prefetch_to_device

    out = {}
    for label, tr in trainers.items():
        x, y = next(iter(prefetch_to_device(tr.train_loader, 1, dev)))
        tr._train_step(x, y, 1.0)  # warm
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr._train_step(x, y, 1.0)
        torch.cuda.synchronize()
        out[label] = dict(step_peak_over_held_gb=(
            torch.cuda.max_memory_allocated() - held) / 1e9)
        del x, y
    timed = _graph_step_ms(trainers)
    for label in trainers:
        out[label]["graph_step_ms"] = timed[label]["step_ms"]
    return out


def _served_drive(engine, jobs, new_tokens: int) -> tuple:
    """Admit ``jobs`` (prompt, adapter) into slots 0.. of ``engine``,
    then step until every request finished; returns the tokens and the
    decode steps' logits of the jobs' rows [len(jobs), V] (each step's,
    copied; every job has the same budget, so each row is live at every
    step).  The free rows are left out: they decode stale state whose
    writes all land in the trash page, in an order no run fixes."""
    from ml_trainer_tpu_torch.serving.scheduler import Request

    reqs = [Request(prompt=p, max_new_tokens=new_tokens, adapter=a)
            for p, a in jobs]
    for slot, req in enumerate(reqs):
        if engine.admit(req, slot) != "active":
            raise AssertionError(f"lora serving: request {slot} not admitted"
                                 f" ({req.state}: {req.error})")
    logits = []
    step = engine._decode_logits

    def recorded():
        out = step()
        logits.append(out[:len(jobs)].clone())
        return out

    engine._decode_logits = recorded
    try:
        while engine.active_count():
            engine.step()
    finally:
        del engine._decode_logits
    return [list(r.tokens) for r in reqs], logits


def _train_mode_logits(model, prompt, tokens) -> "torch.Tensor":
    """The train-mode model's logits scoring ``tokens`` after ``prompt``
    (eager, one contiguous cache: the prompt's prefill, then one token a
    step): [len(tokens), V] float32."""
    import torch

    dev = model.device
    ids = torch.as_tensor(list(prompt) + list(tokens), device=dev)[None]
    n, p = len(tokens), len(prompt)
    with torch.no_grad():
        cache = model.new_cache(1, max_len=p + n)
        rows = [model(ids[:, :p], cache,
                      select=torch.tensor([p - 1], device=dev))[0]]
        for j in range(p, p + n - 1):
            rows.append(model(ids[:, j:j + 1], cache,
                              select=torch.zeros(1, dtype=torch.long,
                                                 device=dev))[0])
    return torch.stack(rows).float()


def lora_serve(dev, base, refs: dict, paths: dict, precision) -> dict:
    """The mixed batch through three paged engines (``paged_kernel``):
    with adapters and the decode graph, without adapters (graph), and
    with adapters eagerly.  Gates: the base rows' tokens equal and their
    logits bitwise the adapter-free engine's at every decode step; the
    graph's tokens and logits bitwise the eager engine's; each adapter
    row against its train-mode model ``refs[name]`` teacher-forced on
    the served tokens (fp32: greedy ``generate()``'s tokens, or a near-
    tie within LOGIT_SLACK at the first difference; bf16: logits within
    LORA_BF16_REL of the largest, each served token within that of the
    best); exact launches (K1 depth a prefill, K6 depth a decode step);
    then a hot-load after the capture, served with no second capture,
    bitwise the eager engine's.  Measured: the decode step's replay ms
    with adapters and without, in turns; one hot-load's upload ms."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.ops.kernels import _split
    from ml_trainer_tpu_torch.serving import (
        AdapterConfig,
        SlotDecodeEngine,
    )
    from ml_trainer_tpu_torch.serving.adapter_pool import prepare_upload

    rng = np.random.default_rng(SEED + 7)
    jobs = [(rng.integers(0, base.vocab_size, n).astype(np.int32), a)
            for n, a in LORA_JOBS]
    depth = base.depth
    kw = dict(max_batch=8, kv_page_size=16, paged_kernel=True, device=dev)

    def engine(adapters: bool, graph: bool):
        with decode_graph(graph):
            eng = SlotDecodeEngine(
                base, adapters=AdapterConfig(**LORA_POOL) if adapters
                else None, **kw)
        if adapters:
            for name in ("trained", "second"):
                eng.adapters.register(name, paths[name])
        return eng

    runs = {}
    for label, adapters, graph in (("lora", True, True),
                                   ("plain", False, True),
                                   ("lora_eager", True, False)):
        eng = engine(adapters, graph)
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            toks, logits = _served_drive(
                eng, [(p, a if adapters else None) for p, a in jobs],
                LORA_NEW)
        torch.cuda.synchronize()
        counts = mt.launch_counts()
        want = {k: 0 for k in counts}
        want.update(flash_fwd=depth * len(jobs),
                    paged_attention=depth * len(logits))
        if counts != want:
            raise AssertionError(f"lora serving {label} ({precision}): "
                                 f"launches {counts}, expected {want}")
        runs[label] = dict(engine=eng, tokens=toks, logits=logits,
                           launches=counts, s=time.perf_counter() - t0)
    if not _split.all_zero():
        raise AssertionError("a K6 ticket counter is not back at 0")
    lora, plain, eager = runs["lora"], runs["plain"], runs["lora_eager"]
    for step, (a, b, c) in enumerate(zip(lora["logits"], plain["logits"],
                                         eager["logits"])):
        if not torch.equal(a, c):
            raise AssertionError(f"lora serving ({precision}): graph logits "
                                 f"differ from eager at decode step {step}")
        for slot, (_, name) in enumerate(jobs):
            if name is None and not torch.equal(a[slot], b[slot]):
                raise AssertionError(
                    f"lora serving ({precision}): base row {slot} differs "
                    f"from the adapter-free engine at decode step {step}")
    for slot, (_, name) in enumerate(jobs):
        if lora["tokens"][slot] != eager["tokens"][slot] or (
                name is None and lora["tokens"][slot]
                != plain["tokens"][slot]):
            raise AssertionError(f"lora serving ({precision}): row {slot} "
                                 "tokens differ")
    # Adapter rows against the train-mode models.
    rows = {}
    for slot, (prompt, name) in enumerate(jobs):
        if name is None:
            continue
        toks = lora["tokens"][slot]
        ref = _train_mode_logits(refs[name], prompt, toks)
        served = torch.stack([lg[slot] for lg in lora["logits"]]).float()
        peak = ref.abs().max().item()
        diff = (served - ref[1:]).abs().max().item() / peak
        best = ref.max(-1).values
        got = ref[torch.arange(len(toks), device=dev),
                  torch.as_tensor(toks, device=dev)]
        gap = (best - got).max().item()
        rec = dict(adapter=name, logit_rel_diff=diff, worst_token_gap=gap)
        if precision is None:
            greedy = mt.generate(refs[name], prompt[None], LORA_NEW,
                                 device=dev)[0, len(prompt):].tolist()
            first = next((i for i, (a, b) in enumerate(zip(toks, greedy))
                          if a != b), None)
            rec["greedy_equal"] = first is None
            if first is not None and not (
                    (best[first] - got[first]).item() <= LOGIT_SLACK):
                raise AssertionError(
                    f"lora serving fp32: row {slot} ({name}) differs from "
                    f"generate() at token {first}: {rec}")
        elif not (diff <= LORA_BF16_REL and gap <= LORA_BF16_REL * peak):
            raise AssertionError(f"lora serving bf16: row {slot} ({name}) "
                                 f"off its train-mode model: {rec}")
        rows[slot] = rec
    # Base rows against adapter rows of the same engine: the adapters act.
    acted = sum(lora["tokens"][s] != plain["tokens"][s]
                for s, (_, a) in enumerate(jobs) if a == "second")
    # Hot-load after the capture: no second capture; the next replays
    # serve the new adapter, bitwise the eager engine's.
    graph = lora["engine"]._graph
    cap_s = graph.capture_s
    late_jobs = [(jobs[0][0], "late"), (jobs[1][0], None)]
    late = {}
    for label in ("lora", "lora_eager"):
        eng = runs[label]["engine"]
        t0 = time.perf_counter()
        meta = eng.adapters.register("late", paths["late"])
        reg_s = time.perf_counter() - t0
        with torch.no_grad():
            late[label] = _served_drive(eng, late_jobs, LORA_NEW)
        late[label + "_register_s"] = reg_s
    if lora["engine"]._graph is not graph or graph.capture_s != cap_s:
        raise AssertionError("lora serving: the hot-load recaptured")
    diffs = [(a - b).abs().max().item()
             for a, b in zip(late["lora"][1], late["lora_eager"][1])]
    if late["lora"][0] != late["lora_eager"][0] or any(diffs):
        raise AssertionError(
            f"lora serving ({precision}): the hot-loaded adapter's replay "
            f"differs from the eager engine: tokens equal "
            f"{late['lora'][0] == late['lora_eager'][0]}, logit diff by "
            f"step {diffs}")
    # One hot-load's cost: the host's prepare_upload, then the copies
    # into a slot (host clock around a synchronize).
    # ("late" again, into its own slot: the same bytes as any adapter.)
    eng = lora["engine"]
    art = eng.adapters.artifact("late")
    t0 = time.perf_counter()
    prepared = prepare_upload(*art, eng._stack_shapes, eng.adapters.rank)
    prep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._upload(prepared, eng.adapters._slot_of["late"])
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    # The decode step's replay with adapters and without, in turns: all
    # eight slots live (six requests and two free rows), 20 replays each.
    step_ms = {"lora": [], "plain": []}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for label in ("plain", "lora", "lora", "plain"):
        g = runs[label]["engine"]._graph
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(20):
            g.replay()
        ev[1].record()
        torch.cuda.synchronize()
        step_ms[label].append(ev[0].elapsed_time(ev[1]) / 20)
    stacks = sum(b.numel() * b.element_size() for b in eng._stacks.values())
    out = dict(
        precision=precision or "fp32", rows=rows,
        second_adapter_rows_changed=int(acted),
        launches={label: r["launches"] for label, r in runs.items()},
        decode_steps=len(lora["logits"]), serve_s={
            label: r["s"] for label, r in runs.items()},
        base_rows_bitwise=True, graph_bitwise_eager=True,
        hot_load=dict(recaptured=False, register_s=late["lora_register_s"],
                      prepare_ms=prep_s * 1e3, upload_ms=upload_s * 1e3,
                      meta_rank=meta["rank"]),
        decode_replay_ms=step_ms, adapter_stack_bytes=stacks,
        adapters_resident=eng.adapters.resident())
    for r in runs.values():
        r["engine"].close()
    return out


def lora_export_torch(dev) -> dict:
    """``export_torch`` of an MLModel trained on the card (2 steps, an
    EMA) against the export of the same state on the CPU, with and
    without ``ddp_prefix``: the same keys, bitwise the same arrays."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.train_state import load_state_tree, state_tree

    out = {}
    t = mt.custom_pre_process_function()
    sets = (mt.SyntheticCIFAR10(size=64, transform=t, seed=SEED),
            mt.SyntheticCIFAR10(size=32, transform=t, seed=SEED + 1))
    made = []
    for device in (dev, "cpu"):
        run_dir = f"{LORA_DIR}/export_{torch.device(device).type}"
        made.append(mt.Trainer(
            _seeded_model("mlmodel", seed=SEED, device=device),
            datasets=sets, epochs=1, batch_size=32, lr=0.01, ema_decay=0.9,
            loader="python", model_dir=run_dir, device=device))
    card, cpu = made
    fit_whole(card, "export_torch MLModel")
    tree = state_tree(card.state, card.model)

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return None if x is None else np.asarray(
            x.cpu() if isinstance(x, torch.Tensor) else x)

    load_state_tree(cpu.state, cpu.model, host(tree))
    for ddp in (False, True):
        a = torch.load(card.export_torch(f"{LORA_DIR}/card.pth",
                                         ddp_prefix=ddp))
        b = torch.load(cpu.export_torch(f"{LORA_DIR}/cpu.pth",
                                        ddp_prefix=ddp))
        if list(a) != list(b) or not all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                for k in a):
            raise AssertionError(f"export_torch (ddp_prefix={ddp}): the "
                                 "card's file differs from the CPU's")
        out["ddp" if ddp else "plain"] = dict(keys=len(a), bitwise=True)
    return out


def lora_phase(dev) -> dict:
    import gc

    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.lora import (
        LoraConfig,
        base_fingerprint,
        export_lora_artifact,
    )
    from ml_trainer_tpu_torch.models.layers import init_lora

    _discard(LORA_DIR)
    os.makedirs(LORA_DIR, exist_ok=True)
    rec = {}
    base = _seeded_model("gpt2", seed=SEED, device=dev)
    fp32, rec["train_fp32"] = lora_fit(dev, base, None, 1)
    bf16_1, rec["train_bf16_k1"] = lora_fit(dev, base, "bf16", 1)
    snap_1 = _named_state(bf16_1)
    del bf16_1
    gc.collect()
    torch.cuda.empty_cache()
    bf16_k, rec["train_bf16_k4"] = lora_fit(dev, base, "bf16", LORA_K)
    first, worst, dist = _leaf_distance(_named_state(bf16_k), snap_1)
    if first is not None or rec["train_bf16_k4"]["step"] != LORA_STEPS:
        raise AssertionError(f"lora bf16: K = {LORA_K} differs from K = 1 "
                             f"(first {first}, worst {worst} {dist})")
    rec["k4_bitwise_k1"] = True
    del snap_1
    # The adapters: the trained one, a second of rank 16 over all four
    # projections (A as the train-mode init, B with real mass), and one
    # more of rank 4 for the hot-load after the capture.
    paths = {"trained": f"{LORA_DIR}/trained.npz"}
    meta = fp32.export_lora(paths["trained"], name="trained")
    fp = base_fingerprint(base)
    if meta["base_fingerprint"] != fp:
        raise AssertionError(f"lora: exported fingerprint "
                             f"{meta['base_fingerprint']} != base's {fp}")
    # The train-mode reference as exported (the step costs below take
    # more steps on the trainer).
    refs = {"trained": fp32.model.clone(share=False)}
    for name, rank, seed in (("second", 16, 1), ("late", 4, 2)):
        m = base.clone(lora_rank=rank, lora_alpha=2.0 * rank,
                       lora_targets=LORA_POOL["targets"])
        init_lora(m, SEED + seed)
        gen = torch.Generator().manual_seed(SEED + seed)
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n.endswith("_lora_B"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        paths[name] = f"{LORA_DIR}/{name}.npz"
        export_lora_artifact(m, LoraConfig(rank, 2.0 * rank,
                                           LORA_POOL["targets"]),
                             paths[name], name=name)
        refs[name] = m
    rec["artifact"] = dict(meta, fingerprint_equal=True)
    # What a LoRA step costs against a full fine-tune at the same shape.
    fulls = {}
    for precision in (None, "bf16"):
        model = _seeded_model("gpt2", seed=SEED, device=dev)
        fulls[precision] = _lora_trainer(dev, model, precision, 1,
                                         f"{LORA_DIR}/full", lora=False)
    rec["step_costs"] = lora_step_costs(dev, {
        "lora_fp32": fp32, "full_fp32": fulls[None],
        "lora_bf16": bf16_k, "full_bf16": fulls["bf16"]})
    rec["opt_state_bytes"] = {
        "lora": rec["train_fp32"]["opt_state_bytes"],
        "full": sum(t.numel() * t.element_size() for t in
                    mt.ops.optimizers.tree_leaves(
                        fulls[None].state.opt_state))}
    del fulls, bf16_k
    gc.collect()
    torch.cuda.empty_cache()
    base.eval()
    rec["serve_fp32"] = lora_serve(dev, base, refs, paths, None)
    base16 = base.clone(dtype=torch.bfloat16)
    refs16 = {n: m.clone(dtype=torch.bfloat16) for n, m in refs.items()}
    rec["serve_bf16"] = lora_serve(dev, base16, refs16, paths, "bf16")
    del base16, refs16, refs, fp32
    gc.collect()
    torch.cuda.empty_cache()
    rec["export_torch"] = lora_export_torch(dev)
    _discard(LORA_DIR)
    total = {}
    for key in ("train_fp32", "train_bf16_k1", "train_bf16_k4"):
        for kname, n in rec[key]["launches"].items():
            total[kname] = total.get(kname, 0) + n
    for key in ("serve_fp32", "serve_bf16"):
        for counts in rec[key]["launches"].values():
            for kname, n in counts.items():
                total[kname] = total.get(kname, 0) + n
    rec["launches"] = total
    if any(total[k] for k in ("unscale_sqsum", "fused_adam",
                              "int8_matmul")):
        raise AssertionError(f"lora: K4/K5/K7 launched: {total}")
    return rec


# The notebook flows (``--only examples``): the port's examples/torch_port
# counterparts run as a user runs them, each script's main() through
# runpy in this process (K1-K3 counted), then lamb, lion and adafactor on
# GPT-2 124M bf16 at TRAIN's shape against adamw.
EXAMPLES_DIR = "build/chip_smoke_examples"  # the runs' files; removed after
EX_04 = dict(MODEL="gpt2", SEQ_LEN="1024", BATCH="8", ACCUM="4", REMAT="1",
             K="4", SYNTH_SIZE="64", EPOCHS="1")  # 8 steps, 4 val batches
EX_05 = dict(MODEL="bert_base", MAX_LEN="128", BATCH="32", EPOCHS="1")
EX_METRIC_ATOL = 1e-6  # 03's loss and accuracy vs trainer.test of 01's
EX_OPTIMIZERS = ("adamw", "lamb", "lion", "adafactor")
EX_OPT_TURNS = 1  # timed rounds, each optimizer twice a round


def _run_example(name: str, env: dict, argv=()):
    """``examples/torch_port/<name>``'s ``main()`` as ``python <name>
    <argv>`` runs it from the checkout's root, with ``env`` set: what it
    returns, its seconds and the kernels' launches it made."""
    import runpy

    import torch

    import ml_trainer_tpu_torch as mt

    root = os.path.dirname(os.path.abspath(__file__))
    where = os.path.join(root, "examples", "torch_port")
    saved_env = {k: os.environ.get(k) for k in env}
    saved_argv, saved_path = sys.argv, list(sys.path)
    os.environ.update(env)
    sys.argv = [name, *argv]
    sys.path.insert(0, where)
    sys.modules.pop("_bootstrap", None)
    try:
        ns = runpy.run_path(os.path.join(where, name), run_name="example")
        torch.cuda.synchronize()
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        out = ns["main"]()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, mt.launch_counts()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        sys.argv, sys.path[:] = saved_argv, saved_path
        sys.modules.pop("_bootstrap", None)


def _exact_launches(what: str, counts: dict, **want) -> None:
    full = dict({k: 0 for k in counts}, **want)
    if counts != full:
        raise AssertionError(f"examples {what}: launches {counts}, "
                             f"expected {full}")


def _finite_history(what: str, history: dict, epochs: int) -> dict:
    import math

    if history["epochs"] != list(range(1, epochs + 1)) or not all(
            math.isfinite(v) for v in history["train_loss"]
            + history["val_loss"]):
        raise AssertionError(f"examples {what}: history {history}")
    return {k: v for k, v in history.items()
            if k in ("train_loss", "val_loss", "train_metric",
                     "val_metric")}


def examples_01_03(dev) -> dict:
    """01 at its defaults (MLModel, 6 epochs of 2048 synthetic images),
    then 03 on 01's directory and on the same trainer's ``export_torch``
    file: the loaded weights bitwise the trained ones, leaf for leaf,
    and 03's loss and accuracy within EX_METRIC_ATOL of ``trainer.test``
    of the in-memory model on 03's loader."""
    import json as _json

    import torch

    import ml_trainer_tpu_torch as mt

    d = f"{EXAMPLES_DIR}/m01"
    golden = f"{EXAMPLES_DIR}/golden01.json"
    (trainer, _, loss, acc), secs, counts = _run_example(
        "01_local_training.py", {"MODEL_DIR": d, "GOLDEN_OUT": golden})
    _exact_launches("01", counts)
    with open(golden) as fp:
        record = _json.load(fp)
    rec = dict(seconds=secs, fit_wall_s=record["fit_wall_secs"],
               samples_per_s=record["train_samples_per_sec_incl_compile"],
               history=_finite_history("01", record["history"], 6),
               test_loss=loss, test_accuracy=acc)
    val = mt.SyntheticCIFAR10(size=512, seed=1,
                              transform=mt.custom_pre_process_function())
    want = trainer.test(None, mt.Loader(val, batch_size=32, shuffle=True))
    trained = {k: v.detach().cpu() for k, v in
               trainer.model.state_dict().items()}
    path = trainer.export_torch(f"{EXAMPLES_DIR}/export.pth")
    for label, argv in (("dir", ()), ("export_torch", (path,))):
        (model, loss3, acc3), secs3, counts3 = _run_example(
            "03_testing.py", {"MODEL_DIR": d}, argv)
        _exact_launches(f"03 {label}", counts3)
        differ = [k for k, v in trained.items()
                  if not torch.equal(model.state_dict[k].cpu(), v)]
        dl, da = abs(loss3 - want[0]), abs(acc3 - want[1])
        if differ or dl > EX_METRIC_ATOL or da > EX_METRIC_ATOL:
            raise AssertionError(f"examples 03 {label}: leaves {differ}, "
                                 f"loss {loss3} vs {want[0]}, accuracy "
                                 f"{acc3} vs {want[1]}")
        rec[f"03_{label}"] = dict(seconds=secs3, loss=loss3, accuracy=acc3,
                                  loss_diff=dl, accuracy_diff=da,
                                  bitwise_leaves=len(trained))
    return rec


def examples_02(dev) -> dict:
    """02 at its defaults: ResNet-18 on 4096 synthetic CIFAR images,
    batch 256, 2 epochs, on 2 replicas that share the card."""
    trainer, secs, counts = _run_example(
        "02_distributed_training.py",
        {"MODEL_DIR": f"{EXAMPLES_DIR}/m02"})
    _exact_launches("02", counts)
    if trainer.mesh.size != 2:
        raise AssertionError(f"examples 02: {trainer.mesh.size} replicas")
    n = len(trainer.train_loader.dataset) * trainer.epochs
    return dict(seconds=secs, replicas=trainer.mesh.size,
                samples_per_s=n / secs,
                history=_finite_history("02", trainer.history, 2))


def examples_04(dev) -> dict:
    """04 at BASELINE config 5's widths (EX_04: GPT-2 124M, [8, 1024] in
    4 microbatches, remat, K = 4): 1 epoch of 8 steps, then RESUME=1
    EPOCHS=2 (epoch 2 only), then its sampled continuation.  K1 runs
    twice a microbatch (remat's recompute) and once a validation batch;
    each run's launches exact."""
    env = dict(EX_04, MODEL_DIR=f"{EXAMPLES_DIR}/m04")
    depth, micro, val = 12, 8 * 4, 32 // 8
    want = dict(flash_fwd=depth * (2 * micro + val),
                flash_bwd_dq=depth * micro, flash_bwd_dkv=depth * micro)
    rec = {}
    for label, extra, epochs in (("fit", {}, 1),
                                 ("resumed", dict(RESUME="1", EPOCHS="2"),
                                  2)):
        (trainer, sampled), secs, counts = _run_example("04_gpt2_pretrain.py",
                                                        dict(env, **extra))
        # The continuation adds none: its 4-token prefill against a
        # 20-slot cache and its decode steps take the plain path.
        _exact_launches(f"04 {label}", counts, **want)
        if len(sampled) != 16 or not all(0 <= t < 50257 for t in sampled):
            raise AssertionError(f"examples 04 {label}: sampled {sampled}")
        rec[label] = dict(seconds=secs, tokens_per_s=8 * 8 * 1024 / secs,
                          history=_finite_history(f"04 {label}",
                                                  trainer.history, epochs),
                          launches=counts, sampled=sampled,
                          step=trainer.state.step)
    if rec["resumed"]["history"]["train_loss"][0] != rec["fit"]["history"][
            "train_loss"][0] or rec["resumed"]["step"] != 16:
        raise AssertionError(f"examples 04: the resumed run lost epoch 1: "
                             f"{rec}")
    return rec


def examples_05(dev) -> dict:
    """05 at EX_05 (BERT-base, [32, 128], right-padded: K1-K3 on the
    kv_lens path): 96 training sentences (3 steps), 32 to validate."""
    trainer, secs, counts = _run_example(
        "05_bert_finetune.py", dict(EX_05, MODEL_DIR=f"{EXAMPLES_DIR}/m05"))
    depth, steps, val = 12, 3, 1
    _exact_launches("05", counts, flash_fwd=depth * (steps + val),
                    flash_bwd_dq=depth * steps, flash_bwd_dkv=depth * steps)
    return dict(seconds=secs, samples_per_s=96 / secs, launches=counts,
                history=_finite_history("05", trainer.history, 1))


def _restore_in_place(trainer, snap) -> None:
    """``_snapshot``'s values written into the tensors the trainer holds
    now (a captured graph keeps reading them)."""
    import torch

    from ml_trainer_tpu_torch.ops.optimizers import tree_leaves

    with torch.no_grad():
        for (k, v), t in zip(snap[0].items(),
                             trainer.model.state_dict().values()):
            t.copy_(v)
        for t, v in zip(tree_leaves(trainer.state.opt_state),
                        tree_leaves(snap[1])):
            t.copy_(v)
        if snap[2] is not None:
            trainer.state.loss_scale.copy_(snap[2][0])
            trainer.state.good_steps.copy_(snap[2][1])
    trainer.state.step = 0


def examples_optimizers(dev) -> dict:
    """lamb, lion and adafactor beside adamw on GPT-2 124M bf16 at TRAIN's
    shape (GPT2_OPT, K = 4): for each, from one state, 4 eager steps
    against one replay of the captured chunk, every parameter and state
    leaf bitwise, and the optimizer state's bytes; then, the four graphs
    held at once, the ms a step of one replay each in turns (EX_OPT_TURNS
    rounds of adamw, lamb, lion, adafactor and back; CUDA events)."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import prefetch_to_device
    from ml_trainer_tpu_torch.ops.optimizers import tree_leaves
    from ml_trainer_tpu_torch.trainer import _chunk_batches

    rec, trainers, launches = {}, {}, {}
    for name in EX_OPTIMIZERS:
        model = _seeded_model("gpt2", seed=SEED, device=dev)
        trainer = mt.Trainer(
            model, datasets=_token_sets(GRAPH_K, 1, TRAIN["batch_size"]),
            epochs=1, batch_size=TRAIN["batch_size"], metric=None,
            model_dir=f"{EXAMPLES_DIR}/opt", seed=SEED, device=dev,
            steps_per_execution=GRAPH_K, loader="python", precision="bf16",
            **dict(GPT2_OPT, optimizer=name))
        xs, ys = next(iter(prefetch_to_device(
            _chunk_batches(trainer.train_loader, GRAPH_K, []), size=1,
            device=dev)))
        trainer._lr_t.fill_(1.0)
        snap = _snapshot(trainer)
        torch.cuda.synchronize()
        mt.reset_launch_counts()
        for x, y in zip(xs, ys):
            trainer._train_step(x, y, 1.0)
        eager = _named_state(trainer, host=False)
        _restore_in_place(trainer, snap)
        t0 = time.perf_counter()
        trainer._dispatch("train", trainer._train_chunk, xs, ys)
        torch.cuda.synchronize()
        first_dispatch_s = time.perf_counter() - t0
        _restore_in_place(trainer, snap)
        trainer._dispatch("train", trainer._train_chunk, xs, ys)
        first, worst, dist = _leaf_distance(
            _named_state(trainer, host=False), eager)
        if first is not None:
            raise AssertionError(f"examples {name}: the K = {GRAPH_K} "
                                 f"replay differs from {GRAPH_K} eager "
                                 f"steps (first {first}, worst {worst} "
                                 f"{dist})")
        rec[name] = dict(
            graph_bitwise_eager=True, leaves=len(eager),
            first_dispatch_s=first_dispatch_s,
            capture_s=next(iter(trainer._graphs.values())).capture_s,
            opt_state_bytes=sum(t.numel() * t.element_size() for t in
                                tree_leaves(trainer.state.opt_state)),
            replay_ms_per_step=[])
        trainers[name] = (trainer, xs, ys, mt.launch_counts())
        del model, snap, eager
        gc.collect()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    order = list(EX_OPTIMIZERS)
    for name in (order + order[::-1]) * EX_OPT_TURNS:
        trainer, xs, ys, _ = trainers[name]
        mt.reset_launch_counts()
        start.record()
        trainer._dispatch("train", trainer._train_chunk, xs, ys)
        end.record()
        torch.cuda.synchronize()
        rec[name]["replay_ms_per_step"].append(start.elapsed_time(end)
                                               / GRAPH_K)
        counts = mt.launch_counts()
        trainers[name][3].update({k: trainers[name][3][k] + n
                                  for k, n in counts.items()})
    for name, (trainer, _, _, counts) in trainers.items():
        # 4 eager steps, the warm-up chunk, 1 + 2 * EX_OPT_TURNS replays.
        steps = GRAPH_K * (3 + 2 * EX_OPT_TURNS)
        micro = steps * TRAIN["accum"]
        _exact_launches(f"optimizer {name}", counts,
                        flash_fwd=12 * micro, flash_bwd_dq=12 * micro,
                        flash_bwd_dkv=12 * micro)
        rec[name]["launches"] = counts
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        trainer._graphs.clear()
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = launches
    return rec


def examples_phase(dev, smi: str) -> dict:
    """Phase 14.  The notebook flows as a user runs them (01 -> 03 twice,
    02, 04 fit -> resume -> sample, 05), then the three optimizers; each
    part printed as it ends, with its seconds and rates."""
    import torch

    _discard(EXAMPLES_DIR)
    os.makedirs(EXAMPLES_DIR, exist_ok=True)
    rec = {}
    for label, fn in (("01_03", examples_01_03), ("02", examples_02),
                      ("04", examples_04), ("05", examples_05),
                      ("optimizers", examples_optimizers)):
        t0 = time.perf_counter()
        rec[label] = fn(dev)
        rec[label]["part_s"] = time.perf_counter() - t0
        log(f"examples {label} on {smi}: " + json.dumps(rec[label]))
        gc.collect()
        torch.cuda.empty_cache()
    _discard(EXAMPLES_DIR)
    total = {}
    for counts in ([rec["04"][k]["launches"] for k in ("fit", "resumed")]
                   + [rec["05"]["launches"],
                      rec["optimizers"]["launches"]]):
        for kname, n in counts.items():
            total[kname] = total.get(kname, 0) + n
    rec["launches"] = total
    return rec


# ------------------------------------------------------------- phase 15
# One process per replica over torch.distributed (ROADMAP.md Queue A
# 2b.8b) and the committed JPEG shards on the card (2b.6c).  The card's
# machine has one H100: NCCL is driven at world size 1 and two ranks
# share cuda:0 over gloo; two NCCL ranks on distinct cards are not run.
DIST_DIR = "build/chip_smoke_dist"  # the runs' files; removed after
DIST_JPEG = "tests/fixtures/jpeg224"  # 64 images, make_jpeg224.py
DIST_GPT = dict(seq_len=1024, vocab_size=50257, batch=8, steps=4)
DIST_GPT_OPT = dict(optimizer="adam", lr=3e-4, metric=None, seed=SEED,
                    loader="python")
DIST_RESNET = dict(batch=32, epochs=2)  # 64 images: 2 steps an epoch
# SGD with momentum at a tenth of the reference's 0.01: at 0.01 four
# steps from random weights already diverge (validation loss 4.5 -> 22-37
# in three reorderings of one fit, on an H100), and a distance between
# two fits then says nothing.
DIST_RESNET_OPT = dict(optimizer="sgd", momentum=0.9, lr=1e-3)
DIST_PLANT = 1 + 2 ** -10  # the planted desync's factor on rank 1
# Synced BatchNorm (flax's E[x^2] - E[x]^2 over sums added across the
# processes) after 4 float32 SGD steps of ResNet-50, against the
# one-process fit of two replicas in the same arithmetic: within this
# many times the distance of that fit from itself with the two ranks'
# rows swapped in the global batch (the same sums in another order).  A
# distance is ||a - b|| / ||b|| over all the parameters, and apart over
# all the BatchNorm buffers: four steps lift float32 reorderings to
# percents of a single BatchNorm bias or running mean (its worst leaf,
# recorded beside), so the bar is set by the run.  It must sit below the
# distance of the same fit with per-replica statistics (each rank's 16
# rows normalised alone, in flax's arithmetic), on the parameters and on
# the buffers, or it detects nothing and the phase fails.  On an H100
# every reordering (the synced ranks, cuDNN's statistics) lands at
# 1.00-1.09 times the floor on both norms, per-replica statistics at 1.8
# times on the parameters and 29 on the buffers: the bar goes between.
DIST_BN_FLOOR_FACTOR = 1.5
DIST_TIMEOUT_S = 480
DIST_LOADER_EPOCHS = 8  # epochs of the JPEG loader timed alone


def _dist_token_sets(steps: int = DIST_GPT["steps"]):
    import ml_trainer_tpu_torch as mt

    c = DIST_GPT
    return (mt.SyntheticTokens(size=c["batch"] * steps,
                               seq_len=c["seq_len"],
                               vocab_size=c["vocab_size"], seed=SEED),
            mt.SyntheticTokens(size=c["batch"], seq_len=c["seq_len"],
                               vocab_size=c["vocab_size"], seed=SEED + 1))


def _dist_jpeg_set():
    from ml_trainer_tpu_torch.data import (
        Compose,
        Normalize,
        ShardedJpegDataset,
        ToFloat,
    )

    return ShardedJpegDataset(DIST_JPEG, transform=Compose(
        [ToFloat(), Normalize(IMAGENET_MEAN, IMAGENET_STD)]))


def _rank_loaders(trainer, dataset, native: bool):
    """The train loaders ranks 0 and 1 of a two-process run build for
    ``dataset`` (``ShardedSampler`` split, half the global batch)."""
    from ml_trainer_tpu_torch.data import ShardedSampler

    kind, trainer._loader_kind = trainer._loader_kind, (
        "native" if native else "python")
    try:
        return [trainer._make_loader(
            dataset, trainer.global_batch // 2, True, SEED,
            ShardedSampler(len(dataset), 2, r, shuffle=True, seed=SEED))
            for r in (0, 1)]
    finally:
        trainer._loader_kind = kind


def _state_digests(trainer, split=(), rank: int = 0, n: int = 1) -> dict:
    """sha1 of every state leaf's bytes (``state_tree``), by '/'-path; a
    leaf named in ``split`` as dim-0 block ``rank`` of ``n`` (a ZeRO-1
    moment as a process of a two-process run holds it)."""
    import hashlib

    import numpy as np
    import torch

    from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten
    from ml_trainer_tpu_torch.train_state import state_tree

    out = {}
    for path, v in _flatten(state_tree(trainer.state, trainer.model)):
        if v is None or isinstance(v, dict):
            continue
        arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v))
        key = "/".join(path)
        if key in split:
            arr = arr.reshape((n, -1) + arr.shape[1:])[rank].reshape(
                (-1,) + arr.shape[1:])
        out[key] = hashlib.sha1(
            f"{arr.dtype}{arr.shape}".encode()
            + np.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def _digest_diff(got: dict, want: dict) -> list:
    return sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))


def _opt_bytes(trainer) -> int:
    from ml_trainer_tpu_torch.ops.optimizers import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(trainer.state.opt_state))


def _counted_fit(what: str, trainer, depth: int, micro: int, val: int,
                 tail: int = 0) -> dict:
    """``fit_whole`` with the launches counted from 0 and checked, the
    peak memory from a reset, the fit's seconds."""
    import torch

    import ml_trainer_tpu_torch as mt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    fit_whole(trainer, what)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = mt.launch_counts()
    _want_launches(what, counts, depth, micro, val, tail)
    return dict(launches=counts, fit_s=fit_s,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                train_loss=trainer.history["train_loss"],
                val_loss=trainer.history["val_loss"])


def _dist_worker_nccl1(port: int) -> dict:
    """(a) GPT-2 124M fp32, ``dp_update="sharded"``, in an NCCL group of
    one process, against the same fit with no process group; then the
    fused step at K = 4 (its collectives captured in the CUDA graph,
    8 steps: a chunk run for real, then one replayed) likewise."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.parallel import distributed

    distributed.initialize_distributed("nccl", f"localhost:{port}", 1, 0,
                                       device="cuda:0")
    dev, c, out = torch.device("cuda:0"), DIST_GPT, {}
    for label, group, k in (("nccl", True, 1), ("no_group", False, 1),
                            ("nccl_k4", True, 4), ("no_group_k4", False, 4)):
        steps = c["steps"] * (2 if k > 1 else 1)
        tr = mt.Trainer(_seeded_model("gpt2", SEED, dev),
                        datasets=_dist_token_sets(steps), epochs=1,
                        batch_size=c["batch"], is_parallel=group, device=dev,
                        dp_update="sharded" if k == 1 else "fused",
                        steps_per_execution=k,
                        model_dir=f"{DIST_DIR}/nccl1_{label}", **DIST_GPT_OPT)
        rec = _counted_fit(f"dist nccl world 1 {label}", tr, 12, steps, 1,
                           tail=steps if group and k == 1 else 0)
        rec.update(digests=_state_digests(tr), dp_update=tr.dp_update,
                   fused_adam=tr.fused_adam, mesh=tr.mesh.shape,
                   distributed=tr.mesh.distributed, k=k)
        out[label] = rec
        del tr
        torch.cuda.empty_cache()
    out["backend"] = distributed.backend()
    out["world"] = distributed.process_count()
    distributed.shutdown()
    return out


def _dist_worker_gloo2(port: int, rank: int) -> dict:
    """(b) GPT-2 124M bf16 sharded, its format-3 checkpoint resumed, (d)
    the planted desync, (c) ResNet-50 on the JPEG shards: two gloo
    processes sharing cuda:0."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.checkpoint import (
        checkpoint_format,
        latest_checkpoint,
    )
    from ml_trainer_tpu_torch.data import NativeLoader
    from ml_trainer_tpu_torch.parallel import check_desync, distributed

    distributed.initialize_distributed("gloo", f"localhost:{port}", 2, rank,
                                       device="cuda:0")
    dev, c, out = torch.device("cuda:0"), DIST_GPT, {}
    kw = dict(datasets=_dist_token_sets(), epochs=1, batch_size=c["batch"],
              is_parallel=True, device=dev, dp_update="sharded",
              precision="bf16", grad_clip_norm=1.0,
              model_dir=f"{DIST_DIR}/gpt2_bf16", **DIST_GPT_OPT)
    a = mt.Trainer(_seeded_model("gpt2", SEED, dev), **kw)
    rec = _counted_fit(f"dist gloo rank {rank} gpt2 bf16", a, 12,
                       c["steps"], 1, tail=c["steps"])
    split = sorted("/".join(p) for p in a._ckpt_split())
    digests = _state_digests(a)
    rec.update(digests=digests, split=len(split),
               opt_state_bytes=_opt_bytes(a),
               fused_adam=a.fused_adam, mesh=a.mesh.shape,
               format=checkpoint_format(latest_checkpoint(a._ckpt_dir())))
    out["gpt2"] = rec
    # The format-3 checkpoint, resumed by two fresh processes' trainers.
    t0 = time.perf_counter()
    b = mt.Trainer(_seeded_model("gpt2", SEED, dev), **kw)
    b.fit(resume=True)
    out["resume"] = dict(s=time.perf_counter() - t0,
                         differ=_digest_diff(_state_digests(b), digests),
                         step=b.state.step)
    # (d) A planted desync: rank 1 scales its largest leaf.
    params = {k: p.detach().clone() for k, p in b.model.named_parameters()}
    step = b.state.step
    clean = raised = None
    try:
        check_desync(params, step=step)
    except RuntimeError as e:
        clean = str(e)
    leaf = max(params, key=lambda k: params[k].numel())
    if rank == 1:
        params[leaf].mul_(DIST_PLANT)
    try:
        check_desync(params, step=step + 1)
    except RuntimeError as e:
        raised = str(e)
    out["desync"] = dict(leaf=leaf, step=step + 1, clean=clean,
                         raised=raised)
    del a, b, params
    torch.cuda.empty_cache()
    # (c) ResNet-50 on the JPEG shards, each rank's half a step through
    # the native loader.
    r = DIST_RESNET
    tr = mt.Trainer(_seeded_model("resnet50", SEED, dev),
                    datasets=(_dist_jpeg_set(), _dist_jpeg_set()),
                    epochs=r["epochs"], batch_size=r["batch"],
                    is_parallel=True, device=dev, loader="native",
                    metric="accuracy", seed=SEED,
                    model_dir=f"{DIST_DIR}/resnet50_{rank}",
                    **DIST_RESNET_OPT)
    if not isinstance(tr.train_loader, NativeLoader):
        raise AssertionError(f"dist resnet50 rank {rank}: {tr.train_loader}")
    rec = _counted_fit(f"dist gloo rank {rank} resnet50", tr, 0, 0, 0)
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    if rank == 0:
        torch.save(state, f"{DIST_DIR}/resnet50_rank0.pt")
    tr.train_loader.set_epoch(0)
    t0 = time.perf_counter()
    n = sum(1 for _ in tr.train_loader)
    rec.update(loader_host_ms_per_batch=(time.perf_counter() - t0) * 1e3 / n,
               loader_batch=tr.train_loader.batch_size,
               steps=len(tr.train_loader) * r["epochs"],
               synced=all(m.synced for m in tr.model.modules()
                          if hasattr(m, "synced")),
               digest=_state_digests(tr))
    out["resnet50"] = rec
    distributed.shutdown()
    return out


def _dist_worker(args) -> int:
    """A ``--dist-worker`` process: its job's record as JSON in
    DIST_DIR."""
    rec = (_dist_worker_nccl1(args.port) if args.dist_worker == "nccl1"
           else _dist_worker_gloo2(args.port, args.rank))
    with open(f"{DIST_DIR}/{args.dist_worker}_{args.rank}.json", "w") as fp:
        json.dump(rec, fp)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_launch(job: str, rank: int, port: int):
    log_path = f"{DIST_DIR}/{job}_{rank}.log"
    fp = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", job,
         "--rank", str(rank), "--port", str(port)],
        stdout=fp, stderr=subprocess.STDOUT)
    return proc, fp, log_path


def _dist_ref_gpt2(dev) -> dict:
    """The one-process fit of two replicas on the card that the gloo
    ranks' GPT-2 run is held to bitwise, on the same global batches."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import JoinedLoader

    c = DIST_GPT
    tr = mt.Trainer(_seeded_model("gpt2", SEED, dev),
                    datasets=_dist_token_sets(), epochs=1,
                    batch_size=c["batch"], device=[dev] * 2,
                    dp_update="sharded", precision="bf16",
                    grad_clip_norm=1.0, model_dir=f"{DIST_DIR}/gpt2_ref",
                    **DIST_GPT_OPT)
    tr.train_loader = JoinedLoader(_rank_loaders(
        tr, tr.train_loader.dataset, native=False))
    rec = _counted_fit("dist gpt2 bf16 one process", tr, 12,
                       2 * c["steps"], 1, tail=2 * c["steps"])
    split = sorted("/".join(p) for p in tr._ckpt_split())
    rec.update(digests=[_state_digests(tr, split, r, 2) for r in (0, 1)],
               opt_state_bytes=_opt_bytes(tr))
    del tr
    torch.cuda.empty_cache()
    return rec


def _dist_ref_resnet(dev) -> dict:
    """The one-process fits of two replicas on the ranks' native loaders'
    batches, joined: with global-batch statistics in the port's
    one-process arithmetic (``F.batch_norm``, cuDNN), in flax's
    (``BatchNorm.synced`` with no group: E[x^2] - E[x]^2 over the whole
    batch), in flax's with the ranks' rows swapped (the reorder floor),
    and with per-replica statistics in flax's arithmetic (the fault the
    sync repairs, and nothing else changed)."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.data import JoinedLoader
    from ml_trainer_tpu_torch.models.layers import BatchNorm

    r, out = DIST_RESNET, {}
    for label, flax, order in (("port", False, 1), ("flax", True, 1),
                               ("flax_swapped", True, -1),
                               ("per_replica", True, 1)):
        tr = mt.Trainer(_seeded_model("resnet50", SEED, dev),
                        datasets=(_dist_jpeg_set(), _dist_jpeg_set()),
                        epochs=r["epochs"], batch_size=r["batch"],
                        device=[dev] * 2, loader="native", metric="accuracy",
                        seed=SEED, model_dir=f"{DIST_DIR}/resnet50_{label}",
                        **DIST_RESNET_OPT)
        for m in tr.model.modules():
            if isinstance(m, BatchNorm):
                m.synced = flax
        # Each replica's block through the model alone: its own statistics.
        tr._has_batch_norm = label != "per_replica"
        tr.train_loader = JoinedLoader(_rank_loaders(
            tr, tr.train_loader.dataset, native=True)[::order])
        rec = _counted_fit(f"dist resnet50 one process {label}", tr, 0, 0, 0)
        rec["state"] = {k: v.detach().cpu()
                        for k, v in tr.model.state_dict().items()}
        for p in tr.train_loader.parts:
            p.stop()
        out[label] = rec
        del tr
        torch.cuda.empty_cache()
    return out


def _dist_jpeg_checks() -> dict:
    """The committed shards on this machine: every image's decode
    (``jpeg_decode_np``) against the CPU decode's digest in
    ``pixels.json``; the native loader's pixels (a batch of all 64,
    normalised by 1, rounded back) bitwise those; the loader's host ms a
    batch of 64 with the ImageNet normalisation (the raw shards' row of
    the data phase) and of 16 (a rank's share in the fit)."""
    import hashlib

    import numpy as np

    from ml_trainer_tpu_torch.data import NativeLoader, ShardedSampler
    from ml_trainer_tpu_torch.data.native import jpeg_decode_np

    ds = _dist_jpeg_set()
    with open(os.path.join(DIST_JPEG, "pixels.json")) as fp:
        want = json.load(fp)["sha256"]
    pixels = np.stack([
        jpeg_decode_np(blob[o[k]:o[k + 1]], ds.shape)
        for blob, o in zip(ds.byte_maps, ds.offset_tables)
        for k in range(len(o) - 1)])
    got = [hashlib.sha256(p.tobytes()).hexdigest() for p in pixels]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"dist jpeg: decode digests differ at {bad}")
    plain = NativeLoader(ds, len(ds), shuffle=False, pad=0, flip=False,
                         normalize=((0.0,) * 3, (1.0,) * 3))
    (x, _), = list(plain)
    plain.stop()
    back = np.rint(x * 255.0).astype(np.uint8)
    if not np.array_equal(back, pixels):
        raise AssertionError("dist jpeg: the native loader's pixels differ "
                             "from jpeg_decode_np's")
    rec = dict(images=len(ds), bytes=int(sum(len(b) for b in ds.byte_maps)),
               decode_bitwise_cpu_digests=True, loader_bitwise_decode=True)
    for batch, sampler in ((64, None), (16, ShardedSampler(len(ds), 2, 0,
                                                           seed=SEED))):
        loader = NativeLoader(ds, batch, shuffle=sampler is None,
                              sampler=sampler, pad=0, flip=False,
                              normalize=(IMAGENET_MEAN, IMAGENET_STD),
                              seed=SEED)
        n, t0 = 0, time.perf_counter()
        for epoch in range(DIST_LOADER_EPOCHS):
            loader.set_epoch(epoch)
            n += sum(1 for _ in loader)
        rec[f"host_ms_per_batch_{batch}"] = (
            (time.perf_counter() - t0) * 1e3 / n)
        loader.stop()
    return rec


def _bn_distance(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| over every parameter (``params``) and,
    apart, every BatchNorm buffer (``buffers``); beside them the worst
    leaf's max |got - want| over its max |want| (``worst_leaf_rel``,
    ``worst``).  An integer leaf must be equal."""
    import torch

    sq = {"params": [0.0, 0.0], "buffers": [0.0, 0.0]}
    leaf = {}
    for k, w in want.items():
        if not w.is_floating_point():
            if not torch.equal(got[k], w):
                raise AssertionError(f"dist (c): {k} {got[k]} != {w}")
            continue
        d = got[k].double() - w.double()
        acc = sq["buffers" if "running_" in k else "params"]
        acc[0] += float((d * d).sum())
        acc[1] += float((w.double() ** 2).sum())
        scale = float(w.double().abs().max())
        leaf[k] = float(d.abs().max()) / (scale if scale else 1.0)
    worst = max(leaf, key=leaf.get)
    return dict(params=(sq["params"][0] / sq["params"][1]) ** 0.5,
                buffers=(sq["buffers"][0] / sq["buffers"][1]) ** 0.5,
                worst_leaf_rel=leaf[worst], worst=worst)


def dist_phase(dev, smi: str) -> dict:
    """(a)-(d) of the module docstring's dist phase: the workers run
    beside this process's one-process references and the JPEG checks;
    then each rank's record is held to them."""
    import torch

    if os.path.isdir(DIST_DIR):
        shutil.rmtree(DIST_DIR)
    os.makedirs(DIST_DIR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    port_a, port_b = _free_port(), _free_port()
    jobs = {("nccl1", 0): _dist_launch("nccl1", 0, port_a)}
    for rank in (0, 1):
        jobs[("gloo2", rank)] = _dist_launch("gloo2", rank, port_b)
    try:
        ref_gpt = _dist_ref_gpt2(dev)
        ref_resnet = _dist_ref_resnet(dev)
        for (job, rank), (proc, _, path) in jobs.items():
            left = DIST_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                code = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                with open(path) as fp:
                    tail = fp.read()[-6000:]
                raise AssertionError(
                    f"dist worker {job} rank {rank} exited {code}:\n{tail}")
    finally:
        for proc, fp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fp.close()
    workers_s = time.perf_counter() - t0
    jpeg = _dist_jpeg_checks()  # timed with the workers gone
    recs = {}
    for job, rank in jobs:
        with open(f"{DIST_DIR}/{job}_{rank}.json") as fp:
            recs[(job, rank)] = json.load(fp)
    # (a) NCCL at world size 1: bitwise the fit with no process group.
    a = recs[("nccl1", 0)]
    differ = _digest_diff(a["nccl"]["digests"], a["no_group"]["digests"])
    differ_k4 = _digest_diff(a["nccl_k4"]["digests"],
                             a["no_group_k4"]["digests"])
    if (differ or differ_k4 or a["backend"] != "nccl" or a["world"] != 1
            or a["nccl"]["dp_update"] != "sharded"
            or not a["nccl"]["fused_adam"]):
        raise AssertionError(f"dist (a): differ {differ[:8]}, at K = 4 "
                             f"{differ_k4[:8]}, backend {a['backend']}, "
                             f"{a['nccl']['dp_update']}")
    # (b) two gloo ranks: bitwise the one-process replicas, resumed
    # bitwise from format 3.
    ranks = [recs[("gloo2", r)] for r in (0, 1)]
    for r, rec in enumerate(ranks):
        differ = _digest_diff(rec["gpt2"]["digests"], ref_gpt["digests"][r])
        if differ:
            raise AssertionError(f"dist (b) rank {r}: {len(differ)} leaves "
                                 f"differ from the one-process run: "
                                 f"{differ[:8]}")
        if rec["gpt2"]["format"] != 3 or rec["resume"]["differ"]:
            raise AssertionError(f"dist (b) rank {r}: format "
                                 f"{rec['gpt2']['format']}, resume differs "
                                 f"at {rec['resume']['differ'][:8]}")
    stitched = _dist_stitched_into_one(dev, ref_gpt)
    # (d) the planted desync: rank 1 raises and names the step.
    d0, d1 = ranks[0]["desync"], ranks[1]["desync"]
    if (d0["clean"] or d1["clean"] or d0["raised"]
            or not d1["raised"] or "host 1" not in d1["raised"]
            or f"(step {d1['step']})" not in d1["raised"]):
        raise AssertionError(f"dist (d): {d0} {d1}")
    # (c) ResNet-50 on the JPEG shards: within DIST_BN_FLOOR_FACTOR times
    # the reorder floor of the one-process fit in flax's arithmetic.
    got = torch.load(f"{DIST_DIR}/resnet50_rank0.pt")
    states = {k: rec.pop("state") for k, rec in ref_resnet.items()}
    bn = dict(vs_flax=_bn_distance(got, states["flax"]),
              floor=_bn_distance(states["flax_swapped"], states["flax"]),
              vs_port=_bn_distance(got, states["port"]),
              port_vs_flax=_bn_distance(states["port"], states["flax"]),
              per_replica_vs_flax=_bn_distance(states["per_replica"],
                                               states["flax"]))
    bar = {k: max(DIST_BN_FLOOR_FACTOR * bn["floor"][k], 1e-7)
           for k in ("params", "buffers")}
    bn["bar"] = bar
    if any(not bn["vs_flax"][k] <= bar[k] for k in bar):
        raise AssertionError(f"dist (c): {bn} over the bar {bar}")
    if any(not bn["per_replica_vs_flax"][k] > bar[k] for k in bar):
        raise AssertionError(f"dist (c): per-replica statistics pass the "
                             f"bar {bar}: {bn}")
    if ranks[0]["resnet50"]["digest"] != ranks[1]["resnet50"]["digest"]:
        raise AssertionError("dist (c): the ranks' ResNet-50 states differ")
    phase_s = time.perf_counter() - t0
    for rec in ranks:
        rec["gpt2"].pop("digests")
        rec["resnet50"].pop("digest")
    for key in ("nccl", "no_group", "nccl_k4", "no_group_k4"):
        a[key].pop("digests")
    ref_gpt.pop("digests")
    shutil.rmtree(DIST_DIR)
    launches = {}
    for counts in ([a[k]["launches"] for k in ("nccl", "no_group",
                                               "nccl_k4", "no_group_k4")]
                   + [ref_gpt["launches"]]
                   + [rec["launches"] for rec in ref_resnet.values()]
                   + [rec[k]["launches"] for rec in ranks
                      for k in ("gpt2", "resnet50")]):
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
    return dict(card=smi, phase_s=phase_s, workers_s=workers_s,
                nccl_world1=a,
                gloo_ranks=ranks, one_process_gpt2=ref_gpt,
                one_process_resnet50=ref_resnet, stitched_into_one=stitched,
                resnet50_vs_one_process=bn, jpeg=jpeg, launches=launches)


def _dist_stitched_into_one(dev, ref_gpt: dict) -> dict:
    """2 -> 1: the two ranks' format-3 checkpoint, restored into one
    process of two co-located replicas: bitwise the stitched arrays and
    the one-process run's state."""
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.checkpoint import restore_checkpoint

    c = DIST_GPT
    path = f"{DIST_DIR}/gpt2_bf16/checkpoints/checkpoint_1"
    t0 = time.perf_counter()
    tree = restore_checkpoint(path)[0]
    stitch_s = time.perf_counter() - t0
    tr = mt.Trainer(_seeded_model("gpt2", SEED, dev),
                    datasets=_dist_token_sets(), epochs=1,
                    batch_size=c["batch"], device=[dev] * 2,
                    dp_update="sharded", precision="bf16",
                    grad_clip_norm=1.0, model_dir=f"{DIST_DIR}/gpt2_bf16",
                    **DIST_GPT_OPT)
    start = tr._resume_from_latest()
    split = sorted("/".join(p) for p in tr._ckpt_split())
    differ = [_digest_diff(_state_digests(tr, split, r, 2),
                           ref_gpt["digests"][r]) for r in (0, 1)]
    from ml_trainer_tpu_torch.checkpoint.checkpoint import _flatten
    from ml_trainer_tpu_torch.train_state import state_tree

    live = dict(_flatten(state_tree(tr.state, tr.model)))
    off = [("/".join(p)) for p, v in _flatten(tree)
           if v is not None and not isinstance(v, dict)
           and not torch.equal(torch.as_tensor(v),
                               torch.as_tensor(live[p]).cpu())]
    if start != 2 or any(differ) or off:
        raise AssertionError(f"dist 2 -> 1: start {start}, differ "
                             f"{[d[:4] for d in differ]}, stitched {off[:4]}")
    del tr
    torch.cuda.empty_cache()
    return dict(stitch_s=stitch_s, leaves=len(live), bitwise=True)


# Speculative decoding, chunked prefill and generate()'s modes (``--only
# decode``): GPT-2 124M serves with spec_k=4 and prefill_chunk=256.
DECODE_SPEC_K = 4
DECODE_LENS = [130, 150, 170, 200, 230, 260, 280, 300]  # the spec prompts
DECODE_NEW = 48
DECODE_BF16_REL = 3e-2  # Queue C 9's bf16 bar: of the largest logit
DECODE_CHUNK = dict(chunk=256, long=900, shorts=(64, 48, 32), new_tokens=32)
DECODE_GEN = dict(batch=2, prompt=128, new_tokens=32, ragged=(96, 128, 200))


def _spec_prompts(rng, vocab: int, lengths) -> list:
    """Prompts whose tails repeat a 24-token span (the n-gram drafter
    finds its matches there), each after its own 32 random tokens (no
    two share a page-16 block: no prefix hit)."""
    import numpy as np

    out = []
    for n in lengths:
        span = rng.integers(0, vocab, 24)
        tail = np.resize(span, n - 32)
        out.append(np.concatenate([rng.integers(0, vocab, 32),
                                   tail]).astype(np.int32))
    return out


@contextlib.contextmanager
def checked_calls(rec: dict):
    """Inside, every eager call of K1's and K6's launch functions runs as
    it would and is held at once against the float64 JAX function on its
    own inputs (``hold_call``; nothing is kept but counts and the worst
    errors, into ``rec``).  A call made while a CUDA graph is being
    captured is counted apart (its outputs are not computed then)."""
    import importlib
    from unittest import mock

    import torch

    with contextlib.ExitStack() as stack:
        for mod, attr, kname in CALL_SITES:
            if kname not in ("flash_fwd", "paged_attention"):
                continue
            module = importlib.import_module(mod)
            r = rec.setdefault(kname, {"calls": 0, "in_capture": 0})

            def wrapped(*args, _real=getattr(module, attr), _k=kname, _r=r,
                        **kw):
                out = _real(*args, **kw)
                if torch.cuda.is_current_stream_capturing():
                    _r["in_capture"] += 1
                else:
                    hold_call(_k, args, out if isinstance(out, tuple)
                              else (out,), _r)
                return out

            stack.enter_context(mock.patch.object(module, attr, wrapped))
        yield rec


def _teacher_logits(model, seq) -> "torch.Tensor":
    """Logits [len(seq), V] float32 of one full forward over ``seq``
    through the plain attention."""
    import numpy as np
    import torch

    model.attention_impl = "xla"
    try:
        with torch.no_grad():
            ids = torch.as_tensor(np.asarray(seq, np.int64),
                                  device=model.device)[None]
            return model(ids)[0].float()
    finally:
        model.attention_impl = "auto"


def near_tie(model, prompts, got, want, bar, what: str) -> int:
    """Each row of ``got`` equal to ``want``'s, or parting first at a step
    where the reference's top-2 margin (``want``'s sequence teacher
    forced) is within ``bar(logits)`` and ``got``'s token there is within
    it of the best.  Returns the number of parted rows."""
    import numpy as np

    parted = 0
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        n = len(p)
        g, w = np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)
        if g.shape != w.shape or not np.array_equal(g[:n], w[:n]):
            raise AssertionError(f"{what} row {i}: shape or prompt differs")
        diff = np.flatnonzero(g[n:] != w[n:])
        if not diff.size:
            continue
        j = n + int(diff[0])
        logits = _teacher_logits(model, w[:j])[-1]
        top2 = logits.topk(2).values
        margin = (top2[0] - top2[1]).item()
        gap = (top2[0] - logits[int(g[j])]).item()
        slack = bar(logits)
        if not (margin <= slack and gap <= slack):
            raise AssertionError(
                f"{what} row {i}: token {j - n} differs where the "
                f"reference's margin is {margin} (gap {gap}) > {slack}")
        parted += 1
    return parted


def _slack(precision):
    if precision is None:
        return lambda logits: LOGIT_SLACK
    return lambda logits: DECODE_BF16_REL * logits.abs().max().item()


def _serve_timed(model, prompts, new_tokens: int, warm, what: str,
                 **server_kw) -> dict:
    """One ``Server`` (``server_kw``): ``warm`` completed uncounted (the
    decode graph's warm-up and capture, the verify's first shapes), then
    the counts set to 0, ``prompts`` submitted together and served
    greedily, the counts read.  Gates: every request done with its
    tokens; K1 12 a prefill (every prompt's bucket is >= 128), K6 12 a
    decode step of a ``paged_kernel`` engine and none otherwise."""
    import ml_trainer_tpu_torch as mt

    with mt.Server(model, max_batch=8, device=model.device,
                   **server_kw) as server:
        for p in warm:
            server.complete(p, 4, timeout=600)
        before = server.metrics.snapshot()
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [server.submit(p, new_tokens) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        snap = settled_snapshot(server, before, len(prompts) * new_tokens)
        counts = mt.launch_counts()
        steps = snap["decode_steps_total"] - before["decode_steps_total"]
        step_secs = list(server.metrics._step_secs)[-steps:]
    reqs = [s.request for s in streams]
    if not all(r.state == "done" and len(r.tokens) == new_tokens
               for r in reqs):
        raise AssertionError(f"{what}: not every request completed: "
                             f"{[(r.state, len(r.tokens)) for r in reqs]}")
    k6 = model.depth * steps if server_kw.get("paged_kernel") else 0
    want = dict(dict.fromkeys(counts, 0), flash_fwd=model.depth * len(prompts),
                paged_attention=k6)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    spec = {k: snap[k] - before[k] for k in (
        "spec_steps_total", "spec_drafted_tokens", "spec_accepted_tokens")}
    rec = dict(wall_s=wall, tokens_per_s=len(prompts) * new_tokens / wall,
               decode_steps=steps,
               step_ms_mean=1e3 * sum(step_secs) / max(len(step_secs), 1),
               step_ms_p50=1e3 * sorted(step_secs)[len(step_secs) // 2],
               launches=counts, outs=outs)
    if server_kw.get("spec_k"):
        # One (verify step, slot) entry drafts spec_k and commits its
        # accepted drafts plus one.
        entries = spec["spec_drafted_tokens"] // server_kw["spec_k"]
        rec.update(spec, acceptance_rate=(
            spec["spec_accepted_tokens"] / spec["spec_drafted_tokens"]),
            tokens_per_verify_step=(
                (spec["spec_accepted_tokens"] + entries) / entries))
    return rec


def decode_spec(dev, checks: dict) -> dict:
    """GPT-2 124M fp32 behind ``Server(max_batch=8)``: the eight
    ``DECODE_LENS`` prompts, 48 greedy tokens, through ``spec_k=4``
    (contiguous, then ``kv_page_size=16``) and ``spec_k=0`` with its
    decode graph (the reference; the near-tie rule); a sampled spec pass
    twice (equal); bf16 spec against the bf16 vanilla engine (tokens
    under the near-tie rule at DECODE_BF16_REL of the largest logit, and
    every served token within it of the best)."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    model = _seeded_model("gpt2", seed=SEED, device=dev).eval()
    rng = np.random.default_rng(SEED + 23)
    prompts = _spec_prompts(rng, model.vocab_size, DECODE_LENS)
    warm = _spec_prompts(rng, model.vocab_size, [130, 300])
    k = DECODE_SPEC_K
    runs = {
        "vanilla": _serve_timed(model, prompts, DECODE_NEW, warm,
                                "vanilla"),
        "spec": _serve_timed(model, prompts, DECODE_NEW, warm, "spec",
                             spec_k=k),
        "spec_paged": _serve_timed(model, prompts, DECODE_NEW, warm,
                                   "spec paged", spec_k=k, kv_page_size=16),
    }
    ref = runs["vanilla"].pop("outs")
    for name in ("spec", "spec_paged"):
        runs[name]["parted_rows"] = near_tie(
            model, prompts, runs[name].pop("outs"), ref, _slack(None),
            f"spec serving ({name})")
    with checked_calls(checks):
        sampled = []
        for _ in range(2):
            with mt.Server(model, max_batch=8, spec_k=k, device=dev) as s:
                streams = [s.submit(p, 16, temperature=0.8, rng=i)
                           for i, p in enumerate(prompts[:4])]
                sampled.append([st.result(timeout=600) for st in streams])
        if not all(np.array_equal(a, b) for a, b in zip(*sampled)):
            raise AssertionError("sampled spec serving does not repeat")
        bf16 = _seeded_model("gpt2", seed=SEED, device=dev,
                             precision="bf16").eval()
        outs = {}
        for name, kw in (("vanilla", {}), ("spec", dict(spec_k=k))):
            with mt.Server(bf16, max_batch=8, device=dev, **kw) as s:
                outs[name] = [s.complete(p, 24, timeout=600)
                              for p in prompts[:4]]
        parted = near_tie(bf16, prompts[:4], outs["spec"], outs["vanilla"],
                          _slack("bf16"), "bf16 spec serving")
        worst = 0.0
        for p, seq in zip(prompts[:4], outs["spec"]):
            logits = _teacher_logits(bf16, seq[:-1])[len(p) - 1:]
            served = torch.as_tensor(seq[len(p):].astype(np.int64),
                                     device=dev)
            gap = (logits.max(-1).values
                   - logits.gather(1, served[:, None])[:, 0]).max().item()
            bar = DECODE_BF16_REL * logits.abs().max().item()
            if not gap <= bar:
                raise AssertionError(f"bf16 spec: a served token {gap} below "
                                     f"the best logit (> {bar})")
            worst = max(worst, gap / bar)
    del bf16
    return dict(runs=runs, prompt_lens=DECODE_LENS, new_tokens=DECODE_NEW,
                spec_k=k, sampled_equal=True,
                bf16=dict(parted_rows=parted, worst_gap_of_bar=worst))


def decode_draft_model(dev, checks: dict) -> dict:
    """``gpt2_mini`` as target with ``gpt2_nano`` as draft (the pair the
    JAX package registers), seeded: ``speculative_generate`` and
    ``Server(drafter=...)`` greedy against ``generate()`` (the near-tie
    rule), with the acceptance stats."""
    import numpy as np

    import ml_trainer_tpu_torch as mt

    target = _seeded_model("gpt2_mini", seed=SEED, device=dev).eval()
    draft = _seeded_model("gpt2_nano", seed=SEED + 1, device=dev).eval()
    rng = np.random.default_rng(SEED + 24)
    prompts = _spec_prompts(rng, target.vocab_size, [130] * 4)
    with checked_calls(checks):
        want = mt.generate(target, np.stack(prompts), DECODE_NEW,
                           device=dev).cpu().numpy()
        got, stats = mt.speculative_generate(
            target, np.stack(prompts), DECODE_NEW, draft_k=DECODE_SPEC_K,
            drafter=draft, return_stats=True, device=dev)
        with mt.Server(target, max_batch=8, spec_k=DECODE_SPEC_K,
                       drafter=draft, device=dev) as s:
            served = [s.complete(p, DECODE_NEW, timeout=600)
                      for p in prompts]
            snap = s.metrics.snapshot()
    return dict(
        parted_rows_batch=near_tie(target, prompts, got.cpu().numpy(), want,
                                   _slack(None), "draft-model batch"),
        parted_rows_served=near_tie(target, prompts, served, want,
                                    _slack(None), "draft-model serving"),
        batch_stats=stats,
        served_acceptance_rate=snap["spec_acceptance_rate"],
        served_tokens_per_step=snap["spec_tokens_per_step"])


def _chunked_run(model, long_p, shorts, chunk: int, graph: bool) -> dict:
    """The long prompt queued ahead of the short ones through a paged
    ``Server`` (page 16, ``paged_kernel``, ``prefill_chunk=chunk``), after
    an uncounted warm-up (the decode graph's capture; with chunking, its
    window shapes).  Gates: exact K6 (12 a decode step), K1 none with
    chunking (the shorts' buckets are under 128, the windows attend
    plainly) and 12 without (the long prefill); the windows counted."""
    import numpy as np

    import ml_trainer_tpu_torch as mt

    n = DECODE_CHUNK["new_tokens"]
    rng = np.random.default_rng(SEED + 25)
    with decode_graph(graph), mt.Server(
            model, max_batch=8, kv_page_size=16, paged_kernel=True,
            prefill_chunk=chunk, prefix_cache=False,
            device=model.device) as server:
        server.complete(rng.integers(0, model.vocab_size, 300), 3,
                        timeout=600)
        server.complete(rng.integers(0, model.vocab_size, 40), 3,
                        timeout=600)
        before = server.metrics.snapshot()
        mt.reset_launch_counts()
        streams = [server.submit(long_p, n)] + [server.submit(p, n)
                                                for p in shorts]
        outs = [s.result(timeout=600) for s in streams]
        snap = settled_snapshot(server, before, len(streams) * n)
        counts = mt.launch_counts()
    steps = snap["decode_steps_total"] - before["decode_steps_total"]
    windows = -(-len(long_p) // chunk) if chunk else 0
    want = dict(dict.fromkeys(counts, 0), paged_attention=model.depth * steps,
                flash_fwd=0 if chunk else model.depth)
    if counts != want:
        raise AssertionError(f"chunked prefill {chunk}: launches {counts}, "
                             f"expected {want}")
    got = {k: snap[k] - before[k] for k in ("chunked_admissions_total",
                                            "prefill_chunks_total")}
    if got != {"chunked_admissions_total": int(bool(chunk)),
               "prefill_chunks_total": windows}:
        raise AssertionError(f"chunked prefill {chunk}: {got}")
    reqs = [s.request for s in streams]
    return dict(outs=outs, launches=counts, decode_steps=steps, **got,
                long_prefill_chunks=reqs[0].prefill_chunks,
                ttft_s=[r.first_token_at - r.submitted_at for r in reqs],
                first_token_at=[r.first_token_at for r in reqs])


def decode_chunked(dev, checks: dict) -> dict:
    """GPT-2 124M, ``kv_page_size=16, paged_kernel=True``: one 900-token
    prompt (4 windows of ``prefill_chunk=256``) queued ahead of three of
    at most 64 tokens, with the decode graph, chunked and not: tokens
    under the near-tie rule, the short requests' first tokens before the
    long one's when chunked (after it when not); then the chunked run
    eagerly with every K6 call held to its plain version."""
    import numpy as np

    model = _seeded_model("gpt2", seed=SEED, device=dev).eval()
    rng = np.random.default_rng(SEED + 26)
    c = DECODE_CHUNK
    long_p = rng.integers(0, model.vocab_size, c["long"]).astype(np.int32)
    shorts = [rng.integers(0, model.vocab_size, m).astype(np.int32)
              for m in c["shorts"]]
    chunked = _chunked_run(model, long_p, shorts, c["chunk"], graph=True)
    plain = _chunked_run(model, long_p, shorts, 0, graph=True)
    prompts = [long_p] + shorts
    parted = near_tie(model, prompts, chunked.pop("outs"), plain["outs"],
                      _slack(None), "chunked prefill")
    first = chunked.pop("first_token_at")
    if not max(first[1:]) < first[0]:
        raise AssertionError(f"chunked: a short request's first token came "
                             f"after the long one's ({first})")
    first_plain = plain.pop("first_token_at")
    if not first_plain[0] < min(first_plain[1:]):
        raise AssertionError(f"unchunked: the long prefill did not come "
                             f"first ({first_plain})")
    with checked_calls(checks):
        eager = _chunked_run(model, long_p, shorts, c["chunk"], graph=False)
    parted_eager = near_tie(model, prompts, eager.pop("outs"),
                            plain.pop("outs"), _slack(None),
                            "chunked prefill, eager")
    return dict(chunked=chunked, unchunked=plain, parted_rows=parted,
                parted_rows_eager=parted_eager,
                eager_launches=eager["launches"],
                short_ttft_s={"chunked": chunked["ttft_s"][1:],
                              "unchunked": plain["ttft_s"][1:]},
                long_ttft_s={"chunked": chunked["ttft_s"][0],
                             "unchunked": plain["ttft_s"][0]})


def decode_generate(dev, checks: dict) -> dict:
    """``generate()``'s modes at GPT-2 124M on [2, 128] prompts, 32
    tokens: ``top_k=1`` at temperature 1.5 and ``top_p=1e-6`` at 0.05
    equal to greedy; a ``top_k=50, top_p=0.95`` sampled run twice, equal;
    ``beam_search(num_beams=4)`` scoring at least greedy's sequence
    (teacher-forced log-probabilities) and ``num_beams=1`` greedy's tokens
    under the near-tie rule; ``generate_ragged`` on three prompt lengths
    equal to ``generate`` per length.  K1 12 a prefill of 128 tokens."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    model = _seeded_model("gpt2", seed=SEED, device=dev).eval()
    g = DECODE_GEN
    rng = np.random.default_rng(SEED + 27)
    prompts = rng.integers(0, model.vocab_size, (g["batch"], g["prompt"]))
    n = g["new_tokens"]
    with checked_calls(checks):
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        greedy = mt.generate(model, prompts, n, device=dev)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) * 1e3
        for kw in (dict(temperature=1.5, top_k=1, rng=1),
                   dict(temperature=0.05, top_p=1e-6, rng=2)):
            if not torch.equal(mt.generate(model, prompts, n, device=dev,
                                           **kw), greedy):
                raise AssertionError(f"generate {kw} differs from greedy")
        sampled = [mt.generate(model, prompts, n, temperature=0.8, top_k=50,
                               top_p=0.95, rng=3, device=dev)
                   for _ in range(2)]
        if not torch.equal(*sampled):
            raise AssertionError("top-k/top-p sampling does not repeat")
        t0 = time.perf_counter()
        beams = mt.beam_search(model, prompts, n, num_beams=4, device=dev)
        torch.cuda.synchronize()
        beam_ms = (time.perf_counter() - t0) * 1e3
        beam1 = mt.beam_search(model, prompts, n, num_beams=1, device=dev)
        lens = g["ragged"]
        ragged_prompts = [rng.integers(0, model.vocab_size, m)
                          for m in (lens[1], lens[0], lens[2], lens[1])]
        ragged = mt.generate_ragged(model, ragged_prompts, 16, device=dev)
        for m in lens:
            idx = [i for i, p in enumerate(ragged_prompts) if len(p) == m]
            want = mt.generate(model, np.stack([ragged_prompts[i]
                                                for i in idx]), 16,
                               device=dev)
            if not all(torch.equal(ragged[i], want[j])
                       for j, i in enumerate(idx)):
                raise AssertionError(f"generate_ragged at length {m}")
        counts = mt.launch_counts()
    # 5 generate calls, 2 beam searches and the ragged and per-length
    # calls at 128 tokens: K1 for each; 96 and 200 take the plain path.
    prefills = 5 + 2 + 2
    want = dict(dict.fromkeys(counts, 0), flash_fwd=model.depth * prefills)
    if counts != want:
        raise AssertionError(f"generate modes: launches {counts}, "
                             f"expected {want}")
    greedy_np, beams_np = greedy.cpu().numpy(), beams.cpu().numpy()
    parted = near_tie(model, list(prompts), beam1.cpu().numpy(), greedy_np,
                      _slack(None), "beam_search(num_beams=1)")
    scores = {}
    for name, seqs in (("greedy", greedy_np), ("beam4", beams_np)):
        scores[name] = []
        for seq in seqs:
            logp = torch.log_softmax(_teacher_logits(model, seq[:-1]), -1)
            tok = torch.as_tensor(seq[g["prompt"]:].astype(np.int64),
                                  device=dev)
            scores[name].append(logp[g["prompt"] - 1:].gather(
                1, tok[:, None]).sum().item())
    for b, (s_beam, s_greedy) in enumerate(zip(scores["beam4"],
                                               scores["greedy"])):
        if not s_beam >= s_greedy - 1e-4 * abs(s_greedy):
            raise AssertionError(f"beam row {b}: score {s_beam} below "
                                 f"greedy's {s_greedy}")
    return dict(prompts=[g["batch"], g["prompt"]], new_tokens=n,
                greedy_ms=greedy_ms, beam4_ms=beam_ms, scores=scores,
                beam1_parted_rows=parted, ragged_lens=list(lens),
                launches=counts)


def decode_phase(dev, smi: str) -> dict:
    """The ``decode`` phase: its runs in order, each one line, then the
    per-call checks of every eager K1 and K6 call; returns the counted
    runs' launches."""
    import torch

    checks: dict = {}
    t0 = time.perf_counter()
    spec = decode_spec(dev, checks)
    for name, run in spec["runs"].items():
        log(f"decode serving {name} on {smi}: " + json.dumps(run))
    log(f"decode serving sampled/bf16 on {smi}: " + json.dumps(
        {k: spec[k] for k in ("sampled_equal", "bf16", "prompt_lens",
                              "new_tokens", "spec_k")}))
    t1 = time.perf_counter()
    draft = decode_draft_model(dev, checks)
    log(f"decode draft model on {smi}: " + json.dumps(draft))
    t2 = time.perf_counter()
    chunked = decode_chunked(dev, checks)
    log(f"decode chunked prefill on {smi}: " + json.dumps(chunked))
    t3 = time.perf_counter()
    gen = decode_generate(dev, checks)
    log(f"decode generate modes on {smi}: " + json.dumps(gen))
    t4 = time.perf_counter()
    for kname in ("flash_fwd", "paged_attention"):
        if not checks.get(kname, {}).get("calls"):
            raise AssertionError(f"the per-call check saw no {kname} call")
    log(f"decode per-call checks on {smi}: " + json.dumps(checks))
    log(f"decode seconds: spec {t1 - t0:.1f}, draft {t2 - t1:.1f}, chunked "
        f"{t3 - t2:.1f}, generate {t4 - t3:.1f}")
    launches = {}
    for counts in ([r["launches"] for r in spec["runs"].values()]
                   + [chunked["chunked"]["launches"],
                      chunked["unchunked"]["launches"], gen["launches"]]):
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n
    log(f"decode launches on {smi}: " + json.dumps(launches))
    torch.cuda.empty_cache()
    return dict(launches=launches)


# The serving front end (``--only front``): GPT-2 124M fp32 behind
# ``Server``'s HTTP front end, two weighted tenants, SLO accounting, the
# overload ladder and the decode watchdog.
FRONT = dict(requests=16, new_tokens=32, lens=(130, 300), page=16)
FRONT_TENANTS = dict(a=dict(weight=3.0), b=dict(weight=1.0, max_active=4))
FRONT_SLO = dict(ttft_ms=500.0, tpot_ms=50.0, target=0.99)
FRONT_WATCHDOG_S = 2.0
# Tenant a's share of the contended admissions of the first pass: its
# weight's 0.75, apart from an unweighted FIFO's 0.5 and a starved b's 1.
FRONT_SHARE = (0.65, 0.85)
FRONT_SCRAPE_HZ = 10.0
# The JAX package's ServingMetrics.snapshot() keys (the CPU tests hold the
# port's to them: tests/test_torch_serving_front.py).
JAX_SNAPSHOT_KEYS = (
    "adapter_evictions_total", "adapter_hits_total", "adapter_loads_total",
    "adapter_pool_bytes", "adapter_slots_free", "adapter_slots_total",
    "adapter_slots_used", "adapters_resident", "admissions_blocked",
    "chunked_admissions_total", "decode_step_p50_ms", "decode_step_p99_ms",
    "decode_steps_total", "e2e_p50_ms", "e2e_p99_ms", "engine_errors",
    "kv_pages_free", "kv_pages_total", "kv_pages_used", "kv_pool_bytes",
    "max_active_slots", "preemptions_total", "prefill_chunks_total",
    "prefill_p50_ms", "prefill_p99_ms", "prefix_cache_nodes",
    "prefix_hit_rate", "prefix_hits", "prefix_misses",
    "prefix_tokens_saved", "queue_depth", "queue_wait_p50_ms",
    "queue_wait_p99_ms", "requests_admitted", "requests_cancelled",
    "requests_completed", "requests_expired", "requests_rejected",
    "requests_shed", "slot_occupancy_mean", "spec_accept_hist",
    "spec_acceptance_rate", "spec_accepted_tokens", "spec_draft_k",
    "spec_drafted_tokens", "spec_steps_total", "spec_tokens_per_step",
    "tenants", "tokens_per_sec_busy", "tokens_per_sec_wall", "tokens_total",
    "tpot_p50_ms", "tpot_p99_ms", "ttft_p50_ms", "ttft_p99_ms",
    "watchdog_trips")
PROM_SAMPLE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$'


def _http(base: str, path: str, body=None, raw=None, timeout=120):
    """(status, JSON or text payload, headers) of one request to the
    server on the loopback."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, text, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        code, text, headers = e.code, e.read(), e.headers
    try:
        return code, json.loads(text), headers
    except ValueError:
        return code, text.decode(), headers


def _gen_body(prompt, n, **kw) -> dict:
    return dict(prompt=[int(t) for t in prompt], max_new_tokens=n, **kw)


def _front_prompts(rng, vocab: int, n: int) -> list:
    """``n`` random prompts of distinct lengths in FRONT["lens"] (a
    timeline is matched to its client by tenant and length); no two
    share a page-16 block."""
    import numpy as np

    lo, hi = FRONT["lens"]
    lens = rng.choice(np.arange(lo, hi + 1), n, replace=False)
    return [rng.integers(0, vocab, int(m)).astype(np.int32) for m in lens]


# The HTTP clients and the scraper run in processes of their own, as a
# load balancer's clients and a Prometheus scraper do: threads of this
# process would wait on its GIL beside the server's threads.  Each
# prints JSON; time.monotonic() is the machine's CLOCK_MONOTONIC in both.
FRONT_CLIENTS = r"""
import json, sys, threading, time, urllib.error, urllib.request
base, bodies = sys.argv[1], json.load(sys.stdin)
with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
    resp.read()  # the first request pays urllib's lazy imports
out = [None] * len(bodies)
barrier = threading.Barrier(len(bodies))
def post(i):
    req = urllib.request.Request(base + "/v1/generate",
                                 data=json.dumps(bodies[i]).encode(),
                                 headers={"Content-Type": "application/json"})
    barrier.wait()
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, text = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read()
    out[i] = dict(code=code, body=json.loads(text), t0=t0,
                  t1=time.monotonic())
threads = [threading.Thread(target=post, args=(i,))
           for i in range(len(bodies))]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(out))
"""
FRONT_SCRAPER = r"""
import json, sys, threading, time, urllib.request
base, hz = sys.argv[1], float(sys.argv[2])
stop = threading.Event()
threading.Thread(target=lambda: (sys.stdin.read(), stop.set()),
                 daemon=True).start()
codes = []
while True:
    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        resp.read()
        codes.append(resp.status)
    if len(codes) == 1:
        print("ready", flush=True)
    if stop.wait(1.0 / hz):
        break
print(json.dumps(codes))
"""


def _front_pass(server, prompts, tenants, base=None, scrape=None) -> dict:
    """One counted pass: the prompts submitted together (over HTTP with
    ``base``: 16 client threads in a process of their own; else
    in-process), FRONT["new_tokens"] greedy tokens each, the counts set
    to 0 before and read after.  With ``scrape``, a process GETs
    ``/metrics`` at that rate meanwhile.  Gates: every request 200/done
    with its tokens; K1 12 a prefill (every prompt's bucket is >= 128,
    no prefix hit), K6 12 a decode step."""
    import numpy as np

    import ml_trainer_tpu_torch as mt

    n = FRONT["new_tokens"]
    model = server.engine.model
    gc.collect()  # not inside the timed pass
    before = server.metrics.snapshot()
    scraper = None
    if scrape:
        host, port = server._httpd.server_address
        scraper = subprocess.Popen(
            [sys.executable, "-c", FRONT_SCRAPER, f"http://{host}:{port}",
             str(scrape)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        if scraper.stdout.readline().strip() != "ready":
            raise AssertionError("front: the scraper did not start")
    mt.reset_launch_counts()
    client_times = None
    since = time.monotonic()
    t0 = time.perf_counter()
    if base is not None:
        bodies = [_gen_body(p, n, tenant=t) for p, t in zip(prompts, tenants)]
        proc = subprocess.run(
            [sys.executable, "-c", FRONT_CLIENTS, base],
            input=json.dumps(bodies), capture_output=True, text=True,
            timeout=600, check=True)
        res = json.loads(proc.stdout)
        bad = [(r["code"], r["body"]) for r in res if r["code"] != 200]
        if bad:
            raise AssertionError(f"front: HTTP failures {bad[:3]}")
        outs = [np.asarray(r["body"]["tokens"], np.int32) for r in res]
        client_times = [(r["t0"], r["t1"]) for r in res]
        wall = max(r["t1"] for r in res) - min(r["t0"] for r in res)
    else:
        streams = [server.submit(p, n, tenant=t)
                   for p, t in zip(prompts, tenants)]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
    snap = settled_snapshot(server, before, len(prompts) * n)
    counts = mt.launch_counts()
    scrapes = 0
    if scraper is not None:
        out, _ = scraper.communicate(timeout=60)
        codes = json.loads(out.strip().splitlines()[-1])
        if scraper.returncode or any(c != 200 for c in codes):
            raise AssertionError(f"front: scrapes {codes[:3]}")
        scrapes = len(codes)
    steps = snap["decode_steps_total"] - before["decode_steps_total"]
    want = dict(dict.fromkeys(counts, 0), flash_fwd=model.depth * len(prompts),
                paged_attention=model.depth * steps)
    if counts != want or not steps:
        raise AssertionError(f"front: launches {counts}, expected {want}")
    if any(len(o) != len(p) + n for o, p in zip(outs, prompts)):
        raise AssertionError("front: a response is short")
    step_secs = list(server.metrics._step_secs)[-steps:]
    return dict(outs=outs, launches=counts, wall_s=wall,
                tokens_per_s=len(prompts) * n / wall, decode_steps=steps,
                step_ms_mean=1e3 * sum(step_secs) / steps,
                step_ms_p50=1e3 * sorted(step_secs)[steps // 2],
                client_times=client_times, since=since, scrapes=scrapes)


def _http_overhead(server, run: dict, tenants, prompts) -> dict:
    """A client's seconds less its request's e2e, in ms: the mean, the
    largest, and its parts before the submit and after the finish (the
    timelines matched to the clients by tenant and prompt length; call
    it before the next pass)."""
    tls = {(tl["tenant"], tl["prompt_tokens"]): tl
           for tl in server.slo.timelines(since=run["since"])}
    lags = [(tls[(t, len(p))]["submitted_at"] - c0,
             c1 - tls[(t, len(p))]["finished_at"])
            for (c0, c1), t, p in zip(run["client_times"], tenants, prompts)]
    total = [a + b for a, b in lags]
    return dict(mean=1e3 * sum(total) / len(total), max=1e3 * max(total),
                to_submit_mean=1e3 * sum(a for a, _ in lags) / len(lags),
                from_finish_mean=1e3 * sum(b for _, b in lags) / len(lags))


def _contended_admissions(server):
    """Wrap the server's ``scheduler.acquire`` (host-only) to record, for
    each admission, its tenant and whether both tenants had queued
    requests just before it."""
    sched = server.scheduler
    real = sched.acquire
    log_ = []

    def acquire():
        depths = sched.tenant_depths()
        got = real()
        if got is not None:
            log_.append((got[0].tenant,
                         depths.get("a", 0) > 0 and depths.get("b", 0) > 0))
        return got

    sched.acquire = acquire
    return log_


def _tenant_latencies(server, since: float) -> dict:
    """TTFT, TPOT, queue wait and e2e percentiles (ms) per tenant over
    the timelines submitted since ``since`` (``aggregate_timelines``)."""
    from ml_trainer_tpu_torch.serving import aggregate_timelines

    out = {}
    for t in ("a", "b"):
        agg = aggregate_timelines(server.slo.timelines(since=since,
                                                       tenants={t}),
                                  server.slo.policy)
        out[t] = {k: agg[k] for k in ("n_requests", "ttft_ms", "tpot_ms",
                                      "queue_wait_ms", "e2e_ms",
                                      "attainment")}
    return out


def front_tenants(dev, model, checks: dict) -> dict:
    """Two tenants over HTTP on one ``Server`` (tenant a weight 3, b
    weight 1 with ``max_active=4``; ``FRONT_SLO``): an HTTP pass of 16
    client threads, the same at a 0.5 ms GIL switch interval, an
    in-process pass and an in-process pass with ``/metrics`` scraped at
    10 Hz, each 16 fresh prompts of 130-300 tokens and 32 greedy tokens,
    counted; the HTTP pass's tokens against
    the same server's in-process ``complete()`` of its prompts (tenant
    "check": no prefix hit) under the per-call checks; the weighted
    share of contended admissions; then the endpoints."""
    import re

    import numpy as np

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.serving import TenantConfig
    from ml_trainer_tpu_torch.telemetry import reset_default_registry

    rng = np.random.default_rng(SEED + 30)
    vocab = model.vocab_size
    tenants = {k: TenantConfig(**v) for k, v in FRONT_TENANTS.items()}
    names = ["a", "b"] * (FRONT["requests"] // 2)
    reset_default_registry()
    rec = {}
    with mt.Server(model, max_batch=8, kv_page_size=FRONT["page"],
                   paged_kernel=True, tenants=tenants,
                   slo=mt.SloPolicy(**FRONT_SLO), slo_timelines=256,
                   http_port=0, device=dev) as server:
        host, port = server._httpd.server_address
        base = f"http://{host}:{port}"
        rec["kernel_load_s"] = server.kernel_load_s
        with checked_calls(checks):
            # Uncounted: the decode graph's warm-up (its one eager step
            # checked) and capture, then a pass's worth of prefills and
            # steps (the allocator's blocks for 8 slots of both buckets),
            # and the handlers' first request.
            for m in FRONT["lens"]:
                server.complete(rng.integers(0, vocab, m), 3, timeout=600,
                                tenant="warm")
            warm = [server.submit(p, 4, tenant="warm") for p in
                    _front_prompts(rng, vocab, FRONT["requests"])]
            for st in warm:
                st.result(timeout=600)
        _http(base, "/healthz")
        rec["capture_s"] = server.engine._graph.capture_s
        # The HTTP pass first: the tenants' strides start level.  A pass
        # carries them over to the next (tenant a, owed the most, then
        # takes every contended admission), in the JAX package alike
        # (tests/test_torch_serving_front.py), so only this pass is
        # held to the weights.
        prompts = _front_prompts(rng, vocab, FRONT["requests"])
        admissions = _contended_admissions(server)
        http = _front_pass(server, prompts, names, base=base)
        del server.scheduler.acquire  # the class's again
        rec["latency_ms"] = _tenant_latencies(server, http["since"])
        http_over = _http_overhead(server, http, names, prompts)
        # The same pass with the interpreter's GIL switch interval at
        # 0.5 ms (5 ms by default), set by this script around it: how
        # much of the HTTP overhead is the handlers waiting on the GIL
        # behind the loop thread.
        switch = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            fast_prompts = _front_prompts(rng, vocab, FRONT["requests"])
            fast = _front_pass(server, fast_prompts, names, base=base)
        finally:
            sys.setswitchinterval(switch)
        fast_over = _http_overhead(server, fast, names, fast_prompts)
        n = FRONT["requests"]
        inproc = _front_pass(server, _front_prompts(rng, vocab, n), names)
        scraped = _front_pass(server, _front_prompts(rng, vocab, n), names,
                              scrape=FRONT_SCRAPE_HZ)
        with checked_calls(checks):
            streams = [server.submit(p, FRONT["new_tokens"], tenant="check")
                       for p in prompts]
            want = [s.result(timeout=600) for s in streams]
        parted = near_tie(model, prompts, http["outs"], want, _slack(None),
                          "front: HTTP vs in-process")
        # Weighted admission: tenant a's share of the pass's contended
        # admissions near its 3 of 4, apart from 1:1 and 1:0.
        contended = [t for t, both in admissions if both]
        share = contended.count("a") / max(len(contended), 1)
        if len(contended) < 8 or not (
                FRONT_SHARE[0] <= share <= FRONT_SHARE[1]):
            raise AssertionError(f"front: contended admissions {contended}")
        rec.update(
            inproc={k: v for k, v in inproc.items()
                    if k not in ("outs", "client_times", "since")},
            http={k: v for k, v in http.items()
                  if k not in ("outs", "client_times", "since")},
            scraped={k: v for k, v in scraped.items()
                     if k not in ("outs", "client_times", "since")},
            http_over_inproc=http["tokens_per_s"] / inproc["tokens_per_s"],
            http_overhead_ms=http_over,
            http_switch_0_5ms=dict(
                launches=fast["launches"], tokens_per_s=fast["tokens_per_s"],
                step_ms_mean=fast["step_ms_mean"], overhead_ms=fast_over),
            contended_admissions="".join(contended),
            contended_share_a=share,
            parted_rows=parted)
        # The endpoints.
        code, prom, headers = _http(base, "/metrics")
        if code != 200 or not headers["Content-Type"].startswith(
                "text/plain; version=0.0.4"):
            raise AssertionError(f"front: /metrics {code}")
        sample = re.compile(PROM_SAMPLE)
        for line in prom.splitlines():
            if not (line.startswith("# ") or sample.match(line)):
                raise AssertionError(f"front: /metrics line {line!r}")
        for stem in ("ttft", "tpot"):
            for t in ("a", "b"):
                if f'serving_{stem}_seconds_bucket{{tenant="{t}"' not in prom:
                    raise AssertionError(f"front: no {stem} buckets for {t}")
        code, snap, _ = _http(base, "/metrics.json")
        if code != 200 or sorted(snap) != sorted(JAX_SNAPSHOT_KEYS):
            raise AssertionError(
                "front: /metrics.json keys "
                f"{sorted(set(snap) ^ set(JAX_SNAPSHOT_KEYS))}")
        code, slo, _ = _http(base, "/slo")
        if code != 200 or not {"a", "b"} <= set(slo["tenants"]):
            raise AssertionError(f"front: /slo {code} {slo}")
        health = _http(base, "/healthz")
        if health[0] != 200 or not health[1]["ok"]:
            raise AssertionError(f"front: /healthz {health[:2]}")
        codes = dict(
            unknown=_http(base, "/nope")[0],
            malformed=_http(base, "/v1/generate", raw=b"{not json")[0])
        if codes != dict(unknown=404, malformed=400):
            raise AssertionError(f"front: codes {codes}")
        rec.update(slo={t: slo["tenants"][t] for t in ("a", "b")},
                   slo_policy=slo["policy"], codes=codes,
                   metrics_lines=len(prom.splitlines()),
                   snapshot=dict(tokens_per_sec_busy=snap[
                       "tokens_per_sec_busy"], slot_occupancy_mean=snap[
                       "slot_occupancy_mean"], tenants=snap["tenants"]))
        rec["overload"] = front_overload(server, base, rng)
    return rec


def front_overload(server, base: str, rng) -> dict:
    """The ladder's rungs on the tenants' server (every rung acts on new
    admissions only): 1 clamps a fresh request and spares a running one;
    3 answers a prefix miss 503 with Retry-After and admits a hit; 4
    sheds the queued priority-0 request, keeps the queued priority-1 one
    and the running ones, and refuses a fresh priority-0 POST."""
    import numpy as np

    from ml_trainer_tpu_torch.serving import (
        DegradationConfig, DegradationLadder, OverloadShed)

    vocab = server.engine.model.vocab_size
    cfg = DegradationConfig(clamp_tokens=8, retry_after_s=2.0,
                            shed_below_priority=1)
    ladder = DegradationLadder([server], cfg)
    rec = {}
    pA, pB = (rng.integers(0, vocab, 140) for _ in range(2))
    sA = server.submit(pA, 64)
    while len(sA.tokens) < 3:
        time.sleep(1e-3)
    ladder.set_level(1, "front: clamp")
    sB = server.submit(pB, 64)
    outA, outB = sA.result(timeout=600), sB.result(timeout=600)
    ladder.set_level(0, "front: recovered")
    refB = server.complete(pB, 64, tenant="ref", timeout=600)
    if len(outA) != len(pA) + 64 or len(outB) != len(pB) + 8:
        raise AssertionError(f"front rung 1: {len(outA)}, {len(outB)}")
    rec["rung1_parted_rows"] = near_tie(
        server.engine.model, [pB], [outB], [refB[:len(pB) + 8]],
        _slack(None), "front rung 1")
    # Rung 3: a miss is shed (503, Retry-After), a hit is served.
    ladder.set_level(3, "front: hits only")
    miss = _http(base, "/v1/generate", _gen_body(
        rng.integers(0, vocab, 150), 4))
    hit_p = np.concatenate([pA[:128], rng.integers(0, vocab, 20)])
    hit = _http(base, "/v1/generate", _gen_body(hit_p, 4))
    if (miss[0], miss[2]["Retry-After"]) != (503, "2") or hit[0] != 200:
        raise AssertionError(f"front rung 3: {miss[:2]}, {hit[:2]}")
    rec["rung3"] = dict(miss=miss[0], retry_after=miss[2]["Retry-After"],
                        hit=hit[0])
    # Rung 4: eight running (prefix hits, so that rung 3 lets them in),
    # then a queued priority-0 and a queued priority-1 request.
    ladder.set_level(0, "front: recovered")
    hits = [np.concatenate([pA[:128], rng.integers(0, vocab, 8)])
            for _ in range(9)]
    running = [server.submit(p, 48) for p in hits[:8]]
    while server.engine.active_count() < 8:
        time.sleep(1e-3)
    lo = server.submit(rng.integers(0, vocab, 130), 8, priority=0)
    hi = server.submit(hits[8], 8, priority=1)
    ladder.set_level(4, "front: shed")
    try:
        lo.result(timeout=600)
        raise AssertionError("front rung 4: the priority-0 request ran")
    except OverloadShed as e:
        rec["rung4_retry_after"] = e.retry_after
    fresh = _http(base, "/v1/generate", _gen_body(hits[8], 4, priority=0))
    if fresh[0] != 503 or fresh[2]["Retry-After"] != "2":
        raise AssertionError(f"front rung 4: fresh {fresh[:2]}")
    if any(len(s.result(timeout=600)) != 136 + 48 for s in running):
        raise AssertionError("front rung 4: a running stream was cut")
    if len(hi.result(timeout=600)) != 136 + 8:
        raise AssertionError("front rung 4: the priority request was cut")
    rec.update(rung4_shed_total=ladder.snapshot()["shed_total"],
               requests_shed=server.metrics.snapshot()["requests_shed"])
    ladder.set_level(0, "front: done")
    return rec


def front_spec_off(dev, model) -> dict:
    """Rung 2 mid-stream on a ``spec_k=4`` server: the greedy stream that
    crosses it keeps the vanilla tokens (a vanilla server's, the near-tie
    rule) and no verify step runs after the one in flight."""
    import numpy as np

    import ml_trainer_tpu_torch as mt

    rng = np.random.default_rng(SEED + 31)
    p = _spec_prompts(rng, model.vocab_size, [200])[0]
    with mt.Server(model, max_batch=8, kv_page_size=FRONT["page"],
                   paged_kernel=True, device=dev) as vanilla:
        want = vanilla.complete(p, 48, timeout=600)
    with mt.Server(model, max_batch=8, kv_page_size=FRONT["page"],
                   paged_kernel=True, spec_k=DECODE_SPEC_K,
                   device=dev) as server:
        st = server.submit(p, 48)
        while len(st.tokens) < 8:
            time.sleep(1e-3)
        server.set_degradation(2)
        at_switch = server.metrics.snapshot()["spec_steps_total"]
        got = st.result(timeout=600)
        after = server.metrics.snapshot()["spec_steps_total"]
    if after > at_switch + 1 or at_switch == 0:
        raise AssertionError(f"front rung 2: verify steps {at_switch} -> "
                             f"{after}")
    return dict(parted_rows=near_tie(model, [p], [got], [want], _slack(None),
                                     "front rung 2"),
                verify_steps_before=at_switch, verify_steps_after=after)


def front_wedge(dev, model) -> dict:
    """The watchdog on the card: a ``Server(watchdog_timeout=2.0,
    max_queue=2)`` warmed (eight active and two queued make a POST 429;
    the decode graph captured), then ``decode_wedge@step=N,secs=60``: the
    HTTP client gets 503 "wedged" within the timeout plus a poll plus 2 s
    of the wedge, ``/healthz`` 503, a new POST 503, one trip; after the
    release and ``close()`` the memory is back within 1% and a fresh
    ``Server`` serves the prompt with the same tokens."""
    import threading

    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.resilience import faults
    from ml_trainer_tpu_torch.serving import AdmissionError

    rng = np.random.default_rng(SEED + 32)
    vocab = model.vocab_size
    p = rng.integers(0, vocab, 180).astype(np.int32)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    rec = {}
    server = mt.Server(model, max_batch=8, max_queue=2,
                       kv_page_size=FRONT["page"], paged_kernel=True,
                       watchdog_timeout=FRONT_WATCHDOG_S, http_port=0,
                       device=dev)
    plan = None
    try:
        host, port = server._httpd.server_address
        base = f"http://{host}:{port}"
        want = server.complete(p, 32, timeout=600)
        rec["capture_s"] = server.engine._graph.capture_s
        streams = []
        while len(streams) < 10:
            try:
                streams.append(server.submit(rng.integers(0, vocab, 140), 64))
            except AdmissionError:
                time.sleep(2e-3)
            if len(streams) == 8:
                while server.engine.active_count() < 8:
                    time.sleep(1e-3)
        full = _http(base, "/v1/generate", _gen_body(p, 4))
        for s in streams:
            s.result(timeout=600)
        if full[0] != 429:
            raise AssertionError(f"front: a full queue answered {full[:2]}")
        rec["queue_full"] = full[0]
        n = server.engine._step_seq + 4
        plan = faults.install(faults.FaultPlan.parse(
            f"decode_wedge@step={n},secs=60"))
        box = {}

        def client():
            box["resp"] = _http(base, "/v1/generate", _gen_body(p, 32))
            box["t"] = time.monotonic()

        th = threading.Thread(target=client)
        th.start()
        while not plan.faults[0].fired:
            time.sleep(1e-3)
        fired = time.monotonic()
        th.join(timeout=120)
        code, payload, _ = box["resp"]
        detect = box["t"] - fired
        bar = FRONT_WATCHDOG_S + FRONT_WATCHDOG_S / 5 + 2.0
        if code != 503 or "wedged" not in payload["error"] or detect > bar:
            raise AssertionError(f"front wedge: {code} {payload} after "
                                 f"{detect:.2f}s (bar {bar}s)")
        health = _http(base, "/healthz")
        again = _http(base, "/v1/generate", _gen_body(p, 4))
        trips = server.metrics.snapshot()["watchdog_trips"]
        if (health[0], again[0], trips) != (503, 503, 1):
            raise AssertionError(f"front wedge: /healthz {health[0]}, POST "
                                 f"{again[0]}, trips {trips}")
        rec.update(step=n, detect_s=detect, bar_s=bar,
                   reason=health[1]["reason"], wedged_post=again[0])
    finally:
        if plan is not None:
            plan.release_wedge()
        faults.uninstall()
        server.close()
    del server
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(dev)
    if abs(mem1 - mem0) > 0.01 * mem0:
        raise AssertionError(f"front wedge: memory {mem0} -> {mem1}")
    with mt.Server(model, max_batch=8, kv_page_size=FRONT["page"],
                   paged_kernel=True, device=dev) as fresh:
        got = fresh.complete(p, 32, timeout=600)
    if not np.array_equal(got, want):
        raise AssertionError("front wedge: the fresh server's tokens differ")
    rec.update(memory_before=mem0, memory_after=mem1)
    return rec


def front_phase(dev, smi: str) -> dict:
    """The ``front`` phase: the tenants' server over HTTP (with the
    endpoints and rungs 1, 3 and 4), rung 2 on a ``spec_k=4`` server, the
    wedge, each one line; then the per-call checks.  Returns the counted
    passes' launches."""
    import torch

    model = _seeded_model("gpt2", seed=SEED, device=dev).eval()
    checks: dict = {}
    t0 = time.perf_counter()
    ten = front_tenants(dev, model, checks)
    t1 = time.perf_counter()
    spec = front_spec_off(dev, model)
    t2 = time.perf_counter()
    wedge = front_wedge(dev, model)
    t3 = time.perf_counter()
    for kname in ("flash_fwd", "paged_attention"):
        if not checks.get(kname, {}).get("calls"):
            raise AssertionError(f"the per-call check saw no {kname} call")
    over = ten.pop("overload")
    log(f"front tenants over HTTP on {smi}: " + json.dumps(ten))
    log(f"front overload on {smi}: " + json.dumps(dict(over, rung2=spec)))
    log(f"front wedge on {smi}: " + json.dumps(wedge))
    log(f"front per-call checks on {smi}: " + json.dumps(checks))
    log(f"front on {smi}: tokens/s HTTP {ten['http']['tokens_per_s']:.1f} "
        f"vs in-process {ten['inproc']['tokens_per_s']:.1f}; HTTP overhead "
        f"{ten['http_overhead_ms']['mean']:.2f} ms a request (GIL switch "
        f"0.5 ms: {ten['http_switch_0_5ms']['tokens_per_s']:.1f} tokens/s, "
        f"{ten['http_switch_0_5ms']['overhead_ms']['mean']:.2f} ms); decode "
        "step "
        f"{ten['inproc']['step_ms_mean']:.3f} ms unscraped, "
        f"{ten['scraped']['step_ms_mean']:.3f} ms scraped at "
        f"{FRONT_SCRAPE_HZ:g} Hz; watchdog detection {wedge['detect_s']:.2f}"
        f" s (capture {wedge['capture_s']:.3f} s)")
    for t, lat in ten["latency_ms"].items():
        log(f"front tenant {t}: TTFT p50/p99 {lat['ttft_ms']['p50']}/"
            f"{lat['ttft_ms']['p99']} ms, TPOT p50/p99 {lat['tpot_ms']['p50']}"
            f"/{lat['tpot_ms']['p99']} ms, queue wait p50 "
            f"{lat['queue_wait_ms']['p50']} ms, e2e p50 {lat['e2e_ms']['p50']}"
            " ms")
    log(f"front seconds: tenants {t1 - t0:.1f}, spec-off {t2 - t1:.1f}, "
        f"wedge {t3 - t2:.1f}")
    launches = {}
    for run in ("inproc", "http", "scraped", "http_switch_0_5ms"):
        for kname, n in ten[run]["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    log(f"front launches on {smi}: " + json.dumps(launches))
    torch.cuda.empty_cache()
    return dict(launches=launches)


# KV migration and the router (``--only router``): GPT-2 124M fp32 (12
# blocks, 768 wide, seeded) through ``Router``, paged at page 16 with
# max_len 1024 and 8 slots a replica, K1 in every full prefill and K6 in
# every decode step (the graph).
ROUTER = dict(requests=16, system=128, lens=(130, 300), new_tokens=32,
              page=16, max_batch=8, fleet_requests=8, hold_step=4)
ROUTER_DIR = "build/chip_smoke_router"  # the fleet's weights and logs


def _router_prompts(rng, vocab: int) -> tuple:
    """ROUTER["requests"] prompts of distinct lengths in ROUTER["lens"]:
    the even ones open with one 128-token system prompt (tenant "sys",
    one prefix-cache namespace), the odd ones are random (tenant
    "default"); returns (prompts, tenants)."""
    import numpy as np

    lo, hi = ROUTER["lens"]
    lens = rng.choice(np.arange(lo, hi + 1), ROUTER["requests"],
                      replace=False)
    system = rng.integers(0, vocab, ROUTER["system"])
    prompts, tenants = [], []
    for i, m in enumerate(lens):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, int(m) - ROUTER["system"])
            prompts.append(np.concatenate([system, tail]).astype(np.int32))
            tenants.append("sys")
        else:
            prompts.append(rng.integers(0, vocab, int(m)).astype(np.int32))
            tenants.append("default")
    return prompts, tenants


@contextlib.contextmanager
def _engine_clocks(engines, router=None):
    """Count each engine's full prefills (the K1 route: a prefix hit runs
    the suffix through the plain paged path) and time its exports and
    imports, and the router's adoptions (serialize, ship, verify), on the
    host clock, by wrapping the instances' methods (host code only)."""
    rec = dict(full_prefills=0, export_ms=[], import_ms=[], adopt_ms=[])
    wrapped = []

    def wrap(obj, attr, key):
        real = getattr(obj, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                if key == "full_prefills":
                    rec[key] += 1
                else:
                    rec[key].append(1e3 * (time.perf_counter() - t0))

        setattr(obj, attr, timed)
        wrapped.append((obj, attr))

    for eng in engines:
        wrap(eng, "_admit_full_prefill", "full_prefills")
        wrap(eng, "export_slot", "export_ms")
        wrap(eng, "import_slot", "import_ms")
    if router is not None:
        wrap(router, "_adopt", "adopt_ms")
    try:
        yield rec
    finally:
        for obj, attr in wrapped:
            delattr(obj, attr)


def _hold_at_step(server, n: int):
    """Hold ``server``'s loop before its ``n``th decode step from now
    until the returned ``go`` is set (``reached`` set when it gets there);
    a server marked unhealthy meanwhile skips that step.  So the kill
    lands mid-stream whatever the machine's pace."""
    import threading

    engine, real = server.engine, server.engine.step
    reached, go = threading.Event(), threading.Event()
    count = [0]

    def step():
        count[0] += 1
        if count[0] == n:
            reached.set()
            go.wait(120)
            if not server.healthy:
                return []
        return real()

    engine.step = step
    return reached, go


def _allocated_without_workspaces(dev) -> int:
    """The card's allocated bytes with torch's cuBLAS workspaces freed
    first: torch keeps one for each (handle, stream) pair it meets for
    the process's life, and a router's replicas each bring a loop thread
    (a handle) and a graph stream, so the workspaces would read as a
    leak.  Called with no graph of the phase alive; a workspace is made
    again at its next use."""
    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(dev)


def _live_cuda(top: int = 8) -> list:
    """The largest CUDA tensors the collector can see: (MB, shape,
    dtype), to name what a memory gate found still held."""
    import torch

    found = []
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                found.append((obj.numel() * obj.element_size() / 1e6,
                              list(obj.shape), str(obj.dtype)))
        except Exception:  # noqa: BLE001 - a half-built object
            continue
    return sorted(found, reverse=True)[:top]


def _ms_stats(values) -> dict:
    vals = sorted(values)
    if not vals:
        return dict(n=0)
    return dict(n=len(vals), mean=sum(vals) / len(vals),
                p50=vals[len(vals) // 2], max=vals[-1])


def _router_pass(router, prompts, tenants, what: str, kill=None) -> dict:
    """One counted pass through ``router``: the prompts submitted
    together, ROUTER["new_tokens"] greedy tokens each, the launch counts
    set to 0 before and read after.  ``kill`` (a replica name): that
    replica is held before its ROUTER["hold_step"]th decode step from
    here, killed, then released.  Gates: every request done with its
    tokens; K1 12 a full prefill, K6 12 a decode step, exactly."""
    import ml_trainer_tpu_torch as mt

    n = ROUTER["new_tokens"]
    reps = router.replicas
    servers = [r.server for r in reps.values()]
    model = servers[0].engine.model
    before = {name: r.server.metrics.snapshot()["decode_steps_total"]
              for name, r in reps.items()}
    snap0 = router.snapshot()
    gc.collect()  # not inside the timed pass
    hold = (_hold_at_step(reps[kill].server, ROUTER["hold_step"])
            if kill else None)
    with _engine_clocks([s.engine for s in servers], router) as clk:
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [router.submit(p, n, tenant=t)
                   for p, t in zip(prompts, tenants)]
        if hold is not None:
            reached, go = hold
            if not reached.wait(120):
                raise AssertionError(f"{what}: {kill} never decoded")
            router.kill_replica(kill)
            go.set()
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        counts = mt.launch_counts()
    reqs = [s.request for s in streams]
    if not all(r.state == "done" and len(r.tokens) == n for r in reqs):
        raise AssertionError(f"{what}: not every request completed: "
                             f"{[(r.state, len(r.tokens)) for r in reqs]}")
    steps = {name: r.server.metrics.snapshot()["decode_steps_total"]
             - before[name] for name, r in reps.items()}
    want = dict(dict.fromkeys(counts, 0),
                flash_fwd=model.depth * clk["full_prefills"],
                paged_attention=model.depth * sum(steps.values()))
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    snap = router.snapshot()
    moved = {k: snap[k] - snap0[k] for k in (
        "migrations_total", "kv_migrated_bytes_total", "redistributes_total",
        "migrations_corrupt_total")}
    ttft = sorted(1e3 * (r.first_token_at - r.submitted_at) for r in reqs)
    return dict(
        outs=outs, launches=counts, wall_s=wall,
        tokens_per_s=len(prompts) * n / wall,
        ttft_ms=dict(p50=ttft[len(ttft) // 2], max=ttft[-1]),
        decode_steps=steps, full_prefills=clk["full_prefills"],
        migrations_a_request=[sum(e["event"] == "kv_migrated"
                                  for e in r.events) for r in reqs],
        prefill_replica=[next(e["prefill"] for e in r.events
                              if e["event"] == "routed") for r in reqs],
        export_ms=_ms_stats(clk["export_ms"]),
        import_ms=_ms_stats(clk["import_ms"]),
        adopt_ms=_ms_stats(clk["adopt_ms"]), **moved,
        bytes_a_migration=(moved["kv_migrated_bytes_total"]
                           / max(moved["migrations_total"], 1)))


def _router_run(dev, model, roles, prompts, tenants, what: str,
                checks: dict, kill=None) -> tuple:
    """``Router.build(roles)`` over ``model``: an uncounted warm-up (the
    decode graphs' warm-up and capture on every decoding replica, its
    eager K1 and K6 calls held to float64), then the counted pass and,
    with ``kill``, a second counted pass that kills that replica
    mid-stream.  Returns (pass, kill pass or None, record)."""
    import ml_trainer_tpu_torch as mt

    with mt.Router.build(model, roles=roles, max_batch=ROUTER["max_batch"],
                         kv_page_size=ROUTER["page"], paged_kernel=True,
                         device=dev,
                         router_kwargs=dict(hedging=False)) as router:
        with checked_calls(checks):
            warm = [router.submit(p[:ROUTER["lens"][0]], 8, tenant="warm")
                    for p in (prompts[1], prompts[-1])]
            for s in warm:
                s.result(timeout=600)
        first = _router_pass(router, prompts, tenants, what)
        killed = None
        if kill:
            killed = _router_pass(router, prompts, tenants,
                                  f"{what} kill {kill}", kill=kill)
        engines = {n: r.server.engine for n, r in router.replicas.items()}
        rec = dict(
            graph_captures={n: e.graph_captures for n, e in engines.items()},
            prefix_hits={n: e._prefix.hits for n, e in engines.items()},
            prefix_nodes={n: len(e._prefix) for n, e in engines.items()},
            snapshot={k: v for k, v in router.snapshot().items()
                      if k != "degradation"},
            weights_fp=sorted({e.weights_fp for e in engines.values()}))
    for name, e in engines.items():
        decodes = first["decode_steps"][name] > 1
        if e.graph_captures != (1 if decodes else 0):
            raise AssertionError(f"{what}: {name} captured "
                                 f"{e.graph_captures} decode graphs")
    return first, killed, rec


def router_fleet_launch(model):
    """Start the fleet's two worker processes on the card
    (``Fleet(["prefill", "decode"])``, ``--ckpt`` the seeded weights
    written here as the port's ``.pth``) without waiting for them: they
    import, load and reach the card while the in-process runs go on.
    Returns (fleet, launched, t0)."""
    import torch

    import ml_trainer_tpu_torch as mt

    os.makedirs(ROUTER_DIR, exist_ok=True)
    ckpt = f"{ROUTER_DIR}/model.pth"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               ckpt)
    t0 = time.perf_counter()
    fleet = mt.serving.Fleet(
        ["prefill", "decode"], model_name="gpt2", max_len=model.max_len,
        max_batch=ROUTER["max_batch"], kv_page_size=ROUTER["page"],
        paged_kernel=True, ckpt=ckpt, log_dir=f"{ROUTER_DIR}/logs")
    launched = []
    try:
        for name, role in (("prefill0", "prefill"), ("decode0", "decode")):
            launched.append((name, *fleet.launch(name, role)))
    except BaseException:
        _stop_launched(launched)
        raise
    return fleet, launched, t0


def _stop_launched(launched) -> None:
    for _, proc, _, _ in launched:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def router_fleet(model, fleet, launched, t0, prompts, tenants) -> dict:
    """The fleet's workers (``router_fleet_launch``) ready, behind
    ``make_router()``: an uncounted warm-up under one
    ``migration_corrupt`` (the decode worker's CRC check refuses it and
    the request is prefilled again), then ROUTER["fleet_requests"]
    greedy requests counted through each worker's ``/v1/spec``: K1 12 a
    prefix miss on the prefill worker, K6 12 a decode step on the decode
    worker, one decode-graph capture."""
    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.resilience import faults

    n = ROUTER["new_tokens"]
    router = None
    try:
        for launch in launched:
            fleet.wait_ready(*launch)
        spawn_s = time.perf_counter() - t0
        router = fleet.make_router(hedging=False)
        remotes = dict(fleet.replicas)
        want_fp = mt.serving.engine.weights_fp(model)
        if any(r.engine.weights_fp != want_fp for r in remotes.values()):
            raise AssertionError("fleet: a worker serves other weights")
        t_warm = time.perf_counter()
        with faults.injected("migration_corrupt") as plan:
            router.complete(prompts[1][:ROUTER["lens"][0]], 8, timeout=600,
                            tenant="warm")
            if plan.remaining():
                raise AssertionError("fleet: the corrupt payload never flew")
        warm_s = time.perf_counter() - t_warm
        corrupt = router.snapshot()["migrations_corrupt_total"]
        if corrupt != 1:
            raise AssertionError(f"fleet: {corrupt} payloads refused")

        def worker_state():
            out = {}
            for name, r in remotes.items():
                m = r._get("/metrics.json")
                out[name] = dict(spec=r.spec(), misses=m["prefix_misses"],
                                 steps=m["decode_steps_total"])
            return out

        before = worker_state()
        k = ROUTER["fleet_requests"]
        snap0 = router.snapshot()
        with _engine_clocks([], router) as clk:
            t1 = time.perf_counter()
            streams = [router.submit(p, n, tenant=t)
                       for p, t in zip(prompts[:k], tenants[:k])]
            outs = [s.result(timeout=600) for s in streams]
            wall = time.perf_counter() - t1
        after = worker_state()
        reqs = [s.request for s in streams]
        if not all(r.state == "done" and len(r.tokens) == n for r in reqs):
            raise AssertionError("fleet: not every request completed")
        launches, captures = {}, {}
        for name in remotes:
            a, b = after[name], before[name]
            got = {kn: a["spec"]["launches"][kn] - b["spec"]["launches"][kn]
                   for kn in a["spec"]["launches"]}
            want = dict(dict.fromkeys(got, 0),
                        flash_fwd=model.depth * (a["misses"] - b["misses"]),
                        paged_attention=model.depth * (a["steps"]
                                                       - b["steps"]))
            if got != want:
                raise AssertionError(f"fleet {name}: launches {got}, "
                                     f"expected {want}")
            for kn, v in got.items():
                launches[kn] = launches.get(kn, 0) + v
            captures[name] = a["spec"]["graph_captures"]
        if captures != {"prefill0": 0, "decode0": 1}:
            raise AssertionError(f"fleet: decode graph captures {captures}")
        snap = router.snapshot()
        moved = {key: snap[key] - snap0[key] for key in (
            "migrations_total", "kv_migrated_bytes_total",
            "redistributes_total")}
        if moved["migrations_total"] != k or moved["redistributes_total"]:
            raise AssertionError(f"fleet: {moved}")
        ttft = sorted(1e3 * (r.first_token_at - r.submitted_at)
                      for r in reqs)
        rec = dict(outs=outs, launches=launches, spawn_s=spawn_s,
                   warm_s=warm_s, wall_s=wall, tokens_per_s=k * n / wall,
                   ttft_ms=dict(p50=ttft[len(ttft) // 2], max=ttft[-1]),
                   adopt_ms=_ms_stats(clk["adopt_ms"]),
                   corrupt_refused_at_the_worker=corrupt,
                   graph_captures=captures, worker_pids=[
                       r.pid for r in remotes.values()], **moved)
    finally:
        t_close = time.perf_counter()
        if router is not None:
            router.close()  # owns the workers: /admin/shutdown
        fleet.stop()
        _stop_launched(launched)
    rec["close_s"] = time.perf_counter() - t_close
    _discard(ROUTER_DIR)
    return rec


def router_phase(dev, smi: str) -> dict:
    """The ``router`` phase: a single ``Server``'s reference tokens, the
    disaggregated router (``["prefill", "decode", "decode"]``) and, on it,
    the kill pass (``decode1`` killed mid-stream), the colocated router
    (``["both"] * 3``), then the two-process fleet; each one line, then
    the per-call checks.  Gates: every pass's tokens equal the reference
    (the near-tie rule), one migration a request disaggregated, none
    colocated, exact launches, one decode-graph capture per decoding
    engine, the card's allocated memory back within 1% at the end.
    Returns the counted passes' launches."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt

    t0 = time.perf_counter()
    model = _seeded_model("gpt2", seed=SEED, device=dev).eval()
    rng = np.random.default_rng(SEED + 40)
    prompts, tenants = _router_prompts(rng, model.vocab_size)
    n = ROUTER["new_tokens"]
    checks: dict = {}
    mem0 = _allocated_without_workspaces(dev)
    launch = router_fleet_launch(model)
    try:
        with mt.Server(model, max_batch=ROUTER["max_batch"],
                       kv_page_size=ROUTER["page"], paged_kernel=True,
                       device=dev) as server:
            streams = [server.submit(p, n, tenant=t)
                       for p, t in zip(prompts, tenants)]
            want = [s.result(timeout=600) for s in streams]
        del server, streams  # its page pool
        t1 = time.perf_counter()
        disagg, killed, d_rec = _router_run(
            dev, model, ["prefill", "decode", "decode"], prompts, tenants,
            "router disagg", checks, kill="decode1")
        t2 = time.perf_counter()
        coloc, _, c_rec = _router_run(dev, model, ["both"] * 3, prompts,
                                      tenants, "router colocated", checks)
        t3 = time.perf_counter()
    except BaseException:
        _stop_launched(launch[1])
        raise
    fleet = router_fleet(model, *launch, prompts, tenants)
    t4 = time.perf_counter()
    parted = dict(
        disagg=near_tie(model, prompts, disagg["outs"], want, _slack(None),
                        "router disagg vs one server"),
        colocated=near_tie(model, prompts, coloc["outs"], disagg["outs"],
                           _slack(None), "router colocated vs disagg"),
        killed=near_tie(model, prompts, killed["outs"], disagg["outs"],
                        _slack(None), "router kill vs disagg"),
        fleet=near_tie(model, prompts[:ROUTER["fleet_requests"]],
                       fleet["outs"], disagg["outs"], _slack(None),
                       "router fleet vs disagg"))
    if disagg["migrations_a_request"] != [1] * ROUTER["requests"]:
        raise AssertionError(f"router disagg: migrations a request "
                             f"{disagg['migrations_a_request']}")
    if coloc["migrations_total"] or any(coloc["migrations_a_request"]):
        raise AssertionError("router colocated: a request migrated")
    if killed["redistributes_total"] < 1:
        raise AssertionError("router kill: nothing was redistributed")
    if not (disagg["full_prefills"] and coloc["full_prefills"]):
        raise AssertionError("router: a pass prefilled nothing through K1")
    sys_prefill = {r for r, t in zip(disagg["prefill_replica"], tenants)
                   if t == "sys"}
    for kname in ("flash_fwd", "paged_attention"):
        if not checks.get(kname, {}).get("calls"):
            raise AssertionError(f"the per-call check saw no {kname} call")
    mem1 = _allocated_without_workspaces(dev)

    def line(run):
        return {k: v for k, v in run.items() if k != "outs"}

    mb = disagg["bytes_a_migration"] / 1e6
    log(f"router disagg on {smi}: " + json.dumps(dict(
        line(disagg), **d_rec, sys_prefill_replicas=sorted(sys_prefill))))
    log(f"router kill decode1 on {smi}: " + json.dumps(line(killed)))
    log(f"router colocated on {smi}: " + json.dumps(dict(line(coloc),
                                                         **c_rec)))
    log(f"router fleet on {smi}: " + json.dumps(line(fleet)))
    log(f"router per-call checks on {smi}: " + json.dumps(checks))
    log(f"router on {smi}: tokens/s disaggregated "
        f"{disagg['tokens_per_s']:.1f} vs colocated "
        f"{coloc['tokens_per_s']:.1f} vs fleet {fleet['tokens_per_s']:.1f}; "
        f"TTFT p50 {disagg['ttft_ms']['p50']:.1f} / "
        f"{coloc['ttft_ms']['p50']:.1f} / {fleet['ttft_ms']['p50']:.1f} ms; "
        f"{mb:.2f} MB a migration (router_kv_migrated_bytes_total "
        f"{disagg['kv_migrated_bytes_total']} for "
        f"{disagg['migrations_total']}); adopt ms p50 in process "
        f"{disagg['adopt_ms'].get('p50', 0):.1f} (+ export "
        f"{disagg['export_ms'].get('p50', 0):.1f}, import "
        f"{disagg['import_ms'].get('p50', 0):.1f}) vs over HTTP "
        f"{fleet['adopt_ms'].get('p50', 0):.1f}; parted rows {parted}; "
        f"memory {mem0} -> {mem1}")
    log(f"router seconds: reference {t1 - t0:.1f}, disagg + kill "
        f"{t2 - t1:.1f}, colocated {t3 - t2:.1f}, fleet {t4 - t3:.1f} "
        f"(its workers ready {fleet['spawn_s']:.1f} s after their start, "
        f"beside the in-process runs), phase {t4 - t0:.1f}")
    launches = {}
    for run in (disagg, killed, coloc, fleet):
        for kname, count in run["launches"].items():
            launches[kname] = launches.get(kname, 0) + count
    log(f"router launches on {smi}: " + json.dumps(launches))
    if abs(mem1 - mem0) > 0.01 * mem0:
        raise AssertionError(f"router: memory {mem0} -> {mem1}; the "
                             f"largest live tensors: {_live_cuda()}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches)


# Deploy generations (``--only deploy``): GPT-2 124M fp32 (12 blocks, 768
# wide) from two seeds, each written by ``Trainer.save_model`` with its
# manifest, served through ``Router`` at page 16, max_len 1024 and 8
# slots a replica (K1 in every full prefill of 128 tokens or more, K6 in
# every decode step), rolled from the seed-0 checkpoint to the seed-1 one
# under live traffic.
DEPLOY = dict(model="gpt2", prompts=8, lens=(130, 300), new_tokens=32,
              page=16, max_batch=8, ttft_ms=2000.0, wedge_s=3.0, poll_s=0.1,
              hold_s=3.0, open_requests=16, open_rate=8.0, open_span_s=2.0,
              min_window=4, fleet_requests=4)
DEPLOY_DIR = "build/chip_smoke_deploy"  # the two model dirs, the logs


def _slice_tenant(prefix: str, lo: float, hi: float) -> str:
    """The first name ``<prefix><i>`` whose ``Router.tenant_slice`` lies
    in [lo, hi)."""
    from ml_trainer_tpu_torch.serving import Router

    i = 0
    while not lo <= Router.tenant_slice(f"{prefix}{i}") < hi:
        i += 1
    return f"{prefix}{i}"


@contextlib.contextmanager
def _k1_prefills():
    """Count the full prefills on K1's route (a bucket of 128 or more: a
    prompt over 64 tokens) of every engine, by wrapping the engine
    class's method for the duration (host code only)."""
    from ml_trainer_tpu_torch.serving.engine import SlotDecodeEngine

    real = SlotDecodeEngine._admit_full_prefill
    rec = [0]

    def counted(self, req, slot, prompt, *args, **kw):
        if prompt.shape[0] > 64:
            rec[0] += 1
        return real(self, req, slot, prompt, *args, **kw)

    SlotDecodeEngine._admit_full_prefill = counted
    try:
        yield rec
    finally:
        SlotDecodeEngine._admit_full_prefill = real


def _await_state(dep, states, what: str, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while dep.state not in states and time.monotonic() < deadline:
        if dep.finished():
            raise AssertionError(f"{what}: the deploy ended {dep.state} "
                                 f"({dep.rollback_cause})")
        time.sleep(0.01)
    if dep.state not in states:
        raise AssertionError(f"{what}: still {dep.state} after {timeout}s")


def _event_t(dep, action: str, **match) -> float:
    for row in dep.events:
        if row["action"] == action and all(row.get(k) == v
                                           for k, v in match.items()):
            return row["t"]
    raise AssertionError(f"no {action} {match} event: {dep.events}")


def _staging_s(dep) -> dict:
    """Seconds from the deploy's start to ``staged`` (spawn, warm-up and
    the decode graph's capture of every new replica) on its clock."""
    return dict(staged=round(_event_t(dep, "staged") - dep._started_at, 3),
                warmed=[row["seconds"] for row in dep.events
                        if row["action"] == "warmed"])


def _gen_tokens(model, prompts, got, want_by_gen, gens, what) -> int:
    """``got[i]`` against the reference of the generation that served it
    (``gens[i]``), by the near-tie rule; returns the parted rows."""
    parted = 0
    for g in set(gens):
        rows = [i for i, x in enumerate(gens) if x == g]
        parted += near_tie(model[g], [prompts[i] for i in rows],
                           [got[i] for i in rows],
                           [want_by_gen[g][i] for i in rows], _slack(None),
                           f"{what} generation {g}")
    return parted


def _deploy_rollback(router, ckpt, factory, prompts, want, models) -> dict:
    """(b) the new generation's ``submit_request`` wedged for
    DEPLOY["wedge_s"] (a canary TTFT far over the SLO); two canary
    requests cross the burn (min_window_requests 2, high_polls 1), two
    more are wedged when the rollback fires, four stable ones beside.
    Gates: rolled back at the first poll that sees the crossing, the
    split down, generation 1 gone, every stream done, each on the tokens
    of the weights that served it, the stable ones on seed 0's."""
    import ml_trainer_tpu_torch as mt

    c, n = DEPLOY, DEPLOY["new_tokens"]
    cfg = mt.serving.DeployConfig(
        canary=0.25, stages=(1.0,), hold_s=600.0, burn_threshold=2.0,
        high_polls=1, min_window_requests=2, poll_interval_s=c["poll_s"],
        drain_timeout_s=60.0)
    dep = router.deploy(ckpt, factory=factory, config=cfg)
    _await_state(dep, ("canary",), "deploy rollback")
    canary = [_slice_tenant(f"rb-canary{k}-", 0.0, 0.25) for k in range(4)]
    stable = [_slice_tenant(f"rb-stable{k}-", 0.5, 1.0) for k in range(4)]
    streams = [router.submit(prompts[i], n, tenant=t)
               for i, t in enumerate(stable + canary[:2])]
    time.sleep(1.0)
    streams += [router.submit(prompts[i], n, tenant=t)
                for i, t in zip((6, 7), canary[2:])]
    verdict = dep.wait(timeout=300)
    outs = [s.result(timeout=600) for s in streams]
    reqs = [s.request for s in streams]
    if verdict != "rolled_back" or "canary burn" not in dep.rollback_cause:
        raise AssertionError(f"deploy rollback: {verdict} "
                             f"({dep.rollback_cause})")
    if not all(r.state == "done" and len(r.tokens) == n for r in reqs):
        raise AssertionError("deploy rollback: a stream was dropped: "
                             f"{[(r.state, len(r.tokens)) for r in reqs]}")
    crossing = max(r.finished_at for r in reqs[4:6])
    t_rb = _event_t(dep, "transition", to="rolling_back")
    t_done = _event_t(dep, "transition", to="rolled_back")
    highs = [row for row in dep.events if row["action"] == "burn_high"]
    if len(highs) != 1 or t_rb - crossing > cfg.poll_interval_s + 0.5:
        raise AssertionError(f"deploy rollback: {len(highs)} high polls, "
                             f"{t_rb - crossing:.3f} s after the crossing")
    if (router._deploy_generation is not None or router._deploy_fraction
            or any(r.generation for r in router.replicas.values())):
        raise AssertionError("deploy rollback: the split or the new "
                             "generation survived")
    gens = [1 if (mt.serving.Router._serving_replica(r) or "").startswith(
        "deploy") else 0 for r in reqs]
    if any(gens[:4]):
        raise AssertionError("deploy rollback: a stable tenant was served "
                             "by the canary")
    parted = _gen_tokens(models, prompts, outs, want, gens,
                         "deploy rollback")
    return dict(staging_s=_staging_s(dep),
                teardown_after_crossing_s=round(t_rb - crossing, 3),
                drain_s=round(t_done - t_rb, 3), last_burn=dep.last_burn,
                served_by_generation=gens, parted=parted,
                redistributes=router.snapshot()["redistributes_total"])


def _deploy_shadow(router, ckpt, factory, prompts, want, models) -> dict:
    """(c) a shadow deploy of the seed-1 weights: two live stable
    requests sampled, replayed on the new generation off the serving
    path, the tokens differ, rollback; the split was never raised."""
    import ml_trainer_tpu_torch as mt

    n = DEPLOY["new_tokens"]
    cfg = mt.serving.DeployConfig(
        shadow=True, shadow_fraction=1.0, shadow_min_requests=2,
        poll_interval_s=DEPLOY["poll_s"], drain_timeout_s=60.0)
    dep = router.deploy(ckpt, factory=factory, config=cfg)
    _await_state(dep, ("shadowing",), "deploy shadow")
    tenants = [_slice_tenant(f"sh-live{k}-", 0.0, 1.0) for k in range(2)]
    streams = [router.submit(prompts[i], n, tenant=t)
               for i, t in zip((4, 5), tenants)]
    outs = [s.result(timeout=600) for s in streams]
    verdict = dep.wait(timeout=300)
    report = dep.shadow_report()
    if (verdict != "rolled_back" or "shadow diff" not in dep.rollback_cause
            or not report["n_token_mismatch"]):
        raise AssertionError(f"deploy shadow: {verdict} "
                             f"({dep.rollback_cause}), {report}")
    if (any(row["action"] == "stage" for row in dep.events)
            or router._deploy_fraction != 0.0):
        raise AssertionError("deploy shadow: the split was raised")
    parted = near_tie(models[0], [prompts[4], prompts[5]], outs,
                      [want[0][4], want[0][5]], _slack(None),
                      "deploy shadow live")
    return dict(staging_s=_staging_s(dep), parted=parted, **{
        k: report[k] for k in ("n_replayed", "n_compared",
                               "n_token_mismatch", "live_e2e_ms_p50",
                               "shadow_e2e_ms_p50")})


def _deploy_repair(router, factory, prompts, want, models) -> dict:
    """(d) ``rep1`` killed; the autoscaler's next ``tick()`` is
    ``scale_up`` (the repair rule: no hysteresis); the dead replica
    leaves; the fleet's tokens are seed 0's still."""
    import ml_trainer_tpu_torch as mt

    n = DEPLOY["new_tokens"]
    asc = mt.serving.Autoscaler(router, factory,
                                mt.serving.AutoscalerConfig(min_replicas=2))
    router.kill_replica("rep1")
    action = asc.tick()
    if action != "scale_up" or "auto1" not in router.replicas:
        raise AssertionError(f"deploy repair: tick {action}, "
                             f"{sorted(router.replicas)}")
    router.remove_replica("rep1", timeout=1.0)
    tenants = [_slice_tenant(f"rp{k}-", 0.0, 1.0) for k in range(4)]
    streams = [router.submit(prompts[i], n, tenant=t)
               for i, t in zip(range(4), tenants)]
    outs = [s.result(timeout=600) for s in streams]
    parted = near_tie(models[0], prompts[:4], outs, want[0][:4],
                      _slack(None), "deploy repair")
    return dict(action=action, actions=asc.summary()["counts"],
                replicas=sorted(router.replicas), parted=parted)


def _open_loop_report(router, report, canary: str, t0: float,
                      t1: float) -> dict:
    """(e)'s report: TTFT p50/p99, attainment and tokens/s by
    generation (the canary tenant is generation 1's)."""
    from ml_trainer_tpu_torch.serving import aggregate_timelines

    out = {k: report[k] for k in ("n_scheduled", "n_completed", "n_errors",
                                  "makespan_s", "offered_rps",
                                  "tokens_per_sec", "client_e2e_p50_ms",
                                  "client_e2e_p99_ms", "send_lag_p99_ms")}
    tls = [tl for tl in router.slo.timelines(since=t0)
           if tl["submitted_at"] < t1]
    for gen, pick in ((1, lambda t: t == canary), (0, lambda t: t != canary)):
        mine = [tl for tl in tls if pick(tl["tenant"])]
        agg = aggregate_timelines(mine, router.slo.policy)
        tokens = sum(r["tokens"] for r in report["per_request"]
                     if r["ok"] and pick(r["tenant"]))
        out[f"generation{gen}"] = dict(
            requests=agg["n_requests"], ttft_ms=agg["ttft_ms"],
            attainment=agg["attainment"],
            tokens_per_s=round(tokens / report["makespan_s"], 1))
    return out


class _Recorded:
    """``run_open_loop``'s in-process target: ``router.complete`` that
    keeps each request (by its prompt), so its serving replica can be
    read after the run."""

    def __init__(self, router):
        self.router = router
        self.requests = {}

    def complete(self, prompt, max_new_tokens, timeout=None, **kw):
        stream = self.router.submit(prompt, max_new_tokens, **kw)
        self.requests[id(prompt)] = stream.request
        return stream.result(timeout=timeout)


def _deploy_promote(router, ckpt, factory, prompts, want, models, sched,
                    scale, canary, manifest) -> dict:
    """(a) with (e): the seed-1 deploy (canary 0.25, stages 0.5 and 1.0);
    during its canary stage ``run_open_loop`` drives the schedule (the
    tenant ``canary`` inside the canary slice, one above 0.5); the canary
    stage holds until the canary tenant's requests have all reported and
    each later stage DEPLOY["hold_s"], so every arrival lands before the
    split reaches 1.0.  Gates: the canary tenant served by generation 1
    with seed 1's tokens, the other by generation 0 with seed 0's;
    ``done``; the old generation retired; ``weights_fp`` the manifest's;
    every tenant then on seed 1's tokens."""
    import numpy as np

    import ml_trainer_tpu_torch as mt

    c, n = DEPLOY, DEPLOY["new_tokens"]
    cfg = mt.serving.DeployConfig(
        canary=0.25, stages=(0.5, 1.0), hold_s=c["hold_s"],
        stage_min_requests=sum(s.tenant == canary for s in sched),
        min_window_requests=c["min_window"], burn_threshold=2.0,
        high_polls=2, poll_interval_s=c["poll_s"], drain_timeout_s=60.0)
    dep = router.deploy(ckpt, factory=factory, config=cfg)
    _await_state(dep, ("canary",), "deploy promote")
    target = _Recorded(router)
    t0 = time.monotonic()
    report = mt.serving.run_open_loop(sched, server=target, timeout=600,
                                      time_scale=scale, collect_tokens=True)
    t1 = time.monotonic()
    if report["n_completed"] != len(sched):
        raise AssertionError(f"deploy open loop: {report['errors']}")
    verdict = dep.wait(timeout=300)
    if verdict != "done":
        raise AssertionError(f"deploy promote: {verdict} "
                             f"({dep.rollback_cause})")
    reqs = [target.requests[id(s.prompt)] for s in sched]
    gens = [1 if (mt.serving.Router._serving_replica(r) or "").startswith(
        "deploy") else 0 for r in reqs]
    if gens != [int(s.tenant == canary) for s in sched]:
        raise AssertionError(f"deploy open loop: generations {gens}")
    parted_open = _gen_tokens(
        models, [s.prompt for s in sched],
        [np.asarray(r["output"]) for r in report["per_request"]],
        want["open"], gens, "deploy open loop")
    if (set(router.replicas) != set(dep.new_replicas)
            or router._serving_generation != 1
            or dep.weights_fp != manifest["weights_fingerprint"]):
        raise AssertionError(f"deploy promote: replicas "
                             f"{sorted(router.replicas)}, fingerprint "
                             f"{dep.weights_fp} vs {manifest}")
    tenants = [_slice_tenant(f"post{k}-", k / len(prompts),
                             (k + 1) / len(prompts))
               for k in range(len(prompts))]
    streams = [router.submit(p, n, tenant=t)
               for p, t in zip(prompts, tenants)]
    outs = [s.result(timeout=600) for s in streams]
    parted = near_tie(models[1], prompts, outs, want[1], _slack(None),
                      "deploy promoted")
    stages = [(row["fraction"], round(row["t"] - dep._started_at, 3))
              for row in dep.events if row["action"] == "stage"]
    return dict(staging_s=_staging_s(dep), parted_open=parted_open,
                parted_promoted=parted, stages_s=stages,
                promoted_s=round(_event_t(dep, "promoted")
                                 - dep._started_at, 3),
                open_loop=_open_loop_report(router, report, canary, t0, t1),
                weights_fp=dep.weights_fp)


def _deploy_inprocess(dev, models, dirs, prompts, want, sched, scale,
                      canary, manifest, checks) -> dict:
    """The stable fleet ``Router.build(["both", "both"])`` over the
    seed-0 model; an uncounted warm-up (its eager K1 and K6 calls held to
    float64); then (b), (c), (d) and (a) with (e), counted together: K1
    12 a full prefill of 128 tokens or more, K6 12 a decode step, on
    every engine the runs made, exactly; one capture a decoding engine.
    The seed-1 factory loads ``dirs[1]`` (one model for its replicas)."""
    import ml_trainer_tpu_torch as mt

    c = DEPLOY
    servers, loaded = [], {}

    def factory(seed, wedge=False):
        def make(role):
            if seed == SEED:
                model = models[0]
            else:
                if "m1" not in loaded:
                    fresh = mt.get_model(c["model"], device=dev,
                                         max_len=models[0].max_len)
                    loaded["m1"] = mt.load_model(fresh, dirs[1]).module
                    loaded["m1"].eval()
                model = loaded["m1"]
            server = mt.Server(model, max_batch=c["max_batch"],
                               kv_page_size=c["page"], paged_kernel=True,
                               role=role, device=dev)
            if wedge:
                inner = server.submit_request

                def wedged(req, _inner=inner):
                    if req.tenant != "default":  # not the staging warm-up
                        time.sleep(c["wedge_s"])
                    _inner(req)

                server.submit_request = wedged
            servers.append(server)
            return server

        return make

    policy = mt.serving.SloPolicy(ttft_ms=c["ttft_ms"], tpot_ms=1000.0,
                                  target=0.9)
    with mt.Router.build(models[0], roles=["both", "both"],
                         max_batch=c["max_batch"], kv_page_size=c["page"],
                         paged_kernel=True, device=dev,
                         router_kwargs=dict(hedging=False, slo=policy,
                                            health_interval=0.1)) as router:
        servers += [r.server for r in router.replicas.values()]
        with checked_calls(checks):
            warm = [router.submit(p[:c["lens"][0]], 8, tenant="warm")
                    for p in (prompts[1], prompts[-1])]
            for s in warm:
                s.result(timeout=600)
        before = {id(s): s.metrics.snapshot()["decode_steps_total"]
                  for s in servers}
        times = {}
        with _k1_prefills() as k1:
            mt.reset_launch_counts()
            t = time.perf_counter()
            rec = dict(rollback=_deploy_rollback(
                router, dirs[1], factory(SEED + 1, wedge=True), prompts,
                want, models))
            times["rollback"] = time.perf_counter() - t
            rec["shadow"] = _deploy_shadow(router, dirs[1],
                                           factory(SEED + 1), prompts, want,
                                           models)
            times["shadow"] = time.perf_counter() - t - sum(times.values())
            rec["repair"] = _deploy_repair(router, factory(SEED), prompts,
                                           want, models)
            times["repair"] = time.perf_counter() - t - sum(times.values())
            rec["promote"] = _deploy_promote(
                router, dirs[1], factory(SEED + 1), prompts, want, models,
                sched, scale, canary, manifest)
            times["promote"] = time.perf_counter() - t - sum(times.values())
            counts = mt.launch_counts()
        steps = {id(s): s.metrics.snapshot()["decode_steps_total"]
                 - before.get(id(s), 0) for s in servers}
        depth = models[0].depth
        want_counts = dict(dict.fromkeys(counts, 0),
                           flash_fwd=depth * k1[0],
                           paged_attention=depth * sum(steps.values()))
        if counts != want_counts:
            raise AssertionError(f"deploy: launches {counts}, expected "
                                 f"{want_counts}")
        captures = [s.engine.graph_captures for s in servers]
        decoded = [s.metrics.snapshot()["decode_steps_total"] > 1
                   for s in servers]
        if captures != [int(d) for d in decoded]:
            raise AssertionError(f"deploy: decode graph captures {captures} "
                                 f"(decoded {decoded})")
        rec.update(launches=counts, full_prefills_k1=k1[0],
                   decode_steps=sum(steps.values()), engines=len(servers),
                   graph_captures=captures,
                   seconds={k: round(v, 1) for k, v in times.items()},
                   alerts=[e for e in router.alerts.history()
                           if e["rule"].startswith("deploy_")])
    return rec


def _deploy_fleet(dev, model1, fleet, launched, dirs, prompts, want,
                  manifest) -> dict:
    """(f) the one-worker fleet (started at the phase's start from the
    seed-0 ``--ckpt``) behind ``make_router()``, deployed onto the seed-1
    checkpoint through ``Fleet.deploy_factory`` (stages (1.0,)): the new
    worker serves DEPLOY["fleet_requests"] prompts with seed 1's tokens,
    counted through its ``/v1/spec``: K1 12 a prefix miss, K6 12 a
    decode step, one capture; its fingerprint the manifest's."""
    import ml_trainer_tpu_torch as mt

    c, n = DEPLOY, DEPLOY["new_tokens"]
    router = None
    try:
        for launch in launched:
            fleet.wait_ready(*launch)
        router = fleet.make_router(hedging=False, health_interval=0.1)
        t0 = time.perf_counter()
        dep = router.deploy(f"{dirs[1]}/model.pth", canary=0.25,
                            config=mt.serving.DeployConfig(
                                stages=(1.0,), hold_s=0.0,
                                min_window_requests=10 ** 4,
                                poll_interval_s=c["poll_s"],
                                drain_timeout_s=60.0))
        verdict = dep.wait(timeout=600)
        deploy_s = time.perf_counter() - t0
        if verdict != "done" or len(router.replicas) != 1:
            raise AssertionError(f"deploy fleet: {verdict} "
                                 f"({dep.rollback_cause}), "
                                 f"{sorted(router.replicas)}")
        (remote,) = [r.server for r in router.replicas.values()]
        if (remote.engine.weights_fp != manifest["weights_fingerprint"]
                or dep.weights_fp != manifest["weights_fingerprint"]):
            raise AssertionError("deploy fleet: the new worker serves "
                                 "other weights")

        def state():
            m = remote._get("/metrics.json")
            return dict(spec=remote.spec(), misses=m["prefix_misses"],
                        steps=m["decode_steps_total"])

        k = c["fleet_requests"]
        before = state()
        t1 = time.perf_counter()
        streams = [router.submit(p, n, tenant=f"fleet{i}")
                   for i, p in enumerate(prompts[:k])]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t1
        after = state()
        got = {kn: after["spec"]["launches"][kn]
               - before["spec"]["launches"][kn]
               for kn in after["spec"]["launches"]}
        want_counts = dict(
            dict.fromkeys(got, 0),
            flash_fwd=model1.depth * (after["misses"] - before["misses"]),
            paged_attention=model1.depth * (after["steps"]
                                            - before["steps"]))
        if got != want_counts or after["spec"]["graph_captures"] != 1:
            raise AssertionError(f"deploy fleet: launches {got}, expected "
                                 f"{want_counts}, captures "
                                 f"{after['spec']['graph_captures']}")
        parted = near_tie(model1, prompts[:k], outs, want[1][:k],
                          _slack(None), "deploy fleet")
        rec = dict(deploy_s=round(deploy_s, 1), staging_s=_staging_s(dep),
                   launches=got, tokens_per_s=k * n / wall, parted=parted,
                   worker_pid=remote.pid)
    finally:
        if router is not None:
            router.close()
        fleet.stop()
        _stop_launched(launched)
    return rec


def deploy_phase(dev, smi: str) -> dict:
    """The ``deploy`` phase: the two seeded models written by
    ``Trainer.save_model``, one ``Server`` on each for the reference
    tokens, the in-process runs (``_deploy_inprocess``: a wedged canary
    rolled back, a shadow rolled back, the autoscaler's repair, a canary
    promoted under open-loop traffic), then the fleet's deploy.  Gates
    as each run's docstring says, and the card's allocated memory back
    within 1% after the routers closed.  Returns the counted launches."""
    import numpy as np
    import torch

    import ml_trainer_tpu_torch as mt
    from ml_trainer_tpu_torch.checkpoint import load_model_manifest

    c, n = DEPLOY, DEPLOY["new_tokens"]
    t0 = time.perf_counter()
    models = [_seeded_model(c["model"], seed=s, device=dev).eval()
              for s in (SEED, SEED + 1)]
    dirs = [f"{DEPLOY_DIR}/seed{s}" for s in (SEED, SEED + 1)]
    manifests = []
    for model, d in zip(models, dirs):
        mt.Trainer(model, device=dev).save_model(d)
        manifests.append(load_model_manifest(d))
        if manifests[-1]["weights_fingerprint"] != \
                mt.serving.engine.weights_fp(model):
            raise AssertionError(f"deploy: {d}'s manifest is not the "
                                 "engine's fingerprint")
    fleet = mt.serving.Fleet(
        ["both"], model_name=c["model"], max_len=models[0].max_len,
        max_batch=c["max_batch"], kv_page_size=c["page"], paged_kernel=True,
        ckpt=f"{dirs[0]}/model.pth", log_dir=f"{DEPLOY_DIR}/logs")
    name = fleet._next_name("both")
    launched = [(name, *fleet.launch(name, "both"))]
    t1 = time.perf_counter()
    try:
        rng = np.random.default_rng(SEED + 50)
        vocab = models[0].vocab_size
        lo, hi = c["lens"]
        prompts = [rng.integers(0, vocab, int(m)).astype(np.int32)
                   for m in rng.choice(np.arange(lo, hi + 1), c["prompts"],
                                       replace=False)]
        canary = _slice_tenant("open-canary", 0.0, 0.25)
        stable = _slice_tenant("open-stable", 0.5, 1.0)
        load = mt.serving.TenantLoad(prompt_len=c["lens"],
                                     output_len=(n, n))
        sched = mt.serving.poisson_schedule(
            c["open_rate"], c["open_requests"], vocab,
            tenants={canary: load, stable: load}, seed=SEED + 60)
        scale = min(1.0, c["open_span_s"] / sched[-1].arrival_s)
        want = {}
        for g, model in enumerate(models):
            with mt.Server(model, max_batch=c["max_batch"],
                           kv_page_size=c["page"], paged_kernel=True,
                           device=dev) as server:
                streams = [server.submit(p, n)
                           for p in prompts + [s.prompt for s in sched]]
                outs = [s.result(timeout=600) for s in streams]
            want[g] = outs[:len(prompts)]
            want.setdefault("open", {})[g] = outs[len(prompts):]
        del server, streams
        mem0 = _allocated_without_workspaces(dev)
        t2 = time.perf_counter()
        checks: dict = {}
        rec = _deploy_inprocess(dev, models, dirs, prompts, want, sched,
                                scale, canary, manifests[1], checks)
        t3 = time.perf_counter()
    except BaseException:
        _stop_launched(launched)
        raise
    rec["fleet"] = _deploy_fleet(dev, models[1], fleet, launched, dirs,
                                 prompts, want, manifests[1])
    t4 = time.perf_counter()
    for kname in ("flash_fwd", "paged_attention"):
        if not checks.get(kname, {}).get("calls"):
            raise AssertionError(f"the per-call check saw no {kname} call")
    mem1 = _allocated_without_workspaces(dev)
    rb, pr = rec["rollback"], rec["promote"]
    log(f"deploy rollback on {smi}: " + json.dumps(rb))
    log(f"deploy shadow on {smi}: " + json.dumps(rec["shadow"]))
    log(f"deploy repair on {smi}: " + json.dumps(rec["repair"]))
    log(f"deploy promote on {smi}: " + json.dumps(
        {k: v for k, v in pr.items() if k != "open_loop"}))
    log(f"deploy open loop during the canary on {smi}: "
        + json.dumps(pr["open_loop"]))
    log(f"deploy fleet on {smi}: " + json.dumps(rec["fleet"]))
    log(f"deploy per-call checks on {smi}: " + json.dumps(checks))
    log(f"deploy on {smi}: staging s (spawn, warm-up, capture) rollback "
        f"{rb['staging_s']['staged']}, shadow "
        f"{rec['shadow']['staging_s']['staged']}, promote "
        f"{pr['staging_s']['staged']}, fleet "
        f"{rec['fleet']['staging_s']['staged']}; burn crossing to "
        f"teardown {rb['teardown_after_crossing_s']} s; rollback drain "
        f"{rb['drain_s']} s; launches {json.dumps(rec['launches'])} "
        f"({rec['full_prefills_k1']} K1 prefills, {rec['decode_steps']} "
        f"decode steps, {rec['engines']} engines, captures "
        f"{rec['graph_captures']}); memory {mem0} -> {mem1}")
    log(f"deploy seconds: checkpoints {t1 - t0:.1f}, references "
        f"{t2 - t1:.1f}, in process {t3 - t2:.1f} "
        f"({json.dumps(rec['seconds'])}), fleet {t4 - t3:.1f}, phase "
        f"{t4 - t0:.1f}")
    if abs(mem1 - mem0) > 0.01 * mem0:
        raise AssertionError(f"deploy: memory {mem0} -> {mem1}; the "
                             f"largest live tensors: {_live_cuda()}")
    launches = dict(rec["launches"])
    for kname, count in rec["fleet"]["launches"].items():
        launches[kname] = launches.get(kname, 0) + count
    log(f"deploy launches on {smi}: " + json.dumps(launches))
    del models
    torch.cuda.empty_cache()
    _discard(DEPLOY_DIR)
    return dict(launches=launches)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only",
                        choices=["kernels", "serve", "train", "dp", "models",
                                 "graphs", "resume", "data", "llama", "cli",
                                 "lora", "examples", "dist", "decode",
                                 "front", "router", "deploy"],
                        default=None)
    # The dist phase's own processes (started by the phase, not by hand).
    parser.add_argument("--dist-worker", choices=["nccl1", "gloo2"],
                        default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    if args.dist_worker:
        return _dist_worker(args)
    from ml_trainer_tpu_torch.device import resolve_device
    from ml_trainer_tpu_torch.ops.kernels import _build

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    os.makedirs("build", exist_ok=True)
    disk = shutil.disk_usage("build")
    log(f"build: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} "
        "(checkpoints of a GPT-2 124M run take ~1.5 GB each)")

    t0 = time.perf_counter()
    build = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f}s")
    # The imports' objects live to the end: keep every collection (the
    # Trainer's clear(), once an epoch) from walking them again.
    gc.freeze()
    for kname, rec in build.items():
        log(f"build {kname}: {rec['seconds']:.2f}s cached={rec['cached']}")
        for line in rec["ptxas"]:
            log(f"  {line}")

    flash_rows = check_flash(dev)
    paged_rows = check_paged(dev)
    paged_bf16_rows = check_paged_bf16(dev)
    bwd_rows, padded_err = check_flash_bwd(dev)
    bf16_rows = check_flash_bf16(dev)
    int8_rows = check_int8(dev)
    int8_bf16_rows = check_int8_bf16(dev)
    check_tickets(dev)
    fused_rows = check_fused_adam(dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f}s (with the build)")
    mark = time.perf_counter()

    def lap(name: str, since: float) -> float:
        now = time.perf_counter()
        if args.only in (None, name):
            log(f"phase {name} on {smi}: {now - since:.1f}s")
        return now

    launches = {"flash_fwd": None, "paged_attention": None,
                "flash_bwd_dq": None, "flash_bwd_dkv": None,
                "int8_matmul": None, "unscale_sqsum": None,
                "fused_adam": None}
    if args.only in (None, "serve"):
        serving = serve(dev)
        for run in ("fp32", "int8", "bf16", "bf16_int8"):
            for rec in (serving[run], serving[run]["eager"]):
                for kname, count in rec["launches"].items():
                    launches[kname] = (launches[kname] or 0) + count
            log(f"serving {run} on {smi}: " + json.dumps(serving[run]))
            log(f"serving {run} eager vs graph on {smi}: "
                + json.dumps(graph_summary(serving[run])))
        log(f"int8 quality gate on {smi}: " + json.dumps(quality_gate(dev)))
    step_split = {kname: {} for kname in ATTN_MARKS}  # K1-K3 per step
    mark = lap("serve", mark)
    if args.only in (None, "decode"):
        rec = decode_phase(dev, smi)
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("decode", mark)
    if args.only in (None, "front"):
        rec = front_phase(dev, smi)
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("front", mark)
    if args.only in (None, "router"):
        rec = router_phase(dev, smi)
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("router", mark)
    if args.only in (None, "deploy"):
        rec = deploy_phase(dev, smi)
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("deploy", mark)
    if args.only in (None, "train"):
        training = train(dev)
        log(f"training on {smi}: " + json.dumps(training))
        training_bf16 = train(
            dev, "bf16", fp32_first_loss=training["grad_check"]["loss_kernel"])
        log(f"training bf16 on {smi}: " + json.dumps(training_bf16))
        for run, pre in ((training, ""), (training_bf16, "bf16_")):
            prof = run["profile"]
            for kname in ATTN_MARKS:
                launches[kname] = ((launches[kname] or 0)
                                   + run["launches"][kname])
                step_split[kname].update({
                    f"{pre}train_step_device_ms": prof["device_ms"][kname],
                    f"{pre}step_bound_ms": prof["bound_ms"][kname]})
    dp_split = None
    mark = lap("train", mark)
    if args.only in (None, "dp"):
        dp = dp_train(dev)
        log(f"data-parallel training on {smi}: " + json.dumps(dp))
        dp_bf16 = dp_train(dev, "bf16", steps=DP_BF16_STEPS)
        log(f"data-parallel training bf16 on {smi}: " + json.dumps(dp_bf16))
        dp_split = {}
        for run, pre in ((dp, ""), (dp_bf16, "bf16_")):
            prof = run["profile"]
            for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "unscale_sqsum", "fused_adam"):
                launches[kname] = ((launches[kname] or 0)
                                   + run["launches"][kname])
            for k in ("unscale_sqsum", "fused_adam"):
                dp_split.setdefault(k, {}).update({
                    f"{pre}step_device_ms": prof["device_ms"][k],
                    f"{pre}step_bound_ms": prof["bound_ms"][k]})
            for kname in ATTN_MARKS:
                step_split[kname].update({
                    f"{pre}dp_step_device_ms": prof["device_ms"][kname],
                    f"{pre}step_bound_ms": prof["bound_ms"][kname]})
    mark = lap("dp", mark)
    if args.only in (None, "models"):
        for run in models(dev):
            log(f"model {run['model']} ({run['precision']}) on {smi}: "
                + json.dumps(run))
            if run["model"] == "bert_base":
                prof = run["profile"]
                pre = "" if run["precision"] == "float32" else "bf16_"
                for kname in ATTN_MARKS:
                    launches[kname] = ((launches[kname] or 0)
                                       + run["launches"][kname])
                    step_split[kname].update({
                        f"{pre}bert_step_device_ms": prof["device_ms"][kname],
                        f"{pre}bert_step_bound_ms": prof["bound_ms"][kname]})
    mark = lap("models", mark)
    if args.only in (None, "graphs"):
        for run in graphs(dev):
            log(f"graphs {run['label']} on {smi}: " + json.dumps(run))
            for kname in ATTN_MARKS:
                launches[kname] = ((launches[kname] or 0)
                                   + run["launches_total"][kname])
    mark = lap("graphs", mark)
    if args.only in (None, "resume"):
        for label, run in (("pretrain", resume_pretrain),
                           ("dp", resume_dp), ("resnet", resume_resnet)):
            rec = run(dev)
            log(f"resume {label} on {smi}: " + json.dumps(rec))
            for key in ("A", "B", "C"):
                for kname, n in rec.get(key, {}).get("launches",
                                                     {}).items():
                    launches[kname] = (launches[kname] or 0) + n
    mark = lap("resume", mark)
    if args.only in (None, "data"):
        rec = data(dev)
        for label in ("native", "resnet50", "gpt2", "bert"):
            log(f"data {label} on {smi}: " + json.dumps(rec[label]))
        fits = ([r["launches"] for r in rec["resnet50"]["runs"]]
                + [r["launches"] for key, r in rec["gpt2"]["runs"].items()
                   if "launches" in r] + [rec["bert"]["launches"]])
        for counts in fits:
            for kname, n in counts.items():
                launches[kname] = (launches[kname] or 0) + n
    mark = lap("data", mark)
    if args.only in (None, "llama"):
        rec = llama(dev)
        runs = ([(f"train {r['label']}", r, r["launches_total"])
                 for r in rec["train"]]
                + [("dp bf16", rec["dp"], rec["dp"]["launches"])]
                + [(f"generate {r['precision']}", r, r["launches"])
                   for r in rec["generate"]]
                + [(f"gpt2 size {r['model']}", r, r["launches"])
                   for r in rec["gpt2_sizes"]])
        for label, run, counts in runs:
            log(f"llama {label} on {smi}: " + json.dumps(run))
            for kname, n in counts.items():
                launches[kname] = (launches[kname] or 0) + n
    mark = lap("llama", mark)
    if args.only in (None, "cli"):
        import torch

        torch.cuda.empty_cache()  # room for the CLI's processes
        rec = cli_phase(dev, smi)
        for label in ("cli", "steps", "gpt2_large", "llama", "fits", "dp"):
            for kname, n in rec[label]["launches"].items():
                launches[kname] = (launches[kname] or 0) + n
    mark = lap("cli", mark)
    if args.only in (None, "lora"):
        rec = lora_phase(dev)
        for key in ("train_fp32", "train_bf16_k1", "train_bf16_k4",
                    "step_costs", "opt_state_bytes", "serve_fp32",
                    "serve_bf16", "export_torch", "launches"):
            log(f"lora {key} on {smi}: " + json.dumps(rec[key]))
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("lora", mark)
    if args.only in (None, "examples"):
        rec = examples_phase(dev, smi)
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    mark = lap("examples", mark)
    if args.only in (None, "dist"):
        rec = dist_phase(dev, smi)
        for key in ("nccl_world1", "one_process_gpt2", "one_process_resnet50",
                    "stitched_into_one", "resnet50_vs_one_process", "jpeg"):
            log(f"dist {key} on {smi}: " + json.dumps(rec[key]))
        for rank, ranks_rec in enumerate(rec["gloo_ranks"]):
            log(f"dist gloo rank {rank} on {smi}: " + json.dumps(ranks_rec))
        for kname, n in rec["launches"].items():
            launches[kname] = (launches[kname] or 0) + n
    lap("dist", mark)
    main_flash = flash_rows[0]  # [2, 12, 1024, 64]: a training microbatch
    # The BERT launch shape's rows of K1-K3, beside each kernel's main row.
    bert_keys = ("ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                 "library_device_ms", "max_abs_err", "bitwise_repeat")
    bert_rows = {"flash_fwd": next(r for r in flash_rows
                                   if r["case"] == "bert")}
    for kname, row in bwd_rows:
        if row["case"] == "bert":
            bert_rows[kname] = row
    bert_rows = {k: {key: r.get(key) for key in bert_keys}
                 for k, r in bert_rows.items()}
    # Llama's training launch, [4, 12, 2048, 64] causal, likewise.
    llama_rows = {"flash_fwd": next(r for r in flash_rows
                                    if r["case"] == "llama_2048")}
    for kname, row in bwd_rows:
        if row["case"] == "llama_2048":
            llama_rows[kname] = row
    llama_rows = {k: {key: r.get(key) for key in bert_keys + ("plain_ms",)}
                  for k, r in llama_rows.items()}
    # K1-K3's bf16 rows, beside each kernel's entry.
    bf16_keys = ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms",
                 "library_ms", "library_device_ms", "max_abs_err",
                 "gate_ratio", "ulps_from_f32_kernel")
    bf16 = {}
    for kname, row in (bf16_rows + [("paged_attention", r)
                                    for r in paged_bf16_rows]
                       + [("int8_matmul", r) for r in int8_bf16_rows]):
        bf16.setdefault(kname, {})[row["case"]] = (
            {key: row.get(key) for key in bf16_keys} if "ms" in row
            else row)  # the planted row: its values and distances
    bwd = {}
    for kname, row in bwd_rows:  # the main row is each kernel's first
        bwd.setdefault(kname, dict(row, max_abs_err=max(
            [padded_err] + [r["max_abs_err"] for n, r in bwd_rows
                            if n == kname])))
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ml_trainer_tpu/ops/attention.py:177",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         **{k: main_flash[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "bound_fp32_core_ms", "device_ms", "library_device_ms")},
         **step_split["flash_fwd"], "bert_row": bert_rows["flash_fwd"],
         "llama_row": llama_rows["flash_fwd"],
         "bf16_rows": bf16["flash_fwd"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/paged_attention.cu",
         "replaces": "ml_trainer_tpu/ops/kernels/paged_attention.py:152",
         "launches": launches["paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
         **{k: paged_rows[0][k] for k in ("ms", "ms_eager", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         "bf16_rows": bf16["paged_attention"]},
    ] + [
        {"name": kname, "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/flash_bwd.cu",
         "replaces": f"ml_trainer_tpu/ops/attention.py:{line}",
         "launches": launches[kname],
         **{k: bwd[kname][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "bound_fp32_core_ms", "device_ms",
             "library_device_ms")},
         **step_split[kname], "bert_row": bert_rows[kname],
         "llama_row": llama_rows[kname], "bf16_rows": bf16[kname]}
        for kname, line in (("flash_bwd_dq", 385), ("flash_bwd_dkv", 403))
    ] + [
        {"name": "int8_matmul", "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "ml_trainer_tpu/ops/kernels/int8_matmul.py:78",
         "launches": launches["int8_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
         **{k: int8_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
         "bf16_rows": bf16["int8_matmul"]},
    ] + [
        {"name": kname, "route": "cuda",
         "source": "ml_trainer_tpu_torch/csrc/fused_adam.cu",
         "replaces": f"ml_trainer_tpu/ops/kernels/fused_adam.py:{line}",
         "launches": launches[kname],
         "max_abs_err": max(r["max_abs_err"] for r in fused_rows[kname]),
         **{k: fused_rows[kname][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         **(dp_split[kname] if dp_split else {})}
        for kname, line in (("unscale_sqsum", 132), ("fused_adam", 241))
    ]
    _discards_done()
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - any failed phase fails the smoke
        traceback.print_exc()
        code = 1
    sys.exit(code)
