#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving, training and decoding paths on one CUDA
card and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):
  1. device  - require CUDA; print the card's name and power limit and the
               torch / CUDA versions;
  2. build   - build the hand-written kernels from ops/csrc with nvcc, one
               nvcc per source, all started together, and print ptxas's
               registers and spills for each kernel;
  3. kernels - hold each kernel against its plain PyTorch version on the
               card (paged attention at the serving shapes; the three flash
               kernels at the training shape in float32 and bfloat16
               (bfloat16 backward: the tensor-core pair, also against its
               arithmetic in float64), a rectangular non-causal and a
               ragged causal case at D=16, a ragged non-causal one with
               Tq < Tk at D=128 and a causal one at D=32; the LSTM
               forward and reverse kernels at text_lstm's full width, with
               peepholes, and through dynamic_lstm(is_reverse=True) on
               lengths {1, T, 0}, all on the persistent route, and at
               B=256 on the step route, and at SRL's T=32, B=64, H=128 with
               peepholes, forward and reverse direction, on lengths 1..T,
               persistent, each case's route checked by the route counts),
               and time kernel, plain version and the
               library yardstick (scaled_dot_product_attention, cuDNN's
               LSTM; the port never calls either), each as the event-timed
               call (host cost included) and as device time (the kernels
               the calls enqueue, read by torch.profiler; the phase fails
               if the profiler shows none); first, the paged kernel's
               device time at the float32 W=1 shape, read again at the end
               of the script (ROADMAP C.2: a record, not a check);
  4. dropout kernels - the threefry dropout kernels (forward, backward)
               against their plain version on the card, bitwise (the mask,
               y and dx), at the LM's [8, 1024, 512] and a ragged
               [1000, 37], float32 and bfloat16, p 0.1 and 0.5, step words
               0, 1, 2^31 + 5 and 2^32 - 1 (immediate and staged), tags 1
               and 13, the kept fraction within 6 sigma of 1 - p; ptxas's
               registers and spills; both timed at [8, 1024, 512] beside
               the plain version and F.dropout (another mask: a yardstick);
  5. serve   - the Transformer-base LM (V=32000, d=512, 8 heads, 6 layers,
               d_ff=2048, tied embeddings, float32, random weights from
               seed 0) served by ContinuousScheduler over a paged pool
               (max_len 1024, block 16, 8 slots): ContinuousDecodeEngine.warm
               captures one CUDA graph per signature (12: prefill at 8
               prompt buckets, the W=1 and W=4 steps greedy and with a
               policy), then 16 mixed greedy/sampled requests, then a
               speculative (W=4) pass on repetitive prompts.  Checks
               completion, zero leaked blocks, every prefill and step
               dispatch a graph replay, kernel launches (counted at replay)
               == n_layers x step dispatches, teacher-forced agreement >=
               0.98 against the dense lm_forward oracle, sampled-stream
               determinism, a replay bitwise equal to the step's body run
               eagerly on the same buffers (W=1 and W=4, greedy and policy,
               logits, tokens and arenas), and no signature prepared after
               warm;
  5b. serve extras - the same LM and engine configuration with the prefix
               cache (prefix_cache=True, warm() first), four passes, each
               with its counts set to 0 before and read after (paged
               launches = n_layers x step dispatches, graph replays =
               dispatches, tokens/s, mean step ms, TTFT p50 / p99, the
               counters, the card): prefix (16 greedy requests sharing a
               384-token system prompt, then the same 16 on the serve
               phase's engine without a cache: blocks mapped, tokens
               saved, teacher-forced agreement >= 0.98 on both, hit
               streams against cold at the greedy floor 0.98, each
               request's digests against a blake2b recomputation here,
               the block partition clean, a divergent continuation leaving
               the shared blocks' K/V bytes bitwise unchanged); fork (a
               K=4 beam on a 64-token prompt, 32 tokens, joining beside 4
               greedy streams: forks and copy-on-write blocks > 0, the
               batch-mates bitwise equal to the same requests served
               alone, the beams against the port's own
               models.transformer.generate in float32 on the card under
               the near-tie rule, scores within 1e-4 relative; the beam
               alone's wall time with no profiler, and its device time
               from a second, profiled run; a parallel-n request, n=4,
               served twice identically with distinct branches; the
               serving.fork fault: private copies, no copy-on-write block,
               the same beams under the same rule); migration (8 streams
               drained after 10 steps, every waiter GenerationMigrated,
               the records resumed on a second scheduler at the greedy
               floor against the uninterrupted run, migrated_out =
               resumed_in = 8, no leaked block either side); dense
               (DecodeEngine warmed, 8 x 64 prompts, 64 generated, at the
               floor against the continuous engine, a step replay bitwise
               against its body run eagerly, tokens/s, the dense caches'
               bytes beside the pool's, then DecodeEngine.measure: prefill,
               KV-cached and naive full-recompute tokens/s); and no
               signature prepared after warm();
  6. train   - the same LM built by build_lm through Program / Executor with
               Adam(1e-3) and global-norm clipping (1.0), weights from
               init_lm_params(0), every step a replay of its signature's
               CUDA graph (Executor.warm): the 2 x 1024 parity signature
               warmed ("compiled", then "cached"), one replay against the
               same step run eagerly by an Executor that did not warm, from
               the same weights (the loss, every gradient, parameter,
               moment and optimizer step and the step counter bitwise
               equal), and against the CPU (plain versions), loss and every
               gradient compared; then the 8 x 1024 signature warmed and 5
               replays on a fixed batch with the flash launch counts set to
               0 before and read after (counted at replay: each must be
               n_layers x steps), replays = steps, compiles unmoved, losses
               finite and falling, warm seconds, ms per step, tokens/s,
               peak memory (allocated, and reserved with the graph pool);
  7. lm amp train - the same program and weights under amp with attention
               in bfloat16 (build_train_program(amp=True): the default
               bf16 list plus the attention op, so the bf16 flash kernels
               run), warmed as in phase 6: the replay bitwise against the
               eager step, then held against the CPU's amp step: loss and
               every gradient held to 3 x the CPU's own spread
               (its amp step's distance from the train phase's float32
               CPU step, same weights and tokens; never tighter than the
               float32 limit 1e-3); then 5 replays on the 8 x 1024 batch
               with the flash counts set to 0 before and read after (each
               n_layers x steps, and every launch bfloat16), replays =
               steps, compiles unmoved, losses finite and falling, ms per
               step, tokens/s, peak memory;
  8. lm dropout train - the LM with dropout 0.1 and Transformer-base's
               optimizer (Adam(0.9, 0.98, 1e-9) on noam_decay(512, 4000),
               clip 1.0, resumed at the optimizer step 4000), step counter
               2^31 - 1: the float32 + remat step warmed at 2 x 1024, its
               replay bitwise against the eager step (and grouped against
               per-op updates), replays of the same state at s + 1 (its
               loss differs: the graph reads the live counter) and at s
               (bitwise the first), the card against the CPU (loss rtol
               1e-4, gradients 1e-3 of max |g|), remat against no remat
               (loss bitwise, gradients 1e-5 of max |g|); then the arms
               float32, float32 + remat and amp + remat: an eager step's
               own peak memory, then warmed at 8 x 1024 and 5 replays with
               the flash and dropout counts set to 0 before and read after
               (a step: dropout 13 forward, 19 with remat, and 13
               backward; flash 6, 12 with remat, forward and 6 + 6
               backward; under amp all bf16), losses finite, ms per step,
               tokens/s, peak memory;
  9. optimizers - each of the eight new optimizers (noam_decay, L2Decay)
               on a 2-layer LM at d = 128: two eager steps with grouped
               updates and two with the per-op rule, every parameter and
               accumulator bitwise equal;
 10. lstm train - the text classifier (vocab 10000, emb 128, 2 x LSTM-512,
               2 classes, seq_len 100, float32, weights from seed 0) through
               Program / Executor with Adam(1e-3): one step on 16 sequences
               on the card and on the CPU from the same weights, loss and
               every gradient compared; then 5 steps on a fixed batch of 128
               with the LSTM launch counts set to 0 before and read after
               (2 layers x 5 steps each, every call on the persistent
               route), losses finite and falling, ms per step and
               sequences/s; then the same 128-sequence signature warmed
               (Executor.warm: one CUDA graph, the persistent kernels'
               cooperative launches captured), a replay bitwise against
               the eager step (and grouped against per-op updates), 5
               replays with the LSTM counts set to 0 before and read after
               (counted at replay: 2 x 5 each, all persistent), the warmed
               ms per step beside the eager one;
 10a. seq2seq train - seq2seq + attention (train_net's widths, emb 256,
               hidden 512, 30000 words a side, weights from the port's
               startup program on the CPU, seed 0) with Adam(1e-3) and clip
               1.0: the B = 8 signature warmed ("compiled", then "cached"),
               one replay bitwise against an unwarmed Executor's eager step
               (the loss, every gradient, parameter, moment, the optimizer
               step, the step counter) and grouped against per-op updates,
               card against CPU (loss rtol 1e-4; each gradient within 1e-3
               of its max |g|, one that is rounding noise, below 1e-6 of
               the step's largest, within 1e-3 of that); then the B = 64
               signature (pairs padded to 50, lengths 10-50) warmed and 5
               replays (losses finite and falling, replays 5, compiles
               unmoved), ms per step, target and source tokens/s, peak
               memory, and 3 eager steps' ms in the same run;
 10b. seq2seq beam - beam_search_decoder (beam 4, max_len 32) on 64
               sources, warmed as one graph over the fixed 32-step loop:
               a replay bitwise equal to the eager run (tokens, scores,
               lens), the replay's first 4 rows against the CPU's run on
               those 4 sources (scores within 1e-4 relative, tokens equal
               in >= 0.98 of positions), ms per
               decode and emitted tokens/s, warmed and eager;
 10c. srl    - the Paddle book's SRL model (db_lstm: word_dim 32, mark_dim
               5, 8 LSTM-128 layers of alternating direction, CRF; the
               conll05 dictionaries; weights from the port's startup program
               on the CPU, seed 0) with the chapter's SGD on
               exponential_decay: check_kernel_shapes accepts the program;
               the B = 8 signature warmed, one replay bitwise against an
               unwarmed Executor's eager step and grouped against per-op
               updates, card against CPU (loss rtol 1e-4, each gradient
               within 1e-3 of its max |g|); then 64 sentences of the
               synthetic conll05 reader padded to 32 warmed and 5 replays
               (losses finite and falling, LSTM launches counted at replay
               8 x 5 each, all persistent), ms per step and tokens/s beside
               3 eager steps; then the program pruned to the Viterbi tags,
               warmed: a replay bitwise against eager, the card's tags
               against the CPU's (>= 0.98 of valid positions, a row that
               differs held by its float64 path score within 1e-5
               relative), chunk_eval's counts on the card, 5 replays (LSTM
               forward launches 8 x 5, persistent), ms and tokens/s warmed
               and eager;
 10d. sequence ops - warpctc (loss and gradients through an fc),
               ctc_greedy_decoder, crf_decoding and edit_distance on small
               ragged inputs (zero-length and repeated labels), card against
               CPU from the same weights;
 10e. hier_text - the nested-sequence document classifier
               (models.hier_text.build at its defaults, emb 64, word GRU 64,
               sentence RNN 64, 2 classes, IMDB's 5147 words; documents of 8
               sentences of 32 words by the JAX test's rule; Adam(3e-3);
               weights from the startup program on the CPU, seed 0): the B =
               8 signature warmed, a replay bitwise against an unwarmed
               eager step (loss, gradients, parameters, moments, step,
               counter) and grouped against per-op updates, card against
               CPU (loss rtol 1e-4, each gradient within 1e-3 of its max
               |g|); then 64 documents warmed and 5 replays (losses finite
               and falling), ms per step and tokens/s beside 3 eager steps;
               then the program pruned to the prediction, warmed: a replay
               bitwise against eager, probabilities card against CPU within
               1e-4 of their max and the class equal wherever the top two
               are further apart than twice the largest difference, ms and
               documents/s warmed and eager;
 10f. control flow - cond (each branch an fc) with both predicates, an
               eager step card against CPU, the untaken branch's gradients
               exact zeros on both; Executor.warm of it refused before any
               capture, run() afterwards eager on the card; the bounded
               while_loop and IfElse, each in a small Adam-trained program,
               card against CPU and warmed (a replay bitwise against eager,
               grouped against per-op); the unbounded while_loop card
               against CPU; md_lstm at [32, 8, 32, 32] -> 64 in the four
               sweep directions card against CPU (hidden states within 1e-4
               of their max, each gradient within 1e-3 of its max |g|), and
               a warmed md_lstm step bitwise against eager;
 11. bn kernels - the batch-norm backward kernels (reduction, dx) against
               their plain versions in float32 and bfloat16 at ResNet-50's
               shapes ([256,64,56,56], [256,128,28,28], [256,256,56,56]
               (benchmark/bn_probe.py's), [256,2048,7,7]) and a ragged one,
               each with a constant channel; timed at [256,256,56,56] beside
               the plain versions and native_batch_norm_backward;
 12. resnet train - ResNet-50 (1000 classes, 224x224, weights from seed 0)
               as bench.py trains it, Program / Executor with Momentum(0.1,
               0.9): one float32 step (TF32 off) on 4 images on the card and
               on the CPU from the same weights, loss and every running
               statistic compared, and every gradient against the CPU's own
               spread under a 1e-7 change of the images (two more CPU
               steps; the gradients are chaotic at float32's resolution at
               this initialisation); then 5 steps in each arm,
               amp at bs=256 and float32 at bs=256, on a batch that stays on
               the card, with the batch-norm launch counts set to 0 before
               and read after (53 layers x 5 steps each), losses finite and
               printed, images/s from the median of steps 2-5, peak memory;
 13. conv kernels - the 3x3 implicit-GEMM kernels (plain and fused with the
               folded batch norm and ReLU) against their plain versions in
               float32 and bfloat16 at ResNet-50's stride-1 shapes
               ([256,56,56,64]x64 and [256,28,28,128]x128, which are
               benchmark/conv_probe.py's, [256,14,14,256]x256,
               [256,7,7,512]x512) and four ragged ones ([3,13,9,3]x40 with
               element loads of x, [3,13,9,16]x24 with 16-byte copies,
               [2,9,11,5]x13 and [2,7,9,20]x13 with element loads of w in
               bfloat16 and of one or several granules of x), and
               the plain kernel at the routed shapes of the image and
               ocr_ctc inference programs (CONV_MODEL_CASES: VGG-19's 224
               stem and 64 -> 64 convs and its 112 conv, AlexNet's 12 x 12,
               GoogLeNet's ragged inception widths, ocr_ctc's C = 1 and 16,
               FCN's three convs and SSD's four heads, each in its dtypes,
               timed beside cuDNN), the fused kernel too at FCN's C = 3 stem
               and SSD's O = 42 head (CONV_GATHER_FUSED), and ptxas's
               registers and spills of each gather instance; each
               case on the route ops/conv.py::conv_route gives it (ResNet
               shapes on the halo kernel in bfloat16 and on the halo_f32
               kernel, three TF32 passes, in float32; the ragged ones on the
               gather kernel), checked by the route counts; timed in both
               dtypes at the four ResNet shapes, beside the plain versions
               and cuDNN (F.conv2d, then the batch norm's scale and shift
               and the ReLU as separate passes, on the same NHWC tensor as
               a channels_last view and on an NCHW copy);
 14. resnet infer - the is_test program benchmark/resnet.py's infer configs
               prune to (build, 1000 classes, 224x224, weights and running
               statistics from seed 0), through Program.prune and
               Executor.run with its 3x3 stride-1 convolutions routed onto
               the kernels: ResNet-50 on 4 images on the card and on the CPU
               from the same arrays, in float32 (TF32 off) and under amp,
               logits compared; then 5 steps in each arm, ResNet-50 amp and
               float32 and ResNet-18 amp at bs=256 on images that stay on
               the card, with the conv launch counts set to 0 before and
               read after (fused 13 x 5 on ResNet-50; fused 5 x 5 and plain
               8 x 5 on ResNet-18; under amp every one on the halo route,
               in float32 every one on the halo_f32 route), images/s from the
               median of steps 2-5, peak memory;
 15. image   - VGG-19, AlexNet and GoogLeNet as benchmark/vgg.py,
               alexnet.py and googlenet.py build them (224x224, 1000
               classes, Momentum(0.01, 0.9), weights from the port's startup
               program on the CPU, seed 0): a float32 train step (TF32 off,
               dropout on) on 2 images card against CPU (loss rtol 1e-4;
               each gradient within 1e-3 of its max abs, or, where one is
               not, every gradient held to 3 x the CPU's own floor under a
               1e-6 change of the images and weights: these gradients are
               chaotic at float32's resolution), the pruned, routed
               inference on 4 images card against CPU (as ResNet-50's);
               then 5 eager steps in each train arm (VGG-19 amp and float32
               at bs=64, AlexNet and GoogLeNet amp at bs=128; dropout
               launches counted) and each inference arm (the three models,
               amp and float32; conv launches by route against
               tools/train_profile.py::conv_routes), ms per step, images/s,
               peak memory;
 16. ocr_ctc - the OCR line recognizer at its own widths on 256 synthetic
               lines, Adam(5e-3), float32: the train signature warmed, a
               replay bitwise against an unwarmed eager step and grouped
               against per-op (these and every other replay-against-eager
               check of the fcn and ssd phases with cuDNN deterministic,
               the timed runs on its default algorithms), card against
               CPU; 5
               replays and 3 eager steps; the program pruned to the greedy
               decode warmed, its two convs on the gather kernel inside the
               graph (2 launches counted at each replay, no allocation at
               replay), replays bitwise against eager on two batches, ids
               against the CPU's where every step's top two are clear;
 17. nets    - paddle_tpu_torch.nets card against CPU, one eager step each
               (the float32 train limit): scaled_dot_product_attention at
               B 16, T 128, D 512, 8 heads (one launch of each flash
               kernel), refused at head dim 8 before its first op;
               multi_head_attention with wider value heads (the einsum
               path); bidirectional_lstm (the LSTM kernels, 2 + 2),
               bidirectional_gru, sequence_conv_pool, glu,
               simple_attention, dot_product_attention; img_conv_group
               with batch norm (the BN kernels, 2 + 2; the conv biases,
               which the batch norm cancels, held to 1e-3 of the largest
               gradient) and its pruned program (2 fused conv launches)
               card against CPU;
 18. fcn     - the FCN segmenter (base 16, 21 classes, Adam(5e-3), weights
               from the port's startup program on the CPU, seed 0): a
               float32 train step (TF32 off) on 2 images at 64 px card
               against CPU (loss rtol 1e-4, each gradient
               within 1e-3 of its max abs, or 3 x the CPU's own floor if
               one is not) and the pruned inference (logits within 1e-4 of
               max, pixel classes equal where the top two are clear); then
               32 of voc2012's synthetic masks at 256 px: the train arms
               float32 and amp, 5 eager steps, then warmed (a replay
               bitwise against eager, grouped against per-op, 5 replays);
               the inference arms float32 and amp, 5 eager steps, 3 gather
               launches a step (conv_routes); ms per step, images/s, peak
               memory;
 19. ssd     - the SSD detector (21 classes, 300 px, 16 gt slots, one-box
               synthetic images, Adam(1e-3)): ssd_loss's positive and
               mined negative masks card against CPU on 4 images, then
               the float32 train step (held to the
               CPU's floor where a mask differs); the train arms float32
               and amp at 32 images, 5 eager steps (the BN kernels 3 + 3 a
               step), then warmed (a replay bitwise against eager, grouped
               against per-op, 5 replays counted at replay), the float32
               scope trained 300 more replays on 8 batches; from its
               weights the detect program (ssd.infer, keep 20) in both
               arms, 5 eager steps (4 gather launches a step, no fusion),
               warmed (replays bitwise against eager on two batches,
               launches counted at replay, nothing allocated); the
               detections card against CPU where each score lies over
               twice the largest probability difference from every other
               candidate; DetectionMAP fed 4 batches of 32 images' card
               detections on the card and on the CPU (histograms bitwise
               equal), on bin-centred scores against detection_map_np and
               on the raw scores with the default 100 bins (at most
               detection_map_np's mAP), with a fifth or more of the gts
               matched;
 20. layers  - every case of tools/layer_cases.py (the 14 activations
               that take attributes and prelu, the 21 new tensor layers,
               the 30 new nn layers, the 16 misc layers and the Variable
               operator sugar: a scalar / and -, [] out of range) on the
               card against the CPU from the
               same inputs, weights and cotangent: values within 1e-5 of
               the CPU's max abs, gradients within 1e-4 of theirs, integer
               outputs equal but at a printed tie; the four streaming
               evaluators (Accuracy, PrecisionRecall, ChunkEvaluator,
               CTCError) over 8 batches through a warmed step, each
               replay's accumulators bitwise an unwarmed eager step's and
               the CPU's, reset() after the fourth copied in by the next
               replay; the random transforms
               (ops/random.py) drawn on the card from a staged step word
               and on the CPU at the same (seed, step, tag): uniform
               (float32, float16, bfloat16), randint and split bitwise,
               normal within NORMAL_ULPS, gumbel within GUMBEL_TOL,
               categorical equal but at printed ties; 2^20 normal draws'
               mean and variance and sampling_id's histogram over 2^20
               rows (each frequency within 6 sigma), the draws timed;
 21. families - word2vec (V 2074, embedding 32, hidden 256, batch 256,
               Adam(1e-3)), recommender (the full movielens tables,
               embedding 32, fc 200, batch 256, Adam(5e-3)), traffic (24
               readings, 24 horizons, batch 1024, Adam(1e-2)), vae (784 /
               256 / 32, batch 128, Adam(1e-3)) and gan (784 / 100 / 256,
               batch 128, Adam(2e-4, beta1 0.5)) at their build()
               defaults (tools/families.py): each train step warmed, a
               replay bitwise against an unwarmed eager step, grouped
               updates bitwise per-op, the replay against the CPU's step
               (loss rtol 1e-4, each gradient within 1e-3 of its max abs);
               vae's replays at s + 1 (another loss) and at s again
               (bitwise); 5 replays timed beside 3 eager steps (losses
               finite and falling); gan's D and G warmed on one scope, 3
               alternations bitwise eager ones, the bytes each alternation
               copies between the two signatures' buffers, then 60 timed
               alternations on new batches (D's loss falling);
 22. ctr     - wide_deep and deepfm at models/ctr.py's defaults (all 26
               FIELD_VOCABS, emb 8, hidden (64, 32), batch 256 of
               datasets.ctr's synthetic clicks, Adam(5e-3), float32, TF32
               off, weights from the port's startup program on the CPU,
               seed 0): each train step warmed, a replay bitwise against an
               unwarmed eager step and grouped updates bitwise per-op, the
               replay against the CPU's step (loss rtol 1e-4, each gradient
               within 1e-3 of its max abs); is_sparse=True against False
               from the same weights and batch (the loss and every
               gradient bitwise); 5 replays timed beside 3 eager steps;
 23. sparse  - benchmark/ctr_sparse.py's A/B at its settings
               (tools/ctr_sparse.py): the fused [185971, 9] table, hidden
               (64, 32), Adagrad(0.05), batch 256 x 26 zipf(1.3) ids, the
               warm-up batches (one per rung), then 100 stream batches
               through SparseEmbeddingTrainer.train over a SparseFeeder,
               the guard on "raise"; the dense-apply arm (the whole table
               the leaf, the full-table Adagrad) on the same sequence:
               every loss bitwise equal, at the end every touched row and
               slot bitwise equal and every untouched row bitwise its
               initial value; captures = distinct rungs;
               count_dense_materializations 0 for the sparse step and > 0
               for the dense arm's; the first 10 losses card against CPU
               (rtol 1e-4); ms per step of each arm, examples/s, the mean
               bucket and n_unique, V / mean bucket, the producer's dedup
               ms and the consumer's stall ms per batch, peak memory.
 24. parallel - the LM of phase 6 at full width (V=32000, d=512, 8 heads, 6
               layers, d_ff=2048, tied, float32, TF32 off, weights from
               init_lm_params(0), 8 x 1024 tokens, Adam(1e-3), clip 1.0)
               under parallel.Strategy: first the dropout kernel with
               counter maps (4 row slices of [8, 1024, 512], sp slices
               contiguous and striped) bitwise the whole tensor's launch;
               the single-card unsharded step's losses and gradients (and,
               with dropout 0.1, its first mask) as the reference; then a
               gang of 4 ranks sharing the card over gloo (the ring's
               send / recv, which gloo cannot take from device memory,
               staged through pinned host memory), two steps a leg: {sp 2, tp 2} with ring,
               ring_striped and Ulysses attention, {tp 4}, and {dp 4} with
               ZeRO-1 and dropout 0.1: losses within rtol PAR_LOSS_RTOL of
               the single card's, every step-1 gradient within
               PAR_GRAD_REL of its max abs, the dropout mask bitwise, the
               flash and dropout launches per rank equal to the prediction
               (ring.ring_launches), ms per step and peak memory per rank;
               then NCCL with one rank on the card ({dp, sp, tp} all 1,
               use_tp and use_sp: every collective a real NCCL call), one
               step held to the same limits.
Each phase prints its seconds.  The line before the card line is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,     # CUDA-core float32
                  torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.int8: 1979e12}      # dense tensor-core int8
# dense tensor-core TF32; a float32-accurate product on the tensor cores is
# TF32_PASSES TF32 products (hi and lo parts of each operand)
TF32_OPS_PER_S = 495e12
TF32_PASSES = 3

LM_CFG = dict(vocab_size=32000, max_len=1024, d_model=512, n_heads=8,
              n_layers=6, d_ff=2048)
ENGINE_CFG = dict(n_slots=8, block_size=16, spec_window=4, dtype="float32")
# kernel-check shapes: the serving step's (S = n_slots, H, Dh, Bs, n_tbl =
# max_len / Bs, L = n_layers)
KS, KH, KDH, KBS, KNTBL, KL, KLAYER = 8, 8, 64, 16, 64, 6, 3
TOLERANCE = {  # (atol, rtol); float32 sums run in another order
    "float32": (2e-5, 1e-5),
    "bfloat16": (2e-2, 2e-2),
    "int8": (2e-5, 1e-5),
}
KERNEL_SOURCES = ("paged_attention.cu", "flash_attention.cu", "lstm.cu",
                  "batch_norm.cu", "conv.cu", "dropout.cu")
# flash kernels against their plain versions.  float32: the JAX package's
# own tolerances for its Pallas kernels (tests/test_pallas_ops.py:34,215):
# o and lse atol 2e-5, gradients 2e-4 of max |grad|, over the tensor.
# bfloat16 is held element by element, with BF16_U = 2^-8, bfloat16's unit
# roundoff (one ulp of x is at most 2 * BF16_U * |x|):
#   o: |d| <= 2u (A + |o|) + 2e-5, A = sum_k p_k |v_k| (the plain forward
#      on |v|).  Kernel and plain version each round every probability
#      once before p.v (the kernel the running, unnormalised one, the plain
#      version the normalised one), at most u * A apart from the exact sum
#      each, and each rounds o once (u |o|): a bound, not a fit;
#   dq, dk, dv: |d| <= 2u |grad| + 1e-3 max |grad|.  Both sides round p and
#      dS at values that differ only in float32's last bits, so a rounding
#      falls the other way only now and then: the first term lets every
#      output differ by one ulp, the second the sums' share, set at three
#      times the largest reading (dq 3.1e-4 of max |grad| on an NVIDIA H100
#      80GB HBM3, 700 W, with dk and dv equal bit for bit).
FLASH_FWD_ATOL = 2e-5
FLASH_BWD_REL = 2e-4
BF16_U = 2.0 ** -8
FLASH_BWD_BF16_SUM_REL = 1e-3
# (label, N = B*H, Tq, Tk, D, causal); the first is the training shape
FLASH_CASES = [("train", 64, 1024, 1024, 64, True),
               ("rectangular", 8, 50, 70, 16, False),
               ("ragged", 8, 37, 37, 16, True),
               ("wide", 4, 130, 200, 128, False),
               ("d32", 4, 200, 200, 32, True)]
FLASH_KERNELS = ("fwd", "bwd_dkdv", "bwd_dq")
# the LM's amp parity step (attention in bf16), card against CPU: an
# element-wise bound does not hold through six bf16 layers, so each
# gradient (relative L2, and max |d| over max |g|), all of them together,
# and the loss are held to AMP_SPREAD_FACTOR x the CPU's own spread, its
# amp step's distance from its float32 step on the same weights and tokens
# (bf16's whole effect on the step), measured in the same run; never
# tighter than AMP_FLOOR, the float32 step's limit (PERF.md section 2)
AMP_SPREAD_FACTOR = 3.0
AMP_FLOOR = 1e-3
# LSTM kernels against their plain versions: the repo's float32 kernel
# tolerances, hs and c_final atol 2e-5, dxw / du / dpeep within 2e-4 of each
# gradient's max |g|
LSTM_FWD_ATOL = 2e-5
LSTM_BWD_REL = 2e-4
LSTM_KERNELS = ("fwd", "bwd")
LSTM_ACTS = ("sigmoid", "tanh", "tanh")
# text_lstm's layer shape (benchmark/text_lstm.py: seq_len 100, bs 128,
# hidden 512; lengths 50-100), on the persistent route; B=256 takes the
# step route (32 x 8 blocks do not fit 132 SMs at one block an SM)
LSTM_SHAPE = (100, 128, 512)
LSTM_STEP_BATCH = 256
# the SRL layer shape (db_lstm at the label_semantic_roles chapter's width:
# 64 sentences padded to 32 tokens, hidden 128, peepholes): the persistent
# route (8 x 2 blocks), the forward direction timed and the reverse one
# (leading padding, as dynamic_lstm(is_reverse=True) feeds it) checked, on
# ragged lengths with 1 and T
LSTM_SRL_SHAPE = (32, 64, 128)
# the srl phase: the parity signature's batch; the decode's tags, card
# against CPU, equal in at least SRL_TAG_SHARE of the valid positions, and
# every row that differs held by its path score (float64, from the CPU's
# emissions and the transition) within SRL_PATH_REL of the CPU path's: a
# flip only at a near-tie (ROADMAP C.5)
SRL_PARITY_BATCH = 8
SRL_TAG_SHARE = 0.98
SRL_PATH_REL = 1e-5
# the sequence ops phase, card against CPU on small ragged inputs: the CTC
# loss within rtol SEQ_OPS_LOSS_REL and each gradient within
# SEQ_OPS_GRAD_REL of its max |g| (float32 sums in another order); the
# Viterbi tags, greedy CTC ids and edit distances equal
SEQ_OPS_LOSS_REL = 1e-5
SEQ_OPS_GRAD_REL = 1e-4
# batch-norm backward kernels against their plain versions: dbeta and
# dgamma (float32 sums in another order) within BN_SUM_REL of sum |dy| and
# sum |dy x-hat| per channel, in both dtypes (the kernel and the plain
# version read the same values and add in float32); float32 dx within
# BN_DX_REL of max |dx|; bfloat16 dx element by element within 2u |dx| +
# BN_BF16_SUM_REL max |dx| (each side rounds once to bfloat16)
BN_SUM_REL = 1e-5
BN_DX_REL = 2e-5
BN_BF16_SUM_REL = 1e-3
BN_KERNELS = ("reduce", "dx")
# (label, N, C, H, W); "probe" is benchmark/bn_probe.py's shape, timed
BN_CASES = [("stage1", 256, 64, 56, 56), ("stage2", 256, 128, 28, 28),
            ("probe", 256, 256, 56, 56), ("stage4", 256, 2048, 7, 7),
            ("ragged", 3, 5, 7, 9)]
BN_EPS = 1e-5
RESNET_PARITY_BATCH = 4
RESNET_BN_LAYERS = 53
# the ResNet-50 parity step's gradients against the CPU's own float32
# floor (see _resnet_parity)
RESNET_FLOOR_FACTOR = 3
# conv kernels against their plain versions: float32 within CONV_F32_REL
# of max |out| (float32 sums in another order); bfloat16 element by element
# within 2u |out| + CONV_BF16_SUM_REL max |out| (each side rounds once to
# bfloat16 from float32 sums that differ in their last bits)
CONV_F32_REL = 2e-5
CONV_BF16_SUM_REL = 1e-3
CONV_KERNELS = ("igemm", "fused")
# (label, N, H, W, C, O); "c56" and "c28" are benchmark/conv_probe.py's
# shapes; the ragged ones leave a part-filled last pixel tile and
# output-channel tile, "ragged" with element loads of x (C = 3),
# "ragged16" with 16-byte copies, "ragged odd" with element loads of x and
# (bfloat16) of w (O odd), "ragged c20" with element loads of several
# granules a point
CONV_CASES = [("c56", 256, 56, 56, 64, 64), ("c28", 256, 28, 28, 128, 128),
              ("c14", 256, 14, 14, 256, 256), ("c7", 256, 7, 7, 512, 512),
              ("ragged", 3, 13, 9, 3, 40), ("ragged16", 3, 13, 9, 16, 24),
              ("ragged odd", 2, 9, 11, 5, 13), ("ragged c20", 2, 7, 9, 20, 13)]
# ResNet's four stride-1 shapes: on the halo route in bfloat16 and the
# halo_f32 route in float32 (the ragged ones on the gather route), timed in
# both dtypes
CONV_RESNET = ("c56", "c28", "c14", "c7")
CONV_ROUTE = {torch.bfloat16: "halo", torch.float32: "halo_f32"}
CONV_TIMED = {torch.bfloat16: CONV_RESNET, torch.float32: CONV_RESNET}
# ResNet inference: card against CPU on INFER_PARITY_BATCH images, float32
# logits within INFER_F32_REL of max |.| (float32 sums in another order
# through 50 layers), bfloat16 logits element by element within 2u |.| +
# CONV_BF16_SUM_REL max |.|; the timed arms' launches a step by depth
INFER_PARITY_BATCH = 4
INFER_F32_REL = 1e-4
INFER_LAUNCHES = {50: {"igemm": 0, "fused": 13}, 18: {"igemm": 8, "fused": 5}}
# dropout kernels against their plain versions, bitwise (the same integer
# arithmetic; a multiply by 0 or 1 is exact): the LM's activation shape
# (timed) and a ragged one, p, step words (0, 1, past 2^31, the last
# uint32) and tags; seed 0, the LM program's.  Bound: DROPOUT_INT_OPS
# integer operations an element, counted from csrc/dropout.cu
# (threefry2x32: two adds of the counter, 20 rounds of add, funnel shift
# and xor, 5 key injections of two adds; then the xor of the halves, the
# shift and the or that make the float), at the H100 SXM's instruction
# issue rate, INT_ISSUE_PER_S: 132 SMs x 4 schedulers x one 32-lane warp
# instruction a clock at the 1.98 GHz boost clock.  nvcc issues integer
# adds as IMAD on the FMA pipe beside the INT32 pipe's shifts and logic
# ops, so the 64 INT32 lanes an SM are not the ceiling (at 64 lanes the
# bound would be 0.0188 ms, above the 0.0179 ms the kernel takes on an
# NVIDIA H100 80GB HBM3 at 700 W)
INT_ISSUE_PER_S = 132 * 128 * 1.98e9
DROPOUT_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3
DROPOUT_CASES = ((8, 1024, 512), (1000, 37))
DROPOUT_PS = (0.1, 0.5)
DROPOUT_STEPS = (0, 1, 2 ** 31 + 5, 2 ** 32 - 1)
DROPOUT_TAGS = (1, 13)
DROPOUT_SEED = 0
DROPOUT_KERNELS = ("fwd", "bwd")
# the lm dropout train phase: Transformer-base's P_drop; the step counter
# of its parity and replay checks (int32's largest: the check at s + 1
# stages 2^31, past the edge of the int32 word that carries it)
LM_DROPOUT = 0.1
LM_DROPOUT_STEP = 2 ** 31 - 1
# (label, amp, remat); the float32 + remat arm is the slice's main path
LM_DROPOUT_ARMS = (("float32", False, False), ("float32 remat", False, True),
                   ("amp remat", True, True))
# remat against no remat, float32: each gradient within this share of its
# max |g| (the backward may add a residual's two contributions in another
# order; the forward is the same kernels, the loss bitwise)
REMAT_GRAD_REL = 1e-5
# the optimizers phase: a 2-layer LM at d = 128, each new optimizer with
# noam_decay(128, 10) (a tensor lr, about 3e-3 at step 1) and L2Decay(1e-4)
OPT_LM_CFG = dict(vocab_size=512, max_len=128, d_model=128, n_heads=2,
                  n_layers=2, d_ff=256)
INFER_ARMS = (("resnet50-infer", 50, True), ("resnet50-infer", 50, False),
              ("resnet18-infer", 18, True))
# seq2seq: the beam decode's card-against-CPU sources (the train parity
# signature's batch and feed seed are tools/seq2seq_parity.py's)
SEQ2SEQ_BEAM_PARITY = 4
# the seq2seq and srl parity steps, card against CPU: each gradient within
# 1e-3 of its max |g| (the float32 train limit), except one that is float32
# rounding noise, max |g| below this share of the step's largest and
# failing its own scale: that one within 1e-3 of the step's largest max
# |g|.  (The srl step's LSTM and fc weights' gradients lie at 2.6e-6 to
# 1.3e-5 against the CRF transition's 13, below the share; they hold on
# their own scale, 2.9-6.3e-7 of it.)  At seq2seq's initialisation the
# attention projection's gradient (fc_w_4) is the remainder of a score
# shift that the softmax cancels, 2.5e-11 against 3.9e-2; the CPU moves it
# by 1.05-1.11e-3 of itself under a relative 1e-7 change of the weights,
# and TF32 by 1.14e-3, so no limit on its own max |g| tells float32 from
# a lower precision (tools/seq2seq_parity.py, PERF.md section 2); the next
# smallest, fc_w_2, is 3.8e-6 of the largest.  The CPU tests use the same
# share (tests/test_torch_seq2seq.py)
SEQ2SEQ_NOISE_SHARE = 1e-6
# the hier_text phase: the parity signature's batch; served probabilities,
# card against CPU, within HIER_PROB_REL of their max abs (float32 sums in
# another order through 8 x 32 GRU steps), and the class equal wherever the
# top two probabilities are further apart than twice the largest difference
# (the ResNet inference rule)
HIER_PARITY_BATCH = 8
HIER_PROB_REL = 1e-4
# the control flow phase: md_lstm at an OCR line's size ([N, H, W, D] to
# MDLSTM_SIZE), card against CPU in all four sweep directions: the hidden
# states within MDLSTM_FWD_REL of their max abs, each gradient within
# MDLSTM_GRAD_REL of its max abs (the float32 train limit)
MDLSTM_SHAPE = (32, 8, 32, 32)
MDLSTM_SIZE = 64
MDLSTM_FWD_REL = 1e-4
MDLSTM_GRAD_REL = 1e-3
# the image phase (VGG-19, AlexNet, GoogLeNet; PERF.md section 4): the
# float32 train step card against CPU on IMAGE_PARITY_BATCH images
# (_image_train_parity), the pruned inference on INFER_PARITY_BATCH
# (_infer_parity), then the eager arms at each config's batch
IMAGE_PARITY_BATCH = 2
# the relative change of the images and weights whose CPU spread is the
# image parity step's floor: at 1e-6 the spread is the size of float32's own
# effect on these steps (VGG-19's median gradient: the CPU's float32 step
# lies 1.6e-3 from its float64 step, the spread reads 2.0e-3), where ResNet's
# 1e-7 change of the images reads 9.8e-7 (tools/image_parity.py on an NVIDIA
# H100 80GB HBM3, 700 W; PERF.md section 2)
IMAGE_FLOOR_SCALE = 1e-6
IMAGE_TRAIN_ARMS = (("vgg19", True), ("vgg19", False), ("alexnet", True),
                    ("googlenet", True))
IMAGE_INFER_ARMS = tuple((m, amp) for m in ("vgg19", "alexnet", "googlenet")
                         for amp in (True, False))
# the conv kernels at the shapes of later slices, the routed convs of the
# image, ocr_ctc, FCN and SSD inference programs at their batches (SSD's
# heads: 2 boxes a cell x 4 coordinates or 21 classes): (label, N, H, W, C, O,
# {dtype: the route conv_route gives}); the plain kernel only (none of
# these programs has a batch norm to fuse), timed as the other cases
CONV_MODEL_CASES = [
    ("vgg19 c224 stem", 64, 224, 224, 3, 64,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("vgg19 c224", 64, 224, 224, 64, 64,
     {torch.bfloat16: "halo", torch.float32: "gather"}),
    ("vgg19 c112", 64, 112, 112, 128, 128,
     {torch.bfloat16: "halo", torch.float32: "halo_f32"}),
    ("alexnet c12", 128, 12, 12, 384, 384,
     {torch.bfloat16: "halo", torch.float32: "halo_f32"}),
    ("googlenet c28 96", 128, 28, 28, 96, 128,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("googlenet c14 144", 128, 14, 14, 144, 288,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("googlenet c7 160", 128, 7, 7, 160, 320,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("ocr_ctc c1", 256, 8, 32, 1, 16, {torch.float32: "gather"}),
    ("ocr_ctc c16", 256, 4, 16, 16, 32, {torch.float32: "gather"}),
    ("fcn c256", 32, 256, 256, 3, 16,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("fcn c128", 32, 128, 128, 16, 32,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("fcn c64", 32, 64, 64, 32, 64,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("ssd loc75", 32, 75, 75, 32, 8,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("ssd conf75", 32, 75, 75, 32, 42,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("ssd loc38", 32, 38, 38, 64, 8,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
    ("ssd conf38", 32, 38, 38, 64, 42,
     {torch.bfloat16: "gather", torch.float32: "gather"}),
]
# CONV_MODEL_CASES whose fused form is checked and timed too, on the gather
# route: a C = 3 stem and an O = 42 head
CONV_GATHER_FUSED = ("fcn c256", "ssd conf75")
# the fcn and ssd phases (PERF.md section 4; the configurations are
# tools/train_profile.py's): FCN's float32 train step and pruned inference
# card against CPU on FCN_PARITY_BATCH images at FCN_PARITY_SIZE px, SSD's
# on SSD_PARITY_BATCH images at 300 px; the routed launches an inference
# step by route (conv_routes gives them: no channel count of either model
# a multiple of 64); SSD's three training batch norms; SSD_TRAIN_STEPS
# replays over SSD_TRAIN_BATCHES batches that train the float32 scope
# whose weights the detect arms, the detections' card-against-CPU check
# and DetectionMAP read (the loss levels off by then: only class 1 looks
# unlike the others, so a box of another class gets its label by chance);
# DetectionMAP fed SSD_MAP_BATCHES new batches of SSD_BATCH images, once
# with their scores moved to the centres of SSD_MAP_BINS bins, so that
# detection_map_np sees the evaluator's own quantisation, and once as they
# are on the default 100 bins; its true positives at least SSD_MAP_MIN_TP
# of the gts
FCN_PARITY_BATCH, FCN_PARITY_SIZE = 2, 64
SSD_PARITY_BATCH = 4
FCN_ROUTES = {"halo": 0, "halo_f32": 0, "gather": 3}
SSD_ROUTES = {"halo": 0, "halo_f32": 0, "gather": 4}
SSD_BN_LAYERS = 3
SSD_TRAIN_STEPS = 300
SSD_TRAIN_BATCHES = 8
SSD_MAP_BATCHES = 4
SSD_MAP_BINS = 100000
SSD_MAP_MIN_TP = 0.2
# the ocr_ctc phase: OCR_BATCH lines (tools/train_profile.py); the nets
# phase's programs: NETS_BATCH rows, and scaled_dot_product_attention at T
# NETS_T, width NETS_D, NETS_HEADS heads (head dim 64)
NETS_BATCH = 16
NETS_T, NETS_D, NETS_HEADS = 128, 512, 8
# the layers phase: each case of tools/layer_cases.py on the card against
# the CPU, values within LAYER_FWD_REL of the CPU's max abs, gradients
# within LAYER_GRAD_REL of theirs (float32 sums run in another order); an
# integer output (top_k's indices, one_hot, sampling_id) equal, but for a
# sampled id whose top-two scores tie within TIE_REL of max(1, |top|); the
# random transforms card (a staged step word) against CPU at RANDOM_KEYS
# (seed, step, tag) and RANDOM_SHAPES; RANDOM_DRAWS draws for the
# statistics
LAYER_FWD_REL = 1e-5
LAYER_GRAD_REL = 1e-4
TIE_REL = 1e-5
RANDOM_KEYS = [(0, 0, 1), (7, 3, 5), (123456, 2 ** 31 + 5, 13),
               (2 ** 32 - 1, 2 ** 32 - 1, 2)]
RANDOM_SHAPES = [(7,), (33, 17), (1000, 37)]
RANDOM_DRAWS = 1 << 20
# the families phase: GAN's D/G alternations on new batches after the
# bitwise checks (tests/test_models.py:285 trains 60)
GAN_ALTERNATIONS = 60
# the layers phase's evaluators: EV_BATCHES batches through the warmed
# step, reset() after batch EV_RESET_AT
EV_BATCHES, EV_RESET_AT = 8, 3
# the sparse phase: the first SPARSE_CPU_STEPS losses card against CPU
# within SPARSE_LOSS_RTOL
SPARSE_CPU_STEPS = 10
SPARSE_LOSS_RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` calls, timed
    with CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 30, warmup: int = 3, counted=None):
    """Device milliseconds per call of ``fn(i)``, as torch.profiler reads
    the device kernels and copies that ``iters`` calls enqueue, after
    ``warmup`` calls.  These are the calls ``cuda_ms`` times, made again
    under the profiler (whose host cost would inflate the event-timed ms).
    In a long process the profiler now and then handed a window's last
    records to the next window (one window read nothing, another 12% too
    much).  So a train of marker kernels (``torch.cuda._sleep``, not
    counted) follows the timed calls to push their records out before the
    window closes, the window is padded by 20 ms on each side, and each
    kernel counts at its mean duration times the whole number of times a
    call runs it (its count over ``iters``, rounded): a record lost or
    carried over moves the sum by at most its own share, and a stray
    record of another window's kernel counts for nothing.  A window that
    reads no device time at all is measured again in a new window, up to
    EMPTY_WINDOW_RETRIES times, each one printed (with the kernel records
    it did hold) and counted in ``empty_windows`` (ROADMAP C.2: a whole
    run once lost one window's records, late in the conv phase; late in a
    run each window loses the first 7 records of a kernel launched from
    the kernel libraries, so ``iters`` stays at 30 for them, where the
    rounding still counts each call once).  Fails when the profiler shows
    no device time in any of them: there is no fallback to the events.

    ``counted``: ``(read, name)`` for a hand-written kernel, ``read()``
    its wrapper's launch counter and ``name`` its device kernel's.  That
    kernel then counts at its mean duration times the launches the
    counter saw in the window, over ``iters``; a window that kept fewer of
    its records than were launched is measured again in the same way, and
    when every window came short this returns None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools.decode_profile import _kernel_us

    short = None
    for attempt in range(EMPTY_WINDOW_RETRIES + 1):
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        before = counted[0]() if counted else 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for i in range(iters):
                fn(i)
            for _ in range(64):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
        launched = counted[0]() - before if counted else 0
        evts = [evt for evt in prof.key_averages()
                if _kernel_us(evt) > 0 and "spin_kernel" not in evt.key]
        mine = [evt for evt in evts if counted and counted[1] in evt.key]
        kept = sum(evt.count for evt in mine)
        if kept < launched:
            short = (kept, launched)
            empty_windows.append(attempt)
            print(f"device_ms: a profiler window kept {kept} of the "
                  f"{launched} {counted[1]} records launched (attempt "
                  f"{attempt + 1}; {len(empty_windows)} re-measured windows "
                  f"in this run so far)", flush=True)
            continue
        # microseconds a call: each kernel's mean times its launches a call
        us = sum(_kernel_us(evt) / evt.count * (
            launched / iters if evt in mine else round(evt.count / iters))
            for evt in evts)
        if us > 0:
            return us / 1e3
        empty_windows.append(attempt)
        held = {evt.key[:40]: evt.count for evt in evts}
        print(f"device_ms: a profiler window read no device time (attempt "
              f"{attempt + 1}; {len(empty_windows)} in this run so far; "
              f"kernel records it held, of {iters} calls: {held})",
              flush=True)
    if short is not None:
        return None
    fail("torch.profiler shows no device time for a timed call")


# the empty profiler windows of this run, each a re-measured window
EMPTY_WINDOW_RETRIES = 2
empty_windows: list = []


def both_ms(fn, iters: int = 30, warmup: int = 3) -> tuple:
    """(event-timed ms, device ms) per call of ``fn(i)``."""
    return (cuda_ms(fn, iters, warmup), device_ms(fn, iters, warmup))


# ----------------------------------------------------------------- phases


def phase_device() -> str:
    from paddle_tpu_torch import card_info

    card = card_info(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices "
          f"{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for fut in [pool.submit(_build.build_library, src)
                    for src in KERNEL_SOURCES]:
            fut.result()
    for src in KERNEL_SOURCES:
        _build.load_kernel_library(src)
        secs = _build.build_seconds.get(src)
        print(f"build: {src} "
              + (f"compiled in {secs:.2f} s" if secs is not None
                 else "loaded from an earlier build"))
        for name, regs, spill in _ptxas_report(_build.build_logs.get(src,
                                                                     "")):
            print(f"build:   {name}: {regs} registers, {spill} bytes "
                  f"spilled")
    print(f"build: all sources ready in {time.perf_counter() - t0:.2f} s")


def _ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) per entry function of an
    ``nvcc -Xptxas -v`` log; the mangled name is cut to the kernel's name
    and the first characters of its template arguments."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name, spill = hit.group(1), 0
            continue
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit and name:
            spill = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            short, pos = name[:40], 3          # past "_ZN"
            while (num := re.match(r"\d+", name[pos:])) is not None:
                start = pos + num.end()
                ident = name[start:start + int(num.group())]
                if ident.endswith("kernel"):
                    short = ident + name[start + len(ident):][:28]
                    break
                if not ident.startswith("_GLOBAL__N"):
                    short = ident     # a kernel named otherwise (lstm.cu)
                pos = start + len(ident)
            rows.append((short, int(hit.group(1)), spill))
            name = None
    return rows


def _kernel_inputs(kind: str, W: int, dev, rng):
    """Arenas [n_blocks+1, L, H, Bs, Dh] of the given kind, a poisoned trash
    block, per-slot block tables with trash past each slot's live columns,
    ragged lengths [S, W], and q [S, W, H, Dh]."""
    from paddle_tpu_torch.ops import quantize_kv

    S, H, Dh, Bs, n_tbl, L = KS, KH, KDH, KBS, KNTBL, KL
    T = n_tbl * Bs
    nb = S * n_tbl
    shape = (nb + 1, L, H, Bs, Dh)
    kf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kf[nb] = 30.0   # poisoned trash: a mask slip would show
    vf[nb] = 30.0
    if kind == "int8":
        # absmax over Dh gives the [n_blocks+1, L, H, Bs] scale planes
        k_pool = tuple(t.to(dev) for t in quantize_kv(kf))
        v_pool = tuple(t.to(dev) for t in quantize_kv(vf))
        qdt = torch.float32
    else:
        dt = torch.float32 if kind == "float32" else torch.bfloat16
        k_pool, v_pool = kf.to(dev, dt), vf.to(dev, dt)
        qdt = dt
    base = rng.randint(1, T - W + 2, size=S)      # ragged, >= 1
    base[0] = T - W + 1                           # one slot at full length
    lengths = torch.from_numpy(
        (base[:, None] + np.arange(W)[None, :]).astype(np.int32))
    perm = rng.permutation(nb)
    tables = np.full((S, n_tbl), nb, np.int32)
    for s in range(S):
        live = -(-int(lengths[s].max()) // Bs)
        tables[s, :live] = perm[s * n_tbl: s * n_tbl + live]
    q = torch.from_numpy(rng.standard_normal((S, W, H, Dh)).astype(np.float32))
    return (q.to(dev, qdt), k_pool, v_pool, torch.from_numpy(tables).to(dev),
            lengths.to(dev))


def _bound(kind: str, W: int, q, lengths) -> tuple:
    """(bound_ms, bound_by) for one launch: live K/V tiles read once, q, the
    tables and lengths read once, the output written once; operations are
    the score and value multiply-adds over the live positions."""
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    live_cols = np.ceil(lengths.max(dim=1).values.cpu().numpy() / KBS)
    live_pos = live_cols * KBS
    per_pos = KH * KDH * itemsize + (KH * 4 if kind == "int8" else 0)
    nbytes = 2 * float(live_pos.sum()) * per_pos
    nbytes += 2 * q.numel() * q.element_size()            # q in, out
    nbytes += KS * KNTBL * 4 + lengths.numel() * 4
    ops = float((2 * 2 * W * KH * KDH * live_pos).sum())
    peak = PEAK_OPS_PER_S[{"float32": torch.float32,
                           "bfloat16": torch.bfloat16,
                           "int8": torch.int8}[kind]]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _ms_or_none(ms) -> str:
    return "not measured (every window came short)" if ms is None \
        else f"{ms:.4f} ms"


def paged_probe():
    """Device ms a call of the paged kernel at the float32 W=1 shape (one
    fixed draw), timed by ``device_ms`` against the wrapper's launch
    counter: at the start of the kernels phase and again after the
    parallel phase, in one process, to see whether torch.profiler's
    windows keep their records over a long process (ROADMAP C.2).  None
    when every window kept fewer split-kernel records than were launched.
    A record, not a check."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    q, kp, vp, tables, lengths = _kernel_inputs(
        "float32", 1, torch.device("cuda"), np.random.RandomState(7))
    qq, ll = q[:, 0], lengths[:, 0]
    return device_ms(lambda i: paged_attention(qq, kp, vp, i % KL, tables,
                                               ll),
                     counted=(lambda: paged_attention.launches,
                              "paged_split_kernel"))


def phase_kernels(card: str) -> dict:
    """Kernel against plain version for float32 / bfloat16 / int8 arenas at
    W=1 and W=4; returns the float32 W=1 record for the JSON line, with
    the first ``paged_probe`` reading."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_gather_kv
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    probe = paged_probe()
    print(f"C.2 probe, start of the kernels phase: paged_attention float32 "
          f"W=1 device {_ms_or_none(probe)} on {card}")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    record = None
    for kind in ("float32", "bfloat16", "int8"):
        for W in (1, 4):
            q, kp, vp, tables, lengths = _kernel_inputs(kind, W, dev, rng)
            qq = q[:, 0] if W == 1 else q
            ll = lengths[:, 0] if W == 1 else lengths
            got = paged_attention(qq, kp, vp, KLAYER, tables, ll)
            torch.cuda.synchronize()
            want = paged_attention_reference(qq, kp, vp, KLAYER, tables, ll,
                                             out_dtype=q.dtype)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{kind} W={W}: kernel returned {got.shape} {got.dtype}, "
                  f"plain {want.shape} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kind} W={W}: non-finite kernel output")
            err = float((got.float() - want.float()).abs().max())
            atol, rtol = TOLERANCE[kind]
            ok = torch.allclose(got.float(), want.float(), atol=atol,
                                rtol=rtol)
            print(f"kernel paged_attention {kind} W={W}: max|d|={err:.3e} "
                  f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"paged_attention {kind} W={W} disagrees with its "
                      f"plain version: max|d|={err}")

            # timing: rotate over layers so the live tiles (~34 MB per layer
            # in float32) do not stay in the 50 MB L2, as in a real step
            def run_kernel(i):
                paged_attention(qq, kp, vp, i % KL, tables, ll)

            def run_plain(i):
                paged_attention_reference(qq, kp, vp, i % KL, tables, ll,
                                          out_dtype=q.dtype)

            kc = [paged_gather_kv(kp, la, tables) for la in range(KL)]
            vc = [paged_gather_kv(vp, la, tables) for la in range(KL)]
            qh = q.transpose(1, 2).to(kc[0].dtype)             # [S, H, W, Dh]
            t_idx = torch.arange(KNTBL * KBS, device=dev)
            mask = (t_idx[None, None, :] < lengths[:, :, None])[:, None]

            def run_library(i):
                F.scaled_dot_product_attention(qh, kc[i % KL], vc[i % KL],
                                               attn_mask=mask)

            ms, dev_ms = both_ms(run_kernel)
            plain_ms, plain_dev = both_ms(run_plain)
            library_ms, library_dev = both_ms(run_library)
            bound_ms, bound_by = _bound(kind, W, q, lengths)
            print(f"kernel paged_attention {kind} W={W}: {ms:.4f} ms (device "
                  f"{dev_ms:.4f}), plain {plain_ms:.4f} ms (device "
                  f"{plain_dev:.4f}), sdpa {library_ms:.4f} ms (device "
                  f"{library_dev:.4f}), bound {bound_ms:.4f} ms ({bound_by}; "
                  f"device time {bound_ms / dev_ms:.3f} of it) on {card}")
            del kc, vc
            if kind == "float32" and W == 1:
                record = {"c2_probe_start_device_ms": probe,
                          "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                          "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms,
                          "library_device_ms": library_dev}
    return record


def _flash_bound(kernel: str, N: int, Tq: int, Tk: int, D: int,
                 causal: bool, dtype) -> tuple:
    """(bound_ms, bound_by) for one launch at this run's shape: each input
    read once and each output written once; operations are the
    multiply-adds of the kernel's products over the score entries the mask
    keeps (a causal row q sees min(q + 1, Tk) keys): two products in the
    forward (q.k, p.v), four in dK/dV (q.k, g.v, p.g, ds.q), three in dQ
    (q.k, g.v, ds.k)."""
    it = torch.empty((), dtype=dtype).element_size()
    if causal:
        pairs = N * float(np.minimum(np.arange(1, Tq + 1), Tk).sum())
    else:
        pairs = float(N * Tq * Tk)
    products = {"fwd": 2, "bwd_dkdv": 4, "bwd_dq": 3}[kernel]
    ops = 2.0 * D * pairs * products
    q_b, kv_b, stat_b = N * Tq * D * it, N * Tk * D * it, N * Tq * 4
    nbytes = {"fwd": 2 * q_b + 2 * kv_b + stat_b,       # q k v in, o lse out
              "bwd_dkdv": 2 * q_b + 4 * kv_b + 2 * stat_b,  # + dk dv out
              "bwd_dq": 3 * q_b + 2 * kv_b + 2 * stat_b}[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _worst(got, want, tol) -> float:
    """max |got - want| / tol, element by element (tol a tensor or a
    number); the check holds where this is <= 1."""
    return float(((got.float() - want.float()).abs() / tol).max())


def _flash_inputs(N, Tq, Tk, D, dtype, dev) -> tuple:
    """q, k, v, g of a flash case, N(0, 1) from a seed the shape gives."""
    rng = np.random.RandomState(N + Tq + 7 * Tk + D)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return mk(N, Tq, D), mk(N, Tk, D), mk(N, Tk, D), mk(N, Tq, D)


def _bwd_f64(q, k, v, g, lse, delta, scale: float, causal: bool) -> tuple:
    """The bfloat16 backward's arithmetic in float64, a second witness
    beside the plain versions: s, p, dP and dS from the same (q, k, v, g,
    lse, delta), p and dS rounded to bfloat16 where the kernels and the
    plain versions round them, the three products in float64 and not
    rounded.  Returns (dq, dk, dv), float64.  A rounding of p or dS that
    falls the other way in one side moves that side from this as far as
    from the other side; a wrong product moves it further."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    s = torch.einsum("nqd,nkd->nqk", qd, kd) * scale
    p = torch.exp(s - lse.double()[..., None])
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        p = p.masked_fill(qpos < kpos, 0.0)
    dp = torch.einsum("nqd,nkd->nqk", gd, vd)
    ds = p * (dp - delta.double()[..., None]) * scale
    p, ds = p.to(q.dtype).double(), ds.to(q.dtype).double()
    return (torch.einsum("nqk,nkd->nqd", ds, kd),
            torch.einsum("nqk,nqd->nkd", ds, qd),
            torch.einsum("nqk,nqd->nkd", p, gd))


def _bf16_bwd_worst(got, want) -> float:
    """max |got - want| over the bfloat16 backward's element-wise limit
    2u |want| + FLASH_BWD_BF16_SUM_REL max |want|."""
    w = want.float()
    return _worst(got, w, 2 * BF16_U * w.abs()
                  + FLASH_BWD_BF16_SUM_REL * float(w.abs().max()) + 1e-30)


def _flash_case(label, N, Tq, Tk, D, causal, dtype, dev, card) -> dict:
    """One case: forward (o, lse) and backward (dq, dk, dv) of the kernels
    against the plain versions on the same inputs; at the training shape
    also the times.  Returns the per-kernel records."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import attention as TA

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    q, k, v, g = _flash_inputs(N, Tq, Tk, D, dtype, dev)
    scale = D ** -0.5
    name = f"flash {label} N={N} Tq={Tq} Tk={Tk} D={D} causal={causal} {kind}"

    o, lse = TA.flash_fwd_kernel(q, k, v, scale, causal)
    torch.cuda.synchronize()
    ro, rlse = TA._fwd_reference(q, k, v, scale, causal)
    check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
          f"{name}: non-finite forward output")
    err_o, err_lse = _abs(o, ro), _abs(lse, rlse)
    if kind == "float32":
        tol_o, lim_o = FLASH_FWD_ATOL, f"atol {FLASH_FWD_ATOL}"
    else:
        a_sum = TA._fwd_reference(q.float(), k.float(), v.float().abs(),
                                  scale, causal)[0]
        tol_o = 2 * BF16_U * (a_sum + ro.float().abs()) + FLASH_FWD_ATOL
        lim_o = "2u (sum p|v| + |o|) + 2e-5 per element"
    w_o = _worst(o, ro, tol_o)
    ok = w_o <= 1.0 and err_lse <= FLASH_FWD_ATOL
    print(f"kernel {name}: fwd o max|d|={err_o:.3e}, worst |d|/limit "
          f"{w_o:.3f} (limit {lim_o}), lse max|d|={err_lse:.3e} (atol "
          f"{FLASH_FWD_ATOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: forward kernel disagrees with _fwd_reference: o "
              f"{err_o} ({w_o} of its limit), lse {err_lse}")

    # the backward kernels and _bwd_blockwise on the same (q, k, v, o, lse, g)
    kq, kk, kv = TA.flash_bwd_kernels(q, k, v, ro, rlse, g, scale, causal)
    torch.cuda.synchronize()
    pq, pk, pv = TA._bwd_blockwise(q, k, v, ro, rlse, g, scale, causal, 128)
    worst = {}
    for n, got, want in (("dq", kq, pq), ("dk", kk, pk), ("dv", kv, pv)):
        top = float(want.float().abs().max())
        worst[n] = (_abs(got, want) / max(top, 1e-30),
                    _worst(got, want, FLASH_BWD_REL * top + 1e-30)
                    if kind == "float32" else _bf16_bwd_worst(got, want))
    lim = (f"{FLASH_BWD_REL} max|g|" if kind == "float32" else
           f"2u |g| + {FLASH_BWD_BF16_SUM_REL} max|g| per element")
    ok = all(w <= 1.0 for _, w in worst.values()) and all(
        bool(torch.isfinite(t.float()).all()) for t in (kq, kk, kv))
    print(f"kernel {name}: bwd max|d|/max|g| (worst |d|/limit) " + ", ".join(
        f"{n} {r:.3e} ({w:.3f})" for n, (r, w) in worst.items())
        + f" (limit {lim}) {'ok' if ok else 'MISMATCH'}")
    if kind == "bfloat16":
        # the second witness: both sides against the float64 arithmetic,
        # under the same limit (recorded, not a check)
        delta = (ro.float() * g.float()).sum(dim=-1)
        ref = _bwd_f64(q, k, v, g, rlse, delta, scale, causal)
        print(f"kernel {name}: bwd against float64 (worst |d|/limit), "
              f"kernel / plain: " + ", ".join(
                  f"{n} {_bf16_bwd_worst(a, r):.3f} / "
                  f"{_bf16_bwd_worst(b, r):.3f}"
                  for n, a, b, r in zip(("dq", "dk", "dv"), (kq, kk, kv),
                                        (pq, pk, pv), ref)))
        del ref
    check(ok, f"{name}: backward kernels disagree with _bwd_blockwise: "
              f"{worst}")
    errs = {"fwd": err_o, "bwd_dkdv": max(_abs(kk, pk), _abs(kv, pv)),
            "bwd_dq": _abs(kq, pq)}
    if label != "train":
        return {}

    # times at the training shape (q, k, v are 16.8 MB each in float32:
    # they stay in the 50 MB L2 between launches, as they do in the step);
    # each backward kernel against its own plain version
    delta = (ro.float() * g.float()).sum(dim=-1).contiguous()
    bwd_args = (q, k, v, g, rlse, delta, scale, True)
    kern_fn = {"fwd": lambda i: TA.flash_fwd_kernel(q, k, v, scale, True),
               "bwd_dkdv": lambda i: TA.flash_bwd_dkdv_kernel(*bwd_args),
               "bwd_dq": lambda i: TA.flash_bwd_dq_kernel(*bwd_args)}
    plain_fn = {
        "fwd": lambda i: TA._fwd_reference(q, k, v, scale, True),
        "bwd_dkdv": lambda i: TA._bwd_dkdv_blockwise(*bwd_args, 128),
        "bwd_dq": lambda i: TA._bwd_dq_blockwise(*bwd_args, 128)}
    ms, dev_ms, plain, plain_dev = {}, {}, {}, {}
    for kern in FLASH_KERNELS:
        ms[kern], dev_ms[kern] = both_ms(kern_fn[kern])
        plain[kern], plain_dev[kern] = both_ms(plain_fn[kern], iters=10)
    B, H = 8, N // 8
    qh, kh, vh, gh = (t.view(B, H, -1, D) for t in (q, k, v, g))
    qr, kr, vr = (t.detach().clone().requires_grad_(True)
                  for t in (qh, kh, vh))

    def sdpa_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_train_fwd(i):
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd(i):
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        torch.autograd.grad(out, (qr, kr, vr), gh)

    lib_fwd, lib_fwd_dev = both_ms(sdpa_fwd)
    both, both_dev = both_ms(sdpa_fwd_bwd, iters=10)
    train_fwd, train_fwd_dev = both_ms(sdpa_train_fwd)
    lib_bwd, lib_bwd_dev = both - train_fwd, both_dev - train_fwd_dev
    recs = {}
    for kern in FLASH_KERNELS:
        bound_ms, bound_by = _flash_bound(kern, N, Tq, Tk, D, causal, dtype)
        # no PyTorch call computes dk/dv alone or dq alone: the backward
        # kernels have no library time of their own; the pair's, SDPA's
        # whole backward, stands beside the pair's own times on the dK/dV
        # record
        recs[kern] = {
            "max_abs_err": errs[kern], "ms": ms[kern],
            "device_ms": dev_ms[kern], "plain_ms": plain[kern],
            "plain_device_ms": plain_dev[kern], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_fwd if kern == "fwd" else None,
            "library_device_ms": lib_fwd_dev if kern == "fwd" else None}
        if kern == "bwd_dkdv":   # the pair's times, once
            recs[kern].update({
                "pair_ms": ms["bwd_dkdv"] + ms["bwd_dq"],
                "pair_device_ms": dev_ms["bwd_dkdv"] + dev_ms["bwd_dq"],
                "library_pair_ms": lib_bwd,
                "library_pair_device_ms": lib_bwd_dev})
        lib = (f"sdpa {lib_fwd:.4f} ms (device {lib_fwd_dev:.4f})"
               if kern == "fwd" else "no library call of its own")
        print(f"kernel flash {kern} {kind} train shape: {ms[kern]:.4f} ms "
              f"(device {dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms "
              f"(device {plain_dev[kern]:.4f}), {lib}, bound "
              f"{bound_ms:.4f} ms ({bound_by}; device time "
              f"{bound_ms / dev_ms[kern]:.3f} of it) on {card}")
    print(f"kernel flash {kind} train shape: the two backward kernels "
          f"together {ms['bwd_dkdv'] + ms['bwd_dq']:.4f} ms (device "
          f"{dev_ms['bwd_dkdv'] + dev_ms['bwd_dq']:.4f}), their plain "
          f"versions {plain['bwd_dkdv'] + plain['bwd_dq']:.4f} ms, sdpa "
          f"backward (dq, dk and dv; forward + backward less forward) "
          f"{lib_bwd:.4f} ms (device {lib_bwd_dev:.4f}) on {card}")
    return recs


def phase_flash_kernels(card: str) -> dict:
    """Every flash case in float32 and bfloat16; returns the
    training-shape records by dtype ("float32", "bfloat16") and kernel for
    the JSON line."""
    dev = torch.device("cuda")
    records = {}
    for label, N, Tq, Tk, D, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            recs = _flash_case(label, N, Tq, Tk, D, causal, dtype, dev, card)
            if label == "train":
                records[str(dtype).replace("torch.", "")] = recs
    return records


def _lstm_bound(kernel: str, T: int, B: int, H: int, n_valid: int,
                whole: bool = True) -> tuple:
    """(bound_ms, bound_by) for one call at this run's shape.  Operations:
    the recurrent product's multiply-adds over the (step, row) pairs the
    mask keeps (``n_valid``; padded steps need none), 2 * n_valid * H * 4H,
    and for the whole backward as much again for du = sum_t h^T dxw.
    Bytes: each input read once and each output written once, float32 --
    forward xw, U, peep, mask in, hs, the carried state hc and cc
    [T+1, B, H], the gates and c_new out (the training path writes them
    for the backward); backward g_hs, g_c, U, peep, mask, gates, c_new, cc
    (and hc for du) in, dxw (and du, dpeep) out."""
    tbh, bh, u = T * B * H, B * H, H * 4 * H
    mask = T * B
    product = 2.0 * n_valid * H * 4 * H
    if kernel == "fwd":
        ops = product
        elems = (4 * tbh + u + 3 * H + mask
                 + tbh + 2 * (tbh + bh) + 4 * tbh + tbh)
    else:
        ops = product * (2 if whole else 1)
        elems = (tbh + bh + u + 3 * H + mask + 4 * tbh + tbh + (tbh + bh)
                 + 4 * tbh)
        if whole:
            elems += (tbh + bh) + u + 3 * H
    t_bytes = 4.0 * elems / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _lstm_inputs(T, B, H, lengths, dev, seed):
    """xw N(0, 1), U N(0, 1/H) (gate pre-activations spread around O(1)),
    peep N(0, 0.5^2), the mask of ``lengths`` and cotangents N(0, 1)."""
    rng = np.random.RandomState(seed)

    def mk(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    mask = torch.from_numpy((np.arange(T)[:, None] < np.asarray(lengths)[
        None, :]).astype(np.float32)).to(dev)
    return (mk((T, B, 4 * H)), mk((H, 4 * H), H ** -0.5), mk((3, H), 0.5),
            mask, mk((T, B, H)), mk((B, H)))


def _lstm_case(label, T, B, H, lengths, peep_on, dev, card, timed,
               route, reverse=False) -> dict:
    """The forward kernel against ``_lstm_scan`` and the backward
    (reverse-recurrence kernel, then du and the peephole sums) against
    ``_lstm_scan_vjp``, on the same inputs on the card, both calls on
    ``route`` (checked by the route counts); with ``reverse`` the mask
    flipped along T, as ``dynamic_lstm(is_reverse=True)`` hands it over
    (each row's padding first); with ``timed`` the times, bounds and
    cuDNN's LSTM beside them.  Returns the records."""
    from paddle_tpu_torch.ops import fused_lstm
    from paddle_tpu_torch.ops import lstm as TL

    xw, u, peep, mask, g_hs, g_c = _lstm_inputs(T, B, H, lengths, dev,
                                                 T + B + H)
    if reverse:
        mask = mask.flip(0).contiguous()
    args = (H, peep_on, LSTM_ACTS)
    name = (f"lstm {label} T={T} B={B} H={H} peepholes={peep_on}"
            + (" reverse" if reverse else ""))
    before = dict(fused_lstm.route_launches)
    hs, hc, cc, gates, cnew = TL.lstm_fwd_kernel(xw, u, peep, mask, *args,
                                                 True)
    torch.cuda.synchronize()
    rhs, rc = TL._lstm_scan(xw, u, peep, mask, *args)
    err_f = max(_abs(hs, rhs), _abs(cc[-1], rc))
    ok = (err_f <= LSTM_FWD_ATOL and bool(torch.isfinite(hs).all())
          and bool(torch.isfinite(cc[-1]).all()))
    print(f"kernel {name}: fwd hs, c_final max|d|={err_f:.3e} (atol "
          f"{LSTM_FWD_ATOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: forward kernel disagrees with _lstm_scan: {err_f}")

    got = TL.lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew,
                           *args)
    torch.cuda.synchronize()
    ran = {k: fused_lstm.route_launches[k] - before[k] for k in before}
    want_ran = {k: 2 if k == route else 0 for k in before}
    print(f"kernel {name}: route launches {ran} (expected {want_ran})")
    check(ran == want_ran, f"{name}: route launches {ran}, expected "
                           f"{want_ran}")
    want = TL._lstm_scan_vjp(xw, u, peep, mask, *args, g_hs, g_c)
    rel, err_b = {}, 0.0
    for n, a, b in zip(("dxw", "du", "dpeep"), got, want):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {n}")
        top = float(b.abs().max())
        rel[n] = _abs(a, b) / max(top, 1e-30)
        err_b = max(err_b, _abs(a, b))
    ok = all(r <= LSTM_BWD_REL for r in rel.values())
    print(f"kernel {name}: bwd max|d|/max|g| " + ", ".join(
        f"{n} {r:.3e}" for n, r in rel.items())
        + f" (limit {LSTM_BWD_REL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: backward disagrees with _lstm_scan_vjp: {rel}")
    if not timed:
        return {}

    ms, dev_ms = {}, {}
    ms["fwd"], dev_ms["fwd"] = both_ms(lambda i: TL.lstm_fwd_kernel(
        xw, u, peep, mask, *args, True))
    ms["bwd"], dev_ms["bwd"] = both_ms(lambda i: TL.lstm_bwd_cuda(
        g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, *args))
    bwd_kernel_ms, bwd_kernel_dev = both_ms(lambda i: TL.lstm_bwd_kernel(
        g_hs, g_c, u, peep, mask, gates, cnew, cc, *args))
    plain, plain_dev = {}, {}
    plain["fwd"], plain_dev["fwd"] = both_ms(
        lambda i: TL._lstm_scan(xw, u, peep, mask, *args), iters=5, warmup=1)
    plain["bwd"], plain_dev["bwd"] = both_ms(lambda i: TL._lstm_scan_vjp(
        xw, u, peep, mask, *args, g_hs, g_c), iters=3, warmup=1)
    # the yardstick: cuDNN's LSTM at the same T, B, H, full length, no
    # peepholes, input width H (text_lstm's second layer), float32 (TF32
    # off); it includes the input projection, so the kernel is shown with
    # that projection's matmul beside it
    torch.backends.cudnn.allow_tf32 = False
    lib = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev)
    xr = x.clone().requires_grad_(True)
    gy = torch.randn(T, B, H, device=dev)
    wx = torch.randn(H, 4 * H, device=dev) * H ** -0.5
    leaves = [xr] + list(lib.parameters())

    def lib_fwd(i):
        with torch.no_grad():
            lib(x)

    def lib_train_fwd(i):
        lib(xr)

    def lib_fwd_bwd(i):
        torch.autograd.grad(lib(xr)[0], leaves, gy)

    lib_ms, lib_dev = both_ms(lib_fwd)
    both, both_dev = both_ms(lib_fwd_bwd, iters=10)
    train_fwd, train_fwd_dev = both_ms(lib_train_fwd)
    lib_bwd_ms, lib_bwd_dev = both - train_fwd, both_dev - train_fwd_dev
    proj_ms = cuda_ms(lambda i: x.reshape(T * B, H) @ wx)
    n_valid = int(mask.sum())
    recs = {}
    for kern in LSTM_KERNELS:
        bound_ms, bound_by = _lstm_bound(kern, T, B, H, n_valid)
        library_ms, library_dev = ((lib_ms, lib_dev) if kern == "fwd"
                                   else (lib_bwd_ms, lib_bwd_dev))
        recs[kern] = {"max_abs_err": err_f if kern == "fwd" else err_b,
                      "lstm_route": route,
                      "ms": ms[kern], "device_ms": dev_ms[kern],
                      "plain_ms": plain[kern],
                      "plain_device_ms": plain_dev[kern],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms,
                      "library_device_ms": library_dev}
        print(f"kernel lstm {kern} {label} shape ({route}): {ms[kern]:.4f} ms "
              f"(device {dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms "
              f"(device {plain_dev[kern]:.4f}), cudnn {library_ms:.4f} ms "
              f"(device {library_dev:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}; share {bound_ms / dev_ms[kern]:.3f} of the "
              f"device time; {n_valid} of {T * B} steps valid) on {card}")
    kb_ms, kb_by = _lstm_bound("bwd", T, B, H, n_valid, whole=False)
    print(f"kernel lstm {label} shape: the reverse-recurrence kernel alone "
          f"{bwd_kernel_ms:.4f} ms (device {bwd_kernel_dev:.4f}; bound "
          f"{kb_ms:.4f} ms, {kb_by}, share {kb_ms / bwd_kernel_dev:.3f}), "
          f"du matmul and peephole sums the rest "
          f"of the backward; input projection [{T * B}, {H}] x [{H}, "
          f"{4 * H}] {proj_ms:.4f} ms, projection + forward kernel "
          f"{proj_ms + ms['fwd']:.4f} ms vs cudnn forward {lib_ms:.4f} ms "
          f"(full length, no mask); cudnn backward is forward + backward "
          f"less forward, with grad-enabled weights, on {card}")
    return recs


def _lstm_layer_case(card) -> None:
    """dynamic_lstm(is_reverse=True, use_peepholes=True) after an fc, in a
    program run by the card's Executor (kernels) and the CPU's (plain
    versions) from the same weights, on lengths {1, T, 0}: hidden, last
    cell and the three weight gradients compared; the card run launches
    each LSTM kernel once, on the persistent route."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import fused_lstm

    T, D, H = 37, 24, 40
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [T, D])
        lengths = L.data("lengths", [-1], dtype="int32",
                         append_batch_size=False)
        proj = L.fc(x, 4 * H, num_flatten_dims=2, bias_attr=False)
        hs, c = L.dynamic_lstm(proj, lengths, H, use_peepholes=True,
                               is_reverse=True)
        loss = L.sums([L.mean(L.square(hs)), L.mean(c)])
        pg = fluid.backward.append_backward(loss)
    rng = np.random.RandomState(5)
    weights = {"fc_w_0": rng.standard_normal((D, 4 * H)) / np.sqrt(D),
               "dynamic_lstm_w_0": rng.standard_normal((H, 4 * H))
               / np.sqrt(H),
               "dynamic_lstm_b_0": rng.standard_normal(7 * H) * 0.5}
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    feed = {"x": rng.standard_normal((3, T, D)).astype(np.float32),
            "lengths": np.array([1, T, 0], np.int32)}
    fetch = [hs, c] + [g for _, g in pg]
    outs = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.load_scope(weights, main, scope, device=dev)
        before = dict(fused_lstm.launches), dict(fused_lstm.route_launches)
        outs[dev] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ran = ({k: fused_lstm.launches[k] - before[0][k] for k in before[0]},
               {k: fused_lstm.route_launches[k] - before[1][k]
                for k in before[1]})
        want = (({"fwd": 1, "bwd": 1}, {"persistent": 2, "step": 0})
                if dev == "cuda" else
                ({"fwd": 0, "bwd": 0}, {"persistent": 0, "step": 0}))
        check(ran == want, f"lstm layer case on {dev}: launches and route "
                           f"launches {ran}, expected {want}")
    name = f"lstm layer dynamic_lstm(is_reverse) T={T} B=3 H={H} lengths 1,T,0"
    errs = []
    for i, (v, a, b) in enumerate(zip(fetch, outs["cuda"], outs["cpu"])):
        check(np.isfinite(a).all(), f"{name}: non-finite {v.name}")
        d = float(np.abs(a - b).max())
        lim = LSTM_FWD_ATOL if i < 2 else LSTM_BWD_REL * float(
            np.abs(b).max())
        errs.append((v.name, d, lim))
    ok = all(d <= lim for _, d, lim in errs)
    print(f"kernel {name}: card vs CPU " + ", ".join(
        f"{n} {d:.3e} (limit {lim:.1e})" for n, d, lim in errs)
        + f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: card and CPU disagree: {errs}")
    check(np.all(outs["cuda"][0][2] == 0) and np.all(
        outs["cuda"][0][0][1:] == 0), f"{name}: padded steps not zero")


def phase_lstm_kernels(card: str) -> tuple:
    """The LSTM cases; returns the full-width records by kernel for the
    JSON line, and the SRL shape's."""
    from paddle_tpu_torch import resolve_device

    dev = resolve_device()         # float32 matmuls in full float32
    T, B, H = LSTM_SHAPE
    lengths = np.random.RandomState(0).randint(T // 2, T + 1, B)
    recs = _lstm_case("train", T, B, H, lengths, False, dev, card, True,
                      "persistent")
    _lstm_case("peepholes", T, B, H, lengths, True, dev, card, False,
               "persistent")
    _lstm_layer_case(card)
    lengths = np.random.RandomState(1).randint(T // 2, T + 1,
                                               LSTM_STEP_BATCH)
    _lstm_case("step", T, LSTM_STEP_BATCH, H, lengths, False, dev, card,
               False, "step")
    T, B, H = LSTM_SRL_SHAPE
    lengths = np.random.RandomState(2).randint(1, T + 1, B)
    lengths[:2] = (1, T)
    srl = _lstm_case("srl", T, B, H, lengths, True, dev, card, True,
                     "persistent")
    _lstm_case("srl", T, B, H, lengths, True, dev, card, False,
               "persistent", reverse=True)
    return recs, srl



def _dropout_bound(n: int, dtype) -> tuple:
    """(bound_ms, bound_by) for one dropout launch over n elements: x read
    and y written once, against DROPOUT_INT_OPS integer operations an
    element at INT_ISSUE_PER_S."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 2 * n * itemsize / HBM_BYTES_PER_S
    t_ops = n * DROPOUT_INT_OPS / INT_ISSUE_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _dropout_case(shape, dtype, p: float, step: int, tag: int, dev) -> int:
    """The forward and backward kernels against their plain versions at one
    (shape, dtype, p, step word, tag), bitwise: the mask (the forward of
    ones), y and dx, with the step given as an immediate and as the staged
    int32 device word; the kept fraction of the mask within 6 sigma of
    1 - p.  Returns the elements kept."""
    from paddle_tpu_torch.ops import dropout as dmod

    gen = torch.Generator().manual_seed(step % 1000 + tag)
    x = torch.randn(shape, generator=gen).to(dev, dtype)
    dy = torch.randn(shape, generator=gen).to(dev, dtype)
    ones = torch.ones(shape, dtype=dtype, device=dev)
    word = torch.from_numpy(np.array([step & 0xFFFFFFFF], np.uint32)
                            .view(np.int32)).to(dev)
    label = (f"dropout {tuple(shape)} {str(dtype)[6:]} p={p} step={step} "
             f"tag={tag}")
    for how, s in (("immediate", step), ("staged", word)):
        key = dmod.ThreefryKey(DROPOUT_SEED, s, tag)
        mask = dmod.dropout_fwd_kernel(ones, key, p)
        y = dmod.dropout_fwd_kernel(x, key, p)
        dx = dmod.dropout_bwd_kernel(dy, key, p)
        torch.cuda.synchronize()
        want_mask = dmod.keep_mask(key, shape, p, dev).to(dtype)
        for name, got, want in (
                ("mask", mask, want_mask),
                ("y", y, dmod.dropout_reference(x, key, p)),
                ("dx", dx, dmod.dropout_reference(dy, key, p))):
            check(got.dtype == want.dtype and torch.equal(
                got.view(torch.int16 if dtype == torch.bfloat16
                         else torch.int32),
                want.view(torch.int16 if dtype == torch.bfloat16
                          else torch.int32)),
                  f"{label} ({how} step): the kernel's {name} differs from "
                  f"the plain version's")
    n = int(np.prod(shape))
    kept = int(mask.float().sum())
    sigma = (p * (1 - p) / n) ** 0.5
    check(abs(kept / n - (1 - p)) <= 6 * sigma,
          f"{label}: kept fraction {kept / n} against {1 - p} (6 sigma "
          f"{6 * sigma:.2e})")
    return kept


def phase_dropout_kernels(card: str) -> dict:
    """The dropout kernels against their plain versions, bitwise, over
    DROPOUT_CASES x p x step words x tags; then both kernels timed at the
    LM's [8, 1024, 512] in float32 and bfloat16 (p = 0.1), beside the plain
    version and F.dropout (a yardstick only: Philox, another mask, scaled
    by 1 / (1 - p)); returns the records by dtype and kernel."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import dropout as dmod

    dev = torch.device("cuda")
    n_cases = 0
    for shape in DROPOUT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for p in DROPOUT_PS:
                for step in DROPOUT_STEPS:
                    for tag in DROPOUT_TAGS:
                        _dropout_case(shape, dtype, p, step, tag, dev)
                        n_cases += 1
    regs = [f"{name} {r} registers, {sp} bytes spilled" for name, r, sp in
            _ptxas_report(_build.build_logs.get("dropout.cu", ""))]
    print(f"kernel dropout: {n_cases} cases (shapes {DROPOUT_CASES}, "
          f"float32 and bfloat16, p {DROPOUT_PS}, step words "
          f"{DROPOUT_STEPS}, tags {DROPOUT_TAGS}, seed {DROPOUT_SEED}; each "
          f"with the step immediate and staged): mask, y and dx bitwise "
          f"equal to the plain version, kept fractions within 6 sigma; "
          f"ptxas: {'; '.join(regs) or 'not built in this process'}")
    shape, p = DROPOUT_CASES[0], DROPOUT_PS[0]
    n = int(np.prod(shape))
    key = dmod.ThreefryKey(DROPOUT_SEED, 3, 5)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, device=dev).to(dtype)
        fns = {"fwd": lambda i: dmod.dropout_fwd_kernel(x, key, p),
               "bwd": lambda i: dmod.dropout_bwd_kernel(x, key, p)}
        plain, plain_dev = both_ms(
            lambda i: dmod.dropout_reference(x, key, p), iters=5)
        lib, lib_dev = both_ms(lambda i: F.dropout(x, p, training=True))
        bound_ms, bound_by = _dropout_bound(n, dtype)
        kind = str(dtype).replace("torch.", "")
        records[kind] = {}
        for kern, fn in fns.items():
            ms, dev_ms = both_ms(fn)
            records[kind][kern] = {
                "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain, "plain_device_ms": plain_dev,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib, "library_device_ms": lib_dev,
                "library": "F.dropout (Philox, another mask, rescaled by "
                           "1 / (1 - p)): a yardstick only"}
            print(f"kernel dropout {kern} {kind} {tuple(shape)} p={p}: "
                  f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms "
                  f"(device {plain_dev:.4f}), F.dropout {lib:.4f} ms "
                  f"(device {lib_dev:.4f}; another mask), bound "
                  f"{bound_ms:.4f} ms ({bound_by}; device time "
                  f"{bound_ms / dev_ms:.3f} of it) on {card}")
    return records

def _ttft(handles) -> tuple:
    t = np.array([h.t_first_token - h.t_submit for h in handles]) * 1e3
    return float(np.percentile(t, 50)), float(np.percentile(t, 99))


def _teacher_forced(eng, handles) -> tuple:
    """(agreeing, total): the dense lm_forward oracle (no kernel) over
    prompt + emitted tokens; its argmax at each generated position against
    the emitted token."""
    agree = total = 0
    for h in handles:
        toks = np.asarray(h.tokens, np.int32)
        hist = torch.from_numpy(np.concatenate([h.prompt, toks]))
        x, _ = eng.model(hist.to(eng.device)[None])
        P = h.prompt.size
        pred = eng.model.logits(x[0, P - 1:P - 1 + toks.size]).argmax(-1)
        agree += int((pred.cpu().numpy() == toks).sum())
        total += int(toks.size)
    return agree, total


def _serve(eng, reqs, spec: bool):
    """One scheduler pass over ``reqs`` [(prompt, max_gen, SamplingParams)];
    returns (handles, scheduler, wall seconds, kernel launches, step
    dispatches by window width).  The kernel's count and the engine's
    dispatch and replay counts are set to 0 just before the pass and read
    just after it, so they are this pass's own."""
    from paddle_tpu_torch import ContinuousScheduler
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    sched = ContinuousScheduler(eng, spec=spec)
    torch.cuda.synchronize()
    paged_attention.launches = 0
    for counter in (eng.step_dispatches, eng.prefill_dispatches,
                    eng.replays):
        counter.clear()
    t0 = time.perf_counter()
    handles = [sched.submit(p, g, sampling=sp) for p, g, sp in reqs]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (handles, sched, wall, paged_attention.launches,
            dict(sorted(eng.step_dispatches.items())))


def _check_pass(name, eng, handles, sched, launches, dispatches):
    for h in handles:
        check(h.done.is_set() and h.error is None,
              f"{name}: request {h.id} ended with {h.error!r}")
        check(len(h.tokens) > 0, f"{name}: request {h.id} emitted nothing")
    acct = sched.check_block_accounting()
    check(acct["leaked"] == 0 and acct["occupied"] == 0
          and eng.pool.blocks_free == eng.pool.n_blocks,
          f"{name}: blocks leaked: {acct}, free {eng.pool.blocks_free}")
    n_layers = eng.model.n_layers
    n_disp = sum(dispatches.values())
    check(launches == n_layers * n_disp and n_disp > 0,
          f"{name}: {launches} kernel launches for {n_disp} step "
          f"dispatches x {n_layers} layers")
    # every dispatch a graph replay: steps by window, prefills by bucket
    replayed = {}
    for key, n in eng.replays.items():
        replayed[key[:2]] = replayed.get(key[:2], 0) + n
    want = {("step", w): n for w, n in dispatches.items()}
    want.update({("prefill", pb): n
                 for pb, n in eng.prefill_dispatches.items()})
    check(replayed == want and sum(eng.prefill_dispatches.values())
          >= sched.counters["prefill_inserts"] > 0,
          f"{name}: graph replays {replayed} != dispatches {want}")
    return sum(eng.replays.values())


SERVE_SAMPLED = (1, 5, 9, 13)  # the mixed pass's sampled requests


def _mixed_reqs(rng) -> list:
    """The serve phase's W=1 stream: 16 prompts of 16-512 tokens, 32-64
    new tokens each, SERVE_SAMPLED of them with a sampling policy."""
    from paddle_tpu_torch import SamplingParams

    V = LM_CFG["vocab_size"]
    reqs = []
    for i in range(16):
        p = rng.randint(2, V, rng.randint(16, 513)).astype(np.int32)
        g = int(rng.randint(32, 65))
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=1000 + i)
              if i in SERVE_SAMPLED else SamplingParams())
        reqs.append((p, g, sp))
    return reqs


def phase_serve(card: str) -> tuple:
    from paddle_tpu_torch import (ContinuousDecodeEngine, SamplingParams,
                                  init_lm_params)

    V = LM_CFG["vocab_size"]
    params = init_lm_params(0, **LM_CFG)
    eng = ContinuousDecodeEngine(params, **ENGINE_CFG, **LM_CFG)
    greedy = SamplingParams()
    windows = sorted({1, ENGINE_CFG["spec_window"]})
    t0 = time.perf_counter()
    n_sig = eng.warm()
    warm_s = time.perf_counter() - t0
    traces = eng.trace_count()
    print(f"serve warm: {n_sig} signatures prepared as CUDA graphs in "
          f"{warm_s:.1f} s: prefill at prompt buckets {eng.prompt_buckets}, "
          f"the step at W in {windows} greedy and with a policy")
    check(n_sig == traces == len(eng.prompt_buckets) + 2 * len(windows),
          f"warm prepared {n_sig} signatures (trace count {traces})")

    # the W=1 path: its counts are this pass's alone (see _serve)
    rng = np.random.RandomState(1)
    sampled_idx = set(SERVE_SAMPLED)
    reqs = _mixed_reqs(rng)
    handles, sched, wall, launches, dispatches = _serve(eng, reqs, False)
    replays = _check_pass("mixed pass", eng, handles, sched, launches,
                          dispatches)
    check(set(dispatches) == {1},
          f"mixed pass dispatched windows {dispatches}, expected W=1 only")
    paths = {"w1_mixed_pass": {"launches": launches,
                               "dispatches_by_window": dispatches,
                               "graph_replays": replays}}
    greedy_h = [h for i, h in enumerate(handles) if i not in sampled_idx]
    agree, total = _teacher_forced(eng, greedy_h)
    rate = agree / total
    tokens = sum(len(h.tokens) for h in handles)
    steps = sched.counters["steps"]
    p50, p99 = _ttft(handles)
    print(f"serve mixed: {len(handles)} requests, {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tok/s, {steps} steps, mean "
          f"step {wall / steps * 1e3:.2f} ms, TTFT p50 {p50:.1f} ms p99 "
          f"{p99:.1f} ms, preemptions {sched.counters['preemptions']}, "
          f"kernel launches {launches} = {eng.model.n_layers} x "
          f"{sum(dispatches.values())} dispatches {dispatches}, "
          f"{replays} graph replays = step and prefill dispatches, on "
          f"{card}")
    print(f"serve mixed: teacher-forced agreement {agree}/{total} = "
          f"{rate:.4f} (floor 0.98)")
    check(rate >= 0.98, f"teacher-forced agreement {rate} < 0.98")

    # sampled streams are a pure function of (seed, token index): the same
    # sampled requests served twice give the same streams (these reruns are
    # checks, not a path: their counts are not reported)
    sreqs = [reqs[i] for i in sorted(sampled_idx)]
    runs = [_serve(eng, sreqs, False)[0] for _ in range(2)]
    same = all(a.tokens == b.tokens for a, b in zip(*runs))
    print(f"serve sampled: {len(sreqs)} sampled streams repeat "
          f"{'identically' if same else 'DIFFERENTLY'}")
    check(same, "sampled streams differ between two identical runs")

    # the W=4 path, speculative pass: repetitive prompts make n-gram drafts,
    # verified in W=4 steps (steps with no draft still run at W=1)
    sreqs = []
    for i in range(8):
        motif = rng.randint(2, V, rng.randint(6, 20)).astype(np.int32)
        p = np.tile(motif, -(-int(rng.randint(64, 257)) // motif.size))
        sreqs.append((p.astype(np.int32), int(rng.randint(32, 65)), greedy))
    handles, sched, wall, launches, dispatches = _serve(eng, sreqs, True)
    replays = _check_pass("spec pass", eng, handles, sched, launches,
                          dispatches)
    W = ENGINE_CFG["spec_window"]
    check(sched.counters["spec_proposed"] > 0 and dispatches.get(W, 0) > 0,
          f"speculative pass dispatched {dispatches}: the W={W} path did not "
          f"run")
    paths["w4_spec_pass"] = {"launches": launches,
                             "dispatches_by_window": dispatches,
                             "graph_replays": replays}
    agree_s, total_s = _teacher_forced(eng, handles)
    rate_s = agree_s / total_s
    tokens_s = sum(len(h.tokens) for h in handles)
    steps_s = sched.counters["steps"]
    p50, p99 = _ttft(handles)
    print(f"serve spec W=4: {len(handles)} requests, {tokens_s} tokens in "
          f"{wall:.3f} s = {tokens_s / wall:.1f} tok/s, {steps_s} steps, "
          f"mean step {wall / steps_s * 1e3:.2f} ms, TTFT p50 {p50:.1f} ms "
          f"p99 {p99:.1f} ms, accepted {sched.counters['spec_accepted']}/"
          f"{sched.counters['spec_proposed']} drafts, kernel launches "
          f"{launches} = {eng.model.n_layers} x {sum(dispatches.values())} "
          f"dispatches {dispatches}, {replays} graph replays, "
          f"teacher-forced {agree_s}/{total_s} = {rate_s:.4f}, on {card}")
    check(rate_s >= 0.98, f"spec teacher-forced agreement {rate_s} < 0.98")

    # a replay against the step's body run eagerly on the same staged
    # buffers, on the arena the passes populated (restored between the
    # two): the graph runs the same kernels on the same inputs
    for w in windows:
        for policy in (False, True):
            _graph_against_body(eng, w, policy, rng)
    check(eng.trace_count() == traces,
          f"serving prepared {eng.trace_count() - traces} signatures after "
          f"warm")
    return paths, eng


# the serve extras phase (PERF.md section 2): the prefix pass's system prompt
# (EXTRAS_SYS tokens, 24 blocks) and requests; the fork pass's beam (K
# EXTRAS_BEAM on an EXTRAS_BEAM_PROMPT-token prompt, EXTRAS_BEAM_GEN tokens,
# eos EXTRAS_EOS) beside EXTRAS_MATES greedy streams shorter than a block
# (never cached), and a parallel-n request (n EXTRAS_N); the migration
# pass's streams drained after EXTRAS_DRAIN_STEPS steps; the dense pass's
# batch and lengths
EXTRAS_SYS, EXTRAS_REQS = 384, 16
EXTRAS_BEAM, EXTRAS_BEAM_PROMPT, EXTRAS_BEAM_GEN, EXTRAS_EOS = 4, 64, 32, 2
EXTRAS_MATES, EXTRAS_N = 4, 4
EXTRAS_MIGRATE, EXTRAS_DRAIN_STEPS = 8, 10
EXTRAS_DENSE = (8, 64, 64)     # prompts, prompt length, generated
BEAM_SCORE_RTOL = 1e-4


def _match_rate(a, b) -> float:
    """Greedy token-match rate of streams ``a`` against ``b``."""
    agree = total = 0
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        n = min(x.size, y.size)
        agree += int((x[:n] == y[:n]).sum())
        total += int(x.size)
    return agree / max(total, 1)


def _blake2b_chain(tokens, block_size: int) -> list:
    """The prefix cache's digest recipe, written out here on its own:
    blake2b of the parent digest (the float32 root first) and each full
    block's int32 bytes, 16-byte digests."""
    import hashlib

    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    prev, out = b"paddle-tpu-prefix-root", []
    for i in range(toks.size // block_size):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class _ExtrasPass:
    """One pass of the serve extras phase: every count the pass is checked
    by set to 0 on entry (the paged kernel's launches, the engines'
    dispatches and replays), read on exit; checks launches = n_layers x
    step dispatches and replays = dispatches; prints the pass's line."""

    def __init__(self, name: str, card: str, *engines):
        from paddle_tpu_torch.ops.paged_attention import paged_attention

        self.name, self.card, self.engines = name, card, engines
        self.kernel = paged_attention
        self.handles, self.scheds = [], []
        self.tokens = 0   # tokens emitted outside a scheduler (dense)

    def __enter__(self):
        torch.cuda.synchronize()
        self.kernel.launches = 0
        for eng in self.engines:
            for c in ("step_dispatches", "prefill_dispatches", "replays",
                      "dispatches"):
                if hasattr(eng, c):
                    getattr(eng, c).clear()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, *exc):
        if kind is not None:
            return False
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        launches, steps, disp, replays, n_layers = self.kernel.launches, 0, \
            0, 0, 0
        by_w = collections.Counter()
        for eng in self.engines:
            if hasattr(eng, "step_dispatches"):
                by_w.update(eng.step_dispatches)
                steps += sum(eng.step_dispatches.values())
                disp += sum(eng.step_dispatches.values()) + sum(
                    eng.prefill_dispatches.values())
            else:
                disp += sum(eng.dispatches.values())
            replays += sum(eng.replays.values())
            n_layers = eng.model.n_layers
        check(launches == n_layers * steps,
              f"serve extras {self.name}: {launches} paged launches for "
              f"{steps} step dispatches x {n_layers} layers")
        check(replays == disp and disp > 0,
              f"serve extras {self.name}: {replays} graph replays for "
              f"{disp} dispatches")
        tokens = self.tokens + sum(len(h.tokens) for h in self.handles)
        n_steps = sum(s.counters["steps"] for s in self.scheds) or disp
        counters = {}
        for s in self.scheds:
            for k, v in s.counters.items():
                counters[k] = counters.get(k, 0) + v
        ttft = ""
        timed = [h for h in self.handles if h.t_first_token is not None]
        if timed:
            p50, p99 = _ttft(timed)
            ttft = f", TTFT p50 {p50:.1f} ms p99 {p99:.1f} ms"
        step_ms = wall / n_steps * 1e3 if n_steps else float("nan")
        print(f"serve extras {self.name}: {len(self.handles)} requests, "
              f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s, "
              f"{n_steps} steps, mean step {step_ms:.2f} ms{ttft}; "
              f"paged launches {launches} = {n_layers} x {steps} step "
              f"dispatches {dict(sorted(by_w.items()))}, {replays} graph "
              f"replays = {disp} dispatches; "
              f"counters {counters}; on {self.card}", flush=True)
        self.record = {"launches": launches, "step_dispatches": steps,
                       "graph_replays": replays, "wall_s": wall,
                       "tokens": tokens}
        if by_w:
            self.record["dispatches_by_window"] = dict(sorted(by_w.items()))
        return False


def _beams_against_dense(label, beams, scores, d_tok, d_sc,
                         what: str = "the dense generate") -> None:
    """The near-tie rule: ranked beams equal to ``what``'s (the dense
    path's) wherever its competing scores lie further apart than twice
    the largest score difference; scores within BEAM_SCORE_RTOL
    relative."""
    scores, d_sc = np.asarray(scores, np.float64), np.asarray(d_sc,
                                                              np.float64)
    diff = float(np.abs(scores - d_sc).max())
    rel = float((np.abs(scores - d_sc) / np.abs(d_sc)).max())
    flips = []
    for k in range(len(beams)):
        if list(beams[k]) == [int(t) for t in d_tok[k]]:
            continue
        gap = min(abs(d_sc[k] - d_sc[j]) for j in range(len(beams)) if j != k)
        flips.append((k, gap))
        check(gap <= 2 * diff,
              f"{label}: beam {k} differs from {what}'s where "
              f"its competing scores lie {gap:.3e} apart, over twice the "
              f"largest score difference {diff:.3e}")
    print(f"{label}: beams against {what}: largest score "
          f"difference {diff:.3e} ({rel:.3e} relative), beams that differ "
          f"(rank, gap to the nearest competing score): {flips}")
    check(rel <= BEAM_SCORE_RTOL,
          f"{label}: beam scores {rel:.3e} relative from {what}'s, over "
          f"{BEAM_SCORE_RTOL}")


def _dense_generate_beams(params, prompt, card_dtype="float32"):
    """The port's own ``models.transformer.generate`` program op on the
    card: (tokens [K, G], scores [K], lens [K]) for one prompt."""
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        pv = fluid.layers.data("prompt", [prompt.size], dtype="int32")
        outs = fluid.models.transformer.generate(
            pv, LM_CFG["vocab_size"], max_len=LM_CFG["max_len"],
            eos_id=EXTRAS_EOS, d_model=LM_CFG["d_model"],
            n_heads=LM_CFG["n_heads"], n_layers=LM_CFG["n_layers"],
            d_ff=LM_CFG["d_ff"], beam_size=EXTRAS_BEAM,
            max_gen=EXTRAS_BEAM_GEN, decode_dtype=card_dtype)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    fluid.load_scope(params, main, scope)
    t, sc, ln = exe.run(main, feed={"prompt": prompt[None]},
                        fetch_list=list(outs), scope=scope)
    return t[0], sc[0], ln[0]


def phase_serve_extras(card: str, cold_eng) -> dict:
    """The prefix cache, forks, migration and the dense engine on the
    serve phase's LM and engine configuration (see the module docstring).
    ``cold_eng`` is the serve phase's warmed engine, without a prefix
    cache."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import (ContinuousDecodeEngine, ContinuousScheduler,
                                  DecodeEngine, GenerationMigrated,
                                  SamplingParams, init_lm_params)
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.tools.decode_profile import _kernel_us

    V, Bs = LM_CFG["vocab_size"], ENGINE_CFG["block_size"]
    params = init_lm_params(0, **LM_CFG)
    eng = ContinuousDecodeEngine(params, prefix_cache=True, **ENGINE_CFG,
                                 **LM_CFG)
    t0 = time.perf_counter()
    n_sig = eng.warm()
    traces = eng.trace_count()
    print(f"serve extras warm: {n_sig} signatures in "
          f"{time.perf_counter() - t0:.1f} s, prefix cache on; pool "
          f"{eng.pool.arena_bytes} bytes, {eng.slots_resident_per_gib()} "
          f"full slots per GiB")
    rng = np.random.RandomState(22)
    paths = {}

    def serve(sched, reqs, stage=None):
        hs = [sched.submit(p, g, **kw) for p, g, kw in reqs]
        sched.run_until_idle()
        for h in hs:
            check(h.done.is_set() and h.error is None,
                  f"serve extras: request {h.id} ended with {h.error!r}")
        if stage is not None:
            stage.handles += hs
            stage.scheds.append(sched)
        return hs

    def clean(sched, label):
        acct = sched.check_block_accounting()
        check(acct["leaked"] == 0 and acct["occupied"] == 0
              and acct.get("referenced", 0) == 0,
              f"serve extras {label}: block accounting {acct}")
        return acct

    # ---- 1. prefix pass: a shared system prompt, then the same requests
    # on the serve phase's engine without a cache
    sys_prompt = rng.randint(2, V, EXTRAS_SYS).astype(np.int32)
    reqs = [(np.concatenate([sys_prompt, rng.randint(
        2, V, int(rng.randint(16, 129))).astype(np.int32)]),
        int(rng.randint(32, 65)), {}) for _ in range(EXTRAS_REQS)]
    with _ExtrasPass("prefix hot", card, eng) as hot:
        hot_h = serve(ContinuousScheduler(eng), reqs, hot)
    pc = dict(eng.prefix.counters)
    acct = clean(hot.scheds[0], "prefix hot")
    check(pc["hits"] > 0 and pc["hit_tokens"] > 0,
          f"serve extras prefix hot: no block mapped from the cache: {pc}")
    with _ExtrasPass("prefix cold", card, cold_eng) as cold:
        cold_h = serve(ContinuousScheduler(cold_eng), reqs, cold)
    clean(cold.scheds[0], "prefix cold")
    print(f"serve extras prefix: {pc['hits']} hits, {pc['misses']} misses, "
          f"blocks mapped from the cache {pc['hit_tokens'] // Bs}, prefill "
          f"tokens saved {pc['hit_tokens']} of "
          f"{sum(p.size for p, _, _ in reqs)}; cached blocks "
          f"{acct['cached']}, free {acct['free']}")
    rates = {}
    for label, hs, e in (("hot", hot_h, eng), ("cold", cold_h, cold_eng)):
        agree, total = _teacher_forced(e, hs)
        rates[label] = agree / total
    hit_cold = _match_rate([h.tokens for h in hot_h],
                           [h.tokens for h in cold_h])
    print(f"serve extras prefix: teacher-forced agreement hot "
          f"{rates['hot']:.4f}, cold {rates['cold']:.4f} (floor 0.98); hit "
          f"streams against cold streams {hit_cold:.4f} (floor 0.98)")
    check(min(rates.values()) >= 0.98,
          f"serve extras prefix: teacher-forced agreement {rates}")
    check(hit_cold >= 0.98,
          f"serve extras prefix: hit streams match cold ones at {hit_cold}")
    for h in hot_h:
        n, digs = h._digest_memo
        want = _blake2b_chain(np.concatenate(
            [h.prompt, np.asarray(h.tokens, np.int32)])[:n], Bs)
        check(digs == want, f"serve extras prefix: request {h.id}'s "
              f"digests differ from the blake2b recomputation")
    sys_digs = _blake2b_chain(sys_prompt, Bs)
    check(all(d in eng.prefix._by_digest for d in sys_digs),
          "serve extras prefix: the system prompt's blocks are not cached")
    # copy-on-write: a request diverging inside the last shared block
    shared = [eng.prefix._by_digest[d] for d in sys_digs]
    k0, v0 = eng.pool.k[shared].clone(), eng.pool.v[shared].clone()
    cows = eng.prefix.counters["cow_copies"]
    div = np.concatenate([sys_prompt[:EXTRAS_SYS - 8],
                          rng.randint(2, V, 40).astype(np.int32)])
    serve(ContinuousScheduler(eng), [(div, 16, {})])
    same = torch.equal(eng.pool.k[shared], k0) and torch.equal(
        eng.pool.v[shared], v0)
    print(f"serve extras prefix: a divergent continuation left the "
          f"{len(shared)} shared blocks' K/V bytes "
          f"{'unchanged' if same else 'CHANGED'}; copy-on-write copies "
          f"{eng.prefix.counters['cow_copies'] - cows}")
    check(same and eng.prefix.counters["cow_copies"] > cows,
          "serve extras prefix: a shared block changed under copy-on-write")
    paths["extras prefix hot"] = hot.record
    paths["extras prefix cold"] = cold.record

    # ---- 2. fork pass: a beam group joining beside greedy streams
    mates = [(rng.randint(2, V, int(rng.randint(4, Bs))).astype(np.int32),
              64, {}) for _ in range(EXTRAS_MATES)]
    solo = serve(ContinuousScheduler(eng), mates)
    bp = rng.randint(3, V, EXTRAS_BEAM_PROMPT).astype(np.int32)
    beam_kw = {"eos_id": EXTRAS_EOS,
               "sampling": SamplingParams(beam=EXTRAS_BEAM)}
    with _ExtrasPass("fork", card, eng) as fork:
        sched = ContinuousScheduler(eng)
        gs = [sched.submit(p, g) for p, g, _ in mates]
        for _ in range(3):
            sched.step()
        hb = sched.submit(bp, EXTRAS_BEAM_GEN, **beam_kw)
        sched.run_until_idle()
        fork.handles += gs + [hb]
        fork.scheds.append(sched)
    check(hb.error is None, f"serve extras fork: beam failed {hb.error!r}")
    c = sched.counters
    check(c["forks"] > 0 and c["fork_cow_blocks"] > 0
          and c["beam_groups"] == 1,
          f"serve extras fork: forks {c['forks']}, copy-on-write blocks "
          f"{c['fork_cow_blocks']}")
    same = all(a.tokens == b.tokens for a, b in zip(solo, gs))
    print(f"serve extras fork: {EXTRAS_MATES} greedy batch-mates "
          f"{'equal' if same else 'DIFFER from'} the same requests served "
          f"alone; forks {c['forks']}, copy-on-write blocks "
          f"{c['fork_cow_blocks']}, private {c['fork_private']}")
    check(same, "serve extras fork: the beam group changed its batch-mates' "
                "streams")
    d_tok, d_sc, d_len = _dense_generate_beams(params, bp)
    _beams_against_dense("serve extras fork", hb.beams, hb.beam_scores,
                         d_tok, d_sc)
    # the beam alone: its wall time on the host clock with no profiler
    # on, then its device time from a second, profiled run of the same
    # request (the profiler's own host cost stays out of the wall time)
    alone = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone += serve(ContinuousScheduler(eng), [(bp, EXTRAS_BEAM_GEN,
                                               beam_kw)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        alone += serve(ContinuousScheduler(eng), [(bp, EXTRAS_BEAM_GEN,
                                                   beam_kw)])
        torch.cuda.synchronize()
    dev_ms = sum(_kernel_us(e) for e in prof.key_averages()) / 1e3
    print(f"serve extras beam alone: wall {host_s * 1e3:.1f} ms (host "
          f"clock, no profiler), device {dev_ms:.1f} ms (torch.profiler, "
          f"every kernel, a second run), {EXTRAS_BEAM_GEN} iterations; "
          f"beams equal to the joined run's: "
          f"{all(h.beams == hb.beams for h in alone)}")
    # parallel-n: primed once, then served twice from the same cache state
    npr = rng.randint(2, V, 40).astype(np.int32)
    n_kw = {"sampling": SamplingParams(temperature=0.8, seed=2207,
                                       n=EXTRAS_N)}
    runs = []
    for _ in range(3):
        root = serve(ContinuousScheduler(eng), [(npr, 48, n_kw)])[0]
        runs.append([list(b.result(1)) for b in root.branches])
    distinct = len({tuple(t) for t in runs[2]})
    print(f"serve extras parallel-n: n={EXTRAS_N} served twice "
          f"{'identically' if runs[1] == runs[2] else 'DIFFERENTLY'}, "
          f"{distinct} distinct branches")
    check(runs[1] == runs[2] and distinct == EXTRAS_N,
          "serve extras parallel-n: branches not repeatable or not distinct")
    # the serving.fork fault: private copies, the same beams
    faults.inject("serving.fork", RuntimeError("fork path down"))
    try:
        fs = ContinuousScheduler(eng)
        hf = serve(fs, [(bp, EXTRAS_BEAM_GEN, beam_kw)])[0]
        fired = faults.fired("serving.fork")
    finally:
        faults.clear()
    c = fs.counters
    print(f"serve extras fork fault: fired {fired}, private forks "
          f"{c['fork_private']}, copy-on-write blocks {c['fork_cow_blocks']}")
    check(fired > 0 and c["fork_private"] > 0 and c["fork_cow_blocks"] == 0,
          f"serve extras fork fault: {c}")
    _beams_against_dense("serve extras fork fault", hf.beams,
                         hf.beam_scores, np.asarray(hb.beams),
                         np.asarray(hb.beam_scores),
                         what="the copy-on-write run")
    clean(fs, "fork")
    paths["extras fork"] = fork.record

    # ---- 3. migration pass: drain after some steps, resume elsewhere
    mreqs = [(rng.randint(2, V, int(rng.randint(64, 257))).astype(np.int32),
              64, {}) for _ in range(EXTRAS_MIGRATE)]
    whole = serve(ContinuousScheduler(eng), mreqs)
    with _ExtrasPass("migration", card, eng) as mig:
        src = ContinuousScheduler(eng)
        hs = [src.submit(p, g) for p, g, _ in mreqs]
        for _ in range(EXTRAS_DRAIN_STEPS):
            src.step()
        recs = src.snapshot_slots(drain=True)
        dst = ContinuousScheduler(eng)
        hr = [dst.submit(np.asarray(r["prompt"], np.int32), r["max_gen"],
                         resume_prefix=r["tokens"],
                         resume_kv_dtype=r["kv_dtype"]) for r in recs]
        dst.run_until_idle()
        mig.handles += hr
        mig.scheds += [src, dst]
    for h in hs:
        check(isinstance(h.error, GenerationMigrated),
              f"serve extras migration: waiter saw {h.error!r}")
    clean(src, "migration source")
    clean(dst, "migration destination")
    by_prompt = {tuple(r["prompt"]): h for r, h in zip(recs, hr)}
    rate = _match_rate([by_prompt[tuple(p)].tokens for p, _, _ in mreqs],
                       [h.tokens for h in whole])
    print(f"serve extras migration: {len(recs)} records, migrated_out "
          f"{src.counters['migrated_out']}, resumed_in "
          f"{dst.counters['resumed_in']}; continued streams against the "
          f"uninterrupted run {rate:.4f} (floor 0.98)")
    check(src.counters["migrated_out"] == dst.counters["resumed_in"]
          == EXTRAS_MIGRATE,
          f"serve extras migration: out {src.counters['migrated_out']}, "
          f"in {dst.counters['resumed_in']}")
    check(rate >= 0.98, f"serve extras migration: match {rate}")
    paths["extras migration"] = mig.record

    # ---- 4. dense pass: DecodeEngine against the continuous engine
    n, tp, g = EXTRAS_DENSE
    dense = DecodeEngine(params, batch_buckets=(n,), prompt_buckets=(tp,),
                         **LM_CFG)
    t0 = time.perf_counter()
    d_sig = dense.warm()
    print(f"serve extras dense warm: {d_sig} signatures in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = rng.randint(2, V, (n, tp)).astype(np.int32)
    with _ExtrasPass("dense", card, dense) as dp:
        t0 = time.perf_counter()
        out = dense.generate(prompts, g)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        dp.tokens = int(out.size)
    cont = serve(ContinuousScheduler(eng), [(p, g, {}) for p in prompts])
    rate = _match_rate(out, [h.tokens for h in cont])
    # a step's replay against its body run eagerly on the same buffers
    step = dense._signature(("step", n))
    step.ins.np["token"][...] = out[:, -1]
    step.ins.np["pos"][0] = tp + g - 1
    ck, cv = dense.caches[n]
    k0, v0 = ck.clone(), cv.clone()
    dense._dispatch(step)
    torch.cuda.synchronize()
    replayed = [t.clone() for t in (step.logits, step.res, ck, cv)]
    ck.copy_(k0)
    cv.copy_(v0)
    step.body(step)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(replayed, (step.logits, step.res, ck, cv)))
    print(f"serve extras dense: {n} x {tp} prompts, {g} generated, "
          f"{n * g / gen_s:.1f} tok/s ({gen_s * 1e3:.1f} ms); tokens against "
          f"the continuous engine's greedy streams {rate:.4f} (floor 0.98); "
          f"a step replay {'bitwise equal to' if bitwise else 'DIFFERS from'}"
          f" its body run eagerly; dense caches {dense.cache_bytes} bytes "
          f"beside the paged pool's {eng.pool.arena_bytes}; on {card}")
    check(rate >= 0.98, f"serve extras dense: match {rate}")
    check(bitwise, "serve extras dense: the step replay differs from eager")
    check(dense.trace_count() == d_sig,
          "serve extras dense: a signature prepared after warm")
    # the A/B of the KV cache: prefill, cached decode and the naive
    # full-recompute arm on the same prompts (measure prepares the naive
    # signature first)
    m = dense.measure(n, tp, g)
    print(f"serve extras dense measure: prefill "
          f"{m['prefill_tokens_per_sec']:.1f} tok/s, KV-cached decode "
          f"{m['kv_decode_tokens_per_sec']:.1f} tok/s, naive full recompute "
          f"{m['naive_decode_tokens_per_sec']:.1f} tok/s (x"
          f"{m['kv_vs_naive_speedup']:.2f}), tokens equal "
          f"{m['tokens_match']} (a record: another summation order); on "
          f"{card}")
    paths["extras dense"] = dict(dp.record, tokens_per_s=n * g / gen_s,
                                 cache_bytes=dense.cache_bytes, measure=m)
    check(eng.trace_count() == traces,
          f"serve extras: {eng.trace_count() - traces} signatures prepared "
          f"after warm")
    print(f"serve extras: trace count {eng.trace_count()} unmoved since "
          f"warm; on {card}")
    return paths


def _graph_against_body(eng, W: int, policy: bool, rng) -> None:
    """Stage one step with real tables (every slot its own blocks, limits
    past the window, so no write lands in the trash block), replay its
    graph, restore the arenas, run its body eagerly on the same buffers:
    the logits, the tokens and both arenas must be bitwise equal."""
    S, Bs, V = eng.n_slots, eng.block_size, eng.vocab_size
    pos0 = rng.randint(Bs, 500, S).astype(np.int32)
    limits = (pos0 + W + 1).astype(np.int32)
    tables = np.tile(eng._trash_table(), (S, 1))
    blocks = iter(rng.permutation(eng.pool.n_blocks))
    for s in range(S):
        n = eng.pool.blocks_for(int(limits[s]))
        tables[s, :n] = [next(blocks) for _ in range(n)]
    toks = rng.randint(2, V, (S, W)).astype(np.int32)
    samp = None
    if policy:
        samp = eng.make_samp()
        for s in range(0, S, 2):
            mask = np.zeros(V, np.float32)
            mask[rng.randint(0, V, 100)] = -1e9
            eng.set_samp_row(samp, s, (1000 + s, s, 0.8, 50 * (s % 4), 0.9,
                                       mask if s == 2 else None))
    sig = eng._stage_step(toks, pos0, tables, limits, samp)
    check(sig.run.captured, f"W={W} has no captured graph")
    k0, v0 = eng.pool.k.clone(), eng.pool.v.clone()
    eng._dispatch(sig)
    torch.cuda.synchronize()
    replayed = [t.clone() for t in (sig.logits, sig.res, eng.pool.k,
                                    eng.pool.v)]
    eng.pool.k.copy_(k0)
    eng.pool.v.copy_(v0)
    sig.body(sig)
    torch.cuda.synchronize()
    eager = (sig.logits, sig.res, eng.pool.k, eng.pool.v)
    names = ("logits", "tokens", "k arena", "v arena")
    diffs = {n: float((a.double() - b.double()).abs().max())
             for n, a, b in zip(names, replayed, eager)}
    moved = bool((eng.pool.k != k0).any())
    label = f"W={W} {'policy' if policy else 'greedy'}"
    print(f"serve graph vs body {label}: largest differences {diffs}, "
          f"arena written {moved}")
    check(moved and all(torch.equal(a, b) for a, b in zip(replayed, eager)),
          f"{label}: the replay differs from the body run eagerly: {diffs}")


def _release() -> None:
    """Free what the last phase left: its Executors' graphs and their pool
    go with the Executors, and the cached blocks with ``empty_cache``."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _replay_against_eager(label, exe, main, startup, params, feed,
                          fetch, prep=None) -> tuple:
    """Warm the parity signature (``feed``, ``fetch``) on a new train scope
    of ``exe``, replay it once, and run the same step eagerly by a second
    Executor that did not warm, from the same weights: the fetches (the
    loss and every gradient), every parameter, moment and optimizer step
    and the step counter must be bitwise equal, the same kernels on the
    same inputs.  Then the same eager step once more by a third Executor
    with every update op run on its own (the per-op rule): its parameters,
    moments and optimizer step must be bitwise equal to the grouped
    step's (``torch._foreach_*``).  ``prep(scope)``, when given, readies
    each new scope after its weights are loaded (the optimizer step, the
    step counter).  Returns (the replay's fetches, warm seconds, the
    warmed scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.tools.train_profile import feed_sig, train_scope

    def new_scope(executor):
        sc = train_scope(executor, startup, main, params)
        if prep is not None:
            prep(sc)
        return sc

    scope = new_scope(exe)
    compiles = exe.compiles
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(main, feed_sig(feed), fetch, scope=scope)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    again = exe.warm(main, feed_sig(feed), fetch, scope=scope)
    check(how == "compiled" and again == "cached"
          and exe.compiles == compiles + 1,
          f"{label}: warm gave {how!r} then {again!r}, compiles "
          f"{compiles} -> {exe.compiles}")
    replays = exe.replays
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    check(exe.replays == replays + 1, f"{label}: the warmed step did not "
                                      f"replay")
    eager = fluid.Executor()
    eager_scope = new_scope(eager)
    want = eager.run(main, feed=feed, fetch_list=fetch, scope=eager_scope)
    check(eager.replays == eager.compiles == 0,
          f"{label}: the eager Executor replayed")
    diffs = {}
    for name, a, b in zip([f if isinstance(f, str) else f.name
                           for f in fetch], got, want):
        diffs[name] = (a.tobytes() == b.tobytes(),
                       float(np.abs(a.astype(np.float64) - b).max()))
    for name in eager_scope.var_names():
        a, b = scope.find_var(name), eager_scope.find_var(name)
        diffs[name] = (torch.equal(a, b),
                       float((a.double() - b.double()).abs().max()))
    n_param = len(params)
    n_mom = sum(n.endswith((".moment1", ".moment2")) for n in diffs)
    bad = {n: d for n, (eq, d) in diffs.items() if not eq}
    print(f"{label} replay vs eager: the loss, {len(fetch) - 1} gradients, "
          f"{n_param} parameters, {n_mom} moments, "
          f"{len(diffs) - len(fetch) - n_param - n_mom} optimizer step(s) "
          f"and the step counter ({scope.step_counter} and "
          f"{eager_scope.step_counter}): {len(bad)} differ"
          + (f", largest {max(bad.values()):.3e} ({max(bad, key=bad.get)})"
             if bad else " (bitwise equal)"))
    check(not bad and scope.step_counter == eager_scope.step_counter,
          f"{label}: the replay differs from the eager step: "
          f"{dict(list(bad.items())[:5])}")

    per_op = fluid.Executor()
    per_op_scope = new_scope(per_op)
    grouped = executor_mod._grouped
    executor_mod._grouped = list  # each update op its own unit
    try:
        per_op.run(main, feed=feed, fetch_list=fetch, scope=per_op_scope)
    finally:
        executor_mod._grouped = grouped
    diffs = {name: (torch.equal(a, per_op_scope.find_var(name)),
                    float((a.double() - per_op_scope.find_var(name).double())
                          .abs().max()))
             for name, a in eager_scope.items()}
    bad = {n: d for n, (eq, d) in diffs.items() if not eq}
    print(f"{label} grouped vs per-op updates on the card: {len(diffs)} "
          f"state tensors, {len(bad)} differ"
          + (f", largest {max(bad.values()):.3e} ({max(bad, key=bad.get)})"
             if bad else " (bitwise equal)"))
    check(not bad, f"{label}: the grouped updates differ from the per-op "
                   f"rule: {dict(list(bad.items())[:5])}")
    return got, t_warm, scope


def _lm_train_pass(exe, main, loss, scope, feed) -> dict:
    """Warm the training signature (``feed``) on ``scope``, then
    TRAIN_STEPS replays, with every kernel launch count set to 0 just
    before and the flash, dropout and LSTM ones read just after (counted
    at replay): losses,
    CUDA-event ms per step (fetch included), the counts (all, and by
    dtype), warm seconds,
    replays and compiles, peak memory (allocated, and reserved: a graph's
    activations live in its pool, reserved while it replays)."""
    from paddle_tpu_torch.ops import (flash_attention, fused_lstm,
                                      threefry_dropout)
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS, feed_sig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(main, feed_sig(feed), [loss], scope=scope)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(how == "compiled", f"training signature: warm gave {how!r}")
    compiles, replays = exe.compiles, exe.replays
    _zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    check(exe.replays - replays == TRAIN_STEPS and exe.compiles == compiles,
          f"training pass: {exe.replays - replays} replays for "
          f"{TRAIN_STEPS} steps, compiles {compiles} -> {exe.compiles}")
    return {"losses": losses, "step_ms": step_ms,
            "launches": dict(flash_attention.launches),
            "dtype_launches": {dt: dict(c) for dt, c in
                               flash_attention.dtype_launches.items()},
            "lstm_launches": dict(fused_lstm.launches),
            "lstm_route_launches": dict(fused_lstm.route_launches),
            "dropout_launches": dict(threefry_dropout.launches),
            "dropout_dtype_launches": {
                dt: dict(c) for dt, c in
                threefry_dropout.dtype_launches.items()},
            "warm_s": warm_s, "compiles": exe.compiles,
            "replays": exe.replays - replays,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved()}


def _pass_line(run) -> str:
    return (f"warmed in {run['warm_s']:.2f} s (compiles {run['compiles']}), "
            f"{run['replays']} replays; peak memory "
            f"{run['peak_bytes'] / 2 ** 30:.2f} GiB allocated, "
            f"{run['peak_reserved'] / 2 ** 30:.2f} GiB reserved (the graph "
            f"pool included)")


def phase_train(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        TRAIN_BATCH, TRAIN_STEPS, build_train_program, train_batch,
        train_scope)

    # the program, weights and batch of tools/train_profile.py
    loss, main, startup = build_train_program()
    params = fluid.init_lm_params(0, **LM_CFG)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity step: the card (kernels, the warmed replay) and the CPU (plain
    # versions) from the same weights on the same 2 x 1024 tokens; the
    # replay also against the same step run eagerly on the card
    feed = train_batch(2, 2)
    fetch = [loss] + grad_names
    got, t_warm, _ = _replay_against_eager("train", exe, main, startup,
                                           params, feed, fetch)
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu = float(got[0]), float(want[0])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"parity step: non-finite {name}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    print(f"train parity: loss {l_gpu:.6f} card (the warmed replay), "
          f"{l_cpu:.6f} CPU (rtol 1e-4); {len(grad_names)} gradients, worst "
          f"max|d|/max|g| {worst:.3e} ({worst_name}; limit 1e-3); warm "
          f"{t_warm:.2f} s card, step {t_cpu:.2f} s CPU")
    check(worst <= 1e-3, f"parity step: {worst_name} differs by {worst} of "
                         f"its max |g|")

    # training pass: the counts are this pass's own
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params),
                         train_batch(3))
    losses, step_ms, launches = run["losses"], run["step_ms"], run["launches"]
    n_layers = LM_CFG["n_layers"]
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    check(all(launches[k] == n_layers * TRAIN_STEPS for k in FLASH_KERNELS),
          f"train: flash launches {launches}, expected {n_layers} x "
          f"{TRAIN_STEPS} each")
    med = float(np.median(step_ms[1:]))
    T = LM_CFG["max_len"]
    tokens = TRAIN_BATCH * T
    print(f"train: {TRAIN_STEPS} Adam steps on {TRAIN_BATCH} x {T} "
          f"tokens, losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps 2-"
          f"{TRAIN_STEPS} {med:.2f} ms = {tokens / med * 1e3:.0f} tokens/s; "
          f"{_pass_line(run)}; flash launches (counted at replay) "
          f"{launches} = {n_layers} layers x {TRAIN_STEPS} steps; on {card}")
    # the float32 parity step, the CPU's and the card's: the amp phase
    # measures the CPU's spread against the one and runs the other through
    # its comparisons as a control
    return {"launches": launches, "losses": losses, "median_ms": med,
            "tokens_per_s": tokens / med * 1e3, "warm_s": run["warm_s"],
            "parity_warm_s": t_warm, "peak_reserved": run["peak_reserved"],
            "cpu_parity": want, "card_parity": got}


def _spread_ratio(a, b, ref, dist) -> tuple:
    """(dist(a, b), the CPU's spread dist(b, ref), dist(a, b) over its
    limit max(AMP_FLOOR, AMP_SPREAD_FACTOR x spread)), each relative to
    the CPU amp value's own norm: a the card's amp value, b the CPU's, ref
    the CPU's float32 value."""
    norm = max(dist(b, np.zeros_like(b)), 1e-30)
    d, spread = dist(a, b) / norm, dist(b, ref) / norm
    return d, spread, d / max(AMP_FLOOR, AMP_SPREAD_FACTOR * spread)


def phase_lm_amp_train(card: str, f32_cpu: list, f32_card: list) -> dict:
    """The LM train step under amp with attention in bf16 (train_profile's
    program, amp=True): a parity step against the CPU's amp step,
    held to the CPU's own spread (its amp step's distance from its float32
    step, ``f32_cpu``: the train phase's CPU step on the same weights and
    tokens), and at least a third of that spread away from the float32
    step, with the train phase's float32 card step ``f32_card`` as the
    control that must fail; then 5 steps, every flash launch bf16."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        TRAIN_BATCH, TRAIN_STEPS, build_train_program, train_batch,
        train_scope)

    loss, main, startup = build_train_program(amp=True)
    params = fluid.init_lm_params(0, **LM_CFG)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity step: card (kernels, the warmed replay) and CPU (plain
    # versions), the train phase's weights and 2 x 1024 tokens; the replay
    # also against the same step run eagerly on the card
    feed = train_batch(2, 2)
    fetch = [loss] + grad_names
    got, t_warm, _ = _replay_against_eager("lm amp train", exe, main,
                                           startup, params, feed, fetch)
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu, l_f32 = float(got[0]), float(want[0]), float(f32_cpu[0])
    l_lim = max(1e-4 * abs(l_cpu), AMP_SPREAD_FACTOR * abs(l_cpu - l_f32))
    print(f"lm amp parity: loss {l_gpu:.6f} card, {l_cpu:.6f} CPU amp, "
          f"{l_f32:.6f} CPU float32; |d| {abs(l_gpu - l_cpu):.3e} (limit "
          f"{l_lim:.3e}: max(1e-4 |loss|, {AMP_SPREAD_FACTOR:g} x the CPU's "
          f"amp - float32 distance)); warm {t_warm:.2f} s card, step "
          f"{t_cpu:.2f} s CPU")
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= l_lim,
          f"lm amp parity: loss {l_gpu} on the card, {l_cpu} on the CPU, "
          f"limit {l_lim}")

    def l2(a, b):
        return float(np.linalg.norm((a - b).ravel()))

    def mx(a, b):
        return float(np.abs(a - b).max())

    worst, worst_name, rows = -1.0, None, []
    for name, a, b, c in zip(grad_names, got[1:], want[1:], f32_cpu[1:]):
        check(np.isfinite(a).all(), f"lm amp parity: non-finite {name}")
        a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
        r_l2, r_mx = _spread_ratio(a, b, c, l2), _spread_ratio(a, b, c, mx)
        rows.append((name, r_l2, r_mx))
        w = max(r_l2[2], r_mx[2])
        if w > worst:
            worst, worst_name = w, name
    def flat(xs):
        return np.concatenate([np.asarray(x, np.float32).ravel() for x in xs])

    cat = [flat(xs) for xs in (got[1:], want[1:], f32_cpu[1:])]
    together = _spread_ratio(*cat, l2)
    spreads = sorted(r[1][1] for r in rows)
    print(f"lm amp parity: {len(grad_names)} gradients; the CPU's spread "
          f"(amp - float32) in relative L2 median {np.median(spreads):.3e}, "
          f"{spreads[0]:.3e} to {spreads[-1]:.3e}; card vs CPU worst "
          f"{worst:.3f} of its limit ({worst_name}; relative L2 and max "
          f"|d|/max, each within max({AMP_FLOOR:g}, {AMP_SPREAD_FACTOR:g} x "
          f"the spread)); all together relative L2 {together[0]:.3e}, "
          f"spread {together[1]:.3e} ({together[2]:.3f} of its limit)")
    for name, r_l2, r_mx in sorted(rows, key=lambda r: -max(r[1][2],
                                                             r[2][2]))[:3]:
        print(f"lm amp parity:   {name}: relative L2 {r_l2[0]:.3e} (spread "
              f"{r_l2[1]:.3e}), max |d|/max {r_mx[0]:.3e} (spread "
              f"{r_mx[1]:.3e})")
    check(worst <= 1.0 and together[2] <= 1.0,
          f"lm amp parity: {worst_name} at {worst} of its limit, all "
          f"together at {together[2]}")

    # the bound above holds a float32 step too (it lies one spread from the
    # CPU's amp step, a third of the limit), so the step must also lie at
    # least 1 / AMP_SPREAD_FACTOR of the CPU's spread from the CPU's
    # float32 step, in relative L2, each gradient and all together: a step
    # whose bf16 casts were dropped sits within float32's 1e-3 of it.  The
    # train phase's float32 card step is the control: it must fail this.
    def away(xs):
        """(each gradient's, all together) distance of the step ``xs``
        from the CPU's float32 step over the CPU's spread."""
        each = [l2(flat([a]), flat([c])) / max(l2(flat([b]), flat([c])),
                                                1e-30)
                for a, b, c in zip(xs, want[1:], f32_cpu[1:])]
        return each, l2(flat(xs), cat[2]) / max(l2(cat[1], cat[2]), 1e-30)

    floor = 1.0 / AMP_SPREAD_FACTOR
    each, all_ = away(got[1:])
    c_each, c_all = away(f32_card[1:])
    c_par = _spread_ratio(flat(f32_card[1:]), cat[1], cat[2], l2)[2]
    print(f"lm amp parity: distance from the CPU's float32 step over the "
          f"CPU's spread (floor {floor:.3f}): amp step least "
          f"{min(each):.3f} ({grad_names[int(np.argmin(each))]}), all "
          f"together {all_:.3f}; control (the float32 card step): all "
          f"together {c_all:.3e}, greatest {max(c_each):.3e}, and "
          f"{c_par:.3f} of the parity limit above")
    check(min(each) >= floor and all_ >= floor,
          f"lm amp parity: the amp step lies {min(each)} (least gradient) "
          f"and {all_} (all together) of the CPU's spread from float32, "
          f"floor {floor}: bf16 did not run")
    check(c_all < floor, f"lm amp parity: the float32 control lies {c_all} "
                         f"of the CPU's spread from float32, floor {floor}:"
                         f" the comparison cannot tell float32 from amp")

    # training pass: every flash launch of it bf16
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params),
                         train_batch(3))
    losses, step_ms = run["losses"], run["step_ms"]
    bf16, f32 = run["dtype_launches"]["bfloat16"], run["dtype_launches"][
        "float32"]
    n_layers = LM_CFG["n_layers"]
    want_n = n_layers * TRAIN_STEPS
    check(all(np.isfinite(losses)), f"lm amp train: non-finite losses "
                                    f"{losses}")
    check(losses[-1] < losses[0], f"lm amp train: loss did not fall: "
                                  f"{losses}")
    check(all(run["launches"][k] == want_n and bf16[k] == want_n
              and f32[k] == 0 for k in FLASH_KERNELS),
          f"lm amp train: flash launches {run['launches']}, by dtype "
          f"{run['dtype_launches']}; expected {n_layers} x {TRAIN_STEPS} "
          f"each, all bfloat16")
    med = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * LM_CFG["max_len"]
    print(f"lm amp train: {TRAIN_STEPS} Adam steps on {TRAIN_BATCH} x "
          f"{LM_CFG['max_len']} tokens, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps 2-"
          f"{TRAIN_STEPS} {med:.2f} ms = {tokens / med * 1e3:.0f} tokens/s; "
          f"{_pass_line(run)}; bf16 flash launches (counted at replay) "
          f"{bf16} = {n_layers} layers x {TRAIN_STEPS} steps (float32 "
          f"{f32}); on {card}")
    return {"launches": bf16, "losses": losses, "median_ms": med,
            "tokens_per_s": tokens / med * 1e3, "warm_s": run["warm_s"],
            "parity_warm_s": t_warm, "peak_bytes": run["peak_bytes"],
            "peak_reserved": run["peak_reserved"]}



def _dropout_arm_scope(exe, startup, main, params, device=None):
    """A train scope of the dropout program with Transformer-base's
    optimizer resumed at the peak of warm-up and the step counter at
    LM_DROPOUT_STEP."""
    from paddle_tpu_torch.tools.train_profile import (resume_at_warmup,
                                                      train_scope)

    scope = train_scope(exe, startup, main, params, device)
    resume_at_warmup(scope, main)
    scope.step_counter = LM_DROPOUT_STEP
    return scope


def phase_lm_dropout_train(card: str) -> dict:
    """Transformer-base with dropout 0.1 and its optimizer (PERF.md §2):
    the float32 + remat step warmed at the 2 x 1024 parity signature, its
    replay against the eager step (and grouped against per-op updates), the
    live step counter (replays at s + 1 and s from the same state), the
    card against the CPU, remat against no remat; then each arm of
    LM_DROPOUT_ARMS warmed at 8 x 1024 tokens and 5 replays with the
    flash and dropout counts set to 0 just before and read just after."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        TRAIN_BATCH, TRAIN_STEPS, build_train_program, resume_at_warmup,
        train_batch)

    params = fluid.init_lm_params(0, **LM_CFG)
    grad_names = [f"{n}@GRAD" for n in params]
    feed = train_batch(2, 2)
    s0 = LM_DROPOUT_STEP
    progs = {label: build_train_program(amp, LM_DROPOUT, remat)
             for label, amp, remat in LM_DROPOUT_ARMS}

    # the main path's program: parity signature, replay against eager
    loss, main, startup = progs["float32 remat"]
    fetch = [loss] + grad_names
    exe = fluid.Executor()

    def prep(scope):
        resume_at_warmup(scope, main)
        scope.step_counter = s0

    got, t_warm, scope = _replay_against_eager(
        "lm dropout train (float32 remat)", exe, main, startup, params,
        feed, fetch, prep=prep)

    # the live counter: the same state replayed at s + 1 and at s
    fresh = _dropout_arm_scope(fluid.Executor(), startup, main, params)
    losses, replays = {}, exe.replays
    for s in (s0 + 1, s0):
        for n in scope.var_names():
            scope.set_var(n, fresh.find_var(n).clone())
        scope.step_counter = s
        losses[s] = exe.run(main, feed=feed, fetch_list=fetch,
                            scope=scope)[0]
    print(f"lm dropout train live counter: loss {float(got[0]):.7f} at "
          f"step {s0}, {float(losses[s0 + 1]):.7f} at {s0 + 1} (staged as "
          f"int32 {np.array(s0 + 1, np.uint32).view(np.int32)}), "
          f"{float(losses[s0]):.7f} at {s0} again, the same state")
    check(exe.replays == replays + 2, "lm dropout train: the live counter "
                                      "runs did not replay")
    check(losses[s0].tobytes() == got[0].tobytes(),
          "lm dropout train: the replay at the same step is not bitwise "
          "the first")
    check(losses[s0 + 1].tobytes() != got[0].tobytes(),
          "lm dropout train: the replay at s + 1 drew the masks of s: the "
          "graph does not read the live step counter")

    # the card against the CPU, same weights, step counter and tokens
    t0 = time.perf_counter()
    exe_cpu = fluid.Executor(fluid.CPUPlace())
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=_dropout_arm_scope(exe_cpu, startup, main,
                                                params, "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu = float(got[0]), float(want[0])
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"lm dropout parity: non-finite {name}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    print(f"lm dropout parity (float32 remat, dropout {LM_DROPOUT}, step "
          f"{s0}): loss {l_gpu:.6f} card (the warmed replay), {l_cpu:.6f} "
          f"CPU (rtol 1e-4); {len(grad_names)} gradients, worst "
          f"max|d|/max|g| {worst:.3e} ({worst_name}; limit 1e-3); warm "
          f"{t_warm:.2f} s card, step {t_cpu:.2f} s CPU")
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"lm dropout parity: loss {l_gpu} on the card, {l_cpu} on the CPU")
    check(worst <= 1e-3, f"lm dropout parity: {worst_name} differs by "
                         f"{worst} of its max |g|")

    # remat against no remat, float32, eager on the card
    loss_n, main_n, startup_n = progs["float32"]
    plain = fluid.Executor()
    ref = plain.run(main_n, feed=feed, fetch_list=[loss_n] + grad_names,
                    scope=_dropout_arm_scope(plain, startup_n, main_n,
                                             params))
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], ref[1:]):
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    same = got[0].tobytes() == ref[0].tobytes()
    print(f"lm dropout remat vs no remat (float32, step {s0}): loss "
          f"{float(got[0]):.7f} and {float(ref[0]):.7f} ("
          f"{'bitwise equal' if same else 'DIFFER'}); worst gradient "
          f"max|d|/max|g| {worst:.3e} ({worst_name}; limit "
          f"{REMAT_GRAD_REL:g})")
    check(same,
          "lm dropout: the remat loss is not bitwise the plain build's")
    check(worst <= REMAT_GRAD_REL,
          f"lm dropout: remat gradient {worst_name} at {worst} of max |g|")
    del exe, plain, exe_cpu, scope, fresh
    _release()

    # the training passes
    n_layers = LM_CFG["n_layers"]
    sites = 1 + 2 * n_layers
    runs = {}
    for label, amp, remat in LM_DROPOUT_ARMS:
        loss, main, startup = progs[label]
        exe = fluid.Executor()
        # the eager step's own peak (activations, gradients, new state)
        # above what its scope holds, on a scope of its own: what remat
        # trades (a warmed step's activations live in its graph's pool,
        # which counts as reserved)
        probe = _dropout_arm_scope(exe, startup, main, params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        exe.run(main, feed=train_batch(3), fetch_list=[loss], scope=probe)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - held
        del probe
        run = _lm_train_pass(exe, main, loss,
                             _dropout_arm_scope(exe, startup, main, params),
                             train_batch(3))
        losses, step_ms = run["losses"], run["step_ms"]
        check(all(np.isfinite(losses)),
              f"lm dropout train {label}: non-finite losses {losses}")
        want_fl = {"fwd": n_layers * (2 if remat else 1), "bwd_dkdv":
                   n_layers, "bwd_dq": n_layers}
        # remat: torch.utils.checkpoint stops a block's recompute once the
        # last activation its backward needs is rebuilt (ff2's input), so
        # the attention's dropout is drawn again and the FFN's is not
        want_dr = {"fwd": sites + (n_layers if remat else 0), "bwd": sites}
        fl, dr = run["launches"], run["dropout_launches"]
        check(all(fl[k] == want_fl[k] * TRAIN_STEPS for k in FLASH_KERNELS)
              and all(dr[k] == want_dr[k] * TRAIN_STEPS
                      for k in DROPOUT_KERNELS),
              f"lm dropout train {label}: flash launches {fl}, dropout "
              f"{dr}; expected {want_fl} and {want_dr} x {TRAIN_STEPS}")
        # the dtype amp hands each kernel: flash bf16 under the attention
        # policy; dropout is in BF16_OPS
        dt_fl = "bfloat16" if amp else "float32"
        dt_dr = str(main.amp_policy.input_dtype("dropout", {},
                                                torch.float32)
                    if amp else torch.float32).replace("torch.", "")
        check(run["dtype_launches"][dt_fl] == fl
              and run["dropout_dtype_launches"][dt_dr] == dr,
              f"lm dropout train {label}: launches by dtype "
              f"{run['dtype_launches']}, {run['dropout_dtype_launches']}; "
              f"expected all flash {dt_fl}, all dropout {dt_dr}")
        med = float(np.median(step_ms[1:]))
        tokens = TRAIN_BATCH * LM_CFG["max_len"]
        print(f"lm dropout train {label}: {TRAIN_STEPS} steps on "
              f"{TRAIN_BATCH} x {LM_CFG['max_len']} tokens, losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
              f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps "
              f"2-{TRAIN_STEPS} {med:.2f} ms = {tokens / med * 1e3:.0f} "
              f"tokens/s; {_pass_line(run)}; an eager step's own peak "
              f"{eager_peak / 2 ** 30:.2f} GiB; launches a step (counted at "
              f"replay): dropout {want_dr} in {dt_dr}, flash {want_fl} in "
              f"{dt_fl}; on {card}")
        runs[label] = {"launches": dr, "flash_launches": fl,
                       "dropout_dtype": dt_dr, "losses": losses,
                       "median_ms": med,
                       "tokens_per_s": tokens / med * 1e3,
                       "warm_s": run["warm_s"],
                       "peak_bytes": run["peak_bytes"],
                       "peak_reserved": run["peak_reserved"],
                       "eager_step_peak_bytes": eager_peak}
        del exe
        _release()
    return runs


def phase_optimizers(card: str) -> dict:
    """Each new optimizer's grouped update against its per-op rule on the
    card: a 2-layer LM at d = 128 with the optimizer on noam_decay and
    L2Decay, one eager step grouped and one with ``executor._grouped``
    patched to ``list``, from the same weights and tokens; every parameter
    and accumulator bitwise equal."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.tools.train_profile import train_scope

    O = fluid.optimizer
    rules = {"Adagrad": (O.Adagrad, {}), "Adamax": (O.Adamax, {}),
             "Adadelta": (O.Adadelta, {}),
             "RMSProp": (O.RMSProp, {"momentum": 0.9}),
             "DecayedAdagrad": (O.DecayedAdagrad, {}),
             "Ftrl": (O.Ftrl, {"l1": 1e-4, "l2": 1e-4}),
             "ProximalGD": (O.ProximalGD, {"l1": 1e-4, "l2": 1e-4}),
             "ProximalAdagrad": (O.ProximalAdagrad, {"l1": 1e-4,
                                                     "l2": 1e-4})}
    cfg = OPT_LM_CFG
    T, V = cfg["max_len"], cfg["vocab_size"]
    rng = np.random.RandomState(5)
    feed = {"toks": rng.randint(0, V, (4, T)).astype(np.int32),
            "labs": rng.randint(0, V, (4, T, 1)).astype(np.int32)}
    params = fluid.init_lm_params(1, **cfg)
    out = {}
    for name, (cls, kw) in rules.items():
        fluid.reset_default_programs()
        toks = fluid.layers.data("toks", [T], dtype="int32")
        labs = fluid.layers.data("labs", [T, 1], dtype="int32")
        loss, _ = fluid.models.build_lm(toks, labs, **cfg)
        cls(fluid.learning_rate_decay.noam_decay(cfg["d_model"], 10),
            regularization=fluid.regularizer.L2Decay(1e-4),
            **kw).minimize(loss)
        main = fluid.default_main_program()
        startup = fluid.default_startup_program()
        scopes = []
        for grouped in (True, False):
            exe = fluid.Executor()
            scope = train_scope(exe, startup, main, params)
            saved = executor_mod._grouped
            if not grouped:
                executor_mod._grouped = list
            try:
                for _ in range(2):
                    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            finally:
                executor_mod._grouped = saved
            scopes.append(scope)
        a, b = scopes
        bad = [n for n in a.var_names()
               if not torch.equal(a.find_var(n), b.find_var(n))]
        n_acc = len(a.var_names()) - len(params) - 1
        print(f"optimizers: {name} (noam_decay, L2Decay(1e-4)"
              f"{', ' + str(kw) if kw else ''}), two eager steps grouped "
              f"and per-op: {len(params)} parameters, {n_acc} accumulators "
              f"and the step: {len(bad)} differ"
              + (f" ({bad[:4]})" if bad else " (bitwise equal)"))
        check(not bad, f"optimizers: {name}'s grouped update differs from "
                       f"its per-op rule on the card: {bad[:4]}")
        out[name] = len(a.var_names())
    return out

def phase_lstm_train(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import fused_lstm
    from paddle_tpu_torch.tools.train_profile import (
        TEXT_LSTM_BATCH, TEXT_LSTM_CFG, TEXT_LSTM_SEQ, TRAIN_STEPS,
        build_text_lstm_program, text_lstm_batch, text_lstm_params,
        train_scope)

    # the program, weights and batch of tools/train_profile.py --model
    # text_lstm
    loss, main, startup = build_text_lstm_program()
    params = text_lstm_params(0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity step: the card (kernels) and the CPU (plain versions) from the
    # same weights on the same 16 sequences
    feed = text_lstm_batch(1, 16)
    t0 = time.perf_counter()
    got = exe.run(main, feed=feed, fetch_list=[loss] + grad_names,
                  scope=train_scope(exe, startup, main, params))
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=[loss] + grad_names,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu = float(got[0]), float(want[0])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"lstm parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"lstm parity step: non-finite {name}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    print(f"lstm train parity: loss {l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol "
          f"1e-4); {len(grad_names)} gradients, worst max|d|/max|g| "
          f"{worst:.3e} ({worst_name}; limit 1e-3); step {t_gpu:.2f} s card "
          f"(first), {t_cpu:.2f} s CPU")
    check(worst <= 1e-3, f"lstm parity step: {worst_name} differs by "
                         f"{worst} of its max |g|")

    # training pass: the counts are this pass's own
    scope = train_scope(exe, startup, main, params)
    feed = text_lstm_batch(0)
    torch.cuda.synchronize()
    for kern in LSTM_KERNELS:
        fused_lstm.launches[kern] = 0
    for route in fused_lstm.route_launches:
        fused_lstm.route_launches[route] = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(fused_lstm.launches)
    routes = dict(fused_lstm.route_launches)
    n_layers = TEXT_LSTM_CFG["num_layers"]
    check(all(np.isfinite(losses)), f"lstm train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"lstm train: loss did not fall: {losses}")
    check(all(launches[k] == n_layers * TRAIN_STEPS for k in LSTM_KERNELS),
          f"lstm train: launches {launches}, expected {n_layers} x "
          f"{TRAIN_STEPS} each")
    check(routes == {"persistent": len(LSTM_KERNELS) * n_layers * TRAIN_STEPS,
                     "step": 0},
          f"lstm train: route launches {routes}, expected every call of "
          f"each kernel on the persistent route")
    med = float(np.median(step_ms[1:]))
    print(f"lstm train: {TRAIN_STEPS} Adam steps on {TEXT_LSTM_BATCH} x "
          f"{TEXT_LSTM_SEQ} (lengths 50-100, {int(feed['lengths'].sum())} "
          f"valid tokens), losses {', '.join(f'{x:.5f}' for x in losses)}; "
          f"step ms {', '.join(f'{x:.1f}' for x in step_ms)}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.2f} ms = "
          f"{TEXT_LSTM_BATCH / med * 1e3:.0f} sequences/s; lstm launches "
          f"{launches} = {n_layers} layers x {TRAIN_STEPS} steps, by route "
          f"{routes} (each persistent call one device launch); on {card}")

    # warmed: the 128-sequence signature as one CUDA graph (the persistent
    # kernels' cooperative launches captured), a replay bitwise against
    # the eager step, then TRAIN_STEPS replays counted at replay
    _replay_against_eager("lstm train", exe, main, startup, params, feed,
                          [loss] + grad_names)
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params), feed)
    w_launches, w_routes = run["lstm_launches"], run["lstm_route_launches"]
    check(all(np.isfinite(run["losses"])) and
          run["losses"][-1] < run["losses"][0],
          f"lstm train (warmed): losses {run['losses']}")
    check(all(w_launches[k] == n_layers * TRAIN_STEPS for k in LSTM_KERNELS),
          f"lstm train (warmed): launches counted at replay {w_launches}, "
          f"expected {n_layers} x {TRAIN_STEPS} each")
    check(w_routes == {"persistent":
                       len(LSTM_KERNELS) * n_layers * TRAIN_STEPS, "step": 0},
          f"lstm train (warmed): route launches {w_routes}, expected every "
          f"call on the persistent route")
    w_med = float(np.median(run["step_ms"][1:]))
    print(f"lstm train (warmed): {TRAIN_STEPS} replays, losses "
          f"{', '.join(f'{x:.5f}' for x in run['losses'])}; step ms "
          f"{', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {w_med:.3f} ms = "
          f"{TEXT_LSTM_BATCH / w_med * 1e3:.0f} sequences/s (eager "
          f"{med:.3f} ms = {TEXT_LSTM_BATCH / med * 1e3:.0f}); "
          f"{_pass_line(run)}; lstm launches counted at replay {w_launches}, "
          f"by route {w_routes}; on {card}")
    return {"launches": launches, "route_launches": routes, "losses": losses,
            "median_ms": med, "warmed_launches": w_launches,
            "warmed_route_launches": w_routes, "warmed_median_ms": w_med}


def _card_cpu_grads(label, got, want, grad_names,
                    what: str = "the warmed replay") -> None:
    """The float32 train limit, card against CPU (``what`` names the card's
    step in the printed line): the loss within rtol
    1e-4, every gradient within 1e-3 of its max |g|; a gradient that fails
    that but whose max is below SEQ2SEQ_NOISE_SHARE of the step's largest
    is rounding noise (at most one such, printed with its magnitude) and is
    held within 1e-3 of the step's largest instead.  Gradients below the
    share that hold on their own scale are listed too."""
    l_gpu, l_cpu = float(got[0]), float(want[0])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"{label} parity step: loss {l_gpu} on the card, {l_cpu} on the "
          f"CPU")
    top = max(float(np.abs(b).max()) for b in want[1:])
    worst, worst_name, noise, small = 0.0, None, [], []
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"{label} parity step: non-finite {name}")
        scale = float(np.abs(b).max())
        d = float(np.abs(a - b).max())
        if scale < SEQ2SEQ_NOISE_SHARE * top:
            if d > 1e-3 * scale:
                noise.append(f"{name} (max |g| {scale:.3e}, max |d| "
                             f"{d:.3e} = {d / max(scale, 1e-30):.3e} of it, "
                             f"{d / top:.3e} of the largest)")
                scale = top
            else:
                small.append(name)
        if d / scale >= worst:
            worst, worst_name = d / scale, name
    print(f"{label} parity: loss {l_gpu:.6f} card ({what}), "
          f"{l_cpu:.6f} CPU (rtol 1e-4); {len(grad_names)} gradients, worst "
          f"max|d|/max|g| {worst:.3e} ({worst_name}; limit 1e-3); largest "
          f"max |g| {top:.3e}; below {SEQ2SEQ_NOISE_SHARE:g} of it and held "
          f"on their own scale: {len(small)}; rounding noise (held to 1e-3 "
          f"of the largest): {'; '.join(noise) or 'none'}")
    check(len(noise) <= 1, f"{label} parity step: {len(noise)} gradients "
                           f"below {SEQ2SEQ_NOISE_SHARE} of the largest fail "
                           f"their own scale")
    check(worst <= 1e-3, f"{label} parity step: {worst_name} differs by "
                         f"{worst} of its limit's scale (limit 1e-3)")


def _event_ms(fn, n: int) -> list:
    """CUDA-event ms of each of ``n`` calls of ``fn`` (host cost and any
    fetch included)."""
    out = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def phase_seq2seq_train(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.seq2seq_parity import (
        PARITY_BATCH, PARITY_FEED_SEED)
    from paddle_tpu_torch.tools.train_profile import (
        TRAIN_STEPS, build_seq2seq_program, seq2seq_batch, startup_params,
        train_scope)

    # the program, weights and batch of tools/train_profile.py --model
    # seq2seq: train_net's widths, 30000 words a side, weights from the
    # port's startup program on the CPU, seed 0
    loss, main, startup = build_seq2seq_program()
    params = startup_params(main, startup, 0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity: the B = 8 signature warmed, one replay against an unwarmed
    # Executor's eager step (bitwise) and against the CPU
    feed = seq2seq_batch(PARITY_FEED_SEED, PARITY_BATCH)
    fetch = [loss] + grad_names
    got, t_warm, _ = _replay_against_eager("seq2seq train", exe, main,
                                           startup, params, feed, fetch)
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    _card_cpu_grads("seq2seq train", got, want, grad_names)
    print(f"seq2seq train parity: warm {t_warm:.2f} s card, step "
          f"{t_cpu:.2f} s CPU")
    del got, want
    _release()

    # the B = 64 signature warmed, TRAIN_STEPS replays on a fixed batch
    feed = seq2seq_batch(0)
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params), feed)
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"seq2seq train: losses {losses}, expected finite and falling")
    med = float(np.median(run["step_ms"][1:]))
    # the eager step in the same run: an Executor that did not warm
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, main, params)
    eager_ms = _event_ms(lambda: eager.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=eager_scope), 3)
    check(eager.replays == 0, "seq2seq train: the eager Executor replayed")
    e_med = float(np.median(eager_ms[1:]))
    tgt, src = int(feed["tlen"].sum()), int(feed["slen"].sum())
    print(f"seq2seq train: {TRAIN_STEPS} Adam steps on "
          f"{feed['src'].shape[0]} pairs x {feed['src'].shape[1]} "
          f"({src} source, {tgt} target tokens), losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.3f} ms = {tgt / med * 1e3:.0f} "
          f"target tokens/s, {src / med * 1e3:.0f} source tokens/s; eager "
          f"step {', '.join(f'{x:.2f}' for x in eager_ms)} ms, median of 2-3 "
          f"{e_med:.3f} ms ({tgt / e_med * 1e3:.0f} target tokens/s); "
          f"{_pass_line(run)}; on {card}")
    return {"median_ms": med, "eager_median_ms": e_med,
            "target_tokens_per_s": tgt / med * 1e3,
            "source_tokens_per_s": src / med * 1e3,
            "warm_s": run["warm_s"], "parity_warm_s": t_warm,
            "peak_bytes": run["peak_bytes"],
            "peak_reserved": run["peak_reserved"]}


def phase_seq2seq_beam(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        build_beam_program, emitted_tokens, feed_sig, seq2seq_batch,
        startup_params, train_scope)

    # beam_search_decoder at its own widths (beam 4, max_len 32) on 64
    # sources, weights from the port's startup program on the CPU, seed 0
    fetch, main, startup = build_beam_program()
    fetch = list(fetch)
    params = startup_params(main, startup, 0)
    feed = seq2seq_batch(0, train=False)
    exe = fluid.Executor()
    scope = train_scope(exe, startup, main, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(main, feed_sig(feed), fetch, scope=scope)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    again = exe.warm(main, feed_sig(feed), fetch, scope=scope)
    check(how == "compiled" and again == "cached" and exe.compiles == 1,
          f"seq2seq beam: warm gave {how!r} then {again!r}")
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    check(exe.replays == 1, "seq2seq beam: the warmed decode did not replay")
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, main, params)
    want = eager.run(main, feed=feed, fetch_list=fetch, scope=eager_scope)
    same = [a.tobytes() == b.tobytes() for a, b in zip(got, want)]
    print(f"seq2seq beam replay vs eager: tokens, scores, lens bitwise "
          f"equal {same}")
    check(all(same), "seq2seq beam: the replay differs from the eager run")

    # card against CPU on SEQ2SEQ_BEAM_PARITY sources: rows decode on
    # their own, so the warmed replay's first rows against the CPU's run
    # on those sources alone
    few = {k: v[:SEQ2SEQ_BEAM_PARITY] for k, v in feed.items()}
    c_tok, c_sc = (a[:SEQ2SEQ_BEAM_PARITY] for a in got[:2])
    exe_cpu = fluid.Executor(fluid.CPUPlace())
    h_tok, h_sc, _ = exe_cpu.run(main, feed=few, fetch_list=fetch,
                                 scope=train_scope(exe_cpu, startup, main,
                                                   params, "cpu"))
    rel = float((np.abs(c_sc - h_sc) / np.maximum(np.abs(h_sc), 1e-30))
                .max())
    equal = int((c_tok == h_tok).sum())
    print(f"seq2seq beam card (the warmed replay's first "
          f"{SEQ2SEQ_BEAM_PARITY} rows) vs CPU on those sources: "
          f"worst score difference {rel:.3e} relative (limit 1e-4); tokens "
          f"equal in {equal} of {c_tok.size} positions (limit 0.98)")
    check(np.isfinite(c_sc).all() and rel <= 1e-4,
          f"seq2seq beam: scores differ by {rel} relative")
    check(equal >= 0.98 * c_tok.size,
          f"seq2seq beam: tokens equal in only {equal} of {c_tok.size}")

    # timing: warmed replays against eager runs, in this run
    n_tok = emitted_tokens(got[2])
    replays = exe.replays
    w_ms = _event_ms(lambda: exe.run(main, feed=feed, fetch_list=fetch,
                                     scope=scope), 5)
    check(exe.replays - replays == 5, "seq2seq beam: a timed decode did not "
                                      "replay")
    e_ms = _event_ms(lambda: eager.run(main, feed=feed, fetch_list=fetch,
                                       scope=eager_scope), 3)
    w_med, e_med = float(np.median(w_ms[1:])), float(np.median(e_ms[1:]))
    print(f"seq2seq beam: {feed['src'].shape[0]} sources, beam "
          f"{got[0].shape[1]}, {got[0].shape[2]} steps, {n_tok} emitted "
          f"tokens (the best hypotheses' lengths); warmed in {warm_s:.2f} s; "
          f"decode ms {', '.join(f'{x:.2f}' for x in w_ms)}, median of 2-5 "
          f"{w_med:.3f} ms = {n_tok / w_med * 1e3:.0f} emitted tokens/s; "
          f"eager {', '.join(f'{x:.2f}' for x in e_ms)}, median of 2-3 "
          f"{e_med:.3f} ms = {n_tok / e_med * 1e3:.0f}; on {card}")
    return {"median_ms": w_med, "eager_median_ms": e_med,
            "emitted_tokens": n_tok, "warm_s": warm_s}


def _crf_path_score(emis, trans, tags, n: int) -> float:
    """The CRF score of tag path ``tags`` over the first ``n`` steps of
    emissions ``emis`` [T, N], in float64: start, emissions, transitions,
    end (the layout of ``layers.linear_chain_crf``'s transition)."""
    emis, trans = emis.astype(np.float64), trans.astype(np.float64)
    start, end, trs = trans[0], trans[1], trans[2:]
    s = start[tags[0]] + emis[0, tags[0]]
    for t in range(1, n):
        s += trs[tags[t - 1], tags[t]] + emis[t, tags[t]]
    return float(s + end[tags[n - 1]])


def phase_srl(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import check_kernel_shapes
    from paddle_tpu_torch.ops import fused_lstm
    from paddle_tpu_torch.tools.train_profile import (
        SRL_BATCH, SRL_CFG, SRL_LEN, TRAIN_STEPS, build_srl_program,
        feed_sig, srl_batch, startup_params, train_scope)

    # the program, weights and batch of tools/train_profile.py --model
    # srl: db_lstm at the label_semantic_roles chapter's width, the
    # chapter's SGD, weights from the port's startup program on the CPU,
    # seed 0
    (loss, decoded), main, startup = build_srl_program()
    params = startup_params(main, startup, 0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())
    check_kernel_shapes(main, exe.device)
    depth = SRL_CFG["depth"]
    print(f"srl: check_kernel_shapes accepts the train program "
          f"({depth} dynamic_lstm ops, float32) on the card")

    # parity: the B = 8 signature warmed, one replay against an unwarmed
    # Executor's eager step (bitwise) and against the CPU
    feed = srl_batch(1, SRL_PARITY_BATCH)
    fetch = [loss] + grad_names
    got, t_warm, _ = _replay_against_eager("srl train", exe, main, startup,
                                           params, feed, fetch)
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    _card_cpu_grads("srl train", got, want, grad_names)
    del got, want

    # the B = 64 signature warmed, TRAIN_STEPS replays on a fixed batch,
    # the LSTM launches counted at replay
    feed = srl_batch(0)
    tokens = int(feed["length"].sum())
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params), feed)
    losses, launches = run["losses"], run["lstm_launches"]
    routes = run["lstm_route_launches"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"srl train: losses {losses}, expected finite and falling")
    check(launches == {"fwd": depth * TRAIN_STEPS, "bwd": depth * TRAIN_STEPS},
          f"srl train: lstm launches counted at replay {launches}, expected "
          f"{depth} x {TRAIN_STEPS} each")
    check(routes == {"persistent": 2 * depth * TRAIN_STEPS, "step": 0},
          f"srl train: route launches {routes}, expected every call on the "
          f"persistent route")
    med = float(np.median(run["step_ms"][1:]))
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, main, params)
    eager_ms = _event_ms(lambda: eager.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=eager_scope), 3)
    check(eager.replays == 0, "srl train: the eager Executor replayed")
    e_med = float(np.median(eager_ms[1:]))
    print(f"srl train: {TRAIN_STEPS} SGD steps on {SRL_BATCH} sentences x "
          f"{SRL_LEN} ({tokens} tokens), losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of steps "
          f"2-{TRAIN_STEPS} {med:.3f} ms = {tokens / med * 1e3:.0f} tokens/s; "
          f"eager {', '.join(f'{x:.2f}' for x in eager_ms)} ms, median of "
          f"2-3 {e_med:.3f} ms ({tokens / e_med * 1e3:.0f} tokens/s); "
          f"{_pass_line(run)}; lstm launches counted at replay {launches}, "
          f"by route {routes}; on {card}")
    _release()

    # decode: the program pruned to the Viterbi tags, its own signature
    dmain = main.prune([decoded])
    op = next(o for o in dmain.list_ops() if o.type == "crf_decoding")
    emission = op.inputs["Emission"][0]
    dfetch = [decoded, emission]
    dfeed = srl_batch(0, train=False)
    dscope = train_scope(exe, startup, dmain, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(dmain, feed_sig(dfeed), dfetch, scope=dscope)
    torch.cuda.synchronize()
    d_warm = time.perf_counter() - t0
    check(how == "compiled", f"srl decode: warm gave {how!r}")
    replays = exe.replays
    d_got = exe.run(dmain, feed=dfeed, fetch_list=dfetch, scope=dscope)
    check(exe.replays == replays + 1, "srl decode: the warmed decode did not "
                                      "replay")
    d_eager = fluid.Executor()
    d_eager_scope = train_scope(d_eager, startup, dmain, params)
    d_want = d_eager.run(dmain, feed=dfeed, fetch_list=dfetch,
                         scope=d_eager_scope)
    same = [a.tobytes() == b.tobytes() for a, b in zip(d_got, d_want)]
    print(f"srl decode replay vs eager: tags, emissions bitwise equal {same}")
    check(all(same), "srl decode: the replay differs from the eager run")

    # card against CPU: tags at the valid positions; a row that differs is
    # held by its path score against the CPU path's
    tags, _ = d_got
    h_tags, h_emis = exe_cpu.run(dmain, feed=dfeed, fetch_list=dfetch,
                                 scope=train_scope(exe_cpu, startup, dmain,
                                                   params, "cpu"))
    ln = dfeed["length"]
    valid = np.arange(SRL_LEN)[None, :] < ln[:, None]
    equal = int(((tags == h_tags) & valid).sum())
    n_valid = int(valid.sum())
    trans = params["srl_crf_transition"]
    worst, rows = 0.0, []
    for b in np.nonzero(((tags != h_tags) & valid).any(1))[0]:
        n = int(ln[b])
        mine = _crf_path_score(h_emis[b], trans, tags[b], n)
        ref = _crf_path_score(h_emis[b], trans, h_tags[b], n)
        rel = abs(mine - ref) / max(abs(ref), 1e-30)
        worst = max(worst, rel)
        rows.append(int(b))
    print(f"srl decode card (the warmed replay) vs CPU: tags equal in "
          f"{equal} of {n_valid} valid positions (limit {SRL_TAG_SHARE}); "
          f"rows that differ {rows or 'none'}, worst path score difference "
          f"{worst:.3e} relative (limit {SRL_PATH_REL})")
    check(equal >= SRL_TAG_SHARE * n_valid,
          f"srl decode: tags equal in only {equal} of {n_valid}")
    check(worst <= SRL_PATH_REL,
          f"srl decode: rows {rows} differ by {worst} in path score")

    # chunk_eval's counts on the card's tags against the labels
    cmain, cstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(cmain, cstart):
        L = fluid.layers
        counts = L.chunk_eval(
            L.data("p", [SRL_LEN], dtype="int32"),
            L.data("g", [SRL_LEN], dtype="int32"),
            L.data("n", [-1], dtype="int32", append_batch_size=False))
    c, = exe.run(cmain, feed={"p": tags, "g": srl_batch(0)["label"],
                              "n": ln}, fetch_list=[counts])
    print(f"srl decode chunk_eval on the card: correct {c[0]:.0f}, "
          f"predicted {c[1]:.0f}, labelled {c[2]:.0f} chunks (random "
          f"weights)")

    # timing: warmed replays against eager runs, the LSTM forward launches
    # counted at replay
    for counts in (fused_lstm.launches, fused_lstm.route_launches):
        for k in counts:
            counts[k] = 0
    replays = exe.replays
    w_ms = _event_ms(lambda: exe.run(dmain, feed=dfeed, fetch_list=dfetch,
                                     scope=dscope), TRAIN_STEPS)
    d_launches = dict(fused_lstm.launches)
    d_routes = dict(fused_lstm.route_launches)
    check(exe.replays - replays == TRAIN_STEPS,
          "srl decode: a timed decode did not replay")
    check(d_launches == {"fwd": depth * TRAIN_STEPS, "bwd": 0}
          and d_routes == {"persistent": depth * TRAIN_STEPS, "step": 0},
          f"srl decode: lstm launches {d_launches}, by route {d_routes}, "
          f"expected {depth} x {TRAIN_STEPS} forward, all persistent")
    de_ms = _event_ms(lambda: d_eager.run(dmain, feed=dfeed,
                                          fetch_list=dfetch,
                                          scope=d_eager_scope), 3)
    w_med, de_med = float(np.median(w_ms[1:])), float(np.median(de_ms[1:]))
    print(f"srl decode: {SRL_BATCH} sentences ({tokens} tokens), warmed in "
          f"{d_warm:.2f} s; decode ms {', '.join(f'{x:.2f}' for x in w_ms)}, "
          f"median of 2-{TRAIN_STEPS} {w_med:.3f} ms = "
          f"{tokens / w_med * 1e3:.0f} tokens/s; eager "
          f"{', '.join(f'{x:.2f}' for x in de_ms)}, median of 2-3 "
          f"{de_med:.3f} ms = {tokens / de_med * 1e3:.0f}; lstm launches "
          f"counted at replay {d_launches}; on {card}")
    return {"launches": launches, "route_launches": routes,
            "decode_launches": d_launches, "median_ms": med,
            "eager_median_ms": e_med, "tokens_per_s": tokens / med * 1e3,
            "decode_median_ms": w_med, "decode_eager_median_ms": de_med,
            "decode_tokens_per_s": tokens / w_med * 1e3,
            "warm_s": run["warm_s"], "parity_warm_s": t_warm,
            "decode_warm_s": d_warm, "peak_bytes": run["peak_bytes"],
            "peak_reserved": run["peak_reserved"]}


def phase_sequence_ops(card: str) -> None:
    """warpctc (loss and gradients, through an fc), crf_decoding,
    ctc_greedy_decoder and edit_distance on small ragged inputs, the card
    against the CPU from the same weights."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (startup_params,
                                                      train_scope)

    B, T, D, C, LAB, N, H, R = 6, 20, 8, 7, 5, 6, 9, 8
    rng = np.random.RandomState(11)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers

        def lengths(name):
            return L.data(name, [-1], dtype="int32", append_batch_size=False)
        x = L.data("x", [T, D])
        logits = L.fc(x, C, num_flatten_dims=2)
        lab = L.data("lab", [LAB], dtype="int32")
        ll = lengths("ll")
        nll = L.warpctc(logits, lab, ll, lengths("tl"))
        loss = L.reduce_mean(nll)
        pg = fluid.backward.append_backward(loss)
        ids, n_ids = L.ctc_greedy_decoder(logits, ll)
        emis = L.data("e", [T, N])
        tags = L.crf_decoding(emis, lengths("el"))
        dist = L.edit_distance(L.data("h", [H], dtype="int32"),
                               lengths("hl"),
                               L.data("r", [R], dtype="int32"),
                               lengths("rl"), normalized=True)
    feed = {"x": rng.standard_normal((B, T, D)).astype(np.float32),
            "lab": rng.randint(1, C, (B, LAB)).astype(np.int32),
            "ll": np.array([T, 12, 7, T, 9, 15], np.int32),
            "tl": np.array([LAB, 0, 2, 3, 1, LAB], np.int32),
            "e": rng.standard_normal((B, T, N)).astype(np.float32),
            "el": np.array([1, T, 5, 11, T, 2], np.int32),
            "h": rng.randint(0, 4, (B, H)).astype(np.int32),
            "hl": np.array([0, H, 3, 5, 1, H], np.int32),
            "r": rng.randint(0, 4, (B, R)).astype(np.int32),
            "rl": np.array([R, 1, 4, 0, 6, R], np.int32)}
    feed["lab"][0, :3] = (2, 2, 4)              # repeated labels
    params = startup_params(main, startup, 0)
    fetch = [nll, ids, n_ids, tags, dist] + [g for _, g in pg]
    outs = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        outs[dev] = exe.run(main, feed=feed, fetch_list=fetch,
                            scope=train_scope(exe, startup, main, params,
                                              dev))
    (c_nll, c_ids, c_n, c_tags, c_d, *c_g), (h_nll, h_ids, h_n, h_tags,
                                             h_d, *h_g) = (outs["cuda"],
                                                           outs["cpu"])
    check(np.isfinite(c_nll).all(), "sequence ops: non-finite CTC loss")
    nll_rel = float((np.abs(c_nll - h_nll) / np.abs(h_nll)).max())
    grad_rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                   for a, b in zip(c_g, h_g))
    same = {"ctc_greedy_decoder": np.array_equal(c_ids, h_ids)
            and np.array_equal(c_n, h_n),
            "crf_decoding": np.array_equal(c_tags, h_tags),
            "edit_distance": np.array_equal(c_d, h_d)}
    print(f"sequence ops card vs CPU: warpctc loss {nll_rel:.3e} relative "
          f"(limit {SEQ_OPS_LOSS_REL}), {len(c_g)} gradients worst "
          f"max|d|/max|g| {grad_rel:.3e} (limit {SEQ_OPS_GRAD_REL}); equal "
          f"{same}; on {card}")
    check(nll_rel <= SEQ_OPS_LOSS_REL, f"sequence ops: warpctc loss differs "
                                       f"by {nll_rel} relative")
    check(grad_rel <= SEQ_OPS_GRAD_REL, f"sequence ops: warpctc gradients "
                                        f"differ by {grad_rel}")
    check(all(same.values()), f"sequence ops: card and CPU differ: {same}")


def phase_hier_text(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        HIER_BATCH, HIER_S, HIER_W, TRAIN_STEPS, build_hier_text_program,
        feed_sig, hier_text_batch, startup_params, train_scope)

    # the program, weights and batch of tools/train_profile.py --model
    # hier_text: build's defaults over IMDB's dictionary, Adam(3e-3),
    # weights from the port's startup program on the CPU, seed 0
    (loss, _, pred), main, startup = build_hier_text_program()
    params = startup_params(main, startup, 0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity: the B = 8 signature warmed, one replay against an unwarmed
    # Executor's eager step (bitwise) and against the CPU
    feed = hier_text_batch(1, HIER_PARITY_BATCH)
    fetch = [loss] + grad_names
    got, t_warm, _ = _replay_against_eager("hier_text train", exe, main,
                                           startup, params, feed, fetch)
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    _card_cpu_grads("hier_text train", got, want, grad_names)
    del got, want

    # the B = 64 signature warmed, TRAIN_STEPS replays on a fixed batch
    feed = hier_text_batch(0)
    tokens = int(feed["sub_len"].sum())
    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params), feed)
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"hier_text train: losses {losses}, expected finite and falling")
    med = float(np.median(run["step_ms"][1:]))
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, main, params)
    eager_ms = _event_ms(lambda: eager.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=eager_scope), 3)
    check(eager.replays == 0, "hier_text train: the eager Executor replayed")
    e_med = float(np.median(eager_ms[1:]))
    print(f"hier_text train: {TRAIN_STEPS} Adam steps on {HIER_BATCH} "
          f"documents x {HIER_S} sentences x {HIER_W} words ({tokens} "
          f"tokens), losses {', '.join(f'{x:.5f}' for x in losses)}; step "
          f"ms {', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.3f} ms = {tokens / med * 1e3:.0f} "
          f"tokens/s; eager {', '.join(f'{x:.2f}' for x in eager_ms)} ms, "
          f"median of 2-3 {e_med:.3f} ms ({tokens / e_med * 1e3:.0f} "
          f"tokens/s); {_pass_line(run)}; on {card}")
    _release()

    # serve: the program pruned to the prediction, its own signature
    smain = main.prune([pred])
    sfeed = hier_text_batch(0, train=False)
    sscope = train_scope(exe, startup, smain, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(smain, feed_sig(sfeed), [pred], scope=sscope)
    torch.cuda.synchronize()
    s_warm = time.perf_counter() - t0
    check(how == "compiled", f"hier_text serve: warm gave {how!r}")
    replays = exe.replays
    s_got, = exe.run(smain, feed=sfeed, fetch_list=[pred], scope=sscope)
    check(exe.replays == replays + 1, "hier_text serve: the warmed step did "
                                      "not replay")
    s_eager = fluid.Executor()
    s_eager_scope = train_scope(s_eager, startup, smain, params)
    s_want, = s_eager.run(smain, feed=sfeed, fetch_list=[pred],
                          scope=s_eager_scope)
    same = s_got.tobytes() == s_want.tobytes()
    print(f"hier_text serve replay vs eager: probabilities bitwise equal "
          f"{same}")
    check(same, "hier_text serve: the replay differs from the eager run")
    h_probs, = exe_cpu.run(smain, feed=sfeed, fetch_list=[pred],
                           scope=train_scope(exe_cpu, startup, smain, params,
                                             "cpu"))
    check(s_got.shape == (HIER_BATCH, 2) and np.isfinite(s_got).all(),
          f"hier_text serve: probabilities {s_got.shape}, finite "
          f"{np.isfinite(s_got).all()}")
    top = float(np.abs(h_probs).max())
    err = float(np.abs(s_got - h_probs).max())
    srt = np.sort(h_probs, axis=1)
    margins = srt[:, -1] - srt[:, -2]
    clear = margins > 2 * err
    equal = s_got.argmax(1) == h_probs.argmax(1)
    print(f"hier_text serve card (the warmed replay) vs CPU: probabilities "
          f"max|d| {err:.3e} ({err / top:.3e} of max, limit "
          f"{HIER_PROB_REL}); class equal in {int(equal.sum())} of "
          f"{HIER_BATCH}, {int(clear.sum())} with a top-two margin over "
          f"twice the difference (smallest margin {margins.min():.3e})")
    check(err <= HIER_PROB_REL * top, f"hier_text serve: probabilities "
                                      f"differ by {err / top} of max")
    check(bool(equal[clear].all()), "hier_text serve: the class differs "
                                    "where the margin exceeds twice the "
                                    "difference")
    w_ms = _event_ms(lambda: exe.run(smain, feed=sfeed, fetch_list=[pred],
                                     scope=sscope), TRAIN_STEPS)
    check(exe.replays == replays + 1 + TRAIN_STEPS,
          "hier_text serve: a timed step did not replay")
    se_ms = _event_ms(lambda: s_eager.run(smain, feed=sfeed,
                                          fetch_list=[pred],
                                          scope=s_eager_scope), 3)
    w_med, se_med = float(np.median(w_ms[1:])), float(np.median(se_ms[1:]))
    print(f"hier_text serve: {HIER_BATCH} documents ({tokens} tokens), "
          f"warmed in {s_warm:.2f} s; ms {', '.join(f'{x:.2f}' for x in w_ms)},"
          f" median of 2-{TRAIN_STEPS} {w_med:.3f} ms = "
          f"{HIER_BATCH / w_med * 1e3:.0f} documents/s; eager "
          f"{', '.join(f'{x:.2f}' for x in se_ms)}, median of 2-3 "
          f"{se_med:.3f} ms = {HIER_BATCH / se_med * 1e3:.0f} documents/s; "
          f"on {card}")
    return {"median_ms": med, "eager_median_ms": e_med,
            "tokens_per_s": tokens / med * 1e3, "warm_s": run["warm_s"],
            "parity_warm_s": t_warm, "peak_bytes": run["peak_bytes"],
            "peak_reserved": run["peak_reserved"],
            "serve_median_ms": w_med, "serve_eager_median_ms": se_med,
            "documents_per_s": HIER_BATCH / w_med * 1e3,
            "serve_warm_s": s_warm}


def _small_train(build, n=16, d=16, seed=13):
    """A small trained program: ``build(L, x, feed, rng)`` maps the feed
    x [n, d] to a hidden [n, k] (adding any feed it declares to ``feed``);
    an fc to 1, the squared error against y, its mean and Adam(1e-2), in
    new programs.  Returns (loss, main, startup, params as the port's
    startup draws them, feed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import startup_params

    rng = np.random.RandomState(seed)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [d])
        feed = {"x": rng.standard_normal((n, d)).astype(np.float32),
                "y": rng.standard_normal((n, 1)).astype(np.float32)}
        h = build(L, x, feed, rng)
        loss = L.mean(L.square_error_cost(L.fc(h, 1), L.data("y", [1])))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return loss, main, startup, startup_params(main, startup, 0), feed


def _step_card_cpu(label, loss, main, startup, params, feed, zero=(),
                   cancelled=()):
    """One eager step on the card and on the CPU from the same weights:
    the gradients named in ``zero`` exact zeros on both; those named in
    ``cancelled``, zero in exact arithmetic but not in float32 (a conv
    bias before a batch norm, which subtracts it again with the batch
    mean), within 1e-3 of the step's largest max |g|; the rest under the
    float32 train limit (``_card_cpu_grads``).  Returns the card Executor
    and scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    grads = [f"{n}@GRAD" for n in params]
    out = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = train_scope(exe, startup, main, params,
                            None if dev == "cuda" else "cpu")
        out[dev] = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                           scope=scope)
        if dev == "cuda":
            on_card = (exe, scope)
    for dev, vals in out.items():
        for g, v in zip(grads, vals[1:]):
            check((not v.any()) == (g[:-len("@GRAD")] in zero),
                  f"{label}: {g} on {dev} {'not ' if v.any() else ''}zero")
    top = max(float(np.abs(v).max()) for v in out["cpu"][1:])
    for i, g in enumerate(grads):
        if g[:-len("@GRAD")] in cancelled:
            d = float(np.abs(out["cuda"][1 + i] - out["cpu"][1 + i]).max())
            print(f"{label}: {g}, cancelled by a batch norm: max |g| "
                  f"{float(np.abs(out['cpu'][1 + i]).max()):.3e}, card vs "
                  f"CPU max|d| {d:.3e} = {d / top:.3e} of the largest max "
                  f"|g| (limit 1e-3)")
            check(d <= 1e-3 * top, f"{label}: {g} differs by {d / top} of "
                                   f"the largest gradient")
    keep = [i for i, g in enumerate(grads)
            if g[:-len("@GRAD")] not in set(zero) | set(cancelled)]
    _card_cpu_grads(label, [out["cuda"][0]] + [out["cuda"][1 + i]
                                               for i in keep],
                    [out["cpu"][0]] + [out["cpu"][1 + i] for i in keep],
                    [grads[i] for i in keep], what="an eager step")
    return on_card


def phase_control_flow(card: str) -> None:
    """cond (both predicates), the bounded and the unbounded while_loop,
    IfElse and md_lstm on the card against the CPU; warm refuses cond
    before any capture and run() then runs it eagerly; the bounded loop,
    IfElse and an md_lstm step warmed, each replay bitwise equal to the
    eager step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.graphs import WarmError
    from paddle_tpu_torch.tools.train_profile import (feed_sig,
                                                      startup_params,
                                                      train_scope)

    # cond: each branch its own fc; the untaken one's gradients zero
    def cond_build(L, x, feed, rng):
        p = L.data("p", [-1], dtype="bool", append_batch_size=False)
        return L.cond(p, lambda: L.fc(x, 32, act="tanh"),
                      lambda: L.fc(x, 32))
    loss, main, startup, params, feed = _small_train(cond_build)
    op = next(o for o in main.list_ops() if o.type == "cond")
    for pred in (True, False):
        feed["p"] = np.array([pred])
        untaken = set((op.else_block if pred else op.sub_block)
                      .program._parameters)
        exe, scope = _step_card_cpu(f"cond ({pred})", loss, main, startup,
                                    params, feed, zero=untaken)
    compiles, refused = exe.compiles, None
    try:
        exe.warm(main, feed_sig(feed), [loss], scope=scope)
    except WarmError as err:
        refused = str(err)
    check(refused is not None and exe.compiles == compiles,
          "control flow: Executor.warm did not refuse the cond program")
    l_run, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    check(np.isfinite(l_run) and exe.replays == 0,
          "control flow: run() after the refused warm failed")
    print(f"control flow cond: warm refused before any capture "
          f"({refused[:60]}...); run() afterwards eager on the card, loss "
          f"{float(l_run):.6f}")

    # the bounded and the unbounded loop, three trips of s * 0.5 + tanh(s)
    # over an fc's output
    def while_build(max_trip_count):
        def build(L, x, feed, rng):
            i0 = L.fill_constant([1], "int32", 0)
            h = L.fc(x, 32, act="tanh")
            return L.while_loop(lambda i, s: (i < 3)[0],
                                lambda i, s: (i + 1, s * 0.5 + torch.tanh(s)),
                                [i0, h], max_trip_count=max_trip_count)[1]
        return build

    def ifelse_build(L, x, feed, rng):
        m = L.data("m", [1], dtype="bool")
        feed["m"] = rng.rand(feed["x"].shape[0], 1) > 0.5
        ie = L.IfElse(m)
        with ie.true_block():
            ie.output(L.fc(ie.input(x), 32, act="tanh"))
        with ie.false_block():
            ie.output(L.fc(ie.input(x), 32))
        h, = ie()
        return h

    warmed = fluid.Executor()
    for label, build in (("while_loop bounded", while_build(4)),
                         ("IfElse", ifelse_build)):
        loss, main, startup, params, feed = _small_train(build)
        _step_card_cpu(label, loss, main, startup, params, feed)
        _replay_against_eager(label, warmed, main, startup, params, feed,
                              [loss] + [f"{n}@GRAD" for n in params])
    loss, main, startup, params, feed = _small_train(while_build(None))
    _step_card_cpu("while_loop unbounded", loss, main, startup, params, feed)

    # md_lstm in the four sweep directions, card against CPU
    N, H, W, D = MDLSTM_SHAPE
    rng = np.random.RandomState(17)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [H, W, D])
        outs = [L.md_lstm(x, MDLSTM_SIZE, reverse_h=rh, reverse_w=rw)
                for rh in (False, True) for rw in (False, True)]
        total = L.sums([L.mean(o) for o in outs])
        pg = fluid.backward.append_backward(total)
    params = startup_params(main, startup, 0)
    feed = {"x": rng.standard_normal((N, H, W, D)).astype(np.float32)}
    fetch = outs + [g for _, g in pg]
    res = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        t0 = time.perf_counter()
        res[dev] = exe.run(main, feed=feed, fetch_list=fetch,
                           scope=train_scope(exe, startup, main, params,
                                             None if dev == "cuda"
                                             else "cpu"))
        res[dev + " s"] = time.perf_counter() - t0
    fwd = max(_rel(a, b) for a, b in zip(res["cuda"][:4], res["cpu"][:4]))
    grad = max(_rel(a, b) for a, b in zip(res["cuda"][4:], res["cpu"][4:]))
    print(f"control flow md_lstm [{N}, {H}, {W}, {D}] -> {MDLSTM_SIZE}, four "
          f"directions, card vs CPU: hidden states worst max|d|/max|.| "
          f"{fwd:.3e} (limit {MDLSTM_FWD_REL}), {len(pg)} gradients worst "
          f"{grad:.3e} (limit {MDLSTM_GRAD_REL}); step {res['cuda s']:.2f} s "
          f"card (first, eager), {res['cpu s']:.2f} s CPU")
    check(all(np.isfinite(a).all() for a in res["cuda"]),
          "control flow md_lstm: non-finite values on the card")
    check(fwd <= MDLSTM_FWD_REL, f"control flow md_lstm: hidden states "
                                 f"differ by {fwd} of max")
    check(grad <= MDLSTM_GRAD_REL, f"control flow md_lstm: gradients differ "
                                   f"by {grad} of max")

    # a warmed md_lstm -> mean step at the same size, bitwise against eager
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = fluid.layers.mean(fluid.layers.md_lstm(
            fluid.layers.data("x", [H, W, D]), MDLSTM_SIZE, reverse_w=True))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    params = startup_params(main, startup, 0)
    _replay_against_eager("md_lstm train", warmed, main, startup, params,
                          feed, [loss] + [f"{n}@GRAD" for n in params])
    print(f"control flow: warmed bounded while_loop, IfElse and md_lstm "
          f"steps, replays {warmed.replays}, compiles {warmed.compiles}; "
          f"on {card}")


def _bn_bound(kernel: str, n: int, c: int, hw: int, dtype) -> tuple:
    """(bound_ms, bound_by) for one call: each input read once and each
    output written once (reduction: dy and x in, mean and rstd in, dbeta
    and dgamma out; dx: dy and x in, five per-channel vectors in, dx out);
    operations, float32 on the CUDA cores: 3 an element in the reduction
    (add, subtract, multiply-add), 4 in dx."""
    it = torch.empty((), dtype=dtype).element_size()
    elems = n * c * hw
    nbytes = ({"reduce": 2, "dx": 3}[kernel] * elems * it
              + {"reduce": 4, "dx": 5}[kernel] * c * 4)
    ops = {"reduce": 3, "dx": 4}[kernel] * elems
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bn_inputs(n, c, h, w, dtype, dev, seed):
    """dy N(0, 1) and x N(0.5, 2^2) in ``dtype`` on the card (channel c // 2
    constant), their batch mean and rstd in float32, gamma in [0.5, 1.5)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=gen, device=dev) * 2 + 0.5
    x[:, c // 2] = 1.25
    dy = torch.randn((n, c, h, w), generator=gen, device=dev)
    x, dy = x.to(dtype), dy.to(dtype)
    x32 = x.float()
    mean = x32.mean((0, 2, 3))
    var = torch.clamp_min(x32.square().mean((0, 2, 3)) - mean.square(), 0.0)
    del x32
    rstd = torch.rsqrt(var + BN_EPS)
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    return dy, x, mean, rstd, gamma


def _bn_case(label, n, c, h, w, dtype, dev, card) -> dict:
    """Both kernels against their plain versions on the same inputs; for
    the probe's shape also the times.  Returns the records by kernel."""
    from paddle_tpu_torch.ops import batch_norm as TB

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    name = f"bn {label} [{n},{c},{h},{w}] {kind}"
    dy, x, mean, rstd, gamma = _bn_inputs(n, c, h, w, dtype, dev,
                                          n + c + h * w)
    kb, kg = TB.bn_bwd_reduce_kernel(dy, x, mean, rstd)
    torch.cuda.synchronize()
    pb, pg = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    dyf = dy.float()
    abs_dy = dyf.abs().sum((0, 2, 3))
    xhat = (x.float() - mean[None, :, None, None]) * rstd[None, :, None, None]
    abs_dg = (dyf * xhat).abs().sum((0, 2, 3))
    del dyf, xhat
    w_red = max(float(((kb - pb).abs() / (BN_SUM_REL * abs_dy + 1e-30)).max()),
                float(((kg - pg).abs() / (BN_SUM_REL * abs_dg + 1e-30)).max()))
    ok = w_red <= 1.0 and bool(torch.isfinite(kb).all()
                               and torch.isfinite(kg).all())
    err_red = max(_abs(kb, pb), _abs(kg, pg))
    print(f"kernel {name}: reduce max|d|={err_red:.3e}, worst |d|/limit "
          f"{w_red:.3f} (limit {BN_SUM_REL} sum |dy|, sum |dy xhat| per "
          f"channel) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: reduction kernel disagrees with its plain version "
              f"({w_red} of its limit)")

    # both dx versions from the plain reduction's dbeta, dgamma
    kdx = TB.bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, pb, pg)
    torch.cuda.synchronize()
    pdx = TB.bn_bwd_dx_reference(dy, x, mean, rstd, gamma, pb, pg)
    check(kdx.dtype == dtype and kdx.shape == dy.shape,
          f"{name}: dx kernel returned {kdx.dtype} {tuple(kdx.shape)}")
    check(bool(torch.isfinite(kdx.float()).all()), f"{name}: non-finite dx")
    top = float(pdx.float().abs().max())
    err_dx = _abs(kdx, pdx)
    if kind == "float32":
        w_dx, lim = err_dx / (BN_DX_REL * top), f"{BN_DX_REL} max|dx|"
    else:
        w_dx = _worst(kdx, pdx, 2 * BF16_U * pdx.float().abs()
                      + BN_BF16_SUM_REL * top)
        lim = f"2u |dx| + {BN_BF16_SUM_REL} max|dx| per element"
    ok = w_dx <= 1.0
    print(f"kernel {name}: dx max|d|={err_dx:.3e} ({err_dx / top:.3e} of "
          f"max|dx|), worst |d|/limit {w_dx:.3f} (limit {lim}) "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: dx kernel disagrees with its plain version "
              f"({w_dx} of its limit)")
    # the count argument (a rank's rows of a batch of 2 x N under data
    # parallelism: M the global count), against the plain version with it
    m2 = 2 * n * h * w
    kdx2 = TB.bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, pb, pg, count=m2)
    torch.cuda.synchronize()
    pdx2 = TB.bn_bwd_dx_reference(dy, x, mean, rstd, gamma, pb, pg, m2)
    top2 = float(pdx2.float().abs().max())
    err2 = _abs(kdx2, pdx2)
    w2 = (err2 / (BN_DX_REL * top2) if kind == "float32" else
          _worst(kdx2, pdx2, 2 * BF16_U * pdx2.float().abs()
                 + BN_BF16_SUM_REL * top2))
    print(f"kernel {name}: dx with count M = {m2} (twice the batch's) "
          f"max|d|={err2:.3e}, worst |d|/limit {w2:.3f} "
          f"{'ok' if w2 <= 1.0 else 'MISMATCH'}")
    check(w2 <= 1.0 and not torch.equal(kdx2, kdx),
          f"{name}: dx kernel with a count argument disagrees with its "
          f"plain version ({w2} of its limit) or ignores it")
    del kdx2, pdx2
    if label != "probe":
        return {}

    # times at the probe's shape (dy and x are 411 MB each in bf16, far
    # past the 50 MB L2: every call streams them from device memory)
    kern_fn = {"reduce": lambda i: TB.bn_bwd_reduce_kernel(dy, x, mean,
                                                           rstd),
               "dx": lambda i: TB.bn_bwd_dx_kernel(dy, x, mean, rstd, gamma,
                                                   pb, pg)}
    plain_fn = {"reduce": lambda i: TB.bn_bwd_reduce_reference(dy, x, mean,
                                                               rstd),
                "dx": lambda i: TB.bn_bwd_dx_reference(dy, x, mean, rstd,
                                                       gamma, pb, pg)}
    ms, dev_ms, plain, plain_dev = {}, {}, {}, {}
    for kern in BN_KERNELS:
        ms[kern], dev_ms[kern] = both_ms(kern_fn[kern])
        plain[kern], plain_dev[kern] = both_ms(plain_fn[kern], iters=10)

    # the library yardstick for the pair: dx, dgamma and dbeta in one call
    def library(i):
        torch.ops.aten.native_batch_norm_backward(
            dy, x, gamma, None, None, mean, rstd, True, BN_EPS,
            [True, True, True])

    lib_ms, lib_dev = both_ms(library)
    lx, lg, lb = torch.ops.aten.native_batch_norm_backward(
        dy, x, gamma, None, None, mean, rstd, True, BN_EPS, [True, True, True])
    print(f"kernel {name}: native_batch_norm_backward against the plain "
          f"versions: dx {_abs(lx, pdx) / top:.3e} of max|dx|, dgamma "
          f"{_abs(lg, pg):.3e}, dbeta {_abs(lb, pb):.3e}")
    del lx, lg, lb
    recs = {}
    for kern in BN_KERNELS:
        bound_ms, bound_by = _bn_bound(kern, n, c, h * w, dtype)
        recs[kern] = {
            "max_abs_err": err_red if kern == "reduce" else err_dx,
            "ms": ms[kern], "device_ms": dev_ms[kern],
            "plain_ms": plain[kern], "plain_device_ms": plain_dev[kern],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no PyTorch call computes the reduction alone or dx alone: the
            # pair's yardstick stands beside each
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "library": "native_batch_norm_backward (dx, dgamma and dbeta)"}
        print(f"kernel bn {kern} {kind} probe shape: {ms[kern]:.4f} ms "
              f"(device {dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms "
              f"(device {plain_dev[kern]:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}; device time {bound_ms / dev_ms[kern]:.3f} of "
              f"it) on {card}")
    print(f"kernel bn {kind} probe shape: the pair {ms['reduce'] + ms['dx']:.4f}"
          f" ms (device {dev_ms['reduce'] + dev_ms['dx']:.4f}), "
          f"native_batch_norm_backward {lib_ms:.4f} ms (device "
          f"{lib_dev:.4f}) on {card}")
    return recs


def phase_bn_kernels(card: str) -> dict:
    """Every batch-norm case in float32 and bfloat16; returns the
    probe-shape records by dtype and kernel for the JSON line."""
    dev = torch.device("cuda")
    records = {}
    for label, n, c, h, w in BN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            recs = _bn_case(label, n, c, h, w, dtype, dev, card)
            if recs:
                records["float32" if dtype == torch.float32
                        else "bfloat16"] = recs
            torch.cuda.empty_cache()
    return records


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _resnet_parity(card: str) -> None:
    """One float32 step (TF32 off) of ResNet-50 on RESNET_PARITY_BATCH
    images on the card and on the CPU from the same weights: the loss
    within rtol 1e-4 and every running statistic after the step within
    1e-3 of its max |.|.

    The gradients of this network at its random initialisation are
    chaotic at float32's resolution: a float32 rounding flips a ReLU here
    and there (about 100 of them in the forward), and each batch norm
    spreads a flipped element's gradient over its whole channel (196
    values a channel at the last stage).  On the CPU alone, multiplying
    the images by (1 + 1e-7 N(0, 1)) moves 159 of the 161 gradients by
    more than 1e-3 of their max |.| (up to 0.19), and by 2.3% in L2 each
    (median).  So each gradient is held, in relative L2, within max(1e-3,
    RESNET_FLOOR_FACTOR x its floor), and all of them together within
    RESNET_FLOOR_FACTOR x the floor of all of them, where a floor is the
    larger spread of two such CPU steps (noise seeds 5 and 6) from the
    unperturbed one, measured in this run.  Six more CPU draws reached at
    most 1.32 x a floor of two."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (build_resnet_program,
                                                      resnet_batch,
                                                      resnet_params,
                                                      train_scope)

    loss, main, startup = build_resnet_program(amp=False)
    params = resnet_params(0)
    grad_names = [f"{n}@GRAD" for n in params]
    stat_names = sorted(v.name for v in main.persistable_vars()
                        if v.name.endswith((".w_mean", ".w_var")))
    check(len(stat_names) == 2 * RESNET_BN_LAYERS,
          f"resnet: {len(stat_names)} running statistics")
    feed = resnet_batch(1, RESNET_PARITY_BATCH, "cpu")

    def step(dev, images):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        check(dev == "cpu" or not torch.backends.cudnn.allow_tf32,
              "cuDNN TF32 is on: the float32 contract needs it off")
        scope = train_scope(exe, startup, main, params,
                            None if dev == "cuda" else "cpu")
        t0 = time.perf_counter()
        out = exe.run(main, feed=dict(feed, img=images),
                      fetch_list=[loss] + grad_names, scope=scope)
        secs = time.perf_counter() - t0
        return (float(out[0]), out[1:],
                [scope.find_var(n).cpu().numpy() for n in stat_names], secs)

    l_gpu, g_gpu, s_gpu, t_gpu = step("cuda", feed["img"])
    l_cpu, g_cpu, s_cpu, t_cpu = step("cpu", feed["img"])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"resnet parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst_s, worst_s_name = max((_rel(a, b), n) for n, a, b in
                                zip(stat_names, s_gpu, s_cpu))
    check(worst_s <= 1e-3, f"resnet parity step: running statistic "
                           f"{worst_s_name} differs by {worst_s} of its max")
    for name, a in zip(grad_names, g_gpu):
        check(np.isfinite(a).all(), f"resnet parity step: non-finite {name}")
    flat = lambda gs: np.concatenate([g.ravel() for g in gs])  # noqa: E731
    floor, floor_max, floor_all = np.zeros(len(grad_names)), 0.0, 0.0
    for seed in (5, 6):
        noise = torch.from_numpy(np.random.RandomState(seed).standard_normal(
            tuple(feed["img"].shape)).astype(np.float32))
        _, g_p, _, _ = step("cpu", feed["img"] * (1 + 1e-7 * noise))
        floor = np.maximum(floor, [_rel_l2(a, b) for a, b in zip(g_p, g_cpu)])
        floor_max = max(floor_max, max(_rel(a, b) for a, b in zip(g_p, g_cpu)))
        floor_all = max(floor_all, _rel_l2(flat(g_p), flat(g_cpu)))
    ratios = np.array([_rel_l2(a, b) for a, b in zip(g_gpu, g_cpu)]) \
        / np.maximum(1e-3, RESNET_FLOOR_FACTOR * floor)
    worst, worst_name = float(ratios.max()), grad_names[int(ratios.argmax())]
    all_l2 = _rel_l2(flat(g_gpu), flat(g_cpu))
    worst_max = max(_rel(a, b) for a, b in zip(g_gpu, g_cpu))
    print(f"resnet train parity (float32, TF32 off, {RESNET_PARITY_BATCH} "
          f"images): loss {l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol 1e-4); "
          f"{len(stat_names)} running statistics, worst {worst_s:.3e} of "
          f"max ({worst_s_name}; limit 1e-3); {len(grad_names)} gradients, "
          f"relative L2: the CPU's floor under a 1e-7 change of the images "
          f"median {np.median(floor):.3e} (max |d|/max up to "
          f"{floor_max:.3e}), card vs CPU worst {worst:.3f} of its limit "
          f"({worst_name}; max(1e-3, {RESNET_FLOOR_FACTOR} x floor)), "
          f"max |d|/max up to {worst_max:.3e}; all together {all_l2:.3e}, "
          f"floor {floor_all:.3e} (limit {RESNET_FLOOR_FACTOR} x); step "
          f"{t_gpu:.2f} s card (first), {t_cpu:.2f} s CPU")
    check(worst <= 1.0, f"resnet parity step: {worst_name} differs beyond "
                        f"its limit ({worst})")
    check(all_l2 <= RESNET_FLOOR_FACTOR * floor_all,
          f"resnet parity step: the gradients differ by {all_l2} in L2, "
          f"limit {RESNET_FLOOR_FACTOR * floor_all}")


def _resnet_arm(amp: bool, card: str) -> dict:
    """TRAIN_STEPS steps of one arm on a fixed batch that stays on the card;
    the batch-norm counts are this pass's own."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import batch_norm_train
    from paddle_tpu_torch.tools.train_profile import (
        RESNET_BATCH, RESNET_FP32_BATCH, TRAIN_STEPS, build_resnet_program,
        resnet_batch, resnet_params, train_scope)

    arm = "amp" if amp else "float32"
    n = RESNET_BATCH if amp else RESNET_FP32_BATCH
    loss, main, startup = build_resnet_program(amp)
    exe = fluid.Executor()
    scope = train_scope(exe, startup, main, resnet_params(0))
    feed = resnet_batch(0, n, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in BN_KERNELS:
        batch_norm_train.launches[kern] = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(batch_norm_train.launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"resnet {arm}: non-finite losses "
                                    f"{losses}")
    want = RESNET_BN_LAYERS * TRAIN_STEPS
    check(all(launches[k] == want for k in BN_KERNELS),
          f"resnet {arm}: batch-norm launches {launches}, expected "
          f"{RESNET_BN_LAYERS} x {TRAIN_STEPS} each")
    if amp:
        dtypes = {str(v.dtype) for _, v in scope.items()}
        check(dtypes <= {"torch.float32", "torch.int32"},
              f"resnet amp: master state not float32: {dtypes}")
    med = float(np.median(step_ms[1:]))
    cut = "" if n == RESNET_BATCH else f" (cut from {RESNET_BATCH} to fit)"
    print(f"resnet train {arm}: {TRAIN_STEPS} Momentum steps on {n} images"
          f"{cut}, losses {', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps 2-"
          f"{TRAIN_STEPS} {med:.2f} ms = {n / med * 1e3:.1f} images/s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"batch-norm launches {launches} = {RESNET_BN_LAYERS} layers x "
          f"{TRAIN_STEPS} steps; on {card}")
    return {"launches": launches, "losses": losses, "median_ms": med,
            "images_per_s": n / med * 1e3, "batch": n,
            "peak_memory_bytes": peak}


def phase_resnet_train(card: str) -> dict:
    # float32 convolutions in full float32: cuDNN's TF32 default is on (the
    # port's Executor turns it off on the card too)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _resnet_parity(card)
    arms = {}
    for amp in (True, False):
        arms["amp" if amp else "float32"] = _resnet_arm(amp, card)
        torch.cuda.empty_cache()
    return arms


def _conv_bound(kernel: str, n, h, w, c, o, dtype, ffma=False) -> tuple:
    """(bound_ms, bound_by) for one call: x, w (and a, b) read once and the
    output written once; operations are the 2 N H W 9 C O of the nine taps
    on the tensor cores (bfloat16 at its peak; float32 as TF32_PASSES TF32
    products, the least that gives a float32-accurate product there, or,
    with ``ffma``, at the CUDA cores' float32 peak), plus, fused, 3 float32
    operations an output (scale, shift, ReLU) on the CUDA cores."""
    it = torch.empty((), dtype=dtype).element_size()
    fused = kernel == "fused"
    nbytes = (n * h * w * c + 9 * c * o + n * h * w * o) * it \
        + (2 * o * 4 if fused else 0)
    rate = (PEAK_OPS_PER_S[dtype] if dtype != torch.float32 or ffma
            else TF32_OPS_PER_S / TF32_PASSES)
    t_ops = 2.0 * n * h * w * 9 * c * o / rate \
        + (3.0 * n * h * w * o / PEAK_OPS_PER_S[torch.float32] if fused
           else 0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _conv_case(label, n, h, w, c, o, dtype, dev, card, want_route: str,
               timed: bool, kernels=CONV_KERNELS) -> dict:
    """``kernels`` against their plain versions on the same inputs, each
    on its route (conv_route must give ``want_route``, and the route
    counts must show it: ResNet shapes take the halo kernel in bfloat16
    and the halo_f32 kernel in float32, the ragged ones the gather
    kernel); when ``timed`` also the times.  Returns the records by
    kernel."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv as TC

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    name = f"conv {label} [{n},{h},{w},{c}]x{o} {kind}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + h * w + c + o)
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((3, 3, c, o), generator=gen, device=dev)
          / (9 * c) ** 0.5).to(dtype)
    a = torch.rand(o, generator=gen, device=dev) + 0.5
    b = torch.randn(o, generator=gen, device=dev) * 0.3
    kern = {"igemm": lambda i: TC.igemm_conv_kernel(x, wt),
            "fused": lambda i: TC.igemm_conv_fused_kernel(x, wt, a, b)}
    plain = {"igemm": lambda i: TC.igemm_conv_reference(x, wt),
             "fused": lambda i: TC.igemm_conv_fused_reference(x, wt, a, b)}
    route = TC.conv_route(dtype, n, h, w, c, o, True)
    check(route == want_route, f"{name}: conv_route gives the {route} "
                               f"route, not {want_route}")
    errs = {}
    for k in kernels:
        before = dict(TC.route_launches)
        got = kern[k](0)
        torch.cuda.synchronize()
        took = {r: TC.route_launches[r] - before[r] for r in before}
        check(took == {r: int(r == route) for r in took},
              f"{name} {k}: route launches {took}, expected the {route} "
              f"route")
        want = plain[k](0)
        check(got.dtype == dtype and got.shape == (n, h, w, o),
              f"{name} {k}: kernel returned {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} {k}: non-finite kernel output")
        top = float(want.float().abs().max())
        errs[k] = _abs(got, want)
        if kind == "float32":
            worst = errs[k] / (CONV_F32_REL * top)
            lim = f"{CONV_F32_REL} max|out|"
        else:
            worst = _worst(got, want, 2 * BF16_U * want.float().abs()
                           + CONV_BF16_SUM_REL * top)
            lim = f"2u |out| + {CONV_BF16_SUM_REL} max|out| per element"
        print(f"kernel {name} {k} ({route} route): max|d|={errs[k]:.3e} "
              f"({errs[k] / top:.3e} of max|out|), worst |d|/limit "
              f"{worst:.3f} (limit {lim}) "
              f"{'ok' if worst <= 1.0 else 'MISMATCH'}")
        check(worst <= 1.0, f"{name}: {k} kernel disagrees with its plain "
                            f"version ({worst} of its limit)")
        del got, want
    if not timed:
        return {}

    # the yardstick: cuDNN on the same NHWC tensor, seen as a channels_last
    # NCHW view, and on an NCHW copy; the fused form's batch-norm scale and
    # shift and ReLU as separate passes, in the dtype, as the probe's XLA
    # yardstick computes them
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    x_cl = x.permute(0, 3, 1, 2)
    x_nchw = x_cl.contiguous()
    a_r, b_r = a.to(dtype).view(1, -1, 1, 1), b.to(dtype).view(1, -1, 1, 1)
    lib = {
        ("igemm", "channels_last"): lambda i: F.conv2d(x_cl, w_oihw,
                                                       padding=1),
        ("igemm", "nchw"): lambda i: F.conv2d(x_nchw, w_oihw, padding=1),
        ("fused", "channels_last"): lambda i: torch.relu(
            F.conv2d(x_cl, w_oihw, padding=1) * a_r + b_r),
        ("fused", "nchw"): lambda i: torch.relu(
            F.conv2d(x_nchw, w_oihw, padding=1) * a_r + b_r)}
    recs = {}
    for k in kernels:
        ms, dev_ms = both_ms(kern[k])
        pl_ms, pl_dev = both_ms(plain[k], iters=5, warmup=1)
        lib_t = {lay: both_ms(lib[(k, lay)]) for lay in ("channels_last",
                                                         "nchw")}
        want = plain[k](0).float()
        lib_err = _abs(lib[(k, "channels_last")](0).permute(0, 2, 3, 1),
                       want) / float(want.abs().max())
        bound_ms, bound_by = _conv_bound(k, n, h, w, c, o, dtype)
        recs[k] = {
            "conv_route": route,
            "max_abs_err": errs[k], "ms": ms, "device_ms": dev_ms,
            "plain_ms": pl_ms, "plain_device_ms": pl_dev,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_t["channels_last"][0],
            "library_device_ms": lib_t["channels_last"][1],
            "library_nchw_ms": lib_t["nchw"][0],
            "library_nchw_device_ms": lib_t["nchw"][1],
            "library": ("F.conv2d (cuDNN)" if k == "igemm" else
                        "F.conv2d (cuDNN), then * a + b and relu as "
                        "separate passes") + " on the channels_last view"}
        ffma = ""
        if dtype == torch.float32:   # the CUDA cores' FFMA bound beside it
            recs[k]["bound_ffma_ms"] = _conv_bound(k, n, h, w, c, o, dtype,
                                                   ffma=True)[0]
            ffma = (f"; FFMA bound {recs[k]['bound_ffma_ms']:.4f} ms, "
                    f"{recs[k]['bound_ffma_ms'] / dev_ms:.3f} of it")
        print(f"kernel {name} {k} ({route} route): {ms:.4f} ms (device "
              f"{dev_ms:.4f}), plain "
              f"{pl_ms:.4f} ms (device {pl_dev:.4f}), cuDNN channels_last "
              f"{lib_t['channels_last'][0]:.4f} ms (device "
              f"{lib_t['channels_last'][1]:.4f}), NCHW "
              f"{lib_t['nchw'][0]:.4f} ms (device {lib_t['nchw'][1]:.4f}; "
              f"its error {lib_err:.3e} of max|out|), bound {bound_ms:.4f} "
              f"ms ({bound_by}; device time {bound_ms / dev_ms:.3f} of it"
              f"{ffma}) on {card}")
    return recs


def phase_conv_kernels(card: str) -> dict:
    """Every conv case in float32 and bfloat16, and the CONV_MODEL_CASES
    in their dtypes (the plain kernel, timed); returns the timed records
    by dtype, shape and kernel for the JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    torch.backends.cudnn.allow_tf32 = False         # the yardstick
    dev = torch.device("cuda")
    records = {}
    cases = [(label, n, h, w, c, o, dtype,
              dict(want_route=(CONV_ROUTE[dtype] if label in CONV_RESNET
                               else "gather"),
                   timed=label in CONV_TIMED[dtype]))
             for label, n, h, w, c, o in CONV_CASES
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(label, n, h, w, c, o, dtype,
               dict(want_route=route, timed=True,
                    kernels=(CONV_KERNELS if label in CONV_GATHER_FUSED
                             else ("igemm",))))
              for label, n, h, w, c, o, routes in CONV_MODEL_CASES
              for dtype, route in routes.items()]
    from paddle_tpu_torch.ops import _build

    for name, regs, spill in _ptxas_report(_build.build_logs.get("conv.cu",
                                                                 "")):
        if name.startswith("igemm_kernel"):
            print(f"conv gather instance {name}: {regs} registers, {spill} "
                  f"bytes spilled")
    for label, n, h, w, c, o, dtype, kw in cases:
        recs = _conv_case(label, n, h, w, c, o, dtype, dev, card, **kw)
        if recs:
            records.setdefault("float32" if dtype == torch.float32
                               else "bfloat16", {})[label] = recs
        torch.cuda.empty_cache()
    return records


def _softmax_input(program, pred_name: str) -> str:
    (sm,) = [op for op in program.list_ops() if op.type == "softmax"
             and op.outputs["Out"] == [pred_name]]
    return sm.inputs["X"][0]


def _infer_parity(card: str, label: str, build, arrays: dict,
                  feed: dict) -> None:
    """A pruned, routed inference program (``build(amp)`` -> (prediction,
    program, startup)) on the images of ``feed`` on the card and on the
    CPU (the plain versions) from the same ``arrays`` (weights and any
    running statistics).  float32 (TF32 off): the fc's pre-softmax logits
    within INFER_F32_REL of max |.|, and the same top-1 class wherever the
    top two are further apart than twice the largest difference (the
    margins are printed).  The card's running statistics are left bitwise
    as loaded.

    amp: a one-rounding element-wise bound (2u |.| + CONV_BF16_SUM_REL
    max |.|) does not hold through 50 bfloat16 layers even for the CPU
    against itself: float32 sums in another order, or images times (1 +
    1e-7 N(0, 1)), flip a bfloat16 rounding here and there, and the flips
    compound (on the CPU alone, such a draw moved ResNet-50's logits by
    32, one bfloat16 ulp at their largest values and 0.7% of their max,
    as far as the card is from the CPU).  So the bfloat16 logits are held,
    like the ResNet-50 training gradients (_resnet_parity), to the CPU's
    own spread under that change of the images, measured in this run: in
    max |.| and in relative L2 within RESNET_FLOOR_FACTOR x the larger
    spread of two draws (noise seeds 5 and 6), unless they are within the
    element-wise bound anyway."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    n_img = int(feed["img"].shape[0])
    stats = sorted(n for n in arrays if n.endswith((".w_mean", ".w_var")))
    ref32 = None   # the CPU's float32 logits, from the first arm
    for amp in (False, True):
        arm = "amp" if amp else "float32"
        pred, program, startup = build(amp)
        logits = _softmax_input(program, pred.name)
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
            scope = train_scope(exe, startup, program, arrays,
                                None if dev == "cuda" else "cpu")
            t0 = time.perf_counter()
            out[dev] = exe.run(program, feed=feed, fetch_list=[logits],
                               scope=scope)[0]
            secs[dev] = time.perf_counter() - t0
            if dev == "cuda":
                for n in stats:
                    check(np.array_equal(scope.find_var(n).cpu().numpy(),
                                         arrays[n]),
                          f"{label} {arm}: running statistic {n} changed")
        floor_max = floor_l2 = 0.0
        if amp:   # the CPU's own spread (see above); exe, scope: the CPU's
            for seed in (5, 6):
                noise = torch.from_numpy(np.random.RandomState(
                    seed).standard_normal(tuple(feed["img"].shape)).astype(
                    np.float32))
                moved = exe.run(program, fetch_list=[logits], scope=scope,
                                feed={"img": feed["img"] * (1 + 1e-7 * noise)}
                                )[0]
                floor_max = max(floor_max,
                                float(np.abs(moved - out["cpu"]).max()))
                floor_l2 = max(floor_l2, _rel_l2(moved, out["cpu"]))
        got, want = out["cuda"], out["cpu"]
        check(got.shape == (n_img, 1000) and np.isfinite(got).all(),
              f"{label} parity {arm}: logits {got.shape}, finite "
              f"{np.isfinite(got).all()}")
        top = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if amp:
            worst = float((np.abs(got - want) / (2 * BF16_U * np.abs(want)
                                                 + CONV_BF16_SUM_REL * top)
                           ).max())
            l2 = _rel_l2(got, want)
            floor_ok = (err <= RESNET_FLOOR_FACTOR * floor_max
                        and l2 <= RESNET_FLOOR_FACTOR * floor_l2)
            lim = (f"2u |.| + {CONV_BF16_SUM_REL} max|.| per element; or "
                   f"{RESNET_FLOOR_FACTOR} x the CPU's floor under a 1e-7 "
                   f"change of the images: max|d| {floor_max:.3e}, relative "
                   f"L2 {floor_l2:.3e}, card vs CPU relative L2 {l2:.3e}, "
                   f"within it: {floor_ok}; amp against float32 on the CPU "
                   f"{_rel(want, ref32):.3e} of max")
            ok = worst <= 1.0 or floor_ok
        else:
            worst = err / (INFER_F32_REL * top)
            lim = f"{INFER_F32_REL} max|.|"
            ok = worst <= 1.0
            ref32 = want
        srt = np.sort(want, axis=1)
        margins = srt[:, -1] - srt[:, -2]
        clear = margins > 2 * err
        same = got.argmax(1) == want.argmax(1)
        print(f"{label} parity ({arm}{', TF32 off' if not amp else ''}, "
              f"{n_img} images): logits max|d| {err:.3e} "
              f"({err / top:.3e} of max), worst |d|/limit {worst:.3f} (limit "
              f"{lim}); top-1 equal {same.tolist()}, top-two margins "
              f"{', '.join(f'{m:.3e}' for m in margins)}; step "
              f"{secs['cuda']:.2f} s card (first), {secs['cpu']:.2f} s CPU")
        check(ok, f"{label} parity {arm}: logits differ beyond their "
                  f"limit ({worst} of the element-wise bound)")
        if not amp:
            check(bool(same[clear].all()),
                  f"{label} parity float32: top-1 differs where the "
                  f"margin exceeds twice the difference: {same}, {margins}")


def _infer_arm(arm: str, fetch: list, program, startup, arrays: dict,
               feed: dict, launches_a_step: dict, routes_a_step: dict,
               card: str) -> dict:
    """TRAIN_STEPS inference steps of one arm (the pruned ``program``,
    ``fetch`` fetched) on ``feed``, which stays on the card (_eager_arm);
    the conv counts are this pass's own and must be ``launches_a_step``
    and ``routes_a_step`` times the steps.  Returns the arm's numbers and,
    under "last", the last step's fetches."""
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS

    n = int(feed["img"].shape[0])
    r = _eager_arm(arm, fetch, program, startup, arrays, feed, n, card)
    launches = r["counts"]["conv.launches"]
    routes = r["counts"]["conv.route_launches"]
    want = {k: v * TRAIN_STEPS for k, v in launches_a_step.items()}
    check(launches == want, f"{arm}: conv launches {launches}, expected "
                            f"{want}")
    want_routes = {k: v * TRAIN_STEPS for k, v in routes_a_step.items()}
    check(routes == want_routes, f"{arm}: route launches {routes}, expected "
                                 f"{want_routes}")
    last = r["outs"][-1]
    alike = all(all(np.array_equal(a, b) for a, b in zip(o, last))
                for o in r["outs"])
    print(f"{_arm_line(arm, r, ', pruned and routed')}; conv launches "
          f"{launches}, by route {routes}; steps agree bitwise: {alike}; on "
          f"{card}")
    return {"launches": launches, "route_launches": routes,
            "median_ms": r["median_ms"], "images_per_s": r["images_per_s"],
            "batch": n, "peak_memory_bytes": r["peak_memory_bytes"],
            "last": last}


def _class_probs(arm: str, rec: dict) -> dict:
    """An image classifier's inference arm (_infer_arm): the last step's
    predictions [batch, 1000] with rows summing to 1; prints the top-1 of
    the first images and returns the arm's numbers without its fetches."""
    last = rec.pop("last")[0]
    n = rec["batch"]
    check(last.shape == (n, 1000) and np.allclose(last.sum(1), 1.0,
                                                  atol=1e-2),
          f"{arm}: predictions {last.shape}, row sums {last.sum(1)[:4]}")
    print(f"{arm}: top-1 of the first images {last.argmax(1)[:4].tolist()}")
    return rec


def phase_resnet_infer(card: str) -> dict:
    from paddle_tpu_torch.tools.train_profile import (INFER_BATCH,
                                                      build_infer_program,
                                                      infer_arrays,
                                                      infer_batch)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _infer_parity(card, "resnet infer",
                  lambda amp: build_infer_program(50, amp), infer_arrays(50),
                  infer_batch(INFER_PARITY_BATCH, "cpu"))
    arms = {}
    for model, depth, amp in INFER_ARMS:
        arm = f"{model} {'amp' if amp else 'float32'}"
        pred, program, startup = build_infer_program(depth, amp)
        want = INFER_LAUNCHES[depth]
        # every bfloat16 ResNet conv on the halo kernel, every float32 one
        # on the halo_f32 kernel
        total = sum(want.values())
        routes = {"halo": total if amp else 0,
                  "halo_f32": 0 if amp else total, "gather": 0}
        arms[arm] = _class_probs(arm, _infer_arm(
            arm, [pred], program, startup, infer_arrays(depth),
            infer_batch(INFER_BATCH, "cuda"), want, routes, card))
        torch.cuda.empty_cache()
    return arms


def _zero_counters() -> None:
    """Set every kernel launch counter to 0 (``ops/_counters.py``)."""
    from paddle_tpu_torch.ops import _counters

    snap = _counters.snapshot()
    _counters.restore(_counters.delta(snap, snap))


def _counts() -> dict:
    """Every kernel launch counter, copied."""
    from paddle_tpu_torch.ops import _counters

    return _counters.snapshot()


def _image_train_parity(model: str, params: dict, card: str) -> None:
    """One float32 Momentum step (TF32 off) of ``model`` on
    IMAGE_PARITY_BATCH images on the card and on the CPU from the same
    weights and dropout masks (_train_parity)."""
    from paddle_tpu_torch.tools.train_profile import (build_image_program,
                                                      image_batch)

    loss, main, startup = build_image_program(model, amp=False)
    _train_parity(model, loss, main, startup, params,
                  image_batch(IMAGE_PARITY_BATCH, "cpu", seed=1), card,
                  f"{IMAGE_PARITY_BATCH} images, dropout on")


def _train_parity(label: str, loss, main, startup, params: dict, feed: dict,
                  card: str, what: str, floor: bool = False) -> dict:
    """One float32 step (TF32 off) of ``main`` on ``feed`` (its images
    under "img") on the card and on the CPU from the same weights: the
    loss within rtol 1e-4 and each gradient within 1e-3 of its max abs
    (the float32 train limit).

    Where a gradient fails that, or ``floor`` asks for it, the step's
    gradients are held as ResNet-50's are (_resnet_parity, ROADMAP C.5) to
    the CPU's own floor measured in this run, in relative L2: each within
    max(1e-3, RESNET_FLOOR_FACTOR x its floor), and all together within
    RESNET_FLOOR_FACTOR x theirs; the floor is the larger spread of two
    CPU steps (noise seeds 5 and 6) with the images and every weight times
    (1 + IMAGE_FLOOR_SCALE N(0, 1)) from the unmoved one.  The image
    classifiers' gradients are chaotic at float32's resolution: a rounding
    flips a ReLU whose input lies within it of 0, and one flip moves a
    layer's weight or bias gradient by one element's product, up to about
    1e-2 of its max where the layer sums few positions
    (tools/image_parity.py, PERF.md section 6).  Returns the card's
    and the CPU's fetches (loss, gradients) by device."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    grad_names = [f"{n}@GRAD" for n in params]

    def step(dev, weights=params, images=feed["img"]):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        check(dev == "cpu" or not torch.backends.cudnn.allow_tf32,
              "cuDNN TF32 is on: the float32 contract needs it off")
        scope = train_scope(exe, startup, main, weights,
                            None if dev == "cuda" else "cpu")
        t0 = time.perf_counter()
        out = exe.run(main, feed=dict(feed, img=images),
                      fetch_list=[loss] + grad_names, scope=scope)
        return out, time.perf_counter() - t0

    (l_gpu, *g_gpu), t_gpu = step("cuda")
    (l_cpu, *g_cpu), t_cpu = step("cpu")
    l_gpu, l_cpu = float(l_gpu), float(l_cpu)
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"{label} train parity: loss {l_gpu} on the card, {l_cpu} on the "
          f"CPU")
    for name, a in zip(grad_names, g_gpu):
        check(np.isfinite(a).all(), f"{label} train parity: non-finite "
                                    f"{name}")
    rel = np.array([_rel(a, b) for a, b in zip(g_gpu, g_cpu)])
    out = {"cuda": [l_gpu] + g_gpu, "cpu": [l_cpu] + g_cpu}
    line = (f"{label} train parity (float32, TF32 off, {what}): loss "
            f"{l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol 1e-4); {len(rel)} "
            f"gradients, max|d|/max|g| worst {rel.max():.3e} "
            f"({grad_names[int(rel.argmax())]}), median "
            f"{np.median(rel):.3e}")
    if rel.max() <= 1e-3 and not floor:
        print(f"{line}, all within 1e-3; step {t_gpu:.2f} s card (first, "
              f"eager), {t_cpu:.2f} s CPU; on {card}")
        return out
    flat = lambda gs: np.concatenate([g.ravel() for g in gs])  # noqa: E731
    floors, floor_all = np.zeros(len(rel)), 0.0
    for seed in (5, 6):
        rng = np.random.RandomState(seed)
        img = np.asarray(feed["img"])
        noise = rng.standard_normal(img.shape).astype(np.float32)
        moved = {n: (a * (1 + IMAGE_FLOOR_SCALE * rng.standard_normal(
            a.shape))).astype(np.float32) for n, a in params.items()}
        (_, *g_p), _ = step("cpu", moved,
                            img * (1 + IMAGE_FLOOR_SCALE * noise))
        floors = np.maximum(floors, [_rel_l2(a, b)
                                     for a, b in zip(g_p, g_cpu)])
        floor_all = max(floor_all, _rel_l2(flat(g_p), flat(g_cpu)))
    d_l2 = np.array([_rel_l2(a, b) for a, b in zip(g_gpu, g_cpu)])
    ratio = d_l2 / np.maximum(1e-3, RESNET_FLOOR_FACTOR * floors)
    all_l2 = _rel_l2(flat(g_gpu), flat(g_cpu))
    i = int(ratio.argmax())
    why = "asked" if floor and rel.max() <= 1e-3 else "over 1e-3"
    print(f"{line}; {why}, so held to the CPU's floor under a "
          f"{IMAGE_FLOOR_SCALE:g} change of the images and weights, in "
          f"relative L2: floor median {np.median(floors):.3e} (max "
          f"{floors.max():.3e}), card vs CPU median {np.median(d_l2):.3e} "
          f"(max {d_l2.max():.3e}), worst {ratio[i]:.3f} of its limit "
          f"({grad_names[i]}; max(1e-3, {RESNET_FLOOR_FACTOR} x floor)); "
          f"all together {all_l2:.3e}, floor {floor_all:.3e} (limit "
          f"{RESNET_FLOOR_FACTOR} x); step {t_gpu:.2f} s card (first, "
          f"eager), {t_cpu:.2f} s CPU; on {card}")
    check(ratio.max() <= 1.0, f"{label} train parity: {grad_names[i]} "
                              f"differs by {d_l2[i]} in L2, its floor "
                              f"{floors[i]}")
    check(all_l2 <= RESNET_FLOOR_FACTOR * floor_all,
          f"{label} train parity: the gradients differ by {all_l2} in L2, "
          f"limit {RESNET_FLOOR_FACTOR * floor_all}")
    return out


def _image_train_arm(model: str, amp: bool, params: dict,
                     card: str) -> dict:
    """TRAIN_STEPS eager Momentum steps of one arm on the config's batch,
    which stays on the card (_eager_arm; the threefry dropout kernels:
    each dropout op once forward and once backward a step)."""
    from paddle_tpu_torch.tools.train_profile import (
        IMAGE_MODELS, TRAIN_STEPS, build_image_program, image_batch)

    arm = f"{model} train {'amp' if amp else 'float32'}"
    n = IMAGE_MODELS[model][2]
    loss, main, startup = build_image_program(model, amp)
    n_drop = sum(op.type == "dropout" for op in main.list_ops())
    r = _eager_arm(arm, [loss], main, startup, params,
                   image_batch(n, "cuda"), n, card)
    losses = [float(o[0]) for o in r["outs"]]
    drop = r["counts"]["threefry_dropout.launches"]
    want = {"fwd": n_drop * TRAIN_STEPS, "bwd": n_drop * TRAIN_STEPS}
    check(drop == want, f"{arm}: dropout launches {drop}, expected {want}")
    if amp:
        dtypes = {str(v.dtype) for _, v in r["scope"].items()}
        check(dtypes <= {"torch.float32", "torch.int32"},
              f"{arm}: master state not float32: {dtypes}")
    print(f"{_arm_line(arm, r, ' (224x224, 1000 classes)')}; losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; dropout launches "
          f"{drop} = {n_drop} ops x {TRAIN_STEPS} steps; convolutions on "
          f"cuDNN (a training program is not routed); on {card}")
    return {"losses": losses, "median_ms": r["median_ms"],
            "images_per_s": r["images_per_s"], "batch": n,
            "peak_memory_bytes": r["peak_memory_bytes"],
            "dropout_launches": drop}


def phase_image(card: str) -> dict:
    """VGG-19, AlexNet and GoogLeNet (benchmark/vgg.py, alexnet.py,
    googlenet.py; weights from the port's startup program on the CPU, seed
    0): the float32 train step and the pruned, routed inference card
    against CPU, then the train and inference arms."""
    from paddle_tpu_torch.tools.train_profile import (
        IMAGE_MODELS, build_image_program, conv_routes, image_batch,
        startup_params)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {}
    for model in IMAGE_MODELS:
        _, main, startup = build_image_program(model, amp=False)
        params[model] = startup_params(main, startup, 0)
        _image_train_parity(model, params[model], card)
        _infer_parity(card, f"{model} infer",
                      lambda amp, m=model: build_image_program(m, amp, True),
                      params[model],
                      image_batch(INFER_PARITY_BATCH, "cpu", seed=2,
                                  train=False))
        _release()
    train, infer = {}, {}
    for model, amp in IMAGE_TRAIN_ARMS:
        train[f"{model} {'amp' if amp else 'float32'}"] = _image_train_arm(
            model, amp, params[model], card)
        _release()
    for model, amp in IMAGE_INFER_ARMS:
        n = IMAGE_MODELS[model][2]
        pred, program, startup = build_image_program(model, amp, True)
        routes = conv_routes(program, [pred.name], n)
        arm = f"{model}-infer {'amp' if amp else 'float32'}"
        infer[arm] = _class_probs(arm, _infer_arm(
            arm, [pred], program, startup, params[model],
            image_batch(n, "cuda", train=False),
            {"igemm": sum(routes.values()), "fused": 0}, routes, card))
        _release()
    return {"train": train, "infer": infer}


def phase_ocr(card: str) -> dict:
    """ocr_ctc at its own widths (8x32 lines, hidden 48, 4 classes) on
    OCR_BATCH lines of synthetic_lines(seed 0), Adam(5e-3), float32: the
    train signature warmed, a replay bitwise against an unwarmed eager
    step (cuDNN deterministic) and the card against the CPU; TRAIN_STEPS
    replays and 3 eager steps; then the program pruned to the decode (ids
    and lengths), warmed (_warmed_infer: its two convs on the gather
    kernel inside the graph, replays bitwise against eager on two
    batches, nothing allocated at replay), and the ids against the CPU's
    where the top two logits are clear."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        OCR_BATCH, TRAIN_STEPS, build_ocr_program, ocr_batch,
        startup_params, train_scope)

    (loss, ids, lens, logits), main, startup = build_ocr_program()
    params = startup_params(main, startup, 0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())
    feed = ocr_batch()
    fetch = [loss] + grad_names
    with _deterministic_cudnn():
        got, t_warm, _ = _replay_against_eager("ocr_ctc train", exe, main,
                                               startup, params, feed, fetch)
    want = exe_cpu.run(main, feed=feed, fetch_list=fetch,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    _card_cpu_grads("ocr_ctc train", got, want, grad_names)
    del got, want

    scope = train_scope(exe, startup, main, params)
    run = _lm_train_pass(exe, main, loss, scope, feed)
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"ocr_ctc train: losses {losses}, expected finite and falling")
    med = float(np.median(run["step_ms"][1:]))
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, main, params)
    eager_ms = _event_ms(lambda: eager.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=eager_scope), 3)
    check(eager.replays == 0, "ocr_ctc train: the eager Executor replayed")
    e_med = float(np.median(eager_ms[1:]))
    print(f"ocr_ctc train: {TRAIN_STEPS} Adam steps on {OCR_BATCH} lines, "
          f"losses {', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.3f} ms = {OCR_BATCH / med * 1e3:.0f}"
          f" lines/s; eager {', '.join(f'{x:.2f}' for x in eager_ms)} ms, "
          f"median of 2-3 {e_med:.3f} ms ({OCR_BATCH / e_med * 1e3:.0f} "
          f"lines/s); {_pass_line(run)}; on {card}")
    trained = {n: scope.find_var(n).cpu().numpy() for n in params}
    _release()

    # decode: the program pruned to the ids and lengths, warmed, from the
    # trained weights
    smain = main.prune([ids, lens])
    sfetch = [ids, lens]
    sfeeds = [ocr_batch(seed=s, train=False) for s in (1, 2)]
    decode = _warmed_infer("ocr_ctc decode", sfetch, smain, startup,
                           trained, sfeeds,
                           {"halo": 0, "halo_f32": 0, "gather": 2}, card,
                           "lines")
    s_eager = fluid.Executor()
    s_eager_scope = train_scope(s_eager, startup, smain, trained)

    # the card's ids against the CPU's where every step is clear
    sfeed = sfeeds[0]
    card_out = s_eager.run(smain, feed=sfeed, fetch_list=sfetch + [logits],
                           scope=s_eager_scope)
    cpu_out = exe_cpu.run(smain, feed=sfeed, fetch_list=sfetch + [logits],
                          scope=train_scope(exe_cpu, startup, smain, trained,
                                            "cpu"))
    err = float(np.abs(card_out[2] - cpu_out[2]).max())
    top2 = np.sort(cpu_out[2], axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    clear = margin > 2 * err
    steps_eq = card_out[2].argmax(-1) == cpu_out[2].argmax(-1)
    rows = clear.all(axis=1)
    ids_eq = (card_out[0] == cpu_out[0]).all(axis=1) & (card_out[1]
                                                        == cpu_out[1])
    print(f"ocr_ctc decode card vs CPU ({OCR_BATCH} lines, trained "
          f"weights): logits max|d| {err:.3e} "
          f"({err / float(np.abs(cpu_out[2]).max()):.3e} of max); step "
          f"argmax equal {int(steps_eq.sum())} of {steps_eq.size}, "
          f"{int(clear.sum())} with a top-two margin over twice the "
          f"difference (smallest margin {margin.min():.3e}); lines decoded "
          f"alike {int(ids_eq.sum())} of {OCR_BATCH}, {int(rows.sum())} "
          f"with every step clear")
    check(bool(steps_eq[clear].all()), "ocr_ctc decode: an argmax differs "
                                       "where the margin is clear")
    check(bool(ids_eq[rows].all()), "ocr_ctc decode: a line whose every "
                                    "step is clear decodes otherwise")
    return {"median_ms": med, "eager_median_ms": e_med,
            "lines_per_s": OCR_BATCH / med * 1e3, "warm_s": run["warm_s"],
            "parity_warm_s": t_warm,
            "decode_median_ms": decode["warmed_median_ms"],
            "decode_eager_median_ms": decode["eager_median_ms"],
            "decode_warm_s": decode["warm_s"],
            "decode_conv_route_launches": decode["replay_route_launches"],
            "decode_conv_launches": decode["replay_launches"]}


def _eager_arm(arm: str, fetch, program, startup, params: dict, feed: dict,
               n: int, card: str) -> dict:
    """TRAIN_STEPS eager steps of one arm of ``program`` on ``feed``, which
    stays on the card; every kernel counter set to 0 just before and read
    just after.  Returns every step's fetches, the CUDA-event ms of
    each step (fetches included), their median over steps 2-TRAIN_STEPS,
    images/s, peak memory and the counts."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS, train_scope

    exe = fluid.Executor()
    scope = train_scope(exe, startup, program, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    outs, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
        e1.record()
        torch.cuda.synchronize()
        outs.append(out)
        step_ms.append(e0.elapsed_time(e1))
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(o).all() for out in outs for o in out),
          f"{arm}: non-finite outputs")
    med = float(np.median(step_ms[1:]))
    return {"outs": outs, "step_ms": step_ms, "median_ms": med,
            "images_per_s": n / med * 1e3, "batch": n,
            "peak_memory_bytes": peak, "counts": counts, "scope": scope}


def _arm_line(arm: str, r: dict, what: str) -> str:
    return (f"{arm}: {len(r['step_ms'])} eager steps on {r['batch']} "
            f"images{what}; step ms "
            f"{', '.join(f'{x:.2f}' for x in r['step_ms'])}; median of steps "
            f"2-{len(r['step_ms'])} {r['median_ms']:.3f} ms = "
            f"{r['images_per_s']:.1f} images/s; peak memory "
            f"{r['peak_memory_bytes'] / 2 ** 30:.2f} GiB "
            f"(max_memory_allocated)")


def _train_arm(arm: str, loss, main, startup, params: dict, feed: dict,
               bn_layers: int, card: str) -> dict:
    """A training arm (_eager_arm, convolutions on cuDNN: a training
    program is not routed): losses finite, no conv kernel launch, and the
    batch-norm backward kernels ``bn_layers`` x steps each."""
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS

    n = int(feed["img"].shape[0])
    r = _eager_arm(arm, [loss], main, startup, params, feed, n, card)
    losses = [float(o[0]) for o in r["outs"]]
    bn = r["counts"]["batch_norm_train.launches"]
    conv = r["counts"]["conv.launches"]
    want = {"reduce": bn_layers * TRAIN_STEPS, "dx": bn_layers * TRAIN_STEPS}
    check(bn == want and conv == {"igemm": 0, "fused": 0},
          f"{arm}: BN launches {bn} (expected {want}), conv launches {conv}")
    if "amp" in arm:
        dtypes = {str(v.dtype) for _, v in r["scope"].items()}
        check(dtypes <= {"torch.float32", "torch.int32"},
              f"{arm}: master state not float32: {dtypes}")
    print(f"{_arm_line(arm, r, '')}; losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; BN kernel launches "
          f"{bn} = {bn_layers} x {TRAIN_STEPS}; on {card}")
    return {k: r[k] for k in ("median_ms", "images_per_s", "batch",
                              "peak_memory_bytes")} | {
        "losses": losses, "bn_launches": bn}


def _warmed_train(label: str, loss, main, startup, params: dict, feed: dict,
                  bn_layers: int, card: str, arm: dict) -> tuple:
    """The train step of one arm warmed: a replay against an unwarmed
    eager step and grouped against per-op updates, bitwise
    (_replay_against_eager, cuDNN deterministic); then TRAIN_STEPS
    replays of the loss signature, warmed with cuDNN's default algorithms
    (_lm_train_pass: the batch-norm counts are the replays' own,
    bn_layers x steps each).
    Returns (the warmed numbers, the scope after the replays)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS, train_scope

    grads = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    with _deterministic_cudnn():
        _replay_against_eager(label, exe, main, startup, params, feed,
                              [loss] + grads)
    _release()
    scope = train_scope(exe, startup, main, params)
    run = _lm_train_pass(exe, main, loss, scope, feed)
    bn = _counts()["batch_norm_train.launches"]
    want = {"reduce": bn_layers * TRAIN_STEPS, "dx": bn_layers * TRAIN_STEPS}
    check(bn == want, f"{label} warmed: BN launches at replay {bn}, expected "
                      f"{want}")
    losses = run["losses"]
    check(all(np.isfinite(losses)), f"{label} warmed: losses {losses}")
    med = float(np.median(run["step_ms"][1:]))
    n = int(feed["img"].shape[0])
    print(f"{label} warmed: {TRAIN_STEPS} replays on {n} images, losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.2f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.3f} ms = {n / med * 1e3:.1f} "
          f"images/s (eager {arm['median_ms']:.3f} ms, "
          f"{arm['median_ms'] / med:.2f} x); BN launches at replay {bn}; "
          f"{_pass_line(run)}; on {card}")
    return ({"warmed_median_ms": med, "warmed_images_per_s": n / med * 1e3,
             "warm_s": run["warm_s"], "warmed_bn_launches": bn,
             "warmed_peak_reserved": run["peak_reserved"]}, exe, scope)


def _warmed_infer(label: str, fetch, program, startup, arrays: dict,
                  feeds: list, routes: dict, card: str,
                  unit: str = "images") -> dict:
    """An inference step warmed, with cuDNN deterministic: per feed a
    replay (the routed conv launches counted at replay must be
    ``routes``, nothing allocated) bitwise against an unwarmed Executor's
    eager run.  Then, with cuDNN's default algorithms, the step warmed
    anew and TRAIN_STEPS replays timed beside 3 eager runs."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (TRAIN_STEPS, feed_sig,
                                                      train_scope)

    with _deterministic_cudnn():
        exe = fluid.Executor()
        scope = train_scope(exe, startup, program, arrays)
        how = exe.warm(program, feed_sig(feeds[0]), fetch, scope=scope)
        check(how == "compiled", f"{label}: warm gave {how!r}")
        eager = fluid.Executor()
        eager_scope = train_scope(eager, startup, program, arrays)
        for i, feed in enumerate(feeds):
            _zero_counters()
            replays = exe.replays
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated()
            got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
            torch.cuda.synchronize()
            grew = torch.cuda.memory_allocated() - mem
            counted = _counts()
            want = eager.run(program, feed=feed, fetch_list=fetch,
                             scope=eager_scope)
            same = all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
            print(f"{label} batch {i + 1}: replays {exe.replays - replays}, "
                  f"conv launches at replay "
                  f"{counted['conv.route_launches']}, memory allocated at "
                  f"replay {grew} bytes; bitwise equal to the eager run "
                  f"{same} (cuDNN deterministic)")
            check(exe.replays == replays + 1, f"{label}: no replay")
            check(counted["conv.route_launches"] == routes,
                  f"{label}: conv launches at replay "
                  f"{counted['conv.route_launches']}, expected {routes}")
            check(grew == 0, f"{label}: a replay allocated {grew} bytes")
            check(same, f"{label}: the replay differs from the eager run")
    del exe, scope, eager, eager_scope
    exe = fluid.Executor()
    scope = train_scope(exe, startup, program, arrays)
    feed = feeds[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    how = exe.warm(program, feed_sig(feed), fetch, scope=scope)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(how == "compiled", f"{label}: warm gave {how!r}")
    eager = fluid.Executor()
    eager_scope = train_scope(eager, startup, program, arrays)
    w_ms = _event_ms(lambda: exe.run(program, feed=feed, fetch_list=fetch,
                                     scope=scope), TRAIN_STEPS)
    e_ms = _event_ms(lambda: eager.run(program, feed=feed, fetch_list=fetch,
                                       scope=eager_scope), 3)
    w_med, e_med = float(np.median(w_ms[1:])), float(np.median(e_ms[1:]))
    n = int(next(iter(feed.values())).shape[0])
    print(f"{label}: {n} {unit}, warmed in {t_warm:.2f} s; ms "
          f"{', '.join(f'{x:.2f}' for x in w_ms)}, median of 2-{TRAIN_STEPS} "
          f"{w_med:.3f} ms = {n / w_med * 1e3:.1f} {unit}/s; eager "
          f"{', '.join(f'{x:.2f}' for x in e_ms)}, median of 2-3 "
          f"{e_med:.3f} ms = {n / e_med * 1e3:.1f} {unit}/s (cuDNN's "
          f"default algorithms); on {card}")
    return {"warmed_median_ms": w_med, f"warmed_{unit}_per_s":
            n / w_med * 1e3, "eager_median_ms": e_med, "warm_s": t_warm,
            "replay_launches": counted["conv.launches"],
            "replay_route_launches": counted["conv.route_launches"]}


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms while a replay is held bitwise
    against eager runs: they agree only where every kernel adds in one
    fixed order, and cuDNN's default weight-gradient and transposed-conv
    algorithms add with atomics (two eager steps differ in their last bits
    too).  The arms are timed outside it, on the default algorithms that
    the port's own path (tools/train_profile.py) runs."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = deterministic


def phase_fcn(card: str) -> dict:
    """The FCN segmenter at tools/train_profile.py's configuration (base
    16, 21 classes, voc2012's synthetic masks, Adam(5e-3); weights from the
    port's startup program on the CPU, seed 0): a float32 train step at
    FCN_PARITY_BATCH x FCN_PARITY_SIZE card against CPU (_train_parity)
    and the pruned, routed float32 inference (the logits within
    INFER_F32_REL of their max, the pixel classes equal wherever the top
    two logits are further apart than twice the largest difference); then
    at FCN_BATCH x FCN_SIZE the train arms float32 and amp, eager and
    warmed (a replay bitwise against eager), and the inference arms, the
    routed launches against conv_routes.  Returns the arms under "train"
    and "infer"."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        FCN_BATCH, build_fcn_program, conv_routes, fcn_batch, on_card,
        startup_params, train_scope)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    S, B = FCN_PARITY_SIZE, FCN_PARITY_BATCH
    (loss, _, _), main, startup = build_fcn_program(size=S)
    params = startup_params(main, startup, 0)
    feed = fcn_batch(B, seed=1, size=S)
    _train_parity("fcn", loss, main, startup, params, feed, card,
                  f"{B} images at {S} px")

    logits, prog, istartup = build_fcn_program(infer=True, size=S)
    out = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = train_scope(exe, istartup, prog, params,
                            None if dev == "cuda" else "cpu")
        out[dev] = exe.run(prog, feed={"img": feed["img"]},
                           fetch_list=[logits], scope=scope)[0]
    got, want = out["cuda"], out["cpu"]
    check(got.shape == (B, 21, S, S) and np.isfinite(got).all(),
          f"fcn infer parity: logits {got.shape}")
    err = float(np.abs(got - want).max())
    top = float(np.abs(want).max())
    srt = np.sort(want, axis=1)
    margin = srt[:, -1] - srt[:, -2]
    clear = margin > 2 * err
    same = got.argmax(1) == want.argmax(1)
    print(f"fcn infer parity (float32, TF32 off, {B} images at {S} px, "
          f"3 routed convs): logits max|d| {err:.3e} ({err / top:.3e} of "
          f"max; limit {INFER_F32_REL}); pixel classes equal "
          f"{int(same.sum())} of {same.size}, {int(clear.sum())} with a "
          f"top-two margin over twice the difference (smallest margin "
          f"{margin.min():.3e}); on {card}")
    check(err <= INFER_F32_REL * top, "fcn infer parity: logits differ "
                                      "beyond their limit")
    check(bool(same[clear].all()), "fcn infer parity: a pixel class "
                                   "differs where the margin is clear")
    _release()

    train_feed = on_card(fcn_batch())
    train, infer = {}, {}
    for amp in (False, True):
        arm = f"fcn train {'amp' if amp else 'float32'}"
        (loss, _, _), main, startup = build_fcn_program(amp)
        params = startup_params(main, startup, 0)
        train[arm] = _train_arm(arm, loss, main, startup, params,
                                train_feed, 0, card)
        _release()
        warmed, _, _ = _warmed_train(arm, loss, main, startup, params,
                                     train_feed, 0, card, train[arm])
        train[arm].update(warmed)
        _release()
    infer_feed = {"img": train_feed["img"]}
    for amp in (False, True):
        arm = f"fcn-infer {'amp' if amp else 'float32'}"
        logits, prog, startup = build_fcn_program(amp, infer=True)
        routes = conv_routes(prog, [logits.name], FCN_BATCH)
        check(routes == FCN_ROUTES, f"{arm}: conv_routes {routes}, "
                                    f"expected {FCN_ROUTES}")
        infer[arm] = _infer_arm(arm, [logits], prog, startup, params,
                                infer_feed,
                                {"igemm": sum(routes.values()), "fused": 0},
                                routes, card)
        del infer[arm]["last"]
        _release()
    return {"train": train, "infer": infer}


def _ssd_masks(conf, prior, feed, dev):
    """ssd_loss's positive and mined negative masks (its own helper,
    ``layers.detection.ssd_match_and_mine``) on ``dev``."""
    from paddle_tpu_torch.layers.detection import ssd_match_and_mine

    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    pos, neg, _, _ = ssd_match_and_mine(t(conf), t(feed["gb"]), t(feed["gl"]),
                                        t(prior), 0.5, 3.0)
    return pos.cpu().numpy(), neg.cpu().numpy()


def phase_ssd(card: str) -> dict:
    """The SSD detector at tools/train_profile.py's configuration (21
    classes, SSD300's 300 px, 16 gt slots, one-box images, Adam(1e-3);
    weights from the port's startup program on the CPU, seed 0):
    ssd_loss's masks card against CPU on SSD_PARITY_BATCH images, then the
    float32 train step card against CPU (_train_parity; held to the CPU's
    floor where a mask differs); the train arms float32 and amp at
    SSD_BATCH, eager (the batch-norm kernels 3 + 3 a step) and warmed (a
    replay bitwise against eager, grouped against per-op), the float32
    scope trained on SSD_TRAIN_STEPS more replays; from its weights the
    detect program (pruned to ssd.infer's detections, its four heads
    routed on the gather kernel) in both arms, eager and warmed (replays
    bitwise against eager, launches counted at replay), the detections
    card against CPU where their scores are clear, and DetectionMAP fed
    SSD_MAP_BATCHES batches of them on the card and on the CPU (the
    histograms bitwise equal) against detection_map_np."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.fusion import FUSED_OP_TYPE, route_inference
    from paddle_tpu_torch.tools.train_profile import (
        SSD_BATCH, build_ssd_program, conv_routes, on_card, ssd_batch,
        startup_params, train_scope)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    (loss, (_, conf, prior, _)), main, startup = build_ssd_program()
    params = startup_params(main, startup, 0)
    feed = ssd_batch(SSD_PARITY_BATCH, seed=1)
    masks = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = train_scope(exe, startup, main, params,
                            None if dev == "cuda" else "cpu")
        c, p = exe.run(main, feed=feed, fetch_list=[conf, prior],
                       scope=scope)
        masks[dev] = _ssd_masks(c, p, feed, dev)
    (pos_g, neg_g), (pos_c, neg_c) = masks["cuda"], masks["cpu"]
    d_pos = (pos_g != pos_c).sum(1)
    d_neg = (neg_g != neg_c).sum(1)
    print(f"ssd masks card vs CPU ({SSD_PARITY_BATCH} images, "
          f"{pos_c.shape[1]} priors): positives {pos_c.sum(1).tolist()}, "
          f"mined negatives {neg_c.sum(1).tolist()}; disagreements: "
          f"positive {d_pos.tolist()}, negative {d_neg.tolist()}")
    _train_parity("ssd", loss, main, startup, params, feed, card,
                  f"{SSD_PARITY_BATCH} images at 300 px",
                  floor=bool(d_pos.sum() + d_neg.sum()))
    _release()

    train_feed = on_card(ssd_batch())
    train, detect = {}, {}
    for amp in (False, True):
        arm = f"ssd train {'amp' if amp else 'float32'}"
        (loss, _), main, startup = build_ssd_program(amp)
        train[arm] = _train_arm(arm, loss, main, startup, params,
                                train_feed, SSD_BN_LAYERS, card)
        _release()
        warmed, exe, scope = _warmed_train(arm, loss, main, startup, params,
                                           train_feed, SSD_BN_LAYERS, card,
                                           train[arm])
        train[arm].update(warmed)
        if not amp:
            # train on: SSD_TRAIN_STEPS more replays over SSD_TRAIN_BATCHES
            # new batches
            batches = [on_card(ssd_batch(seed=s))
                       for s in range(2, 2 + SSD_TRAIN_BATCHES)]
            losses = []
            t0 = time.perf_counter()
            for i in range(SSD_TRAIN_STEPS):
                out, = exe.run(main, feed=batches[i % len(batches)],
                               fetch_list=[loss], scope=scope)
                losses.append(float(out))
            secs = time.perf_counter() - t0
            check(np.isfinite(losses).all() and
                  np.mean(losses[-10:]) < np.mean(losses[:10]),
                  f"ssd train: losses {losses[:3]} ... {losses[-3:]}")
            print(f"ssd train float32: {SSD_TRAIN_STEPS} more replays on "
                  f"{SSD_TRAIN_BATCHES} batches in {secs:.1f} s, loss mean "
                  f"of the first 10 {np.mean(losses[:10]):.4f}, of the "
                  f"last 10 {np.mean(losses[-10:]):.4f}")
            trained = {n: scope.find_var(n).cpu().numpy()
                       for n in params}
            stats = {v.name: scope.find_var(v.name).cpu().numpy()
                     for v in main.persistable_vars()
                     if v.name.endswith((".w_mean", ".w_var"))}
            del batches
        del exe, scope
        _release()

    arrays = {**trained, **stats}
    detect_feeds = [{"img": on_card(ssd_batch(seed=s, train=False))["img"]}
                    for s in (6, 7)]
    for amp in (False, True):
        arm = f"ssd-detect {'amp' if amp else 'float32'}"
        dets, prog, startup = build_ssd_program(amp, infer=True)
        routes = conv_routes(prog, [d.name for d in dets], SSD_BATCH)
        check(routes == SSD_ROUTES, f"{arm}: conv_routes {routes}, "
                                    f"expected {SSD_ROUTES}")
        check(not any(o.type == FUSED_OP_TYPE for o in route_inference(
            prog, [d.name for d in dets])),
              f"{arm}: a stride-2 conv -> BN -> ReLU chain was fused")
        detect[arm] = _infer_arm(arm, list(dets), prog, startup, arrays,
                                 detect_feeds[0],
                                 {"igemm": sum(routes.values()), "fused": 0},
                                 routes, card)
        del detect[arm]["last"]
        detect[arm].update(_warmed_infer(arm, list(dets), prog, startup,
                                         arrays, detect_feeds, routes, card))
        _release()
    del detect_feeds

    # the detections card against CPU, from the trained weights
    dets, prog, startup = build_ssd_program(infer=True)
    conf_name = [o for o in prog.list_ops() if o.type == "detection_output"
                 ][0].inputs["Conf"][0]
    feed = ssd_batch(SSD_PARITY_BATCH, seed=8)
    out = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = train_scope(exe, startup, prog, arrays,
                            None if dev == "cuda" else "cpu")
        out[dev] = exe.run(prog, feed={"img": feed["img"]},
                           fetch_list=list(dets) + [conf_name], scope=scope)
    (bg, sg, lg, cg), (bc, sc, lc, cc) = out["cuda"], out["cpu"]
    probs_g = torch.softmax(torch.from_numpy(cg), -1).numpy()[..., 1:]
    probs_c = torch.softmax(torch.from_numpy(cc), -1).numpy()[..., 1:]
    err = float(np.abs(probs_g - probs_c).max())
    clear = np.zeros(lc.shape, bool)
    margins = []
    for i in range(lc.shape[0]):
        cand = np.sort(probs_c[i][probs_c[i] > 0.01])
        for j in range(lc.shape[1]):
            if lc[i, j] < 0:
                continue
            k = np.searchsorted(cand, sc[i, j])
            near = [abs(cand[q] - sc[i, j]) for q in (k - 1, k + 1)
                    if 0 <= q < len(cand)]
            m = min(near) if near else np.inf
            margins.append(m)
            clear[i, j] = m > 2 * err
    eq = (lg == lc) & np.all(np.abs(bg - bc) <= 1e-4 * np.abs(bc).max(), -1)
    d_scores = float(np.abs(sg - sc).max())
    print(f"ssd detect card vs CPU ({SSD_PARITY_BATCH} images, trained "
          f"weights, float32): scores max|d| {d_scores:.3e}, NMS input "
          f"probabilities max|d| {err:.3e}; filled slots "
          f"{int((lc >= 0).sum())} of {lc.size}, {int(clear.sum())} with "
          f"their score over twice that from every other candidate "
          f"(smallest margin {min(margins):.3e}, median "
          f"{float(np.median(margins)):.3e}); label and box equal in "
          f"{int(eq.sum())} slots, {int(eq[clear].sum())} of the clear ones")
    check(bool(eq[clear].all()), "ssd detect: a clear slot differs")

    # DetectionMAP on the card's detections of SSD_MAP_BATCHES new batches
    stream = []
    exe = fluid.Executor()
    scope = train_scope(exe, startup, prog, arrays)
    for s in range(SSD_MAP_BATCHES):
        f = ssd_batch(seed=20 + s)
        b, sco, lab = exe.run(prog, feed={"img": f["img"]},
                              fetch_list=list(dets), scope=scope)
        stream.append({"db": b, "ds": sco, "dl": lab.astype(np.int32),
                       "gb": f["gb"], "gl": f["gl"]})
    del exe, scope
    maps = {"exact": _ssd_map(stream, SSD_MAP_BINS, card),
            "default bins": _ssd_map(stream, None, card)}
    tp, ngt = maps["exact"]["tp"], maps["exact"]["gts"]
    check(tp >= SSD_MAP_MIN_TP * ngt,
          f"ssd DetectionMAP: {tp} true positives for {ngt} gts, fewer "
          f"than {SSD_MAP_MIN_TP} of them")
    return {"train": train, "detect": detect, "map": maps}


def _detection_map_f32(detections, ground_truths, num_classes: int,
                       iou_threshold: float = 0.5) -> float:
    """detection_map_np (the exact host-side mAP: every detection a point of
    its class's curve) with its recall and precision taken in float32 from
    float32 counts, as DetectionMAP.eval takes them from its float32
    histograms (the JAX package's too).  In float64 a recall of 3 / 10
    falls below the 11-point threshold 0.3 that its float32 value passes,
    so detection_map_np can read less than the histogram's subset of its
    own points; at one precision the subset's mAP is at most this one."""
    from paddle_tpu_torch.layers.detection import _iou_np

    aps = []
    for c in range(1, num_classes):
        records, n_gt = [], 0
        for (db, ds, dl), (gb, gl) in zip(detections, ground_truths):
            gtb = np.asarray(gb)[np.asarray(gl) == c]
            n_gt += len(gtb)
            used = np.zeros(len(gtb), bool)
            sel = (np.asarray(dl) == c) & (np.asarray(ds) > 0)
            for sc, box in sorted(zip(np.asarray(ds)[sel],
                                      np.asarray(db)[sel]),
                                  key=lambda t: -t[0]):
                hit = False
                if len(gtb):
                    ious = _iou_np(box[None], gtb)[0]
                    j = int(np.argmax(ious))
                    hit = bool(ious[j] >= iou_threshold and not used[j])
                    used[j] |= hit
                records.append((sc, hit))
        if n_gt == 0:
            continue
        if not records:
            aps.append(0.0)
            continue
        records.sort(key=lambda t: -t[0])
        hits = np.array([h for _, h in records])
        tps = np.cumsum(hits.astype(np.float32), dtype=np.float32)
        fps = np.cumsum((~hits).astype(np.float32), dtype=np.float32)
        recall = tps / np.float32(n_gt)
        precision = tps / np.maximum(tps + fps, np.float32(1e-9))
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            sel = recall >= t
            ap += (precision[sel].max() if sel.any() else 0.0) / 11
        aps.append(float(ap))
    return float(np.mean(aps)) if aps else 0.0


def _ssd_map(stream: list, n_bins, card: str) -> dict:
    """DetectionMAP fed ``stream``'s detections on the card and on the CPU:
    the histograms bitwise equal, and the mAP against detection_map_np.
    With ``n_bins`` the scores are first moved to the centres of its bins,
    so detection_map_np sees the evaluator's own quantisation: the two
    agree where no two detections share a class and a bin.  With None the
    evaluator keeps its default bins and the scores stay as they are:
    its curve's points are a subset of the exact curve's, so its mAP is
    at most detection_map_np's.  Both comparisons take the exact curve at
    the evaluator's float32 precision (_detection_map_f32); the float64
    detection_map_np is printed beside it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.layers.detection import detection_map_np
    from paddle_tpu_torch.tools.train_profile import SSD_CLASSES

    if n_bins is not None:
        stream = [dict(f, ds=np.where(f["ds"] > 0, (np.floor(
            f["ds"] * n_bins) + 0.5) / n_bins, 0.0).astype(np.float32))
                  for f in stream]
    maps, hists = {}, {}
    for dev in ("cuda", "cpu"):
        mprog, mstart = fluid.Program(), fluid.Program()
        with fluid.program_guard(mprog, mstart):
            L = fluid.layers
            K, G = stream[0]["ds"].shape[1], stream[0]["gl"].shape[1]
            ev = fluid.evaluator.DetectionMAP(
                L.data("db", [K, 4]), L.data("ds", [K]),
                L.data("dl", [K], dtype="int32"), L.data("gb", [G, 4]),
                L.data("gl", [G], dtype="int32"), num_classes=SSD_CLASSES,
                **({} if n_bins is None else {"n_bins": n_bins}))
        mexe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        mscope = fluid.Scope()
        mexe.run(mstart, scope=mscope)
        for f in stream:
            mexe.run(mprog, feed=f, fetch_list=[], scope=mscope)
        maps[dev] = ev.eval(scope=mscope)
        hists[dev] = [mscope.find_var(v.name).cpu().numpy()
                      for v in ev._states]
    dets_np = [(f["db"][i], f["ds"][i], f["dl"][i]) for f in stream
               for i in range(len(f["ds"]))]
    gts_np = [(f["gb"][i], f["gl"][i]) for f in stream
              for i in range(len(f["gl"]))]
    m_np = detection_map_np(dets_np, gts_np, SSD_CLASSES)
    m_f32 = _detection_map_f32(dets_np, gts_np, SSD_CLASSES)
    bins = ev.n_bins
    cells = [(int(lab), min(int(s * bins), bins - 1)) for _, ss, ll in dets_np
             for s, lab in zip(ss, ll) if s > 0]
    shared = len(cells) - len(set(cells))
    tp, fp, ngt = hists["cpu"]
    same = all(np.array_equal(a, b) for a, b in zip(hists["cuda"],
                                                    hists["cpu"]))
    what = ("scores on its bin centres" if n_bins is not None
            else "the scores as they are, the default bins")
    print(f"ssd DetectionMAP ({len(stream)} batches of "
          f"{len(stream[0]['ds'])} images, {len(cells)} detections, "
          f"{int(tp.sum())} TP, {int(fp.sum())} FP, {int(ngt.sum())} gts, "
          f"{bins} bins, {what}): mAP card {maps['cuda']:.6f}, CPU "
          f"{maps['cpu']:.6f}, histograms bitwise equal {same}; "
          f"detection_map_np {m_np:.6f} (float64), {m_f32:.6f} (float32, "
          f"the evaluator's precision); detections sharing a class and a "
          f"bin with another: {shared}; on {card}")
    check(same and maps["cuda"] == maps["cpu"],
          "ssd DetectionMAP: card and CPU differ")
    check(maps["cpu"] <= m_f32 + 1e-6 and (
        n_bins is None or shared or abs(maps["cpu"] - m_f32) <= 1e-6),
          f"ssd DetectionMAP: {maps['cpu']} against detection_map_np "
          f"{m_f32} (float32)")
    return {"card": maps["cuda"], "cpu": maps["cpu"], "np": m_np,
            "np_f32": m_f32,
            "bins": bins, "shared_bins": shared, "tp": int(tp.sum()),
            "fp": int(fp.sum()), "gts": int(ngt.sum())}


def _nets_program(build, shapes: dict, lengths: int = 0, seed: int = 3):
    """A small program: float data of ``shapes`` (name -> shape without
    the batch dim), and with ``lengths`` a ``len`` vector in [1,
    lengths], into ``build(fluid, vars) -> Variable``, then
    mean(square(.)) and Adam(1e-3), in new programs.  Returns (loss, the
    build's output, main, startup, params as the port's startup draws
    them, a feed of NETS_BATCH rows from ``seed``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import startup_params

    rng = np.random.RandomState(seed)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        vs = {n: L.data(n, list(s)) for n, s in shapes.items()}
        feed = {n: rng.standard_normal((NETS_BATCH,) + tuple(s)).astype(
            np.float32) for n, s in shapes.items()}
        if lengths:
            vs["len"] = L.data("len", [-1], dtype="int32",
                               append_batch_size=False)
            feed["len"] = rng.randint(1, lengths + 1, (NETS_BATCH,)).astype(
                np.int32)
        y = build(fluid, vs)
        loss = L.mean(L.square(y))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return loss, y, main, startup, startup_params(main, startup, 0), feed


def phase_nets(card: str) -> dict:
    """paddle_tpu_torch.nets on the card against the CPU, each in a small
    Adam-trained program, one eager step (the float32 train limit):
    scaled_dot_product_attention at B 16, T 128, D 512, 8 heads (the flash
    kernels, one launch each a step) and refused at head dim 8 before its
    first op; multi_head_attention with value heads wider than key heads
    (the einsum path, no flash launch); bidirectional_lstm (the LSTM
    kernels) and bidirectional_gru; sequence_conv_pool, glu,
    simple_attention and dot_product_attention; img_conv_group with batch
    norm (the batch-norm backward kernels), and its pruned program's
    fused conv2d_bn_relu ops card against CPU."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    B, T, D, H = NETS_BATCH, NETS_T, NETS_D, NETS_HEADS

    def sdpa(fl, v):
        L = fl.layers
        q, k, vv = (L.fc(v["x"], D, num_flatten_dims=2, bias_attr=False)
                    for _ in range(3))
        return fl.nets.scaled_dot_product_attention(q, k, vv, num_heads=H)

    loss, _, main, startup, params, feed = _nets_program(sdpa,
                                                         {"x": (T, D)})
    _zero_counters()
    _step_card_cpu(f"nets sdpa (B {B}, T {T}, D {D}, {H} heads)", loss, main,
                   startup, params, feed)
    flash = _counts()["flash_attention.launches"]
    print(f"nets sdpa: flash launches in the card step {flash}")
    check(flash == {"fwd": 1, "bwd_dkdv": 1, "bwd_dq": 1},
          f"nets sdpa: flash launches {flash}, expected one each")
    out["sdpa"] = flash

    # head dim 8: refused by check_kernel_shapes before the first op
    loss, _, main, startup, params, feed = _nets_program(
        lambda fl, v: fl.nets.scaled_dot_product_attention(
            fl.layers.fc(v["x"], 16, num_flatten_dims=2), v["x"], v["x"],
            num_heads=2), {"x": (8, 16)})
    exe = fluid.Executor()
    scope = train_scope(exe, startup, main, params)
    before = {n: v.clone() for n, v in scope.items()}
    counter = scope.step_counter
    refused = None
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    except ValueError as err:
        refused = str(err)
    check(refused is not None and "head dims" in refused,
          f"nets sdpa at head dim 8: not refused ({refused})")
    check(all(torch.equal(before[n], v) for n, v in scope.items())
          and scope.step_counter == counter,
          "nets sdpa at head dim 8: the refused run changed state")
    print(f"nets sdpa at head dim 8 refused before its first op: "
          f"{refused}")

    # multi_head_attention, value heads wider than key heads: the einsum path
    loss, _, main, startup, params, feed = _nets_program(
        lambda fl, v: fl.nets.multi_head_attention(
            v["q"], v["kv"], v["kv"], key_proj_size=64, value_proj_size=128,
            head_num=4, out_size=32), {"q": (24, 48), "kv": (40, 56)})
    _zero_counters()
    _step_card_cpu("nets multi_head_attention (hv 32, hd 16)", loss, main,
                   startup, params, feed)
    flash = _counts()["flash_attention.launches"]
    check(sum(flash.values()) == 0, f"nets multi_head_attention: the "
                                    f"einsum path launched flash {flash}")

    # the recurrent helpers, on lengths in [1, 32]
    seq, st = {"x": (32, 48)}, {"x": (32, 48), "st": (32,)}
    loss, _, main, startup, params, feed = _nets_program(
        lambda fl, v: fl.nets.bidirectional_lstm(v["x"], v["len"], 64), seq,
        lengths=32)
    _zero_counters()
    _step_card_cpu("nets bidirectional_lstm (H 64)", loss, main, startup,
                   params, feed)
    lstm = _counts()["fused_lstm.launches"]
    check(lstm == {"fwd": 2, "bwd": 2}, f"nets bidirectional_lstm: LSTM "
                                        f"launches {lstm}, expected 2 each")
    out["bidirectional_lstm"] = lstm
    for label, build, shapes in (
            ("bidirectional_gru (H 64)",
             lambda fl, v: fl.nets.bidirectional_gru(v["x"], v["len"], 64),
             seq),
            ("sequence_conv_pool",
             lambda fl, v: fl.nets.sequence_conv_pool(v["x"], v["len"], 64,
                                                      3), seq),
            ("glu", lambda fl, v: fl.nets.glu(
                fl.layers.fc(v["x"], 128, num_flatten_dims=2)), seq),
            ("simple_attention",
             lambda fl, v: fl.nets.simple_attention(v["x"], v["len"],
                                                    v["st"]),
             st),
            ("dot_product_attention",
             lambda fl, v: fl.nets.dot_product_attention(
                 v["x"], v["len"], fl.layers.fc(v["st"], 48))[0],
             st)):
        loss, _, main, startup, params, feed = _nets_program(
            build, shapes, lengths=32)
        _step_card_cpu(f"nets {label}", loss, main, startup, params, feed)

    # img_conv_group with batch norm: trained, then pruned and fused
    loss, y, main, startup, params, feed = _nets_program(
        lambda fl, v: fl.nets.img_conv_group(v["img"], [64, 64], 2,
                                             pool_stride=2, conv_act="relu",
                                             conv_with_batchnorm=True),
        {"img": (64, 32, 32)})
    _zero_counters()
    _step_card_cpu("nets img_conv_group (batch norm)", loss, main, startup,
                   params, feed,
                   cancelled=[n for n in params if n.startswith("conv2d_b")])
    bn = _counts()["batch_norm_train.launches"]
    check(bn == {"reduce": 2, "dx": 2}, f"nets img_conv_group: batch-norm "
                                        f"launches {bn}, expected 2 each")
    out["img_conv_group_train"] = bn
    # the pruned program, each conv -> bias -> batch norm -> relu fused,
    # with running statistics away from the startup's zeros and ones
    infer = main.prune([y])
    rng = np.random.RandomState(4)
    arrays = dict(params)
    for v in infer.persistable_vars():
        if v.name.endswith(".w_mean"):
            arrays[v.name] = (rng.standard_normal(64) * 0.1).astype(
                np.float32)
        elif v.name.endswith(".w_var"):
            arrays[v.name] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        _zero_counters()
        res[dev] = exe.run(infer, feed={"img": feed["img"]}, fetch_list=[y],
                           scope=train_scope(exe, startup, infer, arrays,
                                             None if dev == "cuda"
                                             else "cpu"))[0]
        if dev == "cuda":
            fused = _counts()["conv.launches"]
            routes = _counts()["conv.route_launches"]
    err = _rel(res["cuda"], res["cpu"])
    print(f"nets img_conv_group pruned: conv launches {fused}, by route "
          f"{routes}; card vs CPU max|d|/max {err:.3e} (limit "
          f"{INFER_F32_REL}); on {card}")
    check(fused == {"igemm": 0, "fused": 2}, f"nets img_conv_group pruned: "
                                             f"conv launches {fused}")
    check(err <= INFER_F32_REL, f"nets img_conv_group pruned: differs by "
                                f"{err} of max")
    out["img_conv_group_infer"] = fused
    out["img_conv_group_infer_routes"] = routes
    return out


# --------------------------------------------------------------------------
# the layers phase and the families phase (ROADMAP A.12 part 1 and the five
# book and demo families of part 2; PERF.md section 2)


def _sampling_tie(case: str, row: int) -> float:
    """The CPU's top-two margin of ``gumbel + log(max(p, 1e-20))`` in row
    ``row`` of the sampling_id case (the program ``run_case`` built last),
    relative to max(1, |top|): a card id may differ from the CPU's only
    where this is within float32's last bits."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.program import OpContext
    from paddle_tpu_torch.ops import random as R
    from paddle_tpu_torch.tools.layer_cases import CASES, STEP_KEY

    op = next(o for o in fluid.default_main_program().list_ops()
              if o.type == "sampling_id")
    p = torch.from_numpy(CASES[case][1]["p"])
    logp = torch.log(torch.clamp_min(p, 1e-20))
    key = OpContext(*STEP_KEY, "cpu").rng_key(op.attrs["_tag"])
    scores = (R.gumbel(key, tuple(p.shape), device="cpu") + logp)[row]
    top = torch.sort(scores, descending=True).values
    return float((top[0] - top[1]) / max(1.0, abs(float(top[0]))))


def _layer_case(case: str) -> tuple:
    """One case of tools/layer_cases.py on the card and on the CPU (same
    feeds, weights, cotangent and step key): float outputs within
    LAYER_FWD_REL of the CPU's max abs (NaN where the CPU has NaN),
    integer outputs equal (sampling_id: a differing id only where the
    CPU's top two scores tie within TIE_REL, printed), each gradient within
    LAYER_GRAD_REL of its max abs.  Returns (worst value ratio, worst
    gradient ratio, ties)."""
    from paddle_tpu_torch.tools.layer_cases import run_case

    got, g_got, names = run_case(case, "cuda")
    want, g_want, _ = run_case(case, "cpu")
    worst_v = worst_g = 0.0
    ties = []
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"layer {case}: output {i} is {a.dtype} {a.shape} on the "
              f"card, {b.dtype} {b.shape} on the CPU")
        if b.dtype.kind != "f":
            for j in np.flatnonzero(a.reshape(-1) != b.reshape(-1)):
                margin = (_sampling_tie(case, int(j))
                          if case == "sampling_id" else float("inf"))
                check(margin <= TIE_REL,
                      f"layer {case}: integer output {i} differs at {j}: "
                      f"{a.reshape(-1)[j]} on the card, {b.reshape(-1)[j]} "
                      f"on the CPU (top-two margin {margin:.3e})")
                ties.append(f"{case} row {j}: margin {margin:.3e}")
            continue
        nan = np.isnan(b)
        check(np.array_equal(np.isnan(a), nan),
              f"layer {case}: output {i} NaN in other places")
        a0, b0 = np.where(nan, 0, a), np.where(nan, 0, b)
        scale = max(float(np.abs(b0).max(initial=0.0)), 1e-30)
        d = float(np.abs(a0 - b0).max(initial=0.0))
        worst_v = max(worst_v, d / scale)
        check(d <= LAYER_FWD_REL * scale,
              f"layer {case}: output {i} differs by {d}, {d / scale:.3e} "
              f"of its max abs (limit {LAYER_FWD_REL})")
    for n, a, b in zip(names, g_got, g_want):
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
        d = float(np.abs(a - b).max(initial=0.0))
        worst_g = max(worst_g, d / scale)
        check(np.isfinite(a).all() and d <= LAYER_GRAD_REL * scale,
              f"layer {case}: the gradient of {n} differs by {d}, "
              f"{d / scale:.3e} of its max abs (limit {LAYER_GRAD_REL})")
    return worst_v, worst_g, ties


def _ulps(a, b) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _random_draws(card: str) -> dict:
    """The random transforms drawn on the card from a staged step word (as
    a warmed step draws them) and on the CPU from the same (seed, step,
    tag): uniform (float32, float16, bfloat16), randint and split bitwise,
    normal within NORMAL_ULPS, gumbel within GUMBEL_TOL, categorical ids
    equal except where the CPU's top two scores tie within TIE_REL; then
    2^20 normal draws' mean and variance, the draws timed on the card."""
    from paddle_tpu_torch.ops import random as R
    from paddle_tpu_torch.ops.dropout import M32, ThreefryKey

    worst_ulps, ulp_share, ties, n_checks = 0, [], 0, 0
    for seed, step, tag in RANDOM_KEYS:
        host = ThreefryKey(seed, step, tag)
        word = np.array(step & M32, np.uint32).view(np.int32)
        staged = ThreefryKey(seed, torch.tensor(word, device="cuda"), tag)
        for shape in RANDOM_SHAPES:
            for dt in (torch.float32, torch.float16, torch.bfloat16):
                a = R.uniform(staged, shape, dt, -2.0, 3.0).float().cpu()
                b = R.uniform(host, shape, dt, -2.0, 3.0, "cpu").float()
                check(torch.equal(a, b), f"uniform {dt} {shape} at "
                                         f"{(seed, step, tag)}: card != CPU")
            for lo, hi in ((0, 2074), (-5, 5), (-2 ** 31, 2 ** 31 - 1)):
                a = R.randint(staged, shape, lo, hi).cpu()
                b = R.randint(host, shape, lo, hi, "cpu")
                check(torch.equal(a, b), f"randint [{lo}, {hi}) {shape}: "
                                         f"card != CPU")
            a = R.normal(staged, shape).cpu().numpy()
            b = R.normal(host, shape, device="cpu").numpy()
            d = _ulps(a, b)
            worst_ulps = max(worst_ulps, int(d.max()))
            ulp_share.append(float((d > 0).mean()))
            check(d.max() <= R.NORMAL_ULPS, f"normal {shape}: {d.max()} "
                                            f"ulps card vs CPU")
            g = R.gumbel(staged, shape).cpu().numpy()
            gc = R.gumbel(host, shape, device="cpu").numpy()
            check((np.abs(g - gc) <= R.GUMBEL_TOL
                   * np.maximum(1.0, np.abs(gc))).all(),
                  f"gumbel {shape}: card vs CPU beyond {R.GUMBEL_TOL}")
            n_checks += 1
        got = [tuple(int(w) for w in k) for k in R.split(staged, 3)]
        want = [tuple(int(w) for w in k) for k in R.split(host, 3)]
        check(got == want, f"split at {(seed, step, tag)}: card != CPU")
        logits = torch.from_numpy((3 * np.random.RandomState(tag)
                                   .standard_normal((4096, 11)))
                                  .astype(np.float32))
        a = R.categorical(staged, logits.cuda()).cpu()
        b = R.categorical(host, logits)
        for row in torch.nonzero(a != b).flatten().tolist():
            sc = R.gumbel(host, (4096, 11), device="cpu")[row] + logits[row]
            top = torch.sort(sc, descending=True).values
            margin = float((top[0] - top[1]) / max(1.0, abs(float(top[0]))))
            check(margin <= TIE_REL, f"categorical row {row}: card "
                                     f"{int(a[row])}, CPU {int(b[row])}, "
                                     f"margin {margin:.3e}")
            ties += 1
    key = ThreefryKey(1, torch.tensor(2, dtype=torch.int32, device="cuda"), 3)
    z = R.normal(key, (RANDOM_DRAWS,))
    mean, var = float(z.mean()), float(z.var())
    check(abs(mean) < 5e-3 and abs(var - 1) < 5e-3,
          f"normal over {RANDOM_DRAWS} draws: mean {mean}, variance {var}")
    n_ms = float(np.median(_event_ms(lambda: R.normal(key, (RANDOM_DRAWS,)),
                                     10)))
    u_ms = float(np.median(_event_ms(lambda: R.uniform(key, (RANDOM_DRAWS,)),
                                     10)))
    r_ms = float(np.median(_event_ms(
        lambda: R.randint(key, (RANDOM_DRAWS,), 0, 2074), 10)))
    print(f"random draws card (staged step word) vs CPU at "
          f"{len(RANDOM_KEYS)} keys x {len(RANDOM_SHAPES)} shapes: uniform "
          f"(float32, float16, bfloat16), randint (3 ranges) and split "
          f"bitwise equal; normal at most {worst_ulps} ulps apart (limit "
          f"{R.NORMAL_ULPS}; {max(ulp_share):.4f} of the values at most "
          f"differ), gumbel within {R.GUMBEL_TOL}; categorical on 4096 x "
          f"11 logits equal but for {ties} ties; {RANDOM_DRAWS} normal "
          f"draws: mean {mean:.3e}, variance {var:.6f}; event-timed "
          f"{RANDOM_DRAWS} draws: normal {n_ms:.4f} ms, uniform "
          f"{u_ms:.4f} ms, randint {r_ms:.4f} ms (plain torch ops, no "
          f"kernel of the port); on {card}")
    return {"normal_worst_ulps": worst_ulps, "categorical_ties": ties,
            "normal_mean": mean, "normal_var": var, "normal_ms": n_ms,
            "uniform_ms": u_ms, "randint_ms": r_ms}


def _sampling_histogram(card: str) -> dict:
    """sampling_id through the Executor on the card over RANDOM_DRAWS rows
    of one distribution: each id's frequency within 6 sigma of its
    probability; the largest deviation in sigmas and the chi-square
    statistic recorded."""
    import paddle_tpu_torch as fluid

    p_row = np.array([0.4, 0.25, 0.15, 0.1, 0.05, 0.03, 0.015, 0.005],
                     np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        p = fluid.layers.data("p", [len(p_row)])
        ids = fluid.layers.sampling_id(p)
    exe = fluid.Executor()
    feed = {"p": torch.from_numpy(np.tile(p_row, (RANDOM_DRAWS, 1))).cuda()}
    got, = exe.run(main, feed=feed, fetch_list=[ids], scope=fluid.Scope())
    check(got.dtype == np.int32 and got.shape == (RANDOM_DRAWS,),
          f"sampling_id: {got.dtype} {got.shape}")
    freq = np.bincount(got, minlength=len(p_row)) / RANDOM_DRAWS
    sigma = np.sqrt(p_row * (1 - p_row) / RANDOM_DRAWS)
    z = np.abs(freq - p_row) / sigma
    chi2 = float(RANDOM_DRAWS * np.sum((freq - p_row) ** 2 / p_row))
    print(f"sampling_id over {RANDOM_DRAWS} rows of p = "
          f"{p_row.tolist()} on the card: frequencies "
          f"{np.round(freq, 5).tolist()}, largest deviation {z.max():.2f} "
          f"sigma (limit 6), chi-square {chi2:.2f} on {len(p_row) - 1} "
          f"degrees of freedom; on {card}")
    check(z.max() <= 6.0, f"sampling_id: a frequency {z.max()} sigma off")
    return {"max_sigma": float(z.max()), "chi2": chi2}


def _evaluators_warmed(card: str) -> dict:
    """The four streaming evaluators (tools/layer_cases.py's
    evaluator_program) over EV_BATCHES batches: warmed on the card (every
    run a replay), eager on the card by an Executor that did not warm, and
    on the CPU; after each batch every accumulator bitwise equal across
    the three (integer counts in float32), reset() after batch
    EV_RESET_AT zeroing them and the next replay copying the zeros in."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.layer_cases import (evaluator_batch,
                                                    evaluator_program)
    from paddle_tpu_torch.tools.train_profile import feed_sig

    rng = np.random.RandomState(11)
    batches = [evaluator_batch(rng, 64) for _ in range(EV_BATCHES)]
    runs, evals = {}, {}
    for arm in ("warmed", "eager", "cpu"):
        main, startup, evs, fetch = evaluator_program(fluid)
        exe = (fluid.Executor(fluid.CPUPlace()) if arm == "cpu"
               else fluid.Executor())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arm == "warmed":
            how = exe.warm(main, feed_sig(batches[0]), fetch, scope=scope)
            check(how == "compiled", f"evaluators: warm gave {how!r}")
        states = []
        for i, b in enumerate(batches):
            exe.run(main, feed=b, fetch_list=fetch, scope=scope)
            states.append([scope.find_var(v.name).cpu().clone()
                           for e in evs for v in e._states])
            if i == EV_RESET_AT:
                for e in evs:
                    e.reset(exe, scope)
                check(all(not scope.find_var(v.name).any()
                          for e in evs for v in e._states),
                      f"evaluators {arm}: reset() left a count")
        check(exe.replays == (EV_BATCHES if arm == "warmed" else 0),
              f"evaluators {arm}: {exe.replays} replays")
        runs[arm] = states
        evals[arm] = [e.eval(exe, scope) for e in evs]
    for arm in ("eager", "cpu"):
        for i, (a, b) in enumerate(zip(runs["warmed"], runs[arm])):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"evaluators: the warmed replay of batch {i} differs from "
                  f"the {arm} run's accumulators")
    after = runs["warmed"][EV_RESET_AT + 1][1]
    check(float(after[0]) == len(batches[0]["p"]),
          f"evaluators: the replay after reset() counts {float(after[0])}")
    print(f"evaluators (Accuracy k=2, PrecisionRecall, ChunkEvaluator, "
          f"CTCError) over {EV_BATCHES} batches of 64: every warmed "
          f"replay's accumulators bitwise equal to an unwarmed eager "
          f"step's and to the CPU's; reset() after batch {EV_RESET_AT + 1} "
          f"copied in by the next replay; eval() at the end "
          f"{evals['warmed']}; on {card}")
    return {"evaluators": evals["warmed"]}


def phase_layers(card: str) -> dict:
    """Every case of tools/layer_cases.py (the 14 attribute activations
    and prelu, the 21 new tensor layers and the 30 new nn layers, with
    the JAX/torch differences each takes JAX's side of) on the card
    against the CPU, forward and gradient; the random transforms card
    against CPU; sampling_id's histogram."""
    from paddle_tpu_torch.tools.layer_cases import CASES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_v = worst_g = 0.0
    ties = []
    for case in sorted(CASES):
        v, g, t = _layer_case(case)
        worst_v, worst_g = max(worst_v, v), max(worst_g, g)
        ties += t
    print(f"layers card vs CPU: {len(CASES)} cases, forward and gradient; "
          f"worst value {worst_v:.3e} of its max abs (limit "
          f"{LAYER_FWD_REL}), worst gradient {worst_g:.3e} (limit "
          f"{LAYER_GRAD_REL}); integer outputs equal"
          + (f" but for ties: {'; '.join(ties)}" if ties else "")
          + f"; on {card}")
    rec = {"cases": len(CASES), "worst_value": worst_v,
           "worst_grad": worst_g, "ties": ties}
    rec.update(_evaluators_warmed(card))
    rec.update(_random_draws(card))
    rec.update(_sampling_histogram(card))
    return rec


def _family_parity(label: str, loss, main, startup, params: dict,
                   feed: dict, grad_params, card: str) -> tuple:
    """The family's parity signature warmed (replay bitwise against an
    unwarmed eager step and grouped against per-op, _replay_against_eager)
    and the replay against the CPU's step from the same weights under the
    float32 train limit (_card_cpu_grads).  Returns (the replay's fetches,
    warm seconds, the Executor, the warmed scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    grad_names = [f"{n}@GRAD" for n in grad_params]
    fetch = [loss] + grad_names
    exe = fluid.Executor()
    got, t_warm, scope = _replay_against_eager(label, exe, main, startup,
                                               params, feed, fetch)
    cpu = fluid.Executor(fluid.CPUPlace())
    want = cpu.run(main, feed=feed, fetch_list=fetch,
                   scope=train_scope(cpu, startup, main, params, "cpu"))
    _card_cpu_grads(label, got, want, grad_names)
    return got, t_warm, exe, scope


def _vae_noise_steps(exe, main, startup, params, feed, fetch, got,
                     scope) -> None:
    """The VAE's warmed replay holds its noise to the step counter: the
    same state replayed at s + 1 gives another loss, and at s again every
    fetch bitwise the first replay's (s: the counter of that replay, one
    below ``scope``'s now; the startup run counted as a step)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import train_scope

    def replay_at(step):
        fresh = train_scope(fluid.Executor(), startup, main, params)
        for n, v in fresh.items():
            scope.set_var(n, v)
        scope.step_counter = step
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    s = scope.step_counter - 1
    nxt = replay_at(s + 1)
    again = replay_at(s)
    same = all(a.tobytes() == b.tobytes() for a, b in zip(again, got))
    print(f"vae noise: the same state replayed at step counter {s + 1} "
          f"gives loss {float(nxt[0]):.9g} (at {s}: {float(got[0]):.9g}); "
          f"replayed at {s} again, every fetch bitwise the first replay's: "
          f"{same}")
    check(float(nxt[0]) != float(got[0]), "vae: the replay at s + 1 drew "
                                          "the same noise")
    check(same, "vae: the replay at s again differs from the first")


def _family_timed(label: str, exe, loss, main, startup, params: dict,
                  feed: dict, n: int, card: str, falling: bool) -> dict:
    """TRAIN_STEPS replays of the family's signature on a fixed batch
    (_lm_train_pass) beside 3 eager steps: ms per step (median of steps
    2-5, CUDA events, the fetch included), examples/s, warm seconds, peak
    memory; losses finite, and falling where ``falling``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import TRAIN_STEPS, train_scope

    run = _lm_train_pass(exe, main, loss,
                         train_scope(exe, startup, main, params), feed)
    losses = run["losses"]
    check(all(np.isfinite(losses))
          and (not falling or losses[-1] < losses[0]),
          f"{label}: losses {losses}, expected finite"
          + (" and falling" if falling else ""))
    med = float(np.median(run["step_ms"][1:]))
    eager = fluid.Executor()
    escope = train_scope(eager, startup, main, params)
    eager_ms = _event_ms(lambda: eager.run(main, feed=feed, fetch_list=[loss],
                                           scope=escope), 3)
    check(eager.replays == 0, f"{label}: the eager Executor replayed")
    e_med = float(np.median(eager_ms[1:]))
    print(f"{label}: {TRAIN_STEPS} replays on {n} examples, losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.3f}' for x in run['step_ms'])}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.4f} ms = {n / med * 1e3:.0f} "
          f"examples/s; eager {', '.join(f'{x:.3f}' for x in eager_ms)} ms, "
          f"median of 2-3 {e_med:.4f} ms ({n / e_med * 1e3:.0f} examples/s,"
          f" {e_med / med:.2f} x the replay's); {_pass_line(run)}; on {card}")
    return {"median_ms": med, "eager_median_ms": e_med,
            "examples_per_s": n / med * 1e3, "warm_s": run["warm_s"],
            "peak_bytes": run["peak_bytes"],
            "peak_reserved": run["peak_reserved"], "losses": losses}


def _copy_bytes(exe, program, scope) -> int:
    """Bytes the next replay of ``program``'s warmed signature copies in
    (core/executor.py, Executor._replay): its state that the scope holds
    in another tensor than the signature's buffer."""
    sig = next(s for k, s in exe._cache.items() if k[0] is program)
    return sum(buf.numel() * buf.element_size()
               for n, buf in sig.state.items()
               if scope.find_var(n) is not buf)


def _gan_alternations(spec: dict, params: dict, card: str) -> dict:
    """D and G warmed on one scope: 3 alternations of replays bitwise 3
    eager alternations by an unwarmed Executor (both losses, then every
    state tensor), the bytes each replay copies in from the other
    program's buffers; then GAN_ALTERNATIONS alternations on new batches,
    each timed with CUDA events (D replay, then G replay, fetches
    included), D's loss falling (the mean of the last 5 below the first
    5's), as tests/test_models.py:285 holds; G's loss recorded, not held:
    at these widths D wins and G's loss rises, in the JAX package too, so
    that test's bound on G (set at hidden 32, lr 1e-3) does not carry
    over; 3 eager alternations timed beside them."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.families import family_batch
    from paddle_tpu_torch.tools.train_profile import feed_sig

    def new_scope(executor):
        sc = fluid.Scope()
        executor.run(spec["d_startup"], scope=sc)
        executor.run(spec["g_startup"], scope=sc)
        fluid.load_scope(params, spec["d_program"], sc)
        return sc

    exe = fluid.Executor()
    scope = new_scope(exe)
    first = family_batch("gan", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for side in ("d", "g"):
        how = exe.warm(spec[f"{side}_program"], feed_sig(first[side]),
                       [spec[f"{side}_loss"]], scope=scope)
        check(how == "compiled", f"gan {side}: warm gave {how!r}")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    eager = fluid.Executor()
    escope = new_scope(eager)
    copied = []
    for i in range(3):
        batch = family_batch("gan", i)
        row = 0
        for side in ("d", "g"):
            prog, fetch = spec[f"{side}_program"], [spec[f"{side}_loss"]]
            row += _copy_bytes(exe, prog, scope)
            got, = exe.run(prog, feed=batch[side], fetch_list=fetch,
                           scope=scope)
            want, = eager.run(prog, feed=batch[side], fetch_list=fetch,
                              scope=escope)
            check(got.tobytes() == want.tobytes(),
                  f"gan alternation {i}: the {side} replay differs from "
                  f"eager ({float(got)} vs {float(want)})")
        copied.append(row)
    bad = [n for n, v in escope.items()
           if not torch.equal(scope.find_var(n), v)]
    check(exe.replays == 6 and eager.replays == 0 and not bad,
          f"gan alternations: replays {exe.replays}, state differing from "
          f"eager {bad[:4]}")
    shared = sum(params[n].nbytes for n in params)
    print(f"gan alternations warmed: 3 of replays bitwise 3 eager "
          f"alternations (losses and {len(list(escope.items()))} state "
          f"tensors); bytes copied in per alternation "
          f"{copied} (the {len(params)} parameters both programs read, "
          f"{shared} bytes, twice: {2 * shared}); warmed in {warm_s:.2f} s")
    check(copied[1] == copied[2] == 2 * shared,
          f"gan: {copied} bytes copied an alternation, expected "
          f"{2 * shared}")

    d_losses, g_losses, alt_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(GAN_ALTERNATIONS):
        batch = family_batch("gan", 100 + i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        d, = exe.run(spec["d_program"], feed=batch["d"],
                     fetch_list=[spec["d_loss"]], scope=scope)
        g, = exe.run(spec["g_program"], feed=batch["g"],
                     fetch_list=[spec["g_loss"]], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        alt_ms.append(e0.elapsed_time(e1))
        d_losses.append(float(d))
        g_losses.append(float(g))
    peak = torch.cuda.max_memory_allocated()
    d0, d1 = np.mean(d_losses[:5]), np.mean(d_losses[-5:])
    check(np.isfinite(d_losses + g_losses).all() and d1 < d0,
          f"gan: D losses {d_losses[:3]}...{d_losses[-3:]}, G "
          f"{g_losses[0]} -> {g_losses[-1]}")
    eager_ms = []
    for i in range(3):
        batch = family_batch("gan", 200 + i)
        eager_ms += _event_ms(lambda: [eager.run(
            spec[f"{s}_program"], feed=batch[s],
            fetch_list=[spec[f"{s}_loss"]], scope=escope)
            for s in ("d", "g")], 1)
    med = float(np.median(alt_ms[1:]))
    e_med = float(np.median(eager_ms[1:]))
    n = len(first["g"]["z"])
    print(f"gan: {GAN_ALTERNATIONS} warmed alternations on new batches of "
          f"{n}: D loss {d_losses[0]:.5f} -> {d_losses[-1]:.5f} (mean of "
          f"the first 5 {d0:.5f}, last 5 {d1:.5f}), G loss "
          f"{g_losses[0]:.5f} -> {g_losses[-1]:.5f}; ms an alternation "
          f"(D + G, feeds staged, fetches included) median {med:.4f} = "
          f"{n / med * 1e3:.0f} examples/s, min {min(alt_ms):.4f}, max "
          f"{max(alt_ms):.4f}; eager {', '.join(f'{x:.3f}' for x in eager_ms)}"
          f" ms, median of 2-3 {e_med:.4f} ({e_med / med:.2f} x); "
          f"{2 * shared} bytes copied an alternation; peak memory "
          f"{peak / 2 ** 20:.1f} MiB allocated; on {card}")
    return {"median_ms": med, "eager_median_ms": e_med,
            "examples_per_s": n / med * 1e3, "warm_s": warm_s,
            "peak_bytes": peak, "copy_bytes": 2 * shared,
            "d_losses": [d_losses[0], d_losses[-1]],
            "g_losses": [g_losses[0], g_losses[-1]]}


def phase_families(card: str) -> dict:
    """word2vec, recommender, traffic, gan and vae at their build()
    defaults (tools/families.py), float32 with TF32 off, weights from the
    port's startup program on the CPU, seed 0: each train step warmed, a
    replay bitwise against an unwarmed eager step and grouped updates
    bitwise per-op, the replay against the CPU's step (loss rtol 1e-4,
    each gradient within 1e-3 of its max abs); the VAE's noise held to the
    step counter; then 5 replays beside 3 eager steps (gan: its
    alternations)."""
    from paddle_tpu_torch.models import gan
    from paddle_tpu_torch.tools.families import (FAMILY_BATCH, build_family,
                                                 family_batch)
    from paddle_tpu_torch.tools.train_profile import startup_params

    out = {}
    for name in ("word2vec", "recommender", "traffic", "vae"):
        loss, main, startup = build_family(name)
        params = startup_params(main, startup, 0)
        feed = family_batch(name, 0)
        got, t_warm, exe, scope = _family_parity(
            f"{name} train", loss, main, startup, params, feed, list(params),
            card)
        if name == "vae":
            fetch = [loss] + [f"{n}@GRAD" for n in params]
            _vae_noise_steps(exe, main, startup, params, feed, fetch, got,
                             scope)
        del scope
        _release()
        out[name] = _family_timed(f"{name} train", exe, loss, main, startup,
                                  params, feed, FAMILY_BATCH[name], card,
                                  falling=True)
        out[name]["parity_warm_s"] = t_warm
        _release()
    spec = build_family("gan")
    params = startup_params(spec["d_program"], spec["d_startup"], 0)
    batch = family_batch("gan", 0)
    for side, plist in (("d", gan.D_PARAMS), ("g", gan.G_PARAMS)):
        _family_parity(f"gan {side.upper()} train", spec[f"{side}_loss"],
                       spec[f"{side}_program"], spec[f"{side}_startup"],
                       params, batch[side], plist, card)
        _release()
    out["gan"] = _gan_alternations(spec, params, card)
    return out


def _ctr_sparse_against_dense(name: str, params: dict, feed: dict,
                              card: str) -> None:
    """``name`` built with is_sparse=True and with False, one eager step
    on the card each from the same weights (the dense build's, by name) and
    batch: the loss and every gradient bitwise equal (no padding id, so
    both paths gather and add the same values)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.families import build_family
    from paddle_tpu_torch.tools.train_profile import train_scope

    outs = []
    for sparse in (False, True):
        fluid.reset_default_programs()
        loss, main, startup = build_family(name, is_sparse=sparse)
        names = [p.name for p in main.parameters()]
        check(sorted(names) == sorted(params),
              f"{name} is_sparse={sparse}: parameters {names[:3]}...")
        exe = fluid.Executor()
        scope = train_scope(exe, startup, main, params)
        outs.append(exe.run(main, feed=feed, fetch_list=[loss] + [
            f"{n}@GRAD" for n in sorted(params)], scope=scope))
    bad = [n for n, a, b in zip(["loss"] + sorted(params), *outs)
           if a.tobytes() != b.tobytes()]
    print(f"{name} is_sparse=True against False on the card, one eager "
          f"step from the same weights and batch: the loss and "
          f"{len(params)} gradients, {len(bad)} differ"
          + (f" ({bad[:4]})" if bad else " (bitwise equal)"))
    check(not bad, f"{name}: is_sparse=True differs from the dense path: "
                   f"{bad[:4]}")


def phase_ctr(card: str) -> dict:
    """wide_deep and deepfm at models/ctr.py's defaults (tools/families.py,
    float32, TF32 off, weights from the port's startup program on the CPU,
    seed 0): the train step warmed, a replay bitwise against an unwarmed
    eager step and grouped against per-op, the replay against the CPU's
    step (loss rtol 1e-4, each gradient within 1e-3 of its max abs);
    is_sparse=True against False bitwise; then 5 replays beside 3 eager
    steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.families import (CTR_MODELS, FAMILY_BATCH,
                                                 build_family, family_batch)
    from paddle_tpu_torch.tools.train_profile import startup_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in CTR_MODELS:
        fluid.reset_default_programs()
        loss, main, startup = build_family(name)
        params = startup_params(main, startup, 0)
        feed = family_batch(name, 0)
        _, t_warm, exe, scope = _family_parity(
            f"{name} train", loss, main, startup, params, feed, list(params),
            card)
        del scope
        _release()
        out[name] = _family_timed(f"{name} train", exe, loss, main, startup,
                                  params, feed, FAMILY_BATCH[name], card,
                                  falling=True)
        out[name]["parity_warm_s"] = t_warm
        del exe
        _release()
        _ctr_sparse_against_dense(name, params, feed, card)
        _release()
    return out


def phase_sparse(card: str) -> dict:
    """benchmark/ctr_sparse.py's A/B at its settings (tools/ctr_sparse.py):
    the sparse arm (SparseEmbeddingTrainer.train over a SparseFeeder, the
    guard on "raise") and the dense-apply arm on the warm-up batches and
    the 100-batch stream; every loss bitwise, the touched rows and slots
    bitwise and the untouched rows their initial values at the end,
    captures = rungs, the materialization probe 0 and > 0, the first
    SPARSE_CPU_STEPS losses against the CPU's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.datasets import ctr as ctr_data
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.sparse import count_dense_materializations
    from paddle_tpu_torch.tools import ctr_sparse as cs

    vocabs = list(ctr_data.FIELD_VOCABS)
    F, dense_dim, cap = len(vocabs), ctr_data.NUM_DENSE, cs.BATCH * len(vocabs)
    t0 = time.perf_counter()
    stream = cs.stream(vocabs, dense_dim)
    probe = ctr.wide_deep_sparse_table(vocabs, cs.EMB_DIM, seed=cs.TABLE_SEED,
                                       max_ids_per_batch=cap, device="cpu")
    V, D = probe.vocab, probe.dim
    dbs = [probe.dedup(f["sparse"]) for f in stream]
    rungs = sorted({d.bucket for d in dbs})
    warm = cs.warm_batches(probe, stream, vocabs, dense_dim)
    seq = warm + stream
    params = ctr.wide_deep_sparse_params(vocabs, cs.EMB_DIM, dense_dim,
                                         cs.HIDDEN, seed=cs.PARAM_SEED)
    setup_s = time.perf_counter() - t0

    def new_trainer(device=None):
        table = ctr.wide_deep_sparse_table(
            vocabs, cs.EMB_DIM, seed=cs.TABLE_SEED, max_ids_per_batch=cap,
            device=device)
        return fluid.SparseEmbeddingTrainer(
            table, cs.loss_fn(F), params, fluid.optimizer.Adagrad(cs.LR),
            recompile_policy="raise")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = new_trainer()
    init = trainer.table.value.clone()
    t0 = time.perf_counter()
    warm_losses = trainer.train(lambda: iter(warm))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(trainer.traces == len(rungs),
          f"sparse: {trainer.traces} captures over the warm-up, rungs "
          f"{rungs}")
    t0 = time.perf_counter()
    stream_losses = trainer.train(lambda: iter(stream))
    torch.cuda.synchronize()
    sparse_s = time.perf_counter() - t0
    sparse_peak = torch.cuda.max_memory_allocated() - base
    check(trainer.traces == len(rungs),
          f"sparse: {trainer.traces - len(rungs)} captures in the stream")
    dedup_ms = list(trainer.feeder.dedup_ms)
    stall_ms = list(trainer.feeder.stall_ms)[:-1]   # the end's wait left out
    losses = warm_losses + stream_losses

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dense = cs.DenseArm(vocabs, cs.EMB_DIM, params,
                        fluid.optimizer.Adagrad(cs.LR), cs.TABLE_SEED,
                        "cuda", max_ids_per_batch=cap)
    dlosses, dense_ms = [], []
    for f in seq:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss = dense.step(f)
        e1.record()
        torch.cuda.synchronize()
        dense_ms.append(e0.elapsed_time(e1))
        dlosses.append(float(loss))
    dense_peak = torch.cuda.max_memory_allocated() - base
    differ = [i for i, (a, b) in enumerate(zip(losses, dlosses)) if a != b]
    touched = np.unique(np.concatenate(
        [probe.global_ids(f["sparse"]).reshape(-1) for f in seq]))
    untouched = torch.from_numpy(np.setdiff1d(np.arange(V), touched)).cuda()
    tt = torch.from_numpy(touched).cuda()
    rows_eq = torch.equal(trainer.table.value[tt], dense.value[tt])
    slot_eq = torch.equal(trainer.slots["moment"][tt],
                          dense.slots["moment"][tt])
    frozen = torch.equal(trainer.table.value[untouched], init[untouched])
    towers = [k for k in params
              if not torch.equal(trainer.params[k], dense.params[k])]
    print(f"sparse vs dense arm on the card over {len(seq)} steps "
          f"({len(warm)} warm-up, {len(stream)} stream): losses differing "
          f"{len(differ)} (first at {differ[:1]}); touched rows "
          f"{len(touched)} of {V}: rows bitwise {rows_eq}, Adagrad slots "
          f"bitwise {slot_eq}; untouched rows at their initial values "
          f"{frozen}; tower parameters differing {towers}")
    check(not differ, f"sparse: {len(differ)} losses differ from the dense "
                      f"arm's, first at step {differ[:1]}: "
                      f"{[(losses[i], dlosses[i]) for i in differ[:3]]}")
    check(rows_eq and slot_eq and frozen and not towers,
          "sparse: the trained state differs from the dense arm's")

    # the materialization probe: one step each, on state that may change
    db = probe.dedup(stream[0]["sparse"])
    batch = {"dense": torch.from_numpy(stream[0]["dense"]).cuda(),
             "label": torch.from_numpy(stream[0]["label"]).cuda(),
             "sparse__inv": torch.from_numpy(db.inv).cuda(),
             "sparse__mask": torch.from_numpy(db.mask).cuda()}
    lr = torch.tensor(cs.LR, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    n_sparse = count_dense_materializations(
        trainer.step_body, (V, D), torch.from_numpy(db.uids).cuda(), lr,
        one, batch)
    gids, dbatch = dense.batch(stream[0])
    n_dense = count_dense_materializations(dense.step_body, (V, D), gids,
                                           dbatch, lr, one)
    check(n_sparse == 0 and n_dense > 0,
          f"sparse: fresh [V, D] tensors {n_sparse} in the sparse step, "
          f"{n_dense} in the dense arm's")

    cpu = new_trainer("cpu")
    cpu_losses = cpu.train(lambda: iter(seq[:SPARSE_CPU_STEPS]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses[:SPARSE_CPU_STEPS], cpu_losses))
    check(rel <= SPARSE_LOSS_RTOL,
          f"sparse: the first {SPARSE_CPU_STEPS} losses card against CPU "
          f"differ by {rel} relative (limit {SPARSE_LOSS_RTOL})")

    nuniq = float(np.mean([d.n_unique for d in dbs]))
    mean_bucket = float(np.mean([d.bucket for d in dbs]))
    sparse_ms = sparse_s / len(stream) * 1e3
    d_med = float(np.median(dense_ms[len(warm):]))
    print(f"sparse arm: {len(stream)} stream steps of {cs.BATCH} x {F} "
          f"ids in {sparse_s:.4f} s = {sparse_ms:.4f} ms a step (host wall, "
          f"the feeder's producer overlapped) = "
          f"{cs.BATCH / sparse_ms * 1e3:.0f} examples/s; warm-up "
          f"{len(warm)} steps ({len(rungs)} captures, rungs {rungs}) in "
          f"{warm_s:.3f} s; dense arm: median {d_med:.4f} ms a step "
          f"(CUDA events, eager, the feed's upload included) = "
          f"{cs.BATCH / d_med * 1e3:.0f} examples/s "
          f"({d_med / sparse_ms:.2f} x the sparse arm's); mean n_unique "
          f"{nuniq:.1f}, mean bucket {mean_bucket:.1f}, V / mean bucket "
          f"{V / mean_bucket:.1f}; dedup on the producer thread "
          f"{np.mean(dedup_ms):.4f} ms a batch (max {max(dedup_ms):.4f}), "
          f"the consumer's stall {np.mean(stall_ms):.4f} ms a batch (max "
          f"{max(stall_ms):.4f}); peak memory above the arm's start "
          f"(the sparse arm's graph pool and table kept through the dense "
          f"arm) sparse {sparse_peak / 2 ** 20:.1f} MiB, dense "
          f"{dense_peak / 2 ** 20:.1f} MiB allocated; materialization "
          f"probe {n_sparse} sparse, {n_dense} dense; the first "
          f"{SPARSE_CPU_STEPS} losses within {rel:.3e} of the CPU's; "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; setup "
          f"{setup_s:.2f} s; on {card}")
    return {"sparse_ms": sparse_ms, "dense_ms": d_med, "rungs": rungs,
            "mean_bucket": mean_bucket, "mean_unique": nuniq,
            "bytes_ratio": V / mean_bucket,
            "dedup_ms": float(np.mean(dedup_ms)),
            "stall_ms": float(np.mean(stall_ms)),
            "sparse_peak": sparse_peak, "dense_peak": dense_peak,
            "cpu_rel": rel}


PAR_RANKS = 4
PAR_BATCH = 8
PAR_LOSS_RTOL = 1e-4
PAR_GRAD_REL = 1e-3      # the port's float32 train limit (TOLERANCE)
PAR_DROPOUT = 0.1
# (label, mesh, build_lm flags, ZeRO-1)
PAR_LEGS = (
    ("sp2 tp2 ring", {"sp": 2, "tp": 2},
     {"use_tp": True, "use_sp": True, "sp_strategy": "ring"}, False),
    ("sp2 tp2 ring_striped", {"sp": 2, "tp": 2},
     {"use_tp": True, "use_sp": True, "sp_strategy": "ring_striped"}, False),
    ("sp2 tp2 ulysses", {"sp": 2, "tp": 2},
     {"use_tp": True, "use_sp": True, "sp_strategy": "ulysses"}, False),
    ("tp4", {"tp": 4}, {"use_tp": True}, False),
    ("dp4 zero1 dropout", {"dp": 4}, {"dropout": PAR_DROPOUT}, True),
)
PAR_STEPS = 2


def _par_feed() -> dict:
    rng = np.random.RandomState(0)
    V, T = LM_CFG["vocab_size"], LM_CFG["max_len"]
    return {"toks": rng.randint(0, V, (PAR_BATCH, T)).astype(np.int32),
            "labs": rng.randint(0, V, (PAR_BATCH, T, 1)).astype(np.int32)}


def _par_reference(feed: dict, dropout: float, path: str) -> list:
    """The single-card unsharded steps from init_lm_params(0): losses, the
    first step's gradients and first dropout mask, saved at ``path``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import init_lm_params
    from paddle_tpu_torch.tools import parallel_cases as pc

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    loss, _ = pc.build_lm(fluid, None, cfg=LM_CFG, dropout=dropout)
    main = fluid.default_main_program()
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    fluid.load_scope(init_lm_params(0, **LM_CFG), main,
                     fluid.global_scope())
    grads = [p.name + "@GRAD" for p in main.parameters()]
    drops = [op.outputs["Out"][0] for op in main.list_ops()
             if op.type == "dropout"]
    first = exe.run(feed=feed, fetch_list=[loss.name] + grads + drops[:1])
    losses = [float(first[0])]
    for _ in range(PAR_STEPS - 1):
        losses.append(float(exe.run(feed=feed, fetch_list=[loss])[0]))
    torch.save({"loss": losses,
                "grads": {n: torch.from_numpy(g)
                          for n, g in zip(grads, first[1:])},
                "mask": torch.from_numpy(first[-1] == 0) if drops else None},
               path)
    del exe
    fluid.reset_global_scope()
    _release()
    return losses


def _par_predicted(kw: dict, coords: dict) -> dict:
    """Flash launches per kernel and dropout launches per kind of one rank
    over the leg's steps, from the code: a ring call launches
    ring.ring_launches pairs (forward, and each backward kernel); every
    other attention one flash call a layer; dropout 1 + 2 x layers sites a
    step, forward and backward."""
    from paddle_tpu_torch.parallel.ring import ring_launches

    layers, steps = LM_CFG["n_layers"], PAR_STEPS
    per_call = 1
    if kw.get("use_sp") and kw.get("sp_strategy", "ring") != "ulysses":
        per_call = ring_launches(2, coords["sp"], True,
                                 kw["sp_strategy"] == "ring_striped")
    flash = {k: per_call * layers * steps for k in FLASH_KERNELS}
    sites = (1 + 2 * layers) * steps if kw.get("dropout") else 0
    return {"flash": flash, "dropout": {"fwd": sites, "bwd": sites}}


def _dropout_offsets_on_card() -> tuple:
    """The dropout kernel with counter maps: 4 row slices (dp), 2 x 2
    (dp x sp) contiguous and striped sequence slices, 2 x 2 (dp x tp)
    row and column slices (the one-level tensor-parallel map) and 2 x 2
    (sp x tp) contiguous and striped sequence and column slices (the
    two-level map), of one [8, 1024, 512] tensor, each launch bitwise the
    whole tensor's launch at its elements and the plain version with the
    same map.  Then rank 0's slice of the two tp maps timed beside an
    unmapped launch on the same slice.  Returns (the number of slice
    launches checked, {map: (mapped ms, unmapped ms, slice shape)})."""
    from paddle_tpu_torch.ops import dropout as dmod
    from paddle_tpu_torch.param_attr import SeqAxis
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.parallel.strategy import StepLayout, seq_index

    B, T, D = 8, 1024, 512
    x = torch.randn(B, T, D, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    key = dmod.ThreefryKey(0, 7, 3)
    whole = dmod.dropout_fwd_kernel(x, key, PAR_DROPOUT)
    n, times = 0, {}
    for axes, seq, striped in (({"dp": 4}, False, False),
                               ({"dp": 2, "sp": 2}, True, False),
                               ({"dp": 2, "sp": 2}, True, True),
                               ({"dp": 2, "tp": 2}, False, False),
                               ({"sp": 2, "tp": 2}, True, False),
                               ({"sp": 2, "tp": 2}, True, True)):
        grid = np.arange(4).reshape(*axes.values())
        col = "tp" if "tp" in axes else None
        for r in range(4):
            mesh = Mesh(grid, tuple(axes), r)
            sp_ax = SeqAxis("sp", striped) if seq else None
            lay = StepLayout(mesh, "dp" if "dp" in axes else None, sp_ax, B)
            b = B // axes.get("dp", 1)
            rows = slice(mesh.coord("dp") * b, (mesh.coord("dp") + 1) * b)
            pos = torch.as_tensor(seq_index(T, axes.get("sp", 1),
                                            mesh.coord("sp"), striped),
                                  device="cuda")
            w = D // axes.get("tp", 1)
            cols = slice(mesh.coord("tp") * w, (mesh.coord("tp") + 1) * w)
            part = x[rows].index_select(1, pos)[..., cols].contiguous()
            cmap = lay.counter_map(part.shape, sp_ax, True, col)
            got = dmod.dropout_fwd_kernel(part, key, PAR_DROPOUT, cmap)
            want = whole[rows].index_select(1, pos)[..., cols]
            check(torch.equal(got, want)
                  and torch.equal(got, dmod.dropout_reference(
                      part, key, PAR_DROPOUT, cmap)),
                  f"parallel: the dropout kernel's slice {r} of {axes} "
                  f"(seq {seq}, striped {striped}) is not the whole "
                  f"tensor's mask")
            n += 1
            if col and r == 0 and not striped:
                label = ("two-level sp x tp" if seq else "one-level dp x tp")
                times[label] = (
                    cuda_ms(lambda i: dmod.dropout_fwd_kernel(
                        part, key, PAR_DROPOUT, cmap)),
                    cuda_ms(lambda i: dmod.dropout_fwd_kernel(
                        part, key, PAR_DROPOUT)), tuple(part.shape))
    return n, times


def phase_parallel(card: str) -> dict:
    import tempfile

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.tools import parallel_cases as pc

    n_slices, map_ms = _dropout_offsets_on_card()
    print(f"parallel: dropout kernel with counter maps, {n_slices} slices "
          f"bitwise the whole [8, 1024, 512] tensor's launch and the plain "
          f"version (dp, dp x sp contiguous and striped, dp x tp, sp x tp "
          f"contiguous and striped); float32 fwd ms on rank 0's slice, "
          f"mapped vs unmapped: "
          + "; ".join(f"{k} {v[2]} {v[0]:.4f} vs {v[1]:.4f}"
                      for k, v in map_ms.items()) + f"; on {card}")
    feed = _par_feed()
    tmp = tempfile.mkdtemp(prefix="par-ref-")
    refs = {d: os.path.join(tmp, f"ref_{d}.pt") for d in (0.0, PAR_DROPOUT)}
    ref_losses = {d: _par_reference(feed, d, p) for d, p in refs.items()}
    print(f"parallel: single-card reference losses {ref_losses[0.0]} "
          f"(dropout {PAR_DROPOUT}: {ref_losses[PAR_DROPOUT]})")

    def spec(mesh, kw, zero1, steps):
        return {"kind": "lm_leg", "cfg": LM_CFG, "mesh": mesh, "kw": kw,
                "zero1": zero1, "seed": 0, "feed": feed, "steps": steps,
                "ref": refs[kw.get("dropout", 0.0)]}

    specs = {label: spec(mesh, kw, zero1, PAR_STEPS)
             for label, mesh, kw, zero1 in PAR_LEGS}
    t0 = time.perf_counter()
    ranks = distributed.spawn(pc.run_cases, PAR_RANKS, specs, True,
                              device="cuda:0", timeout_s=540,
                              group_timeout_s=120)
    gang_s = time.perf_counter() - t0
    print(f"parallel: gang of {PAR_RANKS} ranks on one card over "
          f"{ranks[0][PAR_LEGS[0][0]]['backend']}, "
          f"{sorted(comm.GLOO_STAGED)} staged through pinned host memory "
          f"(gloo's send / recv take no device memory); {gang_s:.1f} s "
          f"with start-up")
    out = {"legs": {}, "gloo_staged": sorted(comm.GLOO_STAGED),
           "dropout_map_ms": map_ms}
    for label, mesh, kw, zero1 in PAR_LEGS:
        r0 = ranks[0][label]
        rec = {"mesh": mesh, "zero1": zero1, "losses": r0["losses"],
               "ref_losses": r0["ref_losses"],
               "grad_worst": r0["grad_worst"],
               "grad_worst_name": r0["grad_worst_name"],
               "ms": [r[label]["ms"] for r in ranks],
               "peak_gib": [r[label]["peak_bytes"] / 2 ** 30 for r in ranks],
               "flash": [r[label]["flash"] for r in ranks],
               "dropout": [r[label]["dropout"] for r in ranks],
               "staged": [r[label]["staged"] for r in ranks],
               "calls": [r[label]["calls"] for r in ranks],
               "comm_ms": [1e3 * sum(r[label]["comm_s"].values())
                           for r in ranks]}
        for r in ranks:
            check(r[label]["losses"] == r0["losses"],
                  f"parallel {label}: ranks disagree on the losses")
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                   r0["ref_losses"])]
        check(max(rel) <= PAR_LOSS_RTOL,
              f"parallel {label}: losses {r0['losses']} vs the single "
              f"card's {r0['ref_losses']} (rel {rel})")
        check(r0["grad_worst"] <= PAR_GRAD_REL,
              f"parallel {label}: gradient {r0['grad_worst_name']} off by "
              f"{r0['grad_worst']:.3e} of its max abs")
        if kw.get("dropout"):
            check(r0["mask_equal"],
                  f"parallel {label}: the dropout mask differs from the "
                  f"single card's")
        for i, r in enumerate(ranks):
            want = _par_predicted(kw, r[label]["coords"])
            got = {"flash": {k: r[label]["flash"][k] for k in FLASH_KERNELS},
                   "dropout": r[label]["dropout"]}
            check(got == want, f"parallel {label}: rank {i}'s launches "
                               f"{got}, predicted {want}")
        rec["max_loss_rel"] = max(rel)
        out["legs"][label] = rec
        print(f"parallel {label}: mesh {mesh}{' ZeRO-1' if zero1 else ''}"
              f"; losses {r0['losses']} vs single card {r0['ref_losses']} "
              f"(max rel {max(rel):.2e}); worst gradient "
              f"{r0['grad_worst']:.2e} of max abs "
              f"({r0['grad_worst_name']})"
              + (f"; dropout mask bitwise" if kw.get("dropout") else "")
              + f"; flash launches per rank "
              f"{[f['fwd'] for f in rec['flash']]} (as predicted); ms per "
              f"step by rank (step 1 fetches every gradient) "
              f"{[[round(m, 1) for m in ms] for ms in rec['ms']]}; peak "
              f"GiB by rank {[round(g, 3) for g in rec['peak_gib']]}; "
              f"collectives by rank over the steps {rec['calls']}, host ms "
              f"inside them {[round(m, 1) for m in rec['comm_ms']]}, "
              f"staged through host {rec['staged']}; on {card}")
    # NCCL: one rank on the card, every collective a real NCCL call
    kw = {"use_tp": True, "use_sp": True, "sp_strategy": "ring"}
    nccl = distributed.spawn(
        pc.run_cases, 1, {"nccl": spec({"dp": 1, "sp": 1, "tp": 1}, kw,
                                       False, 1)}, True,
        device="cuda:0", timeout_s=300, group_timeout_s=120)[0]["nccl"]
    rel = abs(nccl["losses"][0] - nccl["ref_losses"][0]) / abs(
        nccl["ref_losses"][0])
    check(nccl["backend"] == "nccl", f"parallel nccl: backend "
                                     f"{nccl['backend']}")
    check(rel <= PAR_LOSS_RTOL and nccl["grad_worst"] <= PAR_GRAD_REL,
          f"parallel nccl: loss rel {rel:.2e}, worst gradient "
          f"{nccl['grad_worst']:.2e}")
    check(sum(nccl["calls"].values()) > 0 and not nccl["staged"],
          f"parallel nccl: calls {nccl['calls']}, staged {nccl['staged']}")
    print(f"parallel nccl: one rank, backend nccl, {nccl['calls']} NCCL "
          f"calls in the step, none staged; loss {nccl['losses'][0]:.6f} vs "
          f"{nccl['ref_losses'][0]:.6f} (rel {rel:.2e}); worst gradient "
          f"{nccl['grad_worst']:.2e} of max abs; {nccl['ms'][0]:.1f} ms "
          f"(fetching every gradient); on {card}")
    out["nccl"] = {"calls": nccl["calls"], "loss_rel": rel,
                   "grad_worst": nccl["grad_worst"], "ms": nccl["ms"]}
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return out


# the mesh phase (this slice): C.13's batch reductions under {dp 2}, the
# pipeline + expert leg on {pp 2, ep 2}, the serving mesh; one gang of 4
# ranks over gloo on one card (ranks 2-3 idle in the {dp 2} leg)
MESH_RANKS = 4
C13_LOSS_RTOL = 1e-4
C13_GRAD_REL = 1e-3
C13_STAT_REL = 1e-5
C13_BN_LAYERS = 2
PPEP_RTOL, PPEP_ATOL = 2e-3, 1e-4
PPEP_LM = dict(d_ff=2048, experts=4, stages=4, micro=8, cf=1.25, classes=8)
PPEP_LM_ROWS, PPEP_LM_D = 8192, 512
SERVE_MESHES = ("data=4", "fsdp=2,tp=2")
MESH_LOGIT_TOL = 2e-5        # the reference's rtol = atol
MESH_GREEDY_FLOOR = 0.98     # C.5


def _startup_arrays(build: str, kw: dict) -> tuple:
    """(the startup program's arrays, the parameter names) of a
    ``parallel_cases`` builder, drawn on the CPU."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.types import Place
    from paddle_tpu_torch.tools import parallel_cases as pc

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    pc.BUILDERS[build](fluid, None, **kw)
    exe = fluid.Executor(Place("cpu"))
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    return ({n: np.asarray(scope.find_var(n).numpy())
             for n in scope.var_names()},
            sorted(p.name for p in fluid.default_main_program().parameters()))


def _c13_specs() -> dict:
    rng = np.random.RandomState(11)
    cases = {
        "mlp_sum": ({"momentum": True},
                    {"x": rng.rand(8, 8).astype("float32"),
                     "y": rng.randint(0, 4, (8, 1)).astype("int32")}),
        "conv_bn": ({}, {"img": rng.randn(8, 16, 32, 32).astype("float32"),
                         "lab": rng.randint(0, 10, (8, 1)).astype("int32")})}
    specs = {}
    for build, (kw, feed) in cases.items():
        init, params = _startup_arrays(build, kw)
        stats = sorted(n for n in init if n.endswith((".m", ".v")))
        specs[f"c13 {build}"] = dict(
            kind="c13", build=build, kw=kw, init=init, feeds=[feed],
            fetch=[p + "@GRAD" for p in params], state=params + stats,
            mesh={"dp": 2}, device="cuda")
    return specs


# A.9 part 3's legs on the same gang (this slice): (a) the LM at full
# width on {dp 4} fed by DeviceFeeder(sharding=), fetching accuracy with an
# Accuracy evaluator; (b) dropout on a column-parallel shard and the
# soft-label vocab-parallel loss with its softmax on {dp 2, tp 2} at the
# LM's widths (D 512, d_ff 2048, V 32000; 4 x 128 tokens); (c) ctr
# wide_deep(is_sparse=True) on vocab-sharded tables over {dp 2, tp 2}
# (models.ctr's defaults, each field's vocabulary rounded up to even so
# that tp 2 divides it); (d) switch_moe over a sequence sharded on
# {sp 2, ep 2} at the pp + ep leg's widths (8 x 1024 tokens); (e) the
# serving mesh {data 2, tp 2} with kv_dtype int8, 4 of the serve
# requests.  Each against the single card's run of the same program.
A9_STEPS = 2
A9_TP = dict(T=128, d=512, d_ff=2048, vocab=32000, p=PAR_DROPOUT)
A9_TP_BATCH = 4
A9_MOE = dict(T=1024, d=512, hidden=512, experts=PPEP_LM["experts"],
              d_ff=PPEP_LM["d_ff"], cf=PPEP_LM["cf"],
              classes=PPEP_LM["classes"])
A9_SERVE_MESH = "data=2,tp=2"
A9_SERVE_REQS = 4
A9_SERVE_GEN = 16


def _a9_specs() -> dict:
    """The program legs (a)-(d) of A.9 part 3, as ``program_case`` specs
    (weights from each program's startup on the card: the same draws on
    every rank and on the single card)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import families

    rng = np.random.RandomState(13)
    B, T, V = A9_TP_BATCH, A9_TP["T"], A9_TP["vocab"]
    tp_feed = {"x": rng.randn(B, T, A9_TP["d"]).astype("float32"),
               "soft": rng.rand(B, T, V).astype("float32")}
    ctr_vocabs = [v + v % 2 for v in fluid.datasets.ctr.FIELD_VOCABS]
    moe_feed = {"x": rng.randn(8, A9_MOE["T"], A9_MOE["d"]).astype("float32"),
                "lab": rng.randint(0, A9_MOE["classes"], (8, A9_MOE["T"], 1))
                .astype("int32")}
    base = dict(kind="c13", device="cuda", step_counter=5)
    return {
        "a9 dp4 lm": dict(base, build="lm_metrics", kw={"cfg": LM_CFG},
                          feeds=[_par_feed()] * A9_STEPS,
                          fetch=["$1", "$2", "$3", "$4"], mesh={"dp": 4},
                          feeder=True),
        "a9 dp2 tp2 extras": dict(
            base, build="tp_extras", kw=A9_TP, feeds=[tp_feed] * A9_STEPS,
            fetch=["$1", "$2", "tx.c.w@GRAD", "tx.r.w@GRAD",
                   "tx.o.w@GRAD"], mesh={"dp": 2, "tp": 2}),
        "a9 ctr sparse tp": dict(
            base, build="ctr_tp",
            kw={"is_sparse": True, "vocabs": ctr_vocabs, "emb_dim": 8,
                "hidden": (64, 32)},
            feeds=[families.family_batch("wide_deep", 0)] * A9_STEPS,
            fetch=[], mesh={"dp": 2, "tp": 2},
            state=[f"{k}_emb_{f}" for k in ("wide", "deep")
                   for f in (0, 1, 2)]),
        "a9 moe sp": dict(
            base, build="moe_seq", kw=A9_MOE, feeds=[moe_feed] * A9_STEPS,
            fetch=["$1", "m.w@GRAD", "switch_moe_w_0@GRAD",
                   "switch_moe_w_1@GRAD"], mesh={"sp": 2, "ep": 2}),
    }


def _a9_refs(specs: dict, reqs: list) -> dict:
    """The single card's run of each program leg, and the single int8
    engine's streams for leg (e), with the launches they made."""
    from paddle_tpu_torch.models import init_lm_params
    from paddle_tpu_torch.ops import dropout as dmod
    from paddle_tpu_torch.serving import ContinuousDecodeEngine
    from paddle_tpu_torch.tools import parallel_cases as pc

    refs = {}
    for label, sp in specs.items():
        pc._zero_counters()
        refs[label] = pc.program_case(dict(sp, mesh=None, feeder=False))
        refs[label]["dropout"] = dict(dmod.threefry_dropout.launches)
        _release()
    cfg = dict(ENGINE_CFG, **LM_CFG, kv_dtype="int8")
    eng = ContinuousDecodeEngine(init_lm_params(0, **LM_CFG), **cfg)
    eng.warm()
    refs["a9 serve int8"] = {
        "probe": eng.step_logits(*pc.probe_inputs(eng)),
        "streams": pc.drive_scheduler(eng, 0, 0, reqs=reqs)[0]}
    del eng
    _release()
    return refs


def _a9_check(ranks: list, specs: dict, refs: dict, card: str) -> dict:
    """Hold each leg of A.9 part 3 to the single card's run; print each
    leg's figures."""
    out = {}
    # (a) dp 4: losses within PAR_LOSS_RTOL, accuracy and the evaluator's
    # rate and counts exactly the single card's
    label = "a9 dp4 lm"
    ref, got = refs[label], [r[label] for r in ranks]
    for g in got:
        check(all(set(v[0] for v in st.values()) == {"LocalFeed"}
                  and st["toks"][1] == (PAR_BATCH // 4, LM_CFG["max_len"])
                  for st in g["staged"]),
              f"mesh {label}: the feeder staged {g['staged'][0]}")
        for gs, rs in zip(g["steps"], ref["steps"]):
            lg, lr = float(np.ravel(gs[0])[0]), float(np.ravel(rs[0])[0])
            check(abs(lg - lr) <= PAR_LOSS_RTOL * abs(lr),
                  f"mesh {label}: loss {lg} vs the single card's {lr}")
            check(all(np.array_equal(a, b) for a, b in zip(gs[1:], rs[1:])),
                  f"mesh {label}: accuracy / evaluator {gs[1:]} vs the "
                  f"single card's {rs[1:]}")
    g0 = got[0]
    out[label] = {"losses": [float(np.ravel(s[0])[0]) for s in g0["steps"]],
                  "ref_losses": [float(np.ravel(s[0])[0])
                                 for s in ref["steps"]],
                  "accuracy": [float(np.ravel(s[1])[0]) for s in g0["steps"]],
                  "evaluator": [[float(np.ravel(x)[0]) for x in s[2:]]
                                for s in g0["steps"]]}
    print(f"mesh {label}: LM (V {LM_CFG['vocab_size']}, D "
          f"{LM_CFG['d_model']}, 8 x {LM_CFG['max_len']} tokens) fed by "
          f"DeviceFeeder(sharding=), {PAR_BATCH // 4} rows staged a rank; "
          f"losses {out[label]['losses']} vs single card "
          f"{out[label]['ref_losses']}; accuracy {out[label]['accuracy']} "
          f"and evaluator [rate, correct, total] {out[label]['evaluator']} "
          f"exactly the single card's; on {card}")
    # (b) dp 2 x tp 2: the mask bitwise, the softmax and gradients within
    # PAR_GRAD_REL of their max abs, the loss within PAR_LOSS_RTOL
    label = "a9 dp2 tp2 extras"
    ref, got = refs[label], [r[label] for r in ranks]
    worst = 0.0
    for g in got:
        for gs, rs in zip(g["steps"], ref["steps"]):
            lg, lr = float(np.ravel(gs[0])[0]), float(np.ravel(rs[0])[0])
            check(abs(lg - lr) <= PAR_LOSS_RTOL * abs(lr),
                  f"mesh {label}: loss {lg} vs the single card's {lr}")
            check(np.array_equal(gs[1] == 0, rs[1] == 0),
                  f"mesh {label}: the dropout mask differs from the single "
                  f"card's")
            for name, a, b in zip(specs[label]["fetch"][1:], gs[2:],
                                  rs[2:]):
                e = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                check(e <= PAR_GRAD_REL, f"mesh {label}: {name} off by "
                                         f"{e:.3e} of its max abs")
                worst = max(worst, e)
    drops = [g["dropout"] for g in got]
    check(all(d == {"fwd": A9_STEPS, "bwd": A9_STEPS} for d in drops),
          f"mesh {label}: dropout launches by rank {drops}, want one fwd "
          f"and one bwd a step")
    out[label] = {"losses": [float(np.ravel(s[0])[0])
                             for s in got[0]["steps"]],
                  "worst": worst, "dropout_launches": drops,
                  "nonzero": float((ref["steps"][0][1] != 0).mean())}
    print(f"mesh {label}: dropout {A9_TP['p']} on the column-parallel "
          f"[{A9_TP_BATCH}, {A9_TP['T']}, {A9_TP['d_ff']}] output (the "
          f"one-level tp map), mask bitwise the single card's (non-zero "
          f"after relu and dropout {out[label]['nonzero']:.4f}); soft-label vocab-parallel loss over "
          f"V {A9_TP['vocab']} with return_softmax, losses "
          f"{out[label]['losses']}, softmax and gradients within "
          f"{worst:.2e} of max abs; dropout launches by rank {drops}; on "
          f"{card}")
    # (c) ctr is_sparse on tp-sharded tables
    label = "a9 ctr sparse tp"
    ref, got = refs[label], [r[label] for r in ranks]
    worst = 0.0
    for g in got:
        for gs, rs in zip(g["steps"], ref["steps"]):
            lg, lr = float(np.ravel(gs[0])[0]), float(np.ravel(rs[0])[0])
            check(abs(lg - lr) <= PAR_LOSS_RTOL * abs(lr),
                  f"mesh {label}: loss {lg} vs the single card's {lr}")
        for n, w in ref["state"].items():
            e = float(np.abs(g["state"][n] - w).max()) / max(
                float(np.abs(w).max()), 1e-30)
            check(e <= PAR_GRAD_REL, f"mesh {label}: table {n} off by "
                                     f"{e:.3e} of its max abs")
            worst = max(worst, e)
    out[label] = {"losses": [float(np.ravel(s[0])[0])
                             for s in got[0]["steps"]], "worst": worst}
    print(f"mesh {label}: wide_deep(is_sparse=True), 26 vocab-sharded "
          f"tables over tp 2 (the sparse engine's rule on each rank's rows),"
          f" losses {out[label]['losses']} vs single card "
          f"{[float(np.ravel(s[0])[0]) for s in ref['steps']]}; the "
          f"largest tables after {A9_STEPS} Adam steps within {worst:.2e} "
          f"of max abs; on {card}")
    # (d) switch_moe over a sequence sharded on sp: the loss and the aux
    # loss within PAR_LOSS_RTOL, the gradients within PAR_GRAD_REL of
    # their max abs, as legs (a)-(c)
    label = "a9 moe sp"
    ref, got = refs[label], [r[label] for r in ranks]
    worst = 0.0
    for g in got:
        l_g = [float(np.ravel(s[0])[0]) for s in g["steps"]]
        l_r = [float(np.ravel(s[0])[0]) for s in ref["steps"]]
        for gs, rs in zip(g["steps"], ref["steps"]):
            for name, a, b in zip(["loss"] + specs[label]["fetch"], gs, rs):
                if name in ("loss", "$1"):
                    check(np.allclose(a, b, rtol=PAR_LOSS_RTOL, atol=0.0),
                          f"mesh {label}: {name} {np.ravel(a)} vs the "
                          f"single card's {np.ravel(b)}")
                    continue
                e = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                check(e <= PAR_GRAD_REL, f"mesh {label}: {name} off by "
                                         f"{e:.3e} of its max abs")
                worst = max(worst, e)
    out[label] = {"losses": l_g, "ref_losses": l_r, "grad_worst": worst}
    print(f"mesh {label}: switch_moe ({A9_MOE['experts']} experts, d_ff "
          f"{A9_MOE['d_ff']}, cf {A9_MOE['cf']}) over 8 x {A9_MOE['T']} "
          f"tokens, sequence on sp 2, experts on ep 2: losses {l_g} vs the "
          f"single card's {l_r} (loss and aux loss rtol {PAR_LOSS_RTOL}); "
          f"gradients within {worst:.2e} of max abs (limit {PAR_GRAD_REL});"
          f" on {card}")
    # (e) the int8 serving mesh
    label = "a9 serve int8"
    ref, got = refs[label], [r[label] for r in ranks]
    n_layers = LM_CFG["n_layers"]
    for r in got:
        check(all(np.array_equal(a, b) for a, b in
                  zip(r["streams"], got[0]["streams"])),
              f"mesh {label}: ranks disagree on the tokens")
        check(r["blocks"]["leaked"] == 0 and r["blocks"]["occupied"] == 0,
              f"mesh {label}: blocks leaked {r['blocks']}")
        check(r["paged"] == n_layers * r["steps"] and r["steps"] > 0,
              f"mesh {label}: {r['paged']} paged launches for {r['steps']} "
              f"steps x {n_layers} layers")
        check(r["pool_heads"] == LM_CFG["n_heads"] // 2,
              f"mesh {label}: pool heads {r['pool_heads']}")
    g = got[0]
    rate = _match_rate(g["streams"], ref["streams"])
    err = float(np.abs(g["logits"] - ref["probe"]).max())
    check(np.allclose(g["logits"], ref["probe"], rtol=MESH_LOGIT_TOL,
                      atol=MESH_LOGIT_TOL),
          f"mesh {label}: step logits off the single card's by {err:.3e}")
    check(rate >= MESH_GREEDY_FLOOR, f"mesh {label}: greedy match {rate:.4f}")
    out[label] = {"match_rate": rate, "logit_err": err,
                  "paged": [r["paged"] for r in got],
                  "steps": [r["steps"] for r in got],
                  "mean_step_ms": [1e3 * r["wall_s"] / r["steps"]
                                   for r in got]}
    print(f"mesh {label}: {A9_SERVE_MESH}, int8 pool (payload and scales "
          f"{LM_CFG['n_heads'] // 2} heads a rank), {A9_SERVE_REQS} "
          f"requests; greedy match {rate:.4f} against the single card's "
          f"int8 engine, step logits {err:.3e} max off it (rtol = atol "
          f"{MESH_LOGIT_TOL}); paged int8 "
          f"launches by rank {out[label]['paged']} (= {n_layers} x steps "
          f"{out[label]['steps']}); mean step ms "
          f"{[round(t, 1) for t in out[label]['mean_step_ms']]}; on {card}")
    return out


def _serve_reqs() -> list:
    """16 greedy requests: the serve phase's prompt and length draws."""
    rng = np.random.RandomState(1)
    V = LM_CFG["vocab_size"]
    return [(rng.randint(2, V, rng.randint(16, 513)).astype(np.int32),
             int(rng.randint(32, 65))) for _ in range(16)]


def phase_mesh(card: str) -> dict:
    """ROADMAP C.13's repair and A.9 part 2 on the card, one gang of 4
    gloo ranks sharing it, each leg held to the single card's run of the
    same program (see PERF.md section 2)."""
    import functools

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.models import init_lm_params
    from paddle_tpu_torch.ops.batch_norm import batch_norm_train
    from paddle_tpu_torch.serving import ContinuousDecodeEngine
    from paddle_tpu_torch.tools import dryrun_multichip as dry
    from paddle_tpu_torch.tools import parallel_cases as pc

    specs = _c13_specs()
    refs = {}
    for label, sp in specs.items():
        if sp["kind"] != "c13":
            continue
        batch_norm_train.launches.update(reduce=0, dx=0)
        refs[label] = pc.program_case(dict(sp, mesh=None))
        refs[label]["bn"] = dict(batch_norm_train.launches)
    _release()
    rng = np.random.RandomState(12)
    ppep_feeds = {"ppep dryrun": dry.ppep_feed(MESH_RANKS),
                  "ppep lm": {"x": rng.randn(PPEP_LM_ROWS, PPEP_LM_D)
                              .astype("float32"),
                              "lab": rng.randint(0, PPEP_LM["classes"],
                                                 (PPEP_LM_ROWS, 1))
                              .astype("int32")}}
    ppep_dims = {"ppep dryrun": {}, "ppep lm": PPEP_LM}
    for label, feed in ppep_feeds.items():
        rec = {}
        torch.cuda.reset_peak_memory_stats()
        refs[label] = {"losses": dry.ppep_two_steps(
            MESH_RANKS, feed, record=rec, **ppep_dims[label]),
            "ms": rec["ms"],
            "peak_bytes": torch.cuda.max_memory_allocated()}
        specs[label] = dict(kind="ppep", n=MESH_RANKS, feed=feed,
                            dims=ppep_dims[label], device="cuda")
        _release()
    reqs = _serve_reqs()
    cfg = dict(ENGINE_CFG, **LM_CFG)
    single = ContinuousDecodeEngine(init_lm_params(0, **LM_CFG), **cfg)
    single.warm()
    probe = single.step_logits(*pc.probe_inputs(single))
    streams, _, handles, wall = pc.drive_scheduler(single, 0, 0, reqs=reqs)
    refs["serve"] = {"probe": probe, "streams": streams, "wall_s": wall,
                     "ttft_ms": [1e3 * (h.t_first_token - h.t_submit)
                                 for h in handles],
                     "steps": sum(single.step_dispatches.values())}
    del single
    _release()
    for m in SERVE_MESHES:
        specs[f"serve {m}"] = dict(
            kind="serve", mesh=m, cfg=cfg, reqs=reqs, device="cuda",
            params=functools.partial(init_lm_params, 0, **LM_CFG))
    a9 = _a9_specs()
    a9_reqs = [(p, min(g, A9_SERVE_GEN)) for p, g in reqs[:A9_SERVE_REQS]]
    refs.update(_a9_refs(a9, a9_reqs))
    specs.update(a9)
    specs["a9 serve int8"] = dict(
        kind="serve", mesh=A9_SERVE_MESH, cfg=dict(cfg, kv_dtype="int8"),
        reqs=a9_reqs, device="cuda",
        params=functools.partial(init_lm_params, 0, **LM_CFG))
    t0 = time.perf_counter()
    ranks = distributed.spawn(pc.run_cases, MESH_RANKS, specs, True,
                              device="cuda:0",
                              timeout_s=900, group_timeout_s=300)
    gang_s = time.perf_counter() - t0
    print(f"mesh: gang of {MESH_RANKS} gloo ranks on one card, {gang_s:.1f} "
          f"s with start-up; on {card}")
    out = {"gang_s": gang_s}

    # C.13: {dp 2} against the single card, one Momentum step
    for label in ("c13 mlp_sum", "c13 conv_bn"):
        ref, sp = refs[label], specs[label]
        live = [r[label] for r in ranks if not r[label].get("idle")]
        check(len(live) == 2, f"{label}: {len(live)} ranks ran it")
        for r in live:
            lg, lr = (float(np.ravel(x[0])[0]) for x in (r["steps"][0],
                                                         ref["steps"][0]))
            check(abs(lg - lr) <= C13_LOSS_RTOL * abs(lr),
                  f"{label}: loss {lg} vs the single card's {lr}")
            worst = 0.0
            for name, g, w in zip(sp["fetch"], r["steps"][0][1:],
                                  ref["steps"][0][1:]):
                e = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
                check(e <= C13_GRAD_REL, f"{label}: {name} off by {e:.3e} "
                                         f"of its max abs")
                worst = max(worst, e)
            stat_worst = 0.0
            for name in sp["state"]:
                if name.endswith((".m", ".v")):
                    w = ref["state"][name]
                    e = float(np.abs(r["state"][name] - w).max()) / max(
                        float(np.abs(w).max()), 1e-30)
                    check(e <= C13_STAT_REL, f"{label}: running statistic "
                                             f"{name} off by {e:.3e}")
                    stat_worst = max(stat_worst, e)
            want_bn = ({"reduce": C13_BN_LAYERS, "dx": C13_BN_LAYERS}
                       if label.endswith("conv_bn") else {"reduce": 0,
                                                           "dx": 0})
            check(r["bn"] == want_bn,
                  f"{label}: batch-norm launches "
                                      f"{r['bn']} a rank, want {want_bn}")
        out[label] = {"loss": lg, "ref_loss": lr, "grad_worst": worst,
                      "stat_worst": stat_worst,
                      "bn": [r["bn"] for r in live]}
        print(f"mesh {label}: dp 2, loss {lg:.6f} vs single card {lr:.6f}; "
              f"worst gradient {worst:.2e} of max abs; running statistics "
              f"{stat_worst:.2e}; batch-norm launches by rank "
              f"{[r['bn'] for r in live]}; on {card}")
    out.update(_a9_check(ranks, a9, refs, card))

    # pp + ep against the single card's sequential fold
    for label in ppep_feeds:
        ref = refs[label]
        got = [r[label] for r in ranks]
        for r in got:
            check(r["losses"] == got[0]["losses"],
                  f"{label}: ranks disagree on the losses")
        l1, l2 = got[0]["losses"]
        # the reference's contract: the fold's losses; the dry run's
        # program also learns (the LM-width arm's Adam(1e-2) step on random
        # rows need not)
        check(np.allclose([l1, l2], ref["losses"], rtol=PPEP_RTOL,
                          atol=PPEP_ATOL)
              and (l2 < l1 or label != "ppep dryrun"),
              f"{label}: losses {[l1, l2]} vs the fold's {ref['losses']}")
        out[label] = {"losses": [l1, l2], "ref_losses": ref["losses"],
                      "ms": [r["ms"] for r in got],
                      "ref_ms": ref["ms"],
                      "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in got],
                      "ref_peak_gib": ref["peak_bytes"] / 2 ** 30}
        print(f"mesh {label}: pp 2 x ep 2, losses {l1:.6f} -> {l2:.6f} vs "
              f"the single card's fold {ref['losses'][0]:.6f} -> "
              f"{ref['losses'][1]:.6f}; ms a step by rank "
              f"{[[round(m, 1) for m in r['ms']] for r in got]} (fold "
              f"{[round(m, 1) for m in ref['ms']]}); peak GiB by rank "
              f"{[round(g, 3) for g in out[label]['peak_gib']]} (fold "
              f"{out[label]['ref_peak_gib']:.3f}); on {card}")

    # the serving mesh against the single card's engine
    ref = refs["serve"]
    n_layers = LM_CFG["n_layers"]
    for m in SERVE_MESHES:
        label = f"serve {m}"
        got = [r[label] for r in ranks]
        for r in got:
            check(all(np.array_equal(a, b) for a, b in
                      zip(r["streams"], got[0]["streams"])),
                  f"mesh {label}: ranks disagree on the tokens")
            check(r["blocks"]["leaked"] == 0 and r["blocks"]["occupied"] == 0,
                  f"mesh {label}: blocks leaked {r['blocks']}")
            check(r["paged"] == n_layers * r["steps"] and r["steps"] > 0,
                  f"mesh {label}: {r['paged']} paged launches for "
                  f"{r['steps']} steps x {n_layers} layers")
        g = got[0]
        err = float(np.abs(g["logits"] - ref["probe"]).max())
        bitwise = bool(np.array_equal(g["logits"], ref["probe"]))
        check(np.allclose(g["logits"], ref["probe"], rtol=MESH_LOGIT_TOL,
                          atol=MESH_LOGIT_TOL),
              f"mesh {label}: step logits off the single card's by {err:.3e}")
        rate = _match_rate(g["streams"], ref["streams"])
        exact = sum(np.array_equal(a, b) for a, b in zip(g["streams"],
                                                         ref["streams"]))
        check(rate >= MESH_GREEDY_FLOOR,
              f"mesh {label}: greedy match {rate:.4f}")
        if m.startswith("data"):
            check(isinstance(g["warm"], int) and g["warm"] > 0,
                  f"mesh {label}: warm() {g['warm']!r}")
            for r in got:
                check(r["replays"] == r["steps"] + r["prefills"],
                      f"mesh {label}: replays {r['replays']} != dispatches "
                      f"{r['steps']} + {r['prefills']}")
                check(r["pool_heads"] == LM_CFG["n_heads"],
                      f"mesh {label}: pool heads {r['pool_heads']}")
        else:
            check(isinstance(g["warm"], str) and "gloo" in g["warm"],
                  f"mesh {label}: warm() should raise WarmError, gave "
                  f"{g['warm']!r}")
            for r in got:
                check(r["pool_heads"] == LM_CFG["n_heads"] // 2,
                      f"mesh {label}: pool heads {r['pool_heads']}")
        tokens = sum(len(s) for s in g["streams"])
        rec = {"tokens_s": [tokens / r["wall_s"] for r in got],
               "mean_step_ms": [1e3 * r["wall_s"] / r["steps"] for r in got],
               "ttft_p50_ms": [float(np.median(r["ttft_ms"])) for r in got],
               "paged": [r["paged"] for r in got],
               "steps": [r["steps"] for r in got],
               "logit_err": err, "bitwise": bitwise, "match_rate": rate,
               "exact_streams": int(exact),
               "warm": g["warm"] if isinstance(g["warm"], int) else
               "WarmError"}
        out[label] = rec
        print(f"mesh {label}: step logits {'bitwise' if bitwise else 'not bitwise'}"
              f" ({err:.3e} max off the single card's); greedy match "
              f"{rate:.4f}, {exact} of {len(reqs)} streams exact; warm "
              f"{rec['warm']}; paged launches by rank {rec['paged']} "
              f"(= {n_layers} x steps {rec['steps']}); tokens/s by rank "
              f"{[round(t, 1) for t in rec['tokens_s']]}, mean step ms "
              f"{[round(t, 2) for t in rec['mean_step_ms']]}, TTFT p50 ms "
              f"{[round(t, 1) for t in rec['ttft_p50_ms']]} (single card "
              f"{tokens / ref['wall_s']:.1f} tokens/s, "
              f"{1e3 * ref['wall_s'] / ref['steps']:.2f} ms a step, TTFT "
              f"p50 {float(np.median(ref['ttft_ms'])):.1f} ms); no block "
              f"leaked; on {card}")
    return out


# ---------------------------------------------------------------- trainer_io
# The trainer_io phase (ROADMAP A.12 part 3): the LM at LM_CFG's width
# trained by fluid.Trainer with checkpoints and resumed; inference artifacts
# of the LM's logits, text_lstm and a conv + BN + ReLU program; the anomaly
# guard's skip / rollback / budget on the card.  Files go under build/.

TRAINER_IO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke_trainer_io")
TRAINER_IO_STEPS = 6          # one pass of 6 batches of TRAIN_BATCH x 1024
TRAINER_IO_EVERY = 2          # checkpoint_every_n_steps
TRAINER_IO_RESUME = 4         # the step the second Trainer resumes from
ARTIFACT_LM_BATCHES = (2, 3)  # the symbolic batch at two sizes
ARTIFACT_LSTM_BATCH = 16
ARTIFACT_CONV = CONV_CASES[0]  # row 8's c56 [256, 56, 56, 64] x 64


class _Cursor:
    """A task-queue stand-in with the Trainer's ``snapshot`` / ``rewind`` /
    ``new_epoch``: the batches of the pass trained so far, which the event
    handler advances, so that a checkpoint's snapshot counts trained
    batches exactly and a resumed Trainer reads on from there."""

    def __init__(self, path=None):
        self.done = 0
        if path is not None:
            self.rewind(path)

    def snapshot(self, path):
        with open(path + ".tmp", "w") as f:
            json.dump({"done": self.done}, f)
        os.replace(path + ".tmp", path)

    def rewind(self, path):
        with open(path) as f:
            self.done = json.load(f)["done"]

    def new_epoch(self):
        self.done = 0


def _lm_trainer(ckpt_dir: str, cursor: _Cursor):
    """The LM at LM_CFG's width in fresh programs and scope, under a
    Trainer with train_profile's optimizer (Adam 1e-3, global-norm clip
    1.0), checkpoints every TRAINER_IO_EVERY steps, ``cursor`` as its task
    queue; returns (trainer, tokens, labels, loss, logits)."""
    import paddle_tpu_torch as fluid

    T = LM_CFG["max_len"]
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    toks = fluid.layers.data("toks", [T], dtype="int32")
    labs = fluid.layers.data("labs", [T, 1], dtype="int32")
    loss, logits = fluid.models.build_lm(toks, labs, **LM_CFG)
    tr = fluid.Trainer(
        loss, fluid.optimizer.Adam(
            1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)),
        [toks, labs], checkpoint_dir=ckpt_dir,
        checkpoint_every_n_steps=TRAINER_IO_EVERY, task_queue=cursor,
        queue_snapshot_path=ckpt_dir + ".snap")
    return tr, toks, labs, loss, logits


def _lm_samples(seed: int) -> list:
    from paddle_tpu_torch.tools.train_profile import train_batch

    f = train_batch(seed)
    return [(f["toks"][i], f["labs"][i]) for i in range(len(f["toks"]))]


def _flash_counts() -> dict:
    from paddle_tpu_torch.ops import flash_attention

    return dict(flash_attention.launches)


def _train_lm(tr, cursor, batches, num_passes=1):
    """Train ``tr`` over ``batches`` from the cursor on; returns (losses,
    the scope's tensors cloned at BeginPass 0, its step counter then,
    seconds)."""
    import paddle_tpu_torch as fluid

    losses, init = [], {}

    def handler(e):
        if isinstance(e, fluid.events.BeginPass) and not init:
            scope = fluid.global_scope()
            init.update({n: v.clone() for n, v in scope.items()})
            init["@counter"] = scope.step_counter
        elif isinstance(e, fluid.events.EndIteration):
            losses.append(e.cost)
            cursor.done += 1
        elif isinstance(e, fluid.events.AnomalyDetected):
            fail(f"trainer_io: the LM step {e.batch_id} was not finite")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train(lambda: iter(batches[cursor.done:]), num_passes=num_passes,
             event_handler=handler)
    torch.cuda.synchronize()
    return losses, init, time.perf_counter() - t0


def _close_f32(label: str, got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want|, failing beyond TOLERANCE["float32"] elementwise
    (atol + rtol |want|)."""
    atol, rtol = TOLERANCE["float32"]
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: shape {got.shape} (want {want.shape}) or non-finite")
    d = np.abs(got - want)
    check(bool((d <= atol + rtol * np.abs(want)).all()),
          f"{label}: {float(d.max()):.3e} off the in-process forward")
    return float(d.max())


def _artifact(label: str, dirname: str, exe, feed_names, target, program,
              feeds: list, kernel: tuple, per_call: int) -> dict:
    """Export ``target`` of ``program`` (its current weights in the global
    scope) with ``save_inference_model``, run the pruned program eagerly on
    each of ``feeds`` (the in-process forward), load the artifact after a
    reset of programs and scope, and hold its outputs to the forward within
    the float32 limits; a repeat of the first feed prepares nothing new.
    ``kernel``: (counter read, its custom op's graph target); each replay
    must add ``per_call`` launches.  Returns the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as tio

    read, target_name = kernel
    t0 = time.perf_counter()
    tio.save_inference_model(dirname, feed_names, [target], exe,
                             main_program=program, example_batch=2)
    export_s = time.perf_counter() - t0
    pruned = program.prune([target])
    wants = [exe.run(pruned, feed=f, fetch_list=[target])[0] for f in feeds]
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    infer, _, _ = tio.load_inference_model(dirname)
    targets = [str(n.target) for n in infer.exported.graph.nodes
               if n.op == "call_function"]
    n_ops = targets.count(target_name)
    check(n_ops > 0, f"{label}: the exported graph holds no {target_name}")
    worst = []
    for f, want in zip(feeds, wants):
        worst.append(_close_f32(label, infer(f)[0], want))
    traces = infer.trace_count()
    check(traces == len({tuple(np.shape(v) for v in f.values())
                         for f in feeds}),
          f"{label}: {traces} signatures prepared for {len(feeds)} feeds")
    before = read()
    again = infer(feeds[0])[0]
    torch.cuda.synchronize()
    check(infer.trace_count() == traces,
          f"{label}: a repeated signature prepared a new one")
    check(read() - before == per_call,
          f"{label}: a replay launched {read() - before} kernels, want "
          f"{per_call}")
    check(again.tobytes() == infer(feeds[0])[0].tobytes(),
          f"{label}: two replays of one feed differ")
    rec = {"symbolic_batch": infer.symbolic_batch, "export_s": export_s,
           "graph_ops": n_ops, "max_abs_err": max(worst),
           "signatures": traces, "launches_per_call": per_call}
    print(f"trainer_io {label}: exported in {export_s:.2f} s (symbolic "
          f"batch {infer.symbolic_batch}), {n_ops} {target_name} nodes; "
          f"{len(feeds)} feeds against the in-process forward, max |d| "
          f"{max(worst):.3e} (limit atol {TOLERANCE['float32'][0]} + rtol "
          f"{TOLERANCE['float32'][1]}); {traces} signatures, none more on a "
          f"repeat, {per_call} kernel launch(es) a replay")
    return rec


def _trainer_io_artifacts(tr, toks_var, logits) -> dict:
    """(c): the LM-logits artifact (batch 2 and 3 under the symbolic
    batch), text_lstm at TEXT_LSTM_CFG and one conv + BN + ReLU program
    at row 8's c56 shape."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import conv as conv_ops
    from paddle_tpu_torch.ops import fused_lstm
    from paddle_tpu_torch.tools.train_profile import (TEXT_LSTM_CFG,
                                                      TEXT_LSTM_SEQ,
                                                      text_lstm_batch,
                                                      text_lstm_params)

    out = {}
    rng = np.random.RandomState(11)
    feeds = [{"toks": rng.randint(0, LM_CFG["vocab_size"],
                                  (n, LM_CFG["max_len"])).astype(np.int32)}
             for n in ARTIFACT_LM_BATCHES]
    out["lm"] = _artifact(
        "lm logits", os.path.join(TRAINER_IO_DIR, "lm_artifact"), tr.exe,
        ["toks"], logits, tr.program, feeds,
        (lambda: _flash_counts()["fwd"], "paddle_tpu_torch.flash_fwd.default"),
        LM_CFG["n_layers"])
    check(out["lm"]["symbolic_batch"] and out["lm"]["graph_ops"]
          == LM_CFG["n_layers"], f"lm logits artifact: {out['lm']}")

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    words = fluid.layers.data("words", [TEXT_LSTM_SEQ], dtype="int32")
    lengths = fluid.layers.data("lengths", [-1], dtype="int32",
                                append_batch_size=False)
    label = fluid.layers.data("label", [1], dtype="int32")
    _, _, pred = fluid.models.text_lstm.build(words, lengths, label,
                                              **TEXT_LSTM_CFG)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    fluid.load_scope(text_lstm_params(0), fluid.default_main_program(),
                     fluid.global_scope())
    b = text_lstm_batch(3, ARTIFACT_LSTM_BATCH)
    out["text_lstm"] = _artifact(
        "text_lstm", os.path.join(TRAINER_IO_DIR, "text_lstm_artifact"), exe,
        ["words", "lengths"], pred, fluid.default_main_program(),
        [{"words": b["words"], "lengths": b["lengths"]}],
        (lambda: fused_lstm.launches["fwd"],
         "paddle_tpu_torch.lstm_fwd.default"), TEXT_LSTM_CFG["num_layers"])

    _, n, h, w, c, o = ARTIFACT_CONV
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    img = fluid.layers.data("img", [c, h, w])
    y = fluid.layers.batch_norm(fluid.layers.conv2d(
        img, o, 3, padding=1, bias_attr=False), act="relu")
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    prog = fluid.default_main_program()
    prng = np.random.RandomState(5)
    arrays = {}
    for v in prog.persistable_vars():
        shape = tuple(v.shape)
        if len(shape) == 4:
            a = prng.standard_normal(shape) * (2.0 / (9 * c)) ** 0.5
        elif "var" in v.name.split(".")[-1] or v.name.endswith("variance"):
            a = prng.uniform(0.5, 1.5, shape)
        else:
            a = prng.standard_normal(shape) * 0.1 + (
                1.0 if "scale" in v.name or v.name.endswith("_w_0") else 0.0)
        arrays[v.name] = a.astype(np.float32)
    fluid.load_scope(arrays, prog, fluid.global_scope())
    x = prng.standard_normal((n, c, h, w)).astype(np.float32)
    before = dict(conv_ops.route_launches)
    out["conv"] = _artifact(
        "conv_bn_relu", os.path.join(TRAINER_IO_DIR, "conv_artifact"), exe,
        ["img"], y, prog, [{"img": x}],
        (lambda: conv_ops.launches["fused"],
         "paddle_tpu_torch.conv_igemm_fused.default"), 1)
    routes = {k: conv_ops.route_launches[k] - before[k] for k in before}
    check(routes["halo_f32"] > 0 and routes["gather"] == routes["halo"] == 0,
          f"conv artifact: routes {routes}, want halo_f32 only")
    out["conv"]["route_launches"] = routes
    return out


def _trainer_io_anomaly(card: str) -> dict:
    """(d): a uci_housing regression through fluid.Trainer on the card: a
    NaN batch skipped with the parameters bitwise unchanged over it; a
    burst of NaN past the budget rolled back to the step-4 checkpoint and
    the pass replayed; persistent anomalies raising
    AnomalyBudgetExceeded."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.datasets import uci_housing

    base = list(fluid.reader.batch(uci_housing.train(128), 16)())

    def model():
        fluid.reset_default_programs()
        fluid.reset_global_scope()
        x = fluid.layers.data("x", [13])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, 1), y))
        return loss, [x, y]

    def poisoned(batch):
        xs, ys = batch[0]
        return [(np.full_like(xs, np.nan), ys)] + batch[1:]

    loss, feeds = model()
    tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.01), feeds)
    seen, snaps = [], {}

    def handler(e):
        seen.append(type(e).__name__)
        key = (type(e).__name__, getattr(e, "batch_id", None))
        if key in (("EndIteration", 2), ("BeginIteration", 4)):
            snaps[key] = {n: v.clone() for n, v in
                          fluid.global_scope().items()}

    tr.train(lambda: iter([poisoned(b) if i == 3 else b
                           for i, b in enumerate(base)]),
             event_handler=handler)
    a, b = snaps[("EndIteration", 2)], snaps[("BeginIteration", 4)]
    check(seen.count("AnomalyDetected") == 1
          and seen.count("EndIteration") == len(base) - 1
          and tr.global_step == len(base) - 1
          and all(torch.equal(a[n], b[n]) for n in a),
          f"anomaly skip: events {seen}, step {tr.global_step}")

    loss, feeds = model()
    d = os.path.join(TRAINER_IO_DIR, "anomaly")
    tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.01), feeds,
                       checkpoint_dir=d, checkpoint_every_n_steps=2,
                       anomaly_budget=1, max_rollbacks=2)
    attempts, seen = [0], []

    def burst():
        attempts[0] += 1
        return iter([poisoned(b) if attempts[0] == 1 and i >= 4 else b
                     for i, b in enumerate(base)])

    tr.train(burst, event_handler=lambda e: seen.append(type(e).__name__))
    rollback_step = tr.global_step
    check(attempts[0] == 2 and rollback_step == 4 + len(base)
          and seen.count("AnomalyDetected") == 2,
          f"anomaly rollback: {attempts[0]} attempts, step {rollback_step}")

    loss, feeds = model()
    tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.01), feeds,
                       anomaly_budget=0, max_rollbacks=1)
    try:
        tr.train(lambda: iter([poisoned(b) for b in base[:4]]))
        fail("anomaly budget: persistent NaN batches did not raise")
    except fluid.AnomalyBudgetExceeded as e:
        raised = str(e)
    print(f"trainer_io anomaly: {len(base)} uci_housing batches of 16 on the "
          f"card: batch 3 NaN skipped, the parameters bitwise unchanged "
          f"over it; a NaN burst past a budget of 1 rolled back to step 4 "
          f"and replayed (step {rollback_step}); persistent NaN raised "
          f"AnomalyBudgetExceeded ({raised[:60]}...); on {card}")
    return {"batches": len(base), "rollback_attempts": attempts[0]}


def phase_custom_ops(card: str) -> dict:
    """Rows 2 and 5 through their custom ops (``paddle_tpu_torch::
    flash_fwd``, ``lstm_fwd``) against the wrappers called directly, in
    turns (direct, op, op, direct), event-timed and device ms: the flash
    forward at the kernel phase's float32 case, the LSTM forward without
    residuals (the inference form) at text_lstm's shape.  Early in the
    run, beside the kernel phases: late in a run the profiler drops a
    window's first records of a library-launched kernel (ROADMAP C.2)."""
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.ops import lstm as TL

    dev = torch.device("cuda")
    _, N, Tq, Tk, D, causal = FLASH_CASES[0]
    q, k, v, _ = _flash_inputs(N, Tq, Tk, D, torch.float32, dev)
    scale = D ** -0.5
    T, B, H = LSTM_SHAPE
    lengths = np.random.RandomState(0).randint(T // 2, T + 1, B)
    xw, u, peep, mask, _, _ = _lstm_inputs(T, B, H, lengths, dev, 3)
    arms = {
        "flash_fwd": (lambda i: TA.flash_fwd_kernel(q, k, v, scale, causal),
                      lambda i: TA.flash_fwd_op(q, k, v, scale, causal)),
        "fused_lstm_fwd": (
            lambda i: TL.lstm_fwd_kernel(xw, u, peep, mask, H, False,
                                         LSTM_ACTS, False),
            lambda i: TL.lstm_fwd_op(xw, u, peep, mask, H, False,
                                     *LSTM_ACTS)),
    }
    out = {}
    for name, (direct, op) in arms.items():
        check(torch.equal(op(0)[0], direct(0)[0]),
              f"{name}: the custom op's output differs from the wrapper's")
        runs = [("direct", direct), ("op", op), ("op", op),
                ("direct", direct)]
        times = {"direct": [], "op": []}
        for arm, fn in runs:
            times[arm].append(both_ms(fn))
        out[name] = {arm: {"ms": [t[0] for t in ts],
                           "device_ms": [t[1] for t in ts]}
                     for arm, ts in times.items()}
        print(f"custom op {name}: direct / op ms "
              f"{[round(t[0], 4) for t in times['direct']]} / "
              f"{[round(t[0], 4) for t in times['op']]}, device "
              f"{[t[1] for t in times['direct']]} / "
              f"{[t[1] for t in times['op']]} (turns: direct, op, op, "
              f"direct); on {card}")
    return out


def phase_trainer_io(card: str) -> dict:
    """The LM at LM_CFG's width through fluid.Trainer (a): TRAINER_IO_STEPS
    Adam steps of TRAIN_BATCH x 1024 tokens with a checkpoint every
    TRAINER_IO_EVERY, the losses bitwise a bare Executor's warmed on the
    same program from the same state and batches, every flash kernel
    launched n_layers x (steps + 1) times (the warm's eager run, then a
    replay a step); (b) a new Trainer resumed from step TRAINER_IO_RESUME
    (its checkpoint and queue cursor alone), its steps bitwise the first
    run's; (c) the three inference artifacts; (d) the anomaly guard."""
    import shutil

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.tools.train_profile import feed_sig

    shutil.rmtree(TRAINER_IO_DIR, ignore_errors=True)
    os.makedirs(TRAINER_IO_DIR)
    # the anomaly leg's rollback postmortems stay in the phase's directory
    os.environ["PADDLE_TPU_POSTMORTEM_DIR"] = os.path.join(TRAINER_IO_DIR,
                                                           "postmortem")
    n_layers = LM_CFG["n_layers"]
    rec = {}
    try:
        batches = [_lm_samples(100 + s) for s in range(TRAINER_IO_STEPS)]
        d1 = os.path.join(TRAINER_IO_DIR, "lm")
        cur = _Cursor()
        tr, toks, labs, loss, logits = _lm_trainer(d1, cur)
        _zero_counters()
        obs.metrics.reset()
        losses, init, secs = _train_lm(tr, cur, batches)
        launches = _flash_counts()
        snap = obs.metrics.snapshot()
        check(len(losses) == TRAINER_IO_STEPS and all(np.isfinite(losses)),
              f"trainer_io: losses {losses}")
        want = n_layers * (TRAINER_IO_STEPS + 1)
        check(all(launches[k] == want for k in FLASH_KERNELS),
              f"trainer_io: flash launches {launches}, want {want} each "
              f"(the warm's eager run and {TRAINER_IO_STEPS} replays)")
        check(tr.exe.compiles == 1 and tr.exe.replays == TRAINER_IO_STEPS,
              f"trainer_io: compiles {tr.exe.compiles}, replays "
              f"{tr.exe.replays}")
        cm = tio.CheckpointManager(d1)
        steps = sorted(int(n.split("-")[1]) for n in os.listdir(d1)
                       if n.startswith("ckpt-"))
        check(cm.latest_step() == TRAINER_IO_STEPS
              and steps == list(range(TRAINER_IO_EVERY, TRAINER_IO_STEPS + 1,
                                      TRAINER_IO_EVERY)),
              f"trainer_io: checkpoints {steps}, latest {cm.latest_step()}")
        # (obs) the Trainer's counters against this phase's own count: the
        # steps, the periodic saves and the final one, one warmed signature
        got = {k: snap["counters"].get(k, 0) for k in (
            "train.steps", "train.epochs", "ckpt.saves",
            "compile.executor_compiles")}
        want = {"train.steps": TRAINER_IO_STEPS, "train.epochs": 1,
                "ckpt.saves": len(steps) + 1,
                "compile.executor_compiles": 1}
        hist = snap["histograms"]
        check(got == want and hist["train.step_ms"]["count"]
              == TRAINER_IO_STEPS and hist["ckpt.save_ms"]["count"]
              == len(steps) + 1,
              f"obs trainer: counters {got}, want {want}; histograms "
              f"{ {k: v['count'] for k, v in hist.items()} }")
        print(f"obs trainer: counters {got} equal the phase's own count; "
              f"train.step_ms mean {hist['train.step_ms']['sum'] / TRAINER_IO_STEPS:.2f} ms "
              f"over {TRAINER_IO_STEPS} steps (the warm's capture in the "
              f"first); on {card}")

        # the same steps on a bare Executor warmed on the same program from
        # the state the Trainer started from
        exe = fluid.Executor()
        scope = fluid.Scope()
        for n, v in init.items():
            if n != "@counter":
                scope.set_var(n, v)
        scope.step_counter = init["@counter"]
        feeder = fluid.DataFeeder([toks, labs])
        feeds = [feeder.feed(b) for b in batches]
        exe.warm(tr.program, feed_sig(feeds[0]), [loss], scope=scope)
        bare = [float(exe.run(tr.program, feed=f, fetch_list=[loss],
                              scope=scope)[0]) for f in feeds]
        check(np.array(bare, np.float32).tobytes()
              == np.array(losses, np.float32).tobytes(),
              f"trainer_io: Trainer losses {losses} are not the bare "
              f"Executor's {bare}")
        print(f"trainer_io lm: {TRAINER_IO_STEPS} Trainer steps on "
              f"{len(batches[0])} x {LM_CFG['max_len']} tokens in "
              f"{secs:.2f} s (warm and checkpoints {steps} included), losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}, bitwise the bare "
              f"warmed Executor's; flash launches {launches}; on {card}")
        rec["lm"] = {"losses": losses, "seconds": secs,
                     "launches": launches, "checkpoints": steps}
        del exe, scope, init
        rec["artifacts"] = _trainer_io_artifacts(tr, toks, logits)
        # the LM-logits artifact, merged, for the obs phase's Session
        os.makedirs(OBS_DIR, exist_ok=True)
        tio.merge_model(os.path.join(TRAINER_IO_DIR, "lm_artifact"),
                        OBS_LM_ARTIFACT)
        del tr
        _release()

        # (b) a new Trainer from step TRAINER_IO_RESUME's checkpoint alone
        d2 = os.path.join(TRAINER_IO_DIR, "lm_resume")
        os.makedirs(d2)
        src = os.path.join(d1, f"ckpt-{TRAINER_IO_RESUME}")
        shutil.copytree(src, os.path.join(d2, f"ckpt-{TRAINER_IO_RESUME}"))
        with open(os.path.join(d2, "latest"), "w") as f:
            f.write(str(TRAINER_IO_RESUME))
        cur2 = _Cursor(os.path.join(src, "queue.snap"))
        check(cur2.done == TRAINER_IO_RESUME,
              f"trainer_io: the cursor paired with step {TRAINER_IO_RESUME} "
              f"reads {cur2.done}")
        tr2, _, _, _, _ = _lm_trainer(d2, cur2)
        _zero_counters()
        resumed, _, secs2 = _train_lm(tr2, cur2, batches)
        launches2 = _flash_counts()
        tail = losses[TRAINER_IO_RESUME:]
        check(np.array(resumed, np.float32).tobytes()
              == np.array(tail, np.float32).tobytes()
              and tr2.global_step == TRAINER_IO_STEPS,
              f"trainer_io: resumed losses {resumed}, the first run's {tail}")
        want2 = n_layers * (TRAINER_IO_STEPS - TRAINER_IO_RESUME + 1)
        check(all(launches2[k] == want2 for k in FLASH_KERNELS),
              f"trainer_io: resumed flash launches {launches2}, want {want2}")
        print(f"trainer_io resume: a new Trainer from ckpt-"
              f"{TRAINER_IO_RESUME} and its queue cursor ran steps "
              f"{TRAINER_IO_RESUME + 1}-{TRAINER_IO_STEPS} in {secs2:.2f} s, "
              f"losses bitwise the first run's; flash launches {launches2}")
        rec["resume"] = {"losses": resumed, "seconds": secs2,
                         "launches": launches2}
        del tr2
        _release()
        rec["anomaly"] = _trainer_io_anomaly(card)
    finally:
        del os.environ["PADDLE_TPU_POSTMORTEM_DIR"]
        shutil.rmtree(TRAINER_IO_DIR, ignore_errors=True)
    return rec


# the obs phase (PERF.md section 6): its trace directory, and the
# merged LM-logits artifact the trainer_io phase leaves for its Session
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_obs")
OBS_LM_ARTIFACT = os.path.join(OBS_DIR, "lm_logits.tar")
OBS_THREADS, OBS_REQUESTS = 8, 32
OBS_PROFILED_STEPS = 3


def _stats_delta(before: dict, after: dict) -> dict:
    """Per timing key: (samples, summed sampled ms) added between two
    ``obs.prof.stats_snapshot()`` reads."""
    out = {}
    for k, a in after.items():
        b = before.get(k, {"samples": 0, "mean_ms": 0.0})
        n = a["samples"] - b["samples"]
        if n:
            out[k] = (n, a["mean_ms"] * a["samples"]
                      - b["mean_ms"] * b["samples"])
    return out


def _obs_pass(label: str, eng, trace: bool, every, card: str) -> dict:
    """The serve phase's mixed stream once more on its warmed engine, with
    tracing ``trace`` and sampling every ``every``-th dispatch (None: the
    default period): the metrics are set to 0 just before and read just
    after, and must equal the scheduler's own tallies; every dispatch a
    replay, n_layers paged launches a step dispatch, no capture."""
    from paddle_tpu_torch import obs

    reqs = _mixed_reqs(np.random.RandomState(1))
    traces = eng.trace_count()
    obs.metrics.reset()
    obs.trace.clear()
    if trace:
        obs.trace.enable()
    else:
        obs.trace.disable()
    obs.prof.set_sample_every(every)
    before = obs.prof.stats_snapshot()
    handles, sched, wall, launches, dispatches = _serve(eng, reqs, False)
    stats = _stats_delta(before, obs.prof.stats_snapshot())
    spans = collections.Counter(e["name"] for e in obs.trace.events())
    obs.trace.disable()
    obs.prof.set_sample_every(None)
    _check_pass(f"obs {label}", eng, handles, sched, launches, dispatches)
    check(eng.trace_count() == traces,
          f"obs {label}: {eng.trace_count() - traces} captures")
    c = obs.metrics.snapshot()["counters"]
    want = {"serving.decode.prefill_inserts": "prefill_inserts",
            "serving.decode.retired": "retired",
            "serving.decode.preemptions": "preemptions",
            "serving.decode.sheds": "sheds",
            "serving.sample.requests": "sampled"}
    got = {k: c.get(k, 0) for k in want}
    check(got == {k: sched.counters[v] for k, v in want.items()}
          and got["serving.decode.retired"] == len(reqs)
          and c.get("serving.decode_traces", 0) == 0,
          f"obs {label}: counters {got} against the scheduler's "
          f"{sched.counters}")
    n_step = sum(dispatches.values())
    n_prefill = sum(eng.prefill_dispatches.values())
    sampled = {k: n for k, (n, _) in stats.items()}
    if every == 1:
        steps = {k: n for k, n in sampled.items()
                 if k.startswith("decode_step:")}
        check(sum(steps.values()) == n_step
              and sum(sampled.values()) == n_step + n_prefill,
              f"obs {label}: sampled {sampled}, dispatches {n_step} steps "
              f"+ {n_prefill} prefills")
    if every == 0:
        check(not sampled, f"obs {label}: sampling off timed {sampled}")
    if trace:
        check(spans["serving.decode.prefill_insert"]
              == sched.counters["prefill_inserts"]
              and 0 < spans["serving.decode.step"] <= sched.counters["steps"],
              f"obs {label}: spans {dict(spans)}")
        if every == 1:
            check(spans["obs.prof.sample"] == n_step + n_prefill,
                  f"obs {label}: {spans['obs.prof.sample']} sample spans")
    tokens = sum(len(h.tokens) for h in handles)
    w1 = stats.get(f"decode_step:{eng._sig_scope}:w1")
    rec = {"tokens": tokens, "seconds": wall, "tok_s": tokens / wall,
           "launches": launches, "step_dispatches": n_step,
           "prefill_dispatches": n_prefill, "samples": sum(sampled.values()),
           "w1_sampled_mean_ms": w1[1] / w1[0] if w1 else None,
           "spans": sum(spans.values())}
    print(f"obs {label}: {tokens} tokens in {wall:.3f} s = "
          f"{rec['tok_s']:.1f} tok/s; {launches} paged launches = "
          f"{eng.model.n_layers} x {n_step} step dispatches, every dispatch "
          f"a replay, no capture; counters {got} equal the scheduler's; "
          f"{rec['samples']} sampled dispatches"
          + (f", sampled W=1 step mean {rec['w1_sampled_mean_ms']:.3f} ms"
             if w1 else "") + f", {rec['spans']} spans; on {card}")
    return rec


def _obs_profiled_steps(eng, card: str) -> dict:
    """(c): ``profiler.profiler()`` with PADDLE_TPU_TRACE_DIR set around
    OBS_PROFILED_STEPS decode steps of the warmed engine: the
    reference-named trace exists, holds the paged kernel's CUDA events,
    and merges with the host spans."""
    from paddle_tpu_torch import ContinuousScheduler, obs, profiler

    rng = np.random.RandomState(5)
    sched = ContinuousScheduler(eng)
    for _ in range(2):
        sched.submit(rng.randint(2, LM_CFG["vocab_size"], 40)
                     .astype(np.int32), 16)
    sched.step()                       # the joins' prefills
    os.environ["PADDLE_TPU_TRACE_DIR"] = OBS_DIR
    obs.trace.enable()
    try:
        with profiler.profiler(label="chip_smoke") as info:
            for _ in range(OBS_PROFILED_STEPS):
                sched.step()
            torch.cuda.synchronize()
        host = obs.trace.export_to_dir(label="chip_smoke")
    finally:
        obs.trace.disable()
        del os.environ["PADDLE_TPU_TRACE_DIR"]
    sched.run_until_idle()
    sched.close()
    want = os.path.join(OBS_DIR, f"trace-xprof-chip_smoke-{os.getpid()}.json")
    check(info["fleet_trace"] == want and os.path.exists(want),
          f"obs profiler: no {want} ({info})")
    with open(want) as f:
        evs = json.load(f)["traceEvents"]
    paged = [e for e in evs if e.get("cat") == "kernel"
             and "paged" in str(e.get("name", ""))]
    check(len(paged) > 0, f"obs profiler: no paged kernel among "
          f"{sum(e.get('cat') == 'kernel' for e in evs)} kernel events")
    merged = obs.trace.merge_chrome_traces([want, host])
    names = collections.Counter(e.get("name") for e in merged["traceEvents"])
    check(len(merged["mergedFrom"]) == 2
          and names["serving.decode.step"] == OBS_PROFILED_STEPS,
          f"obs profiler: merged {merged['mergedFrom']}, "
          f"{names['serving.decode.step']} step spans")
    print(f"obs profiler: {OBS_PROFILED_STEPS} decode steps under "
          f"profiler.profiler(): {os.path.basename(want)} holds "
          f"{len(paged)} paged kernel events; merged with the host spans "
          f"({len(merged['traceEvents'])} events from "
          f"{merged['mergedFrom']}); on {card}")
    return {"paged_kernel_events": len(paged),
            "merged_events": len(merged["traceEvents"])}


def phase_obs_serve(card: str, eng) -> dict:
    """The obs phase's serving half on the serve phase's warmed engine: (a)
    its mixed stream with tracing on and every dispatch sampled, with
    tracing and the default sampling, and with everything off; the cost
    ledger's entry for every prepared signature; the hotspots; (c) the
    profiler bracket."""
    import shutil

    from paddle_tpu_torch import obs

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)
    ledger = obs.prof.ledger().by_sig_key()
    keys = {s.prof_key for s in eng._sigs.values()}
    bad = {k: ledger.get(k) for k in keys
           if not (ledger.get(k, {}).get("flops", 0) > 0
                   and ledger.get(k, {}).get("bytes_accessed", 0) > 0)}
    check(not bad and len(keys) == eng.trace_count(),
          f"obs: prepared signatures without a ledger entry: {bad}")
    rec = {"traced_sampled": _obs_pass("traced, every dispatch sampled",
                                       eng, True, 1, card),
           "traced_default": _obs_pass("traced, default sampling", eng,
                                       True, None, card),
           "off": _obs_pass("tracing and sampling off", eng, False, 0,
                            card)}
    hot = obs.prof.hotspots(top=3)
    print(f"obs ledger: {len(keys)} prepared signatures, each with flops "
          f"and bytes: " + "; ".join(
              f"{k} {ledger[k]['flops']:.4g} flops {ledger[k]['bytes_accessed']:.4g} B"
              for k in sorted(keys)))
    print("obs hotspots: " + obs.prof.render_hotspots(hot).replace(
        "\n", " | "))
    print(f"obs cost: traced + default sampling "
          f"{rec['traced_default']['tok_s']:.1f} tok/s, traced + every "
          f"dispatch sampled {rec['traced_sampled']['tok_s']:.1f} tok/s, "
          f"everything off {rec['off']['tok_s']:.1f} tok/s; on {card}")
    rec["hotspots"] = hot["rows"]
    rec["profiler"] = _obs_profiled_steps(eng, card)
    return rec


def _run_all(threads, limit_s: float = 300.0) -> None:
    """Start ``threads`` and join them all within ``limit_s`` together."""
    for t in threads:
        t.start()
    end = time.monotonic() + limit_s
    for t in threads:
        t.join(max(end - time.monotonic(), 0.0))


def _obs_session(card: str) -> dict:
    """(b): a batching Session (max_batch_size=8) over the trainer_io
    phase's LM-logits artifact; OBS_REQUESTS one-row requests from
    OBS_THREADS threads, each row within the float32 limits of the same
    request's unbatched call; no capture after warm; healthz carrying
    metrics, batching stats and hotspots; flash forward launches counted.
    Then C.15 on the card: OBS_THREADS threads on one InferenceModel, each
    call bitwise its thread's solo result at one bucket."""
    import threading

    from paddle_tpu_torch import capi_server, obs
    from paddle_tpu_torch.ops import flash_attention

    n_layers = LM_CFG["n_layers"]
    plain = capi_server.Session(OBS_LM_ARTIFACT)
    rng = np.random.RandomState(29)
    feeds = [rng.randint(0, LM_CFG["vocab_size"], (1, LM_CFG["max_len"]))
             .astype(np.int32) for _ in range(OBS_REQUESTS)]
    wants = []
    for f in feeds:
        plain.feed("toks", f.tobytes(), "int32", list(f.shape))
        plain.run()
        buf, dt, shape = plain.output(0)
        wants.append(np.frombuffer(buf, dt).reshape(shape).copy())
    del plain
    _release()
    sess = capi_server.Session(OBS_LM_ARTIFACT)
    t0 = time.perf_counter()
    sess.enable_batching(max_batch_size=8, max_queue_delay_ms=5.0)
    warm_s = time.perf_counter() - t0
    batcher = sess._state.batcher
    traces = sess._infer.trace_count()
    check(traces == len(batcher.buckets),
          f"obs session: {traces} signatures warmed for {batcher.buckets}")
    obs.prof.set_sample_every(1)
    fwd0 = flash_attention.launches["fwd"]
    errs, worst = [], [0.0]
    lock = threading.Lock()

    def client(t):
        c = sess.clone()
        for i in range(t, OBS_REQUESTS, OBS_THREADS):
            try:
                c.feed("toks", feeds[i].tobytes(), "int32",
                       list(feeds[i].shape))
                c.run()
                buf, dt, shape = c.output(0)
                d = _close_f32(f"obs session request {i}",
                               np.frombuffer(buf, dt).reshape(shape),
                               wants[i])
                with lock:
                    worst[0] = max(worst[0], d)
            except BaseException as e:  # noqa: BLE001 — reported below
                errs.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(t,), daemon=True)
          for t in range(OBS_THREADS)]
    _run_all(ts)
    wall = time.perf_counter() - t0
    obs.prof.set_sample_every(None)
    check(not errs and not any(t.is_alive() for t in ts),
          f"obs session: client errors {errs[:2]}")
    torch.cuda.synchronize()
    stats = batcher.stats()
    launches = flash_attention.launches["fwd"] - fwd0
    hz = sess.healthz()
    check(sess._infer.trace_count() == traces,
          f"obs session: {sess._infer.trace_count() - traces} captures after "
          f"warm")
    check(launches == n_layers * stats["batches"],
          f"obs session: {launches} flash forward launches for "
          f"{stats['batches']} batches x {n_layers} layers")
    check(hz["batching"]["batched_requests"] == OBS_REQUESTS
          and hz["metrics"]["counters"].get("serving.batches", 0)
          >= stats["batches"] and hz["hotspots"]["rows"]
          and hz["requests"] == OBS_REQUESTS and hz["errors"] == 0,
          f"obs session: healthz {dict(hz, metrics='...')}")
    batcher.close()

    # C.15 on the card: one model, OBS_THREADS threads, one bucket
    infer = sess._infer
    xs = [rng.randint(0, LM_CFG["vocab_size"], (2, LM_CFG["max_len"]))
          .astype(np.int32) for _ in range(OBS_THREADS)]
    solo = [infer({"toks": x})[0] for x in xs]
    wrong = [0] * OBS_THREADS

    def caller(t):
        for _ in range(3):
            if infer({"toks": xs[t]})[0].tobytes() != solo[t].tobytes():
                wrong[t] += 1

    ts = [threading.Thread(target=caller, args=(t,), daemon=True)
          for t in range(OBS_THREADS)]
    _run_all(ts)
    check(not any(t.is_alive() for t in ts) and wrong == [0] * OBS_THREADS,
          f"obs C.15: calls that were not the caller's own: {wrong}")
    print(f"obs session: {OBS_REQUESTS} one-row requests from {OBS_THREADS} "
          f"threads in {wall:.2f} s through a batching Session (warm "
          f"{warm_s:.2f} s, buckets {batcher.buckets}): {stats['batches']} "
          f"batches, {stats['avg_requests_per_batch']:.2f} requests a batch, "
          f"max |d| {worst[0]:.3e} against each request's unbatched call; "
          f"no capture after warm; {launches} flash forward launches = "
          f"{n_layers} x batches; healthz {sorted(hz)}; C.15: "
          f"{OBS_THREADS} threads x 3 calls on one model, each bitwise its "
          f"own solo result; on {card}")
    return {"batches": stats["batches"], "seconds": wall, "warm_s": warm_s,
            "max_abs_err": worst[0], "flash_fwd_launches": launches}


def phase_obs_session(card: str) -> dict:
    """The obs phase's Session half, on the artifact trainer_io merged;
    the obs directory is removed at its end."""
    import shutil

    try:
        return _obs_session(card)
    finally:
        shutil.rmtree(OBS_DIR, ignore_errors=True)


def _par_launches(par: dict, which: str, kern: str) -> dict:
    """The parallel phase's launches of one kernel, by leg and rank."""
    return {f"parallel {label} rank {i}": counts[kern]
            for label, rec in par["legs"].items()
            for i, counts in enumerate(rec[which]) if counts[kern]}


def _timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = _timed("device", phase_device)
    _timed("build", phase_build)
    rec = _timed("kernels", phase_kernels, card)
    flash = _timed("flash kernels", phase_flash_kernels, card)
    lstm, lstm_srl = _timed("lstm kernels", phase_lstm_kernels, card)
    custom_ops = _timed("custom ops", phase_custom_ops, card)
    drop = _timed("dropout kernels", phase_dropout_kernels, card)
    paths, serve_eng = _timed("serve", phase_serve, card)
    paths.update(_timed("serve extras", phase_serve_extras, card, serve_eng))
    obs_serve = _timed("obs serve", phase_obs_serve, card, serve_eng)
    del serve_eng
    _release()
    train = _timed("train", phase_train, card)
    _release()
    lm_amp = _timed("lm amp train", phase_lm_amp_train, card,
                    train["cpu_parity"], train["card_parity"])
    _release()
    lm_drop = _timed("lm dropout train", phase_lm_dropout_train, card)
    _release()
    _timed("optimizers", phase_optimizers, card)
    _release()
    lstm_train = _timed("lstm train", phase_lstm_train, card)
    _release()
    _timed("seq2seq train", phase_seq2seq_train, card)
    _release()
    _timed("seq2seq beam", phase_seq2seq_beam, card)
    _release()
    srl = _timed("srl", phase_srl, card)
    _release()
    _timed("sequence ops", phase_sequence_ops, card)
    _timed("hier_text", phase_hier_text, card)
    _release()
    _timed("control flow", phase_control_flow, card)
    _release()
    bn = _timed("bn kernels", phase_bn_kernels, card)
    resnet = _timed("resnet train", phase_resnet_train, card)
    convk = _timed("conv kernels", phase_conv_kernels, card)
    infer = _timed("resnet infer", phase_resnet_infer, card)
    _release()
    image = _timed("image", phase_image, card)
    _release()
    ocr = _timed("ocr_ctc", phase_ocr, card)
    _release()
    nets = _timed("nets", phase_nets, card)
    _release()
    fcn = _timed("fcn", phase_fcn, card)
    _release()
    ssd = _timed("ssd", phase_ssd, card)
    _release()
    _timed("layers", phase_layers, card)
    _release()
    _timed("families", phase_families, card)
    _release()
    _timed("ctr", phase_ctr, card)
    _release()
    _timed("sparse", phase_sparse, card)
    _release()
    tio = _timed("trainer_io", phase_trainer_io, card)
    _release()
    obs_sess = _timed("obs session", phase_obs_session, card)
    _release()
    par = _timed("parallel", phase_parallel, card)
    _release()
    # the C.2 probe runs where earlier runs took it, after the parallel
    # phase; the mesh phase after it profiles nothing
    probe_end = paged_probe()
    mesh = _timed("mesh", phase_mesh, card)
    _release()
    start = rec["c2_probe_start_device_ms"]
    print(f"C.2 probe: paged_attention float32 W=1 device "
          f"{_ms_or_none(start)} at the start of the kernels phase, "
          f"{_ms_or_none(probe_end)} after the parallel phase (end / start "
          f"{probe_end / start if start and probe_end else None}; a record, "
          f"not a check); profiler windows that read no device time or came "
          f"short and were re-measured: {len(empty_windows)}; on {card}")
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:60",
        "case": "float32 arena, W=1, S=8 H=8 Dh=64 Bs=16 n_tbl=64",
        # launches: the W=1 main path's (mixed pass) own count; each path's
        # count, taken over its own pass alone, is in launches_by_path
        "launches": paths["w1_mixed_pass"]["launches"], **rec,
        "c2_probe_end_device_ms": probe_end,
        "c2_empty_profiler_windows": len(empty_windows),
        "launches_by_path": dict(paths, **{
            f"obs {k}": r["launches"] for k, r in obs_serve.items()
            if k in ("traced_sampled", "traced_default", "off")}, **{
            f"mesh {m} rank {i}": n for m in SERVE_MESHES
            for i, n in enumerate(mesh[f"serve {m}"]["paged"])}, **{
            f"mesh {A9_SERVE_MESH} int8 rank {i}": n
            for i, n in enumerate(mesh["a9 serve int8"]["paged"])}),
    }]
    replaces = {"fwd": "paddle_tpu/ops/attention.py:39",
                "bwd_dkdv": "paddle_tpu/ops/attention.py:223",
                "bwd_dq": "paddle_tpu/ops/attention.py:268"}
    for kern in FLASH_KERNELS:
        kernels.append({
            "name": f"flash_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[kern],
            "case": "float32, N=B*H=64, T=1024, D=64, causal",
            # launches: the training pass's own count (5 steps x 6 layers);
            # the nets phase's scaled_dot_product_attention step in
            # launches_by_path
            "launches": train["launches"][kern], **flash["float32"][kern],
            "launches_by_path": {"train": train["launches"][kern],
                                 "nets sdpa step": nets["sdpa"][kern],
                                 "trainer_io lm": tio["lm"]["launches"][kern],
                                 "trainer_io resume":
                                     tio["resume"]["launches"][kern],
                                 **({"obs session": obs_sess[
                                     "flash_fwd_launches"]}
                                    if kern == "fwd" else {}),
                                 **_par_launches(par, "flash", kern)},
            # the forward as the custom op paddle_tpu_torch::flash_fwd
            # against the wrapper called directly, in turns; an artifact
            # replay's launches
            **({"custom_op": custom_ops["flash_fwd"],
                "artifact_launches_per_call":
                    tio["artifacts"]["lm"]["launches_per_call"]}
               if kern == "fwd" else {}),
        })
    for kern in FLASH_KERNELS:
        kernels.append({
            "name": f"flash_{kern}_bf16", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[kern],
            "case": "bfloat16, N=B*H=64, T=1024, D=64, causal",
            # launches: the lm amp training pass's own bf16 count (5 steps
            # x 6 layers)
            "launches": lm_amp["launches"][kern], **flash["bfloat16"][kern],
        })
    replaces = {"fwd": "paddle_tpu/ops/lstm.py:35",
                "bwd": "paddle_tpu/ops/lstm.py:153"}
    for kern in LSTM_KERNELS:
        kernels.append({
            "name": f"fused_lstm_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/lstm.cu",
            "replaces": replaces[kern],
            "case": ("float32, T=100, B=128, H=512, no peepholes, lengths "
                     "50-100" + ("" if kern == "fwd" else
                                 "; the whole backward: reverse-recurrence "
                                 "kernel, du matmul, peephole sums")),
            # launches: the lstm training pass's own count (5 steps x 2
            # layers), one call per layer per step, each call one device
            # launch on the persistent route; the pass's calls by route;
            # the warmed pass's, counted at replay, in launches_by_path
            "launches": lstm_train["launches"][kern], **lstm[kern],
            "route_launches": lstm_train["route_launches"],
            "launches_by_path": {
                "lstm train": lstm_train["launches"][kern],
                "lstm train warmed": lstm_train["warmed_launches"][kern],
                "srl train warmed": srl["launches"][kern],
                "srl decode warmed": srl["decode_launches"][kern],
                "nets bidirectional_lstm step":
                    nets["bidirectional_lstm"][kern]},
            # the inference forward as the custom op
            # paddle_tpu_torch::lstm_fwd against the wrapper, in turns
            **({"custom_op": custom_ops["fused_lstm_fwd"],
                "artifact_launches_per_call":
                    tio["artifacts"]["text_lstm"]["launches_per_call"]}
               if kern == "fwd" else {}),
            # the SRL layer shape: T=32, B=64, H=128, peepholes, lengths
            # 1-32, persistent route (PERF.md section 6 rows 5 and 5b)
            "srl_h128": lstm_srl[kern],
        })
    replaces = {"reduce": "benchmark/bn_probe.py:84",
                "dx": "benchmark/bn_probe.py:126"}
    for kern in BN_KERNELS:
        kernels.append({
            "name": f"bn_bwd_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/batch_norm.cu",
            "replaces": replaces[kern],
            "case": "bfloat16 (the probe's and amp's), N=256, C=256, 56x56",
            # launches: the amp arm's own count (bench.py's recipe, 53
            # batch norms x 5 steps); each arm's in launches_by_path
            "launches": resnet["amp"]["launches"][kern],
            **bn["bfloat16"][kern],
            "launches_by_path": dict(
                {a: r["launches"][kern] for a, r in resnet.items()},
                **{"nets img_conv_group step":
                   nets["img_conv_group_train"][kern]},
                **{a: r["bn_launches"][kern]
                   for a, r in ssd["train"].items()},
                **{f"{a} warmed": r["warmed_bn_launches"][kern]
                   for a, r in ssd["train"].items()},
                **{f"mesh c13 conv_bn dp 2 rank {i}": b[kern]
                   for i, b in enumerate(mesh["c13 conv_bn"]["bn"])}),
            "float32": bn["float32"][kern],
        })
    replaces = {"igemm": "benchmark/conv_probe.py:62",
                "fused": "benchmark/conv_probe.py:68"}
    routed = {**fcn["infer"], **ssd["detect"]}
    main_arm = {"igemm": "resnet18-infer amp", "fused": "resnet50-infer amp"}
    for kern in CONV_KERNELS:
        kernels.append({
            "name": "conv_igemm" if kern == "igemm" else "conv_igemm_fused",
            "route": "cuda", "source": "paddle_tpu_torch/ops/csrc/conv.cu",
            "replaces": replaces[kern],
            "case": "bfloat16 (amp's), N=256, 56x56, C=O=64 (the probe's "
                    "c56)",
            # launches: the main arm's own count (resnet18-infer for the
            # plain kernel, resnet50-infer amp for the fused one); each
            # arm's in launches_by_path
            "launches": infer[main_arm[kern]]["launches"][kern],
            **convk["bfloat16"]["c56"][kern],
            "launches_by_path": dict(
                {a: r["launches"][kern]
                 for a, r in {**infer, **image["infer"], **routed}.items()},
                **{"ocr_ctc decode replay":
                   ocr["decode_conv_launches"][kern],
                   "nets img_conv_group pruned":
                   nets["img_conv_group_infer"][kern]}),
            "route_launches_by_path": dict(
                {a: r["route_launches"]
                 for a, r in {**infer, **image["infer"], **routed}.items()},
                **{"ocr_ctc decode replay":
                   ocr["decode_conv_route_launches"],
                   "nets img_conv_group pruned":
                   nets["img_conv_group_infer_routes"]}),
            "c28": convk["bfloat16"]["c28"][kern],
            "c14": convk["bfloat16"]["c14"][kern],
            "c7": convk["bfloat16"]["c7"][kern],
            # float32 on the halo_f32 route (each record's conv_route)
            "float32": convk["float32"]["c56"][kern],
            "float32_c28": convk["float32"]["c28"][kern],
            "float32_c14": convk["float32"]["c14"][kern],
            "float32_c7": convk["float32"]["c7"][kern],
            # the slice's new shapes (the plain kernel on the image and
            # ocr_ctc inference paths), by dtype and label
            **({"model_shapes": {f"{dt} {label}": recs["igemm"]
                                 for dt, by in convk.items()
                                 for label, recs in by.items()
                                 if label not in CONV_RESNET}}
               if kern == "igemm" else {}),
        })
    # the gather route's kernel (igemm_kernel) on its own: the main path's
    # case is FCN inference's stem, float32; launches are the fcn-infer
    # float32 arm's gather-route calls; each model shape under its dtype and
    # label, the fused form at CONV_GATHER_FUSED
    kernels.append({
        "name": "conv_gather", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/conv.cu",
        "replaces": replaces["igemm"],
        "case": "float32, FCN's stem [32,256,256,3]x16, on the gather route "
                "(igemm_kernel)",
        "launches": fcn["infer"]["fcn-infer float32"]["route_launches"][
            "gather"],
        **convk["float32"]["fcn c256"]["igemm"],
        "gather_launches_by_path": dict(
            {a: r["route_launches"]["gather"]
             for a, r in {**infer, **image["infer"], **routed}.items()},
            **{"ocr_ctc decode replay":
               ocr["decode_conv_route_launches"]["gather"]}),
        "fused": {f"{dt} {label}": by[label]["fused"]
                  for dt, by in convk.items() for label in CONV_GATHER_FUSED
                  if label in by},
    })
    # the float32 fused kernel, on the main path of ResNet-50 float32
    # inference
    kernels.append({
        "name": "conv_igemm_fused_f32", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/conv.cu",
        "replaces": replaces["fused"],
        "case": "float32, N=256, 56x56, C=O=64 (the probe's c56), on the "
                "halo_f32 route (three TF32 wgmma passes)",
        # launches: the resnet50-infer float32 arm's own count
        "launches": infer["resnet50-infer float32"]["launches"]["fused"],
        **convk["float32"]["c56"]["fused"],
        "route_launches": infer["resnet50-infer float32"]["route_launches"],
        # the c56 conv + BN + ReLU artifact, through the custom op
        # paddle_tpu_torch::conv_igemm_fused
        "trainer_io_artifact_route_launches":
            tio["artifacts"]["conv"]["route_launches"],
        "c28": convk["float32"]["c28"]["fused"],
        "c14": convk["float32"]["c14"]["fused"],
        "c7": convk["float32"]["c7"]["fused"],
    })
    for kern in DROPOUT_KERNELS:
        kernels.append({
            "name": f"dropout_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/dropout.cu",
            "replaces": "paddle_tpu/layers/nn.py:458 (jax.random.bernoulli; "
                        "XLA-fused on the TPU, no Pallas kernel)",
            "case": "float32, [8, 1024, 512], p=0.1",
            # launches: the main path's own count, the float32 + remat arm
            # of the lm dropout train phase (5 steps); each arm's in
            # launches_by_path
            "launches": lm_drop["float32 remat"]["launches"][kern],
            **drop["float32"][kern],
            "launches_by_path": dict(
                {a: r["launches"][kern] for a, r in lm_drop.items()},
                **{f"image {a}": r["dropout_launches"][kern]
                   for a, r in image["train"].items()},
                **_par_launches(par, "dropout", kern),
                **{f"mesh dp 2 x tp 2 rank {i}": d[kern] for i, d in
                   enumerate(mesh["a9 dp2 tp2 extras"]["dropout_launches"])}),
            "bfloat16": drop["bfloat16"][kern],
            "mapped_ms": {k: {"mapped": v[0], "unmapped": v[1],
                              "slice": list(v[2])}
                          for k, v in par["dropout_map_ms"].items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
