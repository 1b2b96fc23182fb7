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
               matched.
Each phase prints its seconds.  The line before the card line is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
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


def device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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
    no device time in any of them: there is no fallback to the events."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools.decode_profile import _kernel_us

    for attempt in range(EMPTY_WINDOW_RETRIES + 1):
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for i in range(iters):
                fn(i)
            for _ in range(64):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
        # microseconds a call: each kernel's mean times its launches a call
        us = sum(_kernel_us(evt) / evt.count * round(evt.count / iters)
                 for evt in prof.key_averages()
                 if _kernel_us(evt) > 0 and "spin_kernel" not in evt.key)
        if us > 0:
            return us / 1e3
        empty_windows.append(attempt)
        held = {evt.key[:40]: evt.count for evt in prof.key_averages()
                if _kernel_us(evt) > 0}
        print(f"device_ms: a profiler window read no device time (attempt "
              f"{attempt + 1}; {len(empty_windows)} in this run so far; "
              f"kernel records it held, of {iters} calls: {held})",
              flush=True)
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


def paged_probe() -> float:
    """Device ms a call of the paged kernel at the float32 W=1 shape (one
    fixed draw), timed by ``device_ms``: at the start of the kernels phase
    and again at the end of the script, in one process, to see whether
    torch.profiler's windows keep their records over a long process
    (ROADMAP C.2).  A record, not a check."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    q, kp, vp, tables, lengths = _kernel_inputs(
        "float32", 1, torch.device("cuda"), np.random.RandomState(7))
    qq, ll = q[:, 0], lengths[:, 0]
    return device_ms(lambda i: paged_attention(qq, kp, vp, i % KL, tables,
                                               ll))


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
          f"W=1 device {probe:.4f} ms on {card}")
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


def phase_serve(card: str) -> dict:
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
    sampled_idx = {1, 5, 9, 13}
    reqs = []
    for i in range(16):
        p = rng.randint(2, V, rng.randint(16, 513)).astype(np.int32)
        g = int(rng.randint(32, 65))
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=1000 + i)
              if i in sampled_idx else greedy)
        reqs.append((p, g, sp))
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
    drop = _timed("dropout kernels", phase_dropout_kernels, card)
    paths = _timed("serve", phase_serve, card)
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
    probe_end = paged_probe()
    print(f"C.2 probe: paged_attention float32 W=1 device "
          f"{rec['c2_probe_start_device_ms']:.4f} ms at the start of the "
          f"kernels phase, {probe_end:.4f} ms at the end of the script "
          f"(end / start {probe_end / rec['c2_probe_start_device_ms']:.4f}; "
          f"a record, not a check); profiler windows that read no device "
          f"time and were re-measured: {len(empty_windows)}; on {card}")
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
        "launches_by_path": paths,
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
                                 "nets sdpa step": nets["sdpa"][kern]},
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
                   for a, r in ssd["train"].items()}),
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
                   for a, r in image["train"].items()}),
            "bfloat16": drop["bfloat16"][kern],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
