"""Where the time of one training step goes, on the CUDA card.

    python3 -m paddle_tpu_torch.tools.train_profile [--model lm|text_lstm|seq2seq|seq2seq-beam|srl|srl-decode|hier_text|hier_text-infer|ocr_ctc|ocr_ctc-decode|fcn|fcn-infer|ssd|ssd-detect|resnet50|resnet50-infer|resnet18-infer|vgg19|alexnet|googlenet|<those>-infer] [--dropout P] [--remat] [--eager] [--out F]

``--model lm`` (the default) builds the Transformer-base LM (V=32000,
T=1024, d=512, 8 heads, 6 layers, d_ff=2048, tied, float32, weights
``init_lm_params(0)``) with ``build_lm``, Adam(1e-3) and global-norm
clipping (1.0), on a fixed 8 x 1024 batch, in two arms: float32, then amp
(``amp.enable`` with the default bf16 list plus attention, so the bf16
flash kernels run); each arm ``Executor.warm``s its signature first, so
every profiled step is a replay of one CUDA graph.  ``--dropout P`` and
``--remat`` are ``build_lm``'s arguments; with dropout the optimizer is
Transformer-base's (Adam(0.9, 0.98, 1e-9) on ``noam_decay(512, 4000)``,
clip 1.0), resumed at the optimizer step 4000, the peak of warm-up.
``--model text_lstm`` builds the LSTM text classifier at the width of
``benchmark/text_lstm.py`` (vocab
10000, emb 128, 2 x LSTM-512, 2 classes, seq_len 100, float32, weights
``init_text_lstm_params(0)``) with Adam(1e-3), on a fixed batch of 128
sequences with lengths drawn from [50, 100] (that file's
``synthetic_feed``).  ``--model seq2seq`` builds ``models.seq2seq.
train_net`` at its own widths (emb 256, hidden 512) with the 30000-word
WMT14 dictionary on each side, Adam(1e-3) and clip 1.0, on 64 sentence
pairs padded to 50 tokens (lengths 10-50, numpy seed 0), weights from the
port's startup program on the CPU (seed 0); ``--model seq2seq-beam`` its
``beam_search_decoder`` (beam 4, max_len 32) on those 64 sources, the
emitted tokens counted as the best hypotheses' lengths.  lm, text_lstm and
both seq2seq models ``Executor.warm`` their signature first, so every
profiled step is a replay of one CUDA graph (``--eager``: op by op); for
seq2seq the device ms by class come from two more eager steps of the same
program on a second scope (a replay has no op ranges): the output
projection and cross-entropy, the GRU recurrences, the attention step, the
optimizer and other, by the op that launched each kernel or, in the
backward, by the forward op whose autograd node launched it; for the beam
decode the encoder (by op), and inside the beam op by kernel name the
beam selection (top_k), matmul, softmax and other.  ``--model srl``
builds the Paddle book's label_semantic_roles model (``models.srl.db_lstm``
at word_dim 32, mark_dim 5, hidden 128, depth 8, the conll05 dictionaries)
with the chapter's SGD on ``exponential_decay(0.01, 100000, 0.5,
staircase=True)``, on 64 sentences of ``datasets.conll05.train()`` padded
to 32 tokens, weights from the port's startup program on the CPU (seed 0);
``--model srl-decode`` the same program pruned to the Viterbi tags, on
the same sentences; both warmed, tokens counted as the sum of lengths;
their device ms by class, from two more eager steps as for seq2seq: the
LSTMs (the kernels by name, the rest of ``dynamic_lstm`` by origin), the
CRF's forward algorithm and gold path (``linear_chain_crf``), Viterbi
(``crf_decoding``), matmul (the fc ops), embedding, optimizer and other.
``--model hier_text`` builds the nested-sequence document classifier
(``models.hier_text.build`` at its defaults: emb 64, word GRU 64,
sentence RNN 64, 2 classes) over IMDB's 5147-word dictionary with
Adam(3e-3), on 64 documents padded to 8 sentences of 32 words
(:func:`hier_text_batch`, numpy seed 0), weights from the port's startup
program on the CPU (seed 0); ``--model hier_text-infer`` the program
pruned to the prediction, on the same documents; both warmed, tokens
counted as the sum of ``sub_len`` (documents for the inference step);
device ms by class from two more eager steps as for seq2seq: the word GRU
(``dynamic_gru`` and its input projection), the rest of the sentence
step, embedding, matmul (the classifier's fc), optimizer and other.
``--model fcn`` builds the FCN segmenter (``models.fcn.build`` at its
defaults: base 16, 21 classes) with Adam(5e-3) on 32 masks of
``datasets.voc2012``'s synthetic reader at 256 px; ``--model fcn-infer``
the program pruned to the logits, its three 3x3 convs routed onto the
conv kernel.  ``--model ssd`` builds the SSD detector (``models.ssd.build``,
21 classes) at SSD300's 300 px with 16 gt slots and Adam(1e-3), on 32
synthetic one-box images (:func:`ssd_batch`); ``--model ssd-detect`` the
program pruned to ``ssd.infer``'s detections (keep 20), its four 3x3 heads
routed.  Weights from the port's startup program on the CPU (seed 0), the
batch on the card; all four warmed, both arms (amp, then float32), and
their device ms by class from two more eager steps as for seq2seq: cuDNN
convs, bias + ReLU, the routed conv kernels, the transposed conv, the BN
kernels and the BN's plain ops, pooling, layout (transpose, reshape,
concat), loss, metric, decode + NMS, optimizer and other.
``--model resnet50``
builds ResNet-50 as ``bench.py``
trains it (``models.resnet.build``, 1000 classes, Momentum(0.1, 0.9),
weights ``init_resnet_params(0)``) on a fixed batch of 224x224 images that
stays on the card, in two arms: amp (bf16 compute, bs=256) and float32
(TF32 off, bs=``RESNET_FP32_BATCH``).  ``--model resnet50-infer`` and
``--model resnet18-infer`` profile the inference step instead: the
``is_test`` program that ``benchmark/resnet.py``'s infer configs prune to
(``build`` at depth 50 or 18, 1000 classes, ``Program.prune`` to the
prediction), weights ``init_resnet_params(0)`` and running statistics
``init_resnet_stats(0)``, ``INFER_BATCH`` images from ``rand`` of numpy
seed 0 (``benchmark/_common.py``'s draw) that stay on the card, the
prediction fetched each step; ResNet-50 in the amp and the float32 arm,
ResNet-18 under amp; these steps run op by op.  Either way: two warm-up
steps, then,
3 times over, 5 ``Executor.run`` steps on the host clock and 5 more under
``torch.profiler``.  Prints per step: host wall ms (unprofiled windows)
and device busy ms (the sum of kernel times, profiled windows), each as
the median with the least and the most of the repeats, the device idle
share of the medians, device ms by kernel class and the top kernels, both
from the median-busy window.  The classes are flash attention (float32
and bf16 kernels apart) / lstm / matmul / optimizer (the multi-tensor
kernels of the grouped updates and the clip's scaling) / dropout (the
threefry kernels) / other by kernel name; for ResNet they are cuDNN
convolution
(forward, data gradient, weight gradient, other backward), the batch-norm
backward kernels, the batch-norm forward's plain ops, the rest of the
batch-norm backward, pooling, the optimizer and other, by the op or
autograd node that launched each kernel (the profiled windows wrap each op
in a ``record_function`` range; the unprofiled ones run the program as
it is); for the inference step they are the fused conv + BN + ReLU kernel,
the plain implicit-GEMM kernel, the routed ops' filter layout and BN
folding, cuDNN convolution, the batch norms that stay plain ops, pooling
and other.  ``--out`` also writes the numbers as JSON.

The programs, weights and batches are the ones ``chip_smoke.py``'s train
and resnet infer phases run (:func:`build_train_program`,
:func:`build_text_lstm_program`, :func:`build_resnet_program`,
:func:`build_infer_program`, :func:`train_scope`, :func:`train_batch`,
:func:`text_lstm_params`, :func:`text_lstm_batch`, :func:`resnet_params`,
:func:`resnet_batch`, :func:`infer_arrays`, :func:`infer_batch`,
:func:`build_srl_program`, :func:`srl_batch`,
:func:`build_hier_text_program`, :func:`hier_text_batch`), so the profiled
step is the smoke-checked step.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import sys
import time

import numpy as np
import torch

from .decode_profile import LM_CFG, _kernel_us, _spread

TRAIN_BATCH = 8     # sequences of LM_CFG["max_len"] tokens per step
TRAIN_STEPS = 5
REPEATS = 3         # profiled windows, for the median and spread
# benchmark/text_lstm.py at bs=128, hidden_size=512, lstm_num=2
TEXT_LSTM_CFG = dict(vocab_size=10000, emb_dim=128, hidden=512, num_layers=2,
                     class_dim=2)
TEXT_LSTM_SEQ = 100
TEXT_LSTM_BATCH = 128
# bench.py's ResNet-50 recipe: bs=256, Momentum(0.1, 0.9), amp by default
RESNET_CFG = dict(depth=50, class_dim=1000)
RESNET_IMAGE = (3, 224, 224)
RESNET_BATCH = 256
RESNET_FP32_BATCH = 256
# benchmark/resnet.py's infer configs at the bs=256 of its docstring's
# command: model name -> depth
INFER_DEPTH = {"resnet50-infer": 50, "resnet18-infer": 18}
INFER_BATCH = 256
# seq2seq + attention (BASELINE.json configs[2]) at train_net's and
# beam_search_decoder's own widths, with the 30000-word WMT14 dictionary
# of the Paddle book's machine-translation chapter on each side; ids 0, 1
# and 2 are <s>, <e> and <unk> (the reference's wmt14 dictionary layout)
SEQ2SEQ_CFG = dict(src_vocab=30000, tgt_vocab=30000, emb_dim=256,
                   hidden=512)
SEQ2SEQ_LEN = 50              # sentence pairs padded to 50 tokens
SEQ2SEQ_BATCH = 64
SEQ2SEQ_LENGTHS = (10, 50)    # source and target lengths, uniform
SEQ2SEQ_BEAM = dict(bos_id=0, eos_id=1, beam_size=4, max_len=32)
# the Paddle book's label_semantic_roles chapter (fluid/tests/book/
# test_label_semantic_roles.py): word_dim 32, mark_dim 5, depth 8, an fc
# width of 512 = 4 x the LSTM's own width, and the conll05 dictionaries
SRL_CFG = dict(word_dict_len=7477, pred_dict_len=3162, label_dict_len=59,
               word_dim=32, mark_dim=5, hidden_dim=128, depth=8)
SRL_LEN = 32                  # sentences (5-29 tokens) padded to 32
SRL_BATCH = 64
SRL_SLOTS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb", "mark")
# the nested-sequence document classifier (models/hier_text.py) at
# build's defaults, over IMDB's dictionary (paddle_tpu/datasets/imdb.py:15,
# the document corpus the repo carries): 64 documents padded to 8
# sentences of 32 words, drawn by the JAX test's rule
# (tests/test_nested.py:175-186)
HIER_CFG = dict(vocab_size=5147, emb_dim=64, word_hidden=64, sent_hidden=64,
                class_dim=2)
HIER_S, HIER_W = 8, 32
HIER_BATCH = 64
# the image classifiers beyond ResNet as the repo's benchmark configs build
# them (benchmark/vgg.py, alexnet.py, googlenet.py on
# benchmark/_common.py::image_spec): 224x224x3 synthetic NCHW float32
# images and labels from numpy seed 0, 1000 classes, Momentum(0.01, 0.9),
# each config's default batch; model name -> (models module, build
# arguments, batch)
IMAGE_MODELS = {"vgg19": ("vgg", dict(depth=19), 64),
                "alexnet": ("alexnet", {}, 128),
                "googlenet": ("googlenet", {}, 128)}
IMAGE_INFER = {f"{m}-infer": m for m in IMAGE_MODELS}
IMAGE_CLASS_DIM = 1000
# the OCR line recognizer (paddle_tpu/models/ocr_ctc.py) at its own widths
# (8x32 lines, 4 glyphs of 3 classes and the blank, hidden 48) on
# synthetic_lines(OCR_BATCH, seed=0), Adam(5e-3), as the JAX test trains it
OCR_CFG = dict(num_classes=4, hidden=48)
OCR_BATCH = 256
# the FCN segmenter (paddle_tpu/models/fcn.py) at its defaults (base 16,
# the 21 VOC classes) on datasets/voc2012.py's synthetic masks at 256 px,
# Adam(5e-3), as the JAX package's tests train it; and the SSD detector
# (paddle_tpu/models/ssd.py) with the 21 VOC classes at SSD300's 300 px
# input, 16 gt slots an image (voc2012.detection_train's max_boxes), on
# tests/test_detection.py's synthetic one-box images, Adam(1e-3); the
# detect step keeps the top 20 (ssd.infer's default)
FCN_CFG = dict(num_classes=21, base=16)
FCN_SIZE = 256
FCN_BATCH = 32
SSD_CLASSES = 21
SSD_SIZE = 300
SSD_GT = 16
SSD_BATCH = 32
SSD_KEEP = 20
# Transformer-base's optimizer (Vaswani et al. 2017, section 5.3), for
# the programs with dropout: Adam(0.9, 0.98, 1e-9) on noam_decay(d_model,
# BASE_WARMUP), resumed at the optimizer step BASE_WARMUP (the peak of
# warm-up; the first steps' rate is about 1e-7)
BASE_WARMUP = 4000


def build_train_program(amp: bool = False, dropout: float = 0.0,
                        remat: bool = False):
    """``build_lm`` at LM_CFG's width (with ``dropout`` and ``remat``) with
    Adam(1e-3) and global-norm clipping (1.0), in fresh default programs;
    with dropout, Transformer-base's optimizer instead (Adam(0.9, 0.98,
    1e-9) on ``noam_decay(d_model, BASE_WARMUP)``, clip 1.0; see
    :func:`resume_at_warmup`).  With ``amp``, then ``amp.enable`` with the
    default bf16 list plus the ``attention`` op (the list names
    ``flash_attention``, not the LM's op), so that attention runs the bf16
    flash kernels, the JAX package's knob for its own; returns (loss,
    main, startup)."""
    import paddle_tpu_torch as fluid

    T = LM_CFG["max_len"]
    fluid.reset_default_programs()
    toks = fluid.layers.data("toks", [T], dtype="int32")
    labs = fluid.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fluid.models.build_lm(toks, labs, dropout=dropout,
                                    remat=remat, **LM_CFG)
    clip = fluid.clip.GradientClipByGlobalNorm(1.0)
    if dropout > 0:
        fluid.optimizer.Adam(
            fluid.learning_rate_decay.noam_decay(LM_CFG["d_model"],
                                                 BASE_WARMUP),
            beta1=0.9, beta2=0.98, epsilon=1e-9, grad_clip=clip).minimize(
            loss)
    else:
        fluid.optimizer.Adam(1e-3, grad_clip=clip).minimize(loss)
    main = fluid.default_main_program()
    if amp:
        fluid.amp.enable(main,
                         fluid.amp.Bf16Policy(extra_bf16=("attention",)))
    return loss, main, fluid.default_startup_program()


def build_text_lstm_program():
    """``models.text_lstm.build`` at TEXT_LSTM_CFG's width over padded
    sequences of TEXT_LSTM_SEQ ids, with Adam(1e-3), in fresh default
    programs; returns (loss, main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    words = fluid.layers.data("words", [TEXT_LSTM_SEQ], dtype="int32")
    lengths = fluid.layers.data("lengths", [-1], dtype="int32",
                                append_batch_size=False)
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.text_lstm.build(words, lengths, label,
                                              **TEXT_LSTM_CFG)
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def _seq2seq_data(fluid):
    T = SEQ2SEQ_LEN
    src = fluid.layers.data("src", [T], dtype="int32")
    slen = fluid.layers.data("slen", [-1], dtype="int32",
                             append_batch_size=False)
    return src, slen


def build_seq2seq_program():
    """``models.seq2seq.train_net`` at SEQ2SEQ_CFG's width over pairs padded
    to SEQ2SEQ_LEN tokens, with Adam(1e-3) and global-norm clipping (1.0),
    in fresh default programs; returns (loss, main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    T = SEQ2SEQ_LEN
    src, slen = _seq2seq_data(fluid)
    tgt = fluid.layers.data("tgt", [T], dtype="int32")
    tlen = fluid.layers.data("tlen", [-1], dtype="int32",
                             append_batch_size=False)
    lab = fluid.layers.data("lab", [T, 1], dtype="int32")
    loss = fluid.models.seq2seq.train_net(src, slen, tgt, tlen, lab,
                                          **SEQ2SEQ_CFG)
    fluid.optimizer.Adam(
        1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(
        loss)
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def build_beam_program():
    """``models.seq2seq.beam_search_decoder`` at SEQ2SEQ_CFG's width and
    SEQ2SEQ_BEAM, in fresh default programs; returns ((tokens, scores,
    lens), main, startup): lens is the ``beam_search`` op's third output,
    each beam's length before <e>."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    src, slen = _seq2seq_data(fluid)
    toks, scores = fluid.models.seq2seq.beam_search_decoder(
        src, slen, SEQ2SEQ_CFG["src_vocab"], SEQ2SEQ_CFG["tgt_vocab"],
        emb_dim=SEQ2SEQ_CFG["emb_dim"], hidden=SEQ2SEQ_CFG["hidden"],
        **SEQ2SEQ_BEAM)
    main = fluid.default_main_program()
    op = next(o for o in main.list_ops() if o.type == "beam_search")
    lens = main.global_block.var(op.outputs["Out"][2])
    return (toks, scores, lens), main, fluid.default_startup_program()


def build_srl_program():
    """``models.srl.db_lstm`` at SRL_CFG's width over SRL_LEN-token slots,
    with the chapter's SGD on ``exponential_decay(0.01, 100000, 0.5,
    staircase=True)``, in fresh default programs; returns ((loss,
    decoded), main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    slots = [fluid.layers.data(n, [SRL_LEN], dtype="int32")
             for n in SRL_SLOTS]
    label = fluid.layers.data("label", [SRL_LEN], dtype="int32")
    length = fluid.layers.data("length", [-1], dtype="int32",
                               append_batch_size=False)
    loss, decoded, _ = fluid.models.srl.db_lstm(*slots, length, label=label,
                                                **SRL_CFG)
    fluid.optimizer.SGD(fluid.learning_rate_decay.exponential_decay(
        0.01, 100000, 0.5, staircase=True)).minimize(loss)
    return ((loss, decoded), fluid.default_main_program(),
            fluid.default_startup_program())


def srl_batch(seed: int = 0, n: int = SRL_BATCH, train: bool = True):
    """``n`` sentences of ``datasets.conll05.train()`` from the
    ``seed * n``-th on, padded by ``models.srl.batch_from_dataset``; the
    feed of SRL_SLOTS, ``label`` and ``length`` (``train=False``: no
    label)."""
    from itertools import islice

    from ..datasets import conll05
    from ..models import srl

    samples = list(islice(conll05.train((seed + 1) * n)(), seed * n, None))
    slots, tags, length = srl.batch_from_dataset(samples, SRL_LEN)
    feed = dict(zip(SRL_SLOTS, slots))
    if train:
        feed["label"] = tags
    feed["length"] = length
    return feed


def build_hier_text_program():
    """``models.hier_text.build`` at HIER_CFG over documents of HIER_S
    sentences of HIER_W words, with Adam(3e-3), in fresh default programs;
    returns ((loss, acc, prediction), main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    L = fluid.layers
    toks = L.data("toks", [HIER_S, HIER_W], dtype="int32")
    n_sub = L.data("n_sub", [-1], dtype="int32", append_batch_size=False)
    sub_len = L.data("sub_len", [HIER_S], dtype="int32")
    label = L.data("label", [1], dtype="int32")
    outs = fluid.models.hier_text.build(toks, n_sub, sub_len, label,
                                        **HIER_CFG)
    fluid.optimizer.Adam(3e-3).minimize(outs[0])
    return outs, fluid.default_main_program(), fluid.default_startup_program()


def hier_text_batch(seed: int = 0, n: int = HIER_BATCH, S: int = HIER_S,
                    W: int = HIER_W, vocab_size: int = None,
                    train: bool = True) -> dict:
    """``n`` documents from ``RandomState(seed)`` by the JAX test's rule
    (``tests/test_nested.py:175-186``): a label, tokens from the label's
    half of the vocabulary ([1, V/2) or [V/2, V)), 1..S sentences, each of
    1..W words, ``sub_len`` zero past ``n_sub``.  ``train=False``: no
    label.  ``vocab_size`` defaults to HIER_CFG's."""
    rng = np.random.RandomState(seed)
    V = vocab_size or HIER_CFG["vocab_size"]
    y = rng.randint(0, 2, (n, 1)).astype(np.int32)
    lo = np.where(y[:, 0] == 0, 1, V // 2)[:, None, None]
    hi = np.where(y[:, 0] == 0, V // 2, V)[:, None, None]
    toks = (rng.randint(0, 10 ** 6, (n, S, W)) % (hi - lo) + lo).astype(
        np.int32)
    n_sub = rng.randint(1, S + 1, (n,)).astype(np.int32)
    sub_len = rng.randint(1, W + 1, (n, S)).astype(np.int32)
    sub_len[np.arange(S)[None, :] >= n_sub[:, None]] = 0
    feed = {"toks": toks, "n_sub": n_sub, "sub_len": sub_len}
    if train:
        feed["label"] = y
    return feed


def startup_params(main, startup, seed: int = 0) -> dict:
    """The parameters of ``main`` as numpy arrays, as the port's startup
    program draws them on the CPU with program seed ``seed``."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    startup.random_seed = seed
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {p.name: scope.find_var(p.name).numpy()
            for p in main.parameters()}


def seq2seq_batch(seed: int, n: int = SEQ2SEQ_BATCH, train: bool = True):
    """``n`` sentence pairs from ``RandomState(seed)``: source and target
    lengths uniform in SEQ2SEQ_LENGTHS, words uniform in [3, V), each
    target ending in <e>, padding <e>; the decoder reads <s> and the
    target shifted right, the labels are the target.  ``train=False``
    gives the sources alone."""
    rng = np.random.RandomState(seed)
    T, V = SEQ2SEQ_LEN, SEQ2SEQ_CFG["src_vocab"]
    lo, hi = SEQ2SEQ_LENGTHS
    slen = rng.randint(lo, hi + 1, (n,)).astype(np.int32)
    tlen = rng.randint(lo, hi + 1, (n,)).astype(np.int32)
    src = rng.randint(3, V, (n, T)).astype(np.int32)
    y = rng.randint(3, SEQ2SEQ_CFG["tgt_vocab"], (n, T)).astype(np.int32)
    pos = np.arange(T)[None, :]
    eos, bos = SEQ2SEQ_BEAM["eos_id"], SEQ2SEQ_BEAM["bos_id"]
    src[pos >= slen[:, None]] = eos
    y[pos >= tlen[:, None] - 1] = eos
    if not train:
        return {"src": src, "slen": slen}
    tgt = np.concatenate([np.full((n, 1), bos, np.int32), y[:, :-1]], 1)
    return {"src": src, "slen": slen, "tgt": tgt, "tlen": tlen,
            "lab": y[..., None]}


def build_resnet_program(amp: bool):
    """``models.resnet.build`` at RESNET_CFG (ResNet-50, 1000 classes) over
    NCHW float32 images with Momentum(0.1, 0.9), then ``amp.enable()`` when
    ``amp``, as ``bench.py`` builds it, in fresh default programs; returns
    (loss, main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    img = fluid.layers.data("img", list(RESNET_IMAGE))
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.resnet.build(img, label, **RESNET_CFG)
    fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    if amp:
        fluid.amp.enable()
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def build_infer_program(depth: int, amp: bool):
    """``models.resnet.build`` at ``depth`` (1000 classes) over NCHW float32
    224x224 images, ``amp.enable()`` when ``amp``, pruned to the prediction
    as ``benchmark/resnet.py``'s infer configs are, in fresh default
    programs; returns (prediction, pruned program, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    img = fluid.layers.data("img", list(RESNET_IMAGE))
    label = fluid.layers.data("label", [1], dtype="int32")
    _, _, pred = fluid.models.resnet.build(
        img, label, class_dim=RESNET_CFG["class_dim"], depth=depth)
    if amp:
        fluid.amp.enable()
    return (pred, fluid.default_main_program().prune([pred]),
            fluid.default_startup_program())


def infer_arrays(depth: int, seed: int = 0) -> dict:
    """ResNet's parameters and running statistics at ``depth`` as numpy
    arrays, from ``seed``."""
    from ..models import init_resnet_params, init_resnet_stats

    out = init_resnet_params(seed, depth, RESNET_CFG["class_dim"])
    out.update(init_resnet_stats(seed, depth, RESNET_CFG["class_dim"]))
    return out


def infer_batch(n: int, device, seed: int = 0) -> dict:
    """``n`` images as ``benchmark/_common.py`` draws them (``rand`` of
    ``RandomState(seed)``), as a tensor on ``device``."""
    rng = np.random.RandomState(seed)
    img = rng.rand(n, *RESNET_IMAGE).astype(np.float32)
    return {"img": torch.from_numpy(img).to(device)}


def build_image_program(model: str, amp: bool, infer: bool = False,
                        dtype: str = "float32"):
    """``models.<vgg | alexnet | googlenet>.build`` for ``model`` (a key of
    IMAGE_MODELS) at 1000 classes over NCHW 224x224 images, as
    ``benchmark/_common.py::image_spec`` builds it: with Momentum(0.01,
    0.9), then ``amp.enable()`` when ``amp``; with ``infer`` no optimizer
    and the program pruned to the prediction.  ``dtype`` is the images'
    and so every parameter's (``"float64"``: a reference step).  Fresh
    default programs; returns (loss, main, startup), or with ``infer``
    (prediction, pruned program, startup)."""
    import paddle_tpu_torch as fluid

    module, kw, _ = IMAGE_MODELS[model]
    fluid.reset_default_programs()
    img = fluid.layers.data("img", list(RESNET_IMAGE), dtype=dtype)
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, pred = getattr(fluid.models, module).build(
        img, label, class_dim=IMAGE_CLASS_DIM, **kw)
    if not infer:
        fluid.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
    if amp:
        fluid.amp.enable()
    main = fluid.default_main_program()
    if infer:
        return pred, main.prune([pred]), fluid.default_startup_program()
    return loss, main, fluid.default_startup_program()


def image_batch(n: int, device, seed: int = 0, train: bool = True) -> dict:
    """``n`` images and labels as ``image_spec``'s ``synthetic_feed``
    draws them from ``RandomState(seed)`` (``rand`` images, then labels in
    [0, 1000)), as tensors on ``device``; ``train=False``: images only."""
    rng = np.random.RandomState(seed)
    img = rng.rand(n, *RESNET_IMAGE).astype(np.float32)
    feed = {"img": torch.from_numpy(img).to(device)}
    if train:
        label = rng.randint(0, IMAGE_CLASS_DIM, (n, 1)).astype(np.int32)
        feed["label"] = torch.from_numpy(label).to(device)
    return feed


def conv_routes(program, fetch_names, n: int) -> dict:
    """The conv kernels' launches by route (``ops/conv.py::conv_route``)
    that one inference step of ``program`` on ``n`` images makes: each
    3x3 stride-1 conv ``core/fusion.py`` routes, at its input's declared
    shape and its compute dtype under the program's amp policy, with
    aligned pointers (the routed ops' NHWC copies are fresh
    allocations)."""
    from ..core.fusion import compute_dtype, route_inference
    from ..ops.conv import conv_route

    amp = getattr(program, "amp_policy", None)
    out = {"halo": 0, "halo_f32": 0, "gather": 0}
    for op in route_inference(program, fetch_names, amp) or []:
        if op.type not in ("conv2d", "conv2d_bn_relu") or \
                op.fn.__name__ not in ("_igemm_fn", "_fused_fn"):
            continue
        (x,), (w,) = op.inputs["Input"], op.inputs["Filter"]
        _, c, h, wd = program.global_block.vars[x].shape
        o = program.global_block.vars[w].shape[0]
        dtype = compute_dtype(program, x, "conv2d", op.attrs, amp)
        out[conv_route(dtype, n, h, wd, c, o, True)] += 1
    return out


def build_ocr_program():
    """``models.ocr_ctc.build`` at OCR_CFG over 8x32 lines with Adam(5e-3),
    in fresh default programs; returns ((loss, decoded ids, decoded
    lengths, logits), main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    L = fluid.layers
    img = L.data("img", [1, 8, 32])
    lab = L.data("lab", [4], dtype="int32")
    ll = L.data("ll", [-1], dtype="int32", append_batch_size=False)
    loss, (ids, lens), logits = fluid.models.ocr_ctc.build(img, lab, ll,
                                                           **OCR_CFG)
    fluid.optimizer.Adam(5e-3).minimize(loss)
    return ((loss, ids, lens, logits), fluid.default_main_program(),
            fluid.default_startup_program())


def ocr_batch(n: int = OCR_BATCH, seed: int = 0, train: bool = True) -> dict:
    """``n`` lines of ``models.ocr_ctc.synthetic_lines(n, seed=seed)``;
    ``train=False``: the images only."""
    from ..models.ocr_ctc import synthetic_lines

    imgs, labels, lens = synthetic_lines(n, seed=seed)
    if not train:
        return {"img": imgs}
    return {"img": imgs, "lab": labels, "ll": lens}


def build_fcn_program(amp: bool = False, infer: bool = False,
                      size: int = FCN_SIZE):
    """``models.fcn.build`` at FCN_CFG over ``size`` px images with
    Adam(5e-3), then ``amp.enable()`` when ``amp``; with ``infer`` no
    optimizer and the program pruned to the logits.  Fresh default
    programs; returns ((loss, accuracy, logits), main, startup), or with
    ``infer`` (logits, pruned program, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    img = fluid.layers.data("img", [3, size, size])
    lab = fluid.layers.data("lab", [size, size], dtype="int32")
    loss, acc, logits = fluid.models.fcn.build(img, lab, **FCN_CFG)
    if not infer:
        fluid.optimizer.Adam(5e-3).minimize(loss)
    if amp:
        fluid.amp.enable()
    main = fluid.default_main_program()
    if infer:
        return logits, main.prune([logits]), fluid.default_startup_program()
    return (loss, acc, logits), main, fluid.default_startup_program()


def fcn_batch(n: int = FCN_BATCH, seed: int = 0, train: bool = True,
              size: int = FCN_SIZE) -> dict:
    """``n`` images and int32 masks of ``datasets.voc2012``'s synthetic
    reader (seed 0 is its ``train()``); ``train=False``: the images
    only."""
    from ..datasets import voc2012

    data = list(voc2012._reader(n, seed, size)())
    feed = {"img": np.stack([d[0] for d in data])}
    if train:
        feed["lab"] = np.stack([d[1] for d in data]).astype(np.int32)
    return feed


def on_card(feed: dict) -> dict:
    """``feed``'s numpy arrays as tensors on the card, where a batch that
    every step reads stays."""
    return {k: torch.from_numpy(np.asarray(v)).to("cuda")
            for k, v in feed.items()}


def build_ssd_program(amp: bool = False, infer: bool = False):
    """``models.ssd.build`` over SSD_SIZE px images with SSD_GT box slots
    and SSD_CLASSES classes, Adam(1e-3), then ``amp.enable()`` when
    ``amp``; with ``infer`` no optimizer, ``ssd.infer`` (keep SSD_KEEP)
    and the program pruned to its detections.  Fresh default programs;
    returns ((loss, (loc, conf, prior, prior_var)), main, startup), or
    with ``infer`` ((boxes, scores, labels), pruned program, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    L = fluid.layers
    img = L.data("img", [3, SSD_SIZE, SSD_SIZE])
    gb = L.data("gb", [SSD_GT, 4])
    gl = L.data("gl", [SSD_GT], dtype="int32")
    loss, heads = fluid.models.ssd.build(img, gb, gl, num_classes=SSD_CLASSES)
    if infer:
        dets = tuple(fluid.models.ssd.infer(*heads, keep_top_k=SSD_KEEP))
    else:
        fluid.optimizer.Adam(1e-3).minimize(loss)
    if amp:
        fluid.amp.enable()
    main = fluid.default_main_program()
    if infer:
        return dets, main.prune(list(dets)), fluid.default_startup_program()
    return (loss, heads), main, fluid.default_startup_program()


def ssd_batch(n: int = SSD_BATCH, seed: int = 0, train: bool = True,
              size: int = SSD_SIZE, num_classes: int = SSD_CLASSES,
              gt: int = SSD_GT) -> dict:
    """``n`` synthetic one-box images by ``tests/test_detection.py``'s rule
    (``test_ssd_model_trains_and_detects``): ``rand`` * 0.1 backgrounds,
    one box a class in [1, num_classes) centred in [0.3, 0.7], half the
    image wide and brightened by 1 for class 1, a quarter wide and darkened
    by 0.5 for the others; boxes [n, gt, 4] and labels [n, gt] zero past
    the first slot.  ``train=False``: the images only."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, 3, size, size).astype("float32") * 0.1
    gb = np.zeros((n, gt, 4), "float32")
    gl = np.zeros((n, gt), "int32")
    for b in range(n):
        cls = rng.randint(1, num_classes)
        big = cls == 1
        sz = 0.5 if big else 0.25
        cx, cy = rng.uniform(0.3, 0.7, 2)
        x0, y0 = max(cx - sz / 2, 0.0), max(cy - sz / 2, 0.0)
        x1, y1 = min(cx + sz / 2, 1.0), min(cy + sz / 2, 1.0)
        gb[b, 0] = [x0, y0, x1, y1]
        gl[b, 0] = cls
        imgs[b, :, int(y0 * size):int(y1 * size),
             int(x0 * size):int(x1 * size)] += 1.0 if big else -0.5
    if not train:
        return {"img": imgs}
    return {"img": imgs, "gb": gb, "gl": gl}


def resnet_params(seed: int = 0) -> dict:
    """ResNet-50's parameters as numpy arrays, from ``seed``."""
    from ..models import init_resnet_params

    return init_resnet_params(seed, **RESNET_CFG)


def resnet_batch(seed: int, n: int, device) -> dict:
    """``n`` images N(0, 1) and labels in [0, class_dim) from
    ``RandomState(seed)``, as tensors on ``device``: a synthetic batch that
    stays there, as ``bench.py``'s does."""
    rng = np.random.RandomState(seed)
    img = rng.standard_normal((n,) + RESNET_IMAGE).astype(np.float32)
    label = rng.randint(0, RESNET_CFG["class_dim"], (n, 1)).astype(np.int32)
    return {"img": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(label).to(device)}


def text_lstm_params(seed: int = 0) -> dict:
    """The text classifier's weights as numpy arrays, from ``seed``."""
    from ..models import init_text_lstm_params

    return init_text_lstm_params(seed, **TEXT_LSTM_CFG)


def text_lstm_batch(seed: int, n: int = TEXT_LSTM_BATCH) -> dict:
    """``n`` sequences as ``benchmark/text_lstm.py``'s ``synthetic_feed``
    draws them from ``RandomState(seed)``: ids, lengths in [T/2, T], binary
    labels."""
    rng = np.random.RandomState(seed)
    T, V = TEXT_LSTM_SEQ, TEXT_LSTM_CFG["vocab_size"]
    return {"words": rng.randint(0, V, (n, T)).astype(np.int32),
            "lengths": rng.randint(T // 2, T + 1, (n,)).astype(np.int32),
            "label": rng.randint(0, 2, (n, 1)).astype(np.int32)}


def train_scope(exe, startup, main, params, device=None):
    """A new scope with the startup program run by ``exe`` and ``params``
    (numpy arrays by name) loaded over it on ``device``."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.load_scope(params, main, scope, device=device)
    return scope


def resume_at_warmup(scope, main) -> None:
    """Set every optimizer step of ``main`` in ``scope`` to BASE_WARMUP, as
    a run resumed at the peak of noam's warm-up would hold it."""
    for v in main.persistable_vars():
        if v.name.endswith(".step"):
            cur = scope.find_var(v.name)
            scope.set_var(v.name, torch.full_like(cur, BASE_WARMUP))


def feed_sig(feed: dict) -> list:
    """The (name, shape, dtype) signature of a feed of numpy arrays or
    tensors, for ``Executor.warm``."""
    from ..core.types import dtype_name

    return [(n, tuple(v.shape), v.dtype.name if isinstance(v, np.ndarray)
             else dtype_name(v.dtype)) for n, v in feed.items()]


def train_batch(seed: int, n: int = TRAIN_BATCH) -> dict:
    """``n`` sequences of random tokens and labels from ``seed``."""
    rng = np.random.RandomState(seed)
    T, V = LM_CFG["max_len"], LM_CFG["vocab_size"]
    return {"toks": rng.randint(0, V, (n, T)).astype(np.int32),
            "labs": rng.randint(0, V, (n, T, 1)).astype(np.int32)}


# kernel classes of the LM and LSTM steps; the flash kernels by their
# operands' dtype, which their names carry (``flash_*_bf16_kernel``, or a
# template argument ``__nv_bfloat16``); the optimizer by the multi-tensor
# kernels ``torch._foreach_*`` launches (``multi_tensor_apply_kernel``):
# the grouped updates and the clip's scaling, while the clip's norm and the
# per-op updates' scalar work stay in other
STEP_CLASSES = ("flash_attention_f32", "flash_attention_bf16", "lstm",
                "dropout", "matmul", "optimizer", "other")


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "dropout_mask_kernel" in low:
        return "dropout"
    if "flash_" in low:
        bf16 = "bf16" in low or "bfloat16" in low
        return "flash_attention_bf16" if bf16 else "flash_attention_f32"
    if "lstm_" in low:
        return "lstm"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "matmul", "gemv",
                              "nvjet")):
        return "matmul"
    if "multi_tensor_apply" in low:
        return "optimizer"
    return "other"


# ResNet kernel classes: by the op (record_function range "op::<type>")
# or autograd node that launched each kernel, then by the kernel's name
RESNET_CLASSES = ("conv_fwd", "conv_dgrad", "conv_wgrad", "conv_bwd_other",
                  "bn_bwd_kernels", "bn_fwd_plain", "bn_bwd_other", "pool",
                  "optimizer", "other")
_OP_CLASS = {"conv2d": "conv_fwd", "batch_norm": "bn_fwd_plain",
             "pool2d": "pool", "momentum": "optimizer",
             "increment": "optimizer"}
_NODE = "autograd::engine::evaluate_function: "


def _resnet_class(kernel: str, ancestors) -> str:
    """The class of a kernel launched under ``ancestors`` (the names of the
    enclosing host ranges, innermost first)."""
    low = kernel.lower()
    if "bn_bwd_" in low:
        return "bn_bwd_kernels"
    for a in ancestors:
        if a.startswith("op::"):
            return _OP_CLASS.get(a[4:], "other")
        if a.startswith(_NODE):
            node = a[len(_NODE):]
            if "Convolution" in node:
                return ("conv_wgrad" if "wgrad" in low else
                        "conv_dgrad" if "dgrad" in low else "conv_bwd_other")
            if "BatchNormTrain" in node:
                return "bn_bwd_other"
            if "Pool" in node:
                return "pool"
            return "other"
    return "other"


# the other image classifiers' training step: as ResNet's (no batch norm),
# and the fc layers (the mul op, its matmul backward), dropout, lrn and the
# inception blocks' concat; the bias adds and ReLUs as bias_relu
IMAGE_CLASSES = ("conv_fwd", "conv_dgrad", "conv_wgrad", "conv_bwd_other",
                 "fc", "bias_relu", "dropout", "lrn", "concat", "pool",
                 "optimizer", "other")
_IMAGE_OP = {"conv2d": "conv_fwd", "pool2d": "pool", "momentum": "optimizer",
             "increment": "optimizer", "mul": "fc", "dropout": "dropout",
             "lrn": "lrn", "concat": "concat", "relu": "bias_relu",
             "elementwise_add": "bias_relu"}
_IMAGE_NODE = (("Convolution", None), ("Mm", "fc"), ("Pool", "pool"),
               ("Relu", "bias_relu"), ("Threshold", "bias_relu"),
               ("AddBackward", "bias_relu"), ("Cat", "concat"),
               ("Dropout", "dropout"))


def _image_class(kernel: str, ancestors) -> str:
    """The class of a kernel of an image training step, by the op or the
    autograd node that launched it."""
    low = kernel.lower()
    if "dropout_mask_kernel" in low:
        return "dropout"
    for a in ancestors:
        if a.startswith("op::"):
            return _IMAGE_OP.get(a[4:], "other")
        if a.startswith(_NODE):
            node = a[len(_NODE):]
            for key, cls in _IMAGE_NODE:
                if key in node:
                    if cls is None:
                        return ("conv_wgrad" if "wgrad" in low else
                                "conv_dgrad" if "dgrad" in low
                                else "conv_bwd_other")
                    return cls
            return "other"
    return "other"


# ResNet inference kernel classes: the hand-written conv kernels by name,
# then by the op that launched each kernel; the routed ops' own small
# kernels (filter to HWIO, the folded BN's a and b, the halo routes'
# packing of w) are "conv_prep"
INFER_CLASSES = ("fused_kernel", "igemm_kernel", "conv_prep", "conv_cudnn",
                 "bn_plain", "pool", "other")


def _igemm_class(kernel: str):
    """"fused_kernel" or "igemm_kernel" for an ``igemm_kernel<T, kFused,
    BN>``, ``halo_kernel<kFused>`` or ``halo_f32_kernel<kFused>`` instance
    of ``ops/csrc/conv.cu`` (the gather, halo and halo_f32 routes) by its
    name, else None."""
    m = re.search(r"(?:igemm_kernel<[^,<>]+, |halo_kernel<|halo_f32_kernel<)"
                  r"(true|false)", kernel)
    if m is None:
        return None
    return "fused_kernel" if m.group(1) == "true" else "igemm_kernel"


def _conv_pack_kernel(kernel: str) -> bool:
    """Whether ``kernel`` is a conv route's packing of w (``halo_pack_w``,
    ``halo_f32_pack_w``, the gather route's ``gather_f32_pack_w`` and
    ``gather_bf16_pack_w``), counted by its name: as conv prep in the
    inference classes, with the conv kernels in FCN's and SSD's."""
    return re.search(r"\b(?:halo|halo_f32|gather_f32|gather_bf16)_pack_w\b",
                     kernel) is not None


def _infer_class(kernel: str, ancestors) -> str:
    low = kernel.lower()
    mine = _igemm_class(kernel)
    if mine is not None:
        return mine
    for a in ancestors:
        if not a.startswith("op::"):
            continue
        op = a[4:]
        if op == "conv2d_bn_relu":
            return "conv_prep"
        if op == "conv2d":
            return ("conv_prep" if "copy" in low or "elementwise" in low
                    else "conv_cudnn")
        return {"batch_norm": "bn_plain", "pool2d": "pool"}.get(op, "other")
    return "other"


def _chain(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def _classes_by_origin(prof, classes, classify, name=None) -> dict:
    """Device microseconds by class: each host event's kernels, classified
    by ``classify(kernel name, enclosing host range names)``, innermost
    first; ``name(event)`` names each range (default its own name)."""
    name = name or (lambda evt: evt.name)
    out = {k: 0.0 for k in classes}
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if not kernels:
            continue
        names = [name(a) for a in _chain(evt)]
        for k in kernels:
            out[classify(k.name, names)] += float(k.duration)
    return out


class _OpRanges:
    """While entered, every op (the routed ops of an inference step too)
    runs inside a ``record_function(label(op))`` range, ``op::<type>`` by
    default, and each grouped call of update ops inside its first op's,
    so a profile can tell which op launched a kernel."""

    def __init__(self, label=None):
        self.label = label or (lambda op: f"op::{op.type}")

    def __enter__(self):
        from torch.profiler import record_function

        from ..core.program import Op
        from ..optimizer import Optimizer

        self._apply, self._group = Op.apply, Optimizer.apply_group
        label = self.label

        def apply(op, env, ctx, _apply=self._apply):
            with record_function(label(op)):
                _apply(op, env, ctx)

        def apply_group(opt, ops, env, ctx, _apply=self._group):
            with record_function(label(ops[0])):
                _apply(opt, ops, env, ctx)
        Op.apply, Optimizer.apply_group = apply, apply_group
        return self

    def __exit__(self, *exc):
        from ..core.program import Op
        from ..optimizer import Optimizer

        Op.apply, Optimizer.apply_group = self._apply, self._group


# seq2seq kernel classes, by the op that launched each kernel (the
# profiled eager step runs each op in a "s2s::<class>" range, see
# :func:`seq2seq_op_classes`) or, in the backward, by the forward op that
# made the autograd node (its sequence number); the beam decode's by name
# inside the beam_search op, and its encoder by op
SEQ2SEQ_CLASSES = ("output_ce", "gru", "attention", "optimizer", "other")
BEAM_CLASSES = ("encoder", "beam_select", "matmul", "softmax", "other")
_S2S = "s2s::"


def seq2seq_op_classes(program) -> dict:
    """id(op) -> class for every op of a seq2seq program (the sub-block of
    its ``static_rnn`` op too): the decoder's attention projection and
    score ``attention``; the GRUs (``dynamic_gru``, the decoder's
    ``static_rnn`` op with its other body ops) ``gru``; the ops between
    the decoder and the backward (logits, cross-entropy, the masked mean)
    ``output_ce``; the ops after the backward ``optimizer``; the
    ``beam_search`` op ``beam``; the rest (embeddings, input projections,
    concat, pooling) ``other``."""
    ops = program.list_ops()
    out, after_rnn, after_bwd = {}, False, False
    for op in ops:
        if op.special == "backward":
            after_bwd = True
            continue
        if op.type == "static_rnn":
            out[id(op)] = "gru"
            body = op.sub_block.ops
            att = next(o for o in body if o.type == "attention_score")
            dp = att.inputs["Dp"][0]
            for o in body:
                out[id(o)] = ("attention" if o is att or dp in o.output_names()
                              else "gru")
            after_rnn = True
            continue
        out[id(op)] = ("optimizer" if after_bwd else
                       "output_ce" if after_rnn else
                       "gru" if op.type == "dynamic_gru" else
                       "beam" if op.type == "beam_search" else "other")
    return out


def seq2seq_range_names(events):
    """``name(event)`` for :func:`_classes_by_origin` over a step run under
    ``s2s::<class>`` op ranges: an autograd node's ``evaluate_function``
    (the backward) is named as the innermost ``s2s::`` range above the
    forward op whose autograd op made it, found by its sequence number
    (``s2s::other`` if none), every other event by its own name."""
    forward = {}
    for evt in events:
        nr = getattr(evt, "sequence_nr", -1)
        if nr is None or nr < 0 or evt.name.startswith(_NODE):
            continue
        for a in _chain(evt):
            if a.name.startswith(_S2S):
                forward.setdefault(nr, a.name)
                break

    def name(evt):
        if evt.name.startswith(_NODE):
            return forward.get(getattr(evt, "sequence_nr", -1),
                               _S2S + "other")
        return evt.name
    return name


def _s2s_class(ancestors) -> str:
    return next((a[len(_S2S):] for a in ancestors if a.startswith(_S2S)),
                "other")


def _seq2seq_class(kernel: str, ancestors) -> str:
    if "multi_tensor_apply" in kernel:
        return "optimizer"
    return _s2s_class(ancestors)


def _beam_class(name: str, ancestors) -> str:
    if _s2s_class(ancestors) != "beam":
        return "encoder"
    low = name.lower()
    if any(k in low for k in ("topk", "sort", "radix")):
        return "beam_select"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "matmul", "gemv",
                              "nvjet")):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other"


# SRL kernel classes, by origin as for seq2seq (each op in an
# "s2s::<class>" range): the LSTM kernels by name (a ctypes launch has no
# host event above its kernel; the rest of dynamic_lstm, the bias add,
# transposes and flips, by origin), the CRF's forward algorithm and gold
# path, Viterbi, the fc ops, the embeddings, the optimizer, the rest
SRL_CLASSES = ("lstm", "crf", "viterbi", "matmul", "embedding", "optimizer",
               "other")
_SRL_OP = {"dynamic_lstm": "lstm", "linear_chain_crf": "crf",
           "crf_decoding": "viterbi", "mul": "matmul",
           "elementwise_add": "matmul", "embedding": "embedding"}
# the class of a kernel counted by its name, not by origin
_BY_NAME = "by_name"


def srl_op_classes(program) -> dict:
    """id(op) -> class for every op of an SRL program: by op type
    (_SRL_OP), the ops after the backward ``optimizer``, the rest
    (concat, the loss's mean, the learning-rate schedule) ``other``."""
    out, after_bwd = {}, False
    for op in program.list_ops():
        if op.special == "backward":
            after_bwd = True
            continue
        out[id(op)] = ("optimizer" if after_bwd
                       else _SRL_OP.get(op.type, "other"))
    return out


def _srl_name_class(kernel: str):
    return "lstm" if _kernel_class(kernel) == "lstm" else None


def _srl_class(kernel: str, ancestors) -> str:
    if _srl_name_class(kernel) is not None:
        return _BY_NAME             # counted by name, see _eager_classes
    return _seq2seq_class(kernel, ancestors)


# hier_text kernel classes, by origin as for seq2seq: the word GRU (the
# dynamic_gru op and its input projection, in the static_rnn op's body),
# the rest of the sentence step (the body's pooling and fc, the outer
# loop's masks and stacking), the embedding, the classifier's fc ops, the
# optimizer, the rest
HIER_CLASSES = ("word_gru", "sentence_step", "embedding", "matmul",
                "optimizer", "other")


def hier_text_op_classes(program) -> dict:
    """id(op) -> class for every op of a hier_text program (the sub-block
    of its ``static_rnn`` op too)."""
    out, after_bwd = {}, False
    for op in program.list_ops():
        if op.special == "backward":
            after_bwd = True
            continue
        if op.type == "static_rnn":
            out[id(op)] = "sentence_step"
            body = op.sub_block.ops
            gru = next(o for o in body if o.type == "dynamic_gru")
            proj = gru.inputs["Input"][0]
            for o in body:
                out[id(o)] = ("word_gru" if o is gru
                              or proj in o.output_names()
                              else "sentence_step")
            continue
        out[id(op)] = ("optimizer" if after_bwd else
                       "embedding" if op.type == "embedding" else
                       "matmul" if op.type in ("mul", "elementwise_add")
                       else "other")
    return out


# FCN and SSD kernel classes, by origin as for seq2seq: cuDNN's convs
# (forward and backward) and their bias adds and ReLUs, the conv kernels
# of a routed inference step and the batch-norm backward kernels by name
# (ctypes launches have no host event above them), the transposed conv,
# the batch norms' plain ops, pooling, the head's layout ops (transpose,
# reshape, concat), the losses (FCN's per-pixel softmax CE and mean; SSD's
# matching, mining and multibox loss), FCN's pixel accuracy, SSD's decode
# and NMS, the optimizer and the rest
DETECT_CLASSES = ("conv_cudnn", "bias_relu", "conv_kernel", "deconv",
                  "bn_kernels", "bn_plain", "pool", "layout", "loss",
                  "metric", "nms", "optimizer", "other")
_DETECT_OP = {"conv2d": "conv_cudnn", "elementwise_add": "bias_relu",
              "relu": "bias_relu", "conv2d_transpose": "deconv",
              "batch_norm": "bn_plain", "pool2d": "pool",
              "transpose": "layout", "reshape": "layout",
              "concat": "layout", "unsqueeze": "layout",
              "softmax_with_cross_entropy": "loss", "mean": "loss",
              "ssd_loss": "loss", "argmax": "metric", "equal": "metric",
              "cast": "metric", "detection_output": "nms"}


def detect_op_classes(program) -> dict:
    """id(op) -> class for every op of an FCN or SSD program: by op type
    (_DETECT_OP), the ops after the backward ``optimizer``; a routed conv
    keeps its op type and so its class, but its kernel is counted by
    name."""
    out, after_bwd = {}, False
    for op in program.list_ops():
        if op.special == "backward":
            after_bwd = True
            continue
        out[id(op)] = ("optimizer" if after_bwd
                       else _DETECT_OP.get(op.type, "other"))
    return out


def _detect_name_class(kernel: str):
    if _igemm_class(kernel) is not None or _conv_pack_kernel(kernel):
        return "conv_kernel"
    if "bn_bwd_" in kernel:
        return "bn_kernels"
    return None


def _detect_class(kernel: str, ancestors) -> str:
    if _detect_name_class(kernel) is not None:
        return _BY_NAME             # counted by name, see _eager_classes
    return _seq2seq_class(kernel, ancestors)


def _eager_classes(model, exe, main, scope, feed, fetch, steps=2) -> tuple:
    """Device ms by class of ``steps`` eager steps of a seq2seq, SRL,
    hier_text, FCN or SSD model (the same kernels a replay runs), each op
    in its class's range; and the eager step's host wall ms (median of
    ``steps``, unprofiled, after one warm-up step)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    srl, hier, det = model in SRL, model in HIER, model in DETECT
    classes = (srl_op_classes if srl else hier_text_op_classes if hier
               else detect_op_classes if det else seq2seq_op_classes)(main)
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with _OpRanges(lambda op: _S2S + classes.get(id(op), "other")):
            for _ in range(steps):
                exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
    beam = model == "seq2seq-beam"
    names = seq2seq_range_names(prof.events())
    if srl or det:
        # the ctypes-launched kernels (no host event above them) by name
        name_class = _srl_name_class if srl else _detect_name_class
        out = _classes_by_origin(
            prof, (SRL_CLASSES if srl else DETECT_CLASSES) + (_BY_NAME,),
            _srl_class if srl else _detect_class, names)
        del out[_BY_NAME]
        kernels = [(evt.key, _kernel_us(evt)) for evt in prof.key_averages()
                   if _kernel_us(evt) > 0]
        for k, us in kernels:
            if name_class(k) is not None:
                out[name_class(k)] += us
        # kernels the event tree did not reach count as other
        out["other"] += sum(us for _, us in kernels) - sum(out.values())
    else:
        out = _classes_by_origin(
            prof, (BEAM_CLASSES if beam else HIER_CLASSES if hier
                   else SEQ2SEQ_CLASSES),
            _beam_class if beam else _seq2seq_class, names)
    out = {k: v / 1e3 / steps for k, v in out.items()}
    return out, float(np.median(walls))


# the FCN and SSD train and inference steps
DETECT = ("fcn", "fcn-infer", "ssd", "ssd-detect")
# the models whose profiled steps are replays of a warmed signature
WARMED = ("lm", "text_lstm", "seq2seq", "seq2seq-beam", "srl", "srl-decode",
          "hier_text", "hier_text-infer", "ocr_ctc", "ocr_ctc-decode") + DETECT
SEQ2SEQ = ("seq2seq", "seq2seq-beam")
SRL = ("srl", "srl-decode")
HIER = ("hier_text", "hier_text-infer")
OCR = ("ocr_ctc", "ocr_ctc-decode")
# the models with only a float32 arm
FLOAT32_ONLY = ("text_lstm",) + SEQ2SEQ + SRL + HIER + OCR


def _recipe(model: str, amp: bool = True, dropout: float = 0.0,
            remat: bool = False):
    """(fetch list, main, startup, weights, feed, items per step or None
    (counted from the first run's fetches), item unit)."""
    import paddle_tpu_torch as fluid

    if model == "lm":
        loss, main, startup = build_train_program(amp, dropout, remat)
        return ([loss], main, startup, fluid.init_lm_params(0, **LM_CFG),
                train_batch(3), TRAIN_BATCH * LM_CFG["max_len"], "tokens")
    if model == "text_lstm":
        loss, main, startup = build_text_lstm_program()
        return ([loss], main, startup, text_lstm_params(0),
                text_lstm_batch(0), TEXT_LSTM_BATCH, "sequences")
    if model == "seq2seq":
        loss, main, startup = build_seq2seq_program()
        feed = seq2seq_batch(0)
        return ([loss], main, startup, startup_params(main, startup), feed,
                int(feed["tlen"].sum()), "target_tokens")
    if model == "seq2seq-beam":
        fetch, main, startup = build_beam_program()
        return (list(fetch), main, startup, startup_params(main, startup),
                seq2seq_batch(0, train=False), None, "emitted_tokens")
    if model in SRL:
        (loss, decoded), main, startup = build_srl_program()
        params = startup_params(main, startup)
        feed = srl_batch(0, train=model == "srl")
        if model == "srl-decode":
            main, fetch = main.prune([decoded]), [decoded]
        else:
            fetch = [loss]
        return (fetch, main, startup, params, feed,
                int(feed["length"].sum()), "tokens")
    if model in HIER:
        (loss, _, pred), main, startup = build_hier_text_program()
        params = startup_params(main, startup)
        feed = hier_text_batch(0, train=model == "hier_text")
        if model == "hier_text":
            return ([loss], main, startup, params, feed,
                    int(feed["sub_len"].sum()), "tokens")
        return ([pred], main.prune([pred]), startup, params, feed,
                HIER_BATCH, "documents")
    if model in OCR:
        (loss, ids, lens, _), main, startup = build_ocr_program()
        params = startup_params(main, startup)
        feed = ocr_batch(train=model == "ocr_ctc")
        if model == "ocr_ctc":
            return ([loss], main, startup, params, feed, OCR_BATCH, "lines")
        return ([ids, lens], main.prune([ids, lens]), startup, params, feed,
                OCR_BATCH, "lines")
    if model in DETECT:
        infer = model in ("fcn-infer", "ssd-detect")
        if model.startswith("fcn"):
            fetch, main, startup = build_fcn_program(amp, infer)
            feed, n = fcn_batch(train=not infer), FCN_BATCH
            fetch = [fetch] if infer else [fetch[0]]
        else:
            fetch, main, startup = build_ssd_program(amp, infer)
            feed, n = ssd_batch(train=not infer), SSD_BATCH
            fetch = list(fetch) if infer else [fetch[0]]
        return (fetch, main, startup, startup_params(main, startup),
                on_card(feed), n, "images")
    if model in IMAGE_MODELS or model in IMAGE_INFER:
        infer = model in IMAGE_INFER
        name = IMAGE_INFER.get(model, model)
        n = IMAGE_MODELS[name][2]
        fetch, main, startup = build_image_program(name, amp, infer)
        return ([fetch], main, startup, startup_params(main, startup),
                image_batch(n, "cuda", train=not infer), n, "images")
    if model == "resnet50":
        loss, main, startup = build_resnet_program(amp)
        n = RESNET_BATCH if amp else RESNET_FP32_BATCH
        return ([loss], main, startup, resnet_params(0),
                resnet_batch(0, n, "cuda"), n, "images")
    if model in INFER_DEPTH:
        depth = INFER_DEPTH[model]
        pred, main, startup = build_infer_program(depth, amp)
        return ([pred], main, startup, infer_arrays(depth),
                infer_batch(INFER_BATCH, "cuda"), INFER_BATCH, "images")
    raise ValueError(f"unknown model {model!r}: lm | text_lstm | seq2seq | "
                     f"seq2seq-beam | srl | srl-decode | hier_text | "
                     f"hier_text-infer | ocr_ctc | ocr_ctc-decode | "
                     f"{' | '.join(DETECT)} | "
                     f"resnet50 | {' | '.join(INFER_DEPTH)} | "
                     f"{' | '.join(IMAGE_MODELS)} | "
                     f"{' | '.join(IMAGE_INFER)}")


def emitted_tokens(lens) -> int:
    """The best hypothesis's length summed over the batch (beams come
    best-first)."""
    return int(np.asarray(lens)[:, 0].sum())


def profile(model: str = "lm", amp: bool = True, dropout: float = 0.0,
            remat: bool = False, eager: bool = False) -> dict:
    """The profile of ``model``'s step: for the LM and the ResNets the amp
    arm, or with ``amp=False`` the float32 arm (the models of FLOAT32_ONLY
    have only the float32 one); the LM with ``dropout`` and ``remat``.  The
    models of WARMED are warmed first, so that every profiled step is a
    replay of one CUDA graph, unless ``eager``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import paddle_tpu_torch as fluid

    if not torch.cuda.is_available():
        raise RuntimeError("train_profile needs a CUDA card")
    steps, repeats = TRAIN_STEPS, REPEATS
    exe = fluid.Executor()            # TF32 off for float32 matmuls and convs
    fetch, main, startup, weights, feed, items, unit = _recipe(
        model, amp, dropout, remat)
    scope = train_scope(exe, startup, main, weights)
    if dropout > 0:
        resume_at_warmup(scope, main)
    infer = model in INFER_DEPTH or model in IMAGE_INFER
    image = model in IMAGE_MODELS
    resnet = model == "resnet50" or infer or image
    warm_s = None
    if model in WARMED and not eager:
        t0 = time.perf_counter()
        exe.warm(main, feed_sig(feed), fetch, scope=scope)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

    def run(n):
        out = None
        for _ in range(n):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        return out

    first = run(2)
    if items is None:
        items = emitted_tokens(first[2])
    walls, windows = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            if resnet:
                with _OpRanges():
                    run(steps)
            else:
                run(steps)
            torch.cuda.synchronize()
        by_class = {k: 0.0 for k in STEP_CLASSES}
        kernels = []
        for evt in prof.key_averages():
            us = _kernel_us(evt)
            if us <= 0:
                continue
            kernels.append((us, evt.key, evt.count))
            by_class[_kernel_class(evt.key)] += us
        kernels.sort(reverse=True)
        busy_us = sum(by_class.values())
        if resnet:
            by_class = _classes_by_origin(
                prof, INFER_CLASSES if infer else IMAGE_CLASSES if image
                else RESNET_CLASSES,
                _infer_class if infer else _image_class if image
                else _resnet_class)
            if infer:
                # a ctypes launch has no host event above its kernel: the
                # conv kernels are counted by name, and so is the halo
                # routes' packing of w (conv prep)
                for cls in ("fused_kernel", "igemm_kernel"):
                    by_class[cls] = sum(us for us, name, _ in kernels
                                        if _igemm_class(name) == cls)
                by_class["conv_prep"] += sum(us for us, name, _ in kernels
                                             if _conv_pack_kernel(name))
            # kernels the event tree did not reach count as other
            by_class["other"] += busy_us - sum(by_class.values())
        windows.append((busy_us / 1e3 / steps, by_class, kernels))
    busy = [w[0] for w in windows]
    wall_ms, busy_ms = float(np.median(walls)), float(np.median(busy))
    _, by_class, kernels = sorted(windows, key=lambda w: w[0])[
        (repeats - 1) // 2]
    if warm_s is not None and exe.replays != 2 + 2 * repeats * steps:
        raise RuntimeError(f"{exe.replays} replays for "
                           f"{2 + 2 * repeats * steps} warmed steps")
    by_class = {k: v / 1e3 / steps for k, v in by_class.items()}
    peak, peak_reserved = (torch.cuda.max_memory_allocated(),
                           torch.cuda.max_memory_reserved())
    eager_ms, by_name = None, None
    if model in SEQ2SEQ + SRL + HIER + DETECT:
        by_name = by_class
        # the replayed graph has no op ranges: the classes come from eager
        # steps of the same program on a second scope
        eager_exe = fluid.Executor()
        by_class, eager_ms = _eager_classes(
            model, eager_exe, main,
            train_scope(eager_exe, startup, main, weights), feed, fetch)
    return {
        "card": fluid.card_info(0), "model": model, "steps": steps,
        "dropout": dropout, "remat": remat,
        "arm": "amp" if amp and model not in FLOAT32_ONLY else "float32",
        "warm_s": warm_s, "replays": exe.replays,
        "peak_memory_bytes": peak,
        # the graph pool's activations are reserved, not allocated, while
        # a graph replays
        "peak_reserved_bytes": peak_reserved,
        "repeats": repeats, "unit": unit, f"{unit}_per_step": items,
        "wall_ms_per_step": _spread(walls),
        "device_busy_ms_per_step": _spread(busy),
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        f"{unit}_per_s": items / wall_ms * 1e3,
        "device_ms_per_step_by_class": by_class,
        # seq2seq: the replays' kernels by name (STEP_CLASSES) beside the
        # classes by origin
        "device_ms_per_step_by_kernel_name": by_name,
        "eager_wall_ms_per_step": eager_ms,
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": c / steps}
                        for us, n, c in kernels[:15]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="lm",
                    choices=("lm", "text_lstm", *SEQ2SEQ, *SRL, *HIER,
                             *OCR, *DETECT, "resnet50", *INFER_DEPTH,
                             *IMAGE_MODELS, *IMAGE_INFER),
                    help="the training step to profile (lm: both arms, "
                         "float32 then amp; resnet50: both arms, amp then "
                         "float32), the seq2seq beam or SRL Viterbi "
                         "decode, the hier_text inference step, the "
                         "ocr_ctc train step or greedy decode, the ResNet "
                         "inference step (resnet50-infer: both arms; "
                         "resnet18-infer: amp), or the VGG-19, AlexNet, "
                         "GoogLeNet, FCN or SSD train or inference step "
                         "(both arms, amp then float32)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="lm: build_lm's dropout (with Transformer-base's "
                         "optimizer, resumed at the peak of warm-up)")
    ap.add_argument("--remat", action="store_true",
                    help="lm: build_lm's remat (each block recomputed in "
                         "the backward)")
    ap.add_argument("--eager", action="store_true",
                    help="profile the step op by op, not warmed "
                         f"({', '.join(WARMED)})")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    if args.model != "lm" and (args.dropout or args.remat):
        ap.error("--dropout and --remat are build_lm's: --model lm")
    arms = {"lm": (False, True), "resnet18-infer": (True,)}.get(
        args.model, (False,) if args.model in FLOAT32_ONLY else (True, False))
    results = []
    for amp in arms:
        gc.collect()                  # the last arm's graphs and their pool
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = profile(args.model, amp, args.dropout, args.remat, args.eager)
        results.append(res)
        wall, busy = res["wall_ms_per_step"], res["device_busy_ms_per_step"]
        unit = res["unit"]
        arm = f" ({res['arm']})" if args.model not in FLOAT32_ONLY else ""
        if args.dropout or args.remat:
            arm += (f" (dropout {args.dropout:g}"
                    f"{', remat' if args.remat else ''})")
        what = ("inference" if args.model in (*INFER_DEPTH, *IMAGE_INFER,
                                              "hier_text-infer", "fcn-infer")
                else "decode" if args.model in ("seq2seq-beam", "srl-decode",
                                                "ocr_ctc-decode",
                                                "ssd-detect")
                else "train")
        print(f"{res['model']}{arm} {what} step on {res['card']}: "
              f"{res[unit + '_per_step']} {unit}, {res['repeats']} repeats "
              f"of {res['steps']} steps; wall median {wall['median']:.3f} "
              f"ms/step (min {wall['min']:.3f}, max {wall['max']:.3f}) = "
              f"{res[unit + '_per_s']:.1f} {unit}/s, device busy median "
              f"{busy['median']:.3f} ms/step (min {busy['min']:.3f}, max "
              f"{busy['max']:.3f}), idle share "
              f"{res['device_idle_share']:.3f}, peak memory "
              f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB allocated, "
              f"{res['peak_reserved_bytes'] / 2 ** 30:.2f} GiB reserved"
              + (f"; warmed in {res['warm_s']:.2f} s, every step one graph "
                 f"replay ({res['replays']})" if res["warm_s"] else
                 "; op by op")
              + (f"; eager step {res['eager_wall_ms_per_step']:.3f} ms "
                 f"(classes below from eager steps)"
                 if res["eager_wall_ms_per_step"] else ""))
        for k, v in res["device_ms_per_step_by_class"].items():
            print(f"  {k:16s} {v:.4f} ms/step")
        for k, v in (res["device_ms_per_step_by_kernel_name"] or {}).items():
            print(f"  by name {k:16s} {v:.4f} ms/step")
        for k in res["top_kernels"]:
            print(f"  {k['ms_per_step']:.4f} ms/step "
                  f"x{k['calls_per_step']:7.1f} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
