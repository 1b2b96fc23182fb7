"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

These paths run here (seq2seq among them, ``models.seq2seq``):

* training the Transformer LM: ``build_lm`` through the Program / Executor
  API with Adam and global-norm clipping, on hand-written CUDA
  flash-attention forward and backward kernels
  (``ops/csrc/flash_attention.cu``)::

      import paddle_tpu_torch as fluid

      toks = fluid.layers.data("toks", [T], dtype="int32")
      labs = fluid.layers.data("labs", [T, 1], dtype="int32")
      loss, _ = fluid.models.build_lm(toks, labs, V, max_len=T)
      fluid.optimizer.Adam(1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(loss)
      exe = fluid.Executor()                   # the CUDA card; CPUPlace() for the host
      exe.run(fluid.default_startup_program())
      out, = exe.run(feed={...}, fetch_list=[loss])

* training the LSTM text classifier: ``models.text_lstm.build`` (2 x
  ``dynamic_lstm``) the same way, on hand-written CUDA LSTM forward and
  reverse-recurrence kernels (``ops/csrc/lstm.cu``);

* serving the LM: continuous batching over a paged KV pool, with a
  hand-written CUDA paged decode-attention kernel
  (``ops/csrc/paged_attention.cu``).

* training ResNet (``models.resnet.build``, Momentum, amp), with
  hand-written CUDA batch-norm backward kernels (``ops/csrc/batch_norm.cu``);

* ResNet inference: ``Program.prune`` gives the ``is_test`` program, and
  ``Executor.run`` routes its 3x3 stride-1 convolutions onto hand-written
  CUDA implicit-GEMM kernels, conv + folded batch norm + ReLU fused
  (``ops/csrc/conv.cu``, ``core/fusion.py``).

* semantic role labelling (``models.srl.db_lstm``: eight embeddings, stacked
  LSTMs of alternating direction on the LSTM kernels, a linear-chain CRF),
  trained by the CRF's NLL and Viterbi-decoded, on ``datasets.conll05``'s
  synthetic reader.

* the nested-sequence document classifier (``models.hier_text.build``: a
  word GRU inside each sentence under ``layers.NestedDynamicRNN``, a
  sentence RNN over the document), trained and served; with
  ``layers.cond``, ``while_loop``, ``IfElse``, the ``layers.nested``
  functions and ``layers.md_lstm``.

* the image classifiers beyond ResNet (``models.lenet``, ``smallnet``,
  ``vgg``, ``alexnet``, ``googlenet``) trained, and served from the pruned
  program with their 3x3 stride-1 convolutions on the conv kernels; the
  OCR line recognizer (``models.ocr_ctc``: convs, ``im2sequence``, a
  bidirectional GRU, CTC) trained and greedy-decoded; and ``nets``, the
  composite networks (``scaled_dot_product_attention`` on the flash
  kernels).

* the FCN segmenter (``models.fcn``: ``conv2d_transpose`` upsampling, a
  per-pixel softmax, on ``datasets.voc2012``'s synthetic masks) and the
  SSD detector (``models.ssd``: ``layers.detection``'s priors, multibox
  loss and decode + NMS, ``evaluator.DetectionMAP``), trained, and served
  from the pruned program with their 3x3 stride-1 convolutions on the conv
  kernels; with ``conv3d``, ``pool3d``, ``pool_with_index``, ``unpool``
  and ``spp``.

* the CTR models (``models.ctr``: wide&deep and DeepFM as programs, on
  ``datasets.ctr``'s synthetic clicks; ``layers.embedding(is_sparse=True)``
  through the sparse engine's lookup) and the sparse embedding engine
  (``sparse``: fused tables with host dedup to a bucket ladder, the
  row-touched optimizer apply, ``SparseFeeder``), trained by
  ``SparseEmbeddingTrainer``, one CUDA graph per bucket rung; with the
  Variable operator sugar, ``layers.misc`` and the evaluators.

* the v2 training loop ``Trainer`` (events, checkpoints and resume in the
  JAX package's layout, ``io.CheckpointManager``; the anomaly guard's skip
  and rollback; preemption and hang handling, ``resilience.cluster``) over
  ``reader`` decorators and ``datasets``, and the inference artifact
  (``io.save_inference_model``: ``torch.export`` of the pruned forward,
  the kernels as custom ops of the ``paddle_tpu_torch`` namespace).

Entry points run on the CUDA card unless the caller asks for the CPU
(``CPUPlace()``, ``device="cpu"``); with no card and no device given they
raise.  The package imports torch and numpy, never jax and nothing of
``paddle_tpu``.
"""
from . import (amp, backward, clip, compile, data_feeder, datasets,
               evaluator, events, flags, hooks, initializer, io, layers,
               learning_rate_decay, models, nets, optimizer, reader,
               regularizer, resilience, sparse, trainer)
from . import distributed, parallel
from ._device import card_info, resolve_device
from .data_feeder import DataFeeder, DeviceFeeder
from .trainer import AnomalyBudgetExceeded, SparseEmbeddingTrainer, Trainer
from .core import (CPUPlace, Executor, Place, Program, Scope,
                   Variable, default_main_program, default_startup_program,
                   global_scope, program_guard, reset_default_programs,
                   reset_global_scope)
from .models import (TransformerLM, from_jax_params, gather_scope,
                     init_lm_params, load_scope)
from .param_attr import ParamAttr
from .resilience import Deadline, DeadlineExceeded
from .serving import (AdmissionShed, ContinuousDecodeEngine,
                      ContinuousScheduler, DecodeAdmissionQueue,
                      DecodeEngine, DecodeRequest, GenerationMigrated,
                      PagedKVPool, PrefixCache, SamplingParams, chain_hashes,
                      root_for_kv_dtype)

__all__ = ["AdmissionShed", "AnomalyBudgetExceeded", "amp", "CPUPlace",
           "ContinuousDecodeEngine",
           "ContinuousScheduler", "DataFeeder", "Deadline",
           "DeadlineExceeded", "DecodeAdmissionQueue", "DecodeEngine",
           "DecodeRequest", "DeviceFeeder", "SparseEmbeddingTrainer",
           "Trainer", "compile", "data_feeder", "events", "flags", "io",
           "reader", "resilience", "sparse", "trainer",
           "Executor", "GenerationMigrated", "PagedKVPool", "ParamAttr",
           "Place", "PrefixCache", "Program", "SamplingParams", "Scope",
           "TransformerLM", "Variable", "chain_hashes", "root_for_kv_dtype",
           "backward", "card_info", "clip", "datasets", "default_main_program",
           "default_startup_program", "evaluator", "from_jax_params",
           "gather_scope",
           "global_scope",
           "hooks", "init_lm_params", "initializer", "layers",
           "learning_rate_decay", "load_scope", "models", "nets", "optimizer",
           "program_guard", "regularizer", "reset_default_programs",
           "reset_global_scope", "resolve_device"]
