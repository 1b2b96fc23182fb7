"""The port's models: the decoder-only Transformer LM's training graph and
serving math, the LSTM text classifier's training graph, the image
classifiers (LeNet, SmallNet, VGG, AlexNet, GoogLeNet, ResNet), seq2seq
with attention (training and beam generation), semantic role labelling
(db_lstm with a CRF, trained and Viterbi-decoded), the nested-sequence
document classifier (hier_text), the OCR line recognizer (ocr_ctc), the
FCN segmenter (fcn), the SSD detector (ssd), and the book and demo
models word2vec, recommender, traffic, gan and vae, and the CTR models
(ctr: wide&deep and DeepFM as programs, and the sparse engine's fused
wide&deep arm).  All twenty model families of the JAX package."""
from . import (alexnet, ctr, fcn, gan, googlenet, hier_text, lenet, ocr_ctc,
               recommender, resnet, seq2seq, smallnet, srl, ssd, text_lstm,
               traffic, transformer, vae, vgg, word2vec)
from .resnet import (init_resnet_params, init_resnet_stats,
                     resnet_param_shapes)
from .text_lstm import init_text_lstm_params, text_lstm_param_shapes
from .transformer import (TransformerLM, build_lm, init_lm_params, lm_forward,
                          lm_head_logits, lm_paged_decode_window,
                          lm_param_shapes)
from .weights import from_jax_params, gather_scope, load_scope

__all__ = ["TransformerLM", "alexnet", "build_lm", "ctr", "fcn",
           "from_jax_params", "gather_scope",
           "gan", "googlenet", "hier_text", "init_lm_params", "lenet",
           "ocr_ctc", "recommender", "smallnet", "traffic", "vae", "vgg",
           "word2vec",
           "init_resnet_params", "init_resnet_stats", "init_text_lstm_params",
           "lm_forward", "lm_head_logits", "lm_paged_decode_window", "lm_param_shapes",
           "load_scope", "resnet", "resnet_param_shapes", "seq2seq", "srl", "ssd",
           "text_lstm", "text_lstm_param_shapes", "transformer"]
