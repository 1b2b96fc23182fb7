"""The port's models: the decoder-only Transformer LM's training graph and
serving math, the LSTM text classifier's training graph, the image
classifiers (LeNet, SmallNet, VGG, AlexNet, GoogLeNet, ResNet), seq2seq
with attention (training and beam generation), semantic role labelling
(db_lstm with a CRF, trained and Viterbi-decoded), the nested-sequence
document classifier (hier_text), the OCR line recognizer (ocr_ctc), the
FCN segmenter (fcn) and the SSD detector (ssd).  Not ported yet (ROADMAP
A.8, A.12): ctr, gan, recommender, traffic, vae and word2vec."""
from . import (alexnet, fcn, googlenet, hier_text, lenet, ocr_ctc, resnet,
               seq2seq, smallnet, srl, ssd, text_lstm, transformer, vgg)
from .resnet import (init_resnet_params, init_resnet_stats,
                     resnet_param_shapes)
from .text_lstm import init_text_lstm_params, text_lstm_param_shapes
from .transformer import (TransformerLM, build_lm, init_lm_params, lm_forward,
                          lm_head_logits, lm_paged_decode_window,
                          lm_param_shapes)
from .weights import from_jax_params, load_scope

__all__ = ["TransformerLM", "alexnet", "build_lm", "fcn", "from_jax_params",
           "googlenet", "hier_text", "init_lm_params", "lenet", "ocr_ctc",
           "smallnet", "vgg",
           "init_resnet_params", "init_resnet_stats", "init_text_lstm_params",
           "lm_forward", "lm_head_logits", "lm_paged_decode_window", "lm_param_shapes",
           "load_scope", "resnet", "resnet_param_shapes", "seq2seq", "srl", "ssd",
           "text_lstm", "text_lstm_param_shapes", "transformer"]
