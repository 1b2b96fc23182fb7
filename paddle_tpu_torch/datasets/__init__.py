"""Canned datasets (PyTorch port of ``paddle_tpu/datasets``; ref:
python/paddle/v2/dataset/): numpy readers, each with a deterministic
synthetic generator with the real shapes and vocabulary of its namesake,
sample for sample the JAX package's, and a reader of the canonical files
when they are present under $PADDLE_TPU_DATA_HOME (``common``: the
download cache with md5 checks).  ``sk_real`` reads the tables that ship
with scikit-learn, imported at first use.  The real-file readers of
``conll05``, ``voc2012``, ``imikolov``, ``movielens`` and ``ctr`` are
ROADMAP A.12 part 4; their synthetic halves are here."""
from . import (cifar, common, conll05, ctr, flowers, imdb, imikolov, mnist,
               movielens, mq2007, sentiment, sk_real, uci_housing, voc2012,
               wmt_toy)

__all__ = ["cifar", "common", "conll05", "ctr", "flowers", "imdb",
           "imikolov", "mnist", "movielens", "mq2007", "sentiment",
           "sk_real", "uci_housing", "voc2012", "wmt_toy"]
