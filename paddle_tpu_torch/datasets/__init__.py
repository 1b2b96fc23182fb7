"""Canned datasets (PyTorch port of the part of ``paddle_tpu/datasets`` the
ported models read): the synthetic halves of ``conll05`` (SRL),
``voc2012`` (FCN), ``imikolov`` (word2vec), ``movielens`` (the
recommender) and ``ctr`` (wide&deep, DeepFM).  The readers are numpy
only; the real-file readers wait for ROADMAP A.12 (rest)."""
from . import conll05, ctr, imikolov, movielens, voc2012

__all__ = ["conll05", "ctr", "imikolov", "movielens", "voc2012"]
