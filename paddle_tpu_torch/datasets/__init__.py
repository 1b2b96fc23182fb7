"""Canned datasets (PyTorch port of the part of ``paddle_tpu/datasets`` the
ported models read): ``conll05``'s synthetic reader, for the SRL model,
and ``voc2012``'s synthetic masks, for FCN.  The readers are numpy only;
the real-file readers wait for ROADMAP A.12."""
from . import conll05, voc2012

__all__ = ["conll05", "voc2012"]
