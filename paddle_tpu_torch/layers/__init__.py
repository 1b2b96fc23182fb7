"""Layer library (PyTorch port of the ``paddle_tpu/layers`` subset the
training slices use).  Of ``sequence``, the pooling and ``dynamic_lstm``
are ported; the rest of it (ROADMAP A.7), the image layers beyond
``conv2d``, ``pool2d`` and ``batch_norm`` (A.11), control flow beyond
``recompute`` (A.7), the JAX package's other layers (detection, nested,
beam, misc) and the Variable operator sugar (A.12) are not ported yet."""
from . import control_flow, io, nn, ops, sequence, tensor
from .control_flow import recompute  # noqa: F401
from .io import data  # noqa: F401
from .sequence import (dynamic_lstm, sequence_first_step,  # noqa: F401
                       sequence_last_step, sequence_pool)
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
