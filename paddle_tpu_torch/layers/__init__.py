"""Layer library (PyTorch port of the ``paddle_tpu/layers`` subset the
training slices use).  Of ``sequence``, the pooling, ``dynamic_lstm``,
``dynamic_gru``, ``lstm_unit`` and ``gru_unit`` are ported, of
``control_flow`` ``StaticRNN``, ``DynamicRNN`` and ``recompute``, and
``beam`` whole; the rest of ``sequence`` and ``control_flow`` (ROADMAP
A.7), the image layers beyond ``conv2d``, ``pool2d`` and ``batch_norm``
(A.11), the JAX package's other layers (detection, nested, misc) and the
Variable operator sugar (A.12) are not ported yet."""
from . import beam, control_flow, io, nn, ops, sequence, tensor
from .beam import beam_search, beam_search_decode  # noqa: F401
from .control_flow import DynamicRNN, StaticRNN, recompute  # noqa: F401
from .io import data  # noqa: F401
from .sequence import (dynamic_gru, dynamic_lstm, gru_unit,  # noqa: F401
                       lstm_unit, sequence_first_step, sequence_last_step,
                       sequence_pool)
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
