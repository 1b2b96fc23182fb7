"""Layer library (PyTorch port of the ``paddle_tpu/layers`` subset the
training slices use).  ``sequence``, ``beam``, ``control_flow``
(``StaticRNN``, ``DynamicRNN``, ``cond``, ``while_loop``, ``IfElse``,
``recompute``), ``nested`` and ``mdlstm`` are ported whole; of ``tensor``
the elementwise add, ``mean``, ``sums``, ``reshape``, ``concat``,
``assign``, the five reductions, ``cast``, ``scale``, ``fill_constant``
and ``fill_constant_batch_size_like``.  Not ported yet: the image layers
beyond ``conv2d``, ``pool2d`` and ``batch_norm`` (ROADMAP A.11), and the
JAX package's other layers (detection, misc), the rest of ``tensor`` and
``nn`` and the Variable operator sugar (A.12)."""
from . import (beam, control_flow, io, mdlstm, nested, nn, ops, sequence,
               tensor)
from .beam import beam_search, beam_search_decode  # noqa: F401
from .control_flow import (DynamicRNN, IfElse, StaticRNN, cond,  # noqa: F401
                           recompute, while_loop)
from .io import data  # noqa: F401
from .mdlstm import md_lstm  # noqa: F401
from .nested import (NestedDynamicRNN, nested_sequence_expand,  # noqa: F401
                     nested_sequence_first_step, nested_sequence_last_step,
                     nested_sequence_pool, nested_sequence_select,
                     nested_to_flat)
from .sequence import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
