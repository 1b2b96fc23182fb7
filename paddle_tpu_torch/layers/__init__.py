"""Layer library (PyTorch port of ``paddle_tpu/layers``).  ``ops``,
``tensor``, ``nn``, ``sequence``, ``beam``, ``control_flow``
(``StaticRNN``, ``DynamicRNN``, ``cond``, ``while_loop``, ``IfElse``,
``recompute``), ``nested``, ``mdlstm`` and ``detection`` are ported whole:
every function of the reference's ``ops.py``, ``tensor.py`` and
``nn.py`` has its counterpart here, the random layers
(``gaussian_random``, ``uniform_random``, ``sampling_id``, ``nce``,
``dropout``) drawing JAX's numbers from the op's key.  Not ported yet:
the misc layers and the Variable operator sugar (ROADMAP A.12 part 2)."""
from . import (beam, control_flow, detection, io, mdlstm, nested, nn, ops,
               sequence, tensor)
from .beam import beam_search, beam_search_decode  # noqa: F401
from .control_flow import (DynamicRNN, IfElse, StaticRNN, cond,  # noqa: F401
                           recompute, while_loop)
from .detection import *  # noqa: F401,F403
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
