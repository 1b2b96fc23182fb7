"""Layer library (PyTorch port of ``paddle_tpu/layers``).  ``sequence``,
``beam``, ``control_flow`` (``StaticRNN``, ``DynamicRNN``, ``cond``,
``while_loop``, ``IfElse``, ``recompute``), ``nested``, ``mdlstm`` and
``detection`` are ported whole; of ``tensor`` the seven elementwise ops,
``matmul``, ``mul``, ``mean``, ``sums``, ``reshape``, ``transpose``,
``concat``, ``split``, ``stack``, ``squeeze``, ``unsqueeze``, ``assign``,
the five reductions, ``cast``, ``scale``, ``fill_constant``,
``fill_constant_batch_size_like``, ``argmax`` and the five compares; of
``nn`` the layers of the LM, the RNN models and the image models (``fc``,
``embedding``, ``conv2d``, ``conv2d_transpose``, ``conv3d``, ``pool2d``,
``pool3d``, ``pool_with_index``, ``unpool``, ``spp``, ``batch_norm``,
``layer_norm``, ``lrn``, ``dropout``, the losses and ``accuracy``).  Not
ported yet: ``hsigmoid`` and the rest of ``tensor`` and ``nn`` (ROADMAP
A.12 part 1), and the misc layers and the Variable operator sugar
(A.12)."""
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
