"""Layer library (PyTorch port of the ``paddle_tpu/layers`` subset the
training slices use).  ``sequence`` and ``beam`` are ported whole; of
``tensor`` the elementwise add, ``mean``, ``sums``, ``reshape``,
``concat``, ``assign`` and the five reductions; of ``control_flow``
``StaticRNN``, ``DynamicRNN`` and ``recompute``.  Not ported yet:
``cond`` / ``while_loop`` / ``IfElse``, ``nested`` and ``mdlstm`` (ROADMAP
A.7), the image layers beyond ``conv2d``, ``pool2d`` and ``batch_norm``
(A.11), and the JAX package's other layers (detection, misc), the rest of
``tensor`` and ``nn`` and the Variable operator sugar (A.12)."""
from . import beam, control_flow, io, nn, ops, sequence, tensor
from .beam import beam_search, beam_search_decode  # noqa: F401
from .control_flow import DynamicRNN, StaticRNN, recompute  # noqa: F401
from .io import data  # noqa: F401
from .sequence import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
