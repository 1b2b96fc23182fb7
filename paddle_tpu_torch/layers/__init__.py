"""Layer library (PyTorch port of the ``paddle_tpu/layers`` subset the
training slice uses).  The rest of the JAX package's layers (sequence,
control flow, detection, nested, beam, misc) and the Variable operator sugar
are ROADMAP A.6."""
from . import io, nn, ops, tensor
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
