"""fluid.layers — the port of ``paddle_tpu/fluid/layers``, cut to the
layers the Transformer training program builds.  Control flow,
recurrent, sequence and tensor-creation layers are not ported."""

from . import io, nn, ops  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
