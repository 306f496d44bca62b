"""fluid.layers — the port of ``paddle_tpu/fluid/layers``, cut to the
layers the Transformer and the LSTM text classifiers build.  Control
flow and tensor-creation layers are not ported."""

from . import io, nn, ops, recurrent, sequence  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .recurrent import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
