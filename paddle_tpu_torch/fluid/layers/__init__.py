"""fluid.layers — the port of ``paddle_tpu/fluid/layers``, cut to the
layers the Transformer, the LSTM text classifiers, the book's first
three chapters and the reference's image benchmarks build.  Control
flow and the tensor-creation layers are not ported."""

from . import io, nn, ops, recurrent, sequence, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .recurrent import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
