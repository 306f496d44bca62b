"""fluid.layers — the port of ``paddle_tpu/fluid/layers``, cut to the
layers the Transformer, the LSTM text classifiers, the book's chapters
through machine translation (control flow: While, StaticRNN,
DynamicRNN, Switch, IfElse and the tensor arrays), the reference's
image benchmarks, CTC speech recognition, SSD detection, Fast R-CNN
and learning to rank build."""

from . import (control_flow, io, nn, ops, recurrent,  # noqa: F401
               sequence, tensor)
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .recurrent import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
