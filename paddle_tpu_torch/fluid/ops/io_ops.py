"""Feed/fetch, checkpoint IO and print ops — the port of
``paddle_tpu/fluid/ops/io_ops.py``.

The reference moves data through FEED_MINIBATCH / FETCH_LIST variables
(feed_op.cc, fetch_op.cc) and checkpoints by running save/load ops
(save_op.cc, load_op.cc, save_combine_op.cc, load_combine_op.cc).  Here,
as in the JAX package, feed and fetch are markers the lowering skips
(``lowering.MARKER_OPS``: the executor wires feeds and fetches), kept so
an inference program saved by ``save_inference_model`` has the
reference's shape; save and load are host IO the executor runs outside
the step (``lowering.HOST_OPS``, ``executor._run_host_op``), so their
emitters here do nothing.

``print`` (print_op.cc) prints its input's message and value at every
step, as the reference's ``jax.debug.print`` does from inside its
compiled step.  A captured CUDA graph cannot print, so a program holding
``print`` is never captured: the executor runs it eagerly at every step
on the card (``BlockPlan.prints``), and the print's read of the value is
the one host sync it makes beside the fetch.  It reads slot ``X`` (the
reference's emitter) or ``In`` (what ``layers.Print`` writes; the
reference's emitter raises a ``KeyError`` on it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import OpInfo, register


def _identity_emit(ctx, ins):
    xs = ins.get("X", [])
    return {"Out": list(xs)}


register(OpInfo("feed", _identity_emit, no_grad=True))
register(OpInfo("fetch", _identity_emit, no_grad=True))
register(OpInfo("save", lambda ctx, ins: {}, no_grad=True))
register(OpInfo("load", lambda ctx, ins: {}, no_grad=True))
register(OpInfo("save_combine", lambda ctx, ins: {}, no_grad=True))
register(OpInfo("load_combine", lambda ctx, ins: {}, no_grad=True))


def _host_value(x):
    """``x``'s value on the host, the read allowed under the executor's
    sync guard (a CUDA graph cannot hold it)."""
    t = getattr(x, "data", x)
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if not t.is_cuda:
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("print reads its value on the host at every "
                           "step, which a CUDA graph cannot capture")
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _print_emit(ctx, ins):
    """print_op.cc: the message and the value, every step."""
    x = (ins.get("X") or ins.get("In"))[0]
    msg = ctx.attr("message", "")
    print(msg + " " + str(_host_value(x)), flush=True)
    return {"Out": [x]}


register(OpInfo("print", _print_emit, no_grad=True))
