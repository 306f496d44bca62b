"""Tensor creation and manipulation ops — the port of
``paddle_tpu/fluid/ops/tensor_ops.py``, cut to what the Transformer
(training, the unfused attention, the paged and dense serving steps and
beam search), the LSTM text classifiers, the book's first three
chapters, the reference's image benchmarks (``concat``: GoogLeNet's
inception towers), the embedding chapters (``lookup_table`` with its
sparse gradient), their backward, the optimizers and the learning-rate
schedules emit.

Random ops draw from a CPU ``torch.Generator`` seeded with the op's
seed (``EmitCtx.seed``, a Python int for these ``host_rng`` ops) and
copy to the device, so one seed gives the same values on every device;
during shape inference (``meta``) they draw nothing.  A host draw cannot
sit in a captured step (its values would be replayed), so the executor
runs a program that holds one eagerly once and refuses to replay it.  The reference's runtime narrows int64 and float64 to
int32 and float32, and so do these ops.
"""

from __future__ import annotations

import torch

from ..core.lod import SeqArray
from ..core.registry import primitive
from ..core.types import runtime_dtype, torch_dtype


def _rt_dtype(name) -> torch.dtype:
    return torch_dtype(runtime_dtype(name))


@primitive("fill_constant", inputs=[], no_grad=True)
def fill_constant(ctx, *_):
    return torch.full(tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
                      dtype=_rt_dtype(ctx.attr("dtype", "float32")),
                      device=ctx.device)


@primitive("fill_zeros_like", no_grad=True, seq_transparent=True)
def fill_zeros_like(ctx, x):
    return torch.zeros_like(x)


def _draw(ctx, fill):
    """``fill(cpu_tensor, generator)`` on a float32 CPU tensor of the op's
    shape, then cast and copy to the op's device."""
    shape = tuple(ctx.attr("shape"))
    dt = _rt_dtype(ctx.attr("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(shape, dtype=dt, device="meta")
    gen = torch.Generator()
    gen.manual_seed(int(ctx.seed))
    x = fill(torch.empty(shape, dtype=torch.float32), gen)
    return x.to(device=ctx.device, dtype=dt)


@primitive("uniform_random", inputs=[], no_grad=True, host_rng=True)
def uniform_random(ctx, *_):
    return _draw(ctx, lambda t, g: t.uniform_(ctx.attr("min", -1.0),
                                              ctx.attr("max", 1.0),
                                              generator=g))


@primitive("gaussian_random", inputs=[], no_grad=True, host_rng=True)
def gaussian_random(ctx, *_):
    return _draw(ctx, lambda t, g: t.normal_(generator=g)
                 * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0))


@primitive("cast", seq_transparent=True)
def cast(ctx, x):
    """reference tensor_ops.py cast: to ``out_dtype`` (64-bit types
    narrowed).  Its gradient, autograd's, casts back to X's dtype: the
    master gradient of a bf16 activation's f32 source stays f32."""
    return x.to(_rt_dtype(ctx.attr("out_dtype", "float32")))


@primitive("assign", seq_transparent=True)
def assign(ctx, x):
    return x


@primitive("concat", inputs=["X*"])
def concat(ctx, xs):
    """The inputs joined along ``axis`` (default 0); the gradient is
    autograd's, each input's slice of the output gradient."""
    return torch.cat(xs, dim=ctx.attr("axis", 0))


@primitive("reshape")
def reshape(ctx, x):
    """0 in the shape keeps that input dim, -1 is inferred."""
    shape = list(ctx.attr("shape"))
    return x.reshape([x.shape[i] if d == 0 else d
                      for i, d in enumerate(shape)])


def _ids(ids: torch.Tensor) -> torch.Tensor:
    """[..., 1] or [...] ids -> [...] int64 (torch indexes with int64)."""
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids.long()


@primitive("argmax", no_grad=True, seq_transparent=True)
def argmax(ctx, x):
    """Index of the largest value along ``axis`` (default the last), as
    int32; the first of tied maxima, as ``jnp.argmax`` picks."""
    return torch.argmax(x, dim=ctx.attr("axis", -1)).to(torch.int32)


@primitive("lookup_table", inputs=["W", "Ids"], stop_grad_slots=("Ids",))
def lookup_table(ctx, w, ids):
    """Embedding gather (reference lookup_table_op.cc); padding_idx rows
    are zero.  SeqArray ids give a SeqArray with their lengths.  The
    forward is the same for ``is_sparse``; only the gradient differs."""
    seq = isinstance(ids, SeqArray)
    idv = _ids(ids.data if seq else ids)
    out = w[idv]
    pad = ctx.attr("padding_idx", None)
    if pad is not None:
        out = torch.where((idv == pad)[..., None], 0.0, out)
    return ids.with_data(out) if seq else out


@primitive("lookup_table_grad", inputs=["W", "Ids", "Out@GRAD"],
           outputs=["W@GRAD"], no_grad=True)
def lookup_table_grad(ctx, w, ids, og):
    """Hand-written adjoint of lookup_table.  ``is_sparse=True`` returns a
    SelectedRows (rows: every looked-up id, a sequence's padding
    positions too, duplicates kept; values: the output gradients, zero
    at padding_idx and at padding positions), as the reference does: no
    [V, D] buffer is written.  Dense: that SelectedRows summed into
    [V, D] (``SelectedRows.to_dense``, a sorted segment sum without
    atomics), so the gradient is the same at every run."""
    from ..core.selected_rows import SelectedRows

    if isinstance(ids, SeqArray):
        ids = ids.data
    if isinstance(og, SeqArray):
        og = og.data
    rows = _ids(ids).reshape(-1)
    vals = og.reshape(-1, og.shape[-1])
    pad = ctx.attr("padding_idx", None)
    if pad is not None:
        vals = torch.where((rows == pad)[:, None], 0.0, vals)
    rows = rows.to(torch.int32)
    if ctx.attr("is_sparse", False):
        return SelectedRows(rows, vals, w.shape[0])
    return SelectedRows(rows, vals.to(w.dtype), w.shape[0]).to_dense()


@primitive("top_k", inputs=["X"], outputs=["Out", "Indices"], no_grad=True)
def top_k(ctx, x):
    """reference top_k_op.cc: the k largest values of the last axis and
    their int32 indices, equal values lower index first, as
    ``jax.lax.top_k`` orders them (``beam_ops.stable_top_k``)."""
    from .beam_ops import stable_top_k

    vals, idx = stable_top_k(x, ctx.attr("k", 1))
    return vals, idx.to(torch.int32)


@primitive("transpose")
def transpose(ctx, x):
    return x.permute(*ctx.attr("axis"))
