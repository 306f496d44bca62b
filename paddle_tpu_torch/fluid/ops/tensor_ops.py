"""Tensor creation and manipulation ops — the port of
``paddle_tpu/fluid/ops/tensor_ops.py``, cut to what the Transformer
(training, the unfused attention, the paged and dense serving steps and
beam search), the LSTM text classifiers, the book's chapters through
machine translation (``fill_constant_batch_size_like``, ``squeeze``,
``unsqueeze``, ``expand``: the seq2seq beam decoders), the reference's
image benchmarks (``concat``: GoogLeNet's inception towers), the
embedding chapters (``lookup_table`` with its sparse gradient), their
backward, the optimizers and the learning-rate schedules emit, and the
general tensor ops (``gather``, ``scatter``, ``slice``, ``split``,
``one_hot``, ``shape``, ``multiplex``, ``truncated_gaussian_random``).
``gather``'s gradient and ``scatter``'s adding form sum repeated ids
with the fixed-order ``segment_sum``, never ``index_add_`` (atomics on
the card: a sum that changes from run to run).

Random ops draw from a CPU ``torch.Generator`` seeded with the op's
seed (``EmitCtx.seed``, a Python int for these ``host_rng`` ops) and
copy to the device, so one seed gives the same values on every device;
during shape inference (``meta``) they draw nothing.  A host draw cannot
sit in a captured step (its values would be replayed), so the executor
runs a program that holds one eagerly once and refuses to replay it.
The reference's runtime narrows int64 and float64 to int32 and float32,
and so do these ops.
"""

from __future__ import annotations

import math

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


@primitive("fill_constant_batch_size_like", inputs=["Input"], no_grad=True)
def fill_constant_batch_size_like(ctx, ref):
    """A constant of ``shape`` whose ``output_dim_idx`` dim copies the
    ``input_dim_idx`` dim of Input (reference
    fill_constant_batch_size_like_op.cc)."""
    data = ref.data if isinstance(ref, SeqArray) else ref
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        data.shape[ctx.attr("input_dim_idx", 0)]
    return torch.full(tuple(shape), ctx.attr("value", 0.0),
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


@primitive("squeeze")
def squeeze(ctx, x):
    """The size-1 dims at ``axes`` (every size-1 dim without) dropped."""
    axes = ctx.attr("axes", None)
    return x.squeeze(tuple(axes)) if axes else x.squeeze()


@primitive("unsqueeze")
def unsqueeze(ctx, x):
    """A size-1 dim inserted at each of ``axes``, in ascending order."""
    for ax in sorted(ctx.attr("axes")):
        x = x.unsqueeze(ax)
    return x


@primitive("expand")
def expand(ctx, x):
    """X tiled ``expand_times[i]`` times along dim i (``jnp.tile``); the
    gradient sums the tiles."""
    return torch.tile(x, tuple(ctx.attr("expand_times")))


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


def _normal_truncated(t: torch.Tensor, gen: torch.Generator, lo=-2.0,
                      hi=2.0) -> torch.Tensor:
    """``t`` filled with standard normal draws truncated to [lo, hi], by
    the inverse CDF of uniform draws between the bounds' CDFs (as
    ``torch.nn.init.trunc_normal_`` draws them)."""
    cdf = [0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (lo, hi)]
    t.uniform_(2 * cdf[0] - 1, 2 * cdf[1] - 1, generator=gen)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)


@primitive("truncated_gaussian_random", inputs=[], no_grad=True,
           host_rng=True)
def truncated_gaussian_random(ctx, *_):
    """Normal draws truncated to two standard deviations, then scaled by
    ``std`` and shifted by ``mean`` (``jax.random.truncated_normal(-2,
    2)``'s distribution; the bits are the host generator's)."""
    return _draw(ctx, lambda t, g: _normal_truncated(t, g)
                 * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0))


class _TakeRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose gradient sums repeated ids'
    rows with ``segment_sum`` (in index order, the same bits at every
    run: autograd's own adjoint, ``aten.embedding_dense_backward``, is
    not deterministic on the card where ids repeat many times)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        from ..core.selected_rows import segment_sum

        idx, = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.rows), None


def take_rows(table, idx):
    """table[idx] along axis 0 (any trailing shape), as an embedding
    lookup: its gradient is ``segment_sum``'s fixed-order sum of repeated
    ids' rows."""
    flat = _TakeRows.apply(table.reshape(table.shape[0], -1),
                           idx.reshape(-1).long())
    return flat.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


@primitive("gather", inputs=["X", "Index"], stop_grad_slots=("Index",))
def gather(ctx, x, index):
    """Rows of X by Index (reference gather_op.cc), ids in [0, rows)
    (``take_rows``)."""
    return take_rows(x, index.reshape(-1))


@primitive("scatter", inputs=["X", "Ids", "Updates"],
           stop_grad_slots=("Ids",))
def scatter(ctx, x, ids, updates):
    """X with the rows at Ids replaced by (``overwrite``, the default)
    or increased by the rows of Updates.  Adding sums repeated ids'
    updates first, in a fixed order (``segment_sum``, whose adjoint
    gathers the output gradient's rows).  Overwriting
    with a repeated id is left open by the reference (``.at[].set``
    picks one of the updates, which one is not specified), and so here:
    give each row one update."""
    from ..core.selected_rows import segment_sum

    ids = ids.reshape(-1).long()
    if ctx.attr("overwrite", True):
        return x.index_put((ids,), updates.to(x.dtype))
    return x + segment_sum(updates.to(x.dtype), ids, x.shape[0])


@primitive("slice")
def slice_op(ctx, x):
    """reference slice_op.cc: ``x[starts:ends]`` along each of ``axes``,
    negative bounds counted from the end and clamped, as Python slices
    are."""
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        idx[ax] = slice(st, en)
    return x[tuple(idx)]


@primitive("split", inputs=["X"], outputs=["Out"])
def split(ctx, x):
    """X cut along ``axis`` into ``sections`` sizes, or ``num`` equal
    parts (reference split_op.cc); the gradient joins the parts'."""
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", None)
    if sections:
        return list(torch.split(x, list(sections), dim=axis))
    num = ctx.attr("num", 0)
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                         f"does not divide into {num} equal parts")
    return list(torch.split(x, x.shape[axis] // num, dim=axis))


@primitive("one_hot", no_grad=True)
def one_hot(ctx, x):
    """float32 [..., depth] rows, 1 at each id; an id outside [0, depth)
    gives a row of zeros, as ``jax.nn.one_hot`` does (a comparison with
    ``arange(depth)``: no range check, no host sync)."""
    ids = _ids(x)
    depth = ctx.attr("depth")
    return (ids[..., None] == torch.arange(depth, device=ids.device)
            ).to(torch.float32)


@primitive("shape", no_grad=True)
def shape_op(ctx, x):
    """X's shape as an int32 vector, written by fills on the device (no
    host copy)."""
    out = torch.empty(len(x.shape), dtype=torch.int32, device=ctx.device)
    for i, d in enumerate(x.shape):
        out[i] = d
    return out


@primitive("multiplex", inputs=["Ids", "X*"], stop_grad_slots=("Ids",))
def multiplex(ctx, ids, xs):
    """Row i of the output is row i of X[Ids[i]] (reference
    multiplex_op.cc)."""
    stacked = torch.stack(xs, dim=0)                   # [n, batch, ...]
    rows = ids.reshape(-1).long()
    return stacked[rows, torch.arange(stacked.shape[1], device=rows.device)]
