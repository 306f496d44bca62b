#!/usr/bin/env python3
"""Compare ways to sum repeated rows on one CUDA card: run to run, under
capture, and in time.

    python3 segment_sum_probe.py

For three shapes of an embedding gradient (the Transformer's word
table: 16,384 looked-up rows of 512 into 32,768; CTR wide&deep's deep
table: 1,024 rows of 16 into 1,000,001; both with ids drawn from a
Zipf(1.1) law and hashed over the table; and the Transformer's position
table at batch 64: each of 256 positions 64 times, into 257 rows and
the gradient's spare row): ``index_add_``,
``index_put_(accumulate=True)``, a first design of ``merge_rows`` (a
float64 running sum per column over the sorted rows, segments
differenced at their ends, then scattered into zeros), a second
(``sort_counts``: a stable sort, counts by ``index_add_``,
``segment_reduce`` by those lengths over the table's rows), PyTorch's
embedding backward (``aten.embedding_dense_backward``, which
``segment_sum`` called on the card until it was seen to differ run to
run on the position table), ``selected_rows.segment_sum`` (what the
port uses: a stable sort, ``segment_reduce`` of each run into its
last sorted slot, ``index_add_`` of the slots into zeros) and
``selected_rows.merge_rows`` (a sparse table's update: a stable sort,
offsets by ``searchsorted``, one ``segment_reduce`` over the N
slots).  For each: whether ten runs give the same bits, the
largest difference from a float64 sum on the host, and its time: CUDA
events around 20 eager calls after 3 warm-up calls (``ms``: the host's
launches included), and a CUDA graph of 20 calls replayed 5 times
after 3 (``graph_ms``: the device's time, as in a captured step; null
where the call cannot be captured); for ``segment_sum`` also whether
it runs under ``torch.cuda.set_sync_debug_mode("error")`` and inside a
CUDA graph.
Prints the card and one JSON line per shape.  Needs one CUDA card;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"transformer": (32768, 512, 16384), "ctr": (1000001, 16, 1024),
          "positions": (258, 512, 16384)}
REPEATS, TIMED, WARM, REPLAYS = 10, 20, 3, 5


def scan_merge_dense(torch, rows, values, height):
    """The first design: sort, a float64 running sum per column (on the
    transposed values), each segment's sum the difference of the running
    sum at its ends, scattered into a zeroed [height, D]."""
    n = rows.shape[0]
    order = torch.sort(rows, stable=True).indices
    r = rows[order]
    v = values[order]
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = r[1:] != r[:-1]
    last = torch.ones(n, dtype=torch.bool, device=rows.device)
    last[:-1] = new[1:]
    seg = torch.cumsum(new.long(), 0) - 1
    spare = torch.full_like(seg, n)
    csum = torch.cumsum(v.double().t().contiguous(), dim=1).t()
    before = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]])
    start = torch.zeros((n + 1, v.shape[1]), dtype=csum.dtype,
                        device=csum.device)
    start.index_copy_(0, torch.where(new, seg, spare), before)
    seg_sum = (csum - start[seg]).to(values.dtype)
    out = torch.zeros((height + 1, v.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_copy_(0, torch.where(last, r, height), seg_sum)
    return out[:height]


def sort_counts_dense(torch, rows, values, height):
    """A second design: a stable sort, each row's count by ``index_add_``
    (integers: exact in any order), ``segment_reduce`` by those lengths
    over the table's rows."""
    order = torch.sort(rows, stable=True).indices
    counts = torch.zeros(height, dtype=torch.int64, device=rows.device)
    counts.index_add_(0, rows, torch.ones_like(rows))
    return torch.segment_reduce(values[order], "sum", lengths=counts,
                                axis=0, unsafe=True)


def graph_ms(torch, fn):
    """Device time of one call: TIMED calls captured in one CUDA graph,
    the graph replayed WARM times, then timed over REPLAYS replays (no
    host launch cost in the replay).  None when the call cannot be
    captured (it reads the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(TIMED):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    for _ in range(WARM):
        graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPLAYS):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (REPLAYS * TIMED)
    del graph
    torch.cuda.empty_cache()
    return ms


def ms(torch, fn):
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(TIMED):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from paddle_tpu_torch.fluid.core.selected_rows import (SelectedRows,
                                                           merge_rows,
                                                           segment_sum)

    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    for name, (height, dim, n) in SHAPES.items():
        rng = np.random.RandomState(chip_smoke.SEED)
        rows_np = (rng.zipf(1.1, n) * 2654435761 % height).astype(np.int64)
        if name == "positions":
            rows_np = np.tile(np.arange(256), n // 256).astype(np.int64)
        vals_np = rng.randn(n, dim).astype(np.float32)
        rows = torch.tensor(rows_np, device=dev)
        vals = torch.tensor(vals_np, device=dev)
        exact = torch.zeros(height, dim, dtype=torch.float64).index_add_(
            0, torch.tensor(rows_np), torch.tensor(vals_np).double())
        ways = {
            "index_add": lambda: torch.zeros(
                height, dim, device=dev).index_add_(0, rows, vals),
            "index_put_accumulate": lambda: torch.zeros(
                height, dim, device=dev).index_put_((rows,), vals,
                                                    accumulate=True),
            "scan_merge": lambda: scan_merge_dense(torch, rows, vals,
                                                   height),
            "embedding_dense_backward": lambda: (
                torch.ops.aten.embedding_dense_backward(
                    vals, rows, height, -1, False)),
            "sort_counts": lambda: sort_counts_dense(torch, rows, vals,
                                                     height),
            "segment_sum": lambda: segment_sum(vals, rows, height),
            "merge_rows": lambda: merge_rows(
                SelectedRows(rows, vals, height)).values,
        }
        rec = {"height": height, "dim": dim, "rows": n,
               "distinct": int(len(np.unique(rows_np)))}
        for way, fn in ways.items():
            first = fn()
            rec[way] = {
                "repeat_bitwise": all(torch.equal(first, fn())
                                      for _ in range(REPEATS)),
                # merge_rows' N slots are not the dense table
                "max_abs_err_vs_f64": float(
                    (first.cpu().double() - exact).abs().max())
                if first.shape == exact.shape else None,
                "ms": ms(torch, fn), "graph_ms": graph_ms(torch, fn)}
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ways["segment_sum"]()
            rec["segment_sum"]["no_host_sync"] = True
        finally:
            torch.cuda.set_sync_debug_mode(old)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ways["segment_sum"]()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ways["segment_sum"]()
        graph.replay()
        torch.cuda.synchronize()
        rec["segment_sum"]["captured_equal"] = bool(
            torch.equal(captured, ways["segment_sum"]()))
        print(json.dumps({name: rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
