"""Fused LSTM forward — the port of ``tools/lstm_probe.py``'s TPU kernel
``_cell_kernel``, over the whole contract of the ``dynamic_lstm`` op
(``paddle_tpu/fluid/ops/rnn_ops.py``).

``lstm_forward`` runs the forward time loop: for CUDA tensors it launches
``csrc/lstm_fwd.cu`` once for all T steps (counted in
``lstm_forward.launches``); for CPU tensors it runs ``lstm_forward_plain``,
a per-step PyTorch loop with the op's exact semantics.  Anything else
raises: nothing falls back.  ``dynamic_lstm`` wraps it in the autograd
Function ``_DynamicLSTM``, whose backward is plain PyTorch on every
device (``lstm_backward_plain``): the JAX package has no backward kernel
either, its gradient is the generic vjp of the scan.

Semantics (the op's): x [B, T, 4H] is the pre-projected input, w [H, 4H]
the recurrence, gate blocks in the order c~, i, f, o; bias [4H], or [7H]
with the peepholes w_ic, w_fc, w_oc.  Past a row's length the carry is
frozen and the outputs are 0; ``is_reverse`` walks the padded time axis
backwards, so a right-padded row sees its padding first, with the carry
held at its initial value.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["KERNEL_NAME", "ACTIVATIONS", "lstm_forward", "lstm_forward_plain",
           "lstm_backward_plain", "lstm_plan", "device_plan", "device_limits",
           "dynamic_lstm"]

KERNEL_NAME = "lstm_fwd"
# activation name -> the kernel's code (the order of rnn_ops._ACTS)
ACTIVATIONS = {"sigmoid": 0, "tanh": 1, "relu": 2, "identity": 3}


def _act(name):
    if name not in ACTIVATIONS:
        raise ValueError(f"dynamic_lstm: unknown activation {name!r}; "
                         f"expected one of {sorted(ACTIVATIONS)}")
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda v: v}[name]


def _act_grad(name, y, v):
    """d act(v) / dv from the output y (and the input v for relu)."""
    if name == "sigmoid":
        return y * (1 - y)
    if name == "tanh":
        return 1 - y * y
    if name == "relu":
        return (v > 0).to(y.dtype)
    return torch.ones_like(y)


def _split_bias(bias, H: int, use_peepholes: bool):
    b = bias.reshape(-1)
    peep = ((b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:7 * H])
            if use_peepholes else None)
    return b[:4 * H], peep


def _mask(lengths, T: int, dtype):
    """[B, T, 1] validity mask, 1 inside each row's length."""
    pos = torch.arange(T, dtype=torch.int32, device=lengths.device)
    keep = pos[None, :] < lengths.to(torch.int32)[:, None]
    return keep.to(dtype)[..., None]


def lstm_forward_plain(x, w, bias, lengths, h0=None, c0=None,
                       use_peepholes=True, is_reverse=False,
                       gate_activation="sigmoid", cell_activation="tanh",
                       candidate_activation="tanh", matmul=torch.matmul):
    """The forward as a per-step loop, the counterpart of the reference's
    ``_scan_seq`` + ``dynamic_lstm`` step -> (h, c), each [B, T, H].
    ``matmul`` computes the recurrent product h @ w (a test passes a
    rounded product to see what the kernel's tensor-core arithmetic
    does over T steps)."""
    B, T, _ = x.shape
    H = w.shape[0]
    ga, ca, cda = (_act(gate_activation), _act(cell_activation),
                   _act(candidate_activation))
    gate_bias, peep = _split_bias(bias, H, use_peepholes)
    h = h0 if h0 is not None else x.new_zeros(B, H)
    c = c0 if c0 is not None else x.new_zeros(B, H)
    m = _mask(lengths, T, x.dtype)
    hs, cs = [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        gates = x[:, t] + matmul(h, w) + gate_bias
        gc, gi, gf, go = gates.split(H, dim=-1)
        if peep is not None:
            gi = gi + peep[0] * c
            gf = gf + peep[1] * c
        c_new = ga(gf) * c + ga(gi) * cda(gc)
        if peep is not None:
            go = go + peep[2] * c_new
        h_new = ga(go) * ca(c_new)
        mt = m[:, t]
        hs[t], cs[t] = h_new * mt, c_new * mt
        h = mt * h_new + (1 - mt) * h
        c = mt * c_new + (1 - mt) * c
    return torch.stack(hs, 1), torch.stack(cs, 1)


# The kernel's work split (csrc/lstm_fwd.cu).  A block of THREADS threads
# owns k hidden units (all four gates) for Bs batch rows.  Its warps form
# a wm x wn grid: each owns one 16-row m-tile of the block's rows and ntw
# n-tiles of 8 columns (2 units x 4 gates) of the [H, 4k] weight slice.
THREADS, WARPS, MAX_TILES, MAX_STAGES = 256, 8, 8, 16
CHUNKS = (64, 32, 16)           # h columns a ring slot stages, largest first
# the order in which the C entry point reads the plan
PLAN_FIELDS = ("k", "nh", "nb", "Bs", "wm", "wn", "ntw", "kc", "stages",
               "hp", "kp", "w_smem", "ring_off", "stage_floats", "smem",
               "grid")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ring(bsp: int, H: int, n: int, w_smem: bool, smem_max: int):
    """The ring of h chunks in the shared memory left beside the weight
    slice, or None when fewer than two slots fit: the widest chunk kc
    (fewer block barriers, longer runs of products between them) that
    keeps two chunks in flight ahead of the one being multiplied, or
    all of them, or else as many as fit.  hp is H rounded up to kc: the
    h buffer's row pitch; kp = hp + 4 the row pitch of the n-major slice
    (4 mod 8 words: its ldmatrix reads are free of bank conflicts)."""
    best = None
    for kc in CHUNKS:
        hp = _cdiv(H, kc) * kc
        ring_off = n * (hp + 4) if w_smem else 0
        stage = bsp * kc              # rows unpadded (XOR-swizzled)
        stages = min(MAX_STAGES, hp // kc + 1,
                     (smem_max // 4 - ring_off) // stage)
        if stages < 2:
            continue
        key = (min(stages - 1, 2, hp // kc), kc)
        if best is None or key > best[0]:
            best = (key, dict(kc=kc, stages=stages, hp=hp, kp=hp + 4,
                              ring_off=ring_off, stage_floats=stage,
                              smem=4 * (ring_off + stages * stage)))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def _plan(B: int, H: int, sms: int, smem_max: int):
    best, best_cost = None, None
    for k in range(2, 2 * WARPS * MAX_TILES + 1, 2):
        nh = _cdiv(H, k)
        if nh > sms or (k > 2 and _cdiv(H, k - 2) == nh):
            continue                  # too many blocks, or padding only
        n = 4 * k
        for bs in sorted({_cdiv(B, nb) for nb in range(1, B + 1)}):
            nb = _cdiv(B, bs)
            mt = _cdiv(bs, 16)
            if nh * nb > sms or mt > WARPS:
                continue
            wn = WARPS // mt
            ntw = _cdiv(k // 2, wn)
            if ntw > MAX_TILES:
                continue
            for w_smem in (1, 0):
                ring = _ring(16 * mt, H, n, bool(w_smem), smem_max)
                if ring is not None:
                    break
            if ring is None:
                continue
            hp = ring["hp"]
            # w resident first (from L2 it costs 4H^2 floats a step per
            # batch group); then the longest product a warp runs; then the
            # fewest bytes the grid reads from L2 a step; then the smaller
            # grid and shared memory
            l2 = nh * nb * (16 * mt * hp + (1 - w_smem) * hp * n)
            cost = (1 - w_smem, ntw * hp, l2, nh * nb, ring["smem"])
            if best is None or cost < best_cost:
                best_cost = cost
                best = dict(k=k, nh=nh, nb=nb, Bs=bs, wm=mt, wn=wn, ntw=ntw,
                            w_smem=w_smem, grid=nh * nb, **ring)
    return best


def lstm_plan(B: int, H: int, sms: int, smem_max: int) -> dict:
    """The kernel's work split for B rows and H units on a card with
    ``sms`` SMs and ``smem_max`` bytes of shared memory a block: units
    per block k and unit groups nh, batch groups nb of Bs rows, the warp
    grid wm x wn and n-tiles per warp ntw, the h ring (chunk kc columns,
    stages, h row pitch hp), the weight slice's row pitch kp and whether
    it sits in shared memory, the shared-memory layout and bytes, and the
    grid (at most one block per SM: the launch is cooperative).  Raises
    ValueError when no split fits."""
    plan = _plan(int(B), int(H), int(sms), int(smem_max))
    if plan is None:
        raise ValueError(f"lstm_fwd: no work split for B={B}, H={H} fits "
                         f"{sms} SMs and {smem_max} bytes of shared memory")
    return dict(plan)


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    """The C entry points, built and bound at first use."""
    from ._build import load_library

    lib = load_library(KERNEL_NAME)
    fn = lib.lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    limits = lib.lstm_fwd_limits
    limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
    limits.restype = ctypes.c_int
    return fn, limits


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(SMs, shared memory a block may opt into, in bytes) of card
    ``index``, as the CUDA runtime reports them."""
    _, limits = _kernel_fn()
    out = (ctypes.c_int * 2)()
    err = limits(int(index), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"lstm_fwd: cannot query card {index} (CUDA "
                           f"error {err})")
    return out[0], out[1]


def device_plan(B: int, H: int, device) -> dict:
    """``lstm_plan`` for the card that holds ``device``."""
    return lstm_plan(B, H, *device_limits(torch.device(device).index or 0))


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"lstm_forward (CUDA kernel): {what}")


def _lstm_cuda(x, w, bias, lengths, h0, c0, use_peepholes, is_reverse,
               gate_activation, cell_activation, candidate_activation):
    """Validate and launch the kernel on the current stream -> (h, c)."""
    B, T, G = x.shape
    H = w.shape[0]
    dev = x.device
    _check(tuple(w.shape) == (H, 4 * H) and G == 4 * H,
           f"x [B, T, 4H] and w [H, 4H] expected, got {tuple(x.shape)} and "
           f"{tuple(w.shape)}")
    _check(bias.numel() == (7 if use_peepholes else 4) * H,
           f"bias must hold {7 if use_peepholes else 4}*H values, got "
           f"{bias.numel()}")
    _check(tuple(lengths.shape) == (B,) and lengths.dtype == torch.int32,
           "lengths must be int32 [B]")
    tensors = [x, w, bias, lengths]
    for s in (h0, c0):
        if s is not None:
            _check(tuple(s.shape) == (B, H) and s.dtype == torch.float32,
                   "h0 / c0 must be float32 [B, H]")
            tensors.append(s)
    for t in tensors:
        _check(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    _check(w.dtype == torch.float32 and bias.dtype == torch.float32,
           "w and bias must be float32")
    h = torch.empty(B, T, H, dtype=torch.float32, device=dev)
    c = torch.empty_like(h)
    if B * T * H == 0:
        return h, c
    fn, _ = _kernel_fn()
    plan = device_plan(B, H, dev)
    # h_{t-1} double buffer, rows padded to hp with zeros the kernel never
    # writes; one step counter per batch group
    hbuf = torch.zeros(2, B, plan["hp"], dtype=torch.float32, device=dev)
    counters = torch.zeros(plan["nb"], dtype=torch.int32, device=dev)
    packed = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[f]
                                                 for f in PLAN_FIELDS))
    bias = bias.reshape(-1)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 bias[4 * H:].data_ptr() if use_peepholes else None,
                 ptr(h0), ptr(c0), lengths.data_ptr(), h.data_ptr(),
                 c.data_ptr(), hbuf.data_ptr(), counters.data_ptr(), B, T, H,
                 int(is_reverse), ACTIVATIONS[gate_activation],
                 ACTIVATIONS[cell_activation],
                 ACTIVATIONS[candidate_activation], ctypes.addressof(packed),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd launch failed: CUDA error {err} (B={B}, "
                           f"T={T}, H={H}, plan {plan})")
    lstm_forward.launches += 1
    return h, c


def lstm_forward(x, w, bias, lengths, h0=None, c0=None, *,
                 use_peepholes: bool = True, is_reverse: bool = False,
                 gate_activation: str = "sigmoid",
                 cell_activation: str = "tanh",
                 candidate_activation: str = "tanh"):
    """The LSTM forward time loop -> (h, c), each [B, T, H].

    x [B, T, 4H] float32, w [H, 4H], bias [4H] or [7H] (peepholes),
    lengths [B] int32, optional h0 / c0 [B, H].  CUDA tensors launch the
    fused kernel once (counted in ``lstm_forward.launches``); CPU tensors
    run ``lstm_forward_plain``.  Only float32 is ported: the reference's
    ``amp_dtype`` (bf16 activations) is not."""
    if x.dtype != torch.float32:
        raise NotImplementedError(f"lstm_forward: dtype {x.dtype} (the "
                                  "reference's amp_dtype) is not ported; "
                                  "float32 only")
    for name in (gate_activation, cell_activation, candidate_activation):
        _act(name)
    cfg = dict(use_peepholes=use_peepholes, is_reverse=is_reverse,
               gate_activation=gate_activation,
               cell_activation=cell_activation,
               candidate_activation=candidate_activation)
    if x.device.type == "cpu":
        return lstm_forward_plain(x, w, bias, lengths, h0, c0, **cfg)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_forward: unsupported device {x.device}")
    return _lstm_cuda(x, w, bias, lengths, h0, c0, **cfg)


lstm_forward.launches = 0            # kernel launches, CUDA path only


def lstm_backward_plain(dh_out, dc_out, x, w, bias, lengths, h0, c0, h, c,
                        use_peepholes=True, is_reverse=False,
                        gate_activation="sigmoid", cell_activation="tanh",
                        candidate_activation="tanh"):
    """Gradients of the forward w.r.t. (x, w, bias, h0, c0) from those of
    its outputs (h, c), given the outputs themselves.

    The gate pre-activations are recomputed with one batched product,
    x + h_prev @ w + bias as [B*T, H] x [H, 4H], where h_prev is the
    carry each step saw (the neighbouring output inside the row's length,
    else the initial state).  Then one serial pass over T carries dh and
    dc through the peepholes and the masks, with one [B, 4H] x [4H, H]
    product a step; dw, the bias and the peepholes' gradients are one
    product or sum each.  dh0 / dc0 are None when h0 / c0 are."""
    B, T, _ = x.shape
    H = w.shape[0]
    ga, ca, cda = (_act(gate_activation), _act(cell_activation),
                   _act(candidate_activation))
    gate_bias, peep = _split_bias(bias, H, use_peepholes)
    h_init = (h0 if h0 is not None else x.new_zeros(B, H))[:, None]
    c_init = (c0 if c0 is not None else x.new_zeros(B, H))[:, None]
    m = _mask(lengths, T, x.dtype)                        # [B, T, 1]
    none = torch.zeros_like(m[:, :1])
    if is_reverse:           # step t follows t + 1
        prev_ok = torch.cat([m[:, 1:], none], 1)
        h_nb = torch.cat([h[:, 1:], h_init], 1)
        c_nb = torch.cat([c[:, 1:], c_init], 1)
    else:
        prev_ok = torch.cat([none, m[:, :-1]], 1)
        h_nb = torch.cat([h_init, h[:, :-1]], 1)
        c_nb = torch.cat([c_init, c[:, :-1]], 1)
    hp = torch.where(prev_ok > 0, h_nb, h_init)
    cp = torch.where(prev_ok > 0, c_nb, c_init)

    a = (x + torch.matmul(hp.reshape(-1, H), w).reshape(B, T, 4 * H)
         + gate_bias)
    ac, ai, af, ao = a.split(H, dim=-1)
    if peep is not None:
        ai = ai + peep[0] * cp
        af = af + peep[1] * cp
    i, f, cc = ga(ai), ga(af), cda(ac)
    cn = f * cp + i * cc
    if peep is not None:
        ao = ao + peep[2] * cn
    o = ga(ao)
    tc = ca(cn)
    # the factors that do not depend on the carried gradients
    k_hc = o * _act_grad(cell_activation, tc, cn)          # dh -> dc
    k_ho = tc * _act_grad(gate_activation, o, ao)          # dh -> da_o
    k_ci = cc * _act_grad(gate_activation, i, ai)          # dc -> da_i
    k_cf = cp * _act_grad(gate_activation, f, af)          # dc -> da_f
    k_cc = i * _act_grad(candidate_activation, cc, ac)     # dc -> da_c~

    dh_out = torch.zeros_like(h) if dh_out is None else dh_out
    dc_out = torch.zeros_like(c) if dc_out is None else dc_out
    dh = x.new_zeros(B, H)
    dc = x.new_zeros(B, H)
    da = torch.empty_like(x)
    wt = w.t()
    for t in (range(T) if is_reverse else range(T - 1, -1, -1)):
        mt = m[:, t]
        dhn = mt * (dh + dh_out[:, t])
        dcn = mt * (dc + dc_out[:, t]) + dhn * k_hc[:, t]
        dao = dhn * k_ho[:, t]
        if peep is not None:
            dcn = dcn + dao * peep[2]
        dai = dcn * k_ci[:, t]
        daf = dcn * k_cf[:, t]
        dcp = dcn * f[:, t]
        if peep is not None:
            dcp = dcp + dai * peep[0] + daf * peep[1]
        da_t = torch.cat([dcn * k_cc[:, t], dai, daf, dao], dim=-1)
        da[:, t] = da_t
        dh = (1 - mt) * dh + torch.matmul(da_t, wt)
        dc = (1 - mt) * dc + dcp
    da2 = da.reshape(-1, 4 * H)
    dw = torch.matmul(hp.reshape(-1, H).t(), da2)
    db = [da2.sum(0)]
    if peep is not None:
        dac, dai, daf, dao = da.split(H, dim=-1)
        db += [(dai * cp).sum((0, 1)), (daf * cp).sum((0, 1)),
               (dao * cn).sum((0, 1))]
    dbias = torch.cat(db).reshape(bias.shape)
    return (da, dw, dbias, dh if h0 is not None else None,
            dc if c0 is not None else None)


class _DynamicLSTM(torch.autograd.Function):
    """Forward through ``lstm_forward`` (the kernel on the card), saving
    (x, w, bias, h0, c0, lengths, h, c); backward through
    ``lstm_backward_plain`` on every device."""

    @staticmethod
    def forward(ctx, x, w, bias, h0, c0, lengths, cfg):
        h, c = lstm_forward(x, w, bias, lengths, h0, c0, **cfg)
        ctx.save_for_backward(x, w, bias, h0, c0, lengths, h, c)
        ctx.cfg = cfg
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        x, w, bias, h0, c0, lengths, h, c = ctx.saved_tensors
        grads = lstm_backward_plain(dh, dc, x, w, bias, lengths, h0, c0, h,
                                    c, **ctx.cfg)
        return (*grads, None, None)


def dynamic_lstm(x, w, bias, lengths, h0: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None, **cfg):
    """Differentiable ``lstm_forward`` -> (h, c).  On ``meta`` tensors
    (build-time shape inference) it returns empty outputs and launches
    nothing."""
    B, T, _ = x.shape
    H = w.shape[0]
    if x.device.type == "meta":
        return (torch.empty(B, T, H, dtype=x.dtype, device="meta"),
                torch.empty(B, T, H, dtype=x.dtype, device="meta"))
    return _DynamicLSTM.apply(x, w, bias, h0, c0, lengths, cfg)
