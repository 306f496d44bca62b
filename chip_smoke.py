#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py [--parent-ragged DIR] [--parent-flash DIR]
                          [--parent-package DIR]

Runs from the root of a checkout and needs one CUDA card; it imports
``paddle_tpu_torch`` and never JAX or ``paddle_tpu``.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the four CUDA kernels from the checkout's sources (``nvcc``,
   sm_90a, one compiler per source, all started together) and log their
   ptxas lines;
3. hold the ragged paged-attention kernel against its plain PyTorch
   version at the serving path's shapes (decode C=1 over self pages,
   decode C=1 over cross pages, prefill C=32), for float32, bfloat16
   and int8 pools, with dead lanes and lengths that end mid-page; then
   at D=128, page 8, C=7, causal and not, with a lane that uses all P
   pages, over three grids that ``ragged_plan`` splits one page a split,
   three pages a split and into one split (each must reach that path,
   and run the device kernels it needs: split, and merge if split);
4. hold the flash-attention forward, dq and dk/dv kernels against their
   plain versions (B=8, L=256, H=8, D=64, 'blhd'): causal and not,
   dropout 0 and 0.1, float32 and bfloat16, both bias shapes (forward),
   Lq=200 against Lk=136, and block offsets where every row is dead;
   the backward's tile edges (Lq=77 against Lk=45 and 45 against 77,
   causal and not, dropout 0.1, fp32 and bf16; bf16 also 200x136 and
   the dead rows) and a 'bhld' case in each dtype; every bf16 D = 64
   case must run ``dq_wg_kernel`` and ``dkv_wg_kernel`` (the kernel
   nodes of a CUDA graph of its calls, named through the driver);
   the other head widths the kernels are built for, D = 8, 16 and 32
   (fp32 and bf16, causal, dropout 0.1, 256x256 and 77x45), and D = 24,
   which the wrappers pad to 32; the widths above 64 (80, 128, 256: the
   wide kernels, 64-column chunks), fp32 and bf16; the bf16 kernels at
   D = 8, 32 and 128 against an emulation of the reference's rounding of
   p, ds and p * keep (within one bf16 ulp, and no farther from it than
   from the plain version); the dropout masks of
   the forward and dk/dv kernels exactly, on fp32 and on bf16 inputs (the
   bf16 forward's kept values within its rounding of p); the forward with
   no keys (every row dead);
5. serve 8 seeded requests (prompts of 64-256 tokens, 32 new tokens)
   through ``ContinuousBatchingScheduler`` over a Transformer-base
   ``PagedTransformerGenerator`` once per pool dtype: the generator runs
   its Fluid program (``build_unified_program``) through
   ``fluid.Executor``, ``aot_warm(8)`` captures the step in a CUDA graph
   (the executor's one miss) and every step of the run replays it (a hit
   a step, none missed); 18 ragged-kernel launches a step, and the
   captured graph's kernel nodes name 18 split and 18 merge kernels;
   one step over fresh prompts, some lanes prefilling and some
   decoding, replayed against the same step run eagerly
   (``run_block_ops``) on a clone of the pool: next ids equal and the
   pool bitwise off the trash page; step ms, tokens/s, TTFT p50; the
   pool held once (every cached step's buffer is the scope's pool, and
   serving's peak over the resident weights and pool grows by less than
   the pool's bytes at float32, and over float32's growth at the
   others) and, with ``--parent-package DIR``, ``profile_serving.py``
   on the parent's package and this one in turns, each in a process of
   its own (every run serves every request in the same steps, and this
   one's median peak exceeds the parent's by less than the pool's
   bytes); then replay the requests teacher-forced on the card and on
   the CPU (``place=CPUPlace()``, plain path) with the same weights;
6. beam search at full width, 4 seeded sources of 64-256 tokens, W = 4,
   32 new tokens, once per pool dtype: ``PagedTransformerGenerator.beam``
   on the card twice (the first run captures the unified step at 4
   lanes, the beam step at (4, 4) and the backtrace: 3 executable
   misses; the second misses none and hits every step), 12 ragged
   launches a replayed beam step and 12 split and merge kernel nodes in
   its graph, the beam step's 12 ragged calls at 16 lanes held against
   the plain version at the arguments of the second run's first and
   last steps (their shared page tables, lengths and bases, over the
   pool the run left), the pool held once, copy-on-write copies made,
   no page left in use and the allocator's invariants; the card's beam
   against the CPU port's from the same weights (ids and parents equal
   at every step, scores within 1e-4 relative for the float32 pool, the
   same backtrace; the float error of a step is a fixed bound, the
   teacher-forced logit difference and a rounding a step; a step whose
   W+1 best candidate totals lie within it is printed, and a difference
   there ends the comparison as a near tie), and teacher-forced, the
   CPU selecting along the card's trajectory, at every step (ids and
   parents equal but at a near tie, scores within a step's tolerance);
   the bf16 and int8 pools' ids against the float32 pool's (at least
   0.9 agree); the dense ``TransformerGenerator(causal_encoder=True)``'s
   beam on the card against the paged beam; the dense generator's
   greedy streams through ``ContinuousBatchingScheduler`` against the
   paged generator's, token for token; and at 2 layers the full re-run
   decoder's greedy against both; the beam step's median ms (paged by
   pool dtype, dense), hypothesis tokens/s, executable hits and misses
   and COW copies go to the ``beam`` line;
7. train: build ``transformer()`` at Transformer-base width through
   ``fluid.layers`` with ``Adam(1e-4).minimize``; run 3 steps at batch 2
   on the card (``Executor.run`` captures step 1 in a CUDA graph, steps
   2 and 3 replay it) and hold step 3 against the same step run eagerly
   (``lowering.run_block_ops``) on a clone of the card's state with its
   seeds (bitwise, else each differing value named with its op and held
   within the card-vs-CPU tolerances), and against the CPU port from the
   card's state (dropout on): the loss, gradients, updated parameters
   and the updates themselves; then 20
   steps at batch 64 on the card through ``fluid.Executor`` (the main
   path: 18 fused attentions per step, each launching the forward, dq
   and dk/dv kernels once; 19 executable hits, the captured graph's
   kernel nodes naming 18 of each), with a falling loss;
8. serve 4 requests with the trained scope, loaded by name into a
   ``PagedTransformerGenerator`` (``param_prefix="tf"``), every step a
   replay;
9. train the same Transformer in bench.py's own bf16 recipe
   (``amp_dtype="bfloat16"``: bf16 activations, f32 master weights; the
   same startup program and dropout salts): step 3 at batch 2 as in 7,
   against the eager step and against the CPU in the amp and in the
   float32 program (loss, every gradient in relative L2, and the card's
   distance to the float32 gradients against the CPU's); then 20 steps
   at batch 64 on the card, 18 launches of each flash kernel per step,
   every one on bf16 inputs (counted by dtype at the wrapper), graph and
   hits as in 7, with a falling loss;
10. the book's first two chapters on the card, each step 3 as in 7
   against the eager step and the CPU port (loss, every gradient), every
   step after the first a replay: ``fit_a_line``
   (200 SGD steps at batch 32, the loss down ~100x), ``conv_net`` (20
   Adam steps at batch 64 on synthetic digits) and the bf16 conv-pool
   net of ``tests/test_book.py`` (20 Momentum steps at batch 64, bf16
   images as a bf16 tensor feed), with falling losses; then fit_a_line
   through ``Executor.run_steps``, ``run_pipeline`` and two scopes in
   turns on one executor, each bitwise equal to ``run`` step by step;
11. at the training path's shapes (B=64, L=256, dropout 0.1, causal and
   not), in float32 and in bf16, hold ``flash_attention`` and its
   autograd backward against the plain forward and backward (out, lse,
   dq, dk, dv); then time every kernel, its plain version and the
   PyTorch library call for the same function at the paths' shapes (the
   flash kernels at dropout 0.1 and 0, the library's, in the same
   dtype, at 0, under every backend this PyTorch offers, the fastest
   named; the float32 flash kernels also at D = 80, 128, 256).  The flash
   kernels and SDPA are timed on the device clock (``device_ms``: a sleep
   kernel holds the stream while the host queues the calls).
   The ragged kernel is timed on the device clock: 200 calls captured in
   a CUDA graph whose replay CUDA events time (``ms``), beside the same
   calls issued one by one through the wrapper (``ms_eager``), an empty
   kernel timed the graph's way (``launch_floor_ms``), the device
   kernels one call runs (the kernel nodes of a CUDA graph of its calls)
   and, with
   ``--parent-ragged DIR``, an earlier ``ragged_paged_attention.cu`` in
   DIR built there and timed the graph's way (``parent_ms``); with
   ``--parent-flash DIR``, an earlier ``flash_attention_fwd.cu`` (and
   ``flash_attention_bwd.cu``, when DIR has it) built there, its bf16
   forward timed through the wrapper and its bf16 dq and dk/dv through
   its own entries, each in turns with the kernel's (``parent_ms``,
   ``parent_ms_dropout0``; the forward's ``parent_ms_eager``,
   ``parent_host_ms``);
12. hold the fused LSTM forward kernel (``lstm_forward``) against its
   plain loop: B=128, T=100 at H = 256, 512 and 1280 with and without
   peepholes, ragged lengths with 0 and 1, reverse, h0/c0, non-default
   activations at H=200, the SRL cell (B=128, T=64, H=128, relu /
   sigmoid / sigmoid, ragged, forward and reverse), B=1, T=1, and the
   edges of the kernel's
   tiling: B=100 at H=512, H=1000 ragged and reverse, the widest H whose
   weight slice stays in shared memory and the next (h, c, masked
   positions exactly 0; and for the peephole cases and the variants the
   gradients of every input, through the kernel forward and the
   hand-written backward, against autograd through the plain loop);
13. train the RNN benchmark model (``bench.py``'s ``bench_lstm``: emb
   128, vocab 30000, 2 x (fc + dynamic_lstm) at hidden 512, last step,
   fc softmax, Adam 2e-3) at batch 128, T=100: step 3 at batch 4 as in
   7 (loss, every gradient), then 20 steps on the card on one fixed
   ragged batch (2 kernel launches per step and 2 ``lstm_fwd`` kernel
   nodes in the graph, 19 hits, falling loss);
14. train the book's ``stacked_lstm_net`` (emb 128, hid 512, 3 stacked
   LSTMs, forward and reverse, with peepholes) for 20 steps at batch
   128, T=100, ragged lengths (3 launches per step and graph nodes, 19
   hits, falling loss);
15. time the LSTM kernel, its plain loop, ``torch.nn.LSTM`` (cuDNN, TF32
   off) and cuDNN's own input product alone at B=128, T=100, H = 256,
   512 and 1280;
16. image classification, no kernel of this repo on its path (every
   launch count 0 before and after each run): ResNet-50 in bench.py's
   recipe (224 px, 1000 classes, Momentum 0.1 / 0.9) with bf16 images
   over f32 masters, then in float32: step 3 at 64 px and batch 2 (a
   replay, at a learning rate of 1e-3, after 100 steps there on fresh
   batches: at its initialization the network is chaotic; see R50_*)
   against the eager step (cuDNN's deterministic algorithms) and against
   the CPU port from the card's state before it (the loss, every
   gradient and the 106 moving stats: float32 each gradient within 0.1
   in relative L2, bf16 by the amp rule); step 3 at batch 128 against the eager step; then 20
   steps at batch 128 on one fixed batch kept on the card from the
   startup program run there (19 executable hits in float32; 18 in bf16,
   whose first step turns the moving stats from bf16 to float32, as the
   reference's does; one graph; one host sync a replayed step; images/s,
   median step ms over steps 2-20, peak memory); AlexNet, GoogLeNet and
   SmallNet in bench.py's recipe (bf16 images, Momentum 0.01 / 0.9,
   batch 128): step 3 against the eager step, then 10 steps on one fixed
   batch; the book's CIFAR ResNet-32 (Momentum 0.02 / 0.9) and VGG-16
   with batch norm (Adam 1e-3) at 32 px, batch 128, 20 steps on fresh
   synthetic batches.  Every path's losses finite, the mean of the last
   5 below the first 5;
17. sparse embeddings, no kernel of this repo on their paths (every
   launch count 0 before and after each run): the sparse update ops
   (sgd, momentum with and without Nesterov, adam, adagrad) and
   ``merge_rows`` on the card against the CPU port at repeated and
   vacated rows (``merge_rows`` twice bitwise equal: no atomics); CTR
   wide&deep at ``models/ctr.py``'s width (26 slots of 1,000,001 ids,
   embed 16, 400-400-400, Adagrad 0.1, batch 1024), once with
   ``is_sparse=True`` and once dense, from one startup run on the card,
   20 steps each on the same seeded batches: the peak (sparse below
   dense), step 3 replayed bitwise against the eager step and against
   the CPU port at full size from the card's state, step ms and
   examples/s over steps 4-20, one graph, 19 hits, one host sync a
   replayed step, the device's time a step (10 replays of the graph
   between CUDA events), a falling loss, sparse and dense losses
   together; then the
   book's word2vec, recommender (sparse tables) and ``convolution_net``
   at their published sizes: step 3 against the eager step and the CPU
   port (loss, dense gradients, the state the step writes), 20 steps,
   19 hits, the loss falling;
18. control flow and the seq2seq models (book ch.08): the attention
   seq2seq at ``bench.py``'s ``bench_nmt_quality`` width (dict 2000,
   word 128, hidden 256, Adam 2e-3, batch 128) on seeded reversal pairs
   of 8-32 tokens (``make_seq(..., bucket=8)``): step 3 at 4 rows
   against the eager step (bitwise) and the CPU port (the Transformer's
   float32 limits; every weight's update against Adam's rule applied to
   the card's gradient), then 20 steps on 4 batches of one signature (one captured
   graph, 19 hits, one ``lstm_fwd`` launch and graph node a step, one
   host sync a step, step ms, target tokens/s, peak memory, the loss
   falling); the beam decode (beam 3, 32 steps, top-k 50) of 128
   sources in a While on the trained weights, run eagerly on the card
   with the host reading the loop's condition (decode ms, iterations
   and host syncs per iteration, one miss then hits, no graph, one
   ``lstm_fwd`` launch a decode), and against the CPU port step by
   step (ids and parents equal, scores within 1e-4 relative, the same
   backtrace; near ties printed as the beam phase prints them); the
   book's ``train_model`` with its ``decode_model`` and
   ``seq_to_seq_net`` (its encoder's two LSTMs, one reversed: 2
   launches a step) at the chapter's widths, step 3 against eager
   (bitwise) and the CPU and 5 steps each; a bounded ``While(max_iters=8)``
   differentiated on the card in two cases (its body's squares averaged,
   or summed: saturating), step 3 against eager and the CPU, and in
   float64 on the card against the CPU;
19. semantic role labeling (book ch.07) and the evaluators: the slice's
   16 new ops on the card against the CPU port at the path's sizes
   (``linear_chain_crf``'s loss and gradients, its gradients twice
   bitwise; Viterbi paths and chunk counts bitwise; ``gather`` and
   ``scatter`` over repeated ids, ``one_hot`` out of range, the reduce
   ops over ties and zeros; ``truncated_gaussian_random`` by its
   statistics); the SRL cell (B = 128, T = 64, H = 128, relu / sigmoid
   / sigmoid) timed against its plain loop and bound; then
   ``srl_model(SRLDims())`` at full width (8 LSTMs of H = 128, sparse
   predicate and mark tables, SGD 2e-3, a ChunkEvaluator and a
   ModelAverage in the program) on seeded sentences of 5-60 words
   padded to 64, batch 128: step 3 at 4 sentences against the eager
   step (bitwise) and the CPU port (loss, dense gradients, sparse
   updates; Viterbi and chunk counts on the card's emissions on both
   devices, equal), 20 steps on 4 batches (one graph, 19 hits, 8
   ``lstm_fwd`` launches and graph nodes a step, step ms, target
   tokens/s, peak memory, the loss falling), the frozen word table and
   the predicate rows no batch fed bitwise unchanged, the evaluator's
   counts against a host recount of the fetched paths, ModelAverage's
   ``apply`` against its rule in float64 and ``restore`` bitwise
   (twice), a step after them bitwise the same step without, and after
   ``reset`` a count from zero; host syncs, device ms, busy and idle;
20. speech recognition with CTC (``speech_phase``), no kernel of this
   repo on its path: the reference's BiGRU-CTC program at DeepSpeech2's
   widths (161 bins, fc 2048 relu, 3 bidirectional ``dynamic_gru``
   layers of 2048, each direction fed by its own fc of 3 x 2048, fc to
   29 classes, ``warpctc(blank=28, norm_by_times=True)``, Adam 5e-4),
   batch 32 of 200-400 frames padded to 400 and 20-80 characters: step
   3 at 4 utterances against the eager step and the CPU port (loss
   1e-5 relative, every gradient 1e-4 of its largest), 20 steps on one
   batch (step ms, frames/s, graph nodes, hits, host syncs, peak over
   the resident state, busy and idle, the loss falling), the greedy
   decode and normalized edit distance of the test program, and the
   decode's ops on the card's logits on both devices, bit for bit;
21. MobileNet-SSD at 300 x 300 (``ssd_phase``), no kernel of this repo
   on its path: the MobileNet v1 backbone of depthwise-separable
   ``conv2d(groups=C)`` + ``batch_norm`` blocks, heads on the 19, 10, 5,
   3, 2 and 1 maps, ``prior_box`` (1,917 priors), 21 classes,
   ``ssd_loss``, Momentum 0.9, batch 32 with 1-16 boxes an image: step
   3 at 4 images against the eager step and the CPU port (the loss
   1e-5 relative, the priors and the matching bit for bit, each
   gradient within 0.1 in relative L2 and their median within 4x the
   CPU's own under a one-ulp nudge of the pixels), 20 steps on one
   batch (step ms, images/s,
   the rest as in 20), ``detection_output`` at the layer's defaults
   through the ``mode="infer"`` graph on the trained weights (its NMS on
   the card's decoded boxes and scores bit for bit on both devices), its
   rows against the CPU's op on the card's Location and Confidence
   (equal but at printed near ties) and DetectionMAP over both; then the
   slice's ops off both paths (``conv2d_transpose``, ``conv3d``,
   ``pool3d``, ``l2_normalize``, ``im2sequence``, ``gru_unit``,
   ``lstm_unit``, ``nce``), forward and gradient, card against CPU at
   one realistic shape each, ``nce`` on the card's drawn ids;
22. Fast R-CNN (``frcnn_phase``), no kernel of this repo on its path:
   VGG-16's 13 conv + relu layers and 4 max pools (stride 16),
   ``roi_pool`` 7 x 7 at 1/16, fc6 / fc7 of 4096 with dropout 0.5, 21
   classes by softmax cross-entropy and 84 box outputs by ``smooth_l1``
   on the RoI's class's 4 columns, Momentum 1e-3 / 0.9 with weight decay
   5e-4, 2 images of 600 x 800 and 128 RoIs a batch: step 3 at 2 x 128
   x 160 and 16 RoIs against the eager step (deterministic cuDNN) and
   the CPU port (loss 1e-4 relative, each gradient 0.1 in relative L2),
   ``roi_pool`` out and gradient card against CPU bit for bit, 20 steps
   on one batch (step ms, images/s, RoIs/s, the rest as in 20);
23. learning to rank (``ranking_phase``), no kernel of this repo:
   LambdaRank (``lambda_rank_cost``, ndcg 10, 256 queries of 8-128
   documents) and RankNet (``rank_loss``, 16,384 pairs), a 46 -> 128 ->
   64 -> 1 tanh scorer, Adam 1e-3, the AUC fetched every step: step 3
   against the eager step and the CPU port (loss 1e-5 relative,
   gradients 1e-4 of their largest), 20 steps each; ``lambda_rank_cost``
   and ``auc`` card against CPU on the same tied scores, bit for bit;
24. the slice's 34 ops at realistic shapes card against CPU
   (``loss_misc_op_checks``): outputs 1e-5 and gradients 1e-4 of their
   largest, bit for bit where exact, ``roi_pool``, ``hsigmoid`` and
   ``selective_fc``'s gradients twice the same bits, hsigmoid's path
   length at every label, ``sampling_id`` by a chi-square test;
25. speculative and constrained decoding (``speculative_phase``) at
   Transformer-base width, float32 and int8 pools, K = 4, the serving
   phase's 8 prompts through the scheduler at 8 lanes: the target with
   an identical-weights draft (accept rate 1.0, but where the draft's
   own top-2 logit margin at a rejected token is a near tie), then a
   fresh target with its layers past the first near-identity (output
   projections x 0.01 before it serves anything, as bench.py's
   ``bench_speculative`` builds it) and a 1-layer draft sharing the
   rest (accept rate at least 0.5); streams against each target's
   plain greedy (equal, or a flip where the plain step's top-2 logit
   margin is within twice the teacher-forced logit error: printed, and
   the request's later tokens not compared); accept rate, tokens a
   round, tokens/s against the same target's plain run; ragged
   launches a verify step and a draft step, each over its own steps
   (want 18 and 3 for 1 layer: 3 a layer), the verify and draft
   steps' captured graphs naming their split and merge nodes; one
   mid-traffic verify step replayed against the same step eager on a
   clone of the pool (ids equal, pool bitwise off page 0); 3 rounds
   profiled (round ms, the device's idle share over them);
   a 64-token set and a small DFA, every token within its grammar;
   no executable miss on either executor after ``aot_warm``;
26. the host tier and sessions (``tier_phase``), the serving model with
   97 pages, 1024 host pages, transfers 4 pages a step, a
   ``SessionStore`` on a temporary directory: download -> upload ->
   download of a conversation's pages bitwise per pool dtype; eight
   conversations through two slots, each suspended after 8 tokens and
   resumed for 8 more, token for token against one 16-token decode;
   resume TTFT against re-prefill TTFT; spill (demote) and prefetch
   (promote) GB/s; no executable miss after a warm cycle; one artifact
   torn by ``kv.spill_corrupt`` degrading to re-prefill.

It prints the card's name and power limit, a ``serving`` line, a
``beam`` line, a ``training`` line, a ``training_bf16`` line, a ``book``
line, an ``lstm`` line, an ``image`` line, a ``sparse`` line, an ``nmt``
line, an ``srl`` line, a ``speech`` line, an ``ssd`` line, an ``frcnn``
line, a ``ranking`` line, a ``speculative`` line, a ``tiers`` line, a
``kernels`` line (the flash kernels once
in float32 and once, ``*_bf16``, in bf16) and, last, the ``{"ok":
true, ...}`` line;
per-case detail goes to standard error.  Any failed check exits 1
without the last line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# Transformer-base as the repo serves it (bench.py's serving section)
VOCAB = 32768
MODEL = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
             d_inner_hid=2048)
SERVE = dict(max_length=257, src_len=256, max_out_len=64, page_size=16,
             chunk_size=32, num_pages=1024)
N_REQUESTS, N_SLOTS, MAX_NEW = 8, 8, 32
KV_DTYPES = ("float32", "bfloat16", "int8")

# H100 SXM data-sheet peaks (dense): HBM3 rate, the fp32 rate outside
# the tensor cores (the ragged and flash forward kernels' arithmetic)
# and the TF32 tensor-core rate (the three TF32 products of the LSTM
# and flash backward kernels)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# ... and the bf16 tensor-core rate (the bound of the flash kernels'
# bf16 instantiations, which the amp recipe runs)
BF16_FLOPS_PER_S = 989e12
# the flash kernels' dropout hash (keep_scale), counted on the pipe that
# sets its pace: a live element takes the key's xor, three xor-shifts of
# two operations each and the threshold compare on the int32 ALU pipe,
# 8 operations; the position's add (the row and column terms hoisted)
# and the two multiplies may issue as IMAD on the FMA pipe beside them,
# 3 there.  The ALU pipe's rate is the card's: 64 int32 lanes an SM a
# clock (Hopper) at the SM's maximum clock (int32_ops_per_s)
HASH_ALU_OPS = 8
INT32_LANES_PER_SM = 64

# kernel vs plain on the same inputs: both compute in fp32; they differ
# only in summation order (64-term dots, per-page partial softmax sums
# vs one softmax over all pages) and in expf vs torch.exp rounding
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-4
# card vs CPU logits, teacher-forced: fp32 end to end (TF32 off), so the
# float32 pool differs only by summation order through 12 layers; a
# bf16 or int8 pool also rounds K/V on write, and a value that lands on
# the other side of a rounding boundary moves one key element by one
# bf16 ulp (2^-8 relative) or one int8 step (scale/127)
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 1e-2, "int8": 1e-2}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def int32_ops_per_s(torch) -> float:
    """The card's int32 rate: its SMs x 64 lanes x its maximum SM clock,
    as ``nvidia-smi --query-gpu=clocks.max.sm`` gives it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- phases 3 and 11: the ragged kernel against its plain version ----------

def kernel_cases(torch, gen):
    """Argument sets at the serving path's shapes: 8 lanes, 8 heads,
    D=64, page 16; a prefill chunk of 32 rows over up to 16 encoder
    pages, a decode row over up to 4 self pages and over up to 16 cross
    pages.  Lengths end mid-page; lane 5 is dead (length 0) and lane 4
    idles the way the serving path idles a lane (length 1 on page 0)."""
    B = N_SLOTS
    n_layer = MODEL["n_layer"]
    pages = SERVE["num_pages"]
    pf_len = torch.tensor([32, 69, 100, 256, 1, 0, 161, 250])
    pf_base = torch.clamp((pf_len - 1) // 32 * 32, min=0)
    self_len = torch.tensor([1, 17, 33, 64, 1, 0, 48, 63])
    src_len = torch.tensor([64, 100, 256, 77, 1, 0, 129, 200])
    specs = {  # name: (C, causal, P, lengths, q_base)
        "prefill": (32, True, 16, pf_len, pf_base),
        "decode_self": (1, True, 4, self_len,
                        torch.clamp(self_len - 1, min=0)),
        "decode_cross": (1, False, 16, src_len, torch.zeros(B, dtype=torch.long)),
    }
    cases = {}
    for name, (C, causal, P, lengths, q_base) in specs.items():
        sets = []
        for k in range(16):            # distinct pages: L2 stays cold
            table = torch.randperm(pages - 1, generator=gen)[:B * P] + 1
            table = table.reshape(B, P).to(torch.int32)
            table[4] = 0               # idle lane on the trash page
            q = torch.randn(B, C, MODEL["n_head"], MODEL["d_key"],
                            generator=gen)
            sets.append(dict(q=q, table=table, layer=k % n_layer))
        cases[name] = dict(C=C, causal=causal, P=P, sets=sets,
                           lengths=lengths.to(torch.int32),
                           q_base=q_base.to(torch.int32))
    return cases


def make_pools(torch, gen, dev):
    """One pool per dtype, [H, R, ps, D] over 1024 logical pages."""
    from paddle_tpu_torch.fluid.ops.quant_ops import (abs_max_scale,
                                                      quantize_array)
    H, D, ps = MODEL["n_head"], MODEL["d_key"], SERVE["page_size"]
    R = SERVE["num_pages"] * MODEL["n_layer"] * 2
    g = torch.Generator(device=dev)
    g.manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen)))
    f32 = torch.randn(H, R, ps, D, device=dev, generator=g)
    sc = abs_max_scale(f32, axis=(1, 2))                      # [R, ps]
    i8 = quantize_array(f32, sc, axis=(1, 2))
    return {"float32": (f32, None), "bfloat16": (f32.to(torch.bfloat16), None),
            "int8": (i8, sc.reshape(1, R, ps).contiguous())}


def bound(case, pool, scales):
    """Least time for the work these inputs need: each live page's K and
    V slabs (and scales) read once per head, q/out/tables once; 4*C*ps*D
    fp32 operations per live page and head (the two dot products)."""
    H, _r, ps, D = pool.shape
    C, P = case["C"], case["P"]
    B = len(case["lengths"])
    live = sum(min(P, math.ceil(int(n) / ps)) for n in case["lengths"])
    item = pool.element_size()
    nbytes = live * H * 2 * ps * D * item
    if scales is not None:
        nbytes += live * 2 * ps * 4
    nbytes += 2 * B * C * H * D * 4 + B * P * 4 + 2 * B * 4
    ops = live * H * 4 * C * ps * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def run_case(fa, case, s, pool, scales, plain):
    fn = fa.ragged_attention_plain if plain else fa.ragged_decode_attention
    args = (s["q"], pool, s["table"], case["lengths"], case["q_base"])
    if plain:
        return fn(*args, s["layer"], MODEL["n_layer"], case["causal"],
                  MODEL["d_key"] ** -0.5, scales=scales)
    return fn(*args, layer=s["layer"], n_layer=MODEL["n_layer"],
              causal=case["causal"], sm_scale=MODEL["d_key"] ** -0.5,
              scales=scales)


def case_calls(fa, case, pool, scales, iters, plain=False):
    """``iters`` calls that rotate over the case's 16 argument sets on
    distinct pages (more than L2 holds), as closures."""
    sets = case["sets"]
    return [lambda s=sets[i % len(sets)]: run_case(fa, case, s, pool,
                                                   scales, plain)
            for i in range(iters)]


def time_case(torch, fa, case, pool, scales, plain, iters):
    """ms per call through the Python wrapper: CUDA events around
    ``iters`` calls issued one after another.  For a kernel of a few
    microseconds this is the host's issue rate (``ms_eager``)."""
    calls = case_calls(fa, case, pool, scales, iters, plain)
    for fn in calls[:4]:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for fn in calls:
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, calls, replays=5):
    """ms per call on the device clock: the calls captured into one CUDA
    graph, whose replays CUDA events time; the host issues nothing per
    call, so this is the kernels' own time plus the gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up: builds, attributes
        for fn in calls[:4]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (replays * len(calls))
    del graph
    return ms


def launch_floor_ms(torch, fa, iters):
    """One empty kernel's launch, timed as ``graph_ms`` times a call."""
    _, _, empty = fa._kernel_fn()

    def launch():
        err = empty(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {err}")

    return graph_ms(torch, [launch] * iters)


def build_parent_ragged(src_dir):
    """The parent commit's ragged kernel, from ``src_dir``'s
    ``ragged_paged_attention.cu`` (its first version, one block per
    (lane, head)), built with the port's nvcc flags and bound to its own
    C entry -> the entry."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    src = os.path.join(src_dir, "ragged_paged_attention.cu")
    lib = os.path.join(src_dir, "libparent_ragged.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(lib).ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def parent_calls(torch, parent, fa, case, pool, scales, iters):
    """``case_calls`` through the parent's kernel."""
    H, R, ps, D = pool.shape
    dtype = fa._POOL_DTYPES[pool.dtype]
    outs = [torch.empty_like(s["q"]) for s in case["sets"]]

    def call(i):
        s = case["sets"][i % len(case["sets"])]
        q, out = s["q"], outs[i % len(outs)]
        B, C = q.shape[:2]
        err = parent(q.data_ptr(), pool.data_ptr(),
                     scales.data_ptr() if scales is not None else None,
                     s["table"].data_ptr(), case["lengths"].data_ptr(),
                     case["q_base"].data_ptr(), out.data_ptr(), B, C, H, R,
                     ps, D, s["table"].shape[1], s["layer"],
                     MODEL["n_layer"], int(case["causal"]),
                     MODEL["d_key"] ** -0.5, dtype,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent ragged kernel: CUDA error {err}")
        return out

    return [lambda i=i: call(i) for i in range(iters)]


# ragged shapes beside the serving path's: a wider head, shorter pages, a
# chunk of 7 rows; lane 0 uses all P pages, lane 1 is dead, and the
# others end mid-page, so some splits start past their lane's length
RAGGED_EXTRA = dict(D=128, ps=8, C=7, pages=64, n_layer=2)
# (B, H, P) for each of the kernel's paths, as ``ragged_plan`` splits
# them on a 132-SM card: one page a split with a merge; three pages a
# split (the page ring wraps) with a merge; so many (lane, head) pairs
# that one split walks the whole table and no merge runs
RAGGED_EXTRA_GRIDS = {"page_splits": (4, 4, 6), "ring": (4, 4, 198),
                      "one_split": (33, 32, 6)}


def ragged_extra_cases(torch, gen, dev):
    """{grid: (pools by dtype, argument sets)} at RAGGED_EXTRA's shapes
    over each grid of RAGGED_EXTRA_GRIDS, causal and not."""
    from paddle_tpu_torch.fluid.ops.quant_ops import (abs_max_scale,
                                                      quantize_array)
    x = RAGGED_EXTRA
    R = x["pages"] * x["n_layer"] * 2
    out = {}
    for grid, (B, H, P) in RAGGED_EXTRA_GRIDS.items():
        f32 = torch.randn(H, R, x["ps"], x["D"], generator=gen).to(dev)
        sc = abs_max_scale(f32, axis=(1, 2))
        pools = {"float32": (f32, None),
                 "bfloat16": (f32.to(torch.bfloat16), None),
                 "int8": (quantize_array(f32, sc, axis=(1, 2)),
                          sc.reshape(1, R, x["ps"]).contiguous())}
        lengths = torch.cat([torch.tensor([P * x["ps"], 0]), torch.randint(
            1, P * x["ps"], (B - 2,), generator=gen)]).to(torch.int32)
        sets = []
        for causal in (False, True):
            table = torch.randint(1, x["pages"], (B, P), generator=gen)
            sets.append(dict(
                causal=causal, layer=1,
                q=torch.randn(B, x["C"], H, x["D"], generator=gen).to(dev),
                table=table.to(torch.int32).to(dev), lengths=lengths.to(dev),
                q_base=torch.clamp(lengths - x["C"], min=0).to(dev)))
        out[grid] = (pools, sets)
    return out


def graph_kernels(torch, calls):
    """The device kernels ``calls`` run, in order: the calls captured into
    a CUDA graph (after one warm-up call) -> the mangled names of its
    kernel nodes (``kernel_nodes``)."""
    calls[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    names, _ = kernel_nodes(graph)
    del graph
    return names


def kernel_nodes(graph):
    """A kept CUDA graph's nodes read through libcuda
    (``cuGraphGetNodes``), each kernel node's function named
    (``cuFuncGetName``, or ``cuKernelGetName`` for a kernel the runtime
    launched by its context-free handle) -> (the kernel nodes' mangled
    names in node order, the number of nodes of every type)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUDA driver error {err}")

    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    kind, names = ctypes.c_int(), []
    # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
    params = (ctypes.c_void_p * 9)()
    name = ctypes.c_char_p()
    for node in nodes:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               params),
              "cuGraphKernelNodeGetParams")
        func, kern = params[0], params[7]
        if func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names, n.value


# the kernel families a training step's graph is counted by: the source
# name in a mangled kernel name (``kernel_names``) -> family
FAMILY_OF = {"fwd_kernel": "fwd", "fwd_wide_kernel": "fwd",
             "fwd_bf16_kernel": "fwd", "fwd_wg_kernel": "fwd",
             "dq_kernel": "dq", "dq_wide_kernel": "dq", "dq_wg_kernel": "dq",
             "dkv_kernel": "dkv", "dkv_wide_kernel": "dkv",
             "dkv_wg_kernel": "dkv", "lstm_fwd_kernel": "lstm_fwd",
             "ragged_split_kernel": "ragged_split",
             "ragged_merge_kernel": "ragged_merge"}


def source_name(mangled):
    """``dq_wg_kernel`` etc.: the kernel identifier in a mangled name."""
    import re

    m = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    return m.group(1) if m else None


def step_graph(exe, prog=None):
    """The one CUDA graph an executor captured for a path's step (a
    training step, the serving step at one lane count; of ``prog``'s
    entries only, if given) -> {nodes, kernel_nodes, and the kernel
    nodes of each of this repo's kernel families}."""
    if prog is None:
        graphs = exe.graphs()
    else:
        key = exe._program_key(prog)
        graphs = [e.graph for k, e in exe._cache.items()
                  if k[0] == key and e.graph is not None]
    if len(graphs) != 1:
        return {"graphs": len(graphs)}
    names, nodes = kernel_nodes(graphs[0])
    return {"graphs": 1, "nodes": nodes, "kernel_nodes": len(names),
            "by_family": graph_families(names)}


def graph_families(names):
    """This repo's kernel families among a graph's kernel nodes (their
    mangled names, ``kernel_nodes``) -> {family: nodes}."""
    fams = {}
    for n in names:
        f = FAMILY_OF.get(source_name(n))
        if f:
            fams[f] = fams.get(f, 0) + 1
    return fams


def device_kernels_per_call(torch, calls):
    """Device kernels one call runs: ``graph_kernels`` of ``calls``,
    counted and divided by the calls."""
    return len(graph_kernels(torch, calls)) / len(calls)


def run_ragged_extra(torch, fa, extra, failures):
    """Every extra grid, set and pool dtype through
    ``ragged_decode_attention`` against the plain version under
    KERNEL_ATOL / KERNEL_RTOL; the dead lane must be 0.  Each grid must
    reach the path it is named for (the split the wrapper launched), and
    one call must run the device kernels that split needs (the kernel
    nodes of its calls captured in a CUDA graph): the split kernel, and a merge kernel when there is
    more than one split.  Returns ({grid: record}, the largest error)."""
    x = RAGGED_EXTRA
    worst, recs = 0.0, {}
    for grid, (pools, sets) in extra.items():
        plans, grid_err = set(), 0.0
        for kv, (pool, scales) in pools.items():
            for s in sets:
                args = (s["q"], pool, s["table"], s["lengths"], s["q_base"])
                kw = dict(layer=s["layer"], n_layer=x["n_layer"],
                          causal=s["causal"], sm_scale=x["D"] ** -0.5,
                          scales=scales)
                want = fa.ragged_attention_plain(
                    *args, s["layer"], x["n_layer"], s["causal"],
                    x["D"] ** -0.5, scales=scales)
                got = fa.ragged_decode_attention(*args, **kw)
                plans.add(fa.ragged_decode_attention.last_plan)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = bool(torch.allclose(got, want, atol=KERNEL_ATOL,
                                         rtol=KERNEL_RTOL))
                dead = bool((got[1] == 0).all())
                grid_err = max(grid_err, err)
                name = (f"{grid}/{kv}/{'causal' if s['causal'] else 'full'}"
                        f"/B{got.shape[0]}/H{got.shape[2]}/"
                        f"P{s['table'].shape[1]}/D{x['D']}/ps{x['ps']}/"
                        f"C{x['C']}")
                log(f"kernel vs plain {name}: max_abs_err {err}")
                if not ok or not dead:
                    failures.append(f"kernel {name}: max_abs_err {err} "
                                    f"(dead lane zero: {dead})")
        (pps, splits), = plans
        pool, scales = pools["float32"]
        s = sets[0]
        per_call = device_kernels_per_call(torch, [
            lambda: fa.ragged_decode_attention(
                s["q"], pool, s["table"], s["lengths"], s["q_base"],
                layer=s["layer"], n_layer=x["n_layer"], causal=s["causal"],
                sm_scale=x["D"] ** -0.5)] * 8)
        recs[grid] = {"pages_per_split": pps, "splits": splits,
                      "device_kernels_per_call": per_call,
                      "max_abs_err": grid_err}
        log(f"ragged grid {grid}: {json.dumps(recs[grid])}")
        if per_call != (1 if splits == 1 else 2):
            failures.append(f"ragged grid {grid}: {per_call} device kernels "
                            f"a call at {splits} splits")
        worst = max(worst, grid_err)
    paths = {grid: (r["pages_per_split"], r["splits"])
             for grid, r in recs.items()}
    reached = {"page_splits": paths["page_splits"][0] == 1
               and paths["page_splits"][1] > 1,
               "ring": paths["ring"][0] >= 3 and paths["ring"][1] > 1,
               "one_split": paths["one_split"][1] == 1}
    if not all(reached.values()):
        failures.append(f"ragged grids missed their paths (pages a split, "
                        f"splits): {paths}")
    return recs, worst


# -- phases 5 and 8: serving ------------------------------------------------

def make_generator(device, kv_dtype, model=None):
    """The serving configuration's generator on ``device`` ("cuda" or
    "cpu"): its executor at ``fluid.CUDAPlace(0)`` or ``CPUPlace()``;
    ``model`` replaces MODEL's dims (another depth)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.serving import PagedTransformerGenerator
    place = fluid.CUDAPlace(0) if device == "cuda" else fluid.CPUPlace()
    return PagedTransformerGenerator(VOCAB, VOCAB, kv_dtype=kv_dtype,
                                     place=place, **(model or MODEL),
                                     **SERVE)


def prompts(np, seed=SEED, lengths=None):
    """N_REQUESTS seeded prompts, of 64 .. src_len tokens or of
    ``lengths``."""
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = [rng.randint(64, SERVE["src_len"] + 1)
                   for _ in range(N_REQUESTS)]
    return [rng.randint(2, VOCAB, n) for n in lengths]


def serve_once(torch, np, fa, gen, srcs, on_start=None):
    """The serving path: requests in through the scheduler's thread,
    tokens out.  The warm-up is ``aot_warm(N_SLOTS)``, the unified step's
    capture at the serving width; ``on_start()``, if given, runs after
    it, just before the run's clock starts.  The requests are queued
    before the thread starts, so its first step admits them all and the
    run's steps do not depend on thread timing.  Returns (run record,
    every request finished); the record's ``executable_during_serve``
    counts the executor's hits and misses between the warm-up and the
    end."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler

    gen.aot_warm(N_SLOTS)
    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(gen, n_slots=N_SLOTS,
                                        max_new_tokens=MAX_NEW)
    stats0 = gen.cache_stats()
    if on_start is not None:
        on_start()
    fa.ragged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [sched.submit(s, max_new_tokens=MAX_NEW) for s in srcs]
    sched.serve()
    done = all(r.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.shutdown(timeout=30)
    launches = fa.ragged_decode_attention.launches
    stats = gen.cache_stats()
    steps = stats["steps"] - stats0["steps"]
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_token - r.submitted for r in reqs
            if r.first_token is not None]
    rec = {"requests": len(reqs),
           "finished": sum(r.done and r.error is None for r in reqs),
           "errors": [repr(r.error) for r in reqs if r.error is not None],
           "tokens": tokens, "wall_s": wall, "steps": steps,
           "launches": launches,
           "launches_per_step": launches / max(1, steps),
           "decode_tok_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
           "step_ms": wall / max(1, steps) * 1e3,
           "executable": stats["executable"],
           "executable_during_serve": {
               k: stats["executable"][k] - stats0["executable"][k]
               for k in ("hits", "misses")}}
    return rec, done and rec["finished"] == len(reqs)


def serving_replay_check(torch, gen, srcs, warm_steps=4):
    """One mid-traffic unified step as a graph replay against the same
    step run eagerly (``lowering.run_block_ops``) on a clone of the pool
    (and int8 scales) before it, with the same feed: the next ids equal,
    and the pool equal bitwise off the trash page.  Page 0's rows take
    every dead lane's and dead chunk position's write in one scatter of
    undefined order, and no lane reads them.  ``srcs`` are prompts the
    prefix cache does not hold, of two lengths: ``warm_steps`` lane
    steps after admitting them leave the short ones decoding and the
    long ones prefilling, so the step runs both towers (the encoder and
    cross-page writes, the chunked encoder attention and the decode
    step); the record fails unless it saw both phases.  Returns the
    record; the lanes are cleared after."""
    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor)

    gen.open_slots(N_SLOTS)
    for i, s in enumerate(srcs[:N_SLOTS]):
        gen.admit_slot(i, s, max_new=MAX_NEW)
    for _ in range(warm_steps):
        gen.lane_step()
    phases = [ln.phase for ln in gen._lanes]
    prog, _, next_ids, _ = gen._unified
    feed = gen.step_feed()
    plan = BlockPlan(prog.desc.global_block(), list(feed), [next_ids.name])
    pre = {n: gen.scope.find_var(n) for n in plan.state_in}
    pre.update({n: pre[n].clone() for n in plan.state_out})
    hits = gen.exe.cache_stats()["executable"]["hits"]
    got, = gen._run(feed, [next_ids])
    replayed = gen.exe.cache_stats()["executable"]["hits"] == hits + 1
    ids = got.cpu()
    dev = gen.exe.device
    env = dict(pre)
    env.update(device_feed(torch, feed, dev))
    with torch.no_grad():
        run_block_ops(plan, env, [], seed_tensor([]).to(dev), dev, "infer")
    trash = 2 * MODEL["n_layer"]
    state = {n: bool(torch.equal(env[n][:, trash:],
                                 gen.scope.find_var(n)[:, trash:]))
             for n in plan.state_out}
    rec = {"replayed": replayed, "lane_phases": phases,
           "ids_equal": bool(torch.equal(env[next_ids.name].cpu(), ids)),
           "state_bitwise_off_page0": state}
    rec["ok"] = (replayed and rec["ids_equal"] and all(state.values())
                 and {"prefill", "decode"} <= set(phases))
    gen.absorb_step(ids.numpy())
    for slot in range(N_SLOTS):
        gen.clear_slot(slot)
    del pre, env
    return rec


def ragged_calls_per_step(fa, sms, n_layer=None):
    """(ragged calls, merge launches) of one unified step at the serving
    width (of ``n_layer`` layers, default MODEL's): per layer an encoder
    self-attention over the source table, a decoder self-attention over
    the target table and a cross-attention over the source table; a call
    merges where ``ragged_plan`` splits it.  The speculative verify and
    draft programs are unified programs too, at C = K + 1 and 1 queries
    a lane: the same calls."""
    ps = SERVE["page_size"]
    p_src = -(-SERVE["src_len"] // ps)
    p_out = -(-SERVE["max_out_len"] // ps)
    tables = [p_src, p_out, p_src] * (n_layer or MODEL["n_layer"])
    merges = sum(fa.ragged_plan(N_SLOTS, MODEL["n_head"], p, sms)[1] > 1
                 for p in tables)
    return len(tables), merges


def serving_peak_subprocess(package_root):
    """``profile_serving.py`` (float32 pool) on ``package_root``'s
    package in a process of its own -> its JSON line, or the error."""
    cmd = [sys.executable, os.path.join(ROOT, "profile_serving.py")]
    if package_root is not None:
        cmd += ["--package-root", package_root]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    for line in reversed(out.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return {"error": out.returncode, "stderr": out.stderr[-2000:]}


def pool_held_once(gen, pool):
    """Whether the scope's pool (and int8 scales) is still the tensor of
    ``pool`` at its address, and every cached step of the generator's
    executor steps that tensor as its buffer."""
    entries = list(gen.exe._cache.values())
    return bool(entries) and all(
        gen.scope.find_var(n) is t and t.data_ptr() == ptr
        and all(e.state[n] is t for e in entries if n in e.state)
        for n, (t, ptr) in pool.items())


def in_turns_failures(peaks):
    """The serving profiles run in turns on the parent's package and this
    one: each served every request, all in the same steps, and this
    one's median peak exceeds the parent's by less than the pool's
    bytes (the pool is held once)."""
    bad = [p for p in peaks if "error" in p
           or p["finished"] < p["requests"]]
    if bad:
        return [f"profile_serving failed: {p}" for p in bad]
    fails = []
    steps = {(p["steps"], p["unprofiled"]["steps"]) for p in peaks}
    if len(steps) != 1:
        fails.append(f"profile_serving: (profiled, unprofiled) steps "
                     f"differ between runs: {sorted(steps)}")
    med = {name: statistics.median(p["peak_mem_gib"] for p in peaks
                                   if p["package"] == name)
           for name in ("parent", "this")}
    pool = max(p["pool_gib"] for p in peaks)
    if not med["this"] - med["parent"] < pool:
        fails.append(f"profile_serving: median peak {med['this']} GiB "
                     f"against the parent's {med['parent']}: grows by the "
                     f"pool's {pool} GiB or more")
    return fails


def teacher_forced(np, gpu, cpu, srcs):
    """Same requests, same weights, same feeds on the card and on the CPU;
    each step both absorb the card's tokens.  Returns the largest logit
    difference over decoding lanes and the share of steps where the two
    argmaxes agree."""
    for g in (gpu, cpu):
        g.open_slots(len(srcs))
        for i, s in enumerate(srcs):
            g.admit_slot(i, s, max_new=MAX_NEW)
    counts = [0] * len(srcs)
    worst, agree, total = 0.0, 0, 0
    while any(ln.phase != "idle" for ln in gpu._lanes):
        feed, feed_c = gpu.step_feed(), cpu.step_feed()
        if any(not np.array_equal(feed[k], feed_c[k]) for k in feed):
            raise AssertionError("card and CPU generators built different "
                                 "feeds for the same requests")
        ids_g, lg = gpu.run_feed(feed)
        ids_c, lc = cpu.run_feed(feed)
        ids_g = ids_g.cpu().numpy()
        ids_c = ids_c.numpy()
        emitted = cpu.absorb_step(ids_g)
        gpu.absorb_step(ids_g)
        for slot, tok in emitted.items():
            diff = (lg[slot].cpu() - lc[slot]).abs().max().item()
            worst = max(worst, diff)
            agree += int(ids_c[slot, 0] == tok)
            total += 1
            counts[slot] += 1
            if tok == gpu.end_id or counts[slot] >= MAX_NEW:
                gpu.clear_slot(slot)
                cpu.clear_slot(slot)
    return worst, agree / max(1, total)


# -- phase 6: beam search on the paged engine, the dense generator and the
# full re-run decoder ----------------------------------------------------------

# 4 sources of 64 .. src_len tokens, W beams, MAX_NEW steps each
BEAM_SOURCES, BEAM_W = 4, 4
# the smaller model the full re-run decoder is held to the others at
RERUN_LAYERS = 2
# card vs CPU beam scores, float32 pool: fp32 end to end, summation
# order only (the ragged kernel's split walk, cuBLAS against the CPU's
# GEMMs), 1e-4 relative as the reference holds its dense and paged beams
BEAM_SCORE_RTOL, BEAM_SCORE_ATOL = 1e-4, 1e-5
# the bf16 and int8 pools' beams against the float32 pool's (ids that
# agree), as tests/test_paged_serving.py holds the int8 pool's
BEAM_AGREE = 0.9


def beam_sources(np):
    """BEAM_SOURCES seeded prompts -> (tokens [b, src_len], lengths)."""
    seqs = prompts(np, SEED + 2)[:BEAM_SOURCES]
    tok = np.zeros((len(seqs), SERVE["src_len"]), np.int64)
    for i, q in enumerate(seqs):
        tok[i, :len(q)] = q
    return tok, np.asarray([len(q) for q in seqs], np.int32)


def score_tol(kv, t):
    """How far two runs' accumulated scores may drift apart after step t
    (1-based): float32 pools by the reference's 1e-4 relative; bf16 and
    int8 pools by the teacher-forced logit limit, twice a step (a
    log-softmax moves by at most twice its logits' largest change)."""
    if kv == "float32":
        return lambda x: BEAM_SCORE_ATOL + BEAM_SCORE_RTOL * abs(x)
    return lambda x: 2 * LOGIT_ATOL[kv] * t


@contextlib.contextmanager
def watch_runs(exe, prog, on_run, extra_fetch=(), on_start=None):
    """While active, each ``exe.run`` of ``prog`` also fetches
    ``extra_fetch`` and calls ``on_run(feed, outs, seconds)`` (host
    clock, the fetch's wait included), after ``on_start()`` if given;
    the caller gets the outputs it asked for, or what ``on_run`` returns
    in their place when that is not None."""
    real = exe.run

    def run(program=None, feed=None, fetch_list=None, *a, **kw):
        if program is not prog:
            return real(program, feed, fetch_list, *a, **kw)
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        outs = real(program, feed, list(fetch_list) + list(extra_fetch),
                    *a, **kw)
        given = on_run(feed, outs, time.perf_counter() - t0)
        return outs[:len(fetch_list)] if given is None else given

    exe.run = run
    try:
        yield
    finally:
        exe.run = real


def beam_margin(np, pre_ids, pre_scores, scores, W, end_id):
    """One beam step's margin: the smallest gap between neighbours among
    the W+1 best candidate totals (pre_score + log p; a finished beam,
    whose last id is ``end_id``, keeps its total frozen in its first
    candidate), the smallest over sources.  Where two runs' float errors
    exceed it, they may rightly select differently."""
    total = pre_scores[..., None] + np.log(np.clip(scores, 1e-12, None))
    frozen = np.full_like(total, -1e9)
    frozen[..., 0] = pre_scores
    total = np.where((pre_ids == end_id)[..., None], frozen, total)
    best = -np.sort(-total.reshape(len(total), -1), axis=1)[:, :W + 1]
    return float((best[:, :-1] - best[:, 1:]).min())


def cpu_beam(np, gen, W, tok, lens, max_new, follow=None):
    """The CPU generator's beam over the sources, with each step's
    margin (``beam_margin``).  With ``follow``, another run's
    trajectory (the third item of ``beam(return_trace=True)``), each
    step hands the beam loop that run's selection in place of its own:
    the CPU decodes along that trajectory (teacher-forced) and makes
    each of its own selections from the same ids and scores as that
    run.  -> (beam result, margins by step, the CPU's own (ids, scores,
    parents) by step)."""
    prog = gen._beam_steps.get(W) or gen._build_beam_step(W)
    topk = next(op for op in prog[0].global_block().ops
                if op.type == "top_k").output("Out")[0]
    margins, own = [], []

    def on_run(feed, outs, _s):
        margins.append(beam_margin(np, feed["pre_ids"], feed["pre_scores"],
                                   np.asarray(outs[3], np.float32), W,
                                   gen.end_id))
        own.append(tuple(np.asarray(x) for x in outs[:3]))
        if follow is not None:
            return [steps[len(own)] for steps in follow]
        return None

    with watch_runs(gen.exe, prog[0], on_run, [topk]):
        res = gen.beam(tok, lens, beam_size=W, max_new=max_new,
                       return_trace=True)
    return res, margins, own


def rounding(np, scores):
    """A float32 ulp at the largest selected score's magnitude: how far
    rounding the sum pre_score + log p may move a total (totals of
    pruned candidates, at -1e9, left out)."""
    live = np.abs(scores[scores > -1e8])
    return float(np.spacing(np.float32(live.max()))) if live.size else 0.0


def compare_beams(np, got, want, margins, kv, logit_err):
    """Two beam results step by step: ids and parents equal, scores
    within ``score_tol(kv, t)``, and the same backtrace.  The float
    error between the runs' candidate totals at step t is a fixed
    bound: a candidate's total moves by at most a step's log-probability
    error (twice ``logit_err``, the runs' largest logit difference
    teacher-forced) and a rounding each step, and two candidates' order
    within twice that sum.  A step whose margin (``margins``, the CPU
    run's, ``cpu_beam``) is within it is a near tie, listed; a first
    difference at a near tie is a selection the runs may rightly make
    apart (``tie_at``), and the steps after it are not compared here
    (``compare_forced`` compares them).  -> record with ``ok``."""
    (g_ids, g_sc, (gi, gs, gp)), (w_ids, w_sc, (wi, ws, wp)) = got, want
    rec = {"steps": len(gi) - 1, "max_score_diff": 0.0, "tie_at": None,
           "near_ties": [], "ok": True}
    drift = 0.0
    for t in range(1, min(len(gi), len(wi))):
        tol = score_tol(kv, t)
        drift += 2 * logit_err + rounding(np, ws[t])
        err = 2 * drift
        m = margins[t - 1] if t - 1 < len(margins) else None
        if m is not None and m <= err:
            rec["near_ties"].append({"step": t, "margin": m,
                                     "float_error": err})
        if not (np.array_equal(gi[t], wi[t]) and np.array_equal(gp[t],
                                                                 wp[t])):
            if m is not None and m <= err:
                rec["tie_at"] = {"step": t, "margin": m,
                                 "float_error": err}
            else:
                rec["ok"] = False
                rec["first_difference"] = {"step": t, "margin": m,
                                           "float_error": err}
            return rec
        diff = float(np.abs(gs[t] - ws[t]).max())
        rec["max_score_diff"] = max(rec["max_score_diff"], diff)
        if not np.all(np.abs(gs[t] - ws[t]) <= np.vectorize(tol)(ws[t])):
            rec["ok"] = False
            rec["score_step"] = t
            return rec
    same = len(gi) == len(wi) and all(
        np.array_equal(np.asarray(getattr(g_ids, f)),
                       np.asarray(getattr(w_ids, f)))
        for f in ("data", "outer_lengths", "inner_lengths"))
    rec["same_backtrace"] = same
    rec["ok"] = rec["ok"] and same
    return rec


def compare_forced(np, own, trace, margins, kv, logit_err):
    """The CPU's own selections along the card's trajectory (``cpu_beam``
    with ``follow``, its ``own`` and ``margins``) against the card's
    ``trace``, at every step.  Both make a step's selection from the same
    ids and scores, so a candidate's totals differ by one step's
    log-probability error (twice ``logit_err``) and a rounding, and two
    candidates' order may flip only within twice that.  Ids and parents
    must be equal at every step whose margin exceeds it; a difference
    within it is a near tie, listed in ``ties``; a step selected alike
    has its scores within ``score_tol(kv, 1)``.  -> record with
    ``ok``."""
    ids, scores, parents = trace
    tol = np.vectorize(score_tol(kv, 1))
    rec = {"steps": len(own), "compared": 0, "max_score_diff": 0.0,
           "ties": [], "ok": len(own) == len(ids) - 1}
    for t, (o_ids, o_scores, o_parents) in enumerate(own, 1):
        err = 2 * (2 * logit_err + rounding(np, scores[t]))
        if not (np.array_equal(o_ids, ids[t])
                and np.array_equal(o_parents, parents[t])):
            at = {"step": t, "margin": margins[t - 1], "float_error": err}
            if margins[t - 1] <= err:
                rec["ties"].append(at)
            else:
                rec["ok"] = False
                rec.setdefault("differences", []).append(at)
            continue
        rec["compared"] += 1
        diff = np.abs(o_scores - scores[t])
        rec["max_score_diff"] = max(rec["max_score_diff"],
                                    float(diff.max()))
        if not np.all(diff <= tol(scores[t])):
            rec["ok"] = False
            rec.setdefault("score_steps", []).append(t)
    return rec


def step_entries(exe, prog):
    """The executor's cached entries of ``prog`` (every signature)."""
    fp = prog.desc.fingerprint()
    return [e for k, e in exe._cache.items() if k[0] == fp]


def beam_ragged_calls(fa, b, sms):
    """(ragged calls, merges) of one paged beam step over b lanes: per
    layer a self-attention over the target table and a cross-attention
    over the source table."""
    ps = SERVE["page_size"]
    tables = [-(-SERVE["max_out_len"] // ps),
              -(-SERVE["src_len"] // ps)] * MODEL["n_layer"]
    merges = sum(fa.ragged_plan(b, MODEL["n_head"], p, sms)[1] > 1
                 for p in tables)
    return len(tables), merges


def beam_kernel_check(torch, fa, scope, prog, feeds):
    """Every ``ragged_decode_attention`` op of the paged beam step
    ``prog`` through the wrapper against the plain version, at the op's
    own arguments from each of ``feeds`` (beam steps' feeds: the b*W
    lanes' page tables, shared between beams, their lengths and bases)
    over the pool and scales in ``scope`` as the run left them, with a
    seeded query of the step's shape, [b*W, 1, H, D].  -> {calls, lanes
    (the batch sizes called), plans (``last_plan``), max_abs_err,
    ok}."""
    ops = [op for op in prog.global_block().ops
           if op.type == "ragged_decode_attention"]
    gen = torch.Generator()
    gen.manual_seed(SEED)
    lanes, plans, worst, ok = set(), set(), 0.0, True
    for feed in feeds:
        for op in ops:
            pool = scope.find_var(op.input("Pool")[0])
            scales = (scope.find_var(op.input("Scales")[0])
                      if op.input("Scales") else None)
            table, lengths = (torch.as_tensor(feed[op.input(k)[0]]).to(
                pool.device) for k in ("PageTable", "Lengths"))
            q_base = (torch.as_tensor(feed[op.input("QBase")[0]]).to(
                pool.device) if op.input("QBase") else None)
            q = torch.randn(table.shape[0], 1, MODEL["n_head"],
                            MODEL["d_key"], generator=gen).to(pool.device)
            kw = {k: op.attr(k) for k in ("layer", "n_layer", "causal",
                                          "sm_scale")}
            got = fa.ragged_decode_attention(q, pool, table, lengths,
                                             q_base, scales=scales, **kw)
            plans.add(getattr(fa.ragged_decode_attention, "last_plan",
                              None))
            want = fa.ragged_attention_plain(
                q, pool, table, lengths,
                torch.zeros_like(lengths) if q_base is None else q_base,
                kw["layer"],
                kw["n_layer"], kw["causal"], kw["sm_scale"], scales=scales)
            worst = max(worst, float((got - want).abs().max()))
            ok = ok and bool(torch.allclose(got, want, atol=KERNEL_ATOL,
                                            rtol=KERNEL_RTOL))
            lanes.add(int(table.shape[0]))
    return {"calls": len(ops) * len(feeds), "lanes": sorted(lanes),
            "plans": sorted(plans, key=str), "max_abs_err": worst, "ok": ok}


def beam_on_card(torch, np, fa, g, tok, lens, sms):
    """The paged beam on the card, twice over the same sources: the
    first run captures the unified step at b lanes, the beam step at
    (b, W) and the backtrace at the trajectory's length; the second,
    counted from zero, replays them (its ragged launches on the beam
    steps, step times on the host clock).  Then the beam step's ragged
    calls are held against the plain version at the arguments of the
    second run's first and last beam steps (``beam_kernel_check``).
    -> (record, second run's result)."""
    W = BEAM_W
    prog = (g._beam_steps.get(W) or g._build_beam_step(W))[0]
    n_calls, n_merges = beam_ragged_calls(fa, len(tok) * W, sms)
    pool = {n: (t, t.data_ptr()) for n, t in (
        (n, g.scope.find_var(n)) for n in (g._pool_name, g._scales_name))
            if t is not None}
    cow0 = g.cache_stats()["pages"]["cow_copies"]
    st0 = g.cache_stats()["executable"]
    g.beam(tok, lens, beam_size=W, max_new=MAX_NEW)
    torch.cuda.synchronize()
    st1 = g.cache_stats()["executable"]
    step_s, per_step, at_start, feeds = [], [], [], []

    def on_run(feed, _outs, sec):
        step_s.append(sec)
        per_step.append(fa.ragged_decode_attention.launches - at_start[-1])
        feeds.append(feed)

    fa.ragged_decode_attention.launches = 0
    with watch_runs(g.exe, prog, on_run, on_start=lambda: at_start.append(
            fa.ragged_decode_attention.launches)):
        t0 = time.perf_counter()
        res = g.beam(tok, lens, beam_size=W, max_new=MAX_NEW,
                     return_trace=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fa.ragged_decode_attention.launches
    st2 = g.cache_stats()["executable"]
    steps = len(res[2][0]) - 1
    entries = step_entries(g.exe, prog)
    fams = graph_families(kernel_nodes(entries[0].graph)[0]) \
        if len(entries) == 1 and entries[0].graph is not None else None
    pages = g.cache_stats()["pages"]
    try:
        g.alloc.check_invariants()
        invariants = True
    except AssertionError:
        invariants = False
    kernel = beam_kernel_check(torch, fa, g.scope, prog,
                               (feeds[0], feeds[-1]))
    torch.cuda.synchronize()
    rec = {
        "steps": steps, "beam_step_ms_median":
            statistics.median(step_s) * 1e3 if step_s else None,
        "beam_step_ms": [x * 1e3 for x in step_s],
        "hyp_tok_per_s": len(tok) * W * steps / sum(step_s),
        "beam_wall_s": wall,
        "first_run_executable": {k: st1[k] - st0[k]
                                 for k in ("hits", "misses")},
        "second_run_executable": {k: st2[k] - st1[k]
                                  for k in ("hits", "misses")},
        "beam_step_entries": len(entries),
        "ragged_launches": launches,
        "ragged_per_beam_step": sorted(set(per_step)),
        "graph_by_family": fams,
        "want_graph": {"ragged_split": n_calls, "ragged_merge": n_merges},
        "kernel_vs_plain": kernel,
        "pool_held_once": pool_held_once(g, pool),
        "cow_copies": pages["cow_copies"] - cow0,
        "in_use": pages["in_use"], "invariants": invariants}
    # the first run misses the unified step at b lanes, the beam step at
    # (b, W) and the backtrace at its length; the second misses nothing;
    # the kernel check makes each of the step's ragged calls at its
    # first and last step, at the step's b*W lanes
    rec["ok"] = bool(
        kernel["ok"] and kernel["calls"] == 2 * n_calls
        and kernel["lanes"] == [len(tok) * W]
        and rec["second_run_executable"]["misses"] == 0
        and rec["second_run_executable"]["hits"] >= steps + 1
        and rec["first_run_executable"]["misses"] == 3
        and len(entries) == 1 and len(step_s) == steps
        and per_step == [n_calls] * steps
        and fams == rec["want_graph"] and rec["pool_held_once"]
        and rec["cow_copies"] > 0 and rec["in_use"] == 0 and invariants)
    return rec, res


def beam_phase(torch, np, fluid, fa, card, weights, srcs, logit_err):
    """Phase 6: beam search on the paged engine for each pool dtype (the
    card's run against the CPU port's from the same weights; bf16 and
    int8 against the float32 pool's), against the dense generator's
    beam on the card, then the dense generator's greedy through the
    scheduler against the paged generator's, and the full re-run
    decoder at RERUN_LAYERS layers against both.  ``logit_err``: each
    pool dtype's card-vs-CPU logit difference, teacher-forced (the
    serving phase's), which sizes the float error a near tie is judged
    by.  -> (record, ragged launches of the paged beam runs, worst
    kernel error, failures)."""
    from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                          FullRerunDecoder,
                                          TransformerGenerator)
    failures = []
    tok, lens = beam_sources(np)
    sms = fa._sm_count(0)
    rec = {"card": card, "sources": len(tok), "beam": BEAM_W,
           "max_new": MAX_NEW, "paged": {}}
    launches, kernel_err = 0, 0.0
    card_runs = {}
    for kv in KV_DTYPES:
        t0 = time.perf_counter()
        g = make_generator("cuda", kv)
        g.load_params(weights)
        run, res = beam_on_card(torch, np, fa, g, tok, lens, sms)
        launches += run["ragged_launches"]
        kernel_err = max(kernel_err, run["kernel_vs_plain"]["max_abs_err"])
        card_runs[kv] = res
        del g
        torch.cuda.empty_cache()
        cpu = make_generator("cpu", kv)
        cpu.load_params(weights)
        want, margins, _ = cpu_beam(np, cpu, BEAM_W, tok, lens, MAX_NEW)
        forced, f_margins, own = cpu_beam(np, cpu, BEAM_W, tok, lens,
                                          MAX_NEW, follow=res[2])
        del cpu
        run["vs_cpu"] = compare_beams(np, res, want, margins, kv,
                                      logit_err[kv])
        # every step, the CPU selecting along the card's trajectory; its
        # backtrace of that trajectory is the card's
        run["vs_cpu_forced"] = compare_forced(np, own, res[2], f_margins,
                                              kv, logit_err[kv])
        run["vs_cpu_forced"]["same_backtrace"] = all(
            np.array_equal(np.asarray(getattr(forced[0], f)),
                           np.asarray(getattr(res[0], f)))
            for f in ("data", "outer_lengths", "inner_lengths"))
        if kv == "float32":
            rec["cpu_margins"] = margins
        else:
            a, b = (np.asarray(card_runs[k][0]) for k in ("float32", kv))
            n = min(a.shape[-1], b.shape[-1])
            run["ids_agree_with_float32"] = float(
                (a[..., :n] == b[..., :n]).mean())
            if not run["ids_agree_with_float32"] >= BEAM_AGREE:
                failures.append(f"beam {kv}: ids agree with the float32 "
                                f"pool's beam on "
                                f"{run['ids_agree_with_float32']}, want "
                                f">= {BEAM_AGREE}")
        for how, ties in (("", run["vs_cpu"]["near_ties"]),
                          (" teacher-forced", run["vs_cpu_forced"]["ties"])):
            for tie in ties:
                log(f"beam {kv}{how}: candidate margin {tie['margin']} at "
                    f"step {tie['step']} within the float error "
                    f"{tie['float_error']} ({card})")
        if not run["ok"]:
            failures.append(f"beam {kv} on the card: {run}")
        if not run["vs_cpu"]["ok"]:
            failures.append(f"beam {kv}: card vs CPU {run['vs_cpu']}")
        if not (run["vs_cpu_forced"]["ok"]
                and run["vs_cpu_forced"]["same_backtrace"]):
            failures.append(f"beam {kv}: card vs CPU teacher-forced "
                            f"{run['vs_cpu_forced']}")
        run["seconds"] = time.perf_counter() - t0
        rec["paged"][kv] = run
        log(f"beam {kv}: {json.dumps(run)}")

    # the dense generator on the card, same weights, causal encoder
    place = fluid.CUDAPlace(0)
    dense = TransformerGenerator(
        VOCAB, VOCAB, place=place, causal_encoder=True,
        scope=fluid.scope_from_numpy(weights, place),
        max_length=SERVE["max_length"], src_len=SERVE["src_len"],
        max_out_len=SERVE["max_out_len"], **MODEL)
    dense_prog = dense._build_beam_step(BEAM_W)[0]
    dense.beam(tok, lens, beam_size=BEAM_W, max_new=MAX_NEW)     # captures
    step_s = []
    with watch_runs(dense.exe, dense_prog,
                    lambda _f, _o, sec: step_s.append(sec)):
        d_res = dense.beam(tok, lens, beam_size=BEAM_W, max_new=MAX_NEW,
                           return_trace=True)
    d_cmp = compare_beams(np, card_runs["float32"], d_res,
                          rec.get("cpu_margins", []), "float32",
                          logit_err["float32"])
    rec["dense"] = {"beam_step_ms_median": statistics.median(step_s) * 1e3,
                    "hyp_tok_per_s": len(tok) * BEAM_W * len(step_s)
                    / sum(step_s),
                    "paged_vs_dense": d_cmp,
                    "executable": dense.cache_stats()["executable"]}
    if not d_cmp["ok"]:
        failures.append(f"beam: paged vs dense on the card {d_cmp}")

    # greedy streams: the dense generator behind the scheduler against
    # the paged generator behind it, the same requests
    def streams(model):
        sched = ContinuousBatchingScheduler(model, n_slots=N_SLOTS,
                                            max_new_tokens=MAX_NEW)
        reqs = [sched.submit(q, max_new_tokens=MAX_NEW) for q in srcs]
        while any(not r.done for r in reqs):
            sched.step_once()
        return [list(r.tokens) for r in reqs], [repr(r.error) for r in reqs
                                                if r.error is not None]

    d_streams, d_err = streams(dense)
    del dense
    torch.cuda.empty_cache()
    paged = make_generator("cuda", "float32")
    paged.load_params(weights)
    p_streams, p_err = streams(paged)
    del paged
    torch.cuda.empty_cache()
    rec["scheduler_dense_equals_paged"] = d_streams == p_streams
    rec["scheduler_tokens"] = sum(len(x) for x in d_streams)
    if d_err or p_err or d_streams != p_streams:
        first = next((i for i, (a, b) in enumerate(zip(d_streams,
                                                       p_streams))
                      if a != b), None)
        failures.append(f"scheduler over the dense generator: streams "
                        f"differ from the paged generator's (request "
                        f"{first}); errors {d_err} {p_err}")

    # the full re-run decoder at RERUN_LAYERS layers against both
    small = dict(MODEL, n_layer=RERUN_LAYERS)
    place_kw = dict(place=place, max_length=SERVE["max_length"],
                    src_len=SERVE["src_len"], **small)
    paged2 = make_generator("cuda", "float32", small)
    paged2.init_params(seed=SEED + 3)
    w2 = fluid.scope_to_numpy(paged2.scope, list(paged2._param_vars()))
    dense2 = TransformerGenerator(
        VOCAB, VOCAB, causal_encoder=True,
        scope=fluid.scope_from_numpy(w2, place),
        max_out_len=SERVE["max_out_len"], **place_kw)
    full2 = FullRerunDecoder(
        VOCAB, VOCAB, causal_encoder=True,
        scope=fluid.scope_from_numpy(w2, place), trg_len=MAX_NEW,
        **place_kw)
    t0 = time.perf_counter()
    outs = {name: m.greedy(tok, lens, max_new=MAX_NEW, stop_at_end=False)
            for name, m in (("paged", paged2), ("dense", dense2),
                            ("full_rerun", full2))}
    rec["full_rerun"] = {
        "layers": RERUN_LAYERS, "seconds": time.perf_counter() - t0,
        "equal": {k: bool(np.array_equal(v, outs["paged"]))
                  for k, v in outs.items()}}
    if not all(rec["full_rerun"]["equal"].values()):
        failures.append(f"greedy at {RERUN_LAYERS} layers: paged, dense and "
                        f"full re-run differ {rec['full_rerun']}")
    del paged2, dense2, full2
    torch.cuda.empty_cache()
    return rec, launches, kernel_err, failures



# -- phases 4 and 11: flash kernels against their plain versions -----------

# kernel vs plain, same inputs on the card.  fp32: both compute in fp32
# and differ in summation order only (64-tile online softmax against one
# softmax over all keys; 64- and 256-term dots), errors ~1e-6 relative,
# and gradients sum up to 256 such terms; every kernel's products are
# three TF32 products (operands split into two TF32 parts), whose
# dropped lo*lo term and truncated lo part are below 2^-20 relative.
# bf16: fp32 sums of products of bf16 inputs, but each output is
# rounded to bf16 on both sides, and a value near a rounding boundary
# moves by one bf16 ulp (2^-8 relative); the forward kernel also rounds
# the dropped probabilities to bf16 before p.v, as the reference's
# kernel does (the plain version keeps them fp32), at most 2^-9 of each
# term, and the terms' rounding errors, of either sign, mostly cancel.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_SHAPE = dict(B=8, H=8)
# the head widths the kernels are built for besides 64, and one they pad
NARROW_WIDTHS, PADDED_WIDTH = (8, 16, 32), 24
# heads wider than 64, which run the wide kernels in 64-column chunks (80
# padded to 128)
WIDE_WIDTHS = (80, 128, 256)


def flash_cases():
    """Argument sets at B=8, L=256, H=8, D=64 in 'blhd': causal and not,
    dropout 0 and 0.1, fp32 and bf16; the two bias shapes (forward only:
    the backward with a bias is the plain one); Lq=200 against Lk=136;
    causal block_offsets (0, 256), where every row is dead; then the
    edges of the backward's 16-row warp tiles and 8-column steps: Lq=77
    against Lk=45 and 45 against 77, causal and not, dropout 0.1, in
    fp32; in bf16 (the warpgroup kernels' 64-row tiles) 77x45, 45x77 and
    200x136, causal and not, dropout 0.1, and the dead rows; and one
    'bhld' case in each dtype.  Then the other built
    head widths, D = 8, 16 and 32, in fp32 and bf16, causal with dropout
    0.1 at 256x256 and at the ragged 77x45 edge, and the padded width
    D = 24 at both.  Then the widths above 64 (WIDE_WIDTHS), fp32 and
    bf16, causal with dropout 0.1 at 256x256, and at 77x45 non-causal in
    fp32 without and (forward only) with a bias.  A case without a
    ``layout`` is 'blhd', without a ``d`` D = 64."""
    cases = [dict(dtype=dt, causal=c, rate=r, lq=256, lk=256, bias=None,
                  offsets=None, grads=True)
             for dt in ("float32", "bfloat16") for c in (False, True)
             for r in (0.0, 0.1)]
    cases += [dict(dtype="float32", causal=False, rate=0.0, lq=256, lk=256,
                   bias=b, offsets=None, grads=False) for b in ("b1", "1h")]
    cases += [dict(dtype="float32", causal=c, rate=0.1, lq=200, lk=136,
                   bias=None, offsets=None, grads=True)
              for c in (False, True)]
    cases.append(dict(dtype="float32", causal=True, rate=0.0, lq=256,
                      lk=256, bias=None, offsets=(0, 256), grads=True))
    cases += [dict(dtype="float32", causal=c, rate=0.1, lq=lq, lk=lk,
                   bias=None, offsets=None, grads=True)
              for lq, lk in ((77, 45), (45, 77)) for c in (False, True)]
    # bf16 at D = 64 (the warpgroup kernels) at the same edges
    cases += [dict(dtype="bfloat16", causal=c, rate=0.1, lq=lq, lk=lk,
                   bias=None, offsets=None, grads=True)
              for lq, lk in ((77, 45), (45, 77), (200, 136))
              for c in (False, True)]
    cases.append(dict(dtype="bfloat16", causal=True, rate=0.0, lq=256,
                      lk=256, bias=None, offsets=(0, 256), grads=True))
    cases += [dict(dtype=dt, causal=True, rate=0.1, lq=200, lk=136,
                   bias=None, offsets=None, grads=True, layout="bhld")
              for dt in ("float32", "bfloat16")]
    cases += [dict(dtype=dt, causal=True, rate=0.1, lq=lq, lk=lk, bias=None,
                   offsets=None, grads=True, d=d)
              for d in NARROW_WIDTHS for dt in ("float32", "bfloat16")
              for lq, lk in ((256, 256), (77, 45))]
    cases += [dict(dtype="float32", causal=True, rate=0.1, lq=lq, lk=lk,
                   bias=None, offsets=None, grads=True, d=PADDED_WIDTH)
              for lq, lk in ((256, 256), (77, 45))]
    cases += [dict(dtype=dt, causal=True, rate=0.1, lq=256, lk=256,
                   bias=None, offsets=None, grads=True, d=d)
              for d in WIDE_WIDTHS for dt in ("float32", "bfloat16")]
    cases += [dict(dtype="float32", causal=False, rate=0.1, lq=77, lk=45,
                   bias=b, offsets=None, grads=b is None, d=d)
              for d in WIDE_WIDTHS for b in (None, "b1")]
    return cases


def _case_name(c):
    return (f"{c['dtype']}/{'causal' if c['causal'] else 'full'}/"
            f"p{c['rate']}/{c['lq']}x{c['lk']}"
            + (f"/bias_{c['bias']}" if c["bias"] else "")
            + (f"/off{c['offsets']}" if c["offsets"] else "")
            + (f"/{c['layout']}" if "layout" in c else "")
            + (f"/D{c['d']}" if "d" in c else ""))


def _max_err(torch, got, want):
    """(max |got - want| over finite entries, max |want| there); the
    error is +inf where the two differ in which entries are infinite."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        return float("inf"), 0.0
    if not fin.any():
        return 0.0, 0.0
    return ((got[fin] - want[fin]).abs().max().item(),
            want[fin].abs().max().item())


def kernel_names(torch, fn):
    """The kernels one call of ``fn`` runs on the device, by their source
    names (``dq_wg_kernel``, ``fwd_kernel``, ...: the identifier in each
    mangled name of ``graph_kernels``)."""
    return sorted({source_name(n) for n in graph_kernels(torch, [fn])}
                  - {None})


def wg_kernels_ran(torch, fa, args):
    """{"dq": ..., "dkv": ...}: did the dq and dk/dv wrappers on ``args``
    (bf16, D = 64) run the warpgroup kernels, ``dq_wg_kernel`` and
    ``dkv_wg_kernel``?"""
    names = kernel_names(torch, lambda: (
        fa._flash_dq_cuda(*args), fa._flash_dkv_cuda(*args)))
    ran = {k: f"{k}_wg_kernel" in names for k in ("dq", "dkv")}
    if not all(ran.values()):
        log(f"flash bf16 D=64 backward ran {names}")
    return ran


def run_flash_case(torch, fa, case, dev, gen):
    """One case: kernels and plain versions on the same inputs -> (name,
    {tensor: max_abs_err}, ok).  A tensor passes when its error is within
    the dtype's tolerance times max(1, its largest magnitude); a bf16
    D = 64 case passes only if its backward ran the warpgroup kernels."""
    B, H, D = FLASH_SHAPE["B"], FLASH_SHAPE["H"], case.get("d", 64)
    dt = getattr(torch, case["dtype"])
    lq, lk = case["lq"], case["lk"]
    layout = case.get("layout", "blhd")

    def randn(l):
        shape = (B, l, H, D) if layout == "blhd" else (B, H, l, D)
        return torch.randn(*shape, generator=gen).to(dev, dt)

    q, k, v, dout = randn(lq), randn(lk), randn(lk), randn(lq)
    bias = None
    if case["bias"]:
        shape = (B, 1, lq, lk) if case["bias"] == "b1" else (1, H, lq, lk)
        bias = torch.randn(*shape, generator=gen).to(dev)
    cfg = (case["causal"], D ** -0.5, case["rate"], SEED if case["rate"]
           else 0, layout, case["offsets"] or (0, 0))
    out, lse = fa._flash_fwd_cuda(q, k, v, bias, *cfg)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, bias, *cfg)
    errs = {"out": _max_err(torch, out, p_out),
            "lse": _max_err(torch, lse, p_lse)}
    if case["grads"]:
        args = (q, k, v, out, dout, lse, torch.empty_like(lse), *cfg)
        dq = fa._flash_dq_cuda(*args)
        dk, dv = fa._flash_dkv_cuda(*args)
        want = fa.flash_backward_plain(q, k, v, p_out, dout, p_lse, None,
                                       *cfg)
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            errs[name] = _max_err(torch, g, w)
    torch.cuda.synchronize()
    tol = FLASH_TOL[case["dtype"]]
    ok = all(e <= tol * max(1.0, mag) for e, mag in errs.values())
    if case["grads"] and case["dtype"] == "bfloat16" and D == 64:
        ok = ok and all(wg_kernels_ran(torch, fa, args).values())
    if case["offsets"] == (0, case["lk"]) and case["causal"]:
        ok = ok and not out.any().item() and bool(torch.isinf(lse).all())
    return _case_name(case), {n: e for n, (e, _) in errs.items()}, ok


# the bf16 kernels round p (forward) and ds and p * keep (backward) to
# bf16 where the reference's kernels round them, at every head width:
# the widths besides 64 held to that rounding, emulated, within one bf16
# ulp of each output's largest magnitude (tests/test_torch_flash.py's
# emulation, as it holds D = 64 against the reference's Pallas kernels)
ROUNDING_WIDTHS = (8, 32, 128)


def bf16_rounding_emulation(torch, fa, q, k, v, out, lse, dout, causal,
                            rate, seed, tile=64, part=32):
    """The reference's bf16 rounding on [B, H, L, D] bf16 tensors, in
    fp32: the forward's online softmax over ``tile``-key tiles with the
    dropped p rounded to bf16 before p.v (``part``-key fresh partials),
    l the sum of the unrounded p, out rounded to bf16; the backward from
    the kernel's own (out, lse): ds = p * (dp * keep - delta) * scale and
    p * keep rounded to bf16 before the products they feed, the
    gradients rounded to bf16.  -> (out, dq, dk, dv)."""
    bf = torch.bfloat16
    sm_scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, dout))
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq, device=q.device)
    m = torch.full(q.shape[:3], -float("inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, lk, tile):
        cols = torch.arange(k0, min(k0 + tile, lk), device=q.device)
        s = torch.matmul(qf, kf[:, :, cols].transpose(-1, -2)) * sm_scale
        if causal:
            s = s.masked_fill(rows[:, None] < cols[None, :], -float("inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_sub = torch.where(torch.isinf(m_new), 0.0, m_new)
        alpha = torch.exp(m - m_sub)
        p = torch.exp(s - m_sub[..., None])
        l = alpha * l + p.sum(dim=-1)
        pd = (p * fa._plain_keep(q, rows, cols, rate, seed)).to(bf).float()
        vt = vf[:, :, cols]
        acc = acc * alpha[..., None] + sum(
            torch.matmul(pd[..., c:c + part], vt[:, :, c:c + part])
            for c in range(0, len(cols), part))
        m = m_new
    e_out = (acc / l[..., None]).to(bf)
    cols = torch.arange(lk, device=q.device)
    x = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        x = x.masked_fill(rows[:, None] < cols[None, :], -float("inf"))
    p = torch.exp(x - lse[..., None])
    keep = fa._plain_keep(q, rows, cols, rate, seed)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (of * dof).sum(dim=-1)
    ds = (p * (dp * keep - delta[..., None]) * sm_scale).to(bf).float()
    pk = (p * keep).to(bf).float()
    grads = (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
             torch.matmul(pk.transpose(-1, -2), dof))
    return (e_out, *(g.to(bf) for g in grads))


def rounding_check(torch, fa, dev, gen):
    """The bf16 kernels at ROUNDING_WIDTHS (B=2, H=2, L=256, 'bhld',
    dropout 0.1, causal and not) against ``bf16_rounding_emulation``:
    each output's largest error in bf16 ulps of its largest magnitude
    (``ulps``, at most 1 to pass), and its mean error against the
    emulation and against the plain version, which keeps p and ds in
    fp32 (``mean_emulation``, ``mean_plain``: the kernel must be no
    farther from the emulation; one ulp alone does not tell the two
    apart) -> {case: {tensor: {...}}}."""
    out = {}
    for d in ROUNDING_WIDTHS:
        for causal in (False, True):
            q, k, v, dout = (torch.randn(2, 2, 256, d, generator=gen).to(
                dev, torch.bfloat16) for _ in range(4))
            cfg = (causal, d ** -0.5, 0.1, SEED, "bhld", (0, 0))
            o, lse = fa._flash_fwd_cuda(q, k, v, None, *cfg)
            args = (q, k, v, o, dout, lse, torch.empty_like(lse), *cfg)
            got = (o, fa._flash_dq_cuda(*args), *fa._flash_dkv_cuda(*args))
            want = bf16_rounding_emulation(torch, fa, q, k, v, o, lse, dout,
                                           causal, 0.1, SEED)
            p_out, _ = fa.flash_forward_plain(q, k, v, None, *cfg)
            plain = (p_out, *fa.flash_backward_plain(q, k, v, o, dout, lse,
                                                     None, *cfg)[:3])
            errs = {}
            for name, g, w, pl in zip(("out", "dq", "dk", "dv"), got, want,
                                      plain):
                g, w, pl = g.float(), w.float(), pl.float()
                mag = float(w.abs().max())
                ulp = 2.0 ** (math.floor(math.log2(mag)) - 7)
                errs[name] = {
                    "ulps": float((g - w).abs().max()) / ulp,
                    "mean_emulation": float((g - w).abs().mean()) / ulp,
                    "mean_plain": float((g - pl).abs().mean()) / ulp}
            out[f"D{d}/{'causal' if causal else 'full'}"] = errs
    torch.cuda.synchronize()
    return out


def dropout_mask_probe(torch, fa, dev, dtype="float32"):
    """The kernels' dropout masks, compared exactly with keep_scale, on
    ``dtype`` inputs.  With q = k = 0 every probability is 1/256 (exact),
    so with v one-hot on key 64*g + d the forward's out[r, d] is keep(r,
    64g + d) / 256, and with dout one-hot on row 64*g + d the dk/dv
    kernel's dv[c, d] is keep(64g + d, c) / 256.  Which entries are zero
    must equal keep_scale's mask exactly.  In bf16 the forward rounds
    p * keep to bf16 before p.v (half a bf16 ulp, 2^-8 relative at
    most) and its output to bf16 (as much again), so its kept values are
    held to keep / 256 within 2^-7 relative; in fp32 only the masks are
    compared.  Returns (forward masks equal and kept values within that,
    dv masks equal)."""
    B, H, L, D, rate = 1, 2, 256, 64, 0.1
    dt = getattr(torch, dtype)
    z = torch.zeros(B, L, H, D, device=dev, dtype=dt)
    cfg = (False, D ** -0.5, rate, SEED, "blhd", (0, 0))
    lse = torch.full((B, H, L), float(math.log(L)), device=dev)
    bh = torch.arange(H, device=dev)[:, None, None]
    keep = fa.keep_scale(SEED, bh, torch.arange(L, device=dev)[:, None],
                         torch.arange(L, device=dev)[None, :], rate)
    want = keep > 0
    fwd_ok = dv_ok = True
    for g in range(L // D):
        onehot = torch.zeros(B, L, H, D, device=dev, dtype=dt)
        idx = torch.arange(D, device=dev)
        onehot[:, g * D + idx, :, idx] = 1.0
        out, _ = fa._flash_fwd_cuda(z, z, onehot, None, *cfg)
        got = out[0].permute(1, 0, 2).float()             # [H, r, d]
        cols = slice(g * D, (g + 1) * D)
        fwd_ok &= torch.equal(got > 0, want[:, :, cols])
        if dtype == "bfloat16":
            ref = keep[:, :, cols] / L
            fwd_ok &= bool(((got - ref).abs() <= 2.0 ** -7 * ref).all())
        out0 = torch.zeros_like(z)
        _, dv = fa._flash_dkv_cuda(z, z, z, out0, onehot, lse,
                                   torch.zeros_like(lse), *cfg)
        got = dv[0].permute(1, 0, 2) > 0                  # [H, c, d]
        dv_ok &= torch.equal(got, want[:, cols, :].transpose(1, 2))
    torch.cuda.synchronize()
    return bool(fwd_ok), bool(dv_ok)


def empty_keys_check(torch, fa, dev):
    """The forward with no keys (Lk = 0) at D = 32 and 64, fp32 and bf16
    (the fp32 kernel, the bf16 mma.sync and wgmma kernels' widths):
    every row is dead, out 0 and lse +inf.  Returns the failed
    (dtype, D)."""
    failed = []
    for dt in ("float32", "bfloat16"):
        for d in (32, 64):
            q = torch.randn(2, 77, 2, d, device=dev).to(getattr(torch, dt))
            kv = q[:, :0]
            out, lse = fa._flash_fwd_cuda(q, kv, kv, None, False, d ** -0.5,
                                          0.0, 0, "blhd", (0, 0))
            if out.any().item() or not bool((lse == math.inf).all()):
                failed.append((dt, d))
    return failed


def cuda_ms(torch, fn, iters):
    """ms per call of ``fn`` on the current stream: CUDA events around
    ``iters`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_host_ms(torch, fn, iters, host_us=500):
    """(ms per call of ``fn`` on the device clock, ms per call of host
    time to issue it): a sleep kernel holds the stream while the host
    issues ``iters`` calls behind it (up to ``host_us`` of host time a
    call, at 2 GHz), so the host never waits for the card, the calls
    then run back to back and CUDA events around them time the device
    alone; if the host took longer than the sleep, once more with twice
    the sleep.  Unlike ``graph_ms`` it needs no capture, so an autograd
    backward and every SDPA backend time the same way."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        torch.cuda._sleep(int(iters * host_us * 2000))
        t0.record()
        h0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - h0
        t1.record()
        torch.cuda.synchronize()
        if host_s < 0.9 * iters * host_us * 1e-6:
            break
        host_us *= 2
    return t0.elapsed_time(t1) / iters, host_s * 1e3 / iters


def device_ms(torch, fn, iters, host_us=500):
    """``device_host_ms``'s device time."""
    return device_host_ms(torch, fn, iters, host_us)[0]


def flash_bound(kind, causal, B, H, L, D, item=4, passes=1,
                flops_per_s=FP32_FLOPS_PER_S, rate=0.0, int_ops_per_s=None,
                delta=False):
    """Least time of one flash call: q, k, v (and out, dout, lse for the
    backward) read once and the outputs written once (with ``delta``, the
    bf16 D = 64 kernels' split: dq also writes the fp32 delta rows, and
    dk/dv reads them in place of out), against the dot
    products the call must do (4, 6 and 8 * L^2 * D per batch*head for
    fwd, dq and dk/dv: s and p.v; s, dp and ds.k; s, dp, p.do and ds.q),
    of which the causal mask keeps (L + 1) / 2L, done ``passes`` times
    at ``flops_per_s``, and, with dropout (``rate`` > 0), against the
    hash's HASH_ALU_OPS int32 operations on every live element at
    ``int_ops_per_s``.  The defaults are the CUDA cores' fp32 bound;
    the fp32 kernels do three TF32 products on the tensor cores
    (passes=3 at TF32_FLOPS_PER_S)."""
    keep = (L + 1) / (2 * L) if causal else 1.0
    ops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * B * H * L * L * D * keep
    t, lse = B * L * H * D * item, B * H * L * 4
    nbytes = {"fwd": 4 * t + lse, "dq": 6 * t + lse, "dkv": 7 * t + lse}[kind]
    if delta and kind != "fwd":
        nbytes += lse if kind == "dq" else lse - t
    t_ops = passes * ops / flops_per_s * 1e3
    if rate > 0 and int_ops_per_s:
        t_ops = max(t_ops, HASH_ALU_OPS * B * H * L * L * keep
                    / int_ops_per_s * 1e3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_times(torch, q, k, v, dout, causal, iters=20):
    """The library's yardstick: ``scaled_dot_product_attention`` on
    [B, H, L, D] tensors at dropout 0, under each backend this PyTorch
    offers (``torch.nn.attention.sdpa_kernel``), its forward (no grad)
    and its autograd backward (dq, dk, dv) on the device clock; and as
    the dispatcher picks (DEFAULT), on the device clock and through the
    host call by call (``*_eager``).  Returns {backend: {"fwd": ms,
    "bwd": ms}} or {backend: {"refused": why}} for a backend that does
    not take these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in SDPA_BACKENDS + ("DEFAULT",):
        backend = getattr(SDPBackend, name, None)
        if backend is None and name != "DEFAULT":
            out[name] = {"refused": "not in this PyTorch"}
            continue
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        try:
            with (sdpa_kernel([backend]) if backend is not None
                  else contextlib.nullcontext()):
                with torch.no_grad():
                    fwd = device_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            *leaves, is_causal=causal), iters)
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         is_causal=causal)
            out[name] = {"fwd": fwd, "bwd": device_ms(
                torch, lambda: torch.autograd.grad(
                    lib_out, leaves, dout, retain_graph=True), iters)}
            if backend is None:
                # the dispatcher's own pick, timed also through the
                # host: events around calls it issues one by one
                with torch.no_grad():
                    out[name]["fwd_eager"] = cuda_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            *leaves, is_causal=causal), iters)
                out[name]["bwd_eager"] = cuda_ms(
                    torch, lambda: torch.autograd.grad(
                        lib_out, leaves, dout, retain_graph=True), iters)
            del lib_out
        except RuntimeError as e:
            torch.cuda.synchronize()
            out[name] = {"refused": str(e).strip().splitlines()[0][:200]}
    return out


def flash_entry_check(torch, fa, q, k, v, dout, cfg):
    """The training path's call at its shapes, through its entry point:
    ``flash_attention`` and its autograd backward (the three kernels),
    held against the plain forward and backward on the same inputs.  The
    lse is the one the wrapper saved for its backward.  Returns (name,
    {tensor: max_abs_err}, ok) as ``run_flash_case`` does."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    causal, sm_scale, rate, seed, layout, offsets = cfg
    out = fa.flash_attention(*leaves, None, causal, sm_scale,
                             dropout_rate=rate, dropout_seed=seed,
                             layout=layout, block_offsets=offsets)
    lse = out.grad_fn.saved_tensors[-1]
    grads = torch.autograd.grad(out, leaves, dout)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, None, *cfg)
    want = fa.flash_backward_plain(q, k, v, p_out, dout, p_lse, None, *cfg)
    errs = {"out": _max_err(torch, out.detach(), p_out),
            "lse": _max_err(torch, lse, p_lse)}
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        errs[name] = _max_err(torch, g, w)
    torch.cuda.synchronize()
    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    ok = all(e <= tol * max(1.0, mag) for e, mag in errs.values())
    name = (f"flash_attention/{'causal' if causal else 'full'}/p{rate}/"
            f"B{q.shape[0]}xL{q.shape[1]}")
    return name, {n: e for n, (e, _) in errs.items()}, ok


def build_parent_flash(src_dir):
    """The parent commit's flash kernels, from ``src_dir``'s
    ``flash_attention_fwd.cu`` and, when it is there,
    ``flash_attention_bwd.cu``, with their headers beside them, built
    there with the port's nvcc flags, both at once -> {"fwd": the loaded
    forward library, "bwd": the backward's or None}."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    procs = {}
    for kind in ("fwd", "bwd"):
        src = os.path.join(src_dir, f"flash_attention_{kind}.cu")
        if kind == "fwd" or os.path.exists(src):
            lib = os.path.join(src_dir, f"libparent_flash_{kind}.so")
            procs[kind] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"bwd": None}
    for kind, (lib, proc) in procs.items():
        log_, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"parent {kind} build failed:\n{log_}")
        libs[kind] = ctypes.CDLL(lib)
    return libs


@contextlib.contextmanager
def flash_library(fa, libs):
    """The flash wrappers bound, while the block runs, to the libraries
    in ``libs`` ({kernel source name, as in ``fa.FLASH_KERNELS``: a
    library with the package's C entries and arguments}) and to the
    package's own for the other sources; then to the package's again."""
    from paddle_tpu_torch.kernels import _build

    load = _build.load_library
    _build.load_library = lambda name: libs.get(name) or load(name)
    fa._flash_entry.cache_clear()
    try:
        yield
    finally:
        _build.load_library = load
        fa._flash_entry.cache_clear()


def parent_backward(torch, fa, lib, kind, q, k, v, out, dout, lse, delta,
                    cfg):
    """The parent's dq (``kind`` "dq") or dk/dv ("dkv") through its own C
    entry, which takes the seed by value where this commit's takes its
    address: the wrapper's checks and shared arguments
    (``_flash_bwd_setup``) with the seed's value in place of its
    address, then one launch -> the gradients; ``delta`` as the
    wrappers pass it (dq writes it at bf16 D = 64, dk/dv reads it).
    (The parent's forward runs through the wrapper, whose seed address
    it reads as a value: another seed, the same work.)"""
    import ctypes

    fn = getattr(lib, f"flash_attention_{kind}")
    if fn.argtypes is None:
        n_ptrs = {"dq": 8, "dkv": 9}[kind]
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    _, common, ins = fa._flash_bwd_setup(q, k, v, out, dout, lse, *cfg)
    common = common[:-3] + (int(cfg[3]) & 0xFFFFFFFF,) + common[-2:]
    outs = ((torch.empty_like(q),) if kind == "dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    err = fn(*ins, delta.data_ptr(), *(g.data_ptr() for g in outs), *common)
    if err != 0:
        raise RuntimeError(f"parent flash {kind} launch failed: CUDA "
                           f"error {err}")
    return outs


def flash_timings(torch, fa, dev, gen, dtype="float32", int_ops=None,
                  parent=None):
    """At the training path's shapes, B=64, L=256, H=8, D=64, in
    ``dtype`` (float32, or bfloat16 as the amp recipe runs them), dropout
    0.1, non-causal and causal: first ``flash_entry_check``; then each
    flash kernel, its plain version and the library call
    (``scaled_dot_product_attention`` in the same dtype, dropout 0, its
    autograd backward for dq + dk/dv, under every SDPA backend:
    ``sdpa_times``), on the device clock (``device_ms``); the forward
    kernel also at dropout 0, like for like with the library's, through
    the wrapper call after call (``ms_eager``: events around calls the
    host issues one by one), and the host time to issue a call
    (``host_ms``); the dq and dk/dv kernels also at dropout 0
    (``ms_dropout0``), dk/dv on the delta of one dq call.  The plain
    backward computes dq, dk and dv in one call and is timed as such.
    Bounds: float32, the
    kernels' three TF32 products (the CUDA cores' fp32 bound beside);
    bfloat16, 2-byte tensors and the products at the bf16 tensor-core
    rate (one TF32 pass beside); both against the dropout hash's int32
    operations at ``int_ops`` a second.  With ``parent`` (the libraries
    of ``build_parent_flash``) the parent's forward is timed through the
    same wrapper the same ways (``parent_ms``, ``parent_host_ms``,
    ``parent_ms_dropout0``, ``parent_ms_eager``), and its dq and dk/dv,
    where it has them, through its own entries (``parent_backward``:
    ``parent_ms``, ``parent_ms_dropout0``), each in turns with the kernel
    (kernel, parent, parent, kernel: the kernel's numbers are the mean
    of its two turns).  Returns (timing rows, checks, {causal:
    sdpa_times})."""
    B, L, H, D = TRAIN_BATCH, SEQ, MODEL["n_head"], MODEL["d_key"]
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen).to(dev, dt)
                     for _ in range(4))
    item = q.element_size()
    rate = TRAIN["dropout_rate"]
    if dtype == "float32":
        # the kernels' products run as three TF32 products on the tensor
        # cores; the CUDA cores' fp32 bound beside it
        passes, flops = 3, TF32_FLOPS_PER_S
        side_key, side_flops = "bound_fp32_ms", FP32_FLOPS_PER_S
    else:
        passes, flops = 1, BF16_FLOPS_PER_S
        side_key, side_flops = "bound_tf32_ms", TF32_FLOPS_PER_S
    split = dtype == "bfloat16"          # dq writes delta for dk/dv
    rows, checks, sdpa = {}, [], {}
    for causal in (False, True):
        cfg = (causal, D ** -0.5, rate, SEED, "blhd", (0, 0))
        checks.append(flash_entry_check(torch, fa, q, k, v, dout, cfg))
        out, lse = fa._flash_fwd_cuda(q, k, v, None, *cfg)
        sdpa[causal] = sdpa_times(torch, *(
            x.transpose(1, 2).contiguous() for x in (q, k, v, dout)),
            causal)
        plain_bwd = device_ms(torch, lambda: fa.flash_backward_plain(
            q, k, v, out, dout, lse, None, *cfg), 5, host_us=5000)
        cfg0 = (causal, D ** -0.5, 0.0, 0, "blhd", (0, 0))

        def fwd_times():
            def call(c=cfg):
                return fa._flash_fwd_cuda(q, k, v, None, *c)
            # 100 calls: the host's time a call varies more than the card's
            ms, host = device_host_ms(torch, call, 100)
            return {"ms": ms, "host_ms": host,
                    "ms_dropout0": device_ms(torch, lambda: call(cfg0), 20),
                    "ms_eager": cuda_ms(torch, call, 20)}

        def bwd_times(call):
            # call(kind, cfg) launches one dq or dk/dv; the dq call first
            # leaves the delta that dk/dv reads
            call("dq", cfg)
            return {f"{kind}/{n}": device_ms(
                torch, lambda: call(kind, c), 20)
                for kind in ("dq", "dkv")
                for n, c in (("ms", cfg), ("ms_dropout0", cfg0))}

        delta = torch.empty_like(lse)
        fns = {"dq": fa._flash_dq_cuda, "dkv": fa._flash_dkv_cuda}

        def own(kind, c):
            return fns[kind](q, k, v, out, dout, lse, delta, *c)

        def in_turns(times, parent_times):
            # kernel, parent, parent, kernel -> (kernel means, parent
            # means as parent_*)
            mine, theirs = [times()], []
            if parent_times is not None:
                theirs = [parent_times(), parent_times()]
                mine.append(times())
            avg = {n: sum(x[n] for x in mine) / len(mine) for n in mine[0]}
            par = {f"parent_{n}": sum(x[n] for x in theirs) / len(theirs)
                   for n in (theirs[0] if theirs else ())}
            return avg, par

        def parent_fwd():
            with flash_library(fa, {"flash_attention_fwd": parent["fwd"]}):
                return fwd_times()

        fwd, par = in_turns(fwd_times, parent and parent_fwd)
        bwd, bpar = in_turns(lambda: bwd_times(own), (
            parent and parent["bwd"] and (lambda: bwd_times(
                lambda kind, c: parent_backward(
                    torch, fa, parent["bwd"], kind, q, k, v, out, dout,
                    lse, delta, c)))))
        t = {"fwd": fwd["ms"], "dq": bwd["dq/ms"], "dkv": bwd["dkv/ms"]}
        # which device kernels one call of each runs
        ran = {"fwd": kernel_names(
            torch, lambda: fa._flash_fwd_cuda(q, k, v, None, *cfg))}
        ran.update({kind: kernel_names(torch, lambda: own(kind, cfg))
                    for kind in ("dq", "dkv")})
        plain = {"fwd": device_ms(torch, lambda: fa.flash_forward_plain(
            q, k, v, None, *cfg), 5, host_us=5000),
            "dq": plain_bwd, "dkv": plain_bwd}
        for kind in ("fwd", "dq", "dkv"):
            b_ms, b_by = flash_bound(kind, causal, B, H, L, D, item, passes,
                                     flops, rate=rate, int_ops_per_s=int_ops,
                                     delta=split)
            side_ms, _ = flash_bound(kind, causal, B, H, L, D, item,
                                     flops_per_s=side_flops, delta=split)
            rows[(kind, causal)] = {
                "kernel": kind, "dtype": dtype, "causal": causal,
                "ms": t[kind], "plain_ms": plain[kind], "bound_ms": b_ms,
                "bound_by": b_by, side_key: side_ms,
                "device_kernels": ran[kind]}
        for kind in ("fwd", "dq", "dkv"):
            b0_ms, _ = flash_bound(kind, causal, B, H, L, D, item, passes,
                                   flops, delta=split)
            rows[(kind, causal)]["bound_dropout0_ms"] = b0_ms
        rows[("fwd", causal)].update(ms_dropout0=fwd["ms_dropout0"],
                                     ms_eager=fwd["ms_eager"],
                                     host_ms=fwd["host_ms"], **par)
        for kind in ("dq", "dkv"):
            row = rows[(kind, causal)]
            row["ms_dropout0"] = bwd[f"{kind}/ms_dropout0"]
            for n in ("ms", "ms_dropout0"):
                if f"parent_{kind}/{n}" in bpar:
                    row[f"parent_{n}"] = bpar[f"parent_{kind}/{n}"]
        del out, lse
    return rows, checks, sdpa


def backend_mix(sdpa, kind):
    """{SDPA backend: its ``kind`` ("fwd", "bwd", or for DEFAULT also
    "fwd_eager", "bwd_eager") ms over the training step's 12 full and 6
    causal attentions, or why it refused}"""
    out = {}
    for name in sdpa[False]:
        full, causal = sdpa[False][name], sdpa[True][name]
        if kind in full and kind in causal:
            out[name] = ((ATTN_PER_STEP - CAUSAL_PER_STEP) * full[kind]
                         + CAUSAL_PER_STEP * causal[kind]) / ATTN_PER_STEP
        else:
            out[name] = "refused: " + (full.get("refused")
                                       or causal.get("refused"))
    return out


def fastest_backend(by_backend):
    """(backend, ms) of the fastest of ``backend_mix``'s backends (the
    dispatcher's pick is one of them)."""
    timed = {n: ms for n, ms in by_backend.items()
             if n in SDPA_BACKENDS and isinstance(ms, float)}
    if not timed:
        return None, None
    name = min(timed, key=timed.get)
    return name, timed[name]


def flash_wide_timings(torch, fa, dev, gen):
    """ms per call of each flash kernel at every width in WIDE_WIDTHS and
    at 64 beside them: B=8, L=256, H=8, fp32, non-causal, dropout 0.1
    ('blhd'), on the device clock (``graph_ms`` over 20 calls: at this
    shape a D = 64 call takes less than the host needs to issue one).
    Speed above 64 is not tuned; this records it."""
    B, H, L = FLASH_SHAPE["B"], FLASH_SHAPE["H"], 256
    rows = {}
    for d in (64,) + WIDE_WIDTHS:
        q, k, v, dout = (torch.randn(B, L, H, d, generator=gen).to(dev)
                         for _ in range(4))
        cfg = (False, d ** -0.5, 0.1, SEED, "blhd", (0, 0))
        out, lse = fa._flash_fwd_cuda(q, k, v, None, *cfg)
        bwd = (q, k, v, out, dout, lse, torch.empty_like(lse), *cfg)
        rows[d] = {
            "fwd": graph_ms(torch, [lambda: fa._flash_fwd_cuda(
                q, k, v, None, *cfg)] * 20),
            "dq": graph_ms(torch, [lambda: fa._flash_dq_cuda(*bwd)] * 20),
            "dkv": graph_ms(torch, [lambda: fa._flash_dkv_cuda(*bwd)] * 20)}
        log(f"flash D={d} (B{B} L{L} H{H} fp32 p0.1) ms: "
            f"{json.dumps(rows[d])}")
    return rows


# -- phases 7 and 8: training, and serving what was trained ------------------

# bench.py's Transformer-base training recipe: fused attention without
# materialised biases (causal decoder self-attention in the kernel),
# the streamed vocab loss, dropout 0.1, Adam(1e-4), in float32 here and
# in its own bf16 recipe in phase 9.  max_length is the serving
# generator's, so the position tables carry over.
SEQ = 256
TRAIN = dict(max_length=SERVE["max_length"], dropout_rate=0.1,
             src_seq_len=SEQ, trg_seq_len=SEQ, fused=True,
             materialize_attn_bias=False, fused_vocab_loss=True,
             param_prefix="tf")
LR = 1e-4
TRAIN_BATCH, TRAIN_STEPS, COMPARE_BATCH = 64, 20, 2
N_TRAINED_REQUESTS = 4
# encoder self, decoder self (causal) and cross attention per layer
ATTN_PER_STEP = 3 * MODEL["n_layer"]
CAUSAL_PER_STEP = MODEL["n_layer"]
# card vs CPU, one step from one state with dropout on (both draw the
# same hash masks): float32 end to end with TF32 off, so they differ by
# summation order only, through 12 layers and a 32768-way softmax.  The
# gradient error is taken relative to the gradient's largest magnitude.
# Adam moves a weight by lr_t * m / (sqrt(v) + eps), m = b1 m' + (1 - b1)
# g the first moment after the step, about +-lr where g dominates, and
# a gradient within rounding of 0 may flip that sign: the updated
# weights can differ by 2 lr where the gradients agree.  So the update
# itself, w_after - w_before, is held to its own size as well, on the
# elements whose |m| is at least UPDATE_GRAD_FLOOR of (1 - b1) times the
# gradient's largest magnitude (at step 1, m = (1 - b1) g: the elements
# whose |g| is at least that share of the largest): both sides share m'
# and v', so there a gradient within STEP_GRAD_RTOL moves m, and the
# step, by at most 1e-3 / 1e-2 = 0.1 of itself, while a skipped, doubled
# or misdirected update is off by 1 or more.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
STEP_PARAM_ATOL = 2 * LR + 1e-6
UPDATE_GRAD_FLOOR = 1e-2
STEP_UPDATE_RTOL = 0.1
UPDATE_MIN_SHARE = 0.5          # the floor must leave most elements checked
# Adam's rule on every element: the card's update w_after - w_before
# against the rule applied in float64 to the card's own gradient and the
# moments and beta powers before the step, which both sides share.  The
# card computes the rule in float32, a dozen roundings at most, each
# within one ulp of the terms it combines (m's two terms may cancel, so
# they bound m's error, not m itself), and rounds the weight once: so
# within UPDATE_RULE_ULPS float32 epsilons of
# lr_t (b1 |m'| + (1 - b1) |g|) / (sqrt(v) + eps), plus one ulp of the
# weight.  A skipped, halved or misdirected update is off by its size.
UPDATE_RULE_ULPS = 32


# -- the captured step: replay against eager, card against CPU ---------------

# the step the card-vs-CPU and replay checks read: step 1 runs eagerly
# and is captured in a CUDA graph, steps 2 and 3 replay it
COMPARE_STEP = 3


def device_feed(torch, feed, dev):
    """A feed dict on the card as the executor stages it: int64 and
    float64 narrowed to int32 and float32, sequences as SeqArrays."""
    import numpy as np

    from paddle_tpu_torch.fluid.core.lod import SeqArray
    from paddle_tpu_torch.fluid.core.types import runtime_dtype, torch_dtype

    def one(v):
        if isinstance(v, SeqArray):
            return SeqArray(one(v.data), one(v.lengths))
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        return t.to(dev, torch_dtype(runtime_dtype(t.dtype)))

    return {n: one(v) for n, v in feed.items()}


def _pieces(v):
    return (v.data, v.lengths) if hasattr(v, "lengths") else (v,)


def captured_step(torch, fluid, main, fetch, init, feed_of, cpu=()):
    """Steps 1..COMPARE_STEP of ``main`` on the card from the numpy state
    ``init``, feeding ``feed_of(i)`` and fetching ``fetch`` (names):
    step 1 runs eagerly and is captured, the others replay the graph.
    At the last step:

    * the replay against ``lowering.run_block_ops`` run eagerly on a
      clone of the card's state before it, with the step's seeds
      (``step_seeds``): each fetch and each state var the step writes
      is equal bitwise, or is listed in ``differs`` with the op that
      wrote it (for an optimizer update, the op of its gradient too) and
      its error;
    * each ``(program, fetch)`` of ``cpu`` runs the same step on the CPU
      from the card's state before it, the scope's rng at that step; a
      third entry, ``(program, fetch, change)``, feeds it
      ``change(feed)`` in the step's feed's place.

    Returns {"card": the step's fetches, "before" / "after": the card's
    state around it (numpy), "cpu": [(fetches, state after)], "differs",
    "bitwise", "hits": executable hits}."""
    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor, step_seeds)

    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    dev = exe.device
    for i in range(COMPARE_STEP - 1):
        exe.run(main, feed=feed_of(i), fetch_list=fetch, scope=scope)
    feed = feed_of(COMPARE_STEP - 1)
    plan = BlockPlan(main.desc.global_block(), list(feed), fetch,
                     program=main.desc)

    def clone(v):
        return (type(v)(v.data.clone(), v.lengths.clone())
                if hasattr(v, "lengths") else v.clone())

    pre = {n: clone(scope.find_var(n)) for n in plan.state_in}
    before = fluid.scope_to_numpy(scope)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    written = {n: clone(scope.find_var(n)) for n in plan.state_out}
    after = fluid.scope_to_numpy(scope)
    hits = exe.cache_stats()["executable"]["hits"]
    del exe, scope
    seeds = step_seeds(plan, main.random_seed, COMPARE_STEP)
    env = dict(pre)
    env.update(device_feed(torch, feed, dev))
    with torch.no_grad():
        run_block_ops(plan, env, seeds, seed_tensor(seeds).to(dev), dev,
                      "train")
    writer = {n: op for op in plan.ops for n in op.output_names() if n}

    def source(n):
        # the op that computed n, through the assigns that pass it on
        op = writer.get(n)
        while op is not None and op.type == "assign":
            op = writer.get(op.input("X")[0])
        return op

    def op_of(n):
        op = source(n)
        if op is None:
            return None
        grad = source(op.inputs.get("Grad", [None])[0])
        return op.type if grad is None else f"{op.type} <- {grad.type}"

    differs = {}
    for n, a, b in ([(n, g, env[n]) for n, g in zip(fetch, got)]
                    + [(n, written[n], env[n]) for n in plan.state_out]):
        if all(torch.equal(x, y) for x, y in zip(_pieces(a), _pieces(b))):
            continue
        a, b = _pieces(a)[0].double(), _pieces(b)[0].double()
        abs_err = float((a - b).abs().max())
        differs[n] = {"op": op_of(n), "abs_err": abs_err,
                      "rel_err": abs_err / max(float(b.abs().max()),
                                               1e-30)}
    del pre, env, written
    got = [_pieces(v)[0].float().cpu().numpy() for v in got]
    cpu_runs = []
    for program, names, *change in cpu:
        cs = fluid.scope_from_numpy(before, fluid.CPUPlace())
        # the scope's rng at the card's: the CPU's step is step 3 too
        cs._rng_seed, cs._rng_step = program.random_seed, COMPARE_STEP - 1
        out = fluid.Executor(fluid.CPUPlace()).run(
            program, feed=change[0](feed) if change else feed,
            fetch_list=names, scope=cs)
        cpu_runs.append((out, fluid.scope_to_numpy(cs)))
    torch.cuda.empty_cache()
    return {"card": got, "before": before, "after": after, "cpu": cpu_runs,
            "differs": differs, "bitwise": not differs, "hits": hits}


def replay_ok(rec, params, loss, loss_rtol, grad_rtol, param_atol):
    """A replay that differs from the eager step passes where each value
    that differs is within the card-vs-CPU tolerances of its kind: the
    loss ``loss_rtol``, a parameter ``param_atol``, any other value
    ``grad_rtol`` of its largest magnitude."""
    for n, d in rec["differs"].items():
        if n == loss:
            ok = d["rel_err"] <= loss_rtol
        elif n in params:
            ok = d["abs_err"] <= param_atol
        else:
            ok = d["rel_err"] <= grad_rtol
        if not ok:
            return False
    return True


def replay_record(rec):
    """What a path's record keeps of ``captured_step``'s replay check."""
    return {"step": COMPARE_STEP, "bitwise": rec["bitwise"],
            "differs": rec["differs"], "hits": rec["hits"]}


def graph_failures(path, rec, steps, per_step):
    """A training path's run of ``steps`` steps: every step after the
    first a replay (``steps - 1`` executable hits), one captured graph
    whose kernel nodes of this repo's kernels are ``per_step`` ({family:
    launches a step})."""
    out = []
    if rec["executable_hits"] != steps - 1:
        out.append(f"{path}: {rec['executable_hits']} executable hits in "
                   f"{steps} steps, want {steps - 1}")
    if rec["graph"].get("by_family") != per_step:
        out.append(f"{path}: captured graph {rec['graph']}, want kernel "
                   f"nodes {per_step}")
    return out


def build_training(fluid, transformer, amp_dtype=None):
    """bench.py's Transformer-base training program; ``amp_dtype``
    "bfloat16" is its bf16 recipe (the same parameters, startup program
    and dropout salts as the float32 program)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _, _ = transformer(VOCAB, VOCAB, **MODEL, **TRAIN,
                                     amp_dtype=amp_dtype)
        fluid.optimizer.Adam(LR).minimize(avg_cost)
    return main, startup, avg_cost


def train_feed(np, batch):
    """One fixed batch of packed full-length pairs, made from the seed."""
    rng = np.random.RandomState(SEED)
    pos = np.tile(np.arange(SEQ), (batch, 1))
    return {"src_word": rng.randint(2, VOCAB, (batch, SEQ)),
            "src_pos": pos,
            "trg_word": rng.randint(2, VOCAB, (batch, SEQ)),
            "trg_pos": pos,
            "lbl_word": rng.randint(2, VOCAB, (batch, SEQ)),
            "lbl_weight": np.ones((batch, SEQ), np.float32)}


def adam_rule_excess(np, op, before, w_after, g):
    """The card's update of one parameter against Adam's rule (``adam``
    op ``op``) applied in float64 to its gradient ``g`` from the state
    ``before`` the step: the largest error over the elements, in units
    of each element's rounding allowance (UPDATE_RULE_ULPS); at most 1
    where every element follows the rule."""
    def st(slot):
        return before[op.input(slot)[0]].astype(np.float64)

    b1, b2 = op.attr("beta1"), op.attr("beta2")
    eps = op.attr("epsilon")
    g = g.astype(np.float64)
    m1, m2 = st("Moment1"), st("Moment2")
    m = b1 * m1 + (1 - b1) * g
    v = b2 * m2 + (1 - b2) * g * g
    lr_t = float(st("LearningRate").reshape(-1)[0] * np.sqrt(
        1 - st("Beta2Pow").reshape(-1)[0])
        / (1 - st("Beta1Pow").reshape(-1)[0]))
    scale = lr_t / (np.sqrt(v) + eps)
    w0 = st("Param")
    got = w_after.astype(np.float64) - w0
    allowed = (UPDATE_RULE_ULPS * np.finfo(np.float32).eps * scale
               * (b1 * np.abs(m1) + (1 - b1) * np.abs(g))
               + np.spacing(np.abs(w_after).astype(np.float32)))
    return float((np.abs(got + scale * m) / allowed).max())


def compare_step(torch, np, fluid, main, loss, init, feed, params=None,
                 lr=LR):
    """Step 3 (a graph replay) on the card and the same step on the CPU
    from the card's state before it (``captured_step``): the loss, the
    gradients, the updated weights and the updates of ``params`` (by
    default encoder layer 0 and decoder layer 0 of the Transformer), a
    weight held to twice the program's Adam rate ``lr``.  Returns a
    record of the four errors and of the replay against the eager
    step."""
    if params is None:
        params = [p.name for p in main.global_block().all_parameters()
                  if p.name.startswith(("tf.enc0.", "tf.dec0."))]
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    r = captured_step(torch, fluid, main, fetch, init, lambda i: feed,
                      [(main, fetch)])
    g_card, g_cpu = r["card"], r["cpu"][0][0]
    before, w_card, w_cpu = r["before"], r["after"], r["cpu"][0][1]
    adam = {op.input("Param")[0]: op for op in main.global_block().ops
            if op.type == "adam"}
    upd_err, checked, total = 0.0, 0, 0
    for n, g in zip(params, g_cpu[1:]):
        u_card, u_cpu = w_card[n] - before[n], w_cpu[n] - before[n]
        m1, beta1 = adam[n].input("Moment1")[0], adam[n].attr("beta1")
        sure = np.abs(w_cpu[m1]) >= (UPDATE_GRAD_FLOOR * (1 - beta1)
                                     * np.abs(g).max())
        if sure.any():
            upd_err = max(upd_err, float((np.abs(u_card - u_cpu)[sure]
                                          / np.abs(u_cpu)[sure]).max()))
        checked += int(sure.sum())
        total += g.size
    rule_worst = max(adam_rule_excess(np, adam[n], before, w_card[n], g)
                     for n, g in zip(params, g_card[1:]))
    return {"loss_card": float(g_card[0]), "loss_cpu": float(g_cpu[0]),
            "update_rel_err": upd_err, "update_checked_share":
            checked / max(1, total), "update_rule_worst": rule_worst,
            "loss_rel_err": abs(float(g_card[0]) - float(g_cpu[0]))
            / abs(float(g_cpu[0])),
            "grad_rel_err": max(float(np.abs(a - b).max())
                                / max(float(np.abs(b).max()), 1e-30)
                                for a, b in zip(g_card[1:], g_cpu[1:])),
            "param_max_abs_err": max(float(np.abs(w_card[n] - w_cpu[n])
                                           .max()) for n in params),
            "n_params": len(params), "replay": replay_record(r),
            "replay_ok": replay_ok(
                r, set(before), loss.name, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                2 * lr + 1e-6)}


def train_on_card(torch, fluid, fa, main, loss, init, feed):
    """The training path: TRAIN_STEPS steps of ``Executor.run`` on the
    card (the first run eagerly and captured in a CUDA graph, the others
    replays of it), with the flash kernels' launch counts (all, and by
    input dtype) set to 0 just before and read just after.  Returns
    (record, trained scope); the record has the executor's hits and the
    graph's nodes (``step_graph``)."""
    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    by_dtype = fa.flash_attention.launches_by_dtype
    for dt in by_dtype:
        by_dtype[dt] = {"fwd": 0, "dq": 0, "dkv": 0}
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        # the fetched loss comes back as a numpy array: the step is done
        lv, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)
        losses.append(float(lv))
    launches = dict(fa.flash_attention.launches)
    launches_by_dtype = {dt: dict(n) for dt, n in by_dtype.items()}
    steady = sorted(times[1:])[len(times[1:]) // 2]        # median
    tokens = TRAIN_BATCH * SEQ * 2
    rec = {"batch": TRAIN_BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
           "executable_hits": exe.cache_stats()["executable"]["hits"],
           "graph": step_graph(exe),
           "losses": losses, "first_step_ms": times[0] * 1e3,
           "step_ms_median": steady * 1e3,
           "step_ms_mean": sum(times[1:]) / len(times[1:]) * 1e3,
           "tokens_per_s": tokens / steady,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "launches_by_dtype": launches_by_dtype,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()}}
    return rec, scope


# -- phase 9: the bf16 recipe -----------------------------------------------

# bench.py's own recipe (bench.py:456-462, amp_dtype="bfloat16"): bf16
# activations from one cast at each embedding, f32 master weights
AMP = "bfloat16"
# card vs CPU port, one amp step at batch 2 from one scope and one seed
# (the CPU tests' bf16 tolerances, tests/test_torch_amp.py): the two
# round activations and gradients to bf16 after sums taken in another
# order, so a value near a rounding boundary lands one bf16 ulp apart,
# and the backward's cancellations and relu switches turn that into a
# few percent of a gradient.  The loss within AMP_LOSS_RTOL; every
# gradient within AMP_GRAD_L2 in relative L2; and the card's bf16
# gradients no farther from the CPU port's float32 gradients (same
# scope, same masks) than the CPU port's bf16 gradients are, within
# AMP_NOISE_RATIO, in the median over parameters.
AMP_LOSS_RTOL, AMP_GRAD_L2, AMP_NOISE_RATIO = 1e-2, 0.25, 1.25


def _rel_l2(np, got, want):
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def compare_amp_step(torch, np, fluid, amp_main, amp_loss, f32_main,
                     f32_loss, init, feed):
    """Step 3 of the amp program on the card (a graph replay), and the
    same step of the amp program and of the float32 program on the CPU
    from the card's state before it, dropout on (the programs share
    their dropout salts, so the masks): the losses and every parameter's
    gradient, and the replay against the eager step."""
    params = [p.name for p in amp_main.global_block().all_parameters()]
    grads = [n + "@GRAD" for n in params]
    r = captured_step(torch, fluid, amp_main, [amp_loss.name] + grads, init,
                      lambda i: feed,
                      [(amp_main, [amp_loss.name] + grads),
                       (f32_main, [f32_loss.name] + grads)])
    card, cpu, f32 = r["card"], r["cpu"][0][0], r["cpu"][1][0]
    l2 = [_rel_l2(np, a, b) for a, b in zip(card[1:], cpu[1:])]
    worst = int(np.argmax(l2))
    return {"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
            "loss_cpu_f32": float(f32[0]),
            "loss_rel_err": abs(float(card[0]) - float(cpu[0]))
            / abs(float(cpu[0])),
            "grad_rel_l2_max": l2[worst], "grad_rel_l2_worst": params[worst],
            "grad_rel_l2_median": float(np.median(l2)),
            "grad_dtypes": sorted({str(g.dtype) for g in card[1:]}),
            "card_vs_f32_median": float(np.median(
                [_rel_l2(np, a, b) for a, b in zip(card[1:], f32[1:])])),
            "cpu_vs_f32_median": float(np.median(
                [_rel_l2(np, a, b) for a, b in zip(cpu[1:], f32[1:])])),
            "n_params": len(params), "replay": replay_record(r),
            # the replay against the eager step: fp32 state, bf16 products
            # in both, so the float32 step's tolerances
            "replay_ok": replay_ok(
                r, set(params), amp_loss.name, STEP_LOSS_RTOL,
                STEP_GRAD_RTOL, STEP_PARAM_ATOL)}


def amp_step_ok(step) -> bool:
    return (step["replay_ok"] and step["loss_rel_err"] <= AMP_LOSS_RTOL
            and step["grad_rel_l2_max"] <= AMP_GRAD_L2
            and step["grad_dtypes"] == ["float32"]
            and step["card_vs_f32_median"]
            <= AMP_NOISE_RATIO * step["cpu_vs_f32_median"])


# -- phase 10: the book's first two chapters --------------------------------

FIT_STEPS, FIT_BATCH = 200, 32
BOOK_LR = {"fit_a_line": 0.01, "conv_net": 0.01, "bf16_conv_net": 0.05}
DIGITS_STEPS, DIGITS_BATCH = 20, 64
# card vs CPU port, first step, float32 (cuBLAS and cuDNN with TF32 off
# against the CPU): summation order only; the gradients relative to
# their largest magnitude
BOOK_LOSS_RTOL, BOOK_GRAD_RTOL = 1e-5, 1e-4


def build_book(fluid, program):
    """``fit_a_line`` (SGD 0.01), ``conv_net`` (recognize_digits, Adam
    0.01) or ``bf16_conv_net`` (tests/test_book.py's bf16 conv-pool net,
    Momentum 0.05 / 0.9) -> (main, startup, loss)."""
    from paddle_tpu_torch.models import fit_a_line, recognize_digits

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if program == "fit_a_line":
            loss = fit_a_line.build()[1]
        elif program == "conv_net":
            img = layers.data(name="img", shape=[1, 28, 28],
                              dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64")
            loss = recognize_digits.conv_net(img, label)[1]
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        else:
            img = layers.data(name="img", shape=[3, 16, 16],
                              dtype="bfloat16")
            label = layers.data(name="label", shape=[1], dtype="int64")
            conv = layers.conv2d(input=img, num_filters=8, filter_size=3,
                                 padding=1, act="relu")
            pool = layers.pool2d(input=conv, pool_size=2, pool_stride=2)
            pred = layers.fc(input=pool, size=4, act="softmax")
            loss = layers.mean(layers.cross_entropy(input=pred,
                                                    label=label))
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
    return main, startup, loss


def book_feed(torch, np, program, i):
    """Step ``i``'s batch, made from the seed: fit_a_line's noisy linear
    model (13 features), tests/test_book.py's synthetic digits (class k
    lights rows 2k..2k+2), or its bf16 images (class k brightens
    channel k % 3)."""
    rng = np.random.RandomState(SEED + i)
    if program == "fit_a_line":
        w = np.random.RandomState(SEED).randn(13, 1).astype(np.float32)
        x = rng.randn(FIT_BATCH, 13).astype(np.float32)
        return {"x": x, "y": x @ w + 0.5
                + 0.01 * rng.randn(FIT_BATCH, 1).astype(np.float32)}
    lbl = rng.randint(0, 10 if program == "conv_net" else 4,
                      (DIGITS_BATCH, 1)).astype(np.int64)
    if program == "conv_net":
        img = rng.rand(DIGITS_BATCH, 1, 28, 28).astype(np.float32) * 0.1
        for b, k in enumerate(lbl[:, 0]):
            img[b, 0, k * 2: k * 2 + 3, :] += 1.0
        return {"img": img, "label": lbl}
    img = rng.rand(DIGITS_BATCH, 3, 16, 16).astype(np.float32) * 0.2
    for b, k in enumerate(lbl[:, 0]):
        img[b, k % 3] += 0.8
    return {"img": torch.from_numpy(img).to(torch.bfloat16), "label": lbl}


def book_phase(torch, np, fluid, program, steps):
    """One book program: its step 3 on the card (a graph replay) against
    the eager step and against the CPU from the card's state before it
    (loss and every gradient), then ``steps`` steps on the card on fresh
    seeded batches, each after the first a graph replay.  Returns
    (record, ok)."""
    main, startup, loss = build_book(fluid, program)
    init = initial_scope(fluid, startup)
    params = [p.name for p in main.global_block().all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    r = captured_step(torch, fluid, main, fetch, init,
                      lambda i: book_feed(torch, np, program, i),
                      [(main, fetch)])
    card, cpu = r["card"], r["cpu"][0][0]
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    if program == "bf16_conv_net":
        grad_err = max(_rel_l2(np, a, b) for a, b in zip(card[1:], cpu[1:]))
        ok = loss_err <= AMP_LOSS_RTOL and grad_err <= AMP_GRAD_L2
    else:
        grad_err = max(float(np.abs(a - b).max())
                       / max(float(np.abs(b).max()), 1e-30)
                       for a, b in zip(card[1:], cpu[1:]))
        ok = loss_err <= BOOK_LOSS_RTOL and grad_err <= BOOK_GRAD_RTOL
    replay_good = replay_ok(r, set(params), loss.name, BOOK_LOSS_RTOL,
                            BOOK_GRAD_RTOL, 2 * BOOK_LR[program] + 1e-6)
    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=book_feed(torch, np, program, i),
                            fetch_list=[loss], scope=scope)[0])
              for i in range(steps)]
    wall = time.perf_counter() - t0
    hits = exe.cache_stats()["executable"]["hits"]
    rec = {"program": program, "steps": steps, "losses": losses[::10]
           if steps > 20 else losses, "first_loss": losses[0],
           "last_loss": losses[-1], "ms_per_step": wall / steps * 1e3,
           "executable_hits": hits, "graph": step_graph(exe),
           "step3_loss_rel_err": loss_err, "step3_grad_err": grad_err,
           "replay": replay_record(r)}
    ok = ok and replay_good and hits == steps - 1
    if program == "fit_a_line":
        # the verify recipe's flow 1: the loss falls ~100x in 200 steps
        rec["last10_mean"] = float(np.mean(losses[-10:]))
        ok = ok and rec["last10_mean"] < losses[0] / 100
    return rec, ok and bool(np.isfinite(losses).all()) \
        and losses[-1] < losses[0]

def executor_modes(torch, np, fluid):
    """fit_a_line on the card through one ``Executor`` four ways from one
    scope, each held bitwise to four ``run`` calls on an executor of its
    own (losses and final parameters): ``run_steps`` (the feeds staged
    on the card, the steps replays), ``run_pipeline`` (fetches drained
    every 2 steps), and two scopes stepped in turns through one executor
    (each takes over the graph's buffers from the other).  -> (record,
    ok)."""
    main, startup, loss = build_book(fluid, "fit_a_line")
    init = initial_scope(fluid, startup)
    names = sorted(init)
    place = fluid.CUDAPlace(0)
    feeds = [book_feed(torch, np, "fit_a_line", i) for i in range(4)]

    def alone(feeds):
        scope = fluid.scope_from_numpy(init, place)
        exe = fluid.Executor(place)
        out = [float(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in feeds]
        return out, fluid.scope_to_numpy(scope, names)

    def same(a, b):
        return a[0] == b[0] and all(np.array_equal(a[1][n], b[1][n])
                                    for n in names)

    want = alone(feeds)
    other = alone(feeds[::-1])
    exe = fluid.Executor(place)
    scope = fluid.scope_from_numpy(init, place)
    steps = ([float(r[0]) for r in exe.run_steps(
        main, feeds=feeds, fetch_list=[loss], scope=scope)],
        fluid.scope_to_numpy(scope, names))
    scope = fluid.scope_from_numpy(init, place)
    pipe = ([float(r[0]) for r in fluid.Executor(place).run_pipeline(
        main, loader=feeds, fetch_list=[loss], scope=scope,
        fetch_every=2)], fluid.scope_to_numpy(scope, names))
    a, b = (fluid.scope_from_numpy(init, place) for _ in range(2))
    turns = fluid.Executor(place)
    la, lb = [], []
    for fa_, fb_ in zip(feeds, feeds[::-1]):
        la.append(float(turns.run(main, feed=fa_, fetch_list=[loss],
                                  scope=a)[0]))
        lb.append(float(turns.run(main, feed=fb_, fetch_list=[loss],
                                  scope=b)[0]))
    rec = {"run_steps_bitwise": same(steps, want),
           "run_pipeline_bitwise": same(pipe, want),
           "two_scopes_bitwise": same((la, fluid.scope_to_numpy(a, names)),
                                      want)
           and same((lb, fluid.scope_to_numpy(b, names)), other),
           "run_steps_hits": exe.cache_stats()["executable"]["hits"],
           "two_scopes_hits": turns.cache_stats()["executable"]["hits"]}
    ok = (rec["run_steps_bitwise"] and rec["run_pipeline_bitwise"]
          and rec["two_scopes_bitwise"] and rec["run_steps_hits"] == 3
          and rec["two_scopes_hits"] == 7)
    return rec, ok

# -- phases 12-15: the LSTM text classifiers --------------------------------

# the reference's RNN benchmark (bench.py's bench_lstm, from benchmark/
# paddle/rnn/rnn.py): IMDB text classifier at its batch and padded length
LSTM_VOCAB, LSTM_EMB, LSTM_HIDDEN, LSTM_NUM = 30000, 128, 512, 2
LSTM_BATCH, LSTM_T, LSTM_LR = 128, 100, 2e-3
LSTM_STEPS, LSTM_COMPARE_BATCH = 20, 4
LSTM_WIDTHS = (256, 512, 1280)
BOOK_STEPS = 20
# kernel vs plain loop, same inputs on the card: fp32 on both sides,
# summation order only (H-term dot products, expf vs torch's exp), over
# 100 steps of a contracting recurrence
LSTM_TOL = 1e-4
# card vs CPU, one step from one scope: fp32 end to end, the kernel and
# cuBLAS against the CPU's plain loop and products, summation order only
LSTM_LOSS_RTOL = 1e-5
LSTM_GRAD_RTOL = 1e-4


def resident_edge(lk, B, limits):
    """The largest H whose weight slice the planner keeps in shared
    memory at B rows on a card with these (SMs, shared memory) limits."""
    H = 1024
    while lk.lstm_plan(B, H + 1, *limits)["w_smem"]:
        H += 1
    return H


def lstm_cases(lk, limits):
    """(name, B, T, H, config, grads) of the kernel-vs-plain check; the
    last four hit the edges of the kernel's tiling on this card."""
    default = dict(peep=True, reverse=False, init=False, ragged=False,
                   acts=("sigmoid", "tanh", "tanh"))
    cases = [(f"H{h}/{'peep' if p else 'nopeep'}", LSTM_BATCH, LSTM_T, h,
              dict(default, peep=p), p)
             for h in LSTM_WIDTHS for p in (False, True)]
    variants = [("ragged", dict(ragged=True)),
                ("ragged/reverse", dict(ragged=True, reverse=True)),
                ("ragged/reverse/h0c0", dict(ragged=True, reverse=True,
                                             init=True))]
    cases += [(f"H512/{n}", LSTM_BATCH, LSTM_T, 512, dict(default, **kw),
               True) for n, kw in variants]
    cases.append(("H200/relu-identity-sigmoid/ragged", 64, 30, 200,
                  dict(default, ragged=True,
                       acts=("relu", "identity", "sigmoid")), True))
    # semantic role labeling's cell (phase 19): db_lstm's 8 layers of
    # H = 128 over SRL_BATCH sentences padded to SRL_PAD, relu candidate,
    # sigmoid gate and cell, peepholes, alternating direction
    for rev in (False, True):
        cases.append((f"H128/srl/relu-sigmoid-sigmoid/ragged"
                      f"{'/reverse' if rev else ''}", SRL_BATCH, SRL_PAD,
                      SRL_H, dict(default, ragged=True, reverse=rev,
                                  acts=SRL_ACTS), True))
    cases.append(("H1280/ragged/reverse/h0c0", 8, 20, 1280,
                  dict(default, ragged=True, reverse=True, init=True), True))
    cases.append(("B1/T1/H256", 1, 1, 256, dict(default), True))
    # no weight slice of H=2048 fits shared memory: read from L2
    cases.append(("H2048/w-from-L2/ragged", 4, 6, 2048,
                  dict(default, ragged=True), True))
    # B not a multiple of the 16-row tile (nor of the 4 batch groups);
    # H not a multiple of the h chunk (H=1000: 64-column chunks, the last
    # one padded with zeros).  H=200 above leaves its last block short of
    # units, H=1321 below is odd
    cases.append(("B100/H512/ragged", 100, LSTM_T, 512,
                  dict(default, ragged=True), True))
    cases.append(("H1000/ragged/reverse", LSTM_BATCH, LSTM_T, 1000,
                  dict(default, ragged=True, reverse=True), True))
    # the widest slice still resident in shared memory, and the first H
    # whose slice is read from L2
    edge = resident_edge(lk, LSTM_BATCH, limits)
    for H, where in ((edge, "w-resident"), (edge + 1, "w-from-L2")):
        cases.append((f"H{H}/{where}/ragged", LSTM_BATCH, 20, H,
                      dict(default, ragged=True), True))
    return cases


def lstm_inputs(torch, gen, dev, B, T, H, cfg):
    x = (torch.randn(B, T, 4 * H, generator=gen) * 0.5).to(dev)
    w = (torch.randn(H, 4 * H, generator=gen) * H ** -0.5).to(dev)
    b = (torch.randn((7 if cfg["peep"] else 4) * H, generator=gen)
         * 0.1).to(dev)
    lengths = torch.full((B,), T)
    if cfg["ragged"]:
        lengths = torch.randint(0, T + 1, (B,), generator=gen)
        lengths[:3] = torch.tensor([0, 1, T])[:B]
    h0 = c0 = None
    if cfg["init"]:
        h0 = torch.randn(B, H, generator=gen).to(dev)
        c0 = torch.randn(B, H, generator=gen).to(dev)
    kw = dict(use_peepholes=cfg["peep"], is_reverse=cfg["reverse"],
              gate_activation=cfg["acts"][0], cell_activation=cfg["acts"][1],
              candidate_activation=cfg["acts"][2])
    return (x, w, b, lengths.to(torch.int32).to(dev), h0, c0), kw


def run_lstm_case(torch, lk, gen, dev, case):
    """One case: the kernel (through ``lstm_forward``, and with grads
    through ``dynamic_lstm``, whose backward is hand-written) against the
    plain loop (and autograd through it) -> (name, {tensor: err}, ok,
    plan).  A tensor passes within LSTM_TOL of max(1, its largest
    magnitude); outputs past each row's length must be exactly 0."""
    name, B, T, H, cfg, grads = case
    (x, w, b, lengths, h0, c0), kw = lstm_inputs(torch, gen, dev, B, T, H,
                                                 cfg)
    h, c = lk.lstm_forward(x, w, b, lengths, h0, c0, **kw)
    ph, pc = lk.lstm_forward_plain(x, w, b, lengths, h0, c0, **kw)
    errs = {"h": _max_err(torch, h, ph), "c": _max_err(torch, c, pc)}
    pad = (torch.arange(T, device=dev)[None, :]
           >= lengths[:, None].long())[..., None]
    zero = bool((h * pad == 0).all() and (c * pad == 0).all())
    if grads:
        ins = [t for t in (x, w, b, h0, c0) if t is not None]
        names = ["dx", "dw", "dbias", "dh0", "dc0"][:len(ins)]
        dh = torch.randn(B, T, H, generator=gen).to(dev)
        dc = torch.randn(B, T, H, generator=gen).to(dev)

        def grads_of(fn):
            leaves = [t.detach().requires_grad_(True) for t in ins]
            state = leaves[3:] if h0 is not None else [None, None]
            oh, oc = fn(*leaves[:3], lengths, *state, **kw)
            return torch.autograd.grad((oh, oc), leaves, (dh, dc))

        got = grads_of(lk.dynamic_lstm)
        want = grads_of(lk.lstm_forward_plain)
        for n, g, e in zip(names, got, want):
            errs[n] = _max_err(torch, g, e)
    torch.cuda.synchronize()
    ok = zero and all(e <= LSTM_TOL * max(1.0, mag)
                      for e, mag in errs.values())
    return name, {n: e for n, (e, _) in errs.items()}, ok, \
        lk.device_plan(B, H, dev)


def lstm_bound(B, T, H, passes=3, flops_per_s=TF32_FLOPS_PER_S,
               live=None):
    """Least time of one forward: x's live rows, w, the bias and
    peepholes and the lengths read once, h and c written once, against
    the recurrent product's 2*live*H*4H operations done ``passes`` times
    at ``flops_per_s``; ``live`` is the number of (row, step) pairs
    inside the lengths, B*T with full lengths.  The kernel does three
    TF32 products on the tensor cores; passes=1 at FP32_FLOPS_PER_S is
    the CUDA cores' fp32 bound."""
    live = B * T if live is None else live
    nbytes = 4 * (live * 4 * H + 4 * H * H + 7 * H + B + 2 * B * T * H)
    t_ops = passes * 2 * live * H * 4 * H / flops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def lstm_timings(torch, lk, dev, gen):
    """ms per call at B=128, T=100 and each width, as the model runs it
    (peepholes, full lengths): the kernel (twice, around the others),
    the plain loop, ``torch.nn.LSTM`` (cuDNN; no peepholes, and its own
    input product [B*T, H] x [H, 4H] on top: the same recurrent work and
    gates in the order i, f, g, o), and that input product alone
    (``torch.matmul``), so that library - gemm is cuDNN's recurrence.
    Both sides compute in fp32: TF32 is off for cuDNN and cuBLAS."""
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("lstm_timings: TF32 is on; cuDNN and cuBLAS "
                           "must be timed in fp32")
    rows = {}
    for H in LSTM_WIDTHS:
        cfg = dict(peep=True, reverse=False, init=False, ragged=False,
                   acts=("sigmoid", "tanh", "tanh"))
        (x, w, b, lengths, _, _), kw = lstm_inputs(
            torch, gen, dev, LSTM_BATCH, LSTM_T, H, cfg)
        rnn = torch.nn.LSTM(H, H, batch_first=True).to(dev)
        xi = torch.randn(LSTM_BATCH, LSTM_T, H, generator=gen).to(dev)
        wi = rnn.weight_ih_l0.detach().t().contiguous()
        with torch.no_grad():
            k1 = cuda_ms(torch, lambda: lk.lstm_forward(x, w, b, lengths,
                                                        **kw), 10)
            plain = cuda_ms(torch, lambda: lk.lstm_forward_plain(
                x, w, b, lengths, **kw), 3)
            lib = cuda_ms(torch, lambda: rnn(xi), 10)
            gemm = cuda_ms(torch, lambda: torch.matmul(
                xi.reshape(-1, H), wi), 10)
            k2 = cuda_ms(torch, lambda: lk.lstm_forward(x, w, b, lengths,
                                                        **kw), 10)
        b_ms, b_by = lstm_bound(LSTM_BATCH, LSTM_T, H)
        rows[H] = {"H": H, "ms": k1, "ms_repeat": k2,
                   "us_per_step": min(k1, k2) / LSTM_T * 1e3,
                   "plain_ms": plain, "library_ms": lib,
                   "library_gemm_ms": gemm,
                   "library_recurrence_ms": lib - gemm,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_fp32_ms": lstm_bound(LSTM_BATCH, LSTM_T, H, 1,
                                               FP32_FLOPS_PER_S)[0],
                   "plan": lk.device_plan(LSTM_BATCH, H, dev)}
        del x, w, b, rnn, xi, wi
    return rows


def build_rnn_benchmark(fluid):
    """bench.py's bench_lstm model, step for step, through the port's
    layers."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        net = fluid.layers.embedding(input=words, size=[LSTM_VOCAB,
                                                        LSTM_EMB])
        for _ in range(LSTM_NUM):
            proj = fluid.layers.fc(input=net, size=LSTM_HIDDEN * 4)
            net, _ = fluid.layers.dynamic_lstm(input=proj,
                                               size=LSTM_HIDDEN * 4)
        last = fluid.layers.sequence_last_step(input=net)
        pred = fluid.layers.fc(input=last, size=2, act="softmax")
        cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=LSTM_LR).minimize(cost)
    return main, startup, cost


def build_book_lstm(fluid, stacked_lstm_net):
    """The book's stacked_lstm_net at its default widths."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = stacked_lstm_net(data, label, input_dim=LSTM_VOCAB)
        fluid.optimizer.Adam(learning_rate=LSTM_LR).minimize(cost)
    return main, startup, cost, acc


def rnn_benchmark_lengths(batch):
    """Full rows but a few short ones: 1, 5, 16 and 60 of 100 steps."""
    lengths = [LSTM_T] * batch
    lengths[:4] = [1, LSTM_T // 20, LSTM_T // 6, 3 * LSTM_T // 5]
    return lengths[:batch]


def lstm_feed(np, fluid, batch, lengths):
    """A batch of word ids with the given lengths, padded to LSTM_T."""
    rng = np.random.RandomState(SEED)
    seqs = [rng.randint(0, LSTM_VOCAB, (n, 1)) for n in lengths]
    return {"words": fluid.make_seq(seqs, dtype=np.int32, max_len=LSTM_T),
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def initial_scope(fluid, startup):
    """The startup program's arrays, drawn on the CPU from its seed."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return fluid.scope_to_numpy(scope)


def compare_lstm_step(torch, np, fluid, main, loss, init, feed):
    """Step 3 on the card (a graph replay) against the eager step and
    against the same step on the CPU from the card's state before it:
    the loss and every parameter's gradient (each relative to its
    largest magnitude)."""
    params = [p.name for p in main.global_block().all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    r = captured_step(torch, fluid, main, fetch, init, lambda i: feed,
                      [(main, fetch)])
    card, cpu = r["card"], r["cpu"][0][0]
    return {"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": abs(float(card[0]) - float(cpu[0]))
            / abs(float(cpu[0])),
            "grad_rel_err": max(float(np.abs(a - b).max())
                                / max(float(np.abs(b).max()), 1e-30)
                                for a, b in zip(card[1:], cpu[1:])),
            "n_params": len(params), "replay": replay_record(r),
            "replay_ok": replay_ok(r, set(params), loss.name,
                                   LSTM_LOSS_RTOL, LSTM_GRAD_RTOL,
                                   2 * LSTM_LR + 1e-6)}


def train_lstm(torch, fluid, lk, main, fetch, init, feed, steps):
    """The LSTM training path: ``steps`` steps of ``Executor.run`` on the
    card (one eager and captured, then graph replays), the kernel's
    launch count set to 0 just before and read just after."""
    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lk.lstm_forward.launches = 0
    outs, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        times.append(time.perf_counter() - t0)
        outs.append([float(v) for v in got])
    launches = lk.lstm_forward.launches
    steady = sorted(times[1:])[len(times[1:]) // 2]        # median
    batch = len(feed["label"])
    return {"batch": batch, "seq": LSTM_T, "steps": steps,
            "executable_hits": exe.cache_stats()["executable"]["hits"],
            "graph": step_graph(exe),
            "losses": [o[0] for o in outs],
            "accuracy": [o[1] for o in outs] if len(fetch) > 1 else None,
            "first_step_ms": times[0] * 1e3,
            "step_ms_median": steady * 1e3,
            "step_ms_mean": sum(times[1:]) / len(times[1:]) * 1e3,
            "tokens_per_s": batch * LSTM_T / steady,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "launches_per_step": launches / steps}


def lstm_phases(torch, np, fluid, lk, dev, gen, failures):
    """Phases 11-14.  Returns the ``lstm`` record and the kernels-line
    entry of ``lstm_fwd``."""
    from paddle_tpu_torch.models.sentiment import stacked_lstm_net

    checks, err = [], 0.0
    for case in lstm_cases(lk, lk.device_limits(dev.index or 0)):
        name, errs, ok, plan = run_lstm_case(torch, lk, gen, dev, case)
        log(f"lstm {'ok  ' if ok else 'FAIL'} {name} {json.dumps(errs)} "
            f"plan {json.dumps(plan)}")
        err = max(err, errs["h"], errs["c"])     # the kernel's own outputs
        checks.append({"case": name, "errs": errs, "ok": ok})
        if not ok:
            failures.append(f"lstm kernel vs plain {name}: {errs}")

    # the RNN benchmark model: card vs CPU, then the card alone
    t0 = time.perf_counter()
    main_prog, startup, loss = build_rnn_benchmark(fluid)
    init = initial_scope(fluid, startup)
    lengths = rnn_benchmark_lengths(LSTM_BATCH)
    feed = lstm_feed(np, fluid, LSTM_BATCH, lengths)
    log(f"built the RNN benchmark program "
        f"({len(main_prog.global_block().ops)} ops) in "
        f"{time.perf_counter() - t0:.1f}s")
    small = {"words": fluid.make_seq(
        [feed["words"].data[i, :n] for i, n in
         enumerate(lengths[:LSTM_COMPARE_BATCH])], max_len=LSTM_T),
        "label": feed["label"][:LSTM_COMPARE_BATCH]}
    step = compare_lstm_step(torch, np, fluid, main_prog, loss, init, small)
    log(f"rnn benchmark step {COMPARE_STEP} card vs CPU and replay vs "
        f"eager: {json.dumps(step)}")
    if not (step["loss_rel_err"] <= LSTM_LOSS_RTOL
            and step["grad_rel_err"] <= LSTM_GRAD_RTOL
            and step["replay_ok"]):
        failures.append(f"rnn benchmark step card vs CPU: {step}")
    bench = train_lstm(torch, fluid, lk, main_prog, [loss], init, feed,
                       LSTM_STEPS)
    bench.update(hidden=LSTM_HIDDEN, compare=step)
    log(f"rnn benchmark training: {json.dumps(bench)}")
    if bench["launches"] != LSTM_NUM * LSTM_STEPS:
        failures.append(f"rnn benchmark: {bench['launches']} lstm_fwd "
                        f"launches in {LSTM_STEPS} steps, want "
                        f"{LSTM_NUM * LSTM_STEPS}")
    failures += graph_failures("rnn benchmark", bench, LSTM_STEPS,
                               {"lstm_fwd": LSTM_NUM})
    if not (np.isfinite(bench["losses"]).all()
            and bench["losses"][-1] < bench["losses"][0]):
        failures.append(f"rnn benchmark: loss did not fall: "
                        f"{bench['losses']}")
    del init
    torch.cuda.empty_cache()

    # the book's stacked LSTM net, ragged lengths
    main_prog, startup, loss, acc = build_book_lstm(fluid, stacked_lstm_net)
    init = initial_scope(fluid, startup)
    rng = np.random.RandomState(SEED + 1)
    lengths = rng.randint(1, LSTM_T + 1, LSTM_BATCH)
    lengths[0] = LSTM_T
    feed = lstm_feed(np, fluid, LSTM_BATCH, lengths)
    n_lstm = sum(op.type == "dynamic_lstm"
                 for op in main_prog.global_block().ops)
    book = train_lstm(torch, fluid, lk, main_prog, [loss, acc], init, feed,
                      BOOK_STEPS)
    log(f"stacked_lstm_net training: {json.dumps(book)}")
    if book["launches"] != n_lstm * BOOK_STEPS or n_lstm != 3:
        failures.append(f"stacked_lstm_net: {book['launches']} lstm_fwd "
                        f"launches in {BOOK_STEPS} steps, want 3 a step")
    failures += graph_failures("stacked_lstm_net", book, BOOK_STEPS,
                               {"lstm_fwd": n_lstm})
    if not (np.isfinite(book["losses"]).all()
            and book["losses"][-1] < book["losses"][0]):
        failures.append(f"stacked_lstm_net: loss did not fall: "
                        f"{book['losses']}")
    del init
    torch.cuda.empty_cache()

    rows = lstm_timings(torch, lk, dev, gen)
    for r in rows.values():
        log(json.dumps(r))
    main_row = rows[LSTM_HIDDEN]
    entry = {"name": lk.KERNEL_NAME, "route": "cuda",
             "source": "paddle_tpu_torch/kernels/csrc/lstm_fwd.cu",
             "replaces": "tools/lstm_probe.py:38",
             "launches": bench["launches"] + book["launches"],
             "max_abs_err": err,
             # per call at the benchmark model's width, H=512
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"],
             "library_ms": main_row["library_ms"]}
    rec = {"checks": checks, "rnn_benchmark": bench,
           "stacked_lstm_net": book, "timings": list(rows.values())}
    return rec, entry


# -- phase 16: image classification -----------------------------------------

# bench.py's image recipes: ResNet-50 (bench_resnet, bench.py:91-118) and
# the reference's other image benchmarks (_build_image_net,
# bench.py:161-185), bf16 images over f32 master weights, Momentum 0.9,
# one fixed seeded batch; and the book's CIFAR programs as
# tests/test_book.py trains them, the depth-32 ResNet under Momentum
# 0.02 / 0.9 and VGG-16 under Adam 1e-3, float32, on its synthetic data.
# name: (image px, classes, learning rate)
IMAGE_NETS = {"resnet50": (224, 1000, 0.1), "alexnet": (227, 1000, 0.01),
              "googlenet": (224, 1000, 0.01), "smallnet": (32, 10, 0.01)}
CIFAR_NETS = {"resnet_cifar10": (32, 10, 0.02),
              "vgg16_bn_drop": (32, 10, 1e-3)}
IMAGE_BATCH, IMAGE_COMPARE_BATCH = 128, 2
RESNET_STEPS, IMAGE_NET_STEPS, CIFAR_STEPS = 20, 10, 20
# replayed steps profiled for the host syncs a step makes, and the
# runtime calls that make the host wait for the card
SYNC_STEPS = 3
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# ResNet-50's step 3, card vs CPU port, at R50_COMPARE_PX px and batch
# IMAGE_COMPARE_BATCH.  At the reference's initialization the network is
# chaotic: a one-ulp change of every pixel moves its float32 gradients
# by percents, and its bf16 gradients lie ~1.4 in relative L2 from its
# float32 ones, which is noise (zeroed gradients read 1.0).  So the
# compare starts after R50_WARM_STEPS steps on the card at
# R50_COMPARE_LR (the scope's learning-rate var; at the recipe's 0.1 one
# step from the initialization saturates the softmax), each on a fresh
# seeded batch.  There the same nudge moves the float32 gradients by a
# median ~3e-6 of their largest and bf16 moves them by ~0.25 in relative
# L2 (tests/test_torch_image.py, at 64 px; at 224 px and batch 2 the
# network is still chaotic after 150 such steps).  A relu whose input
# sits within rounding of 0 can still switch, and moves the gradients
# upstream of it by up to ~8% of their largest (seen under one nudge in
# two at some such states).  On an H100 the card's sums in another order
# switched none in one warm-up (every gradient within 1.1e-5 of its
# largest), and in two others moved 8% and 56% of the gradients by more
# than STEP_GRAD_RTOL of their largest, by up to 0.027 in relative L2.
# So the Transformer's element-wise limit is recorded (calm_share), and
# the gate is every gradient within R50_GRAD_L2 in relative L2: a
# halved gradient reads 0.5, a zeroed one 1.0.  The warm-up runs cuDNN's
# deterministic algorithms, so a card reaches the same state each run.
# float32: the loss STEP_LOSS_RTOL, the moving stats R50_STAT_RTOL of
# their largest, the gradients R50_GRAD_L2.  bf16: the
# card against the CPU's bf16 step, the loss AMP_LOSS_RTOL and each
# gradient R50_BF16_GRAD_L2 in relative L2, twice the Transformer's
# AMP_GRAD_L2: the two round to bf16 after sums in another order, and at
# batch 2 that moves this network's gradients as far as bf16 itself does
# (measured: 0.23 median, 0.32 largest, against the CPU's bf16-to-float32
# 0.23, 0.30), where a zeroed gradient reads 1.0.  Both against the
# CPU's float32 step from the same state: the card's gradient distances
# (the median and the largest over parameters) within AMP_NOISE_RATIO of
# the CPU's, so one gradient at half its size fails (~0.5 against
# 1.25 x 0.30); its stats' within R50_FWD_NOISE_RATIO.
R50_COMPARE_PX, R50_WARM_STEPS, R50_COMPARE_LR = 64, 100, 1e-3
R50_STAT_RTOL, R50_GRAD_L2 = 1e-3, 0.1
R50_BF16_GRAD_L2, R50_FWD_NOISE_RATIO = 2 * AMP_GRAD_L2, 1.5


def build_image(fluid, model, dtype="bfloat16", px=None):
    """One of IMAGE_NETS in bench.py's recipe (images [3, px, px] of
    ``dtype``, int64 labels, the mean cross entropy, Momentum(lr, 0.9)),
    or one of CIFAR_NETS as the book trains it; ``px`` in place of the
    recipe's image size -> (main, startup, loss)."""
    from paddle_tpu_torch.models import benchmark_nets as bn
    from paddle_tpu_torch.models import image_classification as ic

    size, ncls, lr = {**IMAGE_NETS, **CIFAR_NETS}[model]
    px = px or size
    build = {"resnet50": lambda x: ic.resnet_imagenet(x, ncls, depth=50),
             "alexnet": lambda x: bn.alexnet(x, class_num=ncls),
             "googlenet": lambda x: bn.googlenet_v1(x, class_num=ncls),
             "smallnet": lambda x: bn.smallnet_cifar(x, class_num=ncls),
             "resnet_cifar10": lambda x: ic.resnet_cifar10(x, 32, ncls),
             "vgg16_bn_drop": lambda x: ic.vgg16_bn_drop(x, ncls)}[model]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, px, px], dtype)
        label = fluid.layers.data("label", [1], "int64")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=build(img), label=label))
        if model == "vgg16_bn_drop":
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        else:
            fluid.optimizer.Momentum(learning_rate=lr,
                                     momentum=0.9).minimize(loss)
    return main, startup, loss


def image_feed(torch, np, model, batch, dtype="bfloat16", i=0, px=None):
    """A batch made from the seed: bench.py's for IMAGE_NETS (images
    uniform in [0, 1), random labels), tests/test_book.py's synthetic
    CIFAR batch for CIFAR_NETS (class k brightens channel k % 3; step
    ``i``'s own seed), images of ``px`` px in place of the recipe's.
    bf16 images as a bf16 tensor."""
    size, ncls, _ = {**IMAGE_NETS, **CIFAR_NETS}[model]
    px = px or size
    rng = np.random.RandomState(SEED + i)
    lbl = rng.randint(0, ncls, (batch, 1)).astype(np.int64)
    img = rng.rand(batch, 3, px, px).astype(np.float32)
    if model in CIFAR_NETS:
        img *= 0.2
        for b, k in enumerate(lbl[:, 0]):
            img[b, k % 3] += 0.8
    if dtype == "bfloat16":
        img = torch.from_numpy(img).to(torch.bfloat16)
    return {"img": img, "label": lbl}


def ulp_nudged(np, feed):
    """The feed with every pixel moved one float32 ulp up or down."""
    img = feed["img"]
    up = np.random.RandomState(SEED).rand(*img.shape) < 0.5
    return dict(feed, img=np.nextafter(
        img, np.where(up, np.inf, -np.inf).astype(np.float32)))


def as_float32(torch, feed):
    """A bf16 image feed as the float32 program takes it."""
    return dict(feed, img=feed["img"].float().numpy())


def moving_stats(main):
    """The moving means and variances the program's batch norms write."""
    return [op.output(s)[0] for op in main.global_block().ops
            if op.type == "batch_norm" for s in ("MeanOut", "VarianceOut")]


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms only, so that a replay and the
    same step run eagerly can agree bitwise (some backward algorithms
    add with atomics)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _max_rel(np, got, want):
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def resnet_compare(torch, np, fluid, dtype):
    """Step 3 of ResNet-50 in bench.py's recipe at R50_COMPARE_PX px and
    IMAGE_COMPARE_BATCH, from the card's state after R50_WARM_STEPS steps
    (a graph replay; the learning rate R50_COMPARE_LR), against the same
    step run eagerly, and against the CPU port from the card's state
    before it: the loss, every gradient and the moving stats, by the R50
    rules above.  float32 also records the CPU's own gradient change
    when every pixel moves one float32 ulp (the state's conditioning).
    -> (record, ok)."""
    main, startup, loss = build_image(fluid, "resnet50", dtype,
                                      R50_COMPARE_PX)
    init = initial_scope(fluid, startup)
    lr_var, = {op.input("LearningRate")[0]
               for op in main.global_block().ops if op.type == "momentum"}
    init[lr_var] = np.array([R50_COMPARE_LR], np.float32)
    params = [p.name for p in main.global_block().all_parameters()]
    fetch = ([loss.name] + [n + "@GRAD" for n in params]
             + moving_stats(main))
    if dtype == "float32":
        cpu = [(main, fetch), (main, fetch, lambda f: ulp_nudged(np, f))]
    else:
        f32 = build_image(fluid, "resnet50", "float32", R50_COMPARE_PX)[0]
        cpu = [(main, fetch), (f32, fetch, lambda f: as_float32(torch, f))]

    def feed_of(i):
        return image_feed(torch, np, "resnet50", IMAGE_COMPARE_BATCH,
                          dtype, i, R50_COMPARE_PX)

    t0 = time.perf_counter()
    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    with cudnn_deterministic(torch):
        warm = [float(exe.run(main, feed=feed_of(100 + i),
                              fetch_list=[loss], scope=scope)[0])
                for i in range(R50_WARM_STEPS)]
        init = fluid.scope_to_numpy(scope)
        del exe, scope
        r = captured_step(torch, fluid, main, fetch, init, feed_of, cpu)
    n = len(params)

    def split(values):
        return float(values[0]), values[1:1 + n], values[1 + n:]

    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu), (l_ref, g_ref, s_ref) \
        = split(r["card"]), split(r["cpu"][0][0]), split(r["cpu"][1][0])

    def gaps(a, b):
        d = [_rel_l2(np, x, y) for x, y in zip(a, b)]
        return float(np.median(d)), max(d)

    rec = {"dtype": dtype, "px": R50_COMPARE_PX,
           "batch": IMAGE_COMPARE_BATCH, "n_params": n,
           "warm_losses": warm[::10] + warm[-1:], "loss_card": l_card,
           "loss_cpu": l_cpu,
           "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
           "replay": replay_record(r), "seconds": time.perf_counter() - t0}
    rec["replay_ok"] = r["bitwise"] or replay_ok(
        r, set(params), loss.name, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
        2 * R50_COMPARE_LR + 1e-6)
    l2 = [_rel_l2(np, a, b) for a, b in zip(g_card, g_cpu)]
    worst = int(np.argmax(l2))
    rec.update(grad_rel_l2_max=l2[worst], grad_rel_l2_worst=params[worst],
               grad_rel_l2_median=float(np.median(l2)))
    if dtype == "float32":
        rel = [_max_rel(np, a, b) for a, b in zip(g_card, g_cpu)]
        floor = [_max_rel(np, a, b) for a, b in zip(g_ref, g_cpu)]
        rec.update(
            calm_share=float(np.mean(np.array(rel) <= STEP_GRAD_RTOL)),
            grad_rel_err_median=float(np.median(rel)),
            grad_rel_err_max=max(rel),
            stat_rel_err=max(_max_rel(np, a, b)
                             for a, b in zip(s_card, s_cpu)),
            floor_calm_share=float(np.mean(np.array(floor)
                                           <= STEP_GRAD_RTOL)),
            floor_rel_err_median=float(np.median(floor)),
            floor_rel_err_max=max(floor))
        ok = (rec["loss_rel_err"] <= STEP_LOSS_RTOL
              and rec["stat_rel_err"] <= R50_STAT_RTOL
              and l2[worst] <= R50_GRAD_L2)
    else:
        (cm, cx), (pm, px_) = gaps(g_card, g_ref), gaps(g_cpu, g_ref)
        (sm, sx), (tm, tx) = gaps(s_card, s_ref), gaps(s_cpu, s_ref)
        rec.update(loss_cpu_f32=l_ref,
                   card_vs_f32_median=cm, card_vs_f32_max=cx,
                   cpu_vs_f32_median=pm, cpu_vs_f32_max=px_,
                   stats_card_vs_f32_median=sm, stats_card_vs_f32_max=sx,
                   stats_cpu_vs_f32_median=tm, stats_cpu_vs_f32_max=tx,
                   grad_dtypes=sorted({str(g.dtype) for g in g_card}))
        ok = (rec["loss_rel_err"] <= AMP_LOSS_RTOL
              and l2[worst] <= R50_BF16_GRAD_L2
              and cm <= AMP_NOISE_RATIO * pm and cx <= AMP_NOISE_RATIO * px_
              and sm <= R50_FWD_NOISE_RATIO * tm
              and sx <= R50_FWD_NOISE_RATIO * tx
              and rec["grad_dtypes"] == ["float32"])
    return rec, ok and rec["replay_ok"]


def replay_check(torch, np, fluid, model, dtype, feed):
    """Step 3 of ``model`` on ``feed`` (a graph replay) from the startup's
    state against the same step run eagerly, under cuDNN's deterministic
    algorithms: bitwise, or each differing value within the card-vs-CPU
    limits.  -> (record, ok)."""
    main, startup, loss = build_image(fluid, model, dtype)
    init = initial_scope(fluid, startup)
    params = [p.name for p in main.global_block().all_parameters()]
    with cudnn_deterministic(torch):
        r = captured_step(torch, fluid, main, [loss.name], init,
                          lambda i: feed)
    ok = r["bitwise"] or replay_ok(
        r, set(params), loss.name, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
        2 * {**IMAGE_NETS, **CIFAR_NETS}[model][2] + 1e-6)
    return replay_record(r), ok


def host_syncs_per_step(torch, step, steps=SYNC_STEPS):
    """The host's waits for the card (synchronize calls) inside each of
    ``steps`` calls of ``step``, under torch.profiler, a step."""
    from torch.profiler import ProfilerActivity, profile

    name = "chip_smoke/step"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with torch.profiler.record_function(name):
                step()
    return host_syncs_in(prof.events(), name) / steps


def on_device(event):
    """Whether a torch.profiler event lies on the card's timeline (a
    kernel, a copy, or the device's copy of a host range)."""
    return "CUDA" in str(getattr(event, "device_type", ""))


def host_syncs_in(events, name):
    """The synchronize calls among a profile's ``events`` that start
    inside a host range named ``name`` (each drains the stream, so the
    host cannot queue work ahead of it).  The range's device copy spans
    its kernels on the card's timeline and ends after the host's range:
    the profiler's own synchronize at its exit can fall inside it, so it
    is left out."""
    spans = [e.time_range for e in events
             if e.name == name and not on_device(e)]
    return sum(1 for e in events if e.name in SYNC_CALLS
               and any(r.start <= e.time_range.start <= r.end
                       for r in spans))


def device_busy(events, wall_ms):
    """The device's work among torch.profiler ``events`` over a window
    of ``wall_ms`` on the host's clock -> (kernels {name: [device us,
    launches]}, busy ms: the sum of their device times, which do not
    overlap on one stream, idle share: 1 - busy / wall).  A device event
    named as a host event is the device's copy of a host range
    (``record_function``'s: a step's, an eager Fluid op's), not work,
    and is left out."""
    on_dev = [on_device(e) for e in events]
    host = {e.name for e, d in zip(events, on_dev) if not d}
    kernels = {}
    for e, d in zip(events, on_dev):
        if d and e.name not in host:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    busy = sum(us for us, _ in kernels.values()) / 1e3
    return kernels, busy, 1.0 - busy / wall_ms


def zero_launch_counts():
    """Every kernel's launch count set to 0."""
    from paddle_tpu_torch.kernels import add_launches, launch_counts

    add_launches({k: -v for k, v in launch_counts().items()})


def train_images(torch, np, fluid, main, startup, loss, feeds, steps):
    """An image path as bench.py runs it: the startup program on the
    card, then ``steps`` steps of ``Executor.run`` (eager and captured,
    then replays) over ``feeds`` (step i takes feeds[i % len(feeds)],
    staged on the card first, as bench.py keeps its batch on the
    device), every kernel's launch count set to 0 just before and read
    just after (no kernel of this repo lies on these paths), then
    SYNC_STEPS more steps profiled for the host syncs a replayed step
    makes.  -> record."""
    from paddle_tpu_torch.kernels import launch_counts

    dev = torch.device("cuda", 0)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    staged = [device_feed(torch, f, dev) for f in feeds]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    zero_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        # the fetched loss comes back as a numpy array: the step is done
        lv, = exe.run(main, feed=staged[i % len(staged)],
                      fetch_list=[loss], scope=scope)
        times.append(time.perf_counter() - t0)
        losses.append(float(lv))
    launches = sum(launch_counts().values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    stats = exe.cache_stats()["executable"]
    syncs = host_syncs_per_step(torch, lambda: exe.run(
        main, feed=staged[-1], fetch_list=[loss], scope=scope))
    steady = statistics.median(times[1:])
    batch = int(staged[0]["label"].shape[0])
    rec = {"batch": batch, "steps": steps, "losses": losses,
           "first_step_ms": times[0] * 1e3, "step_ms_median": steady * 1e3,
           "images_per_s": batch / steady, "peak_mem_gib": peak,
           "peak_reserved_gib": reserved, "executable": stats,
           "graph": step_graph(exe), "host_syncs_per_step": syncs,
           "repo_kernel_launches": launches}
    del exe, scope, staged
    torch.cuda.empty_cache()
    return rec


def image_train_failures(path, rec, hits):
    """What a training path's record must show: ``hits`` executable hits,
    one captured graph with no kernel of this repo in it and none
    launched, one host sync a replayed step (the fetch), finite losses,
    the mean of the last 5 below the mean of the first 5."""
    out = []
    if rec["executable"]["hits"] != hits:
        out.append(f"{path}: {rec['executable']} in {rec['steps']} steps, "
                   f"want {hits} hits")
    if rec["graph"].get("graphs") != 1 or rec["graph"].get("by_family") \
            or rec["repo_kernel_launches"]:
        out.append(f"{path}: graph {rec['graph']}, launches "
                   f"{rec['repo_kernel_launches']}: want one graph and no "
                   f"kernel of this repo")
    if rec["host_syncs_per_step"] != 1:
        out.append(f"{path}: {rec['host_syncs_per_step']} host syncs a "
                   f"step, want 1")
    losses = rec["losses"]
    if not (all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])):
        out.append(f"{path}: the loss did not fall, {losses}")
    return out


def image_phase(torch, np, fluid, card):
    """Phase 16: ResNet-50 in bench.py's bf16 recipe and in float32 (step
    3 at R50_COMPARE_PX against the eager step and the CPU, step 3 at
    IMAGE_BATCH against the eager step, then RESNET_STEPS steps at
    IMAGE_BATCH), AlexNet, GoogLeNet and SmallNet in bench.py's recipe
    (step 3 against the eager step at IMAGE_BATCH, then IMAGE_NET_STEPS
    steps), each on one fixed batch, and the book's CIFAR ResNet-32 and
    VGG-16 (CIFAR_STEPS steps on fresh synthetic batches); every loss
    falling.  -> (the ``image`` record, failures)."""
    rec, fails = {"card": card}, []
    runs = [("resnet50", dt, RESNET_STEPS) for dt in ("bfloat16", "float32")]
    runs += [(m, "bfloat16", IMAGE_NET_STEPS)
             for m in ("alexnet", "googlenet", "smallnet")]
    for model, dtype, steps in runs:
        t0 = time.perf_counter()
        key = f"{model}_{dtype}" if model == "resnet50" else model
        extra = {}
        if model == "resnet50":
            cmp_, ok = resnet_compare(torch, np, fluid, dtype)
            log(f"image resnet50 {dtype} step {COMPARE_STEP} at "
                f"{R50_COMPARE_PX} px {'ok  ' if ok else 'FAIL'} "
                f"{json.dumps(cmp_)}")
            if not ok:
                fails.append(f"resnet50 {dtype} step {COMPARE_STEP}: {cmp_}")
            extra["compare"] = cmp_
        feed = image_feed(torch, np, model, IMAGE_BATCH, dtype)
        replay, ok = replay_check(torch, np, fluid, model, dtype, feed)
        if not ok:
            fails.append(f"{key} step {COMPARE_STEP} replay vs eager: "
                         f"{replay}")
        main, startup, loss = build_image(fluid, model, dtype)
        run = train_images(torch, np, fluid, main, startup, loss, [feed],
                           steps)
        # bf16 ResNet-50: the startup program fills the moving stats in
        # bf16 and the first step makes them float32, as the reference's
        # does, so the executor keeps no step 1 and captures step 2
        hits = steps - (2 if key == "resnet50_bfloat16" else 1)
        fails += image_train_failures(key, run, hits)
        run.update(extra, replay=replay, seconds=time.perf_counter() - t0)
        rec[key] = run
        log(f"image {key}: {json.dumps(run)}")
    for model in CIFAR_NETS:
        t0 = time.perf_counter()
        main, startup, loss = build_image(fluid, model, "float32")
        run = train_images(
            torch, np, fluid, main, startup, loss,
            [image_feed(torch, np, model, IMAGE_BATCH, "float32", i)
             for i in range(CIFAR_STEPS)], CIFAR_STEPS)
        fails += image_train_failures(model, run, CIFAR_STEPS - 1)
        run["seconds"] = time.perf_counter() - t0
        rec[model] = run
        log(f"image {model}: {json.dumps(run)}")
    return rec, fails


# -- phase 17: sparse embeddings and the book's embedding chapters ----------

# CTR wide&deep at models/ctr.py's defaults: 26 categorical slots, 13
# dense features, embed 16, hidden 400-400-400, Adagrad 0.1, batch 1024.
# Each slot's table has 1,000,001 rows: the hashed Criteo vocabulary of
# the PaddlePaddle CTR examples.  26 deep [V, 16] and 26 wide [V, 1]
# tables: 1.77 GB of float32, 3.5 GB with Adagrad's moments.
CTR_SLOTS, CTR_DENSE, CTR_VOCAB, CTR_EMBED = 26, 13, 1_000_001, 16
CTR_HIDDEN, CTR_LR, CTR_BATCH = (400, 400, 400), 0.1, 1024
# steps a run; seeded batches staged on the card and taken in turn
CTR_STEPS, CTR_BATCHES = 20, 4
# the ids' skew: a Zipf draw (exponent 1.1) hashed over the table, so
# the most frequent ids repeat in a batch, as clicked categories do
CTR_ZIPF = 1.1
# card vs CPU port, step 3 from the card's state, both sides float32:
# the loss SPARSE_LOSS_RTOL (summation order only); each state var the
# step writes within SPARSE_UPDATE_RTOL of that var's largest update,
# beyond the float32 rounding of each side's sum (two ulps of the new
# value: an update far below a parameter's size rounds away, and
# word2vec's read 4e-4 of its largest without this slack).  Adagrad's
# update lr * g / (sqrt(m) + eps) is steepest where |g| is near eps
# (1e-6): a summation-order difference dg moves it by ~lr * dg / (4 eps)
# there, and CTR's embeddings read 4.0e-3 of their largest update on an
# H100 for that reason alone.  So an Adagrad parameter's elements are
# held where this step's gradient (the square root of its moment's
# change) is at least SPARSE_G_FLOOR of the var's largest, and the
# moment itself (the squared gradients) everywhere.
SPARSE_LOSS_RTOL, SPARSE_UPDATE_RTOL, SPARSE_G_FLOOR = 1e-5, 1e-3, 1e-3
# replays of a captured step timed on the device clock
REPLAY_TIMES = 10
# the book's embedding chapters at their published sizes: word2vec
# (book ch.04: embed 32, hidden 256, the imikolov dictionary's 2073
# words, batch 32, SGD), the recommender (ch.05: MovieLensDims()'s
# vocabularies, sparse tables, SGD 0.2, batch 256) and convolution_net
# (ch.06: the IMDB dictionary's 5147 words, emb 32, hid 32, Adam 2e-3,
# batch 128, reviews of up to 100 words)
W2V_DICT, W2V_EMBED, W2V_HIDDEN, W2V_BATCH, W2V_LR = 2073, 32, 256, 32, 0.1
REC_BATCH, REC_LR = 256, 0.2
CONV_DICT, CONV_BATCH, CONV_T, CONV_LR = 5147, 128, 100, 2e-3
EMB_STEPS, EMB_BATCHES = 20, 4
# the sparse update ops on the card against the CPU: a [SPARSE_OP_V,
# SPARSE_OP_D] table, SPARSE_OP_N rows with repeats and sentinel slots;
# fp32 on both sides, sqrt and division rounding alike but for an ulp
SPARSE_OP_V, SPARSE_OP_D, SPARSE_OP_N = 100_000, 16, 4096
SPARSE_OP_RTOL = 1e-5


def ctr_build(fluid, is_sparse):
    """CTR wide&deep (models/ctr.py) at CTR_* with Adagrad -> (main,
    startup, loss).  The sparse and the dense program share their
    startup program: the same parameters from the same seed."""
    from paddle_tpu_torch.models import ctr

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = [layers.data(f"C{i}", [1], "int64") for i in range(CTR_SLOTS)]
        dense = layers.data("dense", [CTR_DENSE], "float32")
        label = layers.data("label", [1], "float32")
        loss, _ = ctr.wide_and_deep(ids, dense, label, slot_vocab=CTR_VOCAB,
                                    embed_dim=CTR_EMBED,
                                    hidden_sizes=CTR_HIDDEN,
                                    is_sparse=is_sparse)
        fluid.optimizer.Adagrad(learning_rate=CTR_LR).minimize(loss)
    return main, startup, loss


def ctr_feed(np, i):
    """Batch ``i``: each slot's ids a Zipf draw hashed over its table,
    13 normal dense features, a click where slot 0's id is even (the
    wide part can learn it, tests/test_sparse.py's signal)."""
    rng = np.random.RandomState(SEED + i)
    batch = CTR_BATCH
    z = rng.zipf(CTR_ZIPF, (batch, CTR_SLOTS)).astype(np.int64)
    ids = (z * 2654435761 + np.arange(CTR_SLOTS) * 40503) % CTR_VOCAB
    feed = {f"C{k}": ids[:, k:k + 1] for k in range(CTR_SLOTS)}
    feed["dense"] = rng.randn(batch, CTR_DENSE).astype(np.float32)
    feed["label"] = (ids[:, :1] % 2 == 0).astype(np.float32)
    return feed


def sparse_tables(main):
    """The parameters a program looks up with a sparse gradient."""
    return sorted({op.input("W")[0] for op in main.global_block().ops
                   if op.type == "lookup_table" and op.attr("is_sparse")})


def update_errors(np, card, cpu, before, names, moments=None):
    """Each var of ``names`` after the step, card against CPU: the largest
    difference beyond two float32 ulps of the CPU's value, over the var's
    largest update on the CPU.  ``moments`` maps an Adagrad parameter to
    its moment: the parameter is held only where this step's gradient
    (sqrt of the moment's change) is at least SPARSE_G_FLOOR of its
    largest.  -> {name: error}."""
    out = {}
    for n in names:
        a, b, b0 = (np.asarray(x[n], np.float64) for x in (card, cpu, before))
        slack = 2 * np.spacing(np.abs(np.asarray(cpu[n], np.float32)))
        excess = np.maximum(np.abs(a - b) - slack, 0.0)
        m = (moments or {}).get(n)
        if m is not None:
            g = np.sqrt(np.abs(np.asarray(cpu[m], np.float64)
                               - np.asarray(before[m], np.float64)))
            excess = np.where(g >= SPARSE_G_FLOOR * g.max(), excess, 0.0)
        out[n] = float(excess.max()) / max(float(np.abs(b - b0).max()),
                                           1e-30)
    return out


def adagrad_moments(main):
    """{parameter: its Adagrad moment} of a program's adagrad ops."""
    return {op.input("Param")[0]: op.input("Moment")[0]
            for op in main.global_block().ops if op.type == "adagrad"}


def replay_ms(torch, exe, graph=None):
    """The device's time for one step: REPLAY_TIMES replays of the
    executor's one captured graph (or ``graph``) between two CUDA events
    (the feeds left in its buffers, the state moving on)."""
    graph = exe.graphs()[0] if graph is None else graph
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPLAY_TIMES):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPLAY_TIMES


def ctr_run(torch, np, fluid, is_sparse, state0, feeds, host_feeds,
            failures):
    """One CTR run on the card from ``state0`` (the startup's tensors on
    the card, cloned): CTR_STEPS steps of ``Executor.run`` over ``feeds``
    (staged on the card; ``host_feeds`` the same on the host) in turn,
    every kernel's launch count set to 0 before and read after.  Steps
    1-2 give the peak over what is resident before them (``state0`` and
    the run's own state: one eager step and the capture); step 3, a
    replay, is held bitwise against the same step run eagerly
    (``run_block_ops``) on a clone of the state before it, and against
    the CPU port from that state (the full tables); steps 4-CTR_STEPS
    give the step time; then SYNC_STEPS profiled steps give the host
    syncs a step, and REPLAY_TIMES replays of the graph the device's
    time a step."""
    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor, step_seeds)
    from paddle_tpu_torch.kernels import launch_counts

    kind = "sparse" if is_sparse else "dense"
    main, _, loss = ctr_build(fluid, is_sparse)
    place = fluid.CUDAPlace(0)
    dev = torch.device("cuda", 0)
    scope = fluid.Scope()
    for n, v in state0.items():
        scope.set_var(n, v.clone())
    exe = fluid.Executor(place)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    zero_launch_counts()
    losses, times = [], []

    def step(i):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                      scope=scope)
        times.append(time.perf_counter() - t0)
        losses.append(float(out[0]))

    for i in range(COMPARE_STEP - 1):
        step(i)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    # step 3: the replay, the eager step and the CPU, from one state
    k = (COMPARE_STEP - 1) % len(feeds)
    feed = feeds[k]
    plan = BlockPlan(main.desc.global_block(), list(feed), [loss.name])
    # the state before step 3 on the card (the eager step updates it in
    # place), on the CPU for the CPU's step, and as numpy
    pre = {n: scope.find_var(n).clone() for n in plan.state_in}
    cpu_scope = fluid.Scope()
    for n, v in pre.items():
        cpu_scope.set_var(n, v.to("cpu", copy=True))
    before = {n: cpu_scope.find_var(n).numpy().copy()
              for n in plan.state_out}
    step(COMPARE_STEP - 1)
    written = {n: scope.find_var(n).clone() for n in plan.state_out}
    env = dict(pre)
    env.update(feed)
    seeds = step_seeds(plan, main.random_seed, COMPARE_STEP)
    with torch.no_grad():
        run_block_ops(plan, env, seeds, seed_tensor(seeds).to(dev), dev,
                      "train")
    differs = sorted(n for n in plan.state_out
                     if not torch.equal(written[n], env[n]))
    eager_loss = float(env[loss.name])
    bitwise = not differs and eager_loss == losses[-1]
    del env, pre
    cpu_scope._rng_seed, cpu_scope._rng_step = main.random_seed, \
        COMPARE_STEP - 1
    t0 = time.perf_counter()
    cpu_loss = float(fluid.Executor(fluid.CPUPlace()).run(
        main, feed=host_feeds[k], fetch_list=[loss], scope=cpu_scope)[0])
    cpu_s = time.perf_counter() - t0
    card_after = {n: written[n].cpu().numpy() for n in plan.state_out}
    cpu_after = {n: cpu_scope.find_var(n).numpy() for n in plan.state_out}
    del written, cpu_scope
    upd = update_errors(np, card_after, cpu_after, before, plan.state_out,
                        adagrad_moments(main))
    del card_after, cpu_after, before
    loss_err = abs(losses[-1] - cpu_loss) / abs(cpu_loss)
    worst = max(upd, key=upd.get)
    torch.cuda.empty_cache()
    for i in range(COMPARE_STEP, CTR_STEPS):
        step(i)
    launches = sum(launch_counts().values())
    hits = exe.cache_stats()["executable"]
    syncs = host_syncs_per_step(torch, lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope))
    device = replay_ms(torch, exe)
    steady = statistics.median(times[COMPARE_STEP:])
    rec = {"is_sparse": is_sparse, "batch": CTR_BATCH, "steps": CTR_STEPS,
           "losses": losses, "first_step_ms": times[0] * 1e3,
           "step_ms_median": steady * 1e3,
           "examples_per_s": CTR_BATCH / steady,
           "device_ms": device, "host_share": 1 - device / (steady * 1e3),
           "resident_gib": resident, "peak_mem_gib": peak,
           "peak_over_resident_gib": peak - resident,
           "peak_reserved_gib": reserved,
           "executable": hits, "graph": step_graph(exe),
           "host_syncs_per_step": syncs,
           "repo_kernel_launches": launches,
           "replay": {"step": COMPARE_STEP, "bitwise": bitwise,
                      "differs": differs[:10], "n_differs": len(differs),
                      "eager_loss": eager_loss},
           "cpu": {"loss_rel_err": loss_err, "worst_update": worst,
                   "worst_update_rel_err": upd[worst],
                   "cpu_step_s": cpu_s}}
    del exe, scope
    torch.cuda.empty_cache()
    if hits["hits"] != CTR_STEPS - 1:
        failures.append(f"ctr {kind}: {hits}, want {CTR_STEPS - 1} hits")
    if rec["graph"].get("graphs") != 1 or rec["graph"].get("by_family") \
            or launches:
        failures.append(f"ctr {kind}: graph {rec['graph']}, launches "
                        f"{launches}: want one graph, no kernel of this "
                        f"repo")
    if syncs != 1:
        failures.append(f"ctr {kind}: {syncs} host syncs a step, want 1")
    if not bitwise:
        failures.append(f"ctr {kind}: step {COMPARE_STEP} replay vs eager "
                        f"differs in {differs[:10]} (loss {losses[-1]} vs "
                        f"{eager_loss})")
    if loss_err > SPARSE_LOSS_RTOL or upd[worst] > SPARSE_UPDATE_RTOL:
        failures.append(f"ctr {kind}: card vs CPU at step {COMPARE_STEP}: "
                        f"loss {loss_err}, {worst} {upd[worst]}")
    if not (all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])):
        failures.append(f"ctr {kind}: the loss did not fall, {losses}")
    return rec


def ctr_phase(torch, np, fluid, failures):
    """CTR wide&deep at full width, sparse then dense, from one startup
    run on the card, on the same seeded batches.  -> record."""
    t0 = time.perf_counter()
    main, startup, _ = ctr_build(fluid, True)
    tables = sparse_tables(main)
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    state0 = {n: v for n, v in scope.vars.items() if v is not None}
    del scope
    startup_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    host_feeds = [ctr_feed(np, i) for i in range(CTR_BATCHES)]
    feeds = [device_feed(torch, f, dev) for f in host_feeds]
    rec = {"slots": CTR_SLOTS, "vocab": CTR_VOCAB, "embed": CTR_EMBED,
           "hidden": list(CTR_HIDDEN), "batch": CTR_BATCH,
           "optimizer": f"Adagrad {CTR_LR}", "tables": len(tables),
           "tables_gib": sum(state0[n].numel() * state0[n].element_size()
                             for n in tables) / 2**30,
           "state_gib": sum(v.numel() * v.element_size()
                            for v in state0.values()) / 2**30,
           "startup_s": startup_s,
           "distinct_ids_per_slot_batch0": float(np.mean(
               [len(np.unique(host_feeds[0][f"C{k}"]))
                for k in range(CTR_SLOTS)]))}
    for is_sparse in (True, False):
        kind = "sparse" if is_sparse else "dense"
        rec[kind] = ctr_run(torch, np, fluid, is_sparse, state0, feeds,
                            host_feeds, failures)
        log(f"sparse ctr {kind}: {json.dumps(rec[kind])}")
    if not rec["sparse"]["peak_mem_gib"] < rec["dense"]["peak_mem_gib"]:
        failures.append(f"ctr: sparse peak {rec['sparse']['peak_mem_gib']} "
                        f"GiB not below dense "
                        f"{rec['dense']['peak_mem_gib']}")
    # the sparse Adagrad is the dense one on the touched rows, op for op,
    # and leaves the others as the dense one does (m + 0, p - 0)
    rec["sparse_vs_dense_loss_max_rel"] = max(
        abs(a - b) / abs(b) for a, b in zip(rec["sparse"]["losses"],
                                            rec["dense"]["losses"]))
    if rec["sparse_vs_dense_loss_max_rel"] > SPARSE_LOSS_RTOL:
        failures.append(f"ctr: sparse and dense losses apart by "
                        f"{rec['sparse_vs_dense_loss_max_rel']}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def build_embedding_model(fluid, model):
    """word2vec (``ngram_model``), the recommender or ``convolution_net``
    at the sizes above -> (main, startup, loss)."""
    from paddle_tpu_torch.models import recommender, sentiment, word2vec

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "word2vec":
            words = [layers.data(n, [1], "int64") for n in
                     ("firstw", "secondw", "thirdw", "forthw", "nextw")]
            loss, _ = word2vec.ngram_model(words, W2V_DICT, W2V_EMBED,
                                           W2V_HIDDEN)
            fluid.optimizer.SGD(learning_rate=W2V_LR).minimize(loss)
        elif model == "recommender":
            loss, _ = recommender.recommender(recommender.MovieLensDims())
            fluid.optimizer.SGD(learning_rate=REC_LR).minimize(loss)
        else:
            data = layers.data("words", [1], "int64", lod_level=1)
            label = layers.data("label", [1], "int64")
            loss, _, _ = sentiment.convolution_net(data, label, CONV_DICT)
            fluid.optimizer.Adam(learning_rate=CONV_LR).minimize(loss)
    return main, startup, loss


def embedding_feed(np, fluid, model, i):
    """Batch ``i`` of a learnable synthetic signal (tests/test_book.py's):
    word2vec's next word the context's sum mod the dictionary, the
    recommender's rating from the user and movie ids' parity, the review
    class from which half of the dictionary its words come from."""
    rng = np.random.RandomState(SEED + i)
    if model == "word2vec":
        ctx = rng.randint(0, W2V_DICT, (W2V_BATCH, 4))
        nxt = ctx.sum(axis=1, keepdims=True) % W2V_DICT
        ids = np.concatenate([ctx, nxt], axis=1).astype(np.int64)
        return {n: ids[:, k:k + 1] for k, n in enumerate(
            ("firstw", "secondw", "thirdw", "forthw", "nextw"))}
    if model == "recommender":
        from paddle_tpu_torch.models.recommender import MovieLensDims

        d, b = MovieLensDims(), REC_BATCH
        uid = rng.randint(0, d.max_user_id, (b, 1))
        mid = rng.randint(0, d.max_movie_id, (b, 1))
        return {"user_id": uid, "gender_id": uid % 2,
                "age_id": uid % d.n_age_buckets,
                "job_id": uid % d.max_job_id, "movie_id": mid,
                "category_id": fluid.make_seq(
                    [rng.randint(0, d.n_categories, rng.randint(1, 4))
                     for _ in range(b)], dtype=np.int32, max_len=4),
                "movie_title": fluid.make_seq(
                    [rng.randint(0, d.title_dict_size, rng.randint(3, 16))
                     for _ in range(b)], dtype=np.int32, max_len=16),
                "score": (2.5 + ((uid + mid) % 2) * 2.0).astype(np.float32)}
    lbl = rng.randint(0, 2, CONV_BATCH)
    half = CONV_DICT // 2
    seqs = [rng.randint(half * c, half * (c + 1), rng.randint(5, CONV_T + 1))
            for c in lbl]
    return {"words": fluid.make_seq(seqs, dtype=np.int32, max_len=CONV_T),
            "label": lbl[:, None].astype(np.int64)}


def embedding_model_phase(torch, np, fluid, model, failures):
    """A book embedding chapter: step 3 on the card (a replay) against the
    eager step and the CPU port from the card's state (the loss, every
    dense gradient, every state var the step writes), then EMB_STEPS
    steps over EMB_BATCHES seeded batches, every kernel's launch count
    set to 0 before and read after.  -> record."""
    from paddle_tpu_torch.kernels import launch_counts

    t0 = time.perf_counter()
    main, startup, loss = build_embedding_model(fluid, model)
    init = initial_scope(fluid, startup)
    sparse = set(sparse_tables(main))
    params = [p.name for p in main.global_block().all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in params if n not in sparse]
    feeds = [embedding_feed(np, fluid, model, i) for i in range(EMB_BATCHES)]
    r = captured_step(torch, fluid, main, fetch, init,
                      lambda i: feeds[i % len(feeds)], [(main, fetch)])
    card, (cpu, cpu_after) = r["card"], r["cpu"][0]
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_err = max(float(np.abs(a - b).max())
                   / max(float(np.abs(b).max()), 1e-30)
                   for a, b in zip(card[1:], cpu[1:]))
    written = [n for n in cpu_after if n in r["before"]
               and not np.array_equal(cpu_after[n], r["before"][n])]
    upd = update_errors(np, r["after"], cpu_after, r["before"], written,
                        adagrad_moments(main))
    worst = max(upd, key=upd.get)
    place = fluid.CUDAPlace(0)
    scope = fluid.scope_from_numpy(init, place)
    exe = fluid.Executor(place)
    dev = torch.device("cuda", 0)
    staged = [device_feed(torch, f, dev) for f in feeds]
    zero_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = [float(exe.run(main, feed=staged[i % len(staged)],
                            fetch_list=[loss], scope=scope)[0])
              for i in range(EMB_STEPS)]
    wall = time.perf_counter() - t1
    launches = sum(launch_counts().values())
    hits = exe.cache_stats()["executable"]["hits"]
    rec = {"model": model, "sparse_tables": sorted(sparse),
           "steps": EMB_STEPS, "losses": losses,
           "ms_per_step": wall / EMB_STEPS * 1e3, "executable_hits": hits,
           "graph": step_graph(exe), "repo_kernel_launches": launches,
           "step3_loss_rel_err": loss_err, "step3_grad_err": grad_err,
           "step3_worst_update": worst,
           "step3_worst_update_rel_err": upd[worst],
           "replay": replay_record(r),
           "seconds": time.perf_counter() - t0}
    del exe, scope, staged
    torch.cuda.empty_cache()
    if not r["bitwise"]:
        failures.append(f"{model}: step {COMPARE_STEP} replay vs eager: "
                        f"{r['differs']}")
    if loss_err > BOOK_LOSS_RTOL or grad_err > BOOK_GRAD_RTOL \
            or upd[worst] > SPARSE_UPDATE_RTOL:
        failures.append(f"{model}: card vs CPU at step {COMPARE_STEP}: loss "
                        f"{loss_err}, grads {grad_err}, {worst} {upd[worst]}")
    if hits != EMB_STEPS - 1 or rec["graph"].get("graphs") != 1 \
            or rec["graph"].get("by_family") or launches:
        failures.append(f"{model}: {hits} hits, graph {rec['graph']}, "
                        f"launches {launches}")
    if not (all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])):
        failures.append(f"{model}: the loss did not fall, {losses}")
    return rec


def sparse_op_checks(torch, np, failures):
    """Every sparse update op (sgd, momentum with and without Nesterov,
    adam, adagrad) and ``merge_rows`` on the card against the same op on
    the CPU: SPARSE_OP_N rows over a [SPARSE_OP_V, SPARSE_OP_D] table,
    Zipf-repeated, a quarter of the slots vacated (the sentinel row),
    non-zero moments.  The outputs within SPARSE_OP_RTOL of their
    largest, the rows no slot names bitwise unchanged, each state tensor
    written in place, and ``merge_rows`` run twice bitwise equal (no
    atomics).  -> {op: the largest error over its outputs}."""
    from paddle_tpu_torch.fluid.core import registry as reg
    from paddle_tpu_torch.fluid.core.desc import OpDesc
    from paddle_tpu_torch.fluid.core.selected_rows import (SelectedRows,
                                                           merge_rows)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    v, d, n = SPARSE_OP_V, SPARSE_OP_D, SPARSE_OP_N
    rows = (rng.zipf(CTR_ZIPF, n) * 2654435761 % v).astype(np.int32)
    rows[rng.rand(n) < 0.25] = v
    vals = rng.randn(n, d).astype(np.float32)
    untouched = np.setdiff1d(np.arange(v), rows)
    cases = {"sgd": ({}, ["Param"], ["ParamOut"]),
             "momentum": ({"mu": 0.9}, ["Param", "Velocity"],
                          ["ParamOut", "VelocityOut"]),
             "momentum_nesterov": ({"mu": 0.9, "use_nesterov": True},
                                   ["Param", "Velocity"],
                                   ["ParamOut", "VelocityOut"]),
             "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
                      ["Param", "Moment1", "Moment2", "Beta1Pow",
                       "Beta2Pow"],
                      ["ParamOut", "Moment1Out", "Moment2Out",
                       "Beta1PowOut", "Beta2PowOut"]),
             "adagrad": ({"epsilon": 1e-6}, ["Param", "Moment"],
                         ["ParamOut", "MomentOut"])}
    out = {}
    for name, (attrs, state, outs) in cases.items():
        op = name.split("_")[0]
        arrays = {"LearningRate": np.array([0.1], np.float32)}
        for s in state:
            arrays[s] = (np.array([0.9 ** 3 if s == "Beta1Pow"
                                   else 0.999 ** 3], np.float32)
                         if s.startswith("Beta") else
                         np.abs(rng.randn(v, d)).astype(np.float32))
        got = {}
        for where in ("cuda", "cpu"):
            device = dev if where == "cuda" else torch.device("cpu")
            ins = {s: [torch.tensor(a, device=device)]
                   for s, a in arrays.items()}
            ins["Grad"] = [SelectedRows(torch.tensor(rows, device=device),
                                        torch.tensor(vals, device=device),
                                        v)]
            desc = OpDesc(op, {s: [s] for s in ins}, {}, attrs)
            res = reg.get_op_info(op).emit(reg.EmitCtx(desc, device=device),
                                           ins)
            for s, o in zip(state, outs):
                if res[o][0] is not ins[s][0]:
                    failures.append(f"sparse op {name}: {o} not in place")
            got[where] = {o: res[o][0].cpu().numpy() for o in outs}
        err = 0.0
        for o in outs:
            a, b = got["cuda"][o], got["cpu"][o]
            err = max(err, float(np.abs(a - b).max())
                      / max(float(np.abs(b).max()), 1e-30))
            src = arrays[state[outs.index(o)]]
            if src.shape[0] == v and not np.array_equal(a[untouched],
                                                        src[untouched]):
                failures.append(f"sparse op {name}: {o} changed a row no "
                                f"slot names")
        out[name] = err
        if err > SPARSE_OP_RTOL:
            failures.append(f"sparse op {name}: card vs CPU {err}")
    sr = SelectedRows(torch.tensor(rows, device=dev),
                      torch.tensor(vals, device=dev), v)
    m1, m2 = merge_rows(sr), merge_rows(sr)
    mc = merge_rows(SelectedRows(torch.tensor(rows), torch.tensor(vals), v))
    same = torch.equal(m1.rows, m2.rows) and torch.equal(m1.values,
                                                         m2.values)
    rows_equal = torch.equal(m1.rows.cpu(), mc.rows)
    merge_err = float((m1.values.cpu() - mc.values).abs().max()
                      / mc.values.abs().max())
    out["merge_rows"] = merge_err
    out["merge_rows_repeat_bitwise"] = same
    if not (same and rows_equal and merge_err <= SPARSE_OP_RTOL):
        failures.append(f"merge_rows: repeat bitwise {same}, rows equal "
                        f"{rows_equal}, card vs CPU {merge_err}")
    return out


def sparse_phase(torch, np, fluid, card):
    """Phase 17: the sparse update ops and ``merge_rows`` against the CPU,
    CTR wide&deep at full width (sparse, then dense), and the book's
    word2vec, recommender and ``convolution_net``.  -> (the ``sparse``
    record, failures)."""
    failures = []
    t0 = time.perf_counter()
    rec = {"card": card, "ops": sparse_op_checks(torch, np, failures)}
    log(f"sparse ops card vs CPU: {json.dumps(rec['ops'])}")
    rec["ctr"] = ctr_phase(torch, np, fluid, failures)
    for model in ("word2vec", "recommender", "convolution_net"):
        rec[model] = embedding_model_phase(torch, np, fluid, model, failures)
        log(f"sparse {model}: {json.dumps(rec[model])}")
    rec["seconds"] = time.perf_counter() - t0
    return rec, failures


# -- phase 18: control flow and the seq2seq models ---------------------------

# bench.py's bench_nmt_quality (bench.py:2632-2680): the attention seq2seq
# (machine_translation.attention_*) at dict 2000, word 128, hidden 256,
# Adam 2e-3, batch 128, beam 3, max_length 32, top-k 50 (the decoder's
# default), decode parameters shared with training by name.  Its data
# here: seeded reversal pairs of NMT_MIN_LEN-NMT_MAX_LEN tokens (ids 2 up;
# 0 starts and 1 ends a target), make_seq(..., bucket=NMT_BUCKET), one
# source of NMT_MAX_LEN tokens a batch so every batch has one signature;
# NMT_BATCHES batches staged on the card and taken in turn
NMT_DICT, NMT_WORD, NMT_HIDDEN, NMT_LR = 2000, 128, 256, 2e-3
NMT_BATCH, NMT_BEAM, NMT_MAX_LEN, NMT_TOPK = 128, 3, 32, 50
NMT_MIN_LEN, NMT_BUCKET, NMT_START, NMT_END = 8, 8, 0, 1
NMT_STEPS, NMT_BATCHES, NMT_COMPARE_BATCH, NMT_DECODE_RUNS = 20, 4, 4, 3
# the book's chapter 8 (fluid/tests/book/test_machine_translation.py,
# test_rnn_encoder_decoder.py): the wmt14 dictionary's 30000 words, word
# 16, hidden 32 (the models' defaults), beam 2, max_length 8; a few steps
# at batch 32 on one fixed batch of 4-10 tokens
BOOK_NMT_DICT, BOOK_NMT_BATCH, BOOK_NMT_STEPS = 30000, 32, 5
BOOK_NMT_LEN, BOOK_NMT_BEAM, BOOK_NMT_MAX_LEN = (4, 10), 2, 8
# the bounded While: max_iters WHILE_ITERS, 5 iterations taken, an fc of
# width WHILE_WIDTH in the body, batch WHILE_BATCH, SGD WHILE_LR; the
# body accumulates the mean ("mean") or the sum ("sum") of its output's
# squares.  The sum's gradients, near 1e4, diverge SGD at this rate: by
# step 3 the tanh units saturate, where their derivative 1 - y^2 cancels,
# and float32 gradients lie a few percent of their largest from float64
# ones.  So each case also runs its step eagerly in float64 from the
# card's state before it, on the card and on the CPU: the two held to
# LSTM_GRAD_RTOL, and in the "sum" case the card's float32 gradients no
# farther from float64 than WHILE_NOISE_RATIO times the CPU's are.
WHILE_ITERS, WHILE_TAKEN, WHILE_WIDTH, WHILE_BATCH = 8, 5, 256, 64
WHILE_LR, WHILE_NOISE_RATIO = 0.1, 4.0
# the card's and the CPU's log-probabilities of the top-k candidates at
# a decode step whose inputs agree: float32 on both sides with TF32 off,
# summation order only (a 2000-way softmax over 256-wide products); a
# larger difference is a fault, not a bound for the near-tie rule
NMT_LOGPROB_ATOL = 1e-3


LSTM_COUNTER = "lstm/lstm_forward/launches"


def named_launches(counts):
    """``launch_counts()`` keyed by its paths joined with '/'."""
    return {"/".join(map(str, k)): v for k, v in counts.items()}


def nmt_batch(np, fluid, rng, batch, dict_size, lengths=None):
    """Seeded reversal pairs: a source of ``lengths`` tokens (by default
    NMT_MIN_LEN-NMT_MAX_LEN, the first row NMT_MAX_LEN), its target
    the start id and the source reversed, the next-word target the
    source reversed and the end id; bucketed as bench.py buckets."""
    if lengths is None:
        lengths = rng.randint(NMT_MIN_LEN, NMT_MAX_LEN + 1, batch)
        lengths[0] = NMT_MAX_LEN
    srcs = [rng.randint(2, dict_size, n) for n in lengths]

    def seq(rows):
        return fluid.make_seq(rows, dtype=np.int64, bucket=NMT_BUCKET)

    return {"src": seq(srcs),
            "trg": seq([np.concatenate([[NMT_START], s[::-1]])
                        for s in srcs]),
            "nxt": seq([np.concatenate([s[::-1], [NMT_END]])
                        for s in srcs])}


def build_nmt(fluid, model, dict_size, word, hidden, lr, beam=None,
              max_len=None):
    """A training program of ``model`` (machine_translation's
    ``train_model`` or ``attention_train_model``, or
    rnn_encoder_decoder's ``seq_to_seq_net``) with Adam, and, given
    ``beam``, its beam decoder over the same weights, pruned to its
    outputs.  -> (main, startup, loss, (decode program, ids, scores) or
    None)."""
    from paddle_tpu_torch.models import machine_translation as mt
    from paddle_tpu_torch.models import rnn_encoder_decoder as red

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src, trg, nxt = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                                           lod_level=1)
                         for n in ("src", "trg", "nxt")]
        if model == "seq_to_seq_net":
            loss, _ = red.seq_to_seq_net(src, trg, nxt, dict_size,
                                         dict_size, embedding_dim=word,
                                         encoder_size=hidden,
                                         decoder_size=hidden)
        else:
            loss, _ = getattr(mt, model)(src, trg, nxt, dict_size,
                                         word_dim=word, hidden_dim=hidden)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        decode = None
        if beam is not None:
            dec = (mt.attention_decode_model if model.startswith(
                "attention") else mt.decode_model)
            ids, scores = dec(src, dict_size, word_dim=word,
                              hidden_dim=hidden, beam_size=beam,
                              topk_size=NMT_TOPK, max_length=max_len,
                              start_id=NMT_START, end_id=NMT_END)
            decode = (fluid.io.prune_program(main, [ids, scores]), ids,
                      scores)
    return main, startup, loss, decode


def nmt_step_ok(step, lr):
    """Step 3 replayed bitwise against the eager step, card vs CPU port
    at the Transformer's float32 limits (PERF.md section 2) with this
    program's rate, and every element's update held to Adam's rule on
    the card's gradient (``update_rule_worst``).  The Transformer's
    floor on the share of elements its relative update check covers
    does not apply: these programs' gradients span orders of magnitude
    between the vocabulary projection and the rest, and the vocabulary
    rows this batch leaves out have none (measured on an H100: 0.21 of
    the attention model's elements, 0.003-0.01 of the book models'
    reach that check's floor); the rule's check covers them all."""
    return (step["replay"]["bitwise"]
            and step["loss_rel_err"] <= STEP_LOSS_RTOL
            and step["grad_rel_err"] <= STEP_GRAD_RTOL
            and step["param_max_abs_err"] <= 2 * lr + 1e-6
            and step["update_rel_err"] <= STEP_UPDATE_RTOL
            and step["update_rule_worst"] <= 1.0)


def train_nmt(torch, np, fluid, main, loss, init, feeds, steps):
    """A seq2seq training path: ``steps`` steps of ``Executor.run`` on
    the card over ``feeds`` (staged on the card, taken in turn; one
    signature), every kernel's launch count set to 0 just before and
    read just after, then SYNC_STEPS more steps profiled for the host
    syncs a replayed step makes, and REPLAY_TIMES replays of the graph
    between CUDA events for the device's time a step.  -> (record,
    scope)."""
    from paddle_tpu_torch.kernels import launch_counts

    dev = torch.device("cuda", 0)
    scope = fluid.scope_from_numpy(init, fluid.CUDAPlace(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    staged = [device_feed(torch, f, dev) for f in feeds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    zero_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        lv, = exe.run(main, feed=staged[i % len(staged)], fetch_list=[loss],
                      scope=scope)
        times.append(time.perf_counter() - t0)
        losses.append(float(lv))
    launches = named_launches(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = exe.cache_stats()["executable"]
    syncs = host_syncs_per_step(torch, lambda: exe.run(
        main, feed=staged[-1], fetch_list=[loss], scope=scope))
    device = replay_ms(torch, exe) if exe.graphs() else None
    steady = statistics.median(times[1:])
    # the real target tokens a batch (next words, the end id included)
    tokens = statistics.mean(int(np.asarray(f["nxt"].lengths).sum())
                             for f in feeds)
    rec = {"batch": int(np.asarray(feeds[0]["src"].lengths).shape[0]),
           "steps": steps, "losses": losses,
           "first_step_ms": times[0] * 1e3, "step_ms_median": steady * 1e3,
           "device_ms": device,
           "host_share": (1 - device / (steady * 1e3)
                          if device is not None else None),
           "target_tokens_per_batch": tokens,
           "target_tokens_per_s": tokens / steady,
           "padded_target_len": int(np.asarray(feeds[0]["nxt"].data)
                                    .shape[1]),
           "resident_gib": resident, "peak_mem_gib": peak,
           "peak_over_resident_gib": peak - resident, "executable": stats,
           "executable_hits": stats["hits"], "graph": step_graph(exe),
           "host_syncs_per_step": syncs,
           "lstm_launches": launches.pop(LSTM_COUNTER, 0),
           "other_kernel_launches": sum(launches.values())}
    rec["lstm_launches_per_step"] = rec["lstm_launches"] / steps
    del exe, staged
    return rec, scope


def nmt_train_failures(path, rec, lstm_per_step):
    """``steps - 1`` hits, one graph whose kernel nodes of this repo are
    ``lstm_per_step`` lstm_fwd nodes, that many launches a step, one
    host sync a replayed step, finite losses falling (the mean of the
    last 5 below the first 5; the last below the first on a run shorter
    than 10)."""
    out = graph_failures(path, rec, rec["steps"],
                         {"lstm_fwd": lstm_per_step})
    if rec["lstm_launches"] != lstm_per_step * rec["steps"] \
            or rec["other_kernel_launches"]:
        out.append(f"{path}: {rec['lstm_launches']} lstm_fwd launches in "
                   f"{rec['steps']} steps, want {lstm_per_step} a step, "
                   f"and {rec['other_kernel_launches']} of other kernels, "
                   f"want 0")
    if rec["host_syncs_per_step"] != 1:
        out.append(f"{path}: {rec['host_syncs_per_step']} host syncs a "
                   f"step, want 1 (the fetch)")
    ls = rec["losses"]
    k = 5 if len(ls) >= 10 else 1
    if not (all(math.isfinite(x) for x in ls)
            and sum(ls[-k:]) / k < sum(ls[:k]) / k):
        out.append(f"{path}: loss did not fall: {ls}")
    return out


@contextlib.contextmanager
def beam_steps_recorded(torch):
    """While active, each ``beam_search`` op records its inputs and
    outputs (device clones: no host read in the loop) -> the list of
    steps, as numpy after the block."""
    from paddle_tpu_torch.fluid.core.registry import get_op_info

    info = get_op_info("beam_search")
    real, steps = info.emit, []

    def emit(ctx, ins):
        outs = real(ctx, ins)
        steps.append({k: v[0].detach().clone() for k, v in
                      list(ins.items()) + list(outs.items())})
        return outs

    info.emit = emit
    try:
        yield steps
    finally:
        info.emit = real
        for s in steps:
            for k in s:
                s[k] = s[k].float().cpu().numpy() if s[k].is_floating_point() \
                    else s[k].cpu().numpy()


def decode_on(torch, np, fluid, prog, ids, scores, place, scope, src):
    """One decode of ``src`` with each step's beam_search recorded ->
    ((ids, scores, (step ids, step scores, step parents), index 0 the
    start), the recorded steps)."""
    exe = fluid.Executor(place)
    with beam_steps_recorded(torch) as steps:
        got_ids, got_sc = exe.run(prog, feed={"src": src},
                                  fetch_list=[ids, scores], scope=scope,
                                  mode="infer")
    first = steps[0]
    trace = ([first["pre_ids"]] + [s["selected_ids"] for s in steps],
             [first["pre_scores"]] + [s["selected_scores"] for s in steps],
             [np.zeros_like(first["pre_ids"])]
             + [s["parent_idx"] for s in steps])
    return (got_ids, got_sc, trace), steps


def decode_compare(torch, np, fluid, prog, ids, scores, card_scope, src, W):
    """The card's decode against the CPU port's from the card's weights,
    step by step (``compare_beams``: ids and parents equal, scores within
    1e-4 relative, the same backtrace; a difference at a step whose
    margin, the CPU run's, lies within the float error is a near tie,
    printed, and ends the comparison).  A step's float error is the
    largest difference of the two runs' top-k log-probabilities over the
    steps whose inputs agree, held to NMT_LOGPROB_ATOL.  -> record."""
    names = [n for n, v in prog.global_block().vars.items()
             if v.persistable and card_scope.find_var(n) is not None]
    cpu_scope = fluid.scope_from_numpy(
        fluid.scope_to_numpy(card_scope, names), fluid.CPUPlace())
    card, card_steps = decode_on(torch, np, fluid, prog, ids, scores,
                                 fluid.CUDAPlace(0), card_scope, src)
    cpu, cpu_steps = decode_on(torch, np, fluid, prog, ids, scores,
                               fluid.CPUPlace(), cpu_scope, src)
    err = 0.0
    for a, b in zip(card_steps, cpu_steps):
        err = max(err, float(np.abs(
            np.log(np.clip(a["scores"], 1e-12, None))
            - np.log(np.clip(b["scores"], 1e-12, None))).max()))
        if not (np.array_equal(a["selected_ids"], b["selected_ids"])
                and np.array_equal(a["parent_idx"], b["parent_idx"])):
            break                   # the next step's inputs differ
    margins = [beam_margin(np, s["pre_ids"], s["pre_scores"], s["scores"],
                           W, NMT_END) for s in cpu_steps]
    # compare_beams takes a logit error, twice which bounds a step's
    # log-probability error: the measured one, halved
    rec = compare_beams(np, card, cpu, margins, "float32", err / 2)
    rec.update(logprob_err=err, iterations=len(card_steps),
               cpu_iterations=len(cpu_steps))
    rec["ok"] = (rec["ok"] and err <= NMT_LOGPROB_ATOL
                 and len(card_steps) == len(cpu_steps))
    return rec


def profiled_call(torch, fn):
    """One call of ``fn`` under torch.profiler, inside a named range ->
    {the host's synchronize calls inside it, its wall ms, the device's
    busy ms and idle share over it (``device_busy``), the kernels run
    and the five that took longest in all}."""
    from torch.profiler import ProfilerActivity, profile

    name = "chip_smoke/call"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels, busy, idle = device_busy(events, wall)
    short = defaultdict(float)          # names cut to 80 characters
    for k, (us, _) in kernels.items():
        short[k[:80]] += us / 1e3
    return {"host_syncs": host_syncs_in(events, name), "wall_ms": wall,
            "device_busy_ms": busy, "device_idle_share": idle,
            "kernels": sum(n for _, n in kernels.values()),
            "top_kernels_ms": dict(sorted(short.items(),
                                          key=lambda kv: -kv[1])[:5])}


def decode_timing(torch, fluid, prog, ids, scores, scope, src, runs):
    """``runs`` + 1 decodes of ``src`` on the card through one executor
    (the first a miss, run eagerly as every call of a host-driven loop
    is; the others hits), every kernel's launch count set to 0 just
    before and read just after, the loops' iterations and condition
    reads counted, then one more profiled for its host syncs, the
    device's busy time and idle share (both over that profiled call)
    and kernels.  -> record."""
    from paddle_tpu_torch.fluid.ops.control_flow_ops import HOST_LOOP
    from paddle_tpu_torch.kernels import launch_counts

    exe = fluid.Executor(fluid.CUDAPlace(0))
    staged = device_feed(torch, {"src": src}, torch.device("cuda", 0))

    def run():
        return exe.run(prog, feed=staged, fetch_list=[ids, scores],
                       scope=scope, mode="infer")

    torch.cuda.synchronize()
    zero_launch_counts()
    HOST_LOOP.update(iterations=0, reads=0)
    times = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        run()                   # numpy fetches: the decode is done
        times.append(time.perf_counter() - t0)
    launches = named_launches(launch_counts())
    loops = dict(HOST_LOOP)
    stats = exe.cache_stats()["executable"]
    prof = profiled_call(torch, run)
    syncs = prof["host_syncs"]
    iters = loops["iterations"] / (runs + 1)
    return {"sources": int(staged["src"].lengths.shape[0]),
            "first_ms": times[0] * 1e3,
            "ms_per_batch": statistics.median(times[1:]) * 1e3,
            "ms_runs": [t * 1e3 for t in times[1:]],
            "profiled": prof, "device_idle_share": prof["device_idle_share"],
            "iterations_per_decode": iters,
            "condition_reads_per_decode": loops["reads"] / (runs + 1),
            "host_syncs_per_decode": syncs,
            "host_syncs_per_iteration": syncs / iters if iters else None,
            "executable": stats, "graphs": len(exe.graphs()),
            "lstm_launches": launches[LSTM_COUNTER],
            "lstm_launches_per_decode": launches[LSTM_COUNTER] / (runs + 1),
            "other_kernel_launches": sum(launches.values())
            - launches[LSTM_COUNTER]}


def bounded_while_program(fluid, reduce):
    """A While with max_iters (WHILE_TAKEN iterations of WHILE_ITERS
    taken) whose body applies an fc and accumulates the ``reduce``
    ("mean" or "sum") of its output's squares, under SGD -> (main,
    startup, loss, fetch names)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data(name="x", shape=[WHILE_WIDTH], dtype="float32")
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = layers.fill_constant(shape=[1], dtype="int64",
                                 value=WHILE_TAKEN)
        i.stop_gradient = n.stop_gradient = True
        h = layers.fc(input=x, size=WHILE_WIDTH, act="tanh")
        acc = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = layers.less_than(x=i, y=n)
        loop = layers.While(cond=cond, max_iters=WHILE_ITERS)
        with loop.block():
            nh = layers.fc(input=h, size=WHILE_WIDTH, act="tanh",
                           param_attr=fluid.ParamAttr(name="while_fc.w"))
            layers.assign(nh, h)
            sq = layers.square(nh)
            layers.assign(layers.elementwise_add(
                x=acc, y=(layers.mean(sq) if reduce == "mean"
                          else layers.reduce_sum(sq))), acc)
            layers.increment(x=i, in_place=True)
            layers.less_than(x=i, y=n, cond=cond)
        loss = layers.mean(acc)
        fluid.optimizer.SGD(learning_rate=WHILE_LR).minimize(loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, loss, [loss.name] + [p + "@GRAD" for p in params]


def eager_step(torch, np, main, fetch, state, feed, device, dtype):
    """Step COMPARE_STEP of ``main`` run eagerly
    (``lowering.run_block_ops``) on ``device`` from the numpy ``state``,
    its floating values and ``feed`` in ``dtype`` -> the fetches, as
    float64 arrays.  (An accumulator the program fills in float32 stays
    float32: its gradient, an exact 1, is all that passes through it.)"""
    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor, step_seeds)

    plan = BlockPlan(main.desc.global_block(), list(feed), fetch,
                     program=main.desc)

    def put(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device, dtype if t.is_floating_point() else torch.int32)

    env = {n: put(state[n]) for n in plan.state_in}
    env.update({k: put(v) for k, v in feed.items()})
    seeds = step_seeds(plan, main.random_seed, COMPARE_STEP)
    with torch.no_grad():
        run_block_ops(plan, env, seeds, seed_tensor(seeds).to(device),
                      device, "train")
    return [env[n].double().cpu().numpy() for n in fetch]


def grad_gap(np, got, want):
    """The largest gradient error, each relative to its gradient's
    largest magnitude (the fetches after the loss)."""
    return max(_max_rel(np, a, b) for a, b in zip(got[1:], want[1:]))


def bounded_while_check(torch, np, fluid, reduce):
    """The bounded While on the card (``bounded_while_program``): step 3
    (a replay) against the eager step and the CPU port in float32, one
    graph, two hits; the same step eagerly in float64 from the card's
    state before it, on the card and on the CPU, and each float32 run's
    gradients against the CPU's float64 ones.  Held: the loss 1e-5
    relative, the float64 runs each gradient 1e-4 of its largest, and
    the float32 gradients card vs CPU at the same limit ("mean"), or no
    farther from float64 than WHILE_NOISE_RATIO times the CPU's ("sum":
    saturated, see WHILE_NOISE_RATIO).  -> (record, ok)."""
    main, startup, loss, fetch = bounded_while_program(fluid, reduce)
    init = initial_scope(fluid, startup)
    rng = np.random.RandomState(SEED)
    feed = {"x": rng.randn(WHILE_BATCH, WHILE_WIDTH).astype(np.float32)}
    r = captured_step(torch, fluid, main, fetch, init, lambda i: feed,
                      [(main, fetch)])
    card, cpu = r["card"], r["cpu"][0][0]
    card64, cpu64 = (eager_step(torch, np, main, fetch, r["before"], feed,
                                dev, torch.float64)
                     for dev in (torch.device("cuda", 0),
                                 torch.device("cpu")))
    rec = {"reduce": reduce, "loss_card": float(card[0]),
           "loss_cpu": float(cpu[0]),
           "loss_rel_err": abs(float(card[0]) - float(cpu[0]))
           / abs(float(cpu[0])),
           "grad_rel_err": grad_gap(np, card, cpu),
           "grad_rel_err_float64": grad_gap(np, card64, cpu64),
           "card_float32_vs_float64": grad_gap(np, card, cpu64),
           "cpu_float32_vs_float64": grad_gap(np, cpu, cpu64),
           "n_grads": len(fetch) - 1, "replay": replay_record(r)}
    f32_ok = (rec["grad_rel_err"] <= LSTM_GRAD_RTOL if reduce == "mean"
              else rec["card_float32_vs_float64"]
              <= WHILE_NOISE_RATIO * rec["cpu_float32_vs_float64"]
              + LSTM_GRAD_RTOL)
    ok = (rec["loss_rel_err"] <= LSTM_LOSS_RTOL and f32_ok
          and rec["grad_rel_err_float64"] <= LSTM_GRAD_RTOL
          and r["hits"] == COMPARE_STEP - 1
          and replay_ok(r, set(init), loss.name, LSTM_LOSS_RTOL,
                        LSTM_GRAD_RTOL, 2 * WHILE_LR + 1e-6))
    return rec, ok


def nmt_phase(torch, np, fluid, card):
    """Phase 18: the attention seq2seq at bench_nmt_quality's width
    (step 3 card vs CPU and vs eager at NMT_COMPARE_BATCH rows, NMT_STEPS
    steps at NMT_BATCH, the beam decode of NMT_BATCH sources on the
    trained weights against the CPU port, timed), the book's
    ``train_model`` / ``decode_model`` and ``seq_to_seq_net`` at the
    chapter's widths, and a bounded While differentiated on the card.
    -> (the ``nmt`` record, lstm_fwd launches of the training runs and
    the timed decodes, failures)."""
    t0 = time.perf_counter()
    fails, launches = [], 0
    rec = {"card": card, "config": {
        "dict": NMT_DICT, "word_dim": NMT_WORD, "hidden_dim": NMT_HIDDEN,
        "lr": NMT_LR, "batch": NMT_BATCH, "beam": NMT_BEAM,
        "max_length": NMT_MAX_LEN, "topk": NMT_TOPK}}

    # -- the attention seq2seq: step 3, then NMT_STEPS steps
    main, startup, loss, (dec, ids, scores) = build_nmt(
        fluid, "attention_train_model", NMT_DICT, NMT_WORD, NMT_HIDDEN,
        NMT_LR, NMT_BEAM, NMT_MAX_LEN)
    init = initial_scope(fluid, startup)
    rng = np.random.RandomState(SEED + 18)
    feeds = [nmt_batch(np, fluid, rng, NMT_BATCH, NMT_DICT)
             for _ in range(NMT_BATCHES)]
    small = nmt_batch(np, fluid, np.random.RandomState(SEED + 19),
                      NMT_COMPARE_BATCH, NMT_DICT)
    params = [p.name for p in main.global_block().all_parameters()]
    step = compare_step(torch, np, fluid, main, loss, init, small, params,
                        NMT_LR)
    log(f"nmt attention step {COMPARE_STEP} card vs CPU and replay vs "
        f"eager: {json.dumps(step)}")
    if not nmt_step_ok(step, NMT_LR):
        fails.append(f"nmt attention step {COMPARE_STEP}: {step}")
    train, scope = train_nmt(torch, np, fluid, main, loss, init, feeds,
                             NMT_STEPS)
    train["compare"] = step
    fails += nmt_train_failures("nmt attention", train, 1)
    launches += train["lstm_launches"]
    rec["attention_train"] = train
    log(f"nmt attention training: {json.dumps(train)}")

    # -- the beam decode in a While on the trained weights
    src = nmt_batch(np, fluid, np.random.RandomState(SEED + 20), NMT_BATCH,
                    NMT_DICT)["src"]
    timing = decode_timing(torch, fluid, dec, ids, scores, scope, src,
                           NMT_DECODE_RUNS)
    rec["attention_decode"] = timing
    launches += timing["lstm_launches"]
    log(f"nmt attention decode: {json.dumps(timing)}")
    runs = NMT_DECODE_RUNS + 1
    if timing["executable"]["misses"] != 1 \
            or timing["executable"]["hits"] != runs - 1 \
            or timing["graphs"] != 0 \
            or timing["lstm_launches"] != runs \
            or timing["other_kernel_launches"] \
            or timing["iterations_per_decode"] != NMT_MAX_LEN \
            or timing["condition_reads_per_decode"] != NMT_MAX_LEN + 1 \
            or timing["host_syncs_per_decode"] != NMT_MAX_LEN + 2:
        fails.append(f"nmt attention decode: {timing}; want one miss, a "
                     f"hit a later call, no graph, one lstm_fwd launch, "
                     f"{NMT_MAX_LEN} iterations and {NMT_MAX_LEN + 2} host "
                     f"syncs a decode (a condition read an iteration, one "
                     f"to stop, the fetch)")
    cmp_ = decode_compare(torch, np, fluid, dec, ids, scores, scope, src,
                          NMT_BEAM)
    rec["attention_decode_vs_cpu"] = cmp_
    log(f"nmt attention decode card vs CPU "
        f"{'ok  ' if cmp_['ok'] else 'FAIL'}: {json.dumps(cmp_)}")
    if not cmp_["ok"]:
        fails.append(f"nmt attention decode card vs CPU: {cmp_}")
    del scope, init, feeds
    torch.cuda.empty_cache()

    # -- the book's other two models at the chapter's widths
    for model, n_lstm in (("train_model", 1), ("seq_to_seq_net", 2)):
        main, startup, loss, decode = build_nmt(
            fluid, model, BOOK_NMT_DICT, 16, 32, NMT_LR,
            BOOK_NMT_BEAM if model == "train_model" else None,
            BOOK_NMT_MAX_LEN)
        init = initial_scope(fluid, startup)
        rng = np.random.RandomState(SEED + 21)
        feed = nmt_batch(np, fluid, rng, BOOK_NMT_BATCH, BOOK_NMT_DICT,
                         rng.randint(*BOOK_NMT_LEN, BOOK_NMT_BATCH))
        small = {k: fluid.make_seq(
            [v.data[i, :v.lengths[i]] for i in range(NMT_COMPARE_BATCH)],
            dtype=np.int64, bucket=NMT_BUCKET) for k, v in feed.items()}
        params = [p.name for p in main.global_block().all_parameters()]
        step = compare_step(torch, np, fluid, main, loss, init, small,
                            params, NMT_LR)
        if not nmt_step_ok(step, NMT_LR):
            fails.append(f"nmt {model} step {COMPARE_STEP}: {step}")
        run, scope = train_nmt(torch, np, fluid, main, loss, init, [feed],
                               BOOK_NMT_STEPS)
        run["compare"] = step
        fails += nmt_train_failures(f"nmt {model}", run, n_lstm)
        launches += run["lstm_launches"]
        if decode is not None:
            run["decode_vs_cpu"] = decode_compare(
                torch, np, fluid, *decode, scope, feed["src"],
                BOOK_NMT_BEAM)
            if not run["decode_vs_cpu"]["ok"]:
                fails.append(f"nmt decode_model card vs CPU: "
                             f"{run['decode_vs_cpu']}")
        rec[model] = run
        log(f"nmt {model}: {json.dumps(run)}")
        del scope
        torch.cuda.empty_cache()

    # -- a bounded While, differentiated on the card
    rec["bounded_while"] = {}
    for reduce in ("mean", "sum"):
        got, ok = bounded_while_check(torch, np, fluid, reduce)
        rec["bounded_while"][reduce] = got
        log(f"nmt bounded While ({reduce}) {'ok  ' if ok else 'FAIL'}: "
            f"{json.dumps(got)}")
        if not ok:
            fails.append(f"bounded While ({reduce}) on the card: {got}")
    rec["seconds"] = time.perf_counter() - t0
    return rec, launches, fails


# -- phase 19: semantic role labeling and the evaluators ---------------------

# the book's chapter 7 (fluid/tests/book/test_label_semantic_roles.py):
# srl_model(SRLDims()) at full width, CoNLL-05's dictionaries (44068
# words, 106 labels, 3162 predicates, 2 marks), word 32, mark 5, hidden
# 512, depth 8: 8 dynamic_lstms of H = 128 in alternating directions,
# relu candidate, sigmoid gate and cell, peepholes; the predicate and
# mark tables sparse, the word table frozen, the CRF transitions at
# mix_hidden_lr 1e-3; SGD at 2e-3: the chapter's 0.01 diverges on
# these sentences at batch 128 (this phase with SRL_LR = 0.01: NaN by
# step 7 on an H100); then
# ChunkEvaluator(crf_decode, target, "IOB", 53) and ModelAverage.  The
# repo holds no CoNLL-05 corpus, so the data are seeded sentences of
# SRL_LEN words in the corpus reader's layout (one predicate a sentence,
# its five context words and the predicate repeated along it, mark 1
# within two words of it), padded to SRL_PAD (one signature), the tags
# derived from the word ids as tests/test_book.py derives them;
# SRL_BATCHES batches staged on the card and taken in turn
SRL_BATCH, SRL_PAD, SRL_LEN, SRL_LR = 128, 64, (5, 60), 2e-3
SRL_STEPS, SRL_BATCHES, SRL_COMPARE_BATCH = 20, 4, 4
SRL_CHUNK_TYPES = 53
SRL_H, SRL_ACTS = 128, ("sigmoid", "sigmoid", "relu")
SRL_DEPTH = 8
SRL_CTX = ("ctx_n2_data", "ctx_n1_data", "ctx_0_data", "ctx_p1_data",
           "ctx_p2_data")
# ModelAverage's windows: rate 0.15, min 4, max 8.  The window
# min(8, int(0.15 n)) stays below 4 until update 27, so the partial sum
# moves to sum_3 and the count restarts at updates 4, 8, 12, 16 and 20:
# five shifts in SRL_STEPS steps
SRL_AVG = dict(average_window_rate=0.15, min_average_window=4,
               max_average_window=8)
# the new ops on the card against the CPU port: float32 on both sides,
# summation order only; linear_chain_crf's loss and gradients at the
# LSTM paths' limits (a 64-step logsumexp recursion)
SRL_OP_RTOL = 1e-5


def build_srl(fluid):
    """srl_model(SRLDims()) with SGD, then its ChunkEvaluator and its
    ModelAverage -> (main, startup, loss, feature_out, crf_decode,
    evaluator, model average)."""
    from paddle_tpu_torch.models.label_semantic_roles import (SRLDims,
                                                              srl_model)

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, feature_out, crf_decode, target, _ = srl_model(SRLDims())
        fluid.optimizer.SGD(learning_rate=SRL_LR).minimize(loss)
        ev = fluid.evaluator.ChunkEvaluator(crf_decode, target, "IOB",
                                            SRL_CHUNK_TYPES)
        ma = fluid.optimizer.ModelAverage(**SRL_AVG)
    return main, startup, loss, feature_out, crf_decode, ev, ma


def srl_batch(np, fluid, rng, batch):
    """``batch`` seeded sentences in the CoNLL-05 reader's layout, padded
    to SRL_PAD; the tag of a word is its id mod the label count."""
    from paddle_tpu_torch.models.label_semantic_roles import SRLDims

    dims = SRLDims()
    cols = defaultdict(list)
    for n in rng.randint(SRL_LEN[0], SRL_LEN[1] + 1, batch):
        w = rng.randint(0, dims.word_dict_len, n)
        at = rng.randint(n)                         # the predicate's place
        cols["word_data"].append(w)
        for name, d in zip(SRL_CTX, (-2, -1, 0, 1, 2)):
            cols[name].append(np.full(n, w[min(max(at + d, 0), n - 1)]))
        cols["verb_data"].append(np.full(n, rng.randint(dims.pred_len)))
        cols["mark_data"].append((np.abs(np.arange(n) - at) <= 2)
                                 .astype(np.int64))
        cols["target"].append(w % dims.label_dict_len)
    return {k: fluid.make_seq(v, dtype=np.int64, max_len=SRL_PAD)
            for k, v in cols.items()}


def chunk_counts(np, path, target, lengths):
    """(inferred, label, correct) IOB chunks of tag rows, counted on the
    host by the reference's rule (``crf_ops.chunk_eval``): tag 2t opens
    a chunk of type t, 2t + 1 continues one, and also opens one where
    the previous step's type differs or there is none; a label chunk is
    correct where every step of it agrees with the inference in chunk
    starts and types."""
    ni = nl = nc = 0
    for p, t, n in zip(path, target, lengths):
        p, t = np.asarray(p).reshape(-1)[:n], np.asarray(t).reshape(-1)[:n]

        def starts(tags):
            typ = tags // 2
            s = tags % 2 == 0
            s[1:] |= typ[1:] != typ[:-1]
            s[:1] = True
            return s, typ

        (ps, pt), (ls, lt) = starts(p), starts(t)
        ni, nl = ni + int(ps.sum()), nl + int(ls.sum())
        agree = (ps == ls) & (pt == lt)
        ends = list(np.flatnonzero(ls)) + [n]
        nc += sum(bool(agree[a:b].all()) for a, b in zip(ends, ends[1:]))
    return ni, nl, nc


def average_rule(np, snaps, rate, min_win, max_win):
    """ModelAverage's average after the steps whose parameters ``snaps``
    holds ({name: array} after each update, in order), by the
    reference's rule (``average_accumulates``, then the apply program)
    in float64 -> ({name: average}, {name: per-element limit}).  The
    card sums in float32: the average of cnt terms through the running
    sums, their sum and a division rounds at most cnt + 3 times, each by
    at most 2^-24 of the largest term, so an element is held within
    (cnt + 3) 2^-24 max_j |p_j| of the float64 value."""
    last, partial, n_acc, old = [], [], 0, 0
    for n_upd, snap in enumerate(snaps, 1):
        n_acc += 1
        partial.append(snap)
        window = min(max_win, int(np.float32(n_upd) * np.float32(rate)))
        if n_acc >= min_win and n_acc >= window:
            last, partial, old, n_acc = partial, [], n_acc, 0
    terms = last + partial
    cnt = n_acc + old
    avg = {n: sum(s[n].astype(np.float64) for s in terms) / max(cnt, 1)
           for n in snaps[0]}
    lim = {n: (cnt + 3) * 2.0 ** -24 * np.max([np.abs(s[n]) for s in terms],
                                              axis=0)
           for n in snaps[0]}
    return avg, lim, cnt


def _op_value(torch, spec, device, grad):
    """An op input on ``device`` from its spec (("t", array), ("seq",
    array, lengths), ("list", [arrays])) -> (value for the slot, the
    float leaves that take a gradient)."""
    from paddle_tpu_torch.fluid.core.lod import SeqArray

    arrays = spec[1] if spec[0] == "list" else [spec[1]]
    ts = [torch.tensor(a, device=device) for a in arrays]
    leaves = [t.requires_grad_(True) for t in ts
              if grad and t.is_floating_point()]
    if spec[0] == "seq":
        ts = [SeqArray(ts[0], torch.tensor(spec[2], device=device))]
    return ts, leaves


def run_op(torch, np, op, specs, attrs, wrt, device, seed=None):
    """One emitter call on ``device`` with the gradient of
    sum(out * w) over its float outputs for the slots ``wrt`` -> (the
    outputs' tensors on the CPU, the gradients on the CPU)."""
    from paddle_tpu_torch.fluid.core import registry as reg
    from paddle_tpu_torch.fluid.core.desc import OpDesc

    ins, leaves = {}, []
    for slot, spec in specs.items():
        ins[slot], ls = _op_value(torch, spec, device, slot in wrt)
        leaves += ls
    desc = OpDesc(op, {s: [f"{s}{i}" for i in range(len(v))]
                       for s, v in ins.items()}, {}, attrs)
    ctx = reg.EmitCtx(desc, seed=seed, device=device)
    with torch.enable_grad():
        res = reg.get_op_info(op).emit(ctx, ins)
    vals = [v for slot in sorted(res) for v in res[slot]]
    seqs = [v for v in vals if hasattr(v, "lengths")]
    outs = [v.data if hasattr(v, "lengths") else v for v in vals] + \
        [v.lengths for v in seqs]
    grads = []
    if wrt:
        rng = np.random.RandomState(7)
        live = [o for o in outs if o.requires_grad]
        total = sum((o * torch.tensor(np.asarray(rng.randn(*o.shape),
                                              np.float32),
                                   device=device)).sum() for o in live)
        grads = torch.autograd.grad(total, leaves)
    return [o.detach().cpu() for o in outs], [g.cpu() for g in grads]


def srl_op_cases(np):
    """name -> (op, specs, attrs, wrt, exact: outputs bitwise, repeat:
    the card's gradients run twice bitwise) at the SRL path's sizes: its
    CRF over SRL_BATCH x SRL_PAD emissions of 106 tags, repeated indices
    for gather / scatter, ids out of range for one_hot, ties for the
    max / min reductions, zeros for reduce_prod."""
    rng = np.random.RandomState(SEED + 19)
    b, t, k = SRL_BATCH, SRL_PAD, 106
    lens = rng.randint(SRL_LEN[0], SRL_LEN[1] + 1, b).astype(np.int32)
    emis = rng.randn(b, t, k).astype(np.float32)
    trans = (rng.randn(k + 2, k) * 0.1).astype(np.float32)
    lbl = rng.randint(0, k, (b, t, 1)).astype(np.int32)
    inf = np.where(rng.rand(b, t, 1) < 0.7, lbl,
                   rng.randint(0, k, (b, t, 1))).astype(np.int32)
    ties = rng.randint(0, 3, (512, 64)).astype(np.float32)
    zeros = rng.uniform(0.5, 1.5, (256, 16)).astype(np.float32)
    zeros[::7, 3] = 0.0
    zeros[::11, 5] = 0.0
    table = rng.randn(4096, 64).astype(np.float32)
    ids = (rng.zipf(CTR_ZIPF, 8192) % 4096).astype(np.int32)
    shape = [4096, 64]
    acc = {f"InSum{i}": ("t", rng.randn(*shape).astype(np.float32))
           for i in (1, 2, 3)}
    acc.update(Param=("t", table),
               InNumAccumulates=("t", np.array([3], np.int32)),
               InOldNumAccumulates=("t", np.array([4], np.int32)),
               InNumUpdates=("t", np.array([16383], np.int32)))
    seq = ("seq", emis, lens)
    return {
        "linear_chain_crf": ("linear_chain_crf", {
            "Emission": seq, "Transition": ("t", trans),
            "Label": ("seq", lbl, lens)}, {}, ("Emission", "Transition"),
            False, True),
        "crf_decoding": ("crf_decoding", {
            "Emission": seq, "Transition": ("t", trans)}, {}, (), True,
            False),
        "crf_decoding/label": ("crf_decoding", {
            "Emission": seq, "Transition": ("t", trans),
            "Label": ("seq", lbl, lens)}, {}, (), True, False),
        "chunk_eval": ("chunk_eval", {
            "Inference": ("seq", inf, lens), "Label": ("seq", lbl, lens)},
            {"chunk_scheme": "IOB", "num_chunk_types": SRL_CHUNK_TYPES},
            (), True, False),
        "average_accumulates": ("average_accumulates", acc,
                                {"average_window": 0.15,
                                 "min_average_window": 4,
                                 "max_average_window": 8}, (), True, False),
        "gather": ("gather", {"X": ("t", table), "Index": ("t", ids)}, {},
                   ("X",), True, True),
        "scatter/add": ("scatter", {
            "X": ("t", table), "Ids": ("t", ids),
            "Updates": ("t", rng.randn(8192, 64).astype(np.float32))},
            {"overwrite": False}, ("X", "Updates"), False, True),
        "scatter/overwrite": ("scatter", {
            "X": ("t", table),
            "Ids": ("t", rng.permutation(4096)[:1000].astype(np.int32)),
            "Updates": ("t", rng.randn(1000, 64).astype(np.float32))},
            {}, ("X", "Updates"), True, False),
        "slice": ("slice", {"X": ("t", emis)},
                  {"axes": [1, 2], "starts": [3, -50], "ends": [-2, 1000]},
                  ("X",), True, False),
        "split": ("split", {"X": ("t", emis)},
                  {"sections": [6, 50, 50], "axis": 2}, ("X",), True, False),
        "one_hot": ("one_hot", {"X": ("t", (ids[:, None] % 5000 - 400)
                                      .astype(np.int32))},
                    {"depth": 4096}, (), True, False),
        "shape": ("shape", {"X": seq}, {}, (), True, False),
        "multiplex": ("multiplex", {
            "Ids": ("t", rng.randint(0, 3, (512, 1)).astype(np.int32)),
            "X": ("list", [ties, ties * 2, -ties])}, {}, ("X",), True,
            False),
        "reduce_mean": ("reduce_mean", {"X": ("t", emis)},
                        {"dim": [0, 2]}, ("X",), False, False),
        "reduce_mean/seq": ("reduce_mean", {"X": seq}, {"dim": [2]},
                            ("X",), False, False),
        "reduce_max": ("reduce_max", {"X": ("t", ties)}, {"dim": [1]},
                       ("X",), True, False),
        "reduce_min": ("reduce_min", {"X": ("t", ties)},
                       {"dim": [0], "keep_dim": True}, ("X",), True, False),
        "reduce_prod": ("reduce_prod", {"X": ("t", zeros)}, {"dim": [1]},
                        ("X",), False, False),
    }


def srl_op_checks(torch, np, failures):
    """The slice's 16 new ops on the card against the CPU port at the
    SRL path's sizes (``srl_op_cases``): outputs and gradients within
    SRL_OP_RTOL of their largest (bitwise where ``exact``), the CRF's
    loss and gradients at the LSTM paths' limits, the gradients of
    ``linear_chain_crf``, ``gather`` and adding ``scatter`` run twice on
    the card bitwise equal (no atomics); ``truncated_gaussian_random``
    bitwise the CPU's draw (a host draw), inside two standard
    deviations, its mean and standard deviation within 5 standard errors
    of the truncated normal's.  -> {case: record}."""
    dev = torch.device("cuda", 0)
    out = {}
    for name, (op, specs, attrs, wrt, exact, repeat) in \
            srl_op_cases(np).items():
        got, g_got = run_op(torch, np, op, specs, attrs, wrt, dev)
        want, g_want = run_op(torch, np, op, specs, attrs, wrt,
                              torch.device("cpu"))
        rec = {"outputs": len(got), "grads": len(g_got)}
        errs = op_rel_errs(torch, got + g_got, want + g_want)
        n_out = len(got)
        rec["out_err"] = max(errs[:n_out]) if n_out else 0.0
        rec["grad_err"] = max(errs[n_out:]) if len(errs) > n_out else 0.0
        rec["bitwise"] = all(torch.equal(a, b) for a, b in zip(got, want))
        if op == "linear_chain_crf":
            ok = (rec["out_err"] <= LSTM_LOSS_RTOL
                  and rec["grad_err"] <= LSTM_GRAD_RTOL)
        else:
            ok = (rec["bitwise"] if exact else
                  rec["out_err"] <= SRL_OP_RTOL) \
                and rec["grad_err"] <= SRL_OP_RTOL
        if repeat:
            _, g2 = run_op(torch, np, op, specs, attrs, wrt, dev)
            rec["grads_repeat_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(g_got, g2))
            ok = ok and rec["grads_repeat_bitwise"]
        rec["ok"] = ok
        out[name] = rec
        if not ok:
            failures.append(f"srl op {name}: card vs CPU {rec}")
    attrs = {"shape": [1000, 1000], "dtype": "float32", "mean": 0.5,
             "std": 0.02}
    draws = [run_op(torch, np, "truncated_gaussian_random", {}, attrs, (),
                    d, seed=SEED)[0][0]
             for d in (dev, torch.device("cpu"))]
    x = draws[0].double()
    trunc_std = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                          / math.erf(2 / math.sqrt(2)))
    se = 0.02 * trunc_std / math.sqrt(x.numel())
    rec = {"bitwise_cpu": torch.equal(draws[0], draws[1]),
           "min": float(x.min()), "max": float(x.max()),
           "mean": float(x.mean()), "std": float(x.std()),
           "want_std": 0.02 * trunc_std}
    rec["ok"] = (rec["bitwise_cpu"] and rec["min"] >= 0.46 - 1e-6
                 and rec["max"] <= 0.54 + 1e-6
                 and abs(rec["mean"] - 0.5) <= 5 * se
                 and abs(rec["std"] / rec["want_std"] - 1) <= 0.01)
    out["truncated_gaussian_random"] = rec
    if not rec["ok"]:
        failures.append(f"srl op truncated_gaussian_random: {rec}")
    return out


def srl_cell_timing(torch, lk, dev, gen, lengths):
    """The SRL path's LSTM call (B = SRL_BATCH, T = SRL_PAD, H = SRL_H,
    peepholes, SRL_ACTS, the sentences' ``lengths``): the kernel (twice,
    around the plain loop) and the plain loop on the device clock, and
    the bound for the steps inside the lengths.  No library call
    computes this cell: cuDNN's LSTM fixes tanh for the candidate and
    the cell."""
    cfg = dict(peep=True, reverse=False, init=False, ragged=False,
               acts=SRL_ACTS)
    (x, w, b, _, _, _), kw = lstm_inputs(torch, gen, dev, SRL_BATCH,
                                         SRL_PAD, SRL_H, cfg)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    with torch.no_grad():
        k1 = cuda_ms(torch, lambda: lk.lstm_forward(x, w, b, lens, **kw), 20)
        plain = cuda_ms(torch, lambda: lk.lstm_forward_plain(
            x, w, b, lens, **kw), 3)
        k2 = cuda_ms(torch, lambda: lk.lstm_forward(x, w, b, lens, **kw), 20)
    live = int(sum(lengths))
    b_ms, b_by = lstm_bound(SRL_BATCH, SRL_PAD, SRL_H, live=live)
    return {"B": SRL_BATCH, "T": SRL_PAD, "H": SRL_H, "acts": SRL_ACTS,
            "live_steps": live, "ms": min(k1, k2), "ms_runs": [k1, k2],
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_fp32_ms": lstm_bound(SRL_BATCH, SRL_PAD, SRL_H, 1,
                                        FP32_FLOPS_PER_S, live)[0],
            "library_ms": None,
            "library": "none: cuDNN's LSTM fixes tanh",
            "plan": lk.device_plan(SRL_BATCH, SRL_H, dev)}


def srl_compare(torch, np, fluid, main, loss, feature_out, crf_decode,
                init, small, sparse):
    """Step 3 at SRL_COMPARE_BATCH sentences (``captured_step``): the
    replay against the eager step, the card against the CPU port from
    the card's state before it (the loss, every dense gradient, the
    sparse tables' updates), and ``crf_decoding`` and ``chunk_eval`` run
    on both devices on the card's emissions and transitions: paths and
    counts equal, and the card's program path equal to its op's."""
    params = [p.name for p in main.global_block().all_parameters()
              if p.trainable and p.name not in sparse]
    fetch = [loss.name, feature_out.name, crf_decode.name] + \
        [n + "@GRAD" for n in params]
    r = captured_step(torch, fluid, main, fetch, init, lambda i: small,
                      [(main, fetch)])
    card = r["card"]
    cpu = [np.asarray(v.data if hasattr(v, "lengths") else v)
           for v in r["cpu"][0][0]]
    before, after, cpu_after = r["before"], r["after"], r["cpu"][0][1]
    rec = {"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
           "loss_rel_err": abs(float(card[0]) - float(cpu[0]))
           / abs(float(cpu[0])),
           "grad_rel_err": max(float(np.abs(a - b).max())
                               / max(float(np.abs(b).max()), 1e-30)
                               for a, b in zip(card[3:], cpu[3:])),
           "n_dense_grads": len(params), "replay": replay_record(r),
           "replay_ok": replay_ok(r, set(before), loss.name,
                                  LSTM_LOSS_RTOL, LSTM_GRAD_RTOL,
                                  2 * SRL_LR + 1e-6)}
    rec["sparse_update_rel_err"] = max(
        float(np.abs((after[n] - before[n]) - (cpu_after[n] - before[n]))
              .max()) / max(float(np.abs(cpu_after[n] - before[n]).max()),
                            1e-30) for n in sparse)
    # Viterbi and the chunk counts on the card's emissions, both devices
    lens = np.asarray(small["word_data"].lengths)
    specs = {"Emission": ("seq", card[1], lens),
             "Transition": ("t", before["crfw"])}
    devices = (torch.device("cuda", 0), torch.device("cpu"))
    paths = [run_op(torch, np, "crf_decoding", specs, {}, (), d)[0][0]
             for d in devices]
    lbl = np.asarray(small["target"].data).astype(np.int32)
    # chunk_eval's outputs by slot name: F1-Score, NumCorrectChunks,
    # NumInferChunks, NumLabelChunks, Precision, Recall
    counts = [run_op(torch, np, "chunk_eval", {
        "Inference": ("seq", p.numpy(), lens), "Label": ("seq", lbl, lens)},
        {}, (), d)[0] for p, d in zip(paths, devices)]
    rec["decode_equal"] = torch.equal(paths[0], paths[1])
    rec["program_path_equal"] = bool(np.array_equal(
        card[2].astype(np.int32), paths[0].numpy()))
    rec["chunk_counts"] = dict(zip(("correct", "inferred", "label"),
                                   (float(c) for c in counts[0][1:4])))
    rec["chunk_counts_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(*counts))
    rec["ok"] = (rec["replay"]["bitwise"]
                 and rec["loss_rel_err"] <= LSTM_LOSS_RTOL
                 and rec["grad_rel_err"] <= LSTM_GRAD_RTOL
                 and rec["sparse_update_rel_err"] <= LSTM_GRAD_RTOL
                 and rec["decode_equal"] and rec["program_path_equal"]
                 and rec["chunk_counts_equal"])
    return rec


def srl_phase(torch, np, fluid, lk, card):
    """Phase 19: the slice's ops on the card against the CPU, the SRL
    cell's timing, then the book's label_semantic_roles at full width
    through ``fluid.Executor``: step 3 against eager and the CPU, 20
    steps on SRL_BATCHES batches (the compiled step, the frozen and the
    unfed rows, the loss), the ChunkEvaluator against a recount,
    ModelAverage's apply against its rule and restore bitwise, a step
    after them bitwise the same step without, ``reset`` counting from
    zero, then the host syncs, the device's time and its busy and idle
    share.  -> (the ``srl`` record, lstm_fwd launches of the training
    run, the SRL cell's timing row, failures)."""
    from paddle_tpu_torch.kernels import launch_counts

    t0 = time.perf_counter()
    fails = []
    rec = {"card": card, "config": {
        "dims": "SRLDims()", "depth": SRL_DEPTH, "lstm_H": SRL_H,
        "batch": SRL_BATCH, "padded_len": SRL_PAD, "lengths": SRL_LEN,
        "sgd_lr": SRL_LR, "chunk_types": SRL_CHUNK_TYPES,
        "model_average": SRL_AVG}}
    rec["ops"] = srl_op_checks(torch, np, fails)
    log(f"srl ops card vs CPU: {json.dumps(rec['ops'])}")

    main, startup, loss, feature_out, crf_decode, ev, ma = build_srl(fluid)
    init = initial_scope(fluid, startup)
    rng = np.random.RandomState(SEED + 19)
    feeds = [srl_batch(np, fluid, rng, SRL_BATCH)
             for _ in range(SRL_BATCHES)]
    small = srl_batch(np, fluid, np.random.RandomState(SEED + 20),
                      SRL_COMPARE_BATCH)
    sparse = sparse_tables(main)
    dev = torch.device("cuda", 0)
    gen = torch.Generator()
    gen.manual_seed(SEED + 19)
    rec["lstm_cell"] = srl_cell_timing(
        torch, lk, dev, gen, [int(n) for n in feeds[0]["target"].lengths])
    log(f"srl lstm cell: {json.dumps(rec['lstm_cell'])}")
    step = srl_compare(torch, np, fluid, main, loss, feature_out,
                       crf_decode, init, small, sparse)
    rec["compare"] = step
    log(f"srl step {COMPARE_STEP} card vs CPU and replay vs eager: "
        f"{json.dumps(step)}")
    if not step["ok"]:
        fails.append(f"srl step {COMPARE_STEP}: {step}")
    torch.cuda.empty_cache()

    # -- SRL_STEPS steps through the executor
    params = [p.name for p in ma._params]
    scope = fluid.scope_from_numpy(init, fluid.CUDAPlace(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    staged = [device_feed(torch, f, dev) for f in feeds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    # each step's parameters, copied to pinned host memory behind it on
    # the stream (no host sync): ModelAverage's rule is replayed on them
    snaps = [{n: torch.empty(init[n].shape, pin_memory=True)
              for n in params} for _ in range(SRL_STEPS)]
    fetch = [loss, crf_decode]
    zero_launch_counts()
    losses, times, paths = [], [], []
    for i in range(SRL_STEPS):
        t1 = time.perf_counter()
        lv, path = exe.run(main, feed=staged[i % SRL_BATCHES],
                           fetch_list=fetch, scope=scope)
        times.append(time.perf_counter() - t1)
        losses.append(float(lv))
        paths.append(np.asarray(path.data))
        for n, h in snaps[i].items():
            h.copy_(scope.find_var(n), non_blocking=True)
    launches = named_launches(launch_counts())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    snaps = [{n: t.numpy() for n, t in s.items()} for s in snaps]
    stats = exe.cache_stats()["executable"]
    steady = statistics.median(times[1:])
    tokens = statistics.mean(int(np.asarray(f["target"].lengths).sum())
                             for f in feeds)
    lstm_n = launches.pop(LSTM_COUNTER, 0)
    train = {"batch": SRL_BATCH, "steps": SRL_STEPS, "losses": losses,
             "first_step_ms": times[0] * 1e3,
             "step_ms_median": steady * 1e3,
             "target_tokens_per_batch": tokens,
             "target_tokens_per_s": tokens / steady,
             "resident_gib": resident, "peak_mem_gib": peak,
             "peak_over_resident_gib": peak - resident,
             "executable": stats, "executable_hits": stats["hits"],
             "graph": step_graph(exe), "lstm_launches": lstm_n,
             "lstm_launches_per_step": lstm_n / SRL_STEPS,
             "other_kernel_launches": sum(launches.values())}
    fails += graph_failures("srl", train, SRL_STEPS,
                            {"lstm_fwd": SRL_DEPTH})
    if lstm_n != SRL_DEPTH * SRL_STEPS or train["other_kernel_launches"]:
        fails.append(f"srl: {lstm_n} lstm_fwd launches in {SRL_STEPS} "
                     f"steps, want {SRL_DEPTH} a step, and "
                     f"{train['other_kernel_launches']} of other kernels")
    if not (all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5])):
        fails.append(f"srl: the loss did not fall: {losses}")

    # -- the frozen word table, and the sparse tables' unfed rows
    now = fluid.scope_to_numpy(scope, ["emb"] + sparse)
    state = {"emb_unchanged": bool(np.array_equal(now["emb"], init["emb"]))}
    ids_of = {op.input("W")[0]: op.input("Ids")[0]
              for op in main.global_block().ops
              if op.type == "lookup_table" and op.attr("is_sparse")}
    for n in sparse:
        # padding positions look up row 0 too
        fed = np.unique(np.concatenate(
            [np.asarray(f[ids_of[n]].data).reshape(-1) for f in feeds]))
        unfed = np.setdiff1d(np.arange(now[n].shape[0]), fed)
        state[n] = {"rows": int(now[n].shape[0]), "unfed": int(unfed.size),
                    "unfed_unchanged": bool(np.array_equal(
                        now[n][unfed], init[n][unfed])),
                    "fed_changed": int((now[n][fed] != init[n][fed])
                                       .any(axis=1).sum())}
    train["state"] = state
    if not state["emb_unchanged"] or not all(
            state[n]["unfed_unchanged"] for n in sparse) \
            or not any(state[n]["unfed"] for n in sparse):
        fails.append(f"srl: frozen or unfed rows changed: {state}")

    # -- the ChunkEvaluator against a host recount of the fetched paths
    want = np.zeros(3)
    for i, p in enumerate(paths):
        f = feeds[i % SRL_BATCHES]["target"]
        want += chunk_counts(np, p, f.data, f.lengths)
    names = [ev.num_infer.name, ev.num_label.name, ev.num_correct.name]
    got = [float(fluid.scope_to_numpy(scope, [n])[n].sum()) for n in names]
    train["chunk"] = {"counts": got, "recount": want.tolist(),
                      "eval": [float(v) for v in ev.eval(scope=scope)]}
    if got != want.tolist():
        fails.append(f"srl ChunkEvaluator: {got}, host recount "
                     f"{want.tolist()}")

    # -- ModelAverage: apply against the rule, restore bitwise, twice
    avg, lim, cnt = average_rule(np, snaps, SRL_AVG["average_window_rate"],
                                 SRL_AVG["min_average_window"],
                                 SRL_AVG["max_average_window"])
    snap = {n: v.clone() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor)}
    ptrs = {n: scope.find_var(n).data_ptr() for n in params}
    mrec = {"averaged_steps": cnt, "rounds": []}
    for _ in range(2):
        with fluid.scope_guard(scope):
            with ma.apply(exe, need_restore=False):
                applied = fluid.scope_to_numpy(scope, params)
            ma.restore(exe)
        back = fluid.scope_to_numpy(scope, params)
        excess = max(float((np.abs(applied[n] - avg[n]) / np.maximum(
            lim[n], 1e-30)).max()) for n in params)
        mrec["rounds"].append({
            "apply_excess": excess,
            "apply_max_abs_err": max(float(np.abs(applied[n] - avg[n])
                                           .max()) for n in params),
            "restore_bitwise": all(np.array_equal(back[n], snaps[-1][n])
                                   for n in params)})
    # a step after apply / restore, then the same step from the state
    # before them: bitwise equal
    k = SRL_STEPS % SRL_BATCHES
    l1, _ = exe.run(main, feed=staged[k], fetch_list=fetch, scope=scope)
    after1 = {n: scope.find_var(n).clone() for n in snap}
    mrec["restored_at_graph_addresses"] = all(
        scope.find_var(n).data_ptr() == p for n, p in ptrs.items())
    for n, v in snap.items():
        scope.set_var(n, v.clone())
    l2, _ = exe.run(main, feed=staged[k], fetch_list=fetch, scope=scope)
    mrec["step_after_restore_bitwise"] = bool(
        float(l1) == float(l2) and all(torch.equal(after1[n],
                                                   scope.find_var(n))
                                       for n in snap))
    train["model_average"] = mrec
    del snap, after1
    if not (all(r["apply_excess"] <= 1.0 and r["restore_bitwise"]
                for r in mrec["rounds"])
            and mrec["restored_at_graph_addresses"]
            and mrec["step_after_restore_bitwise"] and cnt > 0):
        fails.append(f"srl ModelAverage: {mrec}")

    # -- reset(): the next replay counts from zero
    ev.reset(scope=scope)
    f = feeds[(k + 1) % SRL_BATCHES]
    _, path = exe.run(main, feed=staged[(k + 1) % SRL_BATCHES],
                      fetch_list=fetch, scope=scope)
    got = [float(fluid.scope_to_numpy(scope, [n])[n].sum()) for n in names]
    want = list(chunk_counts(np, np.asarray(path.data), f["target"].data,
                             f["target"].lengths))
    train["chunk"]["after_reset"] = {"counts": got, "recount": want}
    if got != [float(x) for x in want]:
        fails.append(f"srl ChunkEvaluator after reset: {got}, host "
                     f"recount {want}")

    # -- the host's syncs a step, the device's time, busy and idle share
    train["host_syncs_per_step"] = host_syncs_per_step(torch, lambda: exe.run(
        main, feed=staged[0], fetch_list=fetch, scope=scope))
    if train["host_syncs_per_step"] != 1:
        fails.append(f"srl: {train['host_syncs_per_step']} host syncs a "
                     f"step, want 1 (the fetch)")
    # the training step's graph: the one used last (graphs() is least
    # recently used first)
    train["device_ms"] = (replay_ms(torch, exe, exe.graphs()[-1])
                          if exe.graphs() else None)
    prof = profiled_call(torch, lambda: exe.run(
        main, feed=staged[0], fetch_list=fetch, scope=scope))
    train["profiled_step"] = prof
    # three entries: the training step, apply and restore, each missed
    # once and replayed at every later run
    train["executable_after"] = exe.cache_stats()["executable"]
    if train["executable_after"]["misses"] != 3 \
            or len(exe.graphs()) != 3:
        fails.append(f"srl: {train['executable_after']}, "
                     f"{len(exe.graphs())} graphs: want 3 misses (the "
                     f"step, apply, restore) and 3 graphs")
    train["device_busy_ms"] = prof["device_busy_ms"]
    train["device_idle_share"] = prof["device_idle_share"]
    rec["train"] = train
    log(f"srl training: {json.dumps(train)}")
    del exe, scope, staged
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec, lstm_n, rec["lstm_cell"], fails


# -- phase 20: speech recognition with CTC at DeepSpeech2's widths --------
# PaddlePaddle's DeepSpeech2 for LibriSpeech: 161 linear-spectrogram bins,
# 3 bidirectional GRU layers of 2048, 28 characters and the blank (the
# last class, 28), Adam at its learning rate 5e-4; its convolution front
# end is left out, as the reference's CTC program has none.  Batch 32 of
# 200-400 frames padded to 400, transcripts of 20-80 characters
SPEECH = dict(bins=161, hidden=2048, depth=3, classes=29, lr=5e-4)
SPEECH_BATCH, SPEECH_FRAMES, SPEECH_LABELS = 32, (200, 400), (20, 80)
SPEECH_STEPS, SPEECH_COMPARE_BATCH = 20, 4


def build_speech(fluid, bins, hidden, depth, classes, lr, seed=SEED):
    """The speech program of the reference's tests/test_ctc.py made
    bidirectional and deep: fc(bins -> hidden, relu), then ``depth``
    layers of a forward and a reversed ``dynamic_gru`` of ``hidden``,
    each direction fed by its own fc of 3 x hidden over the layer below
    (both directions of it), then fc -> ``classes`` logits,
    ``warpctc(blank=classes - 1, norm_by_times=True)``, mean and Adam;
    the test program (cloned before the optimizer) decodes greedily and
    scores the decode by ``edit_distance(normalized=True)`` -> (main,
    startup, test, loss, logits, decoded, distance)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feats = layers.data("feats", [bins], "float32", lod_level=1)
        label = layers.data("label", [1], "int64", lod_level=1)
        h = layers.fc(feats, size=hidden, act="relu")
        for _ in range(depth):
            h = [layers.dynamic_gru(layers.fc(h, size=3 * hidden),
                                    size=hidden, is_reverse=rev)
                 for rev in (False, True)]
        logits = layers.fc(h, size=classes)
        loss = layers.mean(layers.warpctc(logits, label, blank=classes - 1,
                                          norm_by_times=True))
        decoded = layers.ctc_greedy_decoder(logits, blank=classes - 1)
        dist = layers.edit_distance(decoded, label, normalized=True)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, test, loss, logits, decoded, dist


def speech_batch(np, fluid, rng, batch, bins, classes, frames, labels):
    """``batch`` utterances of ``frames`` (lo, hi) frames of ``bins``
    standard-normal features (padded to hi) with transcripts of
    ``labels`` (lo, hi) characters in [0, classes - 1)."""
    n = rng.randint(frames[0], frames[1] + 1, batch)
    feats = [rng.randn(t, bins).astype(np.float32) for t in n]
    text = [rng.randint(0, classes - 1, rng.randint(labels[0],
                                                    labels[1] + 1))
            for _ in range(batch)]
    return {"feats": fluid.make_seq(feats, dtype=np.float32,
                                    max_len=frames[1]),
            "label": fluid.make_seq(text, dtype=np.int64,
                                    max_len=labels[1])}


# -- phase 21: MobileNet-SSD at 300 x 300 ----------------------------------
# PaddlePaddle models' object_detection (mobilenet_ssd.py) on VOC: a
# MobileNet v1 backbone of depthwise-separable conv2d(groups=C) +
# batch_norm blocks, heads on the 19, 10, 5, 3, 2 and 1 maps, 3 priors on
# the first (min 60, aspect ratio 2, flip) and 6 on the others (min, max,
# aspect ratios 2 and 3, flip): 1,917 priors; 21 classes (background 0),
# batch 32, 1-16 ground-truth boxes an image padded to 16, Momentum 0.9
SSD = dict(px=300, scale=1.0, repeats=5, classes=21, lr=1e-3)
SSD_BATCH, SSD_GT, SSD_STEPS, SSD_COMPARE_BATCH = 32, (1, 16), 20, 4
SSD_MIN_SIZES = (60.0, 105.0, 150.0, 195.0, 240.0, 285.0)
SSD_MAX_SIZES = (None, 150.0, 195.0, 240.0, 285.0, 300.0)


def build_ssd(fluid, px, scale, repeats, classes, lr, seed=SEED):
    """MobileNet-SSD (``mobilenet_ssd.py``'s ``mobile_net`` at width
    ``scale``, ``repeats`` of its five 512-wide blocks) over ``px``
    images: per head map a 3x3 conv of n_priors x 4 locations and one of
    n_priors x classes scores, NHWC-flattened and concatenated, its
    ``prior_box`` priors (sizes scaled by px / 300) likewise; ``ssd_loss``, mean and Momentum 0.9.
    The test program (cloned before the optimizer) holds
    ``detection_output`` at the layer's defaults -> (main, startup,
    test, loss, loc, conf, detections)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    layers = fluid.layers

    def conv_bn(x, k, n, stride, pad, groups=1):
        x = layers.conv2d(x, n, k, stride, pad, groups=groups,
                          bias_attr=False)
        return layers.batch_norm(x, act="relu")

    def separable(x, n1, n2, groups, stride):
        x = conv_bn(x, 3, int(n1 * scale), stride, 1,
                    groups=int(groups * scale))
        return conv_bn(x, 1, int(n2 * scale), 1, 0)

    def extra(x, n1, n2):
        return conv_bn(conv_bn(x, 1, int(n1 * scale), 1, 0), 3,
                       int(n2 * scale), 2, 1)

    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = layers.data("img", [3, px, px], "float32")
        gt_box = layers.data("gt_box", [4], "float32", lod_level=1)
        gt_label = layers.data("gt_label", [1], "int64", lod_level=1)
        x = conv_bn(img, 3, int(32 * scale), 2, 1)
        for n1, n2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                               (128, 256, 2), (256, 256, 1),
                               (256, 512, 2)):
            x = separable(x, n1, n2, n1, stride)
        for _ in range(repeats):
            x = separable(x, 512, 512, 512, 1)
        maps = [x]
        x = separable(x, 512, 1024, 512, 2)
        maps.append(separable(x, 1024, 1024, 1024, 1))
        for n1, n2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
            maps.append(extra(maps[-1], n1, n2))
        locs, confs, boxes, variances = [], [], [], []
        for i, m in enumerate(maps):
            ratios = [2.0] if i == 0 else [2.0, 3.0]
            mx = [] if SSD_MAX_SIZES[i] is None else [SSD_MAX_SIZES[i]]
            n = 1 + 2 * len(ratios) + len(mx)
            # the sizes are for 300 px images: scaled with the image
            box, var = layers.prior_box(
                m, img, [SSD_MIN_SIZES[i] * px / 300],
                [v * px / 300 for v in mx], ratios, flip=True, clip=True)
            boxes.append(layers.reshape(box, [-1, 4]))
            variances.append(layers.reshape(var, [-1, 4]))
            for out, width in ((locs, 4), (confs, classes)):
                head = layers.conv2d(m, n * width, 3, padding=1)
                head = layers.transpose(head, [0, 2, 3, 1])
                out.append(layers.reshape(head, [0, -1, width]))
        loc = layers.concat(locs, axis=1)
        conf = layers.concat(confs, axis=1)
        prior = layers.concat(boxes, axis=0)
        prior_var = layers.concat(variances, axis=0)
        loss = layers.mean(layers.ssd_loss(loc, conf, gt_box, gt_label,
                                           (prior, prior_var)))
        dets = layers.detection_output(loc, conf, prior, prior_var)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    return main, startup, test, loss, loc, conf, dets


def ssd_batch(np, fluid, rng, batch, px, classes, gt=SSD_GT):
    """``batch`` images (uniform [0, 1) pixels, a brighter rectangle
    under each box) with 1-16 ground-truth boxes of classes 1 ..
    classes - 1, normalized corners, padded to 16."""
    imgs = rng.rand(batch, 3, px, px).astype(np.float32) * 0.5
    boxes, labels = [], []
    for b in range(batch):
        n = rng.randint(gt[0], gt[1] + 1)
        lo = rng.uniform(0.0, 0.7, (n, 2))
        hi = np.minimum(lo + rng.uniform(0.1, 0.5, (n, 2)), 1.0)
        bx = np.concatenate([lo, hi], axis=1).astype(np.float32)
        for x1, y1, x2, y2 in bx:
            imgs[b, :, int(y1 * px):int(y2 * px),
                 int(x1 * px):int(x2 * px)] += 0.5
        boxes.append(bx)
        labels.append(rng.randint(1, classes, n))
    return {"img": imgs,
            "gt_box": fluid.make_seq(boxes, dtype=np.float32,
                                     max_len=gt[1]),
            "gt_label": fluid.make_seq(labels, dtype=np.int64,
                                       max_len=gt[1])}


# the speech step 3 card vs CPU: 4 utterances of 60-120 frames (the
# CPU's step at full width took 48 s at 100-200), transcripts of 10-30;
# the host syncs of one replayed step (a step is ~147k kernels, which
# the profiler takes long to read)
SPEECH_COMPARE_FRAMES, SPEECH_COMPARE_LABELS = (60, 120), (10, 30)
SPEECH_SYNC_STEPS = 1
# SSD step 3 card vs CPU, at batch 4 from the initialization: the
# network amplifies float32 rounding there (the 1 x 1 maps' batch_norm
# averages 4 values), so its gradients are held as ResNet-50's float32
# ones (R50_* above): each within SSD_GRAD_REL_L2 in relative L2, and
# their median relative-L2 distance from the CPU's within
# SSD_NOISE_RATIO times the CPU's own under a one-ulp change of every
# pixel (``ulp_nudged``).  On an H100 80GB HBM3 the card's largest
# error was 9.7% of a gradient's largest (conv2d_24), against 0.9%
# between two CPU runs of 1 and 8 threads
SSD_GRAD_REL_L2, SSD_NOISE_RATIO = 0.1, 4.0
# detection rows card vs CPU on the same inputs: equal classes in the
# same order, scores and corners within ROW_RTOL (exp and softmax round
# differently by an ulp); a flip where two candidates' scores, or an
# IoU and the NMS threshold, lie within NEAR_TIE is a near tie, printed
ROW_RTOL, NEAR_TIE = 1e-6, 1e-5


def train_path(torch, np, fluid, main, init, fetch, feed, steps, units,
               sync_steps=SYNC_STEPS):
    """``steps`` steps of ``main`` on the card from the numpy state
    ``init`` on one batch staged there (``Executor.run``: the first
    step captured, then replays), every kernel's launch count set to 0
    just before and read just after, the peak over the resident state,
    then the host syncs of a replayed step, the device's time of a
    replay and one profiled step (busy, idle) -> (record, scope,
    executor).  ``units`` counts the batch's frames or images."""
    from paddle_tpu_torch.kernels import launch_counts

    dev = torch.device("cuda", 0)
    scope = fluid.scope_from_numpy(init, fluid.CUDAPlace(0))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    staged = device_feed(torch, feed, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    zero_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lv = exe.run(main, feed=staged, fetch_list=fetch, scope=scope)[0]
        times.append(time.perf_counter() - t0)
        losses.append(float(lv))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = exe.cache_stats()["executable"]
    steady = statistics.median(times[1:])

    def step():
        return exe.run(main, feed=staged, fetch_list=fetch, scope=scope)

    rec = {"steps": steps, "losses": losses, "first_step_ms": times[0] * 1e3,
           "step_ms_median": steady * 1e3, "units_per_step": units,
           "units_per_s": units / steady, "resident_gib": resident,
           "peak_mem_gib": peak, "peak_over_resident_gib": peak - resident,
           "executable": stats, "graph": step_graph(exe),
           "repo_kernel_launches": sum(launches.values()),
           "host_syncs_per_step": host_syncs_per_step(torch, step,
                                                      sync_steps),
           "device_ms": replay_ms(torch, exe) if exe.graphs() else None}
    prof = profiled_call(torch, step)
    rec.update(device_busy_ms=prof["device_busy_ms"],
               device_idle_share=prof["device_idle_share"],
               profiled_step=prof)
    return rec, scope, exe


def op_rel_errs(torch, got, want):
    """Each output's error card vs CPU: 0 or inf for an integer one
    (equal or not), else its largest difference over its largest
    magnitude."""
    errs = []
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            errs.append(float("inf"))
        elif not a.is_floating_point():
            errs.append(0.0 if torch.equal(a, b) else float("inf"))
        else:
            errs.append(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
    return errs


def grads_by_conditioning(np, card, cpu, nudged):
    """Gradients (the fetches after the loss) card vs CPU by the SSD
    rule: each within SSD_GRAD_REL_L2 in relative L2, and the median of
    those distances within SSD_NOISE_RATIO times the median distance of
    the CPU's gradients under a one-ulp nudge of the input (``nudged``)
    -> (largest distance, its index, median distance, nudge's median
    distance, ok)."""
    d = [_rel_l2(np, a, b) for a, b in zip(card[1:], cpu[1:])]
    own = [_rel_l2(np, a, b) for a, b in zip(nudged[1:], cpu[1:])]
    worst = int(np.argmax(d))
    med, med_own = float(np.median(d)), float(np.median(own))
    ok = d[worst] <= SSD_GRAD_REL_L2 and \
        med <= max(SSD_NOISE_RATIO * med_own, LSTM_GRAD_RTOL)
    return d[worst], worst, med, med_own, ok


def detection_rows_compare(np, card, cpu, nms_threshold=0.45):
    """Detection rows [B, K, 6] of the card against the CPU's on the
    same inputs, image by image: equal where the classes are equal in
    the same order and every score and corner within ROW_RTOL.  Where an
    image differs, its first differing row is a near tie if the card's
    row is another row of the CPU's and the two rows' scores lie within
    NEAR_TIE of each other (a rank flip), or if a box of one side
    overlaps a kept box of its class on the other by an IoU within
    NEAR_TIE of the NMS threshold (a suppression flip) ->
    {"equal": images equal, "near_ties": [(image, row, margin)],
    "differ": [(image, row)] not explained by a near tie}."""
    equal, ties, differ = 0, [], []
    for b, (x, y) in enumerate(zip(np.asarray(card), np.asarray(cpu))):
        same = (np.array_equal(x[:, 0], y[:, 0])
                and np.allclose(x[:, 1:], y[:, 1:], rtol=ROW_RTOL,
                                atol=ROW_RTOL))
        if same:
            equal += 1
            continue
        close = np.isclose(x[:, 1:], y[:, 1:], rtol=ROW_RTOL,
                           atol=ROW_RTOL).all(1)
        k = int(np.flatnonzero((x[:, 0] != y[:, 0]) | ~close)[0])
        # a rank flip: the card's row k is another of the CPU's rows, its
        # score within NEAR_TIE of the CPU's row k
        twin = [j for j in range(len(y)) if j != k and y[j, 0] == x[k, 0]
                and np.allclose(y[j, 1:], x[k, 1:], rtol=NEAR_TIE,
                                atol=NEAR_TIE)]
        margin = (abs(float(x[k, 1]) - float(y[k, 1])) if twin
                  else float("inf"))
        for box, rows in ((x[k], y), (y[k], x)):
            kept = rows[rows[:, 0] == box[0], 2:]
            if len(kept):
                lo = np.maximum(kept[:, :2], box[2:4])
                hi = np.minimum(kept[:, 2:], box[4:6])
                inter = np.prod(np.maximum(hi - lo, 0), axis=1)
                area = np.prod(np.maximum(box[4:6] - box[2:4], 0))
                areas = np.prod(np.maximum(kept[:, 2:] - kept[:, :2], 0), 1)
                iou = inter / np.maximum(area + areas - inter, 1e-10)
                margin = min(margin, float(np.abs(iou - nms_threshold)
                                           .min()))
        if margin <= NEAR_TIE:
            ties.append((b, k, margin))
        else:
            differ.append((b, k, x[k].tolist(), y[k].tolist()))
    return {"equal": equal, "near_ties": ties, "differ": differ}


def detections_of(np, rows):
    """DetectionMAP's per-image detections from [B, K, 6] rows: the rows
    of class >= 0."""
    return [[list(map(float, r)) for r in img if r[0] >= 0]
            for img in np.asarray(rows)]


def ground_truths_of(np, feed):
    """DetectionMAP's per-image ground truths [class, x1, y1, x2, y2]
    from an ``ssd_batch`` feed."""
    boxes, labels = feed["gt_box"], feed["gt_label"]
    out = []
    for bx, lb, n in zip(np.asarray(boxes.data), np.asarray(labels.data),
                         np.asarray(boxes.lengths)):
        out.append([[float(np.asarray(lb).reshape(-1)[i])]
                    + list(map(float, bx[i])) for i in range(int(n))])
    return out


def speech_phase(torch, np, fluid, card):
    """Phase 20: the speech program at DeepSpeech2's widths (``SPEECH``):
    step 3 at SPEECH_COMPARE_BATCH utterances against the eager step and
    the CPU port (loss 1e-5 relative, every gradient 1e-4 of its
    largest), SPEECH_STEPS Adam steps at SPEECH_BATCH on one batch (step
    ms, frames/s, graph nodes, hits, host syncs, peak over the resident
    state, device busy and idle, no kernel of this repo launched, the
    loss falling), then the test program's greedy decode and
    normalized edit distance on the card, and ``argmax`` ->
    ``ctc_align`` -> ``edit_distance`` on the card's logits on both
    devices: bit for bit.  -> (record, failures)."""
    t0 = time.perf_counter()
    fails = []
    dims = dict(SPEECH)
    main, startup, test, loss, logits, decoded, dist = build_speech(
        fluid, **dims)
    rec = {"card": card, "config": dict(
        dims, batch=SPEECH_BATCH, frames=SPEECH_FRAMES,
        labels=SPEECH_LABELS, blank=dims["classes"] - 1,
        program_ops=len(main.global_block().ops))}
    init = initial_scope(fluid, startup)
    rec["config"]["parameters"] = int(sum(
        init[p.name].size for p in main.global_block().all_parameters()))
    rng = np.random.RandomState(SEED + 20)
    feed = speech_batch(np, fluid, rng, SPEECH_BATCH, dims["bins"],
                        dims["classes"], SPEECH_FRAMES, SPEECH_LABELS)
    small = speech_batch(np, fluid, np.random.RandomState(SEED + 21),
                         SPEECH_COMPARE_BATCH, dims["bins"],
                         dims["classes"], SPEECH_COMPARE_FRAMES,
                         SPEECH_COMPARE_LABELS)
    log(f"speech: {rec['config']}, built and initialized in "
        f"{time.perf_counter() - t0:.1f}s")

    # -- step 3 against the eager step and the CPU port
    params = [p.name for p in main.global_block().all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    t1 = time.perf_counter()
    r = captured_step(torch, fluid, main, fetch, init, lambda i: small,
                      [(main, fetch)])
    card_v, cpu_v = r["card"], [np.asarray(v) for v in r["cpu"][0][0]]
    cmp_ = {"utterances": SPEECH_COMPARE_BATCH,
            "loss_card": float(card_v[0]), "loss_cpu": float(cpu_v[0]),
            "loss_rel_err": abs(float(card_v[0]) - float(cpu_v[0]))
            / abs(float(cpu_v[0])),
            "grad_rel_err": grad_gap(np, card_v, cpu_v),
            "n_grads": len(params), "replay": replay_record(r),
            "replay_ok": replay_ok(r, set(init), loss.name, LSTM_LOSS_RTOL,
                                   LSTM_GRAD_RTOL, 2 * dims["lr"] + 1e-6),
            "seconds": time.perf_counter() - t1}
    rec["compare"] = cmp_
    log(f"speech step {COMPARE_STEP} card vs CPU and replay vs eager: "
        f"{json.dumps(cmp_)}")
    if not (cmp_["replay_ok"] and cmp_["loss_rel_err"] <= LSTM_LOSS_RTOL
            and cmp_["grad_rel_err"] <= LSTM_GRAD_RTOL):
        fails.append(f"speech step {COMPARE_STEP}: {cmp_}")
    del r
    torch.cuda.empty_cache()

    # -- SPEECH_STEPS steps at SPEECH_BATCH
    frames = int(np.asarray(feed["feats"].lengths).sum())
    train, scope, exe = train_path(torch, np, fluid, main, init, [loss],
                                   feed, SPEECH_STEPS, frames,
                                   SPEECH_SYNC_STEPS)
    train.update(batch=SPEECH_BATCH, frames_per_batch=frames,
                 padded_frames_per_batch=SPEECH_BATCH * SPEECH_FRAMES[1],
                 frames_per_s=train["units_per_s"])
    fails += image_train_failures("speech", train, SPEECH_STEPS - 1)
    rec["train"] = train
    log(f"speech training: {json.dumps(train)}")

    # -- the greedy decode on the card, and its ops on both devices
    out = exe.run(test, feed=device_feed(torch, feed, torch.device(
        "cuda", 0)), fetch_list=[logits, decoded, dist], scope=scope,
        return_numpy=False)
    lg, dec, dst = out
    lens = np.asarray(feed["feats"].lengths)
    lbl = feed["label"]
    dec_rec = []
    for d in (torch.device("cuda", 0), torch.device("cpu")):
        ids = run_op(torch, np, "argmax", {"X": (
            "seq", lg.data.float().cpu().numpy(), lens)}, {"axis": -1}, (),
            d)[0]
        path = run_op(torch, np, "ctc_align", {"Input": (
            "seq", ids[0].numpy(), lens)}, {"blank": dims["classes"] - 1},
            (), d)[0]
        ed = run_op(torch, np, "edit_distance", {
            "Hyps": ("seq", path[0].numpy(), path[1].numpy()),
            "Refs": ("seq", np.asarray(lbl.data).astype(np.int32),
                     np.asarray(lbl.lengths))}, {"normalized": True}, (),
            d)[0]
        dec_rec.append((path, ed))
    (pg, eg), (pc, ec) = dec_rec
    decode = {
        "decode_equal": all(torch.equal(a, b) for a, b in zip(pg, pc)),
        "distance_equal": torch.equal(eg[0], ec[0]),
        "program_equal": bool(torch.equal(dec.data.cpu(), pg[0])
                              and torch.equal(dec.lengths.cpu(), pg[1])
                              and torch.equal(dst.cpu(), eg[0])),
        "mean_normalized_distance": float(ec[0].mean()),
        "mean_decoded_len": float(pc[1].float().mean())}
    rec["decode"] = decode
    log(f"speech decode: {json.dumps(decode)}")
    if not (decode["decode_equal"] and decode["distance_equal"]
            and decode["program_equal"]):
        fails.append(f"speech decode card vs CPU: {decode}")
    del exe, scope
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec, fails


def ssd_phase(torch, np, fluid, card):
    """Phase 21: MobileNet-SSD at 300 x 300 (``SSD``): the priors and
    the matching on the card against the CPU on the same inputs (bit for
    bit); step 3 at SSD_COMPARE_BATCH images against the eager step and
    the CPU port (loss 1e-5 relative, gradients by
    ``grads_by_conditioning``);
    SSD_STEPS Momentum steps at SSD_BATCH on one batch (step ms,
    images/s, nodes, hits, syncs, peak, busy and idle, no kernel of this
    repo, the loss falling); then ``detection_output`` at the layer's
    defaults through the test program's ``mode="infer"`` step on the
    trained weights: its NMS on the card's decoded boxes and scores on
    both devices bit for bit, the decode within ROW_RTOL, its rows
    against the CPU's op on the card's Location and Confidence
    (``detection_rows_compare``; an image apart only through the
    decode's ulps is a near tie, printed), and DetectionMAP over both
    sets of rows.  -> (record, failures)."""
    from paddle_tpu_torch.fluid.ops import detection_ops as det

    t0 = time.perf_counter()
    fails = []
    dims = dict(SSD)
    main, startup, test, loss, loc, conf, dets = build_ssd(fluid, **dims)
    init = initial_scope(fluid, startup)
    rec = {"card": card, "config": dict(
        dims, batch=SSD_BATCH, gt_boxes=SSD_GT,
        priors=int(loc.shape[1]), program_ops=len(main.global_block().ops),
        parameters=int(sum(init[p.name].size for p in
                           main.global_block().all_parameters())))}
    rng = np.random.RandomState(SEED + 21)
    feed = ssd_batch(np, fluid, rng, SSD_BATCH, dims["px"],
                     dims["classes"])
    small = ssd_batch(np, fluid, np.random.RandomState(SEED + 22),
                      SSD_COMPARE_BATCH, dims["px"], dims["classes"])
    blk = main.global_block()
    op = next(o for o in blk.ops if o.type == "ssd_loss")
    prior_name, var_name = op.input("PriorBox")[0], op.input("PriorVar")[0]

    # -- step 3 against the eager step (cuDNN's deterministic algorithms:
    # some backward ones add with atomics) and the CPU port, and the CPU
    # port again with every pixel nudged one ulp
    params = [p.name for p in blk.all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in params] + [prior_name]
    with cudnn_deterministic(torch):
        r = captured_step(torch, fluid, main, fetch, init, lambda i: small,
                          [(main, fetch),
                           (main, fetch, lambda f: ulp_nudged(np, f))])
    card_v = r["card"]
    cpu_v, nudged = ([np.asarray(v) for v in run[0]] for run in r["cpu"])
    n = len(params) + 1
    worst, at, med, med_own, grads_ok = grads_by_conditioning(
        np, card_v[:n], cpu_v[:n], nudged[:n])
    cmp_ = {"images": SSD_COMPARE_BATCH, "loss_card": float(card_v[0]),
            "loss_cpu": float(cpu_v[0]),
            "loss_rel_err": abs(float(card_v[0]) - float(cpu_v[0]))
            / abs(float(cpu_v[0])),
            "grad_rel_l2_max": worst, "grad_rel_l2_worst": params[at],
            "grad_rel_l2_median": med, "nudge_rel_l2_median": med_own,
            "grad_rel_err_max": grad_gap(np, card_v[:n], cpu_v[:n]),
            "n_grads": len(params),
            "priors_equal": bool(np.array_equal(card_v[-1], cpu_v[-1])),
            "replay": replay_record(r),
            "replay_ok": r["bitwise"] or replay_ok(
                r, set(init), loss.name, LSTM_LOSS_RTOL, LSTM_GRAD_RTOL,
                2 * dims["lr"] + 1e-6)}
    # the matching on both devices from the card's priors
    gb, gl = small["gt_box"], small["gt_label"]
    matches = [det.ssd_match(torch.tensor(np.asarray(gb.data), device=d),
                             torch.tensor(np.asarray(gb.lengths), device=d),
                             torch.tensor(card_v[-1].reshape(-1, 4),
                                          device=d), 0.5).cpu()
               for d in (torch.device("cuda", 0), torch.device("cpu"))]
    cmp_.update(match_equal=torch.equal(*matches),
                positives=[int(x) for x in (matches[0] >= 0).sum(1)])
    rec["compare"] = cmp_
    log(f"ssd step {COMPARE_STEP} card vs CPU and replay vs eager: "
        f"{json.dumps(cmp_)}")
    if not (cmp_["replay_ok"] and cmp_["loss_rel_err"] <= LSTM_LOSS_RTOL
            and grads_ok and cmp_["priors_equal"] and cmp_["match_equal"]
            and min(cmp_["positives"]) > 0):
        fails.append(f"ssd step {COMPARE_STEP}: {cmp_}")
    del r
    torch.cuda.empty_cache()

    # -- SSD_STEPS steps at SSD_BATCH
    train, scope, exe = train_path(torch, np, fluid, main, init, [loss],
                                   feed, SSD_STEPS, SSD_BATCH)
    train.update(batch=SSD_BATCH, images_per_s=train["units_per_s"])
    fails += image_train_failures("ssd", train, SSD_STEPS - 1)
    rec["train"] = train
    log(f"ssd training: {json.dumps(train)}")

    # -- detection_output through the infer graph, against the CPU's op
    staged = device_feed(torch, feed, torch.device("cuda", 0))
    infer = [exe.run(test, feed=staged, fetch_list=[dets, loc, conf,
                                                    prior_name, var_name],
                     scope=scope, mode="infer", return_numpy=False)
             for _ in range(2)]
    rows, lv, cv, pv, vv = (v.cpu() for v in infer[-1])
    t1 = time.perf_counter()
    nms = (0.01, 0.45, 400, 200)        # the layer's defaults
    # the decode (exp, softmax: an ulp apart between the devices) and the
    # NMS (comparisons only) apart: NMS on the card's own inputs on both
    # devices, bit for bit; then the rows of the CPU's whole op on the
    # card's Location and Confidence, where an image may differ only
    # where the decode's ulps cross a rank, the top-k cut or the IoU
    # threshold (a near tie)
    inputs = [det.detection_inputs(*(t.to(d) for t in (lv, cv, pv, vv)))
              for d in (torch.device("cuda", 0), torch.device("cpu"))]
    same = [det.nms_rows(*(t.to(d) for t in inputs[0]), *nms).cpu()
            for d in (torch.device("cuda", 0), torch.device("cpu"))]
    cpu_rows = det.nms_rows(*inputs[1], *nms)
    decode_err = max(float((a.cpu() - b).abs().max())
                     / max(float(b.abs().max()), 1e-30)
                     for a, b in zip(inputs[0], inputs[1]))
    cmp_rows = detection_rows_compare(np, rows.numpy(), cpu_rows.numpy())
    gts = ground_truths_of(np, feed)
    maps = []
    for r_ in (rows, cpu_rows):
        m = fluid.evaluator.DetectionMAP(0.5)
        m.update(detections_of(np, r_.numpy()), gts)
        maps.append(float(m.eval()))
    inference = dict(cmp_rows, rows_shape=list(rows.shape),
                     replay_equal=torch.equal(infer[0][0].cpu(), rows),
                     nms_same_inputs_equal=bool(
                         torch.equal(same[0], same[1])
                         and torch.equal(same[0], rows)),
                     decode_rel_err=decode_err,
                     detections=int((rows[..., 0] >= 0).sum()),
                     map_card=maps[0], map_cpu=maps[1],
                     cpu_seconds=time.perf_counter() - t1,
                     executable=exe.cache_stats()["executable"])
    # an image whose rows differ with the NMS exact and the decode within
    # ROW_RTOL differs only by the decode's ulps at a decision: a near
    # tie, printed with its rows
    exact = inference["nms_same_inputs_equal"] and decode_err <= ROW_RTOL
    inference["near_ties"] += [(b, k, f"decode {decode_err:.3g}", a, c)
                               for b, k, a, c in cmp_rows["differ"]
                               if exact]
    inference["differ"] = [] if exact else cmp_rows["differ"]
    for t in inference["near_ties"]:
        log(f"ssd detection_output near tie (image, row, margin): {t}")
    rec["inference"] = inference
    log(f"ssd inference: {json.dumps(inference)}")
    if inference["differ"] or not exact or not inference["replay_equal"] \
            or inference["detections"] == 0 \
            or (maps[0] != maps[1] and not inference["near_ties"]):
        fails.append(f"ssd detection_output card vs CPU: {inference}")
    del exe, scope, staged
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec, fails


def slice_op_cases(np):
    """name -> (op, specs, attrs, wrt) of the slice's ops that neither
    path runs, each at a shape its users run: a DCGAN / FCN up-sampling
    step, a C3D video block, 3-D max and average pooling, face-embedding
    normalization, CRNN's column patches, one GRU and one LSTM step at
    width 512, and word2vec's NCE over 30,000 words."""
    rng = np.random.RandomState(SEED + 23)

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {
        "conv2d_transpose": ("conv2d_transpose", {
            "Input": ("t", r(32, 256, 16, 16)),
            "Filter": ("t", r(256, 128, 4, 4, scale=0.05))},
            {"strides": [2, 2], "paddings": [1, 1]}, ("Input", "Filter")),
        "conv3d": ("conv3d", {"Input": ("t", r(8, 64, 8, 28, 28)),
                              "Filter": ("t", r(128, 64, 3, 3, 3,
                                                scale=0.05))},
                   {"paddings": [1, 1, 1]}, ("Input", "Filter")),
        "pool3d/max": ("pool3d", {"X": ("t", r(8, 64, 16, 56, 56))},
                       {"pooling_type": "max", "ksize": [2, 2, 2],
                        "strides": [2, 2, 2]}, ("X",)),
        "pool3d/avg_ceil": ("pool3d", {"X": ("t", r(8, 64, 15, 27, 27))},
                            {"pooling_type": "avg", "ksize": [3, 3, 3],
                             "strides": [2, 2, 2], "paddings": [1, 1, 1],
                             "ceil_mode": True}, ("X",)),
        "l2_normalize": ("l2_normalize", {"X": ("t", r(4096, 512))},
                         {"axis": 1}, ("X",)),
        "im2sequence": ("im2sequence", {"X": ("t", r(32, 512, 1, 100))},
                        {"kernels": [1, 1]}, ("X",)),
        "im2sequence/patches": ("im2sequence",
                                {"X": ("t", r(32, 64, 32, 100))},
                                {"kernels": [8, 2], "strides": [8, 2]},
                                ("X",)),
        "gru_unit": ("gru_unit", {
            "Input": ("t", r(128, 3 * 512)), "HiddenPrev": ("t", r(128, 512)),
            "Weight": ("t", r(512, 3 * 512, scale=0.05)),
            "Bias": ("t", r(1, 3 * 512))}, {},
            ("Input", "HiddenPrev", "Weight", "Bias")),
        "lstm_unit": ("lstm_unit", {"X": ("t", r(128, 4 * 512)),
                                    "C_prev": ("t", r(128, 512))},
                      {"forget_bias": 1.0}, ("X", "C_prev")),
    }


def slice_op_checks(torch, np, failures):
    """Phase 21's op check: the slice's ops off both paths
    (``slice_op_cases``), forward and gradient, card against CPU
    (outputs within SRL_OP_RTOL of their largest, gradients within
    LSTM_GRAD_RTOL), and ``nce`` over 30,000 classes: its negatives
    drawn on the card bit for bit the CPU's from the same seed, its
    cost on the card's draws against ``nce_loss`` on the CPU over the
    same ids.  -> {case: record}."""
    from paddle_tpu_torch.fluid.ops import nn_ops

    dev = torch.device("cuda", 0)
    out = {}
    for name, (op, specs, attrs, wrt) in slice_op_cases(np).items():
        got, g_got = run_op(torch, np, op, specs, attrs, wrt, dev)
        want, g_want = run_op(torch, np, op, specs, attrs, wrt,
                              torch.device("cpu"))
        errs = op_rel_errs(torch, got + g_got, want + g_want)
        rec = {"shapes": {s: list(v[1].shape) for s, v in specs.items()},
               "out_err": max(errs[:len(got)]),
               "grad_err": max(errs[len(got):], default=0.0)}
        rec["ok"] = (rec["out_err"] <= SRL_OP_RTOL
                     and rec["grad_err"] <= LSTM_GRAD_RTOL)
        out[name] = rec
        if not rec["ok"]:
            failures.append(f"op {name} card vs CPU: {rec}")
        torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 24)
    b, d, classes, k = 1024, 256, 30000, 10
    x = rng.randn(b, d).astype(np.float32) * 0.1
    w = rng.randn(classes, d).astype(np.float32) * 0.1
    bias = rng.randn(classes).astype(np.float32) * 0.1
    label = rng.randint(0, classes, (b, 1)).astype(np.int32)
    seed = torch.tensor(SEED & 0x7FFFFFFF, dtype=torch.int32, device=dev)
    specs = {"Input": ("t", x), "Label": ("t", label), "Weight": ("t", w),
             "Bias": ("t", bias)}
    attrs = {"num_total_classes": classes, "num_neg_samples": k}
    (cost,), grads = run_op(torch, np, "nce", specs, attrs,
                            ("Input", "Weight", "Bias"), dev, seed=seed)
    neg = nn_ops.nce_negatives(seed, b, k, classes, dev).cpu()
    neg_cpu = nn_ops.nce_negatives(SEED & 0x7FFFFFFF, b, k, classes,
                                   torch.device("cpu"))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, bias)]
    want = nn_ops.nce_loss(leaves[0], torch.tensor(label), leaves[1],
                           leaves[2], neg)
    wts = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    g_want = torch.autograd.grad((want * torch.tensor(wts)).sum(), leaves)
    errs = op_rel_errs(torch, [cost] + list(grads),
                       [want.detach()] + list(g_want))
    # uniform draws: b * k ids over ``classes`` hit this many distinct
    # ones on average
    expect = classes * (1 - (1 - 1 / classes) ** (b * k))
    rec = {"shapes": {"Input": [b, d], "Weight": [classes, d]},
           "negatives": k, "draws_equal": torch.equal(neg, neg_cpu),
           "distinct_ids": int(neg.unique().numel()),
           "distinct_expected": expect,
           "out_err": errs[0], "grad_err": max(errs[1:])}
    rec["ok"] = (rec["draws_equal"] and rec["out_err"] <= SRL_OP_RTOL
                 and rec["grad_err"] <= LSTM_GRAD_RTOL
                 and abs(rec["distinct_ids"] - expect) <= 0.05 * expect)
    out["nce"] = rec
    if not rec["ok"]:
        failures.append(f"op nce card vs CPU: {rec}")
    return out


# -- phase 22: Fast R-CNN (VGG-16) at 600 x 800 -----------------------------
# Girshick, "Fast R-CNN" (ICCV 2015, arXiv:1504.08083), its VGG-16 model
# on VOC: VGG-16's 13 3x3 conv + relu layers with the four 2x2 max pools
# before conv5 (feature stride 16), roi_pool 7 x 7 on conv5_3 at 1/16,
# fc6 and fc7 of 4096 (relu, dropout 0.5), cls_score over 21 classes
# (softmax cross-entropy) and bbox_pred of 84 (smooth L1, sigma 1, on the
# 4 columns of the RoI's class), Momentum 1e-3 / 0.9, weight decay 5e-4;
# every layer trained (the paper freezes conv1-conv2).  2 images of 600 x
# 800 a batch, 64 RoIs each, a quarter foreground
FRCNN = dict(height=600, width=800, classes=21, fc=4096, scale=1.0,
             lr=1e-3)
FRCNN_IMAGES, FRCNN_ROIS, FRCNN_STEPS = 2, 128, 20
# step 3 card vs CPU: 2 images of 128 x 160, 16 RoIs, full width
FRCNN_COMPARE = dict(height=128, width=160, rois=16)
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def build_fast_rcnn(fluid, height, width, classes, fc, scale, lr,
                    seed=SEED):
    """The Fast R-CNN training program (``FRCNN``), channel widths times
    ``scale``: feeds ``img`` [3, height, width], ``rois`` [5] (image, x1,
    y1, x2, y2 in pixels), ``label`` [1], ``bbox_target`` and
    ``inside_w`` [4 classes] -> (main, startup, test, loss, cls_loss,
    loc_loss, pool5).  The test program is cloned before the
    optimizer."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data("img", [3, height, width], "float32")
        rois = L.data("rois", [5], "float32")
        label = L.data("label", [1], "int64")
        target = L.data("bbox_target", [4 * classes], "float32")
        inside = L.data("inside_w", [4 * classes], "float32")
        x = img
        for i, (n, reps) in enumerate(VGG16_BLOCKS):
            for _ in range(reps):
                x = L.conv2d(x, max(1, int(n * scale)), 3, padding=1,
                             act="relu")
            if i < len(VGG16_BLOCKS) - 1:
                x = L.pool2d(x, 2, "max", 2)
        pool5 = L.roi_pool(x, rois, 7, 7, 1.0 / 16)
        h = pool5
        for _ in range(2):
            h = L.dropout(L.fc(h, fc, act="relu"), 0.5)
        cls_loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, classes),
                                                       label))
        bbox = L.fc(h, 4 * classes)
        loc_loss = L.mean(L.smooth_l1(L.elementwise_mul(bbox, inside),
                                      L.elementwise_mul(target, inside),
                                      sigma=1.0))
        loss = L.sums([cls_loss, loc_loss])
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(5e-4)).minimize(loss)
    return main, startup, test, loss, cls_loss, loc_loss, pool5


def frcnn_batch(np, rng, images, rois, height, width, classes):
    """``images`` images (uniform [0, 1) pixels, a brighter rectangle
    under each foreground RoI) and ``rois`` RoIs split evenly between
    them: boxes of 16 to 400 pixels a side inside the image, corners
    on multiples of 16 for one RoI in eight (bin edges on feature
    cells), a quarter foreground with classes 1 .. classes - 1 and box
    targets N(0, 0.1), the rest background (class 0, no targets)."""
    img = rng.rand(images, 3, height, width).astype(np.float32) * 0.5
    per = rois // images
    out = np.zeros((rois, 5), np.float32)
    label = np.zeros((rois, 1), np.int64)
    target = np.zeros((rois, 4 * classes), np.float32)
    inside = np.zeros((rois, 4 * classes), np.float32)
    for r in range(rois):
        b = min(r // per, images - 1)
        w = rng.uniform(16, min(400, width))
        h = rng.uniform(16, min(400, height))
        x1 = rng.uniform(0, width - w)
        y1 = rng.uniform(0, height - h)
        box = np.float32([x1, y1, x1 + w - 1, y1 + h - 1])
        if r % 8 == 7:
            box = np.minimum(np.round(box / 16) * 16,
                             [width - 1, height - 1] * 2).astype(np.float32)
        out[r] = [b, *box]
        if r % 4 == 0:
            c = rng.randint(1, classes)
            label[r] = c
            target[r, 4 * c:4 * c + 4] = rng.randn(4) * 0.1
            inside[r, 4 * c:4 * c + 4] = 1.0
            bx = box.astype(int)
            img[b, c % 3, bx[1]:bx[3] + 1, bx[0]:bx[2] + 1] += 0.5
    return {"img": img, "rois": out, "label": label, "bbox_target": target,
            "inside_w": inside}


def roi_pool_bitwise(torch, np, x, rois, scale):
    """``roi_pool`` 7 x 7 at ``scale`` on the card and on the CPU on the
    same inputs: out and the gradient of sum(out * w) in X bit for bit,
    and the card's gradient twice the same bits -> record."""
    dev = torch.device("cuda", 0)
    specs = {"X": ("t", x), "ROIs": ("t", rois)}
    attrs = {"pooled_height": 7, "pooled_width": 7, "spatial_scale": scale}
    got, g_got = run_op(torch, np, "roi_pool", specs, attrs, ("X",), dev)
    want, g_want = run_op(torch, np, "roi_pool", specs, attrs, ("X",),
                          torch.device("cpu"))
    _, g_again = run_op(torch, np, "roi_pool", specs, attrs, ("X",), dev)
    return {"shape": list(x.shape), "rois": int(rois.shape[0]),
            "out_bitwise": torch.equal(got[0], want[0]),
            "grad_bitwise": torch.equal(g_got[0], g_want[0]),
            "grad_repeat_bitwise": torch.equal(g_got[0], g_again[0]),
            "out_err": op_rel_errs(torch, got, want)[0],
            "grad_err": op_rel_errs(torch, g_got, g_want)[0],
            "tied_zero_share": float((torch.tensor(x) == 0).float().mean())}


def roi_pool_ms(torch, np, rois, iters=5):
    """The device's ms for ``roi_pool`` 7 x 7 at 1/16 on a [2, 512, 37,
    50] relu-like map and ``rois`` (the training step's shapes): forward
    alone and forward plus backward (CUDA events, ``cuda_ms``)."""
    from paddle_tpu_torch.fluid.ops import misc_ops

    dev = torch.device("cuda", 0)
    x = torch.relu(torch.randn(2, 512, 37, 50, device=dev,
                               generator=torch.Generator(dev).manual_seed(
                                   SEED))).requires_grad_(True)
    r = torch.tensor(rois, device=dev)
    g = torch.ones(r.shape[0], 512, 7, 7, device=dev)

    def fwd():
        bi, ymask, xmask = misc_ops.roi_bins(r, 1.0 / 16, 7, 7, 37, 50)
        return misc_ops._RoIPool.apply(x, bi, ymask, xmask)

    return {"forward": cuda_ms(torch, fwd, iters),
            "forward_backward": cuda_ms(
                torch, lambda: torch.autograd.backward(fwd(), g), iters)}


def frcnn_phase(torch, np, fluid, card):
    """Phase 22: Fast R-CNN (``FRCNN``): step 3 at FRCNN_COMPARE's size
    (full width) against the eager step (bitwise, cuDNN's deterministic
    algorithms) and the CPU port (the loss within 1e-4 relative, each
    gradient within R50_GRAD_L2 in relative L2, ResNet-50's float32
    rule; the largest error over the gradient's largest recorded);
    ``roi_pool`` card against CPU on the same inputs, out and gradient
    bit for bit; FRCNN_STEPS steps at FRCNN_IMAGES x 600 x 800 with
    FRCNN_ROIS RoIs on one batch (step ms, images/s and RoIs/s, nodes,
    hits, syncs, peak over the resident state, busy and idle, no kernel
    of this repo, the loss falling; ``roi_pool``'s own device ms at the
    step's shapes).  -> (record, failures)."""
    t0 = time.perf_counter()
    fails = []
    dims = dict(FRCNN)
    main, startup, test, loss, cls_loss, loc_loss, pool5 = \
        build_fast_rcnn(fluid, **dims)
    init = initial_scope(fluid, startup)
    params = [p.name for p in main.global_block().all_parameters()]
    rec = {"card": card, "config": dict(
        dims, images=FRCNN_IMAGES, rois=FRCNN_ROIS,
        pool5=list(pool5.shape) if pool5.shape else None,
        program_ops=len(main.global_block().ops),
        parameters=int(sum(init[p].size for p in params)))}
    rng = np.random.RandomState(SEED + 22)
    feed = frcnn_batch(np, rng, FRCNN_IMAGES, FRCNN_ROIS, dims["height"],
                       dims["width"], dims["classes"])
    cmp_dims = dict(dims, height=FRCNN_COMPARE["height"],
                    width=FRCNN_COMPARE["width"])
    small_main = build_fast_rcnn(fluid, **cmp_dims)[0]
    small = frcnn_batch(np, np.random.RandomState(SEED + 23), FRCNN_IMAGES,
                        FRCNN_COMPARE["rois"], cmp_dims["height"],
                        cmp_dims["width"], dims["classes"])
    log(f"frcnn: {rec['config']}, built and initialized in "
        f"{time.perf_counter() - t0:.1f}s")

    # -- step 3 against the eager step and the CPU port
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    t1 = time.perf_counter()
    with cudnn_deterministic(torch):
        r = captured_step(torch, fluid, small_main, fetch, init,
                          lambda i: small, [(small_main, fetch)])
    card_v, cpu_v = r["card"], [np.asarray(v) for v in r["cpu"][0][0]]
    l2 = [_rel_l2(np, a, b) for a, b in zip(card_v[1:], cpu_v[1:])]
    cmp_ = {"images": FRCNN_IMAGES, "px": [cmp_dims["height"],
                                           cmp_dims["width"]],
            "rois": FRCNN_COMPARE["rois"], "loss_card": float(card_v[0]),
            "loss_cpu": float(cpu_v[0]),
            "loss_rel_err": abs(float(card_v[0]) - float(cpu_v[0]))
            / abs(float(cpu_v[0])),
            "grad_rel_l2_max": max(l2),
            "grad_rel_l2_worst": params[int(np.argmax(l2))],
            "grad_rel_l2_median": float(np.median(l2)),
            "grad_rel_err_max": grad_gap(np, card_v, cpu_v),
            "n_grads": len(params), "replay": replay_record(r),
            "replay_ok": r["bitwise"],
            "seconds": time.perf_counter() - t1}
    # roi_pool on the same inputs on both devices: relu-like features
    # (a third exactly 0: tied maxima) at the compare size, the batch's
    # RoIs
    fh, fw = cmp_dims["height"] // 16, cmp_dims["width"] // 16
    xr = np.maximum(rng.randn(FRCNN_IMAGES, 512, fh, fw), -0.4).astype(
        np.float32)
    xr[xr < 0] = 0.0
    cmp_["roi_pool"] = roi_pool_bitwise(torch, np, xr, small["rois"],
                                        1.0 / 16)
    rec["compare"] = cmp_
    log(f"frcnn step {COMPARE_STEP} card vs CPU and replay vs eager: "
        f"{json.dumps(cmp_)}")
    rp = cmp_["roi_pool"]
    if not (cmp_["replay_ok"] and cmp_["loss_rel_err"] <= STEP_LOSS_RTOL
            and cmp_["grad_rel_l2_max"] <= R50_GRAD_L2
            and rp["out_bitwise"] and rp["grad_bitwise"]
            and rp["grad_repeat_bitwise"]):
        fails.append(f"frcnn step {COMPARE_STEP}: {cmp_}")
    del r
    torch.cuda.empty_cache()

    # -- FRCNN_STEPS steps at full size
    train, scope, exe = train_path(torch, np, fluid, main, init, [loss],
                                   feed, FRCNN_STEPS, FRCNN_IMAGES)
    steady_s = train["step_ms_median"] / 1e3
    train.update(images=FRCNN_IMAGES, rois=FRCNN_ROIS,
                 images_per_s=train["units_per_s"],
                 rois_per_s=FRCNN_ROIS / steady_s)
    fails += image_train_failures("frcnn", train, FRCNN_STEPS - 1)
    del exe, scope
    torch.cuda.empty_cache()
    train["roi_pool_ms"] = roi_pool_ms(torch, np, feed["rois"])
    rec["train"] = train
    log(f"frcnn training: {json.dumps(train)}")
    rec["seconds"] = time.perf_counter() - t0
    return rec, fails


# -- phase 23: learning to rank (LambdaRank, RankNet) -----------------------
# LETOR 4.0 MQ2007's shape: 46 features a document, graded labels 0-2;
# no corpus in the repo, so seeded synthetic queries whose labels follow
# a hidden linear score.  The scorer (46 -> 128 -> 64 -> 1, tanh) is
# this repo's choice.  LambdaRank: lambda_rank_cost (ndcg_num 10) over
# 256 queries of 8-128 documents padded to 128, its mean the loss;
# RankNet: rank_loss over 16,384 pairs of differently labelled documents
# of the same queries; both Adam 1e-3, both fetch the AUC of
# [1 - p, p], p = sigmoid(score), against label > 0, every step
RANK = dict(features=46, hidden=(128, 64), ndcg_num=10, lr=1e-3)
RANK_QUERIES, RANK_DOCS, RANK_PAIRS, RANK_STEPS = 256, (8, 128), 16384, 20
RANK_COMPARE = dict(queries=8, docs=(4, 24), pairs=64)


def _scorer(fluid, x, hidden):
    """The shared scorer: tanh fcs of ``hidden``, then one output
    without a bias (both losses see only score differences, so an
    output bias would get a gradient of rounding noise, which Adam
    scales to full steps); the parameters named, so that every tower
    shares them."""
    for i, n in enumerate(hidden):
        x = fluid.layers.fc(x, n, act="tanh",
                            param_attr=fluid.ParamAttr(name=f"rank_w{i}"),
                            bias_attr=fluid.ParamAttr(name=f"rank_b{i}"))
    return fluid.layers.fc(
        x, 1, param_attr=fluid.ParamAttr(name=f"rank_w{len(hidden)}"),
        bias_attr=False)


def build_ranking(fluid, kind, features, hidden, ndcg_num, lr, seed=SEED):
    """LambdaRank (``kind`` "lambdarank": feeds ``docs`` and ``label``,
    sequences) or RankNet ("ranknet": ``left``, ``right`` [features] and
    ``pair_label`` [1]), each with the AUC tower on ``flat_docs``
    [features] against ``rel`` [1] (label > 0) -> (main, startup, loss,
    auc)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if kind == "lambdarank":
            docs = L.data("docs", [features], "float32", lod_level=1)
            label = L.data("label", [1], "float32", lod_level=1)
            cost = L.lambda_rank_cost(_scorer(fluid, docs, hidden), label,
                                      ndcg_num=ndcg_num)
        else:
            left = L.data("left", [features], "float32")
            right = L.data("right", [features], "float32")
            pair = L.data("pair_label", [1], "float32")
            cost = L.rank_loss(pair, _scorer(fluid, left, hidden),
                               _scorer(fluid, right, hidden))
        loss = L.mean(cost)
        flat = L.data("flat_docs", [features], "float32")
        rel = L.data("rel", [1], "int64")
        p = L.sigmoid(_scorer(fluid, flat, hidden))
        auc = L.auc(L.concat([L.scale(p, -1.0, 1.0), p], axis=1), rel)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, auc


def ranking_batch(np, fluid, rng, kind, queries, docs, pairs, features):
    """``queries`` queries of ``docs`` (lo, hi) documents: features
    uniform [0, 1), labels 0-2 by thresholds on a hidden linear score
    plus noise (about 55% 0, 30% 1, 15% 2); for RankNet ``pairs`` pairs
    of two documents of one query with different labels, label 1 where
    the left one ranks higher.  Every document also flat (``flat_docs``)
    with ``rel`` = label > 0."""
    w = np.random.RandomState(SEED).randn(features).astype(np.float32)
    n = rng.randint(docs[0], docs[1] + 1, queries)
    feats, labels = [], []
    for k in n:
        x = rng.rand(k, features).astype(np.float32)
        s = (x - 0.5) @ w / np.sqrt(features) + 0.3 * rng.randn(k)
        labels.append(np.digitize(s, [0.1, 0.5]).astype(np.float32))
        feats.append(x)
    flat = np.concatenate(feats)
    lab = np.concatenate(labels)
    feed = {"flat_docs": flat, "rel": (lab > 0).astype(np.int64)[:, None]}
    if kind == "lambdarank":
        feed["docs"] = fluid.make_seq(feats, dtype=np.float32,
                                      max_len=docs[1])
        feed["label"] = fluid.make_seq([v[:, None] for v in labels],
                                       dtype=np.float32, max_len=docs[1])
        return feed
    left, right, pl = [], [], []
    while len(pl) < pairs:
        q = rng.randint(queries)
        i, j = rng.randint(n[q], size=2)
        if labels[q][i] == labels[q][j]:
            continue
        left.append(feats[q][i])
        right.append(feats[q][j])
        pl.append(float(labels[q][i] > labels[q][j]))
    feed.update(left=np.stack(left), right=np.stack(right),
                pair_label=np.float32(pl)[:, None])
    return feed


def rank_ops_bitwise(torch, np, rng):
    """``lambda_rank_cost`` and ``auc`` on the card and on the CPU on
    the same scores: RANK_QUERIES queries of RANK_DOCS documents, scores
    rounded to 1/8 and labels 0-2 (ties), and AUC over every document's
    sigmoid, a quarter saturated (exactly 0 or 1) -> record."""
    dev = torch.device("cuda", 0)
    lo, hi = RANK_DOCS
    lengths = rng.randint(lo, hi + 1, RANK_QUERIES).astype(np.int32)
    score = (np.round(rng.randn(RANK_QUERIES, hi, 1) * 8) / 8).astype(
        np.float32)
    label = rng.randint(0, 3, (RANK_QUERIES, hi, 1)).astype(np.float32)
    specs = {"Score": ("seq", score, lengths),
             "Label": ("seq", label, lengths)}
    attrs = {"ndcg_num": RANK["ndcg_num"]}
    cost = [run_op(torch, np, "lambda_rank_cost", specs, attrs, ("Score",),
                   d) for d in (dev, torch.device("cpu"))]
    n = int(lengths.sum())
    p = 1.0 / (1.0 + np.exp(-rng.randn(n) * 4))
    p[rng.rand(n) < 0.25] = np.float32(rng.rand() > 0.5)
    p = p.astype(np.float32)
    auc_specs = {"Out": ("t", np.stack([1 - p, p], axis=1)),
                 "Indices": ("t", np.zeros((n, 1), np.int32)),
                 "Label": ("t", rng.randint(0, 2, (n, 1)).astype(np.int64))}
    aucs = [run_op(torch, np, "auc", auc_specs, {}, (), d)[0][0]
            for d in (dev, torch.device("cpu"))]
    return {"queries": RANK_QUERIES, "documents": n,
            "cost_bitwise": torch.equal(cost[0][0][0], cost[1][0][0]),
            "cost_err": op_rel_errs(torch, cost[0][0], cost[1][0])[0],
            "grad_err": op_rel_errs(torch, cost[0][1], cost[1][1])[0],
            "auc_bitwise": torch.equal(aucs[0], aucs[1]),
            "auc": float(aucs[0])}


def ranking_phase(torch, np, fluid, card):
    """Phase 23: LambdaRank and RankNet (``RANK``), each: step 3 at
    RANK_COMPARE's size against the eager step (bitwise) and the CPU
    port (loss 1e-5 relative, every gradient 1e-4 of its largest),
    RANK_STEPS Adam steps on one batch fetching the loss and the AUC
    (step ms, queries/s or pairs/s, the rest as phase 22); then
    ``lambda_rank_cost`` and ``auc`` card against CPU on the same scores,
    bit for bit.  -> (record, failures)."""
    t0 = time.perf_counter()
    fails = []
    rec = {"card": card}
    for kind in ("lambdarank", "ranknet"):
        t1 = time.perf_counter()
        main, startup, loss, auc = build_ranking(fluid, kind, **RANK)
        init = initial_scope(fluid, startup)
        params = [p.name for p in main.global_block().all_parameters()]
        feed = ranking_batch(np, fluid, np.random.RandomState(SEED + 30),
                             kind, RANK_QUERIES, RANK_DOCS, RANK_PAIRS,
                             RANK["features"])
        small = ranking_batch(np, fluid, np.random.RandomState(SEED + 31),
                              kind, RANK_COMPARE["queries"],
                              RANK_COMPARE["docs"], RANK_COMPARE["pairs"],
                              RANK["features"])
        fetch = [loss.name] + [n + "@GRAD" for n in params]
        r = captured_step(torch, fluid, main, fetch, init,
                          lambda i: small, [(main, fetch)])
        card_v, cpu_v = r["card"], [np.asarray(v) for v in r["cpu"][0][0]]
        cmp_ = {"loss_card": float(card_v[0]), "loss_cpu": float(cpu_v[0]),
                "loss_rel_err": abs(float(card_v[0]) - float(cpu_v[0]))
                / abs(float(cpu_v[0])),
                "grad_rel_err": grad_gap(np, card_v, cpu_v),
                "replay": replay_record(r), "replay_ok": r["bitwise"]}
        if not (cmp_["replay_ok"] and cmp_["loss_rel_err"] <= LSTM_LOSS_RTOL
                and cmp_["grad_rel_err"] <= LSTM_GRAD_RTOL):
            fails.append(f"{kind} step {COMPARE_STEP}: {cmp_}")
        units = (RANK_QUERIES if kind == "lambdarank" else RANK_PAIRS)
        train, scope, exe = train_path(torch, np, fluid, main, init,
                                       [loss, auc], feed, RANK_STEPS, units)
        train.update(documents=int(len(feed["flat_docs"])),
                     **{("queries_per_s" if kind == "lambdarank"
                         else "pairs_per_s"): train["units_per_s"]})
        aucs = [float(np.asarray(v)) for v in exe.run(
            main, feed=device_feed(torch, feed, torch.device("cuda", 0)),
            fetch_list=[auc], scope=scope)]
        train["auc_after"] = aucs[0]
        fails += image_train_failures(kind, train, RANK_STEPS - 1)
        rec[kind] = {"compare": cmp_, "train": train, "config": dict(
            RANK, queries=RANK_QUERIES, docs=RANK_DOCS,
            pairs=RANK_PAIRS if kind == "ranknet" else None,
            parameters=int(sum(init[p].size for p in params))),
            "seconds": time.perf_counter() - t1}
        log(f"{kind}: {json.dumps(rec[kind])}")
        del exe, scope, r
        torch.cuda.empty_cache()
    ops = rank_ops_bitwise(torch, np, np.random.RandomState(SEED + 32))
    rec["ops"] = ops
    log(f"ranking ops card vs CPU: {json.dumps(ops)}")
    if not (ops["cost_bitwise"] and ops["auc_bitwise"]
            and ops["grad_err"] <= LSTM_GRAD_RTOL):
        fails.append(f"ranking ops card vs CPU: {ops}")
    rec["seconds"] = time.perf_counter() - t0
    return rec, fails


# -- phase 24: the slice's ops at realistic shapes, card against CPU --------
# chi2(k - 1) upper quantile at a 1e-4 false-alarm rate (Wilson-Hilferty)
CHI2_Z = 3.719


def chi2_quantile(k):
    return k * (1 - 2 / (9 * k) + CHI2_Z * math.sqrt(2 / (9 * k))) ** 3


def loss_misc_op_cases(np):
    """name -> (op, specs, attrs, wrt, exact) of the slice's ops at
    shapes their users run: hsigmoid over 100,000 classes (batch 1024,
    512 features), selective_fc over 100,000 columns (k 64, -1 slots),
    row_conv at the speech path's 32 x 400 x 2048 (future context 19),
    bilinear_interp [32, 256, 19, 19] -> 38 x 38, spp on conv5_3
    [2, 512, 37, 50], max_pool2d_with_index / unpool [32, 64, 150, 150]
    2 x 2, cross_entropy_over_beam (3 expansions, batch 128), conv_shift
    [1024, 128] by 3, roi_pool on conv5_3 with phase 22's RoIs, and
    [1024, 1000] for the rest."""
    rng = np.random.RandomState(SEED + 24)

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def ints(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int32)

    b, n = 1024, 1000
    bin01 = ints(2, b, n).astype(np.float32)
    sel = ints(100000, b, 64)
    sel[rng.rand(b, 64) < 0.1] = -1
    pool_in = np.round(r(32, 64, 150, 150) * 4) / 4
    lens = rng.randint(200, 401, 32).astype(np.int32)
    feat = np.maximum(r(2, 512, 37, 50), -0.4)
    feat[feat < 0] = 0.0
    rois = frcnn_batch(np, np.random.RandomState(SEED + 22), 2, 128, 600,
                       800, 21)["rois"]
    beams = {"Scores": ("list", [r(128, n), r(128, 4, n), r(128, 16, n)]),
             "Ids": ("list", [ints(n, 128, 4), ints(n, 128, 4, 4),
                              ints(n, 128, 16, 4)]),
             "Gold": ("list", [ints(n, 128), ints(n, 128), ints(n, 128)])}
    for k, ids in enumerate(beams["Ids"][1]):
        ids[..., -1][k % 4] = -1
    return {
        "cross_entropy_with_selfnorm": (
            "cross_entropy_with_selfnorm",
            {"X": ("t", u(b, n, lo=1e-3, hi=1e-2)),
             "Label": ("t", ints(n, b, 1))},
            {"softmax_selfnorm_alpha": 0.1}, ("X",), False),
        "cross_entropy_over_beam": ("cross_entropy_over_beam", beams, {},
                                    ("Scores",), False),
        "smooth_l1_loss": ("smooth_l1_loss", {"X": ("t", r(b, n)),
                                              "Y": ("t", r(b, n))},
                           {"sigma": 3.0}, ("X", "Y"), False),
        "huber_loss": ("huber_loss", {"X": ("t", r(b, n)),
                                      "Y": ("t", r(b, n))},
                       {"delta": 1.0}, ("X", "Y"), False),
        "hinge_loss": ("hinge_loss", {"Logits": ("t", r(b, n)),
                                      "Labels": ("t", bin01)}, {},
                       ("Logits",), False),
        "squared_l2_distance": ("squared_l2_distance",
                                {"X": ("t", r(b, n)), "Y": ("t", r(b, n))},
                                {}, ("X", "Y"), False),
        "auc": ("auc", {"Out": ("t", u(b * n, 2)),
                        "Indices": ("t", ints(2, b * n, 1)),
                        "Label": ("t", ints(2, b * n, 1))}, {}, (), True),
        "precision_recall": ("precision_recall",
                             {"MaxProbs": ("t", u(b * 100, 1)),
                              "Indices": ("t", ints(n, b * 100, 1)),
                              "Labels": ("t", ints(n, b * 100, 1))},
                             {"class_number": n}, (), True),
        "pad": ("pad", {"X": ("t", r(b, n))},
                {"paddings": [1, 2, 3, 4], "pad_value": 0.5}, ("X",), True),
        "crop": ("crop", {"X": ("t", r(b, n))},
                 {"offsets": [10, 20], "shape": [-1, 900]}, ("X",), True),
        "rotate": ("rotate", {"X": ("t", r(32, 64, 40, 50))}, {}, ("X",),
                   True),
        "scale_sub_region": ("scale_sub_region",
                             {"X": ("t", r(32, 64, 40, 50)),
                              "Indices": ("t", np.tile(np.int32(
                                  [[3, 40, 5, 30, 2, 49]]), (32, 1)))},
                             {"value": 0.5}, ("X",), False),
        "selective_fc": ("selective_fc",
                         {"X": ("t", r(b, 512)),
                          "W": ("t", r(512, 100000, scale=0.05)),
                          "Select": ("t", sel),
                          "Bias": ("t", r(100000))}, {},
                         ("X", "W", "Bias"), False),
        "lod_reset": ("lod_reset", {"X": ("seq", r(32, 400, 64), lens),
                                    "Y": ("seq", r(32, 400, 1), lens[::-1]
                                          .copy())}, {}, ("X",), True),
        "label_smooth": ("label_smooth", {"X": ("t", u(b, n))},
                         {"epsilon": 0.1}, ("X",), False),
        "rank_loss": ("rank_loss", {"Label": ("t", bin01[:, :1]),
                                    "Left": ("t", r(b, 1)),
                                    "Right": ("t", r(b, 1))}, {},
                      ("Left", "Right"), False),
        "margin_rank_loss": ("margin_rank_loss",
                             {"Label": ("t", 2 * bin01 - 1),
                              "X1": ("t", r(b, n)), "X2": ("t", r(b, n))},
                             {"margin": 0.1}, ("X1", "X2"), False),
        "log_loss": ("log_loss", {"Predicted": ("t", u(b, n, lo=0.01,
                                                      hi=0.99)),
                                  "Labels": ("t", bin01)},
                     {"epsilon": 1e-4}, ("Predicted",), False),
        "modified_huber_loss": ("modified_huber_loss",
                                {"X": ("t", r(b, n, scale=2.0)),
                                 "Y": ("t", bin01)}, {}, ("X",), False),
        "conv_shift": ("conv_shift", {"X": ("t", r(b, 128)),
                                      "Y": ("t", r(b, 3))}, {},
                       ("X", "Y"), False),
        "row_conv": ("row_conv", {"X": ("seq", r(32, 400, 2048), lens),
                                  "Filter": ("t", r(20, 2048, scale=0.2))},
                     {}, ("X", "Filter"), False),
        "max_pool2d_with_index": ("max_pool2d_with_index",
                                  {"X": ("t", pool_in)},
                                  {"ksize": [2, 2], "strides": [2, 2]},
                                  ("X",), True),
        "roi_pool": ("roi_pool", {"X": ("t", feat), "ROIs": ("t", rois)},
                     {"pooled_height": 7, "pooled_width": 7,
                      "spatial_scale": 1.0 / 16}, ("X",), True),
        "spp": ("spp", {"X": ("t", feat)}, {"pyramid_height": 3},
                ("X",), True),
        "spp/avg": ("spp", {"X": ("t", feat)},
                    {"pyramid_height": 3, "pooling_type": "avg"}, ("X",),
                    False),
        "bilinear_interp": ("bilinear_interp",
                            {"X": ("t", r(32, 256, 19, 19))},
                            {"out_h": 38, "out_w": 38}, ("X",), False),
        "minus": ("minus", {"X": ("t", r(b, n)), "Y": ("t", r(b, n))}, {},
                  ("X", "Y"), True),
        "l1_norm": ("l1_norm", {"X": ("t", r(b, n))}, {}, ("X",), False),
        "is_empty": ("is_empty", {"X": ("t", r(b, n))}, {}, (), True),
        "assign_value": ("assign_value", {},
                         {"shape": [4, 8], "fp32_values": [
                             float(v) for v in r(32)]}, (), True),
        "bilinear_tensor_product": ("bilinear_tensor_product",
                                    {"X": ("t", r(b, 64)),
                                     "Y": ("t", r(b, 48)),
                                     "Weight": ("t", r(128, 64, 48,
                                                       scale=0.1)),
                                     "Bias": ("t", r(1, 128))}, {},
                                    ("X", "Y", "Weight", "Bias"), False),
        "hsigmoid": ("hsigmoid", {"X": ("t", r(b, 512, scale=0.1)),
                                  "Label": ("t", ints(100000, b, 1)),
                                  "W": ("t", r(99999, 512, scale=0.1)),
                                  "Bias": ("t", r(99999, scale=0.1))},
                     {"num_classes": 100000}, ("X", "W", "Bias"), False),
    }


# the cases whose gradients must be the same bits twice on the card (a
# gather's gradient summed in a fixed order, no atomic scatter)
REPLAY_BITWISE = ("roi_pool", "hsigmoid", "selective_fc")


def loss_misc_op_checks(torch, np, failures):
    """Phase 24: ``loss_misc_op_cases`` on the card against the CPU port,
    outputs within SRL_OP_RTOL of their largest and gradients within
    LSTM_GRAD_RTOL, outputs and gradients bit for bit where ``exact``;
    REPLAY_BITWISE's gradients twice the same bits on the card; the
    unpool of max_pool2d_with_index's card output (stride = kernel);
    hsigmoid's path length at every one of 100,000 labels against the
    CPU's and the bit length; sampling_id by a chi-square test (100
    draws of 1024 rows over 1000 classes).  -> {case: record}."""
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    out = {}

    def check(name, op, specs, attrs, wrt, exact):
        t0 = time.perf_counter()
        got, g_got = run_op(torch, np, op, specs, attrs, wrt, dev)
        want, g_want = run_op(torch, np, op, specs, attrs, wrt, cpu)
        errs = op_rel_errs(torch, got + g_got, want + g_want)
        k = len(got)
        rec = {"out_err": max(errs[:k], default=0.0),
               "grad_err": max(errs[k:], default=0.0),
               "bitwise": all(torch.equal(a, b) for a, b in
                              zip(got + g_got, want + g_want))}
        ok = (rec["bitwise"] if exact else
              rec["out_err"] <= SRL_OP_RTOL
              and rec["grad_err"] <= LSTM_GRAD_RTOL)
        if name in REPLAY_BITWISE:
            _, g2 = run_op(torch, np, op, specs, attrs, wrt, dev)
            rec["grads_repeat_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(g_got, g2))
            ok = ok and rec["grads_repeat_bitwise"]
        rec.update(ok=ok, seconds=time.perf_counter() - t0)
        out[name] = rec
        if not ok:
            failures.append(f"op {name} card vs CPU: {rec}")
        torch.cuda.empty_cache()
        return got

    for name, case in loss_misc_op_cases(np).items():
        got = check(name, *case)
        if name == "max_pool2d_with_index":
            mask, pooled = got       # the outputs in slot order
            check("unpool", "unpool", {"X": ("t", pooled.numpy()),
                                       "Indices": ("t", mask.numpy())},
                  {"unpooled_size": [150, 150]}, ("X",), True)
    # hsigmoid's path length at every label of 100,000 classes
    from paddle_tpu_torch.fluid.ops.misc_ops import hsigmoid_path_length

    c = torch.arange(100000, 200000, dtype=torch.int32)
    lengths = [hsigmoid_path_length(c.to(d)).cpu() for d in (dev, cpu)]
    bits = torch.tensor(np.floor(np.log2(np.arange(100000, 200000,
                                                   dtype=np.float64)))
                        .astype(np.int32))
    rec = {"card_cpu_equal": torch.equal(lengths[0], lengths[1]),
           "bit_length_equal": torch.equal(lengths[0], bits)}
    rec["ok"] = rec["card_cpu_equal"] and rec["bit_length_equal"]
    out["hsigmoid/path_length"] = rec
    if not rec["ok"]:
        failures.append(f"op hsigmoid path length: {rec}")
    # sampling_id: 100 draws of 1024 rows of one distribution over 1000
    rng = np.random.RandomState(SEED + 25)
    p = rng.uniform(0.2, 1.0, 1000).astype(np.float32)
    x = np.tile(p / p.sum(), (1024, 1)).astype(np.float32)
    counts = torch.zeros(1000, dtype=torch.int64, device=dev)
    for i in range(100):
        seed = torch.full((), SEED + i, dtype=torch.int32, device=dev)
        ids = run_op(torch, np, "sampling_id", {"X": ("t", x)}, {}, (), dev,
                     seed=seed)[0][0]
        counts += torch.bincount(ids.reshape(-1).to(dev).long(),
                                 minlength=1000)
    expect = 102400 * (p.astype(np.float64) / p.sum())
    cnt = counts.cpu().numpy()
    chi2 = float(((cnt - expect) ** 2 / expect).sum())
    rec = {"draws": 102400, "chi2": chi2, "quantile": chi2_quantile(999)}
    rec["ok"] = chi2 < rec["quantile"]
    out["sampling_id"] = rec
    if not rec["ok"]:
        failures.append(f"op sampling_id: {rec}")
    return out


# -- phase 25: speculative and constrained decoding --------------------------

# the draft length, and the 1-layer draft's target as bench.py's
# bench_speculative builds it (:926): the target's layers the draft lacks
# have their residual-branch output projections scaled by SPEC_EPS, so the
# two models usually argmax alike, as a distilled draft tracks its teacher
SPEC_K = 4
SPEC_EPS = 0.01
SPEC_DRAFT_LAYERS = 1
SPEC_KV_DTYPES = ("float32", "int8")
# constrained traffic: a 64-token set, and a small key / value / separator
# DFA (accepting between fields)
SPEC_TOKEN_SET = {"type": "token_set", "allowed": list(range(1000, 1064))}
SPEC_DFA = {"type": "dfa", "start": "k",
            "edges": ([["k", t, "v"] for t in range(200, 208)]
                      + [["v", t, "s"] for t in range(300, 332)]
                      + [["s", 5, "k"]]),
            "accept": ["k"]}
# verify rounds profiled for the round's ms and the host's share of it
SPEC_PROFILED_ROUNDS = 3
# the 1-layer draft's accept rate below which the recipe is broken: the
# reference's own run of it read 0.8628 (BENCH_r07.json, "speculative")
SPEC_ACCEPT_FLOOR = 0.5


def eps_scaled_names(prefix, n_layer, n_draft):
    """The residual-branch output projections of the target layers a
    ``n_draft``-layer draft lacks (bench.py:966-972)."""
    names = []
    for i in range(n_draft, n_layer):
        names += [f"{prefix}.enc{i}.self.out.w", f"{prefix}.enc{i}.ffn.fc2.w",
                  f"{prefix}.enc{i}.ffn.fc2.b", f"{prefix}.dec{i}.self.out.w",
                  f"{prefix}.dec{i}.cross.out.w",
                  f"{prefix}.dec{i}.ffn.fc2.w", f"{prefix}.dec{i}.ffn.fc2.b"]
    return names


def plain_with_margins(torch, np, gen, srcs):
    """Plain greedy of ``srcs`` through the unified step (``run_feed``,
    logits fetched), each request ending at end_id or MAX_NEW tokens ->
    (tokens per request, the emitting step's top-2 logit margin per
    token)."""
    gen.open_slots(len(srcs))
    for i, s in enumerate(srcs):
        gen.admit_slot(i, s, max_new=MAX_NEW)
    out = [[] for _ in srcs]
    margins = [[] for _ in srcs]
    while any(ln.phase != "idle" for ln in gen._lanes):
        ids, logits = gen.run_feed(gen.step_feed())
        top2 = torch.topk(logits[:, 0].float(), 2, dim=-1).values
        marg = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        for slot, tok in gen.absorb_step(ids.cpu().numpy()).items():
            out[slot].append(tok)
            margins[slot].append(float(marg[slot]))
            if tok == gen.end_id or len(out[slot]) >= MAX_NEW:
                gen.clear_slot(slot)
    return out, margins


def stream_compare(got, want, margins, tol):
    """Streams against plain greedy's: equal, or differing first where the
    plain step's top-2 margin is within ``tol`` (a near tie: printed, and
    that request's later tokens not compared, for they follow another
    prefix), else differing."""
    rec = {"equal": 0, "near_ties": [], "differ": []}
    for r, (g, w) in enumerate(zip(got, want)):
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 None)
        if j is None and len(g) == len(w):
            rec["equal"] += 1
        elif j is not None and margins[r][j] < tol:
            rec["near_ties"].append([r, j, margins[r][j]])
        else:
            rec["differ"].append([r, j, len(g), len(w)])
    return rec


def scheduled_run(torch, model, srcs, decode=None):
    """``srcs`` through a ContinuousBatchingScheduler over ``model`` at
    N_SLOTS, MAX_NEW tokens each (queued before the loop runs, so the
    steps do not depend on thread timing) -> (tokens per request, wall
    s, every request finished without error)."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(model, n_slots=N_SLOTS,
                                        max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [sched.submit(s, max_new_tokens=MAX_NEW, decode=decode)
            for s in srcs]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = all(r.done and r.error is None for r in reqs)
    return [list(r.tokens) for r in reqs], wall, ok


def grammar_ok(spec_c, row, end_id):
    """Every token of ``row`` allowed by the constraint ``spec_c`` at its
    place (a wire spec, walked here without the serving code)."""
    if spec_c["type"] == "token_set":
        return all(t in set(spec_c["allowed"]) | {end_id} for t in row)
    edges = {(s, t): n for s, t, n in spec_c["edges"]}
    state = spec_c["start"]
    for t in row:
        if t == end_id and state in spec_c["accept"]:
            state = None
            continue
        if state is None or (state, t) not in edges:
            return False
        state = edges[(state, t)]
    return True


def verify_replay_check(torch, spec):
    """One verify step of ``spec``'s next round as a graph replay against
    the same step run eagerly (``run_block_ops``) on a clone of the
    target's pool (and int8 scales) before it: next ids equal, and the
    pool bitwise off the trash page.  Returns the record and the round's
    emitted tokens."""
    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor)

    tgt = spec.target
    prog = spec._verify[0]
    seen = {}
    orig = tgt.exe.run

    def run(program=None, feed=None, fetch_list=None, **kw):
        if program is not prog:
            return orig(program, feed=feed, fetch_list=fetch_list, **kw)
        plan = BlockPlan(prog.desc.global_block(), list(feed),
                         [f.name for f in fetch_list])
        pre = {n: tgt.scope.find_var(n) for n in plan.state_in}
        pre.update({n: pre[n].clone() for n in plan.state_out})
        hits = tgt.exe.cache_stats()["executable"]["hits"]
        out = orig(program, feed=feed, fetch_list=fetch_list, **kw)
        seen.update(plan=plan, feed=dict(feed), pre=pre,
                    ids=out[0].clone(), fetch=fetch_list[0].name,
                    replayed=tgt.exe.cache_stats()["executable"]["hits"]
                    == hits + 1)
        return out

    tgt.exe.run = run
    try:
        emitted = spec.lane_step()
    finally:
        del tgt.exe.run
    dev = tgt.exe.device
    env = dict(seen["pre"])
    env.update(device_feed(torch, seen["feed"], dev))
    with torch.no_grad():
        run_block_ops(seen["plan"], env, [], seed_tensor([]).to(dev), dev,
                      "infer")
    trash = 2 * MODEL["n_layer"]
    state = {n: bool(torch.equal(env[n][:, trash:],
                                 tgt.scope.find_var(n)[:, trash:]))
             for n in seen["plan"].state_out}
    rec = {"replayed": seen["replayed"],
           "ids_equal": bool(torch.equal(env[seen["fetch"]], seen["ids"])),
           "state_bitwise_off_page0": state,
           "verifying_lanes": len(emitted)}
    rec["ok"] = (rec["replayed"] and rec["ids_equal"]
                 and all(state.values()) and len(emitted) > 0)
    return rec, emitted


def spec_delta(after, before):
    keys = ("rounds", "drafted", "accepted", "bonus", "emitted",
            "plain_tokens", "draft_steps", "verify_steps", "cow_copies")
    d = {k: after[k] - before[k] for k in keys}
    d["accept_rate"] = d["accepted"] / d["drafted"] if d["drafted"] else None
    d["tokens_per_round"] = ((d["emitted"] - d["plain_tokens"])
                             / d["rounds"] if d["rounds"] else None)
    return d


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.<name>`` replaced by ``make(old)`` inside the block, then
    put back."""
    own = name in vars(obj)
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def draft_margin_probe(torch, spec, tol):
    """Inside the block, each rejected drafted token of ``spec``'s rounds
    with the draft's own top-2 logit margin where it drafted that token:
    the draft program fetches its logits too (a signature of its own,
    which ``aot_warm`` captures), and each verify step's ids are held
    against the round's drafts.  A rejection is excused where that
    margin is within ``tol`` (a near tie that the draft's and the verify
    step's rounding may break apart).  Yields the record: the drafts
    checked, the rejections ([slot, index in the round, margin]), how
    many were excused and how many not, and the lanes whose drafts the
    dispatches seen do not account for (the probe's own check)."""
    prog, _, _, logits = spec._draft_prog
    hist = defaultdict(list)    # slot -> (token, margin) of its dispatches
    planned = set()
    rec = {"drafted": 0, "rejections": [], "excused": 0, "unexcused": 0,
           "untracked": 0}

    def fetch_margins(run):
        def wrapped(program=None, feed=None, fetch_list=None, **kw):
            if program is not prog:
                return run(program, feed=feed, fetch_list=fetch_list, **kw)
            ids, lg = run(program, feed=feed,
                          fetch_list=[fetch_list[0], logits], **kw)
            top2 = torch.topk(lg.reshape(lg.shape[0], -1).float(), 2,
                              dim=-1).values
            marg = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            toks = ids.reshape(-1).cpu().numpy()
            for slot in planned:
                hist[slot].append((int(toks[slot]), float(marg[slot])))
            return [ids]
        return wrapped

    def note_plan(dispatch):
        def wrapped(plan):
            planned.clear()
            planned.update(plan)
            return dispatch(plan)
        return wrapped

    def judge(dispatch):
        def wrapped(rows):
            ids = dispatch(rows)
            for slot, (inputs, _m) in rows.items():
                drafts = inputs[1:]
                if not drafts:
                    continue
                # a lane's drafts come from its last len(drafts) draft
                # dispatches of the round (its catch-up inputs first)
                got = hist[slot][-len(drafts):]
                rec["drafted"] += len(drafts)
                if [t for t, _ in got] != drafts:
                    rec["untracked"] += 1
                    continue
                m = next((i for i, d in enumerate(drafts)
                          if int(ids[slot][i]) != d), None)
                if m is not None:
                    rec["rejections"].append([slot, m, got[m][1]])
                    rec["excused" if got[m][1] < tol else "unexcused"] += 1
            hist.clear()
            return ids
        return wrapped

    with patched(spec.draft.exe, "run", fetch_margins), \
            patched(spec, "_dispatch_draft", note_plan), \
            patched(spec, "_dispatch_verify", judge):
        yield rec


def speculative_run(torch, fa, spec, srcs, plain, margins, tol,
                    draft_layers, decode=None):
    """``srcs`` through the scheduler over ``spec`` after ``aot_warm``
    (the verify, draft and copy-on-write steps captured at N_SLOTS) ->
    its record: tokens/s, the counters' deltas, the ragged launches of
    the run and of each verify and draft step (its launches over its
    steps; want 3 a layer), executable misses of both executors, and
    (unconstrained) the streams against plain greedy's under the
    near-tie rule."""
    spec.aot_warm(N_SLOTS)
    c0, s0 = spec.cache_stats(), dict(spec.cache_stats()["speculative"])
    per = {"verify": [0, 0], "draft": [0, 0]}     # launches, steps

    def counting(kind):
        def make(dispatch):
            def wrapped(arg):
                n0 = fa.ragged_decode_attention.launches
                out = dispatch(arg)
                per[kind][0] += fa.ragged_decode_attention.launches - n0
                per[kind][1] += 1
                return out
            return wrapped
        return make

    fa.ragged_decode_attention.launches = 0
    with patched(spec, "_dispatch_verify", counting("verify")), \
            patched(spec, "_dispatch_draft", counting("draft")):
        toks, wall, ok = scheduled_run(torch, spec, srcs, decode)
    launches = fa.ragged_decode_attention.launches
    c1 = spec.cache_stats()
    d = spec_delta(dict(spec.cache_stats()["speculative"]), s0)
    rec = {"finished": ok, "tokens": sum(map(len, toks)), "wall_s": wall,
           "tok_per_s": sum(map(len, toks)) / wall, **d,
           "ms_per_round": wall * 1e3 / max(1, d["verify_steps"]),
           "launches": launches,
           "launches_outside_steps": (launches - per["verify"][0]
                                      - per["draft"][0]),
           "launches_per_verify_step": (per["verify"][0] / per["verify"][1]
                                        if per["verify"][1] else None),
           "launches_per_draft_step": (per["draft"][0] / per["draft"][1]
                                       if per["draft"][1] else None),
           "launches_want_per_step": [3 * MODEL["n_layer"],
                                      3 * draft_layers],
           "misses": {k: c1[k]["misses"] - c0[k]["misses"]
                      for k in ("executable", "draft_executable")}}
    if decode is None:
        rec["vs_plain"] = stream_compare(toks, plain, margins, tol)
    else:
        rec["grammar_ok"] = all(grammar_ok(decode["constraint"], t,
                                           spec.end_id) for t in toks)
    return rec, toks


def speculative_failures(name, rec, constrained=False):
    fails = []
    if not rec["finished"]:
        fails.append(f"speculative {name}: a request failed")
    got = [rec["launches_per_verify_step"], rec["launches_per_draft_step"]]
    if got != rec["launches_want_per_step"] or rec["launches_outside_steps"]:
        fails.append(f"speculative {name}: {got} ragged launches a verify "
                     f"and a draft step, want {rec['launches_want_per_step']}"
                     f" (3 a layer), {rec['launches_outside_steps']} "
                     f"outside them")
    if any(rec["misses"].values()):
        fails.append(f"speculative {name}: executable misses after "
                     f"aot_warm {rec['misses']}")
    if constrained and not rec["grammar_ok"]:
        fails.append(f"speculative {name}: a token outside the grammar")
    if not constrained and rec["vs_plain"]["differ"]:
        fails.append(f"speculative {name}: streams differ from plain "
                     f"greedy beyond near ties {rec['vs_plain']}")
    return fails


def plain_run(torch, fa, gen, srcs, plain):
    """``srcs`` through the scheduler over ``gen`` after ``aot_warm`` ->
    (record: tokens/s, whether the tokens are ``plain``; its ragged
    launches; every request finished with those tokens)."""
    gen.aot_warm(N_SLOTS)
    fa.ragged_decode_attention.launches = 0
    toks, wall, ok = scheduled_run(torch, gen, srcs)
    rec = {"tokens": sum(map(len, toks)), "wall_s": wall,
           "tok_per_s": sum(map(len, toks)) / wall,
           "same_as_run_feed": toks == plain}
    return rec, fa.ragged_decode_attention.launches, ok and toks == plain


def speculative_phase(torch, np, fluid, fa, card, weights, srcs,
                      logit_err):
    """Phase 25: speculative and constrained decoding at Transformer-base
    width, per pool dtype of SPEC_KV_DTYPES: the target with the serving
    weights and an identical-weights draft (accept rate 1.0 but where
    the draft's own top-2 margin was a near tie), then a fresh target
    whose layers past the first are near-identity (SPEC_EPS, scaled
    before it serves anything) and the 1-layer draft that shares the
    rest (accept rate at least SPEC_ACCEPT_FLOOR); K = SPEC_K, the
    serving phase's 8 prompts through the scheduler at 8 lanes.  Streams
    against each target's plain greedy under the near-tie rule (a flip
    where the plain step's top-2 margin is within twice the
    teacher-forced logit error: two card runs, each that close to the
    CPU's); tokens/s against the same target's plain run; a verify step
    replayed against the same step eager; the verify and draft steps'
    graphs and ragged launches; constrained traffic (a 64-token set, a
    DFA) within its grammar; no executable miss after ``aot_warm``.
    Returns (record, ragged launches, failures)."""
    from paddle_tpu_torch.serving import SpeculativeGenerator

    t_phase = time.perf_counter()
    failures, runs = [], []
    launches = 0
    sms = fa._sm_count(0)
    want_verify, want_draft = (
        dict(zip(("ragged_split", "ragged_merge"),
                 ragged_calls_per_step(fa, sms, n)))
        for n in (MODEL["n_layer"], SPEC_DRAFT_LAYERS))
    for kv in SPEC_KV_DTYPES:
        torch.cuda.empty_cache()
        tol = 2 * logit_err[kv]
        target = make_generator("cuda", kv)
        target.load_params(weights)
        same = make_generator("cuda", kv)
        same.load_params(weights)
        rec = {"kv_dtype": kv, "card": card, "k": SPEC_K,
               "near_tie_tol": tol}
        # plain greedy: the stream and margins, then its timed run
        plain, margins = plain_with_margins(torch, np, target, srcs)
        rec["plain"], n, ok = plain_run(torch, fa, target, srcs, plain)
        launches += n
        if not ok:
            failures.append(f"speculative {kv}: the plain scheduled run "
                            f"differs from run_feed's greedy")
        spec = SpeculativeGenerator(target, same, k=SPEC_K)
        with draft_margin_probe(torch, spec, tol) as probe:
            r, _ = speculative_run(torch, fa, spec, srcs, plain, margins,
                                   tol, MODEL["n_layer"])
        r["draft_margins"] = probe
        launches += r["launches"]
        rec["identical_draft"] = r
        failures += speculative_failures(f"{kv}/identical", r)
        if probe["unexcused"] or probe["untracked"] or not probe["drafted"]:
            failures.append(f"speculative {kv}: identical draft rejected "
                            f"beyond the draft's near ties {probe}")
        rec["verify_graph"] = step_graph(target.exe, spec._verify[0])
        if rec["verify_graph"].get("by_family") != want_verify:
            failures.append(f"speculative {kv}: verify graph "
                            f"{rec['verify_graph']}, want {want_verify}")
        del spec, same, target
        torch.cuda.empty_cache()

        # the near-identity target, scaled before it serves a request (a
        # prefix it cached under other weights would feed it stale
        # encoder and cross pages), and its 1-layer draft
        target = make_generator("cuda", kv)
        target.load_params(weights)
        for n in eps_scaled_names(target.prefix, MODEL["n_layer"],
                                  SPEC_DRAFT_LAYERS):
            target.scope.find_var(n).mul_(SPEC_EPS)
        draft = make_generator("cuda", kv, dict(MODEL,
                                                n_layer=SPEC_DRAFT_LAYERS))
        draft.load_params({n: v for n, v in weights.items()
                           if n in draft._param_vars()})
        plain1, margins1 = plain_with_margins(torch, np, target, srcs)
        rec["plain_near_identity"], n, ok = plain_run(torch, fa, target,
                                                      srcs, plain1)
        launches += n
        if not ok:
            failures.append(f"speculative {kv}: the near-identity target's "
                            f"scheduled run differs from run_feed's greedy")
        spec1 = SpeculativeGenerator(target, draft, k=SPEC_K)
        r, _ = speculative_run(torch, fa, spec1, srcs, plain1, margins1,
                               tol, SPEC_DRAFT_LAYERS)
        launches += r["launches"]
        rec["draft_1_layer"] = r
        failures += speculative_failures(f"{kv}/1-layer", r)
        if not (r["accept_rate"] or 0) >= SPEC_ACCEPT_FLOOR:
            failures.append(f"speculative {kv}: the 1-layer draft's accept "
                            f"rate {r['accept_rate']}, want at least "
                            f"{SPEC_ACCEPT_FLOOR}")
        rec["draft_graph"] = step_graph(draft.exe, spec1._draft_prog[0])
        if rec["draft_graph"].get("by_family") != want_draft:
            failures.append(f"speculative {kv}: draft graph "
                            f"{rec['draft_graph']}, want {want_draft}")
        for name, c in (("token_set", SPEC_TOKEN_SET), ("dfa", SPEC_DFA)):
            r, _ = speculative_run(torch, fa, spec1, srcs, None, None, tol,
                                   SPEC_DRAFT_LAYERS, {"constraint": c})
            launches += r["launches"]
            rec[f"constrained_{name}"] = r
            failures += speculative_failures(f"{kv}/{name}", r, True)

        # one mid-traffic round: its verify step replayed vs eager, then
        # SPEC_PROFILED_ROUNDS rounds profiled (the round's ms, and the
        # device's busy time and idle share over them)
        spec1.open_slots(N_SLOTS)
        for i, s in enumerate(srcs):
            spec1.admit_slot(i, s, max_new=MAX_NEW)
        while any(ln.phase == "prefill" for ln in spec1.target._lanes) or \
                any(ln.phase == "prefill" for ln in spec1.draft._lanes):
            spec1.lane_step()
        fa.ragged_decode_attention.launches = 0
        rec["verify_replay_vs_eager"], _ = verify_replay_check(torch, spec1)
        if not rec["verify_replay_vs_eager"]["ok"]:
            failures.append(f"speculative {kv}: verify replay vs eager "
                            f"{rec['verify_replay_vs_eager']}")
        prof = profiled_call(torch, lambda: [
            spec1.lane_step() for _ in range(SPEC_PROFILED_ROUNDS)])
        launches += fa.ragged_decode_attention.launches
        prof["round_ms"] = prof["wall_ms"] / SPEC_PROFILED_ROUNDS
        rec["rounds_profiled"] = prof
        for i in range(N_SLOTS):
            spec1.clear_slot(i)
        spec1.check_invariants()
        rec["speedup_vs_plain"] = (rec["draft_1_layer"]["tok_per_s"]
                                   / rec["plain_near_identity"]["tok_per_s"])
        runs.append(rec)
        log(f"speculative {kv}: {json.dumps(rec)}")
        del spec1, draft, target
        torch.cuda.empty_cache()
    one = runs[0]
    per_step = {
        "launches_verify_step": one["draft_1_layer"][
            "launches_per_verify_step"],
        "launches_draft_step": one["draft_1_layer"][
            "launches_per_draft_step"],
        "verify_graph_nodes": one["verify_graph"].get("by_family"),
        "draft_graph_nodes": one["draft_graph"].get("by_family")}
    return ({"runs": runs, "per_step": per_step,
             "seconds": time.perf_counter() - t_phase}, launches, failures)


# -- phase 26: the host tier and sessions ------------------------------------

# the serving model with a pool that keeps two or three conversations
# (a 256-token prompt holds 2 x 16 prompt pages and its decode pages),
# a host tier of 1024 pages, transfers 4 pages a step
TIER_NUM_PAGES = 97
TIER_HOST_PAGES = 1024
TIER_XFER_WIDTH = 4
TIER_SLOTS = 2
TIER_TURN = 8                   # tokens a turn; two turns a conversation


def make_tiered(device, kv_dtype, store):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.serving import PagedTransformerGenerator
    place = fluid.CUDAPlace(0) if device == "cuda" else fluid.CPUPlace()
    return PagedTransformerGenerator(
        VOCAB, VOCAB, kv_dtype=kv_dtype, place=place, session_store=store,
        host_pages=TIER_HOST_PAGES, xfer_width=TIER_XFER_WIDTH,
        **MODEL, **dict(SERVE, num_pages=TIER_NUM_PAGES))


def tier_round_trip(torch, np, gen, src):
    """A prompt prefilled and decoding a few tokens, then its cross and
    self pages downloaded, uploaded into fresh pages and downloaded from
    there: bitwise equal (bf16 slabs as their bits)."""
    gen.open_slots(1)
    gen.admit_slot(0, src, max_new=TIER_TURN)
    for _ in range(64):
        if gen._lanes[0].phase == "decode" and gen._lanes[0].pos >= 2:
            break
        gen.lane_step()
    lane = gen._lanes[0]
    pages = list(lane.cross_table) + list(lane.self_table[:1])
    first = gen._tier_download(pages)
    fresh = gen.alloc.alloc(len(pages))
    gen._tier_upload(fresh, first)
    again = gen._tier_download(fresh)
    for p in fresh:
        gen.alloc.unref(p)
    gen.clear_slot(0)

    def bits(x):
        return None if x is None else (
            x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
            else x)

    same = all(np.array_equal(bits(first[k]), bits(again[k]))
               if first[k] is not None else again[k] is None
               for k in ("kv", "scales"))
    gen.alloc.check_invariants()
    return {"pages": len(pages), "bitwise": bool(same)}


def tier_phase(torch, np, fluid, fa, card, weights):
    """Phase 26: the host tier and sessions on the serving model with
    TIER_NUM_PAGES pages (two or three conversations resident), a host
    tier of TIER_HOST_PAGES pages and a ``SessionStore`` on a temporary
    directory: per pool dtype, download -> upload -> download of a
    conversation's pages bitwise; float32: eight conversations through
    two slots, each suspended after a turn of TIER_TURN tokens and
    resumed for a second, against each conversation decoded in one go
    (token for token); resume TTFT against re-prefill TTFT; spill
    (demote) and prefetch (promote) GB/s; no executable miss across the
    churn after a warm cycle; one artifact torn by ``kv.spill_corrupt``
    degrading to re-prefill with the first turn's tokens.  Returns
    (record, ragged launches, failures)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                          SessionStore)

    t_phase = time.perf_counter()
    failures = []
    rec = {"card": card, "num_pages": TIER_NUM_PAGES,
           "host_pages": TIER_HOST_PAGES, "xfer_width": TIER_XFER_WIDTH,
           "round_trip": {}}
    srcs = prompts(np, SEED + 3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kvs_")
    fa.ragged_decode_attention.launches = 0
    try:
        for kv in KV_DTYPES:
            g = make_tiered("cuda", kv, SessionStore(dirname=os.path.join(
                tmp, f"rt-{kv}")))
            g.load_params(weights)
            rec["round_trip"][kv] = tier_round_trip(torch, np, g, srcs[0])
            if not rec["round_trip"][kv]["bitwise"]:
                failures.append(f"tiers {kv}: download -> upload -> "
                                f"download not bitwise")
            del g
            torch.cuda.empty_cache()

        store = SessionStore(dirname=os.path.join(tmp, "churn"))
        gen = make_tiered("cuda", "float32", store)
        gen.load_params(weights)
        sched = ContinuousBatchingScheduler(gen, n_slots=TIER_SLOTS,
                                            max_new_tokens=2 * TIER_TURN)

        def run(src, max_new, session=None):
            # the serve loop's prefetch of a queued prompt's demoted
            # chunks, as when the request waits behind busy lanes: an
            # admission on an idle loop comes first and would prefill a
            # demoted chunk again (ROADMAP C10)
            gen.tier_maintenance(prefetch=src)
            req = sched.submit(src, max_new_tokens=max_new,
                               session=session)
            sched.run_until_idle()
            if not (req.done and req.error is None):
                failures.append(f"tiers: request failed {req.error!r}")
            return req

        # the uninterrupted decodes; then a warm cycle (suspend, resume,
        # demote, promote) after which the executable misses freeze
        whole = [run(s, 2 * TIER_TURN).tokens for s in srcs]
        run(srcs[0], 2, session="warm")
        run(srcs[0], 2, session="warm")
        while gen.alloc.demote_one():
            pass
        gen.tier_maintenance(prefetch=srcs[0])
        store.delete("warm")
        torch.cuda.synchronize()
        misses0 = gen.exe.cache_stats()["executable"]["misses"]
        stats0 = dict(gen.cache_stats()["tiers"])

        first = [run(s, TIER_TURN, session=f"c{i}")
                 for i, s in enumerate(srcs)]
        second = [run(s, TIER_TURN, session=f"c{i}")
                  for i, s in enumerate(srcs)]
        rec["resumed"] = sum(r.resumed for r in second)
        rec["parity"] = [list(a.tokens) + list(b.tokens) == w
                         for a, b, w in zip(first, second, whole)]
        if rec["resumed"] != len(srcs) or not all(rec["parity"]):
            failures.append(f"tiers: {rec['resumed']} of {len(srcs)} "
                            f"resumed, parity {rec['parity']}")
        ttft_resume = [r.first_token - r.submitted for r in second]
        fresh = prompts(np, SEED + 4, [len(s) for s in srcs])
        reprefill = [run(s, TIER_TURN) for s in fresh]
        ttft_prefill = [r.first_token - r.submitted for r in reprefill]
        rec["resume_ttft_ms"] = float(np.median(ttft_resume)) * 1e3
        rec["reprefill_ttft_ms"] = float(np.median(ttft_prefill)) * 1e3
        rec["resume_vs_reprefill_ttft"] = (rec["resume_ttft_ms"]
                                           / rec["reprefill_ttft_ms"])

        # spill and prefetch rates through the transfer programs
        a0 = dict(gen.alloc.stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while gen.alloc.demote_one():
            pass
        d2h = time.perf_counter() - t0
        a1 = dict(gen.alloc.stats())
        t0 = time.perf_counter()
        for h in list(gen.alloc.host._entries):
            # only into free pages: an allocation under pressure would
            # demote another chunk in the timed window
            if gen.alloc.free_count() < 2:
                break
            gen.alloc.promote_chunk(h)
        torch.cuda.synchronize()
        h2d = time.perf_counter() - t0
        a2 = dict(gen.alloc.stats())
        spill = a1["spilled_bytes"] - a0["spilled_bytes"]
        fetch = a2["fetched_bytes"] - a1["fetched_bytes"]
        rec["spill_gb_per_s"] = spill / d2h / 1e9 if spill else None
        rec["prefetch_gb_per_s"] = fetch / h2d / 1e9 if fetch else None
        rec["spilled_bytes"], rec["fetched_bytes"] = spill, fetch
        if not spill or not fetch:
            failures.append(f"tiers: no demotion or promotion ({spill} "
                            f"spilled, {fetch} fetched bytes)")
        gen.alloc.check_invariants()

        # one torn artifact: re-prefill, the first turn's tokens
        run(srcs[1], TIER_TURN, session="torn")
        corrupt0 = store.stats()["corrupt"]
        prev = chaos.install(chaos.FaultInjector(
            spec="kv.spill_corrupt=1.0", seed=SEED))
        try:
            torn = run(srcs[1], TIER_TURN, session="torn")
        finally:
            chaos.install(prev)
        rec["corrupt_degraded"] = {
            "resumed": torn.resumed,
            "corrupt": store.stats()["corrupt"] - corrupt0,
            "tokens_equal": list(torn.tokens) == whole[1][:TIER_TURN]}
        if torn.resumed or rec["corrupt_degraded"]["corrupt"] != 1 or \
                not rec["corrupt_degraded"]["tokens_equal"]:
            failures.append(f"tiers: torn artifact "
                            f"{rec['corrupt_degraded']}")
        rec["misses_after_warm"] = (
            gen.exe.cache_stats()["executable"]["misses"] - misses0)
        if rec["misses_after_warm"]:
            failures.append(f"tiers: {rec['misses_after_warm']} executable "
                            f"misses across the churn")
        st = gen.cache_stats()["tiers"]
        rec["tier_counts"] = {k: st[k] - stats0.get(k, 0) for k in
                              ("suspends", "resumes", "resume_misses",
                               "demotes", "promotes", "prefetches")}
        rec["sessions"] = store.stats()
        rec["xfer_graphs"] = {
            name: step_graph(gen.exe, p)["graphs"] for name, p in
            (("down", gen._xfer()["down"][0]), ("up", gen._xfer()["up"]))}
        sched.shutdown(timeout=30)
        gen.alloc.check_invariants()
        del gen, sched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = fa.ragged_decode_attention.launches
    rec["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return rec, launches, failures


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-ragged", metavar="DIR", default=None,
                    help="a directory holding an earlier "
                    "ragged_paged_attention.cu (same C entry as the "
                    "parent commit's): build it there and time it beside "
                    "the kernel, the same way (parent_ms)")
    ap.add_argument("--parent-package", metavar="DIR", default=None,
                    help="a directory holding an earlier checkout: after "
                    "the serving phase, profile_serving.py runs on its "
                    "package and on this one in turns (parent, this, "
                    "this, parent), each in a process of its own, for "
                    "the serving step's peak memory, wall, busy and idle "
                    "figures side by side")
    ap.add_argument("--parent-flash", metavar="DIR", default=None,
                    help="a directory holding an earlier "
                    "flash_attention_fwd.cu (and flash_attention_bwd.cu) "
                    "and their headers: build them there and time their "
                    "bf16 forward, dq and dk/dv in turns with the "
                    "kernels' (parent_ms, parent_ms_dropout0, ...)")
    args = ap.parse_args()
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import paddle_tpu_torch.kernels.flash_attention as fa
    import paddle_tpu_torch.kernels.lstm as lk
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.transformer import transformer

    failures = []
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # -- build: every kernel source at once
    t0 = time.perf_counter()
    sources = ([fa.KERNEL_NAME, lk.KERNEL_NAME]
               + sorted(set(fa.FLASH_KERNELS.values())))
    libs = _build.build_all(sources)
    log(f"built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f}s")
    for lib in libs.values():
        build_log = lib.with_name(lib.name + ".log")
        if build_log.exists():      # ptxas: registers, spills, barriers
            for ln in build_log.read_text().splitlines():
                if ("ptxas" in ln and "Compile time" not in ln) \
                        or "spill" in ln:
                    log(ln.strip())

    # -- the ragged kernel vs plain on the card
    dev = torch.device("cuda", 0)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    cases = kernel_cases(torch, gen)
    for case in cases.values():
        case["lengths"] = case["lengths"].to(dev)
        case["q_base"] = case["q_base"].to(dev)
        for s in case["sets"]:
            s["q"] = s["q"].to(dev)
            s["table"] = s["table"].to(dev)
    pools = make_pools(torch, gen, dev)
    max_err = 0.0
    for kv, (pool, scales) in pools.items():
        for name, case in cases.items():
            case_err = 0.0
            for s in case["sets"][:4]:
                got = run_case(fa, case, s, pool, scales, False)
                want = run_case(fa, case, s, pool, scales, True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = bool(torch.allclose(got, want, atol=KERNEL_ATOL,
                                         rtol=KERNEL_RTOL))
                dead = bool((got[5] == 0).all())
                case_err = max(case_err, err)
                if not ok or not dead:
                    failures.append(f"kernel {kv}/{name}: max_abs_err "
                                    f"{err} (dead lane zero: {dead})")
            max_err = max(max_err, case_err)
            log(f"kernel vs plain {kv}/{name}: max_abs_err {case_err}")
    extra = ragged_extra_cases(torch, gen, dev)
    extra_grids, extra_err = run_ragged_extra(torch, fa, extra, failures)
    max_err = max(max_err, extra_err)
    del extra

    # -- the flash kernels vs plain on the card
    flash_err = {(dt, k): 0.0 for dt in ("float32", "bfloat16")
                 for k in ("fwd", "dq", "dkv")}
    owner = {"out": "fwd", "lse": "fwd", "dq": "dq", "dk": "dkv",
             "dv": "dkv"}
    for case in flash_cases():
        name, errs, ok = run_flash_case(torch, fa, case, dev, gen)
        log(f"flash {'ok  ' if ok else 'FAIL'} {name} {json.dumps(errs)}")
        for t, e in errs.items():
            key = (case["dtype"], owner[t])
            flash_err[key] = max(flash_err[key], e)
        if not ok:
            failures.append(f"flash kernel vs plain {name}: {errs}")
    for dt in ("float32", "bfloat16"):
        masks = dropout_mask_probe(torch, fa, dev, dt)
        log(f"flash dropout masks equal keep_scale, {dt} (fwd, dv): "
            f"{masks}")
        if not all(masks):
            failures.append(f"flash dropout masks differ from keep_scale "
                            f"in {dt}: (fwd, dv) = {masks}")
    rounding = rounding_check(torch, fa, dev, gen)
    for name, errs in rounding.items():
        ok = all(e["ulps"] <= 1.0 and e["mean_emulation"] <= e["mean_plain"]
                 for e in errs.values())
        log(f"flash bf16 rounding {'ok  ' if ok else 'FAIL'} {name} "
            f"(bf16 ulps) {json.dumps(errs)}")
        if not ok:
            failures.append(f"flash bf16 {name}: {errs} from the "
                            f"reference's rounding (want at most 1 ulp, "
                            f"and no farther than from the plain version)")
    empty = empty_keys_check(torch, fa, dev)
    log(f"flash forward with no keys, rows dead: {not empty}")
    if empty:
        failures.append(f"flash forward with no keys: {empty}")

    # -- serving, once per pool dtype: the unified step through the
    # executor, captured at the warm-up and replayed at every step
    srcs = prompts(np)
    # fresh prompts, half a chunk's worth of steps apart in length
    replay_srcs = prompts(np, SEED + 1, [64, SERVE["src_len"]]
                          * (N_REQUESTS // 2))
    runs = []
    launches = 0
    weights = None
    n_calls, n_merges = ragged_calls_per_step(fa, fa._sm_count(0))
    f32_growth = None
    for kv in KV_DTYPES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = make_generator("cuda", kv)
        if weights is None:
            g.init_params(seed=SEED)
            weights = fluid.scope_to_numpy(g.scope, list(g._param_vars()))
        else:
            g.load_params(weights)
        # the peak of building and loading, then serving's own over the
        # resident weights and pool
        resident = torch.cuda.memory_allocated()
        load_peak = torch.cuda.max_memory_allocated()
        pool = {n: (t, t.data_ptr()) for n, t in (
            (n, g.scope.find_var(n)) for n in (g._pool_name,
                                               g._scales_name))
                if t is not None}
        torch.cuda.reset_peak_memory_stats()
        rec, ok = serve_once(torch, np, fa, g, srcs)
        rec.update(kv_dtype=kv, card=card,
                   resident_gib=resident / 2**30,
                   pool_gib=g.cache_stats()["hbm"]["pool_bytes"] / 2**30,
                   load_peak_gib=load_peak / 2**30,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   peak_reserved_gib=torch.cuda.max_memory_reserved()
                   / 2**30,
                   graph=step_graph(g.exe))
        launches += rec["launches"]
        want = n_calls * rec["steps"]
        if not ok:
            failures.append(f"serving {kv}: {rec['finished']} of "
                            f"{rec['requests']} requests finished "
                            f"{rec['errors']}")
        if rec["launches"] != want or rec["steps"] == 0:
            failures.append(f"serving {kv}: {rec['launches']} kernel "
                            f"launches in {rec['steps']} steps, want {want}")
        if rec["executable_during_serve"]["misses"] != 0 \
                or rec["executable_during_serve"]["hits"] != rec["steps"] \
                or rec["executable"]["misses"] != 1:
            failures.append(f"serving {kv}: executable {rec['executable']}, "
                            f"during the run {rec['executable_during_serve']}"
                            f" in {rec['steps']} steps: want one miss (the "
                            f"warm-up's capture) and a hit every step")
        # the pool held once: the scope's pool is the tensor it was, and
        # every cached step's buffer; serving's own growth (one step's
        # activations, a cuBLAS workspace for each of two streams) is the
        # same at every pool dtype, so a second pool would add its bytes
        # to the float32 growth, or to another dtype's over that
        rec["pool_held_once"] = pool_held_once(g, pool)
        rec["serve_growth_gib"] = rec["peak_mem_gib"] - rec["resident_gib"]
        if kv == "float32":
            f32_growth = rec["serve_growth_gib"]
        over = rec["serve_growth_gib"] - (f32_growth if kv != "float32"
                                          else 0.0)
        if not rec["pool_held_once"] or not over < rec["pool_gib"]:
            failures.append(f"serving {kv}: pool held once "
                            f"{rec['pool_held_once']}; peak "
                            f"{rec['peak_mem_gib']} GiB over "
                            f"{rec['resident_gib']} resident grows by "
                            f"{over} GiB more than float32's, not less "
                            f"than the pool's {rec['pool_gib']} GiB")
        want_graph = {"ragged_split": n_calls, "ragged_merge": n_merges}
        if rec["graph"].get("by_family") != want_graph:
            failures.append(f"serving {kv}: captured graph {rec['graph']}, "
                            f"want kernel nodes {want_graph}")
        rec["replay_vs_eager"] = serving_replay_check(torch, g,
                                                      replay_srcs)
        if not rec["replay_vs_eager"]["ok"]:
            failures.append(f"serving {kv}: replay vs eager "
                            f"{rec['replay_vs_eager']}")
        runs.append(rec)
        del g, pool
        torch.cuda.empty_cache()
        log(f"served {kv}: {json.dumps(rec)}")

        # teacher-forced card vs CPU on the same feeds
        gpu = make_generator("cuda", kv)
        cpu = make_generator("cpu", kv)
        gpu.load_params(weights)
        cpu.load_params(weights)
        t0 = time.perf_counter()
        worst, agree = teacher_forced(np, gpu, cpu, srcs)
        rec["logits_max_abs_err_vs_cpu"] = worst
        rec["token_agreement_vs_cpu"] = agree
        log(f"teacher-forced {kv}: max |dlogit| {worst}, argmax agreement "
            f"{agree} ({time.perf_counter() - t0:.1f}s)")
        if not worst <= LOGIT_ATOL[kv]:
            failures.append(f"logits {kv}: card vs CPU max_abs_err {worst} "
                            f"> {LOGIT_ATOL[kv]}")
        del gpu, cpu
        torch.cuda.empty_cache()
    # the serving peak beside the parent's, each in a process of its own,
    # in turns (float32 pool; profile_serving.py)
    peaks = None
    if args.parent_package:
        peaks = [dict(serving_peak_subprocess(root), package=name)
                 for name, root in (("parent", args.parent_package),
                                    ("this", None), ("this", None),
                                    ("parent", args.parent_package))]
        for p in peaks:
            log(f"profile_serving ({p['package']}): {json.dumps(p)}")
        failures += in_turns_failures(peaks)

    # -- beam search on the paged engine, the dense generator, the full
    # re-run decoder
    t0 = time.perf_counter()
    # the teacher-forced logit error of each pool dtype: the float error
    # the beam's and the speculative streams' near ties are judged by
    logit_err = {r["kv_dtype"]: r["logits_max_abs_err_vs_cpu"]
                 for r in runs}
    beam, beam_launches, beam_err, beam_fails = beam_phase(
        torch, np, fluid, fa, card, weights, srcs, logit_err)
    failures += beam_fails
    launches += beam_launches
    max_err = max(max_err, beam_err)
    log(f"beam phase ({time.perf_counter() - t0:.1f}s): {json.dumps(beam)}")
    torch.cuda.empty_cache()

    # -- training: the program, one step card vs CPU, then the card alone
    t0 = time.perf_counter()
    main_prog, startup, loss = build_training(fluid, transformer)
    init = initial_scope(fluid, startup)
    log(f"built the training program ({len(main_prog.global_block().ops)} "
        f"ops) and its {len(init)} initial arrays in "
        f"{time.perf_counter() - t0:.1f}s")
    feed = train_feed(np, TRAIN_BATCH)
    step = compare_step(torch, np, fluid, main_prog, loss, init,
                        {k: v[:COMPARE_BATCH] for k, v in feed.items()})
    log(f"training step {COMPARE_STEP} card vs CPU and replay vs eager: "
        f"{json.dumps(step)}")
    if not (step["replay_ok"] and step["loss_rel_err"] <= STEP_LOSS_RTOL
            and step["grad_rel_err"] <= STEP_GRAD_RTOL
            and step["param_max_abs_err"] <= STEP_PARAM_ATOL
            and step["update_rel_err"] <= STEP_UPDATE_RTOL
            and step["update_checked_share"] >= UPDATE_MIN_SHARE):
        failures.append(f"training step card vs CPU: {step}")
    torch.cuda.empty_cache()
    training, scope = train_on_card(torch, fluid, fa, main_prog, loss, init,
                                    feed)
    training.update(card=card, compare=step)
    log(f"training: {json.dumps(training)}")
    want = {k: ATTN_PER_STEP * TRAIN_STEPS for k in ("fwd", "dq", "dkv")}
    if training["launches_by_dtype"]["float32"] != want \
            or training["launches"] != want:
        failures.append(f"training: flash launches "
                        f"{training['launches_by_dtype']} in {TRAIN_STEPS} "
                        f"steps, want {want} on float32 inputs")
    per_step = {k: ATTN_PER_STEP for k in ("fwd", "dq", "dkv")}
    failures += graph_failures("training", training, TRAIN_STEPS, per_step)
    if not (np.isfinite(training["losses"]).all()
            and training["losses"][-1] < training["losses"][0]):
        failures.append(f"training: loss did not fall: "
                        f"{training['losses']}")

    # -- serve what was trained: the scope's parameters, by name
    params = [p.name for p in main_prog.global_block().all_parameters()]
    trained = fluid.scope_to_numpy(scope, params)
    del scope
    torch.cuda.empty_cache()
    g = make_generator("cuda", "float32")
    n_loaded = g.load_params(trained)
    rec, ok = serve_once(torch, np, fa, g, srcs[:N_TRAINED_REQUESTS])
    rec.update(kv_dtype="float32", weights="trained", loaded=n_loaded)
    launches += rec["launches"]
    log(f"served the trained scope: {json.dumps(rec)}")
    if not ok or rec["launches"] != ATTN_PER_STEP * rec["steps"] \
            or rec["steps"] == 0 \
            or rec["executable_during_serve"]["misses"] != 0:
        failures.append(f"serving the trained scope: {rec}")
    runs.append(rec)
    del g
    torch.cuda.empty_cache()

    # -- the bf16 recipe: one step card vs CPU, then the card alone
    t0 = time.perf_counter()
    amp_prog, amp_startup, amp_loss = build_training(fluid, transformer,
                                                     AMP)
    if amp_startup.desc.fingerprint() != startup.desc.fingerprint():
        failures.append("amp training: its startup program differs from "
                        "the float32 program's")
    amp_step = compare_amp_step(
        torch, np, fluid, amp_prog, amp_loss, main_prog, loss, init,
        {k: v[:COMPARE_BATCH] for k, v in feed.items()})
    log(f"amp training step {COMPARE_STEP} card vs CPU and replay vs eager "
        f"({time.perf_counter() - t0:.1f}s): {json.dumps(amp_step)}")
    if not amp_step_ok(amp_step):
        failures.append(f"amp training step card vs CPU: {amp_step}")
    torch.cuda.empty_cache()
    training_bf16, scope = train_on_card(torch, fluid, fa, amp_prog,
                                         amp_loss, init, feed)
    del scope
    torch.cuda.empty_cache()
    training_bf16.update(card=card, amp_dtype=AMP, compare=amp_step)
    log(f"training_bf16: {json.dumps(training_bf16)}")
    per_run = {k: ATTN_PER_STEP * TRAIN_STEPS for k in ("fwd", "dq", "dkv")}
    if training_bf16["launches_by_dtype"] != {
            "float32": {k: 0 for k in per_run}, "bfloat16": per_run}:
        failures.append(f"amp training: flash launches by input dtype "
                        f"{training_bf16['launches_by_dtype']} in "
                        f"{TRAIN_STEPS} steps, want {per_run} on bf16 "
                        f"inputs and none on float32")
    failures += graph_failures("amp training", training_bf16, TRAIN_STEPS,
                               per_step)
    if not (np.isfinite(training_bf16["losses"]).all()
            and training_bf16["losses"][-1] < training_bf16["losses"][0]):
        failures.append(f"amp training: loss did not fall: "
                        f"{training_bf16['losses']}")

    # -- the book's first two chapters
    book = {"card": card}
    for program, steps in (("fit_a_line", FIT_STEPS),
                           ("conv_net", DIGITS_STEPS),
                           ("bf16_conv_net", DIGITS_STEPS)):
        rec, ok = book_phase(torch, np, fluid, program, steps)
        book[program] = rec
        log(f"book {'ok  ' if ok else 'FAIL'} {json.dumps(rec)}")
        if not ok:
            failures.append(f"book {program}: {rec}")
        # no kernel of this repo on these paths
        failures += graph_failures(f"book {program}", rec, steps, {})
    modes, ok = executor_modes(torch, np, fluid)
    book["executor_modes"] = modes
    log(f"executor modes {'ok  ' if ok else 'FAIL'} {json.dumps(modes)}")
    if not ok:
        failures.append(f"executor run_steps / run_pipeline / two scopes "
                        f"on the card: {modes}")
    torch.cuda.empty_cache()

    # -- timings at the paths' shapes: the ragged kernel on the device
    # clock (a CUDA graph of 200 calls), through the wrapper one call at
    # a time (ms_eager), the parent's kernel by the same graph method,
    # and the plain version
    parent = None
    if args.parent_ragged:
        parent = build_parent_ragged(args.parent_ragged)
        log(f"built the parent's ragged kernel from {args.parent_ragged}")
    floor_ms = launch_floor_ms(torch, fa, 200)
    timing = []
    for kv, (pool, scales) in pools.items():
        for name, case in cases.items():
            dev_ms = graph_ms(torch, case_calls(fa, case, pool, scales, 200))
            eager = time_case(torch, fa, case, pool, scales, False, 200)
            pms = time_case(torch, fa, case, pool, scales, True, 20)
            dev_ms2 = graph_ms(torch, case_calls(fa, case, pool, scales,
                                                 200))
            par = (graph_ms(torch, parent_calls(torch, parent, fa, case,
                                                pool, scales, 200))
                   if parent is not None else None)
            b_ms, b_by = bound(case, pool, scales)
            per_call = device_kernels_per_call(
                torch, case_calls(fa, case, pool, scales, 16))
            pps, splits = fa.ragged_decode_attention.last_plan
            timing.append({"kv_dtype": kv, "case": name, "ms": dev_ms,
                           "ms_repeat": dev_ms2, "ms_eager": eager,
                           "parent_ms": par, "plain_ms": pms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "launch_floor_ms": floor_ms,
                           "pages_per_split": pps, "splits": splits,
                           "device_kernels_per_call": per_call})
            if per_call != (1 if splits == 1 else 2):
                failures.append(f"ragged {kv}/{name}: {per_call} device "
                                f"kernels a call at {splits} splits")
    del pools
    torch.cuda.empty_cache()
    wide_rows = flash_wide_timings(torch, fa, dev, gen)
    flash_rows, flash_sdpa = {}, {}
    int_ops = int32_ops_per_s(torch)
    parent_flash = None
    if args.parent_flash:
        parent_flash = build_parent_flash(args.parent_flash)
        log(f"built the parent's flash forward"
            f"{' and backward' if parent_flash['bwd'] else ''} from "
            f"{args.parent_flash}")
    log(f"int32 rate (SMs x {INT32_LANES_PER_SM} x max SM clock): "
        f"{int_ops:.4g} ops/s")
    for dt in ("float32", "bfloat16"):
        rows, checks, sdpa = flash_timings(
            torch, fa, dev, gen, dt, int_ops,
            parent_flash if dt == "bfloat16" else None)
        flash_rows[dt], flash_sdpa[dt] = rows, sdpa
        for causal, by_backend in sdpa.items():
            log(f"sdpa {dt} {'causal' if causal else 'full'}: "
                f"{json.dumps(by_backend)}")
        for name, errs, ok in checks:
            log(f"flash {'ok  ' if ok else 'FAIL'} {dt} {name} "
                f"{json.dumps(errs)}")
            for t, e in errs.items():
                flash_err[(dt, owner[t])] = max(flash_err[(dt, owner[t])],
                                                e)
            if not ok:
                failures.append(f"flash entry point vs plain {dt} {name}: "
                                f"{errs}")
    fp32 = [t for t in timing if t["kv_dtype"] == "float32"]
    b_bytes = sum(t["bound_ms"] for t in fp32 if t["bound_by"] == "bytes")
    b_ops = sum(t["bound_ms"] for t in fp32 if t["bound_by"] != "bytes")
    by_case = {t["case"]: t for t in fp32}
    kernels = [{
        "name": fa.KERNEL_NAME,
        "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:181",
        "launches": launches,
        "launches_beam": beam_launches,
        "max_abs_err": max_err,
        # one call of each of the step's three shapes, float32 pool, on
        # the device clock; ms_eager through the wrapper call by call
        "ms": sum(t["ms"] for t in fp32),
        "plain_ms": sum(t["plain_ms"] for t in fp32),
        "bound_ms": b_bytes + b_ops,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "ms_eager": sum(t["ms_eager"] for t in fp32),
        "parent_ms": (sum(t["parent_ms"] for t in fp32)
                      if parent is not None else None),
        "launch_floor_ms": floor_ms,
        # device kernels one call runs: kernel nodes of a CUDA graph of
        # 16 calls, over 16
        "kernels_per_call": {c: t["device_kernels_per_call"]
                             for c, t in by_case.items()},
        "ms_by_case": {f"{t['kv_dtype']}/{t['case']}": t["ms"]
                       for t in timing},
        "extra_grids": extra_grids,
        "parent_ms_by_case": ({f"{t['kv_dtype']}/{t['case']}":
                               t["parent_ms"] for t in timing}
                              if parent is not None else None),
    }]
    replaces = {"fwd": 527, "dq": 743, "dkv": 788}
    # float32 rows: the float32 training run's launches; bfloat16 rows
    # (the same kernels' bf16 instantiations): the amp training run's
    for dt, run, suffix in (("float32", training, ""),
                            ("bfloat16", training_bf16, "_bf16")):
        rows = flash_rows[dt]
        for k in ("fwd", "dq", "dkv"):
            # per call, averaged over the training step's mix of 12 full
            # and 6 causal attentions
            def mix(key, k=k, rows=rows):
                full, causal = rows[(k, False)], rows[(k, True)]
                return ((ATTN_PER_STEP - CAUSAL_PER_STEP) * full[key]
                        + CAUSAL_PER_STEP * causal[key]) / ATTN_PER_STEP

            by = {rows[(k, c)]["bound_by"] for c in (False, True)}
            pass_ = "fwd" if k == "fwd" else "bwd"
            by_backend = backend_mix(flash_sdpa[dt], pass_)
            lib_name, lib_ms = fastest_backend(by_backend)
            by_backend["DEFAULT_eager"] = backend_mix(
                {c: {"DEFAULT": r["DEFAULT"]} for c, r in
                 flash_sdpa[dt].items()}, f"{pass_}_eager")["DEFAULT"]
            # the dropout hash's share: the kernel at the step's dropout
            # less the kernel at 0
            extra = {"ms_dropout0": mix("ms_dropout0"),
                     "hash_ms": mix("ms") - mix("ms_dropout0"),
                     "bound_dropout0_ms": mix("bound_dropout0_ms")}
            if k == "fwd":
                extra.update(ms_eager=mix("ms_eager"),
                             host_ms=mix("host_ms"))
            extra.update({n: mix(n) for n in rows[(k, False)]
                          if n.startswith("parent_")})
            extra["device_kernels"] = sorted(
                set(rows[(k, False)]["device_kernels"])
                | set(rows[(k, True)]["device_kernels"]))
            if dt == "float32":
                extra.update(bound_fp32_ms=mix("bound_fp32_ms"),
                             ms_by_width={f"D{d}": r[k]
                                          for d, r in wide_rows.items()})
            else:
                extra.update(bound_tf32_ms=mix("bound_tf32_ms"))
            kernels.append({
                "name": f"flash_attention_{k}{suffix}",
                "route": "cuda",
                "source": f"paddle_tpu_torch/kernels/csrc/"
                          f"{fa.FLASH_KERNELS[k]}.cu",
                "replaces": f"paddle_tpu/kernels/flash_attention.py:"
                            f"{replaces[k]}",
                "launches": run["launches_by_dtype"][dt][k],
                "max_abs_err": flash_err[(dt, k)],
                "ms": mix("ms"), "plain_ms": mix("plain_ms"),
                "bound_ms": mix("bound_ms"),
                "bound_by": by.pop() if len(by) == 1 else "operations",
                "library_ms": lib_ms, "library_backend": lib_name,
                "library_ms_by_backend": by_backend, **extra})
    for t in timing:
        log(json.dumps(t))
    for rows in flash_rows.values():
        for r in rows.values():
            log(json.dumps(r))

    # -- the LSTM text classifiers: kernel checks, training, timings
    lstm_rec, lstm_entry = lstm_phases(torch, np, fluid, lk, dev, gen,
                                       failures)
    lstm_rec["card"] = card
    kernels.append(lstm_entry)

    # -- image classification: no kernel of this repo on its path
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    image, image_fails = image_phase(torch, np, fluid, card)
    failures += image_fails
    log(f"image phase ({time.perf_counter() - t0:.1f}s)")

    # -- sparse embeddings and the book's embedding chapters: no kernel of
    # this repo on their paths
    torch.cuda.empty_cache()
    sparse, sparse_fails = sparse_phase(torch, np, fluid, card)
    failures += sparse_fails
    log(f"sparse phase ({sparse['seconds']:.1f}s)")

    # -- control flow and the seq2seq models: the LSTM kernel in each
    # encoder, the decode loop driven from the host
    torch.cuda.empty_cache()
    nmt, nmt_launches, nmt_fails = nmt_phase(torch, np, fluid, card)
    failures += nmt_fails
    lstm_entry["launches"] += nmt_launches
    lstm_entry["launches_seq2seq"] = nmt_launches
    log(f"nmt phase ({nmt['seconds']:.1f}s)")

    # -- semantic role labeling and the evaluators: the LSTM kernel in
    # each of db_lstm's 8 layers, H = 128
    torch.cuda.empty_cache()
    srl, srl_launches, srl_cell, srl_fails = srl_phase(torch, np, fluid, lk,
                                                       card)
    failures += srl_fails
    lstm_entry["launches"] += srl_launches
    lstm_entry["launches_srl"] = srl_launches
    # the SRL path's own call: H = 128, relu / sigmoid / sigmoid, ragged
    lstm_entry["srl_cell"] = srl_cell
    log(f"srl phase ({srl['seconds']:.1f}s)")

    # -- speech recognition with CTC and MobileNet-SSD: no kernel of this
    # repo on their paths; then the slice's ops off both paths
    torch.cuda.empty_cache()
    speech, speech_fails = speech_phase(torch, np, fluid, card)
    failures += speech_fails
    log(f"speech phase ({speech['seconds']:.1f}s)")
    torch.cuda.empty_cache()
    ssd, ssd_fails = ssd_phase(torch, np, fluid, card)
    failures += ssd_fails
    t0 = time.perf_counter()
    ssd["ops"] = slice_op_checks(torch, np, failures)
    log(f"ssd phase ({ssd['seconds']:.1f}s), op check "
        f"({time.perf_counter() - t0:.1f}s): {json.dumps(ssd['ops'])}")

    # -- Fast R-CNN and learning to rank: no kernel of this repo on their
    # paths; then the slice's ops at realistic shapes
    torch.cuda.empty_cache()
    frcnn, frcnn_fails = frcnn_phase(torch, np, fluid, card)
    failures += frcnn_fails
    log(f"frcnn phase ({frcnn['seconds']:.1f}s)")
    torch.cuda.empty_cache()
    ranking, ranking_fails = ranking_phase(torch, np, fluid, card)
    failures += ranking_fails
    log(f"ranking phase ({ranking['seconds']:.1f}s)")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranking["loss_misc_ops"] = loss_misc_op_checks(torch, np, failures)
    log(f"loss and misc op check ({time.perf_counter() - t0:.1f}s): "
        f"{json.dumps(ranking['loss_misc_ops'])}")

    # -- speculative and constrained decoding; the host tier and
    # sessions: the ragged kernel in the verify and draft steps
    torch.cuda.empty_cache()
    spec_rec, spec_launches, spec_fails = speculative_phase(
        torch, np, fluid, fa, card, weights, srcs, logit_err)
    failures += spec_fails
    log(f"speculative phase ({spec_rec['seconds']:.1f}s)")
    tiers, tier_launches, tier_fails = tier_phase(torch, np, fluid, fa,
                                                  card, weights)
    failures += tier_fails
    log(f"tier phase ({tiers['seconds']:.1f}s): {json.dumps(tiers)}")
    kernels[0]["launches"] += spec_launches + tier_launches
    kernels[0]["launches_speculative"] = spec_launches
    kernels[0]["launches_tiers"] = tier_launches
    # a verify step's ragged launches (its prefill tower and its
    # k+1-query decode) and a 1-layer draft step's, over their steps in
    # phase 25's float32 run, and their graphs' ragged nodes
    kernels[0].update(spec_rec["per_step"])

    print(json.dumps({"serving": {"card": card, "runs": runs,
                                  "profile_in_turns": peaks}}), flush=True)
    print(json.dumps({"beam": beam}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"training_bf16": training_bf16}), flush=True)
    print(json.dumps({"book": book}), flush=True)
    print(json.dumps({"lstm": lstm_rec}), flush=True)
    print(json.dumps({"image": image}), flush=True)
    print(json.dumps({"sparse": sparse}), flush=True)
    print(json.dumps({"nmt": nmt}), flush=True)
    print(json.dumps({"srl": srl}), flush=True)
    print(json.dumps({"speech": speech}), flush=True)
    print(json.dumps({"ssd": ssd}), flush=True)
    print(json.dumps({"frcnn": frcnn}), flush=True)
    print(json.dumps({"ranking": ranking}), flush=True)
    print(json.dumps({"speculative": spec_rec}), flush=True)
    print(json.dumps({"tiers": tiers}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"chip_smoke: all phases in {time.perf_counter() - started:.1f}s")
    if failures:
        for f in failures:
            log(f"chip_smoke: FAIL: {f}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
