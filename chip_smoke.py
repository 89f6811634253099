#!/usr/bin/env python3
"""Drive the PyTorch port (``ddl_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root; needs a CUDA card and nvcc
    python3 chip_smoke.py --only 8,11   # the set-up and those phases alone
                                        # (no kernel table, no last line)

Phases (any failed check raises, and the script exits nonzero):

1. Set-up: the card's name and power limit, the PyTorch/CUDA versions, the
   kernels built from ``ddl_tpu_torch/csrc/`` into ``build/ddl_tpu_torch/``
   (one ``nvcc`` per source, in parallel).  TF32 is switched off for
   cuDNN and cuBLAS so the plain versions' f32 products are exact.
2. Kernels: each kernel against its plain PyTorch version at the shapes
   the slice gives it, then timed (kernel, plain version, one library call
   where one computes the same function) beside its bound, the least time
   the card could take for the same work.  Device times are the union of
   the profiler's kernel intervals: the dense-block kernels launch as
   programmatic dependents, so each may start while the one before it
   finishes.
3. Eval slice: ``Trainer(cfg).evaluate(0)`` on DenseNet121 at full width
   with the fused configuration (bf16, fused blocks 1 and 4, kernel
   normalize) over a synthetic eval set whose last batch is
   sentinel-padded.  The launch counters are zeroed just before and read
   just after this run; the logits are then held against the same model
   run through the plain versions on the card, and the eval step's device
   busy time is measured with the fused blocks and with the packed ones
   (cuDNN convolutions).
4. Train slice: ``Trainer(cfg).train(1)`` on the same configuration, five
   steps of 30 images and the eval pass, counters zeroed just before and
   read just after; then one train step through the kernels against one
   through the plain versions from the same weights (loss, every
   parameter's gradient, the running statistics), and the train step
   timed on device-resident batches, fused and with the packed blocks.
5. LM decode slice: ``make_lm_generator`` on the 124M transformer LM
   (``ddl_tpu/bench/decode.py``'s configuration) at full width with the
   port's seeded init, in three variants: A, MHA with a bf16 cache, batch
   8, a 2048-token prompt through the flash kernel and 32 greedy tokens;
   B, GQA 12q/4kv with the int8 cache, batch 32, 1024 + 32; C, the
   bench's ``--quant kv+w`` (int8 weights from ``quantize_lm_params`` and
   the int8 cache), GQA 12q/4kv with a 1024-token window (the rolling
   ring), batch 1, 4096 + 32 (128 before the serving phase needed the
   time, A and B halved likewise; A and C 64 before ZeRO's and the HBM
   ledger's checks).  Counters zeroed just before and read just after
   each run (flash 12 and decode 384; flash 12 and int8 decode 384; flash
   12, int8 decode 384 and the int8 matmul 2337: 72 products a token and
   the head once a step and once at the prefill).  The kernel
   path is then held against the plain path and an f32 plain path by
   teacher forcing the generated tokens through ``LMDecode``; prefill ms,
   decode ms/token by the slope between two lengths at equal capacity,
   the decode step's device busy share, and (after A) the dense-vs-flash
   prompt-pass sweep behind ``FLASH_AUTO_MIN_T``.  Then
   ``bench/decode.py`` at C's B=1 configuration with ``kv`` (bf16 weights)
   and ``kv+w`` (int8 weights) in turns: kv, kv+w, kv+w, kv.

6. LM train slice: the 124M LM (``ddl_tpu/bench/lm.py:79-99`` at its
   defaults with ``--flash``: batch 8 x 1024, full remat, AdamW 3e-4 with
   optax's weight decay 1e-4) from ``init_lm_weights(seed 0)``.  One train
   step's loss and gradients through the kernels, through the plain
   versions and through the plain versions in f32; then
   ``LMTrainer(...).train()`` on the synthetic Markov stream for 20 steps,
   counters zeroed just before and read just after (flash forward 24 per
   step: remat recomputes each layer's forward once; dQ and dK/dV 12 per
   step), the loss finite and falling; the step timed as
   ``ddl_tpu_torch/bench/lm.py`` times it, with its device busy share and
   top kernels; and the flash-vs-dense train-step sweep at 8192 tokens per
   step behind ``FLASH_AUTO_MIN_T``.
7. The chunked head+CE losses and mixture-of-experts (prints its own
   seconds).  (a) The loss edge at the 124M train shape (hidden (8, 1024,
   768) f32, the f32 head (50304, 768), TF32 off): the dense CE,
   ``fused_chunked_ce(256)`` and ``fused_vocab_chunked_ce(8384)`` forward
   and backward, each held to the dense one (loss 1e-5 relative, dhidden
   and dW 1e-4 of their largest dense value, accuracy equal), each one's
   peak memory above its start (a chunked one at most half the dense
   one's) and device time.  (b) Phase 6's configuration with
   ``ce_chunk=256`` and with ``ce_vocab_chunk=8384``: one train step
   through the kernels, the plain versions and the plain versions in f32
   (phase 6's limits), then ``bench_lm`` beside phase 6's dense row with
   the step's busy time and top kernels.  (c) The 124M MoE (8 experts,
   top-2, capacity factor 1.5, groups of 256: the einsum dispatch at
   capacity 96; d_ff 1536, batch 16 x 1024): one train step three ways
   with the share of routing decisions that differ between the kernel and
   the plain path, ``LMTrainer.train()`` for 12 steps with
   ``capacity_anneal_step=10`` (counters flash forward 288, dQ 144, dK/dV
   144; loss finite and falling; the router metrics at each log period;
   the anneal to capacity 64), then ``bench_lm`` with the einsum and the
   sort dispatch and the dense model at batch 16, each step's device busy
   time beside its wall.  (d) MoE decode from
   the (c) model's seed-0 weights, batch 8, a 1024-token prompt through
   flash and 8 greedy tokens (64 before the pipelines' checks, 32 before
   the serving phase and 16 before ZeRO's and the HBM ledger's checks
   needed the time): D with the bf16 cache (flash 12, decode 96), E with
   ``quantize_lm_params`` weights, expert banks included, and the int8
   cache (flash 12, int8 decode 96, int8 matmul (4 L + 1) n + 1:
   the attention's four products per layer and the head each step, and
   the prefill's head), each as phase 5's variants are checked and timed.
8. DenseNet121 training that survives its failures (prints its own
   seconds), phase 4's fused configuration for 2 epochs of 5 steps, async
   snapshots, ``keep_snapshots=1``, events on, ``DDL_WATCHDOG_S=120``.
   (a) ``DDL_FAULT=preempt@step:7``: the run is preempted, ``epoch_0``
   (the best-QWK save) and ``epoch_1`` (the preemption save) verify, and
   the cursor is ``{period 1, offset 3}``.  (b) A new Trainer of the same
   job id resumes by itself at epoch 1, batch 3, with every parameter,
   running statistic, Adam moment and step and the schedule's count
   bit-equal to (a)'s state at its save, and trains exactly epoch 1's last
   2 batches.  (c) The same run uninterrupted with ``log_gradient_stats``:
   (a)+(b) consumed its batches epoch by epoch, (b)'s epoch-1 loss is
   within phase 4's loss limit of (c)'s over the same batches and the final
   parameters within its gradient-style limit (printed, with whether they
   are bit-equal), and ``gradient.csv`` has steps x parameters rows of 14
   columns.  (c) also runs under ``DDL_FAULT=leak@step:6:256``: its HBM
   ledger holds one ``hbm_plan`` (the train step's first dispatch, with
   the allocator's peak) and one ``hbm_sample`` an epoch from the card's
   allocator (``synthetic: false``) booking the parameters and Adam's
   moments, the epoch-1 watermark 256 MiB above epoch 0's (within the
   allocator's 2 MiB rounding).  (d) ``nan_policy="recover"`` with ``DDL_FAULT=nan@step:6``:
   one ``rollback`` event, the state after it bit-equal to the ``epoch_0``
   file, one eval batch's logits through #2 right after it bit-equal to a
   fresh Trainer's resumed from ``epoch_0``, the grace epoch's updates at
   0.1x the schedule and 1x after, the loss finite.  (e) Snapshot bytes,
   the loop's ms per save and the background write's, the restore's, each
   period's phase split from ``events.jsonl``, and the step wall with and
   without a save in flight.  (f) The OOM drill in a child process
   (``--oom-child``): a phase-8 Trainer capped by
   ``torch.cuda.set_per_process_memory_fraction`` at the bytes in use plus
   1024, 256, then 64 MiB until a train step fails; the child must exit
   nonzero with one ``hbm_oom_dump`` (the failure, the watermark, the
   resident tensors, the tracked bytes) in its events; it runs beside
   phase 11's two-rank world (which times nothing that counts), and its
   check is printed there.  The counters are zeroed just before and read
   just after each ``train()``; each run's launches must be what its steps
   and eval batches account for.
9. The LM trainer that survives its failures on a real corpus (prints its
   own seconds): a byte corpus built from this checkout by
   ``tools/repo_corpus.build_corpus`` (into a temporary directory outside
   the tree), the 124M width of phase 6 with GQA 12q/4kv and vocab 256,
   flash, bf16 over f32 masters, full remat, batch 16 x 1024, AdamW 3e-4,
   held-out eval and synchronous snapshots every 20 steps, 60 steps,
   events on, ``DDL_WATCHDOG_S=120``.  (a) ``DDL_FAULT=preempt@step:33``:
   snapshots at steps 20 and 34 verify, the cursor has the step and the
   shuffle position.  (b) A new ``LMTrainer`` of the same job id resumes by
   itself at step 34 with every parameter, Adam moment and step, the
   optimizer count and the step bit-equal to (a)'s state at its save, and
   trains exactly steps 34-59.  (c) The same run uninterrupted: (a)+(b)
   consumed its token batches step by step, (b)'s losses within phase 6's
   loss limit of (c)'s and the final parameters within its gradient-style
   limit (both printed with whether they are bit-equal), the held-out
   perplexity finite and falling.  (d) ``nan_policy="recover"`` with
   ``DDL_FAULT=nan@step:25``: one ``rollback`` to step 20, the state after
   it bit-equal to the file, the window after it at 0.1x the schedule and
   1x after, the loss finite.  (e) ``bench/decode_quality.main`` on (c)'s
   last snapshot at ``--batch 8`` (so ``kv+w``'s decode products take #9):
   its ``heldout_ppl`` and two ``greedy_agreement`` lines, every number
   finite.  (f) ``examples.train_lm.main`` at d_model 512 (8 heads of 64)
   with ``--flash on`` and a checkpoint directory for 6 steps, then
   ``examples.generate_lm.main`` from its snapshot with the bf16 cache and
   with ``--int8 kv+w``.  (g) ``nan@grad:5`` under ``nan_policy="recover"``,
   8 steps in windows of 2 with snapshots at 4 and 8: the step is built
   with the fault live, so step 5's gradients are NaN inside the step; one
   rollback to step 4, the replayed window at 0.1x and then 1x (the grace
   window's rebuild of the step finds the fault consumed), the weights and
   the last loss finite.  The counters are zeroed just before and read
   just after each run; #4-#6 must launch as the train steps and eval
   batches account for, #7-#9 as the generators' steps, layers and
   products.  Snapshot bytes, each save's wall, the restore's, each
   window's phase split from ``events.jsonl`` and the train ms/step with
   and without the snapshots' checkpoint phases are printed.
10. The command line on image files (prints its own seconds): phase 4's
   fused configuration through ``ddl_tpu_torch.cli.main`` for 2 epochs
   over an APTOS-layout tree written into a temporary directory (``train.
   csv`` and ``test.csv`` beside ``train_images/`` and ``test_images/``:
   the synthetic set's first 90 and 60 images as 8-bit RGB PNG files, by
   the phase's own writer on ``zlib`` and ``struct``).  (a) The tree.  (b)
   The native decoder (``ddl_tpu_torch/native``) built beside (a), with
   its build time, the probe's findings and the PNG route it took; ``load_batch`` of
   30 files bit-equal to the synthetic arrays; the decode of 30 files and
   the pinned host-to-device copy of the batch timed (medians of 5).  (c)
   ``cli.main`` in this process on the files: the loss and QWK CSVs finite
   for both epochs, #1-#3 launched as the 6 steps and 4 eval batches
   account for, every batch decoded natively and none through PIL.  (d)
   The same command over the in-memory synthetic set for one epoch (cut
   from two for the phase's time): its epoch loss and its final state
   (parameters, statistics, Adam moments) bit-equal to (c)'s at the end of
   that epoch.  (e) ``python -m ddl_tpu_torch.cli train --supervise
   --max-restarts 2`` on the files in a subprocess with
   ``DDL_FAULT=preempt@step:4``: exit 0, the job's events hold
   ``supervisor_start``, one ``supervisor_relaunch`` on ``preempt``,
   ``supervisor_done`` with rc 0, one ``snapshot_restore`` at the
   preemption's cursor and ``restart_latency`` (printed: the child's exit
   to its first step); the run's last snapshot bit-equal to (c)'s state at
   the snapshot's cursor, and each epoch's last ``val_loss`` and ``qwk``
   bit-equal to (c)'s.
11. Data parallelism (prints its own seconds): a world of two ranks on the
   one card, each a process started by ``launch.spawn_local`` and joined
   over gloo (``launch.bootstrap(backend="gloo")``: NCCL refuses two ranks
   on one GPU), the ``dp`` preset's shape of 2 x 15 images.  (a) DenseNet121
   in f32 with the packed blocks from ``init_weights(0)``: 2 SGD steps of 30
   images and an eval pass over 60, against the same run in this process:
   the first step's loss within 1e-5 relative, the parameters and the
   BatchNorm running statistics within 1e-4 of the largest; the second step's loss and the eval logits within 1e-5
   and 1e-4 of the largest, or twice the f32 noise floor where that is
   larger: how far the one-process run moves when each batch's rows are
   reversed (the same math, summed in another order).  (b) Phase 4's
   fused configuration through ``cli.main(["--preset", "dp", ...])``, one
   epoch of 3 steps and the eval over ``EVAL_SET`` images, the counters
   zeroed just before and read just after on each rank: each rank's
   launches of #1-#3 what its steps and eval batches account for, the
   epoch loss finite and within 1e-2 of the single preset's run in this
   process, QWK over every test image once; each rank's step wall with
   every BatchNorm all-reduce timed from a synchronised device, and the
   all-reduces' share of it, printed as the gloo one-card world's, which
   is no speed figure.  Then pipeline parallelism in the same two ranks,
   each a stage of the ``pp`` preset's (1, 2) mesh (DenseNet121 cut at
   denseblock3), the handoff over gloo through a host copy (its transport
   printed): (c) the f32 packed DenseNet121, 2 SGD steps of 30 images in
   5 microbatches with remat and the eval of 60, under GPipe and under
   1F1B, against the same microbatched math run in this process (cuDNN's
   deterministic algorithms on both sides): every loss within 1e-5
   relative, the parameters and running statistics within 1e-4 of the
   largest, the eval logits within 1e-4 of the largest or twice the floor
   of the data rows' summation order (the one-process math with its rows
   in the other order) where larger, and GPipe against 1F1B within 1e-6;
   (d) the fused configuration through ``cli.main(["--preset",
   "pp", ...])``, one epoch of 3 steps and the eval, counters zeroed just
   before and read just after on each rank: stage 0's launches of #2 and
   #3 those of block 1 and stage 1's those of block 4 for 5 microbatches a
   step, twice in the forward (remat) and once in the backward, and none
   of #1 (the pipeline normalizes with the plain divide, as the JAX
   package's does); the epoch loss finite and within 1e-2 of the same
   microbatched math in this process (a ``single`` Trainer taking each
   batch's 5 microbatches in order; the single preset's run, whose
   BatchNorm normalizes by 30 images' statistics, is printed beside it),
   QWK over every test image once.  Last, (e) a world of
   four ranks on the card, the ``dp_pp`` preset's (2, 2) mesh: (c) for
   both schedules against the two data rows' math in this process, after
   every rank's result is read and data row 1's losses, parameters,
   running statistics and eval logits are required to equal row 0's bit
   for bit.  Between (b) and (c), ZeRO-1 in the same two ranks: (f)
   ``bench/dp.zero_parity`` (f32 packed DenseNet121, Adam, 15 images a
   rank): the reduce-scatter's gradient shard within the f32 reordering
   bound of the replicated all-reduce's slice, the sharded update bit-equal
   to the replicated one given its gradients, and 2 whole steps of each
   from the same weights bit-equal (at two ranks each element's sum is one
   addition); (g) (b)'s command line with ``train.zero_sharding=true``:
   #1-#3 launched as (b)'s steps and eval batches account for, one
   reduce-scatter a step, each rank's optimizer bytes 28,191,016 against
   (b)'s 55,671,848, the epoch loss within 1e-2 of (b)'s; (h) (g)'s
   snapshot loaded by a replicated Trainer and (b)'s by a ZeRO one, each
   state right after the load bit-equal to the file.
12. The continuous-batching serving engine (``ddl_tpu_torch/serve/``;
   prints its own seconds) on phase 5's 124M LM with ``flash="auto"``:
   block size 16, 8 lanes, 8 steps per dispatch, 288 blocks (every lane's
   full reservation), clients from serve-bench's own generator, all at
   t0.  (a) The bf16 pool: 16 clients, prompts 64:512, 32:64 new tokens;
   (b) 8 clients of 64:512 and 8:16, ``kv_quant`` with GQA 12q/4kv
   (weights cut from the MHA draw: each layer's first 4 K/V heads); (c)
   (b) with int8 weights (``quantize_lm_params``), so the decode products
   take #9 at M = 8; (d) ``shared-prefix``, 8 clients, a 256-token prefix
   and tails of 16:64, 8:16 new tokens, the prefix cache on and off; (e)
   ``long-prompt``, one 2048-token prompt among 15 of 16:64, 8:16 new
   tokens, at ``prefill_chunk`` 256 and 2048; (f) (a)'s clients parked by
   ``drain(park=True)`` once the queue is empty, then
   ``resume_parked()``.  (a)-(c) first run every reachable shape once
   (``precompile``).  Each run serves with the counters zeroed just before
   and read just after: #4 launched 12 times for each whole-prompt prefill
   at a bucket of 256 or more, #7 (or #8) 12 times a decode step, #9 73
   times a step and once for each prefill's head.  Each run's tokens are
   held against the sequential generator at equal settings ((d) also
   against the cache-off run, (f) against (a)): a stream that is not
   bit-identical is teacher-forced (the engine's own logits, kept by
   forward hooks, against the plain versions and the plain versions in f32
   along its tokens: phase 5's three limits), and the share that is
   bit-identical is printed.  Each run prints its aggregate tokens/s, the
   p50/p95/p99 of latency, queue delay, TTFT and tokens/s of its warm
   requests, pool occupancy, the prefix hit rate, the prefill tokens
   computed and the ratio to the sequential replay (one pass of it, each
   request's first run); (a) also one ``hbm_sample`` from the card's
   allocator with the pool's cached, private and free blocks, which sum to
   the pool; (e) the short requests' queue delay; (a)-(c) one
   8-step dispatch's wall, device busy share and top kernels, and (c)'s #9
   time a step beside (b)'s cuBLAS products.  Last, the entry points, 8
   clients each: ``python -m ddl_tpu_torch.cli serve-bench`` in process at
   the 124M width with 2 layers (its vocab of 256 bytes) and
   ``examples.serve_lm --int8 kv+w`` on phase 9's ``train_lm`` snapshot.
13. Pod supervision across hosts (prints its own seconds).  (a)
   ``bench/pod.py``'s crash drill through the user's command, ``python -m
   ddl_tpu_torch.cli train --supervise --pod DIR --hosts 2 --host-id
   0|1``: two hosts of one rank each, both on the one card over gloo
   (``DDL_DIST_BACKEND``), phase 11 (b)'s fused configuration for 2
   epochs of 3 global steps of 30 and the eval of 100, whole and, beside
   it, with ``DDL_FAULT=crash@step:4`` on host 1.  Read from the
   rendezvous files: one restart epoch, a crash counted once, both hosts
   relaunched into a fresh store, the agreed resume epoch the last
   snapshot committed before the decision; from the ranks' events and run
   reports: each incarnation's steps (the resumed one exactly the cursor's
   to the end), restart_latency per host and its split at run_start and
   the snapshot restore, the step wall before and after, #1-#3's launches
   on every rank, and the final parameters, BatchNorm statistics and each
   epoch's rows bit-equal to the whole pod's (else phase 8's limits).
   (b) Beside (a), the elastic scale-down drill of
   ``tests/test_torch_pod_sim.py`` with ``tests/torch_pod_sim_child.py``
   on the card: host 1's supervisor arrives, beats once and dies; the
   survivors 0 and 2 evict it (epoch 1: ``peer_lost``, hosts [0, 2],
   world 2) and train the 124M width (vocab 256, bf16, ``flash="auto"``)
   for 6 steps of 1 x 256 tokens (#4-#6), ending with identical parameter
   digests and each epoch-1 tail exactly [resume, steps).

Phase 2 holds the fused dense block's forward and backward at DenseNet121's
blocks 1 and 4, at edge cases (tiles across image rows and images, one
image, C0 = 96, block 2's geometry, block 3's 14x14 at C0 256) and at
blocks 1 and 4 with the pipeline's microbatch of 6 images (every case's
dx0 also against the f32 VJP: no farther than 1.25x the plain version's
in relative L2, in the largest element-wise difference and in each
64-pixel tile's L2), requires two backward calls on the same inputs to
give bit-identical results,
checks both kernels' machine code for wgmma and TMA (no mma.sync, no
spills), and times the port's packed block (cuDNN) beside them as their
yardstick.  It also holds the flash-attention forward, its two backward
kernels, the bf16 and int8 decode-attention kernels (also at every
head_dim and grouping they are built for; variants A, B and C's caches
timed; two calls bit-identical) and the int8 small-M matmul (at the 124M
decode's call sites and ragged shapes in both layouts and x types, M = 1,
3 and 8; two calls bit-identical; timed at M = 1 and 8, with the host's
wall per call) to their plain versions, and the int8 kernels' machine code
for asynchronous copies (UTMALDG, UBLKCP), mma.sync where the products are
on the tensor cores, and ptxas's report of no spills.  The flash
forward is also checked at the edges of its query and key tiles (T = 64
and 129, window 100 with kv_offset 37, strided q/k/v of one fused buffer,
head_dim 128 with GQA 4), its machine code is checked for wgmma and TMA
(no mma.sync), and it is timed at variants A and B (the row), the train
step's shape and variant C's windowed prefill beside SDPA on contiguous
copies.  The two backward kernels get the forward's edge cases too, plus
a batch-broadcast cotangent through autograd (a stride-0 ``do`` is copied
before the kernels see it), their machine code the same check at both head
dims with ptxas's report of no spills, and they are timed at the train
step's shape (the rows), the GQA prefill's and head_dim 128, with the
whole backward (delta, dQ, dK/dV) beside SDPA's backward and a
five-product bound.  Then the kernel gates: each model-level dispatch
whose kernel cannot take the work (head_dim 32 with ``flash="auto"``, MQA
decode, an
int8 ``wo`` at d_ff 8192 that the kernel now takes and an int8 head too
wide for it, an f32 "fused" DenseNet121) runs once on the card through
its gate, with the counters showing which path it took.  The line
before the last is ``{"kernels": [...]}`` (launches from the main-path
runs: the DenseNet train slice, which also evaluates, phase 5's three
generator runs, phase 6's ``train()``, phase 7's MoE ``train()`` and
two generator runs, phase 8's four ``train()`` runs, phase 9's five
``train()`` runs, ``decode_quality`` and the entry points, and phase 10's
two in-process command-line runs and phase 11's two ranks, the ``dp``,
ZeRO ``dp`` and ``pp`` command lines, phase 12's engine runs and entry points, and
phase 13's pods: every rank and incarnation); the last line is
``{"ok": true, "device": {...}}``.  Every DenseNet Trainer gets a fresh
checkpoint directory under ``build/chip_smoke_ckpt/`` (emptied at the
start), so none resumes from another run's snapshot.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import math
import operator
import os
import re
import shutil
import subprocess
import sys
import tempfile
import struct
import threading
import time
import zlib
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import ddl_tpu_torch.train as train_pkg  # noqa: E402
from ddl_tpu_torch import checkpoint as ckpt  # noqa: E402
from ddl_tpu_torch import cli, native  # noqa: E402
from ddl_tpu_torch.bench import decode_quality  # noqa: E402
from ddl_tpu_torch.bench import dp as bench_dp  # noqa: E402
from ddl_tpu_torch.bench import pod as bench_pod  # noqa: E402
from ddl_tpu_torch.bench import pp as bench_pp  # noqa: E402
from ddl_tpu_torch.bench.decode import bench_decode, decode_bench_config  # noqa: E402
from ddl_tpu_torch.bench.lm import bench_lm  # noqa: E402
from ddl_tpu_torch.config import parse_cli, preset  # noqa: E402
from ddl_tpu_torch.data import MarkovChain, SyntheticAptosDataset, to_device  # noqa: E402
from ddl_tpu_torch.examples import generate_lm, serve_lm, train_lm  # noqa: E402
from ddl_tpu_torch.infer import LMDecode, init_kv_cache, make_lm_generator  # noqa: E402
from ddl_tpu_torch.models import DenseNet, init_weights  # noqa: E402
from ddl_tpu_torch.models.densenet import DenseBlock  # noqa: E402
from ddl_tpu_torch.models.transformer import (  # noqa: E402
    LMConfig,
    LMHead,
    MoeMlp,
    QDense,
    TransformerLM,
    dense_kernel_names,
    init_lm_weights,
    moe_routing_plan,
)
from ddl_tpu_torch.obs import EventWriter, events_path, hbm, read_events  # noqa: E402
from ddl_tpu_torch.obs.serving import ServingStats, render_percentiles  # noqa: E402
from ddl_tpu_torch.ops import _build  # noqa: E402
from ddl_tpu_torch.ops import cross_entropy_loss, normalize_images  # noqa: E402
from ddl_tpu_torch.ops.fused_dense_block import (  # noqa: E402
    fused_dense_block,
    fused_dense_block_bwd,
    fused_dense_block_bwd_plain,
    fused_dense_block_fn_plain,
    fused_dense_block_plain,
    pack_block_params,
)
from ddl_tpu_torch.ops.decode_attention import (  # noqa: E402
    _SIGNATURES as DECODE_SIGNATURES,
    decode_attention,
    decode_attention_plain,
    decode_split_plan,
    quant_decode_attention,
    quant_decode_attention_plain,
)
from ddl_tpu_torch.ops.flash_attention import (  # noqa: E402
    FLASH_AUTO_MIN_T,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dkdv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_fn_plain,
    flash_attention_plain,
    flash_attention_with_lse,
    flash_attention_with_lse_plain,
)
from ddl_tpu_torch.ops.image_kernel import normalize, normalize_plain  # noqa: E402
from ddl_tpu_torch.ops.losses import fused_chunked_ce, fused_vocab_chunked_ce  # noqa: E402
from ddl_tpu_torch.ops.int8_matvec import (  # noqa: E402
    Int8MatmulLaunch,
    int8_matmul_small_m,
    int8_matmul_small_m_plain,
    matvec_plan,
)
from ddl_tpu_torch.ops.quant import (  # noqa: E402
    kv_decode_plain,
    quantize_lm_params,
    quantize_q8,
)
from ddl_tpu_torch import launch  # noqa: E402
from ddl_tpu_torch.config import ModelConfig  # noqa: E402
from ddl_tpu_torch.parallel import LMMeshSpec  # noqa: E402
from ddl_tpu_torch.parallel.mesh import COLLECTIVES, MeshSpec, build_mesh  # noqa: E402
from ddl_tpu_torch.parallel.pipeline import HANDOFF  # noqa: E402
from ddl_tpu_torch.train.fused_optim import ZERO  # noqa: E402
from ddl_tpu_torch.train import (  # noqa: E402
    LMRunConfig,
    LMTrainer,
    Optimizer,
    Trainer,
    make_eval_step,
    make_lm_step_fns,
)
from ddl_tpu_torch.tools.repo_corpus import build_corpus, iter_files  # noqa: E402
from ddl_tpu_torch.train.lm_steps import _token_ce, chunked_ce_loss  # noqa: E402
from ddl_tpu_torch.utils import faultinject  # noqa: E402
from ddl_tpu_torch.serve import ServeEngine  # noqa: E402
from ddl_tpu_torch.serve import bench as serve_bench  # noqa: E402
from ddl_tpu_torch.serve.engine import prompt_bucket  # noqa: E402

SEED = 0
EVAL_BATCH = 30
EVAL_SET = 100  # 3 full batches + 10 real rows padded with 20 sentinels
# Fused block: max |kernel - plain| / max |plain|.  Kernel and plain
# version round at the same places, so they differ only where a different
# f32 summation order flips a bf16 rounding: one ulp, at most 2^-7 of the
# largest value, which then feeds the later layers.  1e-2 admits one ulp
# anywhere and not two at the largest values.
BLOCK_TOL = 1e-2
# Logits of the whole model: kernel path vs plain path, same weights.  The
# one-ulp strip differences travel through the 120 layers that follow.
LOGIT_TOL = 5e-2  # max |kernel - plain| / max |plain|
ARGMAX_AGREE = 0.99
# Backward kernel vs its plain version, each gradient: max |diff| / max
# |plain|.  Both round dstrip, hid and dy1 to bf16 at the same places, so a
# different f32 summation order (and the run-to-run order of the kernel's
# atomic adds) flips a bf16 rounding of dy1 or dstrip here and there.  The
# f32 parameter gradients are sums over every pixel, where such flips
# average out: 1e-2.  dx0 is itself rounded to bf16 (one ulp is 2^-8 to
# 2^-7 of its largest value) after summing the flipped terms of every later
# layer at each pixel: 2e-2, two ulps (measured up to 0.0101 at block 1).
# Other draws break that limit while both paths stay equally far from the
# VJP with no rounding (kernel_probes.py dense_bwd repeats one at block 2,
# 2.95e-2; block 1 at the pipeline's microbatch read 5.67e-2): each bf16
# path is 0.06-0.33 of the largest value from it at some element.  So every
# case also holds dx0 against the f32 VJP, the kernel no farther from it
# than STEP_GRAD_RATIO times the plain version: in relative L2, in the
# largest element-wise difference, and in the L2 over each 64-pixel tile
# (the kernels' M tile: a fault confined to one tile or a few pixels
# shows there, where a whole-tensor norm would hide it, while a flipped
# rounding moves a tile's norm little).  The microbatch blocks, added with
# these checks, are held by them alone; the earlier cases keep 2e-2 on
# their inputs.
BWD_TOL = 1e-2
BWD_DX0_TOL = 2e-2
# Fused-block cases beside DenseNet121's blocks 1 and 4 (B, H, W, C0, L):
# tiles that cross image rows and images with ragged edges, one image, an
# input width that is an odd multiple of 32 (a half chunk of the 1x1),
# block 2's geometry and block 3's 14x14 at C0 256 (four of its layers).
FUSED_BLOCK_EDGES = (("edge tiles", (2, 9, 11, 64, 2)), ("B=1", (1, 56, 56, 64, 6)),
                     ("C0=96", (2, 12, 12, 96, 3)), ("denseblock2", (EVAL_BATCH, 28, 28, 128, 12)),
                     ("denseblock3 (4 layers)", (EVAL_BATCH, 14, 14, 256, 4)))
# Blocks 1 and 4 at the pipeline's microbatch of 6 images (30 / 5), with
# inputs from a generator of their own, so the cases above keep theirs.
PP_MICROBATCH_BLOCKS = (("pp microbatch, denseblock1", (6, 56, 56, 64, 6)),
                        ("pp microbatch, denseblock4", (6, 7, 7, 512, 16)))
# The packed block's backward at blocks 1 and 4 (check_fused_block times
# it beside the forward; check_fused_block_bwd reports it): the yardstick
# of the backward kernel, as no one PyTorch call computes a block's VJP.
PACKED_BWD_MS: dict[str, float] = {}
TRAIN_SET = 150  # five train steps of 30
# One train step, kernel path vs plain path from the same weights.  The
# one-ulp strip differences of the fused blocks travel through the rest of
# the network and back: the loss within 1e-2 (relative) and the running
# statistics within 1e-2 (relative).  Gradients: a weight that feeds a
# train-mode BatchNorm leaves the loss invariant to its scale, so its
# gradient is the small sum of two large terms (the kernel's VJP at fixed
# affines and the term through the batch statistics) that cancel, and bf16
# rounding noise in either term is large in the sum: kernel and plain path
# differ by ~20% (relative L2) on such leaves of block 1 and the stem, as
# two bf16 runs of the same math would.  So each path is held against the
# f32 gradient of the same step (the plain versions in f32 on the card):
# the kernel path no farther from it than the plain path, within 25%, for
# the whole gradient vector; and every leaf within 5e-2 of the model's
# largest gradient of the plain path.
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2
STEP_GRAD_RATIO = 1.25
STEP_STATS_TOL = 1e-2
# Flash forward vs its plain version: the kernel rounds P to bf16 before
# the P.V product (the TPU kernel and the plain version keep f32), a
# relative error of 2^-9 per term: every output row (one query, one head)
# within 1e-2 of that row's own largest |plain| value, so late causal rows,
# whose averages over many keys are small, are held as tightly as row 0;
# the lse sums f32 probabilities in another order: 1e-3 absolute.  Rows
# whose band holds no key are exactly 0.
FLASH_TOL = 1e-2
LSE_TOL = 1e-3
# Flash backward vs its plain version in f32 from the same bf16 inputs (and
# the forward kernel's out and lse).  The kernels round P (dV's product)
# and dS (dQ's and dK's) to bf16, a relative error of at most 2^-8 per
# term, random in sign, so each gradient sum carries a relative error of
# ~2^-8/sqrt(3) of its typical size; then the result is rounded to bf16
# (at most 2^-8 of the row's largest value).  Every row (dq: one query, one
# head; dk, dv: one key, one K/V head) within 2e-2 of that row's own
# largest |plain| value: the two rounding points at their worst and a
# 4-sigma tail of the summed noise over ~10^5 rows.  A row whose exact
# gradient is zero (a query that sees one key: ds = p (do.v - do.out) = 0)
# holds only f32 cancellation noise in both versions, so a row's scale is
# floored at 1e-2 of the tensor's largest value.  Rows no key or query
# reaches (dq of an empty-band query; dk and dv of a key no query sees)
# are exactly 0.
FLASH_BWD_TOL = 2e-2
FLASH_BWD_FLOOR = 1e-2
# Decode kernels vs their plain versions: the same f32 arithmetic in
# another order, then one bf16 rounding of the output: every row within
# 1e-2 of its own largest |plain| value.
DECODE_TOL = 1e-2
# Decode kernels at every (head_dim, query heads per K/V head) they are
# built for, bf16 and int8 cache: B=2, Hkv=2, L=300 with per-lane lengths.
DECODE_GROUPINGS = [(d, g) for d in (64, 128) for g in range(1, 9)]
# Int8 small-M matmul vs its plain version: both sum exact f32 products in
# f32 and round once; another summation order flips at most one bf16
# rounding (2^-8 to 2^-7 of a row's largest value), so a bf16 row within
# 1e-2 of its own largest |plain| value; an f32 row differs only by the
# order of ~768 f32 additions (~1e-6 relative): 1e-4.
MATVEC_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The call sites of the 124M decode (d_model 768, d_ff 3072, vocab 50304):
# (name, D, O, x dtype, contract_last)
MATVEC_SHAPES = (
    ("attn.q, attn.out, MHA attn.k/v", 768, 768, torch.bfloat16, False),
    ("GQA attn.k/v (12q/4kv)", 768, 256, torch.bfloat16, False),
    ("mlp.wi", 768, 3072, torch.bfloat16, False),
    ("mlp.wo", 3072, 768, torch.bfloat16, False),
    ("lm_head", 768, 50304, torch.float32, True),
)
# one decode token's calls per layer (q, k, v, out, wi, wo) for GQA, and the head
MATVEC_CALLS = {"attn.q, attn.out, MHA attn.k/v": 2, "GQA attn.k/v (12q/4kv)": 2,
                "mlp.wi": 1, "mlp.wo": 1, "lm_head": 1}
# 124M decode under teacher forcing, kernel path vs plain path, same
# weights: the flash prefill's bf16 P and one-ulp bf16 flips travel through
# 12 layers: every step's logits within 5e-2 of the largest |logit|; top-1
# equal wherever the plain path's top-2 margin exceeds that; and the kernel
# path no farther than 1.25x the plain path from the f32 plain path.
LM_LOGIT_TOL = 5e-2
LM_L2_RATIO = 1.25
# ddl_tpu/bench/decode.py:55-70 at its defaults (:175-181): the 124M LM
LM_124M = dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12, head_dim=64,
               d_ff=3072, compute_dtype="bfloat16", flash=True)
LM_VARIANTS = {
    # A and B decode 32 new tokens (128 and 64 until the serving phase needed
    # the time, then A 64 until ZeRO's and the HBM ledger's checks did)
    "A": dict(kv_heads=0, quant=False, batch=8, prompt=2048, new=32),
    "B": dict(kv_heads=4, quant=True, batch=32, prompt=1024, new=32),
    # ddl_tpu/bench/decode.py --quant kv+w at B=1, GQA, window 1024 (the
    # configuration ddl_tpu/ops/int8_matvec.py:15-17 measured): the bench's
    # 4096-token prompt, 32 tokens instead of 2 x 2048 (128 until the serving
    # phase needed the time, 64 until ZeRO's and the HBM ledger's checks did)
    "C": dict(kv_heads=4, quant=True, weights_int8=True, window=1024, batch=1, prompt=4096,
              new=32),
}
CROSSOVER_T = (256, 512, 1024, 2048, 4096)
# The kv / kv+w gate after phase 5, cut from 128 new tokens and 200
# alternations to keep the whole run under 900 s with phase 7, from 64
# new tokens with phase 11, and from 32 new tokens and 100 alternations
# with phase 12
GATE_NEW, GATE_STEPS = 16, 50
# ddl_tpu/bench/lm.py:79-99 at its defaults with --flash: the 124M LM,
# batch 8 x 1024, full remat, optax.adamw(3e-4) (weight decay 1e-4)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 1024
LM_TRAIN_STEPS, LM_TRAIN_LOG_EVERY = 20, 10
TRAIN_SWEEP_T = (256, 512, 1024, 2048)  # at 8192 tokens per step
# One 124M train step, kernel path vs plain path from the same weights, and
# each against the plain path in f32: the same limits as the DenseNet step
# (STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_RATIO), for the same reason --
# bf16 rounding of the whole model, here with the kernels' bf16 P and dS on
# top, is judged against an f32 run of the same step.

# Phase 7.  The loss edge at the 124M train shape, each chunked loss against
# the dense CE on the same f32 inputs with TF32 off: the same f32 sums in
# another order (per chunk or block, then over them): the loss within 1e-5
# (relative), dhidden and dW within 1e-4 of their largest dense value, the
# accuracy equal; a chunked edge's peak memory at most half the dense
# one's (the point of the chunking).  The chunk sizes are those the JAX
# package measured at this shape.
LOSS_EDGE_CHUNK, LOSS_EDGE_VOCAB_CHUNK = 256, 8384
LOSS_EDGE_LOSS_TOL, LOSS_EDGE_GRAD_TOL, LOSS_EDGE_PEAK_SHARE = 1e-5, 1e-4, 0.5
# The 124M MoE that the JAX package measured its routing on
# (ddl_tpu/bench/lm.py --batch 16 --experts 8 --d-ff 1536 --flash): top-2,
# capacity factor 1.5, groups of 256 (the einsum dispatch, capacity 96);
# the trainer anneals to capacity_factor_min 1.0 (capacity 64) at step 10.
MOE_124M = dict(num_experts=8, expert_top_k=2, capacity_factor=1.5, moe_group=256, d_ff=1536)
MOE_TRAIN_BATCH, MOE_ANNEAL_STEP = 16, 10
# the MoE trainer's steps, two logged windows of 6 around the anneal (20
# steps in windows of 10 until the pod phase needed the time)
MOE_TRAIN_STEPS = 12
# MoE decode from the same model: D with the bf16 cache, E with int8
# weights (expert banks too) and the int8 cache; 8 new tokens (32 until
# the serving phase needed the time, 16 until ZeRO's and the HBM ledger's
# checks did)
MOE_DECODE = {
    "D": dict(kv_heads=0, quant=False, batch=8, prompt=1024, new=8, moe=True),
    "E": dict(kv_heads=0, quant=True, weights_int8=True, batch=8, prompt=1024, new=8, moe=True),
}

# Dense bf16 tensor-core FLOP/s and device-memory bytes/s, NVIDIA data sheets.
PEAKS = {"SXM": (989e12, 3.35e12), "PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12)}
# f32 FLOP/s outside the tensor cores (the rate of an f32 product with TF32 off)
F32_PEAKS = {"SXM": 67e12, "PCIe": 51e12, "NVL": 60e12}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def row_rel_err(got, want) -> float:
    """Largest error of a row (the last axis) over that row's own largest
    |want|; a row whose ``want`` is all zero must be exactly zero."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-30),
                      torch.where(err > 0, torch.inf, 0.0))
    return rel.max().item()


def grad_row_err(got, want, floor: float) -> float:
    """Largest error of a row over that row's own largest |want|, the scale
    floored at ``floor`` times the tensor's largest |want| (a row whose
    exact value is 0 by cancellation carries only rounding noise)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return (err / scale.clamp(min=floor * scale.max().item())).max().item()


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_part(name: str) -> str:
    return next((p for p in ("PCIe", "NVL") if p in name), "SXM")


def measure(fn, inputs, iters: int = 20, warmup: int = 3) -> tuple[float, float, dict]:
    """Per call of ``fn(x)``, cycling through ``inputs`` (several copies, so
    a launch does not find its input in L2): (device ms, the time the card
    had at least one kernel running, from the profiler's kernel intervals
    in the busier of two windows that recorded kernels (at most four
    tried): a kernel launched as a programmatic
    dependent may start while the one before it finishes, so its interval
    overlaps and a plain sum would count the overlap twice; wall ms, CUDA
    events around back-to-back calls, host overhead included; {kernel name:
    device ms, each kernel's own time})."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / iters
    # Two profiled windows that recorded kernels, and the busier one's
    # numbers: on the card's machine the profiler has returned windows with
    # no kernel at all (once both of a pair), and once read a kernel 45%
    # under its time in the other runs of the same code; a kernel lost from
    # a window can only lower its busy time.  At most 4 windows.
    best, seen = (-1.0, {}), 0
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(inputs[i % len(inputs)])
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / 1e3 / iters
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        best = max(best, (busy_us(prof) / 1e3 / iters, kernels), key=lambda b: b[0])
        seen += sum(kernels.values()) > 0
        if seen == 2:
            break
    busy, kernels = best
    require(sum(kernels.values()) > 0, "the profiler recorded device time")
    return busy, wall, kernels


def busy_us(prof) -> float:
    """Microseconds in which at least one kernel (or copy) ran on the card:
    the union of the profiler's device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def setup() -> dict:
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi()}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(_build.BUILD_DIR.parents[1])) for p in libs.values()))
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and cuBLAS: the plain versions' f32 products are exact")
    flops, bw = PEAKS[card_part(name)]
    flops_f32 = F32_PEAKS[card_part(name)]
    print(f"peaks used for bounds: {flops / 1e12:.0f} TFLOP/s bf16, {flops_f32 / 1e12:.0f} "
          f"TFLOP/s f32, {bw / 1e12:.2f} TB/s")
    return {"name": name, "flops": flops, "flops_f32": flops_f32, "bw": bw}


def check_normalize(card: dict, rng) -> dict:
    shape = (EVAL_BATCH, 224, 224, 3)
    max_err = 0.0
    for s in (shape, (3, 7, 5, 3)):  # the slice's batch, and a ragged tail
        x = torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).cuda()
        for dt, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
            got, want = normalize(x, dt), normalize_plain(x, dt)
            torch.cuda.synchronize()
            equal = torch.equal(got.view(bits), want.view(bits))
            max_err = max(max_err, (got.float() - want.float()).abs().max().item())
            print(f"normalize {s} {dt}: bit-equal {equal}")
            require(equal, f"normalize {s} {dt} bit-equal to its plain version")
    xs = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda() for _ in range(8)]
    ms, wall, _ = measure(lambda x: normalize(x, torch.bfloat16), xs)
    plain_ms, plain_wall, _ = measure(lambda x: normalize_plain(x, torch.bfloat16), xs)
    # two calls: the cast, then the in-place multiply
    library_ms, library_wall, _ = measure(lambda x: x.to(torch.bfloat16).mul_(1.0 / 255.0), xs)
    row = {
        "name": "normalize", "route": "cuda", "source": "ddl_tpu_torch/csrc/normalize.cu",
        "replaces": "ddl_tpu/ops/pallas_image.py:26", "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": xs[0].numel() * (1 + 2) / card["bw"] * 1e3, "bound_by": "bytes",
    }
    print(f"normalize {shape} bf16, device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), "
          f"plain {plain_ms:.4f} ({plain_wall:.4f}), library {library_ms:.4f} "
          f"({library_wall:.4f}); bound {row['bound_ms']:.4f} ms (bytes)")
    return row


def random_block(rng, b, h, w, c0, n_layers, growth=32, bn=128, with_layers=False):
    """Seeded block input and folded parameters (positive running variances);
    with ``with_layers``, also the layers' torchvision-named tensors."""
    def normal(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    def uniform(lo, hi, n):
        return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))

    layers = []
    for i in range(n_layers):
        c = c0 + i * growth
        layers.append({
            "norm1.weight": uniform(0.5, 1.5, c), "norm1.bias": normal(c, std=0.1),
            "norm1.running_mean": normal(c, std=0.5), "norm1.running_var": uniform(0.5, 2.0, c),
            "conv1.weight": normal(bn, c, 1, 1, std=(2.0 / c) ** 0.5),
            "norm2.weight": uniform(0.5, 1.5, bn), "norm2.bias": normal(bn, std=0.1),
            "norm2.running_mean": normal(bn, std=0.5), "norm2.running_var": uniform(0.5, 2.0, bn),
            "conv2.weight": normal(growth, bn, 3, 3, std=(2.0 / (9 * bn)) ** 0.5),
        })
    layers = [{k: v.cuda() for k, v in s.items()} for s in layers]
    packed = pack_block_params(layers, torch.bfloat16)
    x0 = normal(b, h, w, c0).cuda().to(torch.bfloat16)
    return (x0, packed, layers) if with_layers else (x0, packed)


def packed_block(layers, c0: int, growth: int = 32, bn_size: int = 4) -> DenseBlock:
    """The port's packed dense block (cuDNN convolutions, no ``fused_fn``)
    in eval mode with the same layers' weights and running statistics:
    the same function as the fused kernels on the folded parameters."""
    block = DenseBlock(len(layers), c0, growth, bn_size)
    missing, unexpected = block.load_state_dict(
        {f"denselayer{i + 1}.{k}": v for i, layer in enumerate(layers) for k, v in layer.items()},
        strict=False)
    require(not unexpected and all(k.endswith("num_batches_tracked") for k in missing),
            "the packed block takes every tensor of the fused block's layers")
    return block.cuda().eval()


def time_packed(layers, x0) -> tuple[float, float]:
    """Device ms of the packed block on ``x0`` (NHWC bf16) at the same
    weights: the forward, and the forward and backward by autograd (the
    gradients of the input and of every weight)."""
    block = packed_block(layers, x0.shape[-1])
    xs = [x0.permute(0, 3, 1, 2).clone().requires_grad_() for _ in range(4)]
    fwd_ms, _, _ = measure(lambda x: block(x, torch.bfloat16), xs, iters=10)

    def step(x):
        out = block(x, torch.bfloat16)
        out.backward(torch.ones_like(out))

    both_ms, _, _ = measure(step, xs, iters=10)
    return fwd_ms, both_ms


def block_work(b, h, w, c0, n_layers, growth=32, bn=128) -> tuple[float, float]:
    """(FLOPs, bytes) of one block call: every product once; each input
    read once and the output written once."""
    c_ins = [c0 + i * growth for i in range(n_layers)]
    flops = sum(2 * b * h * w * (c * bn + 9 * bn * growth) for c in c_ins)
    params = sum(c * (4 + 4 + 2 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 2)
    io = b * h * w * (c0 + c0 + n_layers * growth) * 2
    return flops, io + params


def pp_block_cases(rng):
    """``FUSED_BLOCK_EDGES`` on ``rng``, then ``PP_MICROBATCH_BLOCKS`` on a
    generator of their own: ``(label, geom, generator)``."""
    pp_rng = np.random.default_rng(SEED + 15)
    return [*((label, geom, rng) for label, geom in FUSED_BLOCK_EDGES),
            *((label, geom, pp_rng) for label, geom in PP_MICROBATCH_BLOCKS)]


def check_fused_block(card: dict, rng) -> dict:
    for label, geom, gen in pp_block_cases(rng):
        x0, packed = random_block(gen, *geom)
        want = fused_dense_block_plain(x0, packed).float()
        got = fused_dense_block(x0, packed).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        print(f"fused block {label} {geom}: rel err {rel:.5f} (tol {BLOCK_TOL})")
        require(bool(torch.isfinite(got).all()), f"fused block {label} finite")
        require(rel <= BLOCK_TOL, f"fused block {label} within {BLOCK_TOL}")
    row = {"name": "fused_dense_block", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/fused_dense_block.cu",
           "replaces": "ddl_tpu/ops/fused_dense_block.py:155", "library_ms": 0.0,
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    flops_total = bytes_total = 0.0
    # DenseNet121 blocks 1 and 4 at eval batch 30 (config.py:44-96)
    for label, geom in (("denseblock1", (EVAL_BATCH, 56, 56, 64, 6)),
                        ("denseblock4", (EVAL_BATCH, 7, 7, 512, 16))):
        x0, packed, layers = random_block(rng, *geom, with_layers=True)
        got = fused_dense_block(x0, packed).float()
        want = fused_dense_block_plain(x0, packed).float()
        require(bool(torch.isfinite(got).all()), f"{label} kernel output finite")
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        xs = [x0] + [x0.clone() for _ in range(3)]
        ms, wall, _ = measure(lambda x: fused_dense_block(x, packed), xs)
        plain_ms, plain_wall, _ = measure(lambda x: fused_dense_block_plain(x, packed), xs, iters=5)
        packed_ms, packed_both = time_packed(layers, x0)
        PACKED_BWD_MS[label] = packed_both - packed_ms
        flops, nbytes = block_work(*geom)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        print(f"fused block {label} {geom}: max abs err {err:.5f}, rel {rel:.5f} "
              f"(tol {BLOCK_TOL}); device ms (wall ms per call): kernel {ms:.4f} "
              f"({wall:.4f}), plain {plain_ms:.4f} ({plain_wall:.4f}), packed block "
              f"(cuDNN) {packed_ms:.4f} (forward and backward {packed_both:.4f}); bound "
              f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        require(rel <= BLOCK_TOL, f"{label} within {BLOCK_TOL} of the plain version")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += packed_ms
        row["bound_ms"] += bound
        flops_total += flops
        bytes_total += nbytes
    row["bound_by"] = ("operations" if flops_total / card["flops"] >= bytes_total / card["bw"]
                       else "bytes")
    return row


def block_bwd_work(b, h, w, c0, n_layers, growth=32, bn=128) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward call: twice the forward's products
    (the input and the weight gradients of each); the output map and its
    cotangent read once, dx0 and the f32 parameter gradients written once,
    the folded parameters read once."""
    flops, _ = block_work(b, h, w, c0, n_layers, growth, bn)
    c_ins = [c0 + i * growth for i in range(n_layers)]
    c_tot = c0 + n_layers * growth
    params = sum(c * (4 + 4 + 2 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 2)
    grads = sum(c * (4 + 4 + 4 * bn) for c in c_ins) + n_layers * (2 * 4 * bn + 9 * growth * bn * 4)
    io = b * h * w * (2 * c_tot + c0) * 2
    return 2 * flops, io + params + grads


def dx0_distances(dx0, f32_dx0) -> tuple[float, float, torch.Tensor]:
    """dx0's distances to the f32 VJP: the relative L2, the largest
    element-wise difference, and the L2 over each tile of 64 pixels."""
    err = (dx0.float() - f32_dx0).reshape(-1, f32_dx0.shape[-1])
    tiles = F.pad(err, (0, 0, 0, -err.shape[0] % 64)).reshape(-1, 64 * err.shape[1])
    return ((err.norm() / f32_dx0.norm()).item(), err.abs().max().item(), tiles.norm(dim=1))


def worst_tile_ratio(kernel_tiles, plain_tiles) -> float:
    """The largest over tiles of the kernel's L2 distance to the f32 VJP
    over the plain version's (infinite where only the plain one is 0)."""
    ratio = torch.where(plain_tiles > 0, kernel_tiles / plain_tiles.clamp_min(1e-30),
                        torch.where(kernel_tiles > 0, math.inf, 0.0))
    return ratio.max().item()


def check_fused_block_bwd(card: dict, rng) -> dict:
    row = {"name": "fused_dense_block_bwd", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/fused_dense_block_bwd.cu",
           "replaces": "ddl_tpu/ops/fused_dense_block.py:277", "library_ms": 0.0,
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    flops_total = bytes_total = 0.0
    # the edge cases, then DenseNet121 blocks 1 and 4 at train batch 30
    for label, geom, gen in (*pp_block_cases(rng),
                             ("denseblock1", (EVAL_BATCH, 56, 56, 64, 6), rng),
                             ("denseblock4", (EVAL_BATCH, 7, 7, 512, 16), rng)):
        x0, packed = random_block(gen, *geom)
        out = fused_dense_block(x0, packed)
        gs = [torch.from_numpy(gen.standard_normal(out.shape).astype(np.float32)).cuda()
              .to(torch.bfloat16) for _ in range(4)]
        dx0, grads = fused_dense_block_bwd(out, gs[0], packed)
        want_dx0, want = fused_dense_block_bwd_plain(out, gs[0], packed)
        # both bf16 paths against the same VJP with no rounding (the plain
        # version in f32): the kernel no farther from it than the plain one
        f32_dx0, _ = fused_dense_block_bwd_plain(out.float(), gs[0].float(), packed)
        (l2, inf, tiles), (l2_p, inf_p, tiles_p) = (dx0_distances(d, f32_dx0)
                                                    for d in (dx0, want_dx0))
        tile_ratio = worst_tile_ratio(tiles, tiles_p)
        got = {"dx0": dx0.float(), **grads}
        want = {"dx0": want_dx0.float(), **want}
        rels = {}
        for k, v in got.items():
            require(bool(torch.isfinite(v).all()), f"{label} backward {k} finite")
            err = (v - want[k]).abs().max().item()
            rels[k] = err / want[k].abs().max().item()
            row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"fused block backward {label} {geom}: max |diff| / max |plain| "
              + ", ".join(f"{k} {r:.5f}" for k, r in rels.items())
              + f" (tol dx0 {BWD_DX0_TOL}, the rest {BWD_TOL}); dx0 against the f32 VJP "
              f"(tol {STEP_GRAD_RATIO}x the plain's): relative L2 kernel {l2:.5f}, plain "
              f"{l2_p:.5f}; largest difference / its largest value kernel "
              f"{inf / f32_dx0.abs().max().item():.5f}, plain "
              f"{inf_p / f32_dx0.abs().max().item():.5f}; worst 64-pixel tile's L2, kernel "
              f"over plain, {tile_ratio:.4f} of {tiles.numel()} tiles")
        require(l2 <= STEP_GRAD_RATIO * l2_p,
                f"{label} backward dx0's L2 to f32 within {STEP_GRAD_RATIO}x the plain's")
        require(inf <= STEP_GRAD_RATIO * inf_p, f"{label} backward dx0's largest difference "
                f"from f32 within {STEP_GRAD_RATIO}x the plain's")
        require(tile_ratio <= STEP_GRAD_RATIO, f"{label} backward dx0's L2 to f32 in every "
                f"64-pixel tile within {STEP_GRAD_RATIO}x the plain's")
        dx0_rel = rels.pop("dx0")
        if gen is rng:  # the microbatch blocks' dx0: the f32 checks above (BWD_DX0_TOL's note)
            require(dx0_rel <= BWD_DX0_TOL, f"{label} backward dx0 within {BWD_DX0_TOL}")
        require(max(rels.values()) <= BWD_TOL, f"{label} backward gradients within {BWD_TOL}")
        if label not in PACKED_BWD_MS:
            continue
        # no atomics: a second call on the same inputs gives the same bits
        dx0_b, grads_b = fused_dense_block_bwd(out, gs[0], packed)
        same = torch.equal(dx0.view(torch.int16), dx0_b.view(torch.int16)) and all(
            torch.equal(grads[k].view(torch.int32), grads_b[k].view(torch.int32)) for k in grads)
        print(f"  a second call: dx0 and every gradient bit-identical {same}")
        require(same, f"{label} backward bit-identical across two calls")
        ms, wall, _ = measure(lambda g: fused_dense_block_bwd(out, g, packed), gs, iters=10)
        plain_ms, plain_wall, _ = measure(lambda g: fused_dense_block_bwd_plain(out, g, packed),
                                          gs, iters=3, warmup=1)
        flops, nbytes = block_bwd_work(*geom)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        print(f"  device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), plain "
              f"{plain_ms:.4f} ({plain_wall:.4f}), packed block (cuDNN) backward "
              f"{PACKED_BWD_MS[label]:.4f} (its forward and backward less its forward); "
              f"bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += PACKED_BWD_MS[label]
        row["bound_ms"] += bound
        flops_total += flops
        bytes_total += nbytes
    row["bound_by"] = ("operations" if flops_total / card["flops"] >= bytes_total / card["bw"]
                       else "bytes")
    return row


# Every Trainer's checkpoint directory: a fresh one per configuration under
# this root, which main() empties first, so no Trainer resumes from another
# run's snapshot (a Trainer auto-resumes from its job id's latest one).
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
_CKPT_RUNS = itertools.count()


def fused_cfg(**extra):
    return preset("single", **{
        "model.compute_dtype": "bfloat16", "model.dense_block_impl": "fused",
        "model.dense_block_fused_blocks": (0, 3), "model.pallas_normalize": True,
        "data.dataset_dir": "", "data.synthetic_num_test": EVAL_SET,
        "data.eval_batch_size": EVAL_BATCH, "train.seed": SEED,
        "train.checkpoint_dir": str(CKPT_ROOT / f"run{next(_CKPT_RUNS)}"), **extra,
    })


def run_slice(card: dict) -> dict:
    cfg = fused_cfg()
    trainer = Trainer(cfg)  # device left at its default: cuda
    n_batches = len(trainer.test_loader)
    trainer.evaluate(0)  # warm-up: cuDNN plans, allocator, kernel libraries
    torch.cuda.synchronize()

    normalize.launches = 0
    fused_dense_block.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.evaluate(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"normalize": normalize.launches, "fused_dense_block": fused_dense_block.launches}

    print(f"eval metrics: {json.dumps(metrics)}")
    for k in ("val_loss", "val_accuracy", "qwk"):
        require(bool(np.isfinite(metrics[k])), f"{k} finite")
    require(metrics["val_examples"] == EVAL_SET, f"val_examples == {EVAL_SET}")
    per_batch = {"normalize": 1, "fused_dense_block": sum(
        cfg.model.block_config[b] for b in cfg.model.dense_block_fused_blocks)}
    print(f"launches in the eval run ({n_batches} batches): {launches}")
    for k, n in per_batch.items():
        require(launches[k] == n * n_batches, f"{k} launched {n} x {n_batches} times")

    # the same weights through the plain versions, on the card
    ref = DenseNet(cfg.model, num_stages=1, fused_fn=fused_dense_block_plain)
    ref.load_state_dict(trainer.model.state_dict())
    ref_step = make_eval_step(ref.cuda().eval(), torch.bfloat16, normalize_plain)
    got, want, valid = [], [], []
    batches = [to_device(i, l, "cuda") for i, l in trainer.test_loader]
    for images, labels in batches:
        got.append(trainer.eval_step(images))
        want.append(ref_step(images))
        valid.append(labels >= 0)
    mask = torch.cat(valid)
    got, want = torch.cat(got)[mask], torch.cat(want)[mask]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"logits vs plain path: max abs diff {(got - want).abs().max().item():.5f}, "
          f"rel {rel:.5f} (tol {LOGIT_TOL}), argmax agreement {agree:.4f} (min {ARGMAX_AGREE})")
    require(rel <= LOGIT_TOL, f"logits within {LOGIT_TOL} of the plain path")
    require(agree >= ARGMAX_AGREE, f"argmax agreement >= {ARGMAX_AGREE}")

    step_ms, step_wall, kernels = measure(trainer.eval_step, [b[0] for b in batches], iters=10)
    print(f"eval on {card['name']} ({smi()}): wall {wall / n_batches * 1e3:.2f} ms/batch "
          f"(loader included), {EVAL_SET / wall:.1f} images/s; eval step on device-resident "
          f"batches {step_wall:.3f} ms/batch wall (CUDA events), "
          f"{EVAL_BATCH / step_wall * 1e3:.1f} images/s, device busy {step_ms:.3f} ms "
          f"({step_ms / step_wall:.1%} of the step), {len(kernels)} distinct kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, k_ms in top:
        print(f"  {k_ms:8.4f} ms/batch  {k_ms / step_ms:6.1%}  {name[:90]}")
    # the same step with the packed blocks (cuDNN convolutions, no kernels)
    packed = Trainer(fused_cfg(**{"model.dense_block_impl": "packed"}))
    packed.evaluate(0)  # warm-up
    p_ms, p_wall, _ = measure(packed.eval_step, [b[0] for b in batches], iters=10)
    print(f"eval step with dense_block_impl=packed: {p_wall:.3f} ms/batch wall (CUDA events), "
          f"device busy {p_ms:.3f} ms ({p_ms / p_wall:.1%}); fused: {step_ms:.3f} ms busy, "
          f"{step_ms - p_ms:+.3f} ms against packed")
    return launches


def step_grads(model, images, labels, normalizer, dtype=torch.bfloat16) -> tuple[float, dict]:
    """One train step's forward and backward (no update): the loss and
    every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(normalizer(images, dtype)), labels)
    loss.backward()
    return loss.item(), {k: p.grad.float() for k, p in model.named_parameters()}


def l2_diff(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over the whole gradient vector."""
    return (sum((a[k] - b[k]).square().sum() for k in b).sqrt()
            / sum(v.square().sum() for v in b.values()).sqrt()).item()


def run_train_slice(card: dict) -> dict:
    log_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_logs"
    cfg = fused_cfg(**{"data.synthetic_num_train": TRAIN_SET, "train.log_dir": str(log_dir)})
    trainer = Trainer(cfg)
    n_train, n_eval = len(trainer.train_loader), len(trainer.test_loader)
    launches = {"normalize": normalize, "fused_dense_block": fused_dense_block,
                "fused_dense_block_bwd": fused_dense_block_bwd}
    for fn in launches.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.train(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launches.items()}
    print(f"launches in train(1) ({n_train} train steps, {n_eval} eval batches): {launches}")
    per_layer = sum(cfg.model.block_config[b] for b in cfg.model.dense_block_fused_blocks)
    want = {"normalize": n_train + n_eval, "fused_dense_block": per_layer * (n_train + n_eval),
            "fused_dense_block_bwd": per_layer * n_train}
    for k, n in want.items():
        require(launches[k] == n, f"{k} launched {n} times in train(1)")
    # the epoch's mean loss, as the loop logged it: the last row's value
    loss_csv = log_dir / "by_job_id" / trainer.job_id / "loss.csv"
    loss = float(loss_csv.read_text().splitlines()[-1].split(",")[-1])
    metrics = trainer.evaluate(0)
    period = [e for e in read_events(events_path(log_dir, trainer.job_id))
              if e["kind"] == "period"][-1]
    print(f"train(1) wall {wall:.2f} s with its eval pass and its best-QWK snapshot "
          f"(checkpoint phase {period['phases'].get('checkpoint', 0.0) * 1e3:.1f} ms on the "
          f"loop); epoch 0 loss {loss:.4f}; eval {json.dumps(metrics)}")
    require(bool(np.isfinite(loss)), "train loss finite")
    for k in ("val_loss", "val_accuracy", "qwk"):
        require(bool(np.isfinite(metrics[k])), f"eval {k} finite after training")

    # one step through the kernels, one through the plain versions and one
    # through the plain versions in f32, from the same weights
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ref = DenseNet(cfg.model, num_stages=1, fused_fn=fused_dense_block_fn_plain)
    ref.load_state_dict(state)
    ref.cuda().train()
    trainer.model.train()
    batches = [to_device(i, l, "cuda") for i, l in trainer.train_loader]
    images, labels = batches[0]
    got_loss, got = step_grads(trainer.model, images, labels, normalize)
    want_loss, want = step_grads(ref, images, labels, normalize_plain)
    stats_rel = max(
        ((a - b).abs().max() / b.abs().max()).item()
        for (name, a), b in zip(trainer.model.named_buffers(), ref.buffers())
        if "running" in name)
    f32 = DenseNet(dataclasses.replace(cfg.model, compute_dtype="float32"), num_stages=1,
                   fused_fn=fused_dense_block_fn_plain)
    f32.load_state_dict(state)
    _, exact = step_grads(f32.cuda().train(), images, labels, normalize_plain, torch.float32)
    del f32

    big = max(g.abs().max().item() for g in want.values())
    worst = sorted((((got[k] - want[k]).abs().max().item(), ((got[k] - want[k]).norm()
                     / want[k].norm()).item(), k) for k in want), reverse=True)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    kernel_l2, plain_l2 = l2_diff(got, exact), l2_diff(want, exact)
    print(f"train step kernel vs plain path: loss {got_loss:.6f} vs {want_loss:.6f} "
          f"(rel {loss_rel:.2e}, tol {STEP_LOSS_TOL}); kernel vs plain relative L2 "
          f"{l2_diff(got, want):.2e}; vs the f32 gradient: kernel path {kernel_l2:.2e}, plain "
          f"path {plain_l2:.2e} (ratio {kernel_l2 / plain_l2:.3f}, tol {STEP_GRAD_RATIO})")
    for err, rel_l2, k in worst[:5]:
        print(f"  grad {k}: max |diff| {err:.3e} = {err / big:.4f} of the largest gradient "
              f"(tol {STEP_GRAD_TOL}); leaf relative L2 kernel vs plain {rel_l2:.2e}, vs f32: "
              f"kernel {l2_diff({k: got[k]}, {k: exact[k]}):.2e}, "
              f"plain {l2_diff({k: want[k]}, {k: exact[k]}):.2e}")
    print(f"  running statistics after the step: max rel diff {stats_rel:.2e} "
          f"(tol {STEP_STATS_TOL})")
    require(loss_rel <= STEP_LOSS_TOL, f"train-step loss within {STEP_LOSS_TOL}")
    require(worst[0][0] <= STEP_GRAD_TOL * big,
            f"every gradient within {STEP_GRAD_TOL} of the largest gradient")
    require(kernel_l2 <= STEP_GRAD_RATIO * plain_l2,
            f"kernel path within {STEP_GRAD_RATIO}x the plain path's distance to f32")
    require(stats_rel <= STEP_STATS_TOL, f"running statistics within {STEP_STATS_TOL}")

    step_ms, step_wall, kernels = measure(lambda b: trainer.train_step(*b), batches, iters=10)
    print(f"train step on {card['name']} ({smi()}), device-resident batches of {EVAL_BATCH}: "
          f"{step_wall:.3f} ms wall (CUDA events), {1e3 / step_wall:.2f} steps/s, "
          f"{EVAL_BATCH / step_wall * 1e3:.1f} images/s; device busy {step_ms:.3f} ms "
          f"({step_ms / step_wall:.1%} of the step), {len(kernels)} distinct kernels")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    for name, k_ms in top:
        print(f"  {k_ms:8.4f} ms/step  {k_ms / step_ms:6.1%}  {name[:90]}")
    # the same step with the packed blocks (cuDNN convolutions, no stats
    # pass and no kernels), from the same seed
    packed = Trainer(fused_cfg(**{"data.synthetic_num_train": TRAIN_SET,
                                  "model.dense_block_impl": "packed"}))
    p_ms, p_wall, _ = measure(lambda b: packed.train_step(*b), batches, iters=10)
    print(f"train step with dense_block_impl=packed: {p_wall:.3f} ms wall (CUDA events), "
          f"device busy {p_ms:.3f} ms ({p_ms / p_wall:.1%}); fused: {step_ms:.3f} ms busy, "
          f"{step_ms - p_ms:+.3f} ms against packed")
    return launches


def randn_bf16(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def flash_work(b, t, h, hkv, d, window: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal forward: two products over the visible
    (query, key) pairs (``window`` > 0: the last ``window`` keys of each
    query); q, k, v read once, out and lse written once."""
    pairs = t * (t + 1) / 2 if not window else sum(min(i + 1, window) for i in range(t))
    flops = 4 * b * h * d * pairs
    nbytes = b * t * (2 * h + 2 * hkv) * d * 2 + b * h * t * 4
    return flops, nbytes


def fused_qkv(gen, b, t, h, hkv, d):
    """q, k, v as strided views of one (B, T, (H + 2 Hkv) * D) buffer, as a
    fused projection would leave them."""
    buf = randn_bf16(gen, b, t, (h + 2 * hkv) * d)
    q = buf[..., :h * d].unflatten(-1, (h, d))
    k = buf[..., h * d:(h + hkv) * d].unflatten(-1, (hkv, d))
    v = buf[..., (h + hkv) * d:].unflatten(-1, (hkv, d))
    return q, k, v


def check_flash_sass() -> None:
    """The forward kernel's machine code: wgmma (HGMMA) and TMA loads
    (UTMALDG) for its products and copies, no mma.sync (HMMA)."""
    code = _build.sass("flash_attention_fwd")
    counts = {op: len(re.findall(rf"\b{op}\b", code)) for op in ("HGMMA", "UTMALDG", "HMMA")}
    print(f"flash forward SASS (both head dims): {counts['HGMMA']} HGMMA, {counts['UTMALDG']} "
          f"UTMALDG, {counts['HMMA']} HMMA instructions")
    require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0,
            "the flash forward issues wgmma and TMA loads and no mma.sync")


def check_flash(card: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    row = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/flash_attention_fwd.cu",
           "replaces": "ddl_tpu/ops/flash_attention.py:84",
           "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    flops_total = bytes_total = 0.0
    # (B, T, H, Hkv, D, causal, window, kv_offset): the two slice prefills
    # (timed, summed in the row), the 124M train step's and variant C's
    # windowed prefill (timed), then the band's other shapes and the edges
    # of the 128-row query and 128-key tiles
    cases = (("variant A prefill", (8, 2048, 12, 12, 64, True, 0, 0)),
             ("variant B prefill (GQA)", (32, 1024, 12, 4, 64, True, 0, 0)),
             ("train step", (8, 1024, 12, 12, 64, True, 0, 0)),
             ("variant C prefill (GQA, window 1024)", (1, 4096, 12, 4, 64, True, 1024, 0)),
             ("non-causal", (2, 512, 12, 12, 64, False, 0, 0)),
             ("window 256", (2, 1024, 12, 4, 64, True, 256, 0)),
             ("kv_offset 200, window 64: empty-band rows", (2, 512, 12, 12, 64, True, 64, 200)),
             ("ragged T=1000", (2, 1000, 12, 4, 64, True, 0, 0)),
             ("head_dim 128", (2, 512, 8, 2, 128, True, 0, 0)),
             ("T=64, below one query tile", (2, 64, 12, 4, 64, True, 0, 0)),
             ("T=129", (2, 129, 12, 12, 64, True, 0, 0)),
             ("window 100, kv_offset 37", (2, 1000, 12, 4, 64, True, 100, 37)),
             ("strided q/k/v of one fused buffer", (2, 600, 12, 4, 64, True, 0, 0)),
             ("head_dim 128, GQA 4", (2, 777, 16, 4, 128, True, 0, 0)))
    timed = ("variant A prefill", "variant B prefill (GQA)", "train step",
             "variant C prefill (GQA, window 1024)")
    for label, (b, t, h, hkv, d, causal, window, off) in cases:
        if label.startswith("strided"):
            q, k, v = fused_qkv(gen, b, t, h, hkv, d)
        else:
            q, k, v = (randn_bf16(gen, b, t, h, d), randn_bf16(gen, b, t, hkv, d),
                       randn_bf16(gen, b, t, hkv, d))
        out, lse = flash_attention_with_lse(q, k, v, causal, window, off)
        want, want_lse = flash_attention_with_lse_plain(q, k, v, causal, window, off)
        torch.cuda.synchronize()
        empty = want_lse < -1e29  # (B, H, T): rows whose band holds no key
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        lse_err = (lse - want_lse)[~empty].abs().max().item()
        empty_out = out.float().permute(0, 2, 1, 3)[empty].abs().max().item() if empty.any() else 0.0
        print(f"flash {label} {(b, t, h, hkv, d)}: out per-row rel {rel:.2e} (tol {FLASH_TOL};"
              f" of the largest value {err / want.float().abs().max().item():.2e}), lse max "
              f"|diff| {lse_err:.2e} (tol {LSE_TOL}), {int(empty.sum())} empty-band rows, "
              f"max |out| there {empty_out}")
        require(bool(torch.isfinite(out).all()), f"flash {label} output finite")
        require(rel <= FLASH_TOL, f"flash {label} output within {FLASH_TOL}")
        require(lse_err <= LSE_TOL, f"flash {label} lse within {LSE_TOL}")
        require(empty_out == 0.0 and bool((lse[empty] == want_lse[empty]).all()),
                f"flash {label} empty-band rows exactly 0")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if label not in timed:
            continue
        del want, want_lse
        xs = [(q, k, v)] + [tuple(randn_bf16(gen, *x.shape) for x in (q, k, v))]
        ms, wall, _ = measure(lambda x: flash_attention_with_lse(*x, True, window), xs, iters=10)
        flops, nbytes = flash_work(b, t, h, hkv, d, window)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        # the yardstick: SDPA on contiguous (B, H, T, D) copies made before
        # the timed calls (its own K/V expansion for GQA is in its time);
        # the window as a boolean band mask, also made before
        sdpa_xs = [tuple(y.transpose(1, 2).contiguous() for y in x) for x in xs]
        mask = None
        if window:
            pos = torch.arange(t, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        library_ms, _, lib_kernels = measure(lambda x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, is_causal=mask is None, enable_gqa=hkv != h), sdpa_xs, iters=10)
        print(f"  device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), SDPA "
              f"{library_ms:.4f} ({'band mask' if window else 'is_causal'}; kernels: "
              + ", ".join(n[:60] for n in lib_kernels) + f"); bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): {flops / ms / 1e9:.1f} "
              f"TFLOP/s achieved, {bound / ms:.1%} of the bound")
        del sdpa_xs, mask
        if not label.startswith("variant") or window:
            continue
        plain_ms, _, _ = measure(lambda x: flash_attention_with_lse_plain(*x, True), xs,
                                 iters=3, warmup=1)
        print(f"  plain version {plain_ms:.4f} ms")
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] += library_ms
        row["bound_ms"] += bound
        flops_total += flops
        bytes_total += nbytes
    row["bound_by"] = ("operations" if flops_total / card["flops"] >= bytes_total / card["bw"]
                       else "bytes")
    print(f"flash forward row (variants A + B): kernel {row['ms']:.4f} ms, SDPA "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return row


def flash_bwd_work(b, t, h, hkv, d, which: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal backward call over the visible (query,
    key) pairs: dQ's three products (S, dP, dS K) or dK/dV's four (S, dP,
    P^T dO, dS^T Q), with q, k, v, do, lse and delta read once and dq (or
    dk and dv) written once; or the whole backward ("whole"), the least
    work the function needs: five products (S, dP, dV, dK, dQ), q, k, v,
    out, do and lse read once, dq, dk and dv written once."""
    pairs = b * h * t * (t + 1) / 2
    qkv = b * t * (2 * h + 2 * hkv) * d * 2
    if which == "dq":
        return 3 * 2 * d * pairs, qkv + 2 * b * h * t * 4 + b * t * h * d * 2
    if which == "dkdv":
        return 4 * 2 * d * pairs, qkv + 2 * b * h * t * 4 + 2 * b * t * hkv * d * 2
    return 5 * 2 * d * pairs, qkv + b * t * (2 * h + 2 * hkv) * d * 2 + b * h * t * 4


def sass_functions(code: str) -> dict[str, str]:
    """``cuobjdump -sass`` output split by kernel: {mangled name: its code}."""
    parts = re.split(r"Function : (\S+)", code)
    return dict(zip(parts[1::2], parts[2::2]))


def ptxas_functions(log: str) -> dict[str, str]:
    """An ``nvcc -Xptxas -v`` log split by kernel: {mangled name: ptxas's
    lines for it (registers, shared memory, spills)}."""
    parts = re.split(r"Compiling entry function '([^']+)'", log)
    return dict(zip(parts[1::2], parts[2::2]))


def check_flash_bwd_sass() -> None:
    """Both backward kernels at both head dims: wgmma (HGMMA) and TMA loads
    (UTMALDG) in each instantiation's machine code, no mma.sync (HMMA), and
    ptxas's report of no spills."""
    funcs = sass_functions(_build.sass("flash_attention_bwd"))
    ptxas = ptxas_functions((_build.BUILD_DIR / "flash_attention_bwd.log").read_text())
    for kernel in ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"):
        for d in (64, 128):
            name = next((n for n in funcs if f"{kernel}ILi{d}E" in n), None)
            report = next((v for n, v in ptxas.items() if f"{kernel}ILi{d}E" in n), "")
            require(name is not None and report, f"{kernel}<{d}> built")
            counts = {op: len(re.findall(rf"\b{op}\b", funcs[name]))
                      for op in ("HGMMA", "UTMALDG", "HMMA")}
            regs = re.search(r"Used (\d+) registers", report)
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            print(f"flash backward {kernel}<{d}>: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} "
                  f"UTMALDG, {counts['HMMA']} HMMA; ptxas {regs.group(1) if regs else '?'} "
                  f"registers, spills (stores, loads) {spills}")
            require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0,
                    f"{kernel}<{d}> issues wgmma and TMA loads and no mma.sync")
            require(bool(spills) and all(a == b == "0" for a, b in spills),
                    f"{kernel}<{d}> compiles without spills")


def check_dense_sass() -> None:
    """Every dense-block kernel that runs a product, forward and backward,
    at each instantiation: wgmma (HGMMA) and TMA loads (UTMALDG) in its
    machine code, no mma.sync (HMMA), and ptxas's report of no spills."""
    for lib, kernels in (("fused_dense_block", ("dense_1x1_kernelILi1E", "dense_1x1_kernelILi2E",
                                                "dense_3x3_kernelILi1E", "dense_3x3_kernelILi2E")),
                         ("fused_dense_block_bwd", ("dense_bwd_layer_kernelILi1E",
                                                    "dense_bwd_layer_kernelILi2E",
                                                    "dense_dw1_kernel", "dense_dw2_kernel"))):
        funcs = sass_functions(_build.sass(lib))
        ptxas = ptxas_functions((_build.BUILD_DIR / f"{lib}.log").read_text())
        for kernel in kernels:
            name = next((n for n in funcs if kernel in n), None)
            report = next((v for n, v in ptxas.items() if kernel in n), "")
            require(name is not None and report, f"{kernel} built")
            counts = {op: len(re.findall(rf"\b{op}\b", funcs[name]))
                      for op in ("HGMMA", "UTMALDG", "HMMA")}
            regs = re.search(r"Used (\d+) registers", report)
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            print(f"dense block {kernel}: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG, "
                  f"{counts['HMMA']} HMMA; ptxas {regs.group(1) if regs else '?'} registers, "
                  f"spills (stores, loads) {spills}")
            require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["HMMA"] == 0,
                    f"{kernel} issues wgmma and TMA loads and no mma.sync")
            require(bool(spills) and all(a == b == "0" for a, b in spills),
                    f"{kernel} compiles without spills")


def check_flash_bwd(card: dict) -> list[dict]:
    """Both backward kernels against their plain versions (f32, from the
    same bf16 inputs and the forward kernel's out and lse) at the forward's
    shapes, its tile edges and the train slice's, plus a batch-broadcast
    cotangent through autograd; dq, dk and dv timed at the train slice's
    shape (the rows), the GQA prefill's and head_dim 128 beside their
    bounds and SDPA's backward, and the whole backward (delta, dQ, dK/dV)
    at the train slice's shape beside SDPA's and a five-product bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {which: {"name": f"flash_attention_bwd_{which}", "route": "cuda",
                    "source": "ddl_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": "ddl_tpu/ops/flash_attention.py:" + ("133" if which == "dq"
                                                                     else "172"),
                    "max_abs_err": 0.0} for which in ("dq", "dkdv")}
    # (B, T, H, Hkv, D, causal, window, kv_offset): the train slice's shape
    # (timed: the rows), the forward's band shapes, then the edges of the
    # 128-query and 64-key dQ tiles and the 128-key and 64-query dK/dV
    # tiles, strided inputs and a batch-broadcast cotangent
    cases = (("train slice", (8, 1024, 12, 12, 64, True, 0, 0)),
             ("variant A prefill", (8, 2048, 12, 12, 64, True, 0, 0)),
             ("variant B prefill (GQA)", (32, 1024, 12, 4, 64, True, 0, 0)),
             ("non-causal", (2, 512, 12, 12, 64, False, 0, 0)),
             ("window 256", (2, 1024, 12, 4, 64, True, 256, 0)),
             ("kv_offset 200, window 64: empty-band rows", (2, 512, 12, 12, 64, True, 64, 200)),
             ("ragged T=1000", (2, 1000, 12, 4, 64, True, 0, 0)),
             ("head_dim 128", (2, 512, 8, 2, 128, True, 0, 0)),
             ("T=64, below one query tile", (2, 64, 12, 4, 64, True, 0, 0)),
             ("T=129", (2, 129, 12, 12, 64, True, 0, 0)),
             ("window 100, kv_offset 37", (2, 1000, 12, 4, 64, True, 100, 37)),
             ("strided q/k/v of one fused buffer", (2, 600, 12, 4, 64, True, 0, 0)),
             ("head_dim 128, GQA 4", (2, 777, 16, 4, 128, True, 0, 0)),
             ("batch-broadcast do, through autograd", (4, 300, 12, 4, 64, True, 0, 0)))
    timed = ("train slice", "variant B prefill (GQA)", "head_dim 128")
    for label, (b, t, h, hkv, d, causal, window, off) in cases:
        if label.startswith("strided"):
            q, k, v = fused_qkv(gen, b, t, h, hkv, d)
        else:
            q, k, v = (randn_bf16(gen, b, t, h, d), randn_bf16(gen, b, t, hkv, d),
                       randn_bf16(gen, b, t, hkv, d))
        if label.startswith("batch-broadcast"):
            # the cotangent of a loss that sums over the batch: stride 0 on B
            do = randn_bf16(gen, 1, t, h, d).expand(b, t, h, d)
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out, lse = flash_attention_with_lse(*qkv, causal, window, off)
            got = torch.autograd.grad(out, qkv, do)
            out, lse = out.detach(), lse.detach()
        else:
            do = randn_bf16(gen, b, t, h, d)
            out, lse = flash_attention_with_lse(q, k, v, causal, window, off)
            got = flash_attention_bwd(q, k, v, out, lse, do, None, causal, window, off)
        want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                         do.float(), None, causal, window, off)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            require(bool(torch.isfinite(g).all()), f"flash backward {label} {name} finite")
            errs[name] = grad_row_err(g, w, FLASH_BWD_FLOOR)
            abs_err = (g.float() - w).abs().max().item()
            which = "dq" if name == "dq" else "dkdv"
            rows[which]["max_abs_err"] = max(rows[which]["max_abs_err"], abs_err)
        empty = lse.permute(0, 2, 1) < -1e29  # (B, T, H): queries whose band holds no key
        unseen = (want[2] == 0).all(-1)  # (B, T, Hkv): keys no query sees (dv = sum p do)
        parts = [got[0][empty], got[1][unseen], got[2][unseen]]
        zeros = max((z.float().abs().max().item() for z in parts if z.numel()), default=0.0)
        print(f"flash backward {label} {(b, t, h, hkv, d)}: per-row rel "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (tol {FLASH_BWD_TOL}); {int(empty.sum())} empty-band queries, "
              f"{int(unseen.sum())} unseen keys, max |dq|, |dk|, |dv| there {zeros}")
        for name, e in errs.items():
            require(e <= FLASH_BWD_TOL, f"flash backward {label} {name} within {FLASH_BWD_TOL}")
        require(zeros == 0.0, f"flash backward {label}: empty-band queries and unseen keys "
                "give exactly 0")
        if label not in timed:
            continue
        del want, got
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        xs = [(q, k, v, do)] + [tuple(randn_bf16(gen, *x.shape) for x in (q, k, v, do))]
        # SDPA's backward at the same shape, the out it saved computed once
        lib_in = [tuple(y.transpose(1, 2).detach().requires_grad_() for y in x[:3]) for x in xs]
        lib_out = [F.scaled_dot_product_attention(*y, is_causal=True, enable_gqa=hkv != h)
                   for y in lib_in]
        lib_xs = list(zip(lib_out, lib_in, (x[3].transpose(1, 2) for x in xs)))
        library_ms, _, _ = measure(lambda x: torch.autograd.grad(x[0], x[1], x[2],
                                                                 retain_graph=True), lib_xs)
        pair_ms = 0.0
        for which, kernel, plain in (("dq", flash_attention_bwd_dq, flash_attention_bwd_dq_plain),
                                     ("dkdv", flash_attention_bwd_dkdv,
                                      flash_attention_bwd_dkdv_plain)):
            ms, wall, _ = measure(lambda x: kernel(*x, lse, delta, True), xs, iters=10)
            flops, nbytes = flash_bwd_work(b, t, h, hkv, d, which)
            bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
            pair_ms += ms
            plain_text = ""
            if label == "train slice":
                plain_ms, _, _ = measure(lambda x: plain(*x, lse, delta, True), xs, iters=3,
                                         warmup=1)
                plain_text = f", plain {plain_ms:.4f}"
                rows[which].update(
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                    bound_by=("operations" if flops / card["flops"] >= nbytes / card["bw"]
                              else "bytes"))
            print(f"  {label} {which}: device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f})"
                  f"{plain_text}, SDPA backward (dq, dk, dv) {library_ms:.4f}; bound "
                  f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s achieved, {bound / ms:.1%} of the bound)")
        print(f"  {label} dQ + dK/dV: {pair_ms:.4f} ms, {pair_ms / library_ms:.2f}x SDPA's "
              "backward")
        if label == "train slice":
            # the whole backward as FlashAttentionFn runs it: delta, dQ, dK/dV
            full = [(*x[:3], out, lse, x[3]) for x in xs]
            ms, wall, kernels = measure(lambda x: flash_attention_bwd(*x, None, True), full,
                                        iters=10)
            flops, nbytes = flash_bwd_work(b, t, h, hkv, d, "whole")
            bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
            delta_ms = sum(k_ms for n, k_ms in kernels.items() if "flash_bwd" not in n)
            print(f"  {label} whole backward (delta, dQ, dK/dV): device ms {ms:.4f} (wall "
                  f"{wall:.4f}) in {len(kernels)} kernels, the delta chain {delta_ms:.4f}; "
                  f"SDPA's backward {library_ms:.4f} ({ms / library_ms:.2f}x);"
                  f" five-product bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB)")
        del lib_in, lib_out, lib_xs
    return [rows["dq"], rows["dkdv"]]


def decode_inputs(gen, b, L, h, hkv, d, quant, lens):
    """q, the cache and the additive bias of one decode call; ``lens``
    (1 or B entries) are the visible prefix lengths.  An int8 cache is the
    quantized bf16 one, as kv_write stores it."""
    q = randn_bf16(gen, b, 1, h, d)
    k, v = randn_bf16(gen, b, L, hkv, d), randn_bf16(gen, b, L, hkv, d)
    mask = torch.arange(L, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
    bias = torch.where(mask, 0.0, -1e30).float()
    if not quant:
        return q, (k.reshape(b, L, hkv * d), v.reshape(b, L, hkv * d)), bias
    (kq, ks), (vq, vs) = quantize_q8(k), quantize_q8(v)
    return q, (kq.reshape(b, L, -1), ks[..., 0].transpose(1, 2).contiguous(),
               vq.reshape(b, L, -1), vs[..., 0].transpose(1, 2).contiguous()), bias


def decode_work(b, L, h, hkv, d, quant) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: the whole cache is read (K, V and, for
    int8, both scales), plus q, the bias row and the output."""
    elt = 1 if quant else 2
    nbytes = 2 * b * L * hkv * d * elt + (2 * b * hkv * L * 4 if quant else 0)
    nbytes += 2 * b * h * d * 2 + L * 4
    return 4 * b * h * L * d, nbytes


def check_decode(card: dict, quant: bool) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + quant)
    kernel, plain = ((quant_decode_attention, quant_decode_attention_plain) if quant
                     else (decode_attention, decode_attention_plain))
    name = "quant_decode_attention" if quant else "decode_attention"
    row = {"name": name, "route": "cuda", "source": "ddl_tpu_torch/csrc/decode_attention.cu",
           "replaces": "ddl_tpu/ops/decode_attention.py:" + ("105" if quant else "67"),
           "max_abs_err": 0.0}
    # (B, L, H, Hkv, D, visible lengths): the slice's caches mid-generation
    # (the main path's variant timed), a per-lane bias, a fully masked
    # first stretch of 600 keys, and L not a multiple of any tile
    # (B, L, H, Hkv, D, visible lengths): the slice's caches mid-generation
    # (the main path's variants timed: A for the bf16 kernel, B and C's
    # 1024-slot ring for the int8 one), a per-lane bias, a fully masked
    # first stretch of 600 keys, and L not a multiple of any tile
    cases = (("variant A cache", (8, 2176, 12, 12, 64, [2048 + 64])),
             ("variant B cache", (32, 1088, 12, 4, 64, [1024 + 32])),
             ("variant C ring", (1, 1024, 12, 4, 64, [1024])),
             ("per-lane bias", (8, 2176, 12, 12, 64, [2176, 2100, 1500, 900, 300, 64, 2, 1])),
             ("fully masked tile", (3, 1500, 12, 4, 64, [1500, 1500, 1500])),
             ("ragged L=1001", (2, 1001, 12, 4, 64, [1001, 999])),
             ("ragged L=300", (2, 300, 12, 4, 64, [300, 123])))
    timed = ("variant B cache", "variant C ring") if quant else ("variant A cache",)
    parts = []
    for label, (b, L, h, hkv, d, lens) in cases:
        q, cache, bias = decode_inputs(gen, b, L, h, hkv, d, quant, lens)
        if label == "fully masked tile":
            bias[:, :600] = -1e30
        got = kernel(q, *cache, bias, hkv=hkv)
        want = plain(q, *cache, bias, hkv=hkv)
        again = kernel(q, *cache, bias, hkv=hkv)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        plan = ""
        if quant:
            sp = decode_split_plan(b, L, hkv, h // hkv, d, _build.sm_count(0))
            c_smem = _build.load("decode_attention", DECODE_SIGNATURES).ddl_quant_decode_smem(
                hkv, sp.heads, sp.keys, d, h // hkv)
            plan = (f"; split {sp.splits} x {sp.keys} keys x {sp.heads} head(s), "
                    f"{sp.ctas(b, hkv)} CTAs, {sp.smem} B shared")
            require(c_smem == sp.smem, f"{name} {label}: the C side's shared memory {c_smem} is "
                    f"the plan's {sp.smem}")
        print(f"{name} {label} {(b, L, h, hkv, d)}: per-row rel err {rel:.2e} (tol {DECODE_TOL};"
              f" of the largest value {err / want.float().abs().max().item():.2e}); two calls "
              f"bit-identical: {torch.equal(got, again)}{plan}")
        require(bool(torch.isfinite(got).all()), f"{name} {label} output finite")
        require(rel <= DECODE_TOL, f"{name} {label} within {DECODE_TOL}")
        require(torch.equal(got, again), f"{name} {label}: two calls give the same bits")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if label not in timed:
            continue
        # rotate over copies of the cache (> 50 MB of L2 in all)
        nbytes_one = decode_work(b, L, h, hkv, d, quant)[1]
        xs = [(q, cache, bias)] + [decode_inputs(gen, b, L, h, hkv, d, quant, lens)
                                   for _ in range(max(3, math.ceil(60e6 / nbytes_one)) - 1)]
        ms, wall, _ = measure(lambda x: kernel(x[0], *x[1], x[2], hkv=hkv), xs,
                              iters=max(30, len(xs)))
        plain_ms, _, _ = measure(lambda x: plain(x[0], *x[1], x[2], hkv=hkv), xs, iters=5)
        if quant:  # no PyTorch call reads an int8 cache with its scales
            lib_ms = None
        else:
            lib_ms, _, _ = measure(lambda x: F.scaled_dot_product_attention(
                x[0].transpose(1, 2), x[1][0].reshape(b, L, hkv, d).transpose(1, 2),
                x[1][1].reshape(b, L, hkv, d).transpose(1, 2),
                attn_mask=(x[2] == 0)[:, None, None, :], enable_gqa=hkv != h), xs, iters=30)
        del xs
        flops, nbytes = decode_work(b, L, h, hkv, d, quant)
        bound = max(flops / card["flops"], nbytes / card["bw"]) * 1e3
        parts.append((ms, plain_ms, lib_ms, bound, flops / card["flops"] >= nbytes / card["bw"]))
        lib = "none" if quant else f"{lib_ms:.4f}"
        print(f"  {label}: device ms (wall ms per call): kernel {ms:.4f} ({wall:.4f}), plain "
              f"{plain_ms:.4f}, SDPA {lib}; bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, "
              f"{nbytes / ms / 1e6:.1f} GB/s achieved, {bound / ms:.1%} of the bound)")
    row["ms"] = sum(p[0] for p in parts)
    row["plain_ms"] = sum(p[1] for p in parts)
    row["library_ms"] = None if quant else sum(p[2] for p in parts)
    row["bound_ms"] = sum(p[3] for p in parts)
    row["bound_by"] = "operations" if all(p[4] for p in parts) else "bytes"
    if quant:
        print(f"  row: variants B + C {row['ms']:.4f} ms (bound {row['bound_ms']:.4f})")
    return row


def check_decode_groupings() -> None:
    """Both decode kernels at every (head_dim, grouping) pair they are built
    for, one small shape each: per-lane lengths (one lane sees 123 of the
    300 keys), each row within DECODE_TOL of its own largest value."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {}
    for quant in (False, True):
        kernel, plain = ((quant_decode_attention, quant_decode_attention_plain) if quant
                         else (decode_attention, decode_attention_plain))
        for d, g in DECODE_GROUPINGS:
            b, L, hkv = 2, 300, 2
            q, cache, bias = decode_inputs(gen, b, L, g * hkv, hkv, d, quant, [L, 123])
            got = kernel(q, *cache, bias, hkv=hkv)
            want = plain(q, *cache, bias, hkv=hkv)
            torch.cuda.synchronize()
            what = f"decode ({'int8' if quant else 'bf16'} cache) at D={d}, G={g}"
            require(bool(torch.isfinite(got).all()), f"{what}: output finite")
            worst[quant, d, g] = rel = row_rel_err(got, want)
            require(rel <= DECODE_TOL, f"{what}: within {DECODE_TOL} (per-row {rel:.2e})")
    for quant in (False, True):
        print(f"{'quant_decode_attention' if quant else 'decode_attention'} at every (head_dim, "
              f"grouping), (B, L, Hkv) = (2, 300, 2): per-row rel err " + ", ".join(
                  f"({d},{g}) {worst[quant, d, g]:.1e}" for d, g in DECODE_GROUPINGS)
              + f" (tol {DECODE_TOL})")


def matvec_inputs(gen, m, d, o, dtype, contract_last):
    """x (M, D), an int8 weight of the call site's layout, a positive (1, O)
    per-channel scale (as quantize_q8 leaves a QDense kernel's)."""
    x = torch.randn(m, d, generator=gen, device="cuda").to(dtype)
    w8 = torch.randint(-127, 128, (o, d) if contract_last else (d, o), generator=gen,
                       device="cuda", dtype=torch.int8)
    scale = torch.rand(1, o, generator=gen, device="cuda") * 1e-3 + 1e-4
    return x, w8, scale


def matvec_work(card: dict, m, d, o, dtype) -> tuple[float, float]:
    """(ms to move the bytes, ms for the operations) of one call: the int8
    weight, the f32 scale, x and the output each moved once; 2 M D O
    operations at the x type's rate (bf16 tensor cores, or f32 without TF32
    for f32 x).  The bound is the larger."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = d * o + 4 * o + m * d * size + m * o * size
    rate = card["flops"] if dtype == torch.bfloat16 else card["flops_f32"]
    return nbytes / card["bw"] * 1e3, 2 * m * d * o / rate * 1e3


def check_int8_matvec(card: dict) -> dict:
    """The int8 small-M matmul against its plain version at the 124M
    decode's call sites, M in (1, 3, 8), and at ragged shapes in both
    layouts and both x types; two calls bit-identical at every call site
    (M = 1 and 8); each weight's launch state's shared memory (the C side)
    equal to the Python plan's.  Then timed at M = 1 and 8 over enough
    weight copies (> 100 MB) that every launch misses L2, beside the plain
    version, cuBLAS's product with the weight already in bf16 (for the f32
    head: in f32), and ``torch._weight_int8pack_mm`` where this torch has
    it on CUDA; and the host's wall per call at M = 1, 768 -> 768, through
    a module's launch state (the decode path) and through the free
    function.  The row's times are one decode token's calls at M = 1 for
    one GQA layer and the head."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    row = {"name": "int8_matmul_small_m", "route": "cuda",
           "source": "ddl_tpu_torch/csrc/int8_matvec.cu",
           "replaces": "ddl_tpu/ops/int8_matvec.py:39", "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    t_bytes = t_ops = 0.0
    sms = _build.sm_count(0)
    cases = [*MATVEC_SHAPES, ("ragged (D, O)", 200, 1000, torch.bfloat16, False),
             ("ragged (D, O) f32", 200, 1000, torch.float32, False),
             ("ragged (O, D)", 100, 1000, torch.float32, True),
             ("ragged (O, D) bf16", 100, 1000, torch.bfloat16, True)]
    for label, d, o, dtype, last in cases:
        rels, same = [], []
        for m in (1, 3, 8):
            x, w8, scale = matvec_inputs(gen, m, d, o, dtype, last)
            got = int8_matmul_small_m(x, w8, scale, contract_last=last)
            want = int8_matmul_small_m_plain(x, w8, scale, contract_last=last)
            again = int8_matmul_small_m(x, w8, scale, contract_last=last)
            torch.cuda.synchronize()
            require(got.dtype == dtype and tuple(got.shape) == (m, o),
                    f"int8 matmul {label} M={m}: ({m}, {o}) {dtype}")
            require(bool(torch.isfinite(got).all()), f"int8 matmul {label} M={m} finite")
            rels.append(row_rel_err(got, want))
            same.append(torch.equal(got, again))
            row["max_abs_err"] = max(row["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            require(rels[-1] <= MATVEC_TOL[dtype],
                    f"int8 matmul {label} M={m} within {MATVEC_TOL[dtype]} (per-row {rels[-1]:.2e})")
            require(same[-1], f"int8 matmul {label} M={m}: two calls give the same bits")
        launch = Int8MatmulLaunch(w8, scale, contract_last=last)
        plan = matvec_plan(d, o, last, sms)
        smem = [launch.smem(m) for m in range(1, 9)]
        require(smem == [plan.smem(m) for m in range(1, 9)],
                f"int8 matmul {label}: the C side's shared memory {smem} is the plan's")
        print(f"int8 matmul {label} D={d} O={o} {str(dtype)[6:]}: per-row rel err at M=1/3/8 "
              + " / ".join(f"{r:.2e}" for r in rels) + f" (tol {MATVEC_TOL[dtype]}); two calls "
              f"bit-identical {all(same)}; {plan.ctas} CTAs, shared {smem[0]}-{smem[-1]} B")
    int8pack = hasattr(torch, "_weight_int8pack_mm")
    for label, d, o, dtype, last in MATVEC_SHAPES:
        copies = max(3, math.ceil(100e6 / (d * o)))
        for m in (1, 8):
            xs = [matvec_inputs(gen, m, d, o, dtype, last) for _ in range(copies)]
            ms, wall, _ = measure(lambda a: int8_matmul_small_m(*a, contract_last=last), xs,
                                  iters=copies)
            plain_ms, _, _ = measure(
                lambda a: int8_matmul_small_m_plain(*a, contract_last=last), xs,
                iters=min(copies, 40))
            # the unquantized path's own product at its own width
            wide = [(a[0], a[1].to(dtype)) for a in xs]
            del xs
            lib_ms, _, _ = measure(lambda a: a[0] @ (a[1].t() if last else a[1]), wide,
                                   iters=copies)
            del wide
            packed = "not available"
            if int8pack:
                pk = [matvec_inputs(gen, m, d, o, dtype, True) for _ in range(copies)]
                try:
                    pk_ms, _, _ = measure(
                        lambda a: torch._weight_int8pack_mm(a[0], a[1], a[2].reshape(-1)), pk,
                        iters=copies)
                    packed = f"{pk_ms:.4f}"
                except (RuntimeError, NotImplementedError) as e:  # a timing, not a path
                    packed = f"not available on CUDA ({str(e).splitlines()[0][:60]})"
                del pk
            tb, to = matvec_work(card, m, d, o, dtype)
            print(f"  {label} M={m}: device ms (wall ms per call) kernel {ms:.4f} ({wall:.4f}), "
                  f"plain {plain_ms:.4f}, cuBLAS {'f32' if last else 'bf16'} weight "
                  f"{lib_ms:.4f}, _weight_int8pack_mm {packed}; bound {max(tb, to):.4f} ms "
                  f"({'bytes' if tb >= to else 'operations'}; "
                  f"{(d * o) / ms / 1e6:.1f} GB/s of weight achieved)")
            if m == 1:
                n = MATVEC_CALLS[label]
                row["ms"] += n * ms
                row["plain_ms"] += n * plain_ms
                row["library_ms"] += n * lib_ms
                row["bound_ms"] += n * max(tb, to)
                t_bytes += n * tb
                t_ops += n * to
            torch.cuda.empty_cache()
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  row: one token's 7 calls at M=1 {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
          f"cuBLAS {row['library_ms']:.4f})")
    # the host's cost of a call: back-to-back calls at M = 1, 768 -> 768,
    # whose device time (a few us) is below the host's, so the CUDA-event
    # wall per call is the host's time per call
    x, w8, scale = matvec_inputs(gen, 1, 768, 768, torch.bfloat16, False)
    dense = QDense(768, 768, torch.bfloat16)
    dense.load_state_dict({"kernel": w8.cpu(), "scale": scale.cpu()})
    dense.cuda()
    with torch.inference_mode():
        _, state_wall, _ = measure(lambda a: dense(a), [x], iters=200, warmup=20)
        _, free_wall, _ = measure(lambda a: int8_matmul_small_m(a, w8, scale), [x], iters=200,
                                  warmup=20)
        _, cublas_wall, _ = measure(lambda a: a @ w8.to(torch.bfloat16), [x], iters=200,
                                    warmup=20)
    print(f"  host wall per call at M=1, 768 -> 768 (CUDA events over 200 back-to-back calls): "
          f"QDense through its launch state {state_wall * 1e3:.2f} us, the free function "
          f"{free_wall * 1e3:.2f} us; a bf16 QDense's cuBLAS product with a bf16 weight "
          f"{cublas_wall * 1e3:.2f} us")
    return row


def check_kernel_sass() -> None:
    """The int8 matmul's and the int8 decode's kernels: asynchronous copies
    (TMA tensor loads UTMALDG, bulk copies UBLKCP) in every instantiation's
    machine code, mma.sync (HMMA) where the products are on the tensor cores
    (the (D, O) matmul, the decode's scores) and not in the f32 head, and
    ptxas's report of no spills."""
    for lib, kernel, copy, hmma in (
            ("int8_matvec", "matvec_do_kernel", "UTMALDG", True),
            ("int8_matvec", "matvec_od_kernel", "UBLKCP", False),
            ("decode_attention", "quant_decode_split_kernel", "UBLKCP", True)):
        funcs = sass_functions(_build.sass(lib))
        ptxas = ptxas_functions((_build.BUILD_DIR / f"{lib}.log").read_text())
        names = sorted(n for n in funcs if kernel in n)
        require(bool(names), f"{kernel} built")
        seen = []
        for name in names:
            report = next((v for n, v in ptxas.items() if n == name), "")
            counts = {op: len(re.findall(rf"\b{op}\b", funcs[name]))
                      for op in ("UTMALDG", "UBLKCP", "HMMA", "HGMMA")}
            regs = re.search(r"Used (\d+) registers", report)
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            seen.append(f"{regs.group(1) if regs else '?'}r/{counts[copy]}/{counts['HMMA']}")
            require(counts[copy] > 0, f"{name}: {copy} in its machine code")
            require((counts["HMMA"] > 0) == hmma,
                    f"{name}: {'mma.sync' if hmma else 'no mma.sync'} in its machine code")
            require(bool(spills) and all(a == b == "0" for a, b in spills),
                    f"{name} compiles without spills (ptxas: {spills})")
        print(f"{lib} {kernel}: {len(names)} instantiations, registers/{copy}/HMMA each: "
              + ", ".join(seen) + "; no spills")


def check_gates() -> None:
    """Each model-level dispatch whose kernel cannot take the work, driven
    once on the card: the call site's gate routes it to the non-kernel
    path, so it runs, and no kernel launch is counted."""
    counters = {"flash_attention_fwd": flash_attention_with_lse,
                "decode_attention": decode_attention,
                "quant_decode_attention": quant_decode_attention,
                "int8_matmul_small_m": int8_matmul_small_m,
                "fused_dense_block": fused_dense_block}

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # LMConfig() (head_dim 32) with flash="auto" over a FLASH_AUTO_MIN_T prompt:
    # a dense prefill and dense single-token steps
    cfg = LMConfig(flash="auto")
    model = TransformerLM(cfg)
    init_lm_weights(model, SEED)
    params = {k: v.cuda() for k, v in model.state_dict().items()}
    prompt = torch.randint(0, cfg.vocab_size, (2, FLASH_AUTO_MIN_T), generator=gen,
                           device="cuda")
    before = launches()
    toks = make_lm_generator(cfg, prompt_len=FLASH_AUTO_MIN_T, max_new=4, batch=2)(params, prompt)
    torch.cuda.synchronize()
    print(f"gate: LMConfig() (head_dim {cfg.head_dim}), flash='auto', prompt "
          f"{FLASH_AUTO_MIN_T}, 4 tokens: {toks.tolist()}; launches {launches()}")
    require(launches() == before, "head_dim 32 generation launches no kernel")
    require(tuple(toks.shape) == (2, 4) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "head_dim 32 generation gives tokens inside the vocabulary")
    # MQA, 12 query heads on one K/V head, bf16 and int8 caches: the flash
    # prefill (it takes any grouping), then dense single-token steps
    cfg = LMConfig(**{**LM_124M, "n_layers": 2, "n_kv_heads": 1})
    model = TransformerLM(cfg)
    init_lm_weights(model, SEED)
    params = {k: v.cuda() for k, v in model.state_dict().items()}
    prompt = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    for quant in (False, True):
        before = launches()
        toks = make_lm_generator(cfg, prompt_len=128, max_new=4, batch=2,
                                 kv_quant=quant)(params, prompt)
        torch.cuda.synchronize()
        after = launches()
        print(f"gate: MQA (12q/1kv) decode, {'int8' if quant else 'bf16'} cache, 4 tokens: "
              f"{toks.tolist()}; launches {after}")
        require(after["decode_attention"] == before["decode_attention"]
                and after["quant_decode_attention"] == before["quant_decode_attention"],
                "MQA decode steps take the dense path")
        require(after["flash_attention_fwd"] == before["flash_attention_fwd"] + cfg.n_layers,
                "MQA prefill takes the flash kernel")
        require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "MQA tokens in vocabulary")
    del model, params
    # int8 wo at d_ff 8192, M = 8, (D, O): the kernel; an (O, D) head at
    # D = 8192, M = 8: more than the kernel stages, the large product
    w8, scale = quantize_q8(torch.randn(8192, 768, generator=torch.Generator().manual_seed(SEED)),
                            axis=0)
    wo = QDense(8192, 768, torch.bfloat16)
    wo.load_state_dict({"kernel": w8, "scale": scale})
    wo.cuda()
    x = randn_bf16(gen, 8, 8192)
    before = launches()
    with torch.inference_mode():
        y = wo(x)
    want = int8_matmul_small_m_plain(x, w8.cuda(), scale.cuda())
    torch.cuda.synchronize()
    rel = row_rel_err(y, want)
    print(f"gate: int8 wo (8192 -> 768) at M = 8: launches {launches()}, per-row rel {rel:.2e} "
          f"(tol {MATVEC_TOL[torch.bfloat16]})")
    require(launches()["int8_matmul_small_m"] == before["int8_matmul_small_m"] + 1,
            "int8 wo at d_ff 8192, M = 8 launches the kernel")
    require(rel <= MATVEC_TOL[torch.bfloat16], "int8 wo at d_ff 8192 matches its plain version")
    head_cfg = LMConfig(vocab_size=4096, d_model=8192)
    h8, hscale = quantize_q8(torch.randn(4096, 8192, generator=torch.Generator().manual_seed(SEED)),
                             axis=1)
    head = LMHead(head_cfg)
    head.load_state_dict({"kernel": h8, "scale": hscale})
    head.cuda()
    x = randn_bf16(gen, 8, 8192)
    before = launches()
    with torch.inference_mode():
        y = head(x)
    want = int8_matmul_small_m_plain(x.float(), h8.cuda(), hscale.cuda(), contract_last=True)
    torch.cuda.synchronize()
    rel = row_rel_err(y, want)
    print(f"gate: int8 head (4096, 8192) at M = 8: launches {launches()}, per-row rel "
          f"{rel:.2e} (tol {MATVEC_TOL[torch.float32]})")
    require(launches() == before, "the (O, D) head at D = 8192, M = 8 takes the large product")
    require(rel <= MATVEC_TOL[torch.float32], "the large product matches the plain version")
    # DenseNet121, dense_block_impl="fused" at compute_dtype="float32": the
    # packed blocks, one eval batch
    net = DenseNet(fused_cfg(**{"model.compute_dtype": "float32"}).model, num_stages=1)
    init_weights(net, SEED)
    net.cuda().eval()
    images = torch.rand(EVAL_BATCH, 224, 224, 3, generator=gen, device="cuda")
    before = launches()
    with torch.inference_mode():
        logits = net(images)
    torch.cuda.synchronize()
    print(f"gate: DenseNet121 'fused' in float32, one eval batch: logits {tuple(logits.shape)}, "
          f"launches {launches()}")
    require(launches() == before, "f32 DenseNet blocks take the packed path")
    require(tuple(logits.shape) == (EVAL_BATCH, net.cfg.num_classes)
            and bool(torch.isfinite(logits).all()), "f32 DenseNet logits finite")
    del net
    torch.cuda.empty_cache()


def lm_config(variant: dict) -> LMConfig:
    return LMConfig(**{**LM_124M, **(MOE_124M if variant.get("moe") else {}),
                       "n_kv_heads": variant["kv_heads"], "attn_window": variant.get("window", 0)})


def decode_model(cfg: LMConfig, params: dict, **kw) -> LMDecode:
    """An ``LMDecode`` on the card holding ``params`` (the floating dense
    kernels cast to the compute dtype once, as the generator does; int8
    kernels stay int8)."""
    with torch.device("meta"):
        model = LMDecode(cfg, **kw)
    cast = set(dense_kernel_names(model))
    model.load_state_dict({k: v.to(cfg.dtype) if k in cast and v.is_floating_point() else v
                           for k, v in params.items()}, assign=True)
    return model


def route_hooks(model, record: dict, replay: dict | None = None) -> list:
    """Forward hooks on every MoE router: the first logits each layer's
    router gives (the forward; remat's recompute gives the same) go into
    ``record``; with ``replay``, the router returns ``replay``'s logits of
    that layer instead, the gradient still flowing through its own."""
    hooks = []
    for i, moe in enumerate(m for m in model.modules() if isinstance(m, MoeMlp)):
        def hook(_mod, _args, out, i=i):
            record.setdefault(i, out.detach())
            if replay:
                return out + (replay[i] - out).detach()
        hooks.append(moe.router.register_forward_hook(hook))
    return hooks


def routing_differs(a: dict, b: dict, k: int) -> tuple[int, int]:
    """(how many, of how many) (layer, token) top-k expert sets differ
    between two paths' router logits."""
    diff = total = 0
    for i in a:
        sa = a[i].topk(k, dim=-1).indices.sort(-1).values
        sb = b[i].topk(k, dim=-1).indices.sort(-1).values
        diff += int((sa != sb).any(-1).sum())
        total += sa[..., 0].numel()
    return diff, total


def judged_with_replay(check: Callable):
    """The MoE checks' one replay rule.  ``check(replay)`` runs the paths
    (with ``replay``, the plain path's routing fed into the others through
    ``route_hooks``) and judges them: ``(failed checks, whether any routing
    decision differed, result)``.  Should a check fail where the routing
    differed, the paths run again with the plain routing replayed and that
    run's verdict stands.  Requires every check; returns the result of the
    run that stood."""
    failed, flipped, out = check(False)
    if failed and flipped:
        print(f"  failed: {failed}; again with the plain path's routing replayed into the kernel "
              "and f32 paths (router hooks)")
        failed, _, out = check(True)
    for what in failed:
        require(False, what)
    return out


def teacher_forced(cfg: LMConfig, params: dict, prompt, toks, quant: bool,
                   rolling: bool = False) -> None:
    """The generated tokens through ``LMDecode`` on three paths from the
    same weights: the kernels, the plain versions (flash, decode attention
    and, for int8 weights, the int8 matmul), the plain versions in f32.
    Checks every step's logits (the prefill's and each token's).  With
    MoE, the share of routing decisions in which the kernel path leaves
    the plain path; should a check fail where they differ, the tokens are
    forced again with the plain path's routing of each step replayed into
    the other two (``route_hooks``) and the same checks decide."""
    b, p = prompt.shape
    n = toks.shape[1]
    window = cfg.attn_window
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain = dict(decode_attend=kv_decode_plain, int8_matmul=int8_matmul_small_m_plain,
                 rolling=rolling)
    paths = {  # the plain path first: its routing is what a replay feeds the others
        "plain": (decode_model(cfg, params, attn_core=partial(
            flash_attention_plain, causal=True, window=window), **plain), cfg),
        "kernel": (decode_model(cfg, params, attn_core=partial(
            flash_attention, causal=True, window=window), rolling=rolling), cfg),
        "f32": (decode_model(f32, params, attn_core=partial(
            flash_attention_plain, causal=True, window=window), **plain), f32),
    }

    def run(replay: bool) -> list:
        caches = {k: init_kv_cache(c, b, p + n, quant=quant, rolling=rolling, device="cuda")
                  for k, (_, c) in paths.items()}
        routes, feed = {k: {} for k in paths}, {}
        hooks = [h for k, (m, _) in paths.items()
                 for h in route_hooks(m, routes[k], feed if replay and k != "plain" else None)]
        worst = 0.0
        checked = agree = flips = decisions = 0
        d_kernel = d_plain = norm = 0.0
        with torch.inference_mode():
            for i in range(n + 1):
                tok, off = (prompt, 0) if i == 0 else (toks[:, i - 1:i], p + i - 1)
                for r in routes.values():
                    r.clear()
                logits = {}
                for k, (m, _) in paths.items():
                    logits[k] = m(tok, caches[k], off, last_only=True)[0][:, -1]
                    if k == "plain":
                        feed.update(routes["plain"])
                if cfg.num_experts:
                    d, t = routing_differs(routes["kernel"], routes["plain"], cfg.expert_top_k)
                    flips, decisions = flips + d, decisions + t
                got, want, exact = logits["kernel"], logits["plain"], logits["f32"]
                big = want.abs().max()
                worst = max(worst, ((got - want).abs().max() / big).item())
                top2 = want.topk(2, dim=-1).values
                sure = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_TOL * big
                checked += int(sure.sum())
                agree += int((got.argmax(-1) == want.argmax(-1))[sure].sum())
                d_kernel += (got - exact).square().sum().item()
                d_plain += (want - exact).square().sum().item()
                norm += exact.square().sum().item()
        for h in hooks:
            h.remove()
        l2_kernel, l2_plain = math.sqrt(d_kernel / norm), math.sqrt(d_plain / norm)
        how = " (plain routing replayed)" if replay else ""
        print(f"  teacher-forced logits over {n + 1} steps{how}: kernel vs plain max |diff| "
              f"{worst:.2e} of the largest (tol {LM_LOGIT_TOL}); top-1 equal at {agree}/{checked} "
              f"(row, step) pairs whose top-2 margin exceeds the tolerance; relative L2 to the "
              f"f32 path: kernel {l2_kernel:.3e}, plain {l2_plain:.3e} (ratio "
              f"{l2_kernel / l2_plain:.3f}, tol {LM_L2_RATIO})")
        if cfg.num_experts and not replay:
            print(f"  routing: the (layer, token) top-{cfg.expert_top_k} expert sets of the kernel "
                  f"path differ from the plain path's at {flips}/{decisions} "
                  f"({flips / decisions:.4%}), prefill and steps")
        failed = [what for ok, what in (
            (worst <= LM_LOGIT_TOL, f"logits within {LM_LOGIT_TOL} of the plain path"),
            (agree == checked, "top-1 equal wherever the margin exceeds the tolerance"),
            (l2_kernel <= LM_L2_RATIO * l2_plain,
             f"kernel path within {LM_L2_RATIO}x the plain path's distance to f32"),
        ) if not ok]
        return failed, flips > 0, None

    judged_with_replay(run)


def run_lm_variant(card: dict, label: str, variant: dict, params: dict) -> dict:
    t_start = time.perf_counter()
    cfg = lm_config(variant)
    b, p, n, quant = variant["batch"], variant["prompt"], variant["new"], variant["quant"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device="cuda")
    w8 = variant.get("weights_int8", False)
    generate = make_lm_generator(cfg, prompt_len=p, max_new=n, batch=b, kv_quant=quant)
    rolling = generate.model.rolling
    generate(params, prompt)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    counters = {"flash_attention_fwd": flash_attention_with_lse,
                "decode_attention": decode_attention,
                "quant_decode_attention": quant_decode_attention,
                "int8_matmul_small_m": int8_matmul_small_m}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks = generate(params, prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # int8 weights: every step's products per layer (q, k, v, out, and a
    # dense MLP's wi and wo; a MoE block's expert banks are einsums) and its
    # head take the kernel (B <= 8 rows), and the prefill's head (its last
    # position only); the prefill's B*T rows take the large product
    products = 4 if cfg.num_experts else 6
    want = {"flash_attention_fwd": cfg.n_layers,
            "decode_attention": 0 if quant else cfg.n_layers * n,
            "quant_decode_attention": cfg.n_layers * n if quant else 0,
            "int8_matmul_small_m": (products * cfg.n_layers + 1) * n + 1 if w8 else 0}
    moe = (f"MoE {cfg.num_experts} experts top-{cfg.expert_top_k}, d_ff {cfg.d_ff}, "
           if cfg.num_experts else "")
    print(f"variant {label}: {moe}{cfg.n_heads}q/{cfg.kv_heads}kv, "
          f"{'int8' if quant else 'bf16'} cache, {'int8' if w8 else 'bf16'} weights, window "
          f"{cfg.attn_window} ({'rolling ring' if rolling else 'linear cache'}), batch {b}, "
          f"prompt {p}, {n} greedy tokens: {wall:.3f} s; launches {launches}")
    if w8:
        print(f"  int8 matmul launches expected: ({products} products x {cfg.n_layers} layers "
              f"+ the head) x {n} steps + the prefill's head = "
              f"{want['int8_matmul_small_m']}")
    for k, v in want.items():
        require(launches[k] == v, f"variant {label}: {k} launched {v} times")
    require(tuple(toks.shape) == (b, n) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"variant {label}: tokens of shape {(b, n)} inside the vocabulary")
    teacher_forced(cfg, params, prompt, toks, quant, rolling)

    # prefill (with the first token's step) and the decode slope, at equal capacity
    def timed(max_new: int, iters: int) -> float:
        g = make_lm_generator(cfg, prompt_len=p, max_new=max_new, batch=b, kv_quant=quant,
                              max_len=p + n)
        g(params, prompt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            g(params, prompt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters, g

    t_pre, _ = timed(1, 3)
    # one timed run at each length (after its warm-up) keeps the script
    # under 900 s
    t1, _ = timed(n // 2, 1)
    t2, g = timed(n, 1)
    ms_tok = (t2 - t1) / (n - n // 2) * 1e3
    caches = init_kv_cache(cfg, b, p + n, quant=quant, rolling=rolling, device="cuda")
    tok = [toks[:, i:i + 1] for i in range(4)]
    with torch.inference_mode():
        step_ms, step_wall, kernels = measure(lambda x: g.model(x, caches, p + 5), tok, iters=10)
    print(f"variant {label} on {card['name']} ({smi()}): prefill {t_pre * 1e3:.2f} ms for the "
          f"batch (prompt pass and the first step); decode {ms_tok:.3f} ms/token (slope "
          f"{n // 2} -> {n} tokens at capacity {p + n}), {b / ms_tok * 1e3:.1f} tokens/s; "
          f"decode step {step_wall:.3f} ms wall, device busy {step_ms:.3f} ms "
          f"({step_ms / step_wall:.1%}), {len(kernels)} distinct kernels")
    for name, k_ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {k_ms:8.4f} ms/step  {k_ms / step_ms:6.1%}  {name[:90]}")
    print(f"  variant {label} took {time.perf_counter() - t_start:.1f} s")
    return launches


def flash_crossover(cfg: LMConfig, params: dict) -> None:
    """The 124M prompt pass at B=1, dense vs flash attention core: the
    smallest T from which flash stays faster is FLASH_AUTO_MIN_T.  Decided
    on device time: at B=1 the eager pass's wall is host overhead that both
    cores share (and that varies by several ms between calls)."""
    models = {"dense": decode_model(cfg, params),
              "flash": decode_model(cfg, params, attn_core=partial(flash_attention, causal=True))}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    with torch.inference_mode():
        for t in CROSSOVER_T:
            prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device="cuda")
                       for _ in range(2)]
            caches = init_kv_cache(cfg, 1, t, device="cuda")
            for impl, m in models.items():
                dev, wall, _ = measure(lambda x: m(x, caches, 0, last_only=True), prompts,
                                       iters=5, warmup=2)
                times[impl, t] = dev
                print(f"  prompt pass T={t} {impl}: {dev:.3f} ms device, {wall:.3f} ms wall")
    wins = [t for t in CROSSOVER_T if times["flash", t] < times["dense", t]]
    stays = next((t for t in CROSSOVER_T if all(u in wins for u in CROSSOVER_T if u >= t)), None)
    print(f"flash vs dense prompt pass on {smi()}: flash's device time stays below dense's "
          f"from T={stays} (FLASH_AUTO_MIN_T = {FLASH_AUTO_MIN_T})")


def run_lm_slice(card: dict, variants: dict = LM_VARIANTS) -> dict:
    launches = {}
    for label, variant in variants.items():
        model = TransformerLM(lm_config(variant))
        init_lm_weights(model, SEED)
        params = model.state_dict()
        if variant.get("weights_int8"):
            params = quantize_lm_params(params)
        params = {k: v.cuda() for k, v in params.items()}
        del model
        for k, n in run_lm_variant(card, label, variant, params).items():
            launches[k] = launches.get(k, 0) + n
        if label == "A":
            flash_crossover(lm_config(variant), params)
        del params
        torch.cuda.empty_cache()
    return launches


def int8_weights_gate() -> None:
    """``bench/decode.py`` at B=1, GQA 12q/4kv, window 1024, its 4096-token
    prompt and ``GATE_NEW`` new tokens (slope n -> 2n, 2 runs each), ``kv``
    (bf16 weights, cuBLAS) and ``kv+w`` (int8 weights, the int8 matmul) in
    turns: kv, kv+w, kv+w, kv.  The step is host-bound and the host's
    speed drifts between runs, so the two models' single decode steps are
    also timed in alternation (one step of each, ``GATE_STEPS`` times;
    medians)."""
    t0 = time.perf_counter()
    cfg = decode_bench_config(kv_heads=4, window=1024)
    rates = {"kv": [], "kv+w": []}
    for quant in ("kv", "kv+w", "kv+w", "kv"):
        r = bench_decode(cfg, batch=1, prompt=4096, new=GATE_NEW, iters=2, quant=quant)
        rates[quant].append(r["decode_ms_per_tok"])
        print(f"  bench/decode.py --batch 1 --kv-heads 4 --attn-window 1024 --new {GATE_NEW} "
              f"--iters 2 --quant {quant}: {json.dumps(r)}")
    kv, kvw = (sum(v) / len(v) for v in (rates["kv"], rates["kv+w"]))
    model = TransformerLM(cfg)
    init_lm_weights(model, SEED)
    params = {"kv": model.state_dict(), "kv+w": quantize_lm_params(model.state_dict())}
    del model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen, device="cuda")
    steps, caches = {}, {}
    for quant, p in params.items():
        g = make_lm_generator(cfg, prompt_len=4096, max_new=8, batch=1, kv_quant=True)
        toks = g({k: v.cuda() for k, v in p.items()}, prompt)
        steps[quant] = (g.model, toks[:, :1])
        caches[quant] = init_kv_cache(cfg, 1, 4096 + 8, quant=True, rolling=g.model.rolling,
                                      device="cuda")
    walls = {"kv": [], "kv+w": []}
    with torch.inference_mode():
        for i in range(20 + GATE_STEPS):
            for quant, (m, tok) in steps.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                m(tok, caches[quant], 4096 + 4)
                torch.cuda.synchronize()
                if i >= 20:
                    walls[quant].append(time.perf_counter() - t)
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in walls.items()}
    print(f"int8 weights at B=1 on {smi()}: bench/decode.py kv {rates['kv']} ms/token (mean "
          f"{kv:.3f}), kv+w {rates['kv+w']} (mean {kvw:.3f}, {(kvw - kv) / kv:+.1%}); one decode "
          f"step in alternation, median of {GATE_STEPS}: kv {med['kv']:.3f} ms, kv+w {med['kv+w']:.3f} ms "
          f"({(med['kv+w'] - med['kv']) / med['kv']:+.1%}): kv+w "
          f"{'no slower than' if med['kv+w'] <= med['kv'] else 'SLOWER than'} kv")
    del steps, caches, params
    torch.cuda.empty_cache()
    print(f"  the kv / kv+w gate took {time.perf_counter() - t0:.1f} s")


def lm_adamw(params):
    """optax.adamw(3e-4): decoupled weight decay 1e-4 (optax's default)."""
    return Optimizer(params, 3e-4, weight_decay=1e-4)


def lm_train_batch(step: int = 0, batch: int = LM_TRAIN_BATCH):
    """The trainer's synthetic batch of ``step`` (Markov bytes from
    ``default_rng(1000 + step)``), on the card."""
    seqs = MarkovChain().sample(np.random.default_rng(1000 + step), batch, LM_TRAIN_SEQ + 1)
    toks = torch.from_numpy(seqs).long().cuda()
    return toks[:, :-1], toks[:, 1:]


def step_loss(model, cfg: LMConfig, inp, tgt):
    """A train step's loss as ``make_lm_step_fns`` computes it: the dense
    CE or the chunked head+CE, plus the MoE aux loss."""
    if cfg.ce_chunk or cfg.ce_vocab_chunk:
        hidden, aux = model(inp, return_hidden=True)
        return chunked_ce_loss(cfg, hidden, model.lm_head.kernel, tgt, aux, False)[0]
    logits, aux = model(inp)
    return _token_ce(logits, tgt) + cfg.moe_aux_weight * aux


def lm_step_paths(cfg: LMConfig, batch: int = LM_TRAIN_BATCH, label: str = "124M") -> dict:
    """One train step's loss and gradients three ways from the same
    weights (``init_lm_weights(seed 0)``): the kernels, the plain versions
    (forward and backward, ``flash_attention_fn_plain``), the plain
    versions in f32; the loss edge and the MoE aux loss as the config has
    them.  With MoE, the share of routing decisions in which the kernel
    path leaves the plain path; should a check fail where they differ,
    the step is taken again with the plain path's routing replayed into
    the other two (``route_hooks``) and the same checks decide.  Returns
    the losses."""
    model = TransformerLM(cfg)
    init_lm_weights(model, SEED)
    state = model.state_dict()
    del model
    inp, tgt = lm_train_batch(batch=batch)
    paths = {"kernel": (cfg, partial(flash_attention, causal=True)),
             "plain": (cfg, partial(flash_attention_fn_plain, causal=True)),
             "f32": (dataclasses.replace(cfg, compute_dtype="float32"),
                     partial(flash_attention_fn_plain, causal=True))}

    def run(replay=None):
        losses, grads, routes = {}, {}, {}
        for name, (c, core) in paths.items():
            model = TransformerLM(c, attn_core=core)
            model.load_state_dict(state)
            model.cuda()
            routes[name] = {}
            hooks = route_hooks(model, routes[name], None if name == "plain" else replay)
            loss = step_loss(model, c, inp, tgt)
            loss.backward()
            for h in hooks:
                h.remove()
            losses[name] = loss.item()
            grads[name] = {k: p.grad.float() for k, p in model.named_parameters()}
            del model, loss
            torch.cuda.empty_cache()
        return losses, grads, routes

    def judge(losses, grads, how):
        got, want, exact = grads["kernel"], grads["plain"], grads["f32"]
        big = max(g.abs().max().item() for g in want.values())
        worst = max(((got[k] - want[k]).abs().max().item(), k) for k in want)
        loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        kernel_l2, plain_l2 = l2_diff(got, exact), l2_diff(want, exact)
        print(f"{label} train step{how}, kernel vs plain path: loss {losses['kernel']:.6f} vs "
              f"{losses['plain']:.6f} (f32 {losses['f32']:.6f}; rel {loss_rel:.2e}, tol "
              f"{STEP_LOSS_TOL}); worst leaf {worst[1]} max |diff| {worst[0]:.3e} = "
              f"{worst[0] / big:.4f} of the largest gradient (tol {STEP_GRAD_TOL}); relative L2 "
              f"to the f32 gradient: kernel path {kernel_l2:.3e}, plain path {plain_l2:.3e} "
              f"(ratio {kernel_l2 / plain_l2:.3f}, tol {STEP_GRAD_RATIO})")
        for k in [k for k in want if k.startswith("block0.attn") or k.startswith("block0.moe")]:
            print(f"  grad {k}: relative L2 to f32: kernel "
                  f"{l2_diff({k: got[k]}, {k: exact[k]}):.3e}, plain "
                  f"{l2_diff({k: want[k]}, {k: exact[k]}):.3e}")
        return [what for ok, what in (
            (loss_rel <= STEP_LOSS_TOL, f"{label} train-step loss within {STEP_LOSS_TOL}"),
            (worst[0] <= STEP_GRAD_TOL * big,
             f"every {label} gradient within {STEP_GRAD_TOL} of the largest gradient"),
            (kernel_l2 <= STEP_GRAD_RATIO * plain_l2,
             f"{label} kernel path within {STEP_GRAD_RATIO}x the plain path's distance to f32"),
        ) if not ok]

    plain_routes = {}

    def check(replay: bool):
        losses, grads, routes = run(plain_routes if replay else None)
        failed = judge(losses, grads, " (plain routing replayed)" if replay else "")
        if replay or not cfg.num_experts:
            return failed, False, losses
        plain_routes.update(routes["plain"])
        shares = {name: operator.truediv(*routing_differs(routes[name], routes["plain"],
                                                          cfg.expert_top_k))
                  for name in ("kernel", "f32")}
        print(f"  routing: the (layer, token) top-{cfg.expert_top_k} expert sets differ from the "
              f"plain path's at {shares['kernel']:.4%} (kernel path) and {shares['f32']:.4%} "
              f"(f32 path) over {len(routes['plain'])} layers")
        return failed, shares["kernel"] > 0, losses

    return judged_with_replay(check)


def lm_train_sweep(cfg: LMConfig) -> None:
    """The 124M train step, flash vs dense attention core, at T in
    TRAIN_SWEEP_T and 8192 tokens per step, on device time: does dense beat
    flash anywhere from FLASH_AUTO_MIN_T on?"""
    fns = {impl: make_lm_step_fns(dataclasses.replace(cfg, flash=impl == "flash"), LMMeshSpec(),
                                  lm_adamw, SEED, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
           for impl in ("dense", "flash")}
    states = {impl: f.init_state() for impl, f in fns.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    for t in TRAIN_SWEEP_T:
        toks = torch.randint(0, cfg.vocab_size, (8192 // t, t + 1), generator=gen, device="cuda")
        batch = [(toks[:, :-1], toks[:, 1:])]
        for impl, f in fns.items():
            dev, wall, _ = measure(lambda x: f.train(states[impl], *x), batch, iters=4, warmup=2)
            times[impl, t] = dev
            print(f"  train step T={t} B={8192 // t} {impl}: {dev:.3f} ms device, {wall:.3f} ms "
                  "wall")
    dense_wins = [t for t in TRAIN_SWEEP_T if t >= FLASH_AUTO_MIN_T
                  and times["dense", t] < times["flash", t]]
    print(f"flash vs dense train step on {smi()}: dense faster at T = {dense_wins or 'none'} "
          f"of {list(TRAIN_SWEEP_T)} (FLASH_AUTO_MIN_T = {FLASH_AUTO_MIN_T})")


LOG_DIR = ROOT / "build" / "chip_smoke_logs"
FLASH_COUNTERS = {"flash_attention_fwd": flash_attention_with_lse,
                  "flash_attention_bwd_dq": flash_attention_bwd_dq,
                  "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv}


class Tee(io.StringIO):
    """Standard output kept as well as printed."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def csv_rows(job_id: str, metric: str) -> list:
    """(step, value) rows of one metric's CSV of an LM trainer job."""
    path = LOG_DIR / "by_job_id" / job_id / f"{metric}.csv"
    return [(int(r.split(",")[5]), float(r.split(",")[6]))
            for r in path.read_text().splitlines()]


def train_counted(cfg: LMConfig, batch: int, job_id: str, label: str,
                  steps: int = LM_TRAIN_STEPS, log_every: int = LM_TRAIN_LOG_EVERY) -> tuple:
    """``LMTrainer(cfg).train()`` for ``steps`` steps on the Markov
    stream, the flash counters zeroed just before and read just after
    (forward 24, dQ 12 and dK/dV 12 per step: full remat runs each layer's
    forward twice), the loss finite and falling.  Returns (the trainer,
    the launches, what it printed)."""
    run = LMRunConfig(batch=batch, seq_len=LM_TRAIN_SEQ, steps=steps,
                      log_every=log_every, log_dir=str(LOG_DIR), job_id=job_id)
    shutil.rmtree(LOG_DIR / "by_job_id" / job_id, ignore_errors=True)  # CSVs append
    trainer = LMTrainer(cfg, LMMeshSpec(), lm_adamw, run, seed=SEED)  # device: cuda
    for fn in FLASH_COUNTERS.values():
        fn.launches = 0
    out = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer.train()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in FLASH_COUNTERS.items()}
    n = steps * cfg.n_layers
    print(f"{label} LMTrainer.train(): {steps} steps of {batch} x {LM_TRAIN_SEQ} in "
          f"{wall:.2f} s; launches {launches}")
    want = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkdv": n}
    for k, v in want.items():
        require(launches[k] == v, f"{label} train: {k} launched {v} times")
    rows = csv_rows(job_id, "loss")
    print(f"  loss by logged step: {rows}")
    require(len(rows) == steps // log_every, "one loss row per logged window")
    require(all(np.isfinite(v) for _, v in rows), f"{label} train loss finite")
    require(rows[-1][1] < rows[0][1], f"{label} train loss falls from the first window to the "
            "last")
    return trainer, launches, out.getvalue()


def profile_train_step(cfg: LMConfig, batch: int, label: str, top: int = 12) -> float:
    """The train step's wall (CUDA events), device busy time, memory peak
    and top kernels, as ``make_lm_step_fns`` runs it; returns the busy ms."""
    fns = make_lm_step_fns(cfg, LMMeshSpec(), lm_adamw, SEED, batch, LM_TRAIN_SEQ)
    state = fns.init_state()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_wall, kernels = measure(lambda x: fns.train(state, *x),
                                          [lm_train_batch(batch=batch)], iters=5, warmup=2)
    print(f"{label} train step: {step_wall:.3f} ms wall (CUDA events), device busy {step_ms:.3f} "
          f"ms ({step_ms / step_wall:.1%} of the step), {len(kernels)} distinct kernels, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, k_ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {k_ms:8.4f} ms/step  {k_ms / step_ms:6.1%}  {name[:90]}")
    del fns, state
    torch.cuda.empty_cache()
    return step_ms


def run_lm_train_slice(card: dict) -> tuple[dict, dict]:
    """Phase 6; returns the train() launches and the dense bench row."""
    cfg = LMConfig(**LM_124M)  # flash on, remat "full"
    lm_step_paths(cfg)
    trainer, launches, _ = train_counted(cfg, LM_TRAIN_BATCH, "lm-124m", "124M")
    del trainer
    torch.cuda.empty_cache()
    # 5 timed steps (10 until the serving phase needed the time)
    bench = bench_lm(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, iters=5, seed=SEED)
    print(f"bench/lm.py on {card['name']} ({smi()}): {json.dumps(bench)}")
    profile_train_step(cfg, LM_TRAIN_BATCH, "124M")
    lm_train_sweep(cfg)
    return launches, bench


def check_loss_edges(card: dict) -> None:
    """Phase 7a: the dense CE and the two chunked losses at the 124M train
    shape on the same f32 inputs, forward and backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, t, d, v = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_124M["d_model"], LM_124M["vocab_size"]
    hidden = torch.randn(b, t, d, generator=gen, device="cuda")
    w = torch.randn(v, d, generator=gen, device="cuda") / d ** 0.5
    tgt = torch.randint(0, v, (b, t), generator=gen, device="cuda")
    # every other target is the position's top logit, so the accuracy is
    # about a half and its check compares the argmax of half the positions
    tgt[:, ::2] = (hidden[:, ::2] @ w.t()).argmax(-1)

    def dense(h, w):
        logits = h @ w.t()
        return _token_ce(logits, tgt), (logits.argmax(-1) == tgt).float().mean()

    edges = {
        "dense": dense,
        f"fused_chunked_ce({LOSS_EDGE_CHUNK})": lambda h, w: fused_chunked_ce(
            h, w, tgt, LOSS_EDGE_CHUNK, with_accuracy=True),
        f"fused_vocab_chunked_ce({LOSS_EDGE_VOCAB_CHUNK})": lambda h, w: fused_vocab_chunked_ce(
            h, w, tgt, LOSS_EDGE_VOCAB_CHUNK, True),
    }
    out = {}
    for name, fn in edges.items():
        h, wt = hidden.clone().requires_grad_(), w.clone().requires_grad_()

        def fwd_bwd(_=None):
            ce, acc = fn(h, wt)
            return (ce, acc, *torch.autograd.grad(ce, (h, wt)))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ce, acc, dh, dw = fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms, wall, _ = measure(fwd_bwd, [None], iters=5, warmup=1)
        out[name] = dict(ce=ce.item(), acc=acc.item(), dh=dh, dw=dw, peak=peak, ms=ms)
        print(f"loss edge {name} at hidden ({b}, {t}, {d}) f32, head ({v}, {d}) f32, TF32 off, "
              f"on {smi()}: loss {ce.item():.7f}, accuracy {acc.item():.6f}, forward+backward "
              f"{ms:.3f} ms device ({wall:.3f} ms wall), peak {peak / 1e9:.3f} GB above its "
              "start")
        del h, wt, ce, acc, dh, dw
    ref = out.pop("dense")
    for name, r in out.items():
        loss_rel = abs(r["ce"] - ref["ce"]) / abs(ref["ce"])
        dh_err = ((r["dh"] - ref["dh"]).abs().max() / ref["dh"].abs().max()).item()
        dw_err = ((r["dw"] - ref["dw"]).abs().max() / ref["dw"].abs().max()).item()
        share = r["peak"] / ref["peak"]
        print(f"  {name} vs dense: loss rel {loss_rel:.2e} (tol {LOSS_EDGE_LOSS_TOL}), dhidden "
              f"{dh_err:.2e} and dW {dw_err:.2e} of their largest dense value (tol "
              f"{LOSS_EDGE_GRAD_TOL}), accuracy {r['acc']:.6f} vs {ref['acc']:.6f}, peak "
              f"{share:.3f} of the dense edge's (at most {LOSS_EDGE_PEAK_SHARE}), device time "
              f"{r['ms'] / ref['ms']:.3f}x the dense edge's")
        require(loss_rel <= LOSS_EDGE_LOSS_TOL, f"{name} loss within {LOSS_EDGE_LOSS_TOL}")
        require(max(dh_err, dw_err) <= LOSS_EDGE_GRAD_TOL,
                f"{name} gradients within {LOSS_EDGE_GRAD_TOL} of the largest dense value")
        require(r["acc"] == ref["acc"], f"{name} accuracy equal to the dense edge's")
        require(share <= LOSS_EDGE_PEAK_SHARE,
                f"{name} peak at most {LOSS_EDGE_PEAK_SHARE} of the dense edge's")
    del out, ref
    torch.cuda.empty_cache()


def bench_row(label: str, row: dict, busy_ms: float | None = None) -> None:
    """One ``bench_lm`` row's main numbers on a line."""
    keys = ("ms_per_step", "tokens_per_sec", "hbm_peak_bytes", "loss", "moe_dispatch",
            "moe_group", "moe_drop_frac", "moe_load_max", "moe_load_min")
    shown = ", ".join(f"{k} {row[k]}" for k in keys if k in row)
    busy = "" if busy_ms is None else f"; device busy {busy_ms:.3f} ms a step"
    print(f"  {label}: {shown}{busy}")


def run_loss_edge_steps(card: dict, dense_bench: dict) -> None:
    """Phase 7b: phase 6's configuration with each chunked loss edge."""
    print(f"bench/lm.py loss edges on {card['name']} ({smi()}), batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}:")
    bench_row("dense CE (phase 6)", dense_bench)
    for edge in (dict(ce_chunk=LOSS_EDGE_CHUNK), dict(ce_vocab_chunk=LOSS_EDGE_VOCAB_CHUNK)):
        cfg = LMConfig(**LM_124M, **edge)
        name = " ".join(f"{k} {v}" for k, v in edge.items())
        lm_step_paths(cfg, label=f"124M {name}")
        row = bench_lm(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, iters=5, seed=SEED)
        print(f"bench/lm.py --flash --{name.replace('_', '-')}: {json.dumps(row)}")
        busy = profile_train_step(cfg, LM_TRAIN_BATCH, f"124M {name}", top=8)
        bench_row(name, row, busy)
        print(f"  {name} against the dense CE: ms/step "
              f"{row['ms_per_step'] / dense_bench['ms_per_step']:.3f}x, HBM peak "
              f"{row['hbm_peak_bytes'] / dense_bench['hbm_peak_bytes']:.3f}x")


def run_moe_train(card: dict) -> dict:
    """Phase 7c: the 124M MoE's train step, trainer (with the capacity
    anneal) and bench; returns the train() launches."""
    cfg = LMConfig(**{**LM_124M, **MOE_124M})
    impl, group = moe_routing_plan(cfg, LM_TRAIN_SEQ)

    def capacity(cf: float) -> int:
        return max(1, int(cfg.expert_top_k * group * cf / cfg.num_experts))

    print(f"124M MoE: {cfg.num_experts} experts top-{cfg.expert_top_k}, d_ff {cfg.d_ff}, "
          f"groups of {group}, {impl} dispatch, capacity {capacity(cfg.capacity_factor)} "
          f"(factor {cfg.capacity_factor}), batch {MOE_TRAIN_BATCH} x {LM_TRAIN_SEQ}")
    require((impl, group, capacity(cfg.capacity_factor)) == ("einsum", 256, 96),
            "the MoE resolves to the einsum dispatch, groups of 256, capacity 96")
    lm_step_paths(cfg, batch=MOE_TRAIN_BATCH, label="124M MoE")
    job = "lm-124m-moe"
    trainer, launches, printed = train_counted(
        dataclasses.replace(cfg, capacity_anneal_step=MOE_ANNEAL_STEP), MOE_TRAIN_BATCH, job,
        "124M MoE", steps=MOE_TRAIN_STEPS, log_every=MOE_TRAIN_STEPS // 2)
    for metric in ("moe_drop_frac", "moe_load_max", "moe_load_min"):
        print(f"  {metric} by logged step: {csv_rows(job, metric)}")
    anneal = [line for line in printed.splitlines() if "capacity anneal" in line]
    caps = {m.capacity_factor for m in trainer.state.model.modules() if isinstance(m, MoeMlp)}
    after = trainer.cfg.capacity_factor
    print(f"  capacity anneal: {anneal}; capacity {capacity(cfg.capacity_factor)} -> "
          f"{capacity(after)} (every MoE block at factor {sorted(caps)})")
    require(len(anneal) == 1, "one capacity anneal line")
    require(caps == {after} and capacity(after) == 64, "the running model anneals to capacity 64")
    del trainer
    torch.cuda.empty_cache()

    moe_flags = f"--experts {cfg.num_experts} --d-ff {cfg.d_ff} --moe-dispatch"
    rows, busy = {}, {}
    for name, c, flags in (
            ("MoE einsum", cfg, f"{moe_flags} einsum"),
            ("MoE sort", dataclasses.replace(cfg, moe_dispatch="sort"), f"{moe_flags} sort"),
            ("dense", LMConfig(**LM_124M), "")):
        # 5 timed steps each (10 until the serving phase needed the time)
        rows[name] = bench_lm(c, MOE_TRAIN_BATCH, LM_TRAIN_SEQ, iters=5, seed=SEED)
        print(f"bench/lm.py --batch {MOE_TRAIN_BATCH} --flash {flags}: {json.dumps(rows[name])}")
        busy[name] = profile_train_step(c, MOE_TRAIN_BATCH, f"124M {name}",
                                        top=12 if name == "MoE einsum" else 8)
    # the walls follow the host; the device busy times are what the
    # dispatches cost the card
    print(f"MoE vs dense on {card['name']} ({smi()}), batch {MOE_TRAIN_BATCH} x {LM_TRAIN_SEQ}:")
    for name, row in rows.items():
        bench_row(name, row, busy[name])
        if name != "dense":
            print(f"    {name}/dense ms/step {row['ms_per_step'] / rows['dense']['ms_per_step']:.3f}"
                  f", device busy {busy[name] / busy['dense']:.3f}")
    print(f"    MoE sort/einsum ms/step "
          f"{rows['MoE sort']['ms_per_step'] / rows['MoE einsum']['ms_per_step']:.3f}, device "
          f"busy {busy['MoE sort'] / busy['MoE einsum']:.3f}")
    return launches


def run_slice10(card: dict, dense_bench: dict) -> dict:
    """Phase 7: the chunked head+CE losses and mixture-of-experts; returns
    the MoE train() and decode launches."""
    marks = [time.perf_counter()]
    check_loss_edges(card)
    marks.append(time.perf_counter())
    run_loss_edge_steps(card, dense_bench)
    marks.append(time.perf_counter())
    launches = run_moe_train(card)
    marks.append(time.perf_counter())
    for k, n in run_lm_slice(card, MOE_DECODE).items():
        launches[k] = launches.get(k, 0) + n
    marks.append(time.perf_counter())
    parts = ", ".join(f"{what} {b - a:.1f}" for what, a, b in zip(
        ("loss edges", "their train steps", "MoE training", "MoE decode"), marks, marks[1:]))
    print(f"phase 7 took {marks[-1] - marks[0]:.1f} s ({parts})")
    return launches


# Phase 8.  DenseNet121 one-GPU training that survives its failures, in
# phase 4's fused configuration: 150 train images (5 steps an epoch), 2
# epochs, async snapshots, keep_snapshots=1, events on, the watchdog at
# 120 s.  A preemption at global step 7 (epoch 1, 3 batches in) and the
# resume of the same job id must give the uninterrupted run's batches and,
# within phase 4's limits, its losses and parameters (cuDNN's backward in
# blocks 2-3 need not be deterministic); a rollback must restore the
# snapshot bit for bit.
P8_EPOCHS, P8_PREEMPT_STEP, P8_NAN_STEP = 2, 7, 6
# (c) also holds a leak of P8_LEAK_MB from step 6 (epoch 1): the epoch-1
# hbm_sample's watermark must exceed epoch 0's by it, to within the
# allocator's 2 MiB block rounding
P8_LEAK_STEP, P8_LEAK_MB, P8_LEAK_SLACK = 6, 256, 2 << 20
# (f) the OOM child caps its process at the bytes in use plus a margin,
# lowered until a train step fails
P8_OOM_MARGINS_MB = (1024, 256, 64)
P8_OOM_JOB = "p8-oom"
P8_PHASES = ("data_wait", "h2d", "step", "fence", "eval", "checkpoint")
DENSE_COUNTERS = {"normalize": normalize, "fused_dense_block": fused_dense_block,
                  "fused_dense_block_bwd": fused_dense_block_bwd}


def p8_trainer(job_id: str, **extra) -> Trainer:
    """A phase-8 Trainer of job ``job_id``: its checkpoints in
    ``CKPT_ROOT/<job_id>``, its CSVs and events under ``LOG_DIR``."""
    os.environ["DDL_JOB_ID"] = job_id
    try:
        return Trainer(fused_cfg(**{
            "data.synthetic_num_train": TRAIN_SET, "train.max_epochs": P8_EPOCHS,
            "train.async_checkpoint": True, "train.keep_snapshots": 1,
            "train.log_dir": str(LOG_DIR), "train.checkpoint_dir": str(CKPT_ROOT / job_id),
            **extra}))
    finally:
        del os.environ["DDL_JOB_ID"]


def flat_state(tree, prefix: str = "") -> dict:
    """``{path: tensor}`` of a nested snapshot state."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {f"{prefix} (value)": torch.tensor(tree)} if isinstance(tree, (int, float)) else {}
    return {k: v for key, sub in items for k, v in flat_state(sub, f"{prefix}/{key}").items()}


def state_copy(trainer: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in flat_state(trainer.snapshot_state()).items()}


def require_bit_equal(got: dict, want: dict, what: str) -> None:
    require(got.keys() == want.keys(), f"{what}: the same {len(want)} tensors")
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    print(f"  {what}: {len(want) - len(bad)} of {len(want)} tensors bit-equal"
          + (f"; differ: {bad[:5]}" if bad else ""))
    require(not bad, f"{what} bit-equal")


class P8Run:
    """What the loop does to one phase-8 Trainer: the index batches each
    period consumed (recorded where the loader makes them, cut to the
    period's steps: the loader prefetches), each step's loss tensor, the
    learning rate of each update, and the kernel launches of ``train()``
    (comparison launches, ``excluded``, taken out)."""

    def __init__(self, trainer: Trainer) -> None:
        self.t = trainer
        self.consumed, self.periods, self.step_losses, self.lrs = [], [], [], []
        self.excluded = dict.fromkeys(DENSE_COUNTERS, 0)
        self.evals = 0
        loader, made = trainer.train_loader, []
        batches = loader._batches

        def recording_batches():
            mine = []
            made.append(mine)
            for idxs in batches():
                mine.append(tuple(int(i) for i in idxs))
                yield idxs

        loader._batches = recording_batches
        run_period, evaluate, train_step = trainer.run_period, trainer.evaluate, trainer.train_step

        def spy_period(epoch, guard=None):
            metrics, steps = run_period(epoch, guard)
            self.consumed.append((epoch, steps))
            self.periods.append((epoch, made[-1][:steps], metrics["loss"]))
            return metrics, steps

        def spy_evaluate(epoch):
            self.evals += 1
            return evaluate(epoch)

        def spy_step(images, labels):
            self.lrs.append((trainer.epochs_run, trainer.optimizer.learning_rate()))
            loss, pred = train_step(images, labels)
            self.step_losses.append((trainer.epochs_run, loss))
            return loss, pred

        trainer.run_period, trainer.evaluate, trainer.train_step = (
            spy_period, spy_evaluate, spy_step)

    def train(self, label: str, fault: str | None = None) -> dict:
        """``train()`` with ``DDL_FAULT=fault``, the counters zeroed just
        before and read just after; requires the launches the run's steps
        and eval batches account for."""
        if fault:
            os.environ["DDL_FAULT"] = fault
        faultinject.deactivate()  # re-read DDL_FAULT
        for fn in DENSE_COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            self.t.train()
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDL_FAULT", None)
            faultinject.deactivate()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches - self.excluded[k] for k, fn in DENSE_COUNTERS.items()}
        steps = sum(n for _, n in self.consumed)
        per_layer = sum(self.t.cfg.model.block_config[b]
                        for b in self.t.cfg.model.dense_block_fused_blocks)
        images = steps + self.evals * len(self.t.test_loader)
        want = {"normalize": images, "fused_dense_block": per_layer * images,
                "fused_dense_block_bwd": per_layer * steps}
        print(f"  {label}: train() {wall:.2f} s, periods {self.consumed}, {self.evals} eval "
              f"passes, launches {launches}")
        for k, n in want.items():
            require(launches[k] == n, f"{label}: {k} launched {n} times")
        return launches

    def epoch_batches(self) -> dict:
        out = {}
        for epoch, idxs, _ in self.periods:
            out.setdefault(epoch, []).extend(idxs)
        return out


def job_events(job_id: str) -> list[dict]:
    return read_events(events_path(LOG_DIR, job_id))


def print_phase_totals(label: str, events: list[dict]) -> None:
    for e in events:
        if e["kind"] == "period":
            split = ", ".join(f"{k} {e['phases'].get(k, 0.0) * 1e3:.1f}" for k in P8_PHASES)
            print(f"  {label} period {e['period']} ({e['steps']} steps from batch {e['offset']}, "
                  f"{e['elapsed']:.3f} s): {split} ms")


def step_walls(trainer: Trainer, mgr: ckpt.SnapshotManager, batches, n: int = 5) -> tuple:
    """Host ms per train step over ``n`` steps on device-resident batches,
    ending in a synchronise: without a save, then right after
    ``mgr.save`` (the host copy included, the write in flight)."""
    walls = []
    for save in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if save:
            mgr.save(99, trainer.snapshot_state())
        for i in range(n):
            trainer.train_step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n * 1e3)
    in_flight = mgr._thread is not None and mgr._thread.is_alive()
    mgr.wait()
    return walls[0], walls[1], in_flight


def run_resilience(card: dict) -> dict:
    """Phase 8: preempt, resume, the uninterrupted reference and a
    rollback on DenseNet121; returns the main-path launches of #1-#3."""
    t0 = time.perf_counter()
    os.environ["DDL_WATCHDOG_S"] = "120"
    for job in ("p8-preempt", "p8-reference", "p8-rollback"):
        shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    total = dict.fromkeys(DENSE_COUNTERS, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    # (a) preempted at global step 7: epoch 1, 3 batches in
    a = P8Run(p8_trainer("p8-preempt"))
    saved = {}
    save_snapshot = a.t.save_snapshot

    def spy_save(epoch):
        save_snapshot(epoch)
        saved[epoch] = state_copy(a.t)

    a.t.save_snapshot = spy_save
    add(a.train("(a) preempt", fault=f"preempt@step:{P8_PREEMPT_STEP}"))
    store = (CKPT_ROOT / "p8-preempt", "p8-preempt")
    verdicts = {e: ckpt.verify_snapshot(ckpt.snapshot_path(*store, e))
                for e in ckpt.snapshot_epochs(*store)}
    cursor = ckpt.read_cursor(*store, 1)
    print(f"  (a) preempted {a.t.preempted}; snapshots {verdicts}; epoch-1 cursor {cursor}")
    require(a.t.preempted, "(a) the run was preempted")
    require(sorted(verdicts) == [0, 1] and all(ok for ok, _ in verdicts.values()),
            "(a) snapshots epoch_0 and epoch_1, both verified")
    require(cursor == {"period": 1, "offset": 3}, "(a) the cursor is {period 1, offset 3}")

    # (b) a new Trainer of the same job id resumes by itself
    b = P8Run(p8_trainer("p8-preempt"))
    print(f"  (b) resumed at epoch {b.t.epochs_run}, batch {b.t._resume_offset}")
    require((b.t.epochs_run, b.t._resume_offset) == (1, 3), "(b) resumes at epoch 1, batch 3")
    require_bit_equal(state_copy(b.t), saved[1], "(b) state after the load vs (a)'s at its save")
    add(b.train("(b) resume"))
    require(b.consumed == [(1, 2)], "(b) consumed exactly epoch 1's last 2 batches")

    # (c) the same configuration uninterrupted, with gradient statistics
    grad_csv = LOG_DIR / "gradient.csv"
    grad_csv.unlink(missing_ok=True)
    c = P8Run(p8_trainer("p8-reference", **{"train.log_gradient_stats": True}))
    add(c.train("(c) reference", fault=f"leak@step:{P8_LEAK_STEP}:{P8_LEAK_MB}"))
    check_hbm_ledger(c.t)
    ab = a.epoch_batches()
    for epoch, idxs in b.epoch_batches().items():
        ab.setdefault(epoch, []).extend(idxs)
    require(ab == c.epoch_batches(), "(a)+(b) consumed (c)'s batches, epoch by epoch")
    b_loss = float(np.mean([l.item() for e, l in b.step_losses if e == 1]))
    c_loss = float(np.mean([l.item() for e, l in c.step_losses if e == 1][3:]))
    rel = abs(b_loss - c_loss) / abs(c_loss)
    print(f"  (b) vs (c) epoch-1 loss over batches 3-4: {b_loss:.6f} vs {c_loss:.6f} "
          f"(rel {rel:.2e}, tol {STEP_LOSS_TOL})")
    require(rel <= STEP_LOSS_TOL, f"(b)'s epoch-1 loss within {STEP_LOSS_TOL} of (c)'s")
    got = dict(b.t.model.named_parameters())
    want = dict(c.t.model.named_parameters())
    big = max(p.abs().max().item() for p in want.values())
    worst = max((got[k] - want[k]).abs().max().item() for k in want)
    equal = all(torch.equal(got[k], want[k]) for k in want)
    print(f"  (b) vs (c) final parameters: max |diff| {worst:.3e} = {worst / big:.2e} of the "
          f"largest parameter (tol {STEP_GRAD_TOL}); bit-equal: {equal}")
    require(worst <= STEP_GRAD_TOL * big, f"final parameters within {STEP_GRAD_TOL} of (c)'s")
    rows = grad_csv.read_text().splitlines()
    n_params = len(want)
    print(f"  (c) gradient.csv: {len(rows)} rows ({len(c.step_losses)} steps x {n_params} "
          f"parameters), first {rows[0].split(',')[4:8]}")
    require(len(rows) == len(c.step_losses) * n_params
            and all(len(r.split(",")) == 14 for r in rows),
            "gradient.csv: steps x parameters rows of 14 columns")

    # (d) a NaN at step 6 rolls back to epoch_0 with a reduced-LR grace epoch
    d = P8Run(p8_trainer("p8-rollback", **{
        "train.nan_policy": "recover", "train.nan_max_consecutive": 1,
        "train.nan_grace_periods": 1}))
    probe = to_device(*next(iter(d.t.test_loader)), d.t.device)[0]
    after = {}
    restore = d.t._rollback_restore

    def spy_restore(epoch):
        restore(epoch)
        after["state"] = state_copy(d.t)
        snap = ckpt.snapshot_path(CKPT_ROOT / "p8-rollback", "p8-rollback", epoch)
        after["file"] = flat_state(torch.load(snap / ckpt.STATE_FILE, map_location=d.t.device,
                                              weights_only=True)["state"])
        before = {k: fn.launches for k, fn in DENSE_COUNTERS.items()}
        d.t.model.eval()
        after["logits"] = d.t.eval_step(probe).clone()
        d.t.model.train()
        for k, fn in DENSE_COUNTERS.items():  # a comparison, not the main path
            d.excluded[k] += fn.launches - before[k]

    d.t._rollback_restore = spy_restore
    add(d.train("(d) rollback", fault=f"nan@step:{P8_NAN_STEP}"))
    rollbacks = [e for e in job_events("p8-rollback") if e["kind"] == "rollback"]
    print(f"  (d) rollback events {[(e['period'], e['resumed_at']) for e in rollbacks]}")
    require(len(rollbacks) == 1 and d.t.recovery.rollbacks == 1, "(d) one rollback event")
    require_bit_equal(after["state"], after["file"], "(d) state after the rollback vs epoch_0")
    fresh = p8_trainer("p8-rollback", **{"train.snapshot_job_id": "p8-rollback",
                                         "train.snapshot_epoch": 0})
    fresh.model.eval()
    fresh_logits = fresh.eval_step(probe)
    diff = (after["logits"] - fresh_logits).abs().max().item()
    print(f"  (d) eval logits through #2 after the rollback vs a fresh Trainer resumed from "
          f"epoch_0: max |diff| {diff:.3e}")
    require(torch.equal(after["logits"], fresh_logits), "(d) logits after the rollback bit-equal")
    lr = d.t.cfg.train.learning_rate
    scales = [(e, round(x / lr, 6)) for e, x in d.lrs]
    print(f"  (d) learning rate per update / schedule: {scales}")
    n = TRAIN_SET // EVAL_BATCH
    grace = d.t.cfg.train.nan_grace_scale
    require([x for _, x in scales] == [1.0] * 2 * n + [grace] * n,
            f"(d) updates at 1x, then the grace epoch at {grace}x")
    require(d.t.update_scale == 1.0 and d.t.optimizer.learning_rate() == lr,
            "(d) back to 1x after the grace epoch")
    final = d.periods[-1][2]
    require(bool(np.isfinite(final)), "(d) the loss is finite at the end")

    # (e) what a user of the trainer pays
    for label, run in (("(a)", a), ("(b)", b), ("(c)", c), ("(d)", d)):
        mgr = run.t._snapshot_mgr
        for r in (mgr.history if mgr else []):
            print(f"  {label} snapshot epoch {r['epoch']}: {r.get('bytes', 0) / 1e6:.1f} MB, "
                  f"save() {r['save_s'] * 1e3:.1f} ms on the loop, write {r['write_s'] * 1e3:.1f} "
                  f"ms in the background")
    restores = [e for e in job_events("p8-preempt") if e["kind"] == "snapshot_restore"]
    print(f"  (b) snapshot_restore dur {restores[0]['dur'] * 1e3:.1f} ms "
          f"(epoch {restores[0]['epoch']}, offset {restores[0]['offset']})")
    print(f"  (d) rollback restore {rollbacks[0]['restore_dur'] * 1e3:.1f} ms")
    for job in ("p8-preempt", "p8-reference", "p8-rollback"):
        print_phase_totals(job, job_events(job))
    timing = ckpt.SnapshotManager(CKPT_ROOT / "p8-timing", "p8-timing")
    batches = [to_device(i, l, c.t.device) for i, l in itertools.islice(c.t.train_loader, 5)]
    c.t.model.train()
    step_walls(c.t, timing, batches)  # warm-up: the pinned buffers
    plain, saving, in_flight = step_walls(c.t, timing, batches)
    print(f"  train step wall on {smi()}: {plain:.1f} ms without a save, {saving:.1f} ms with "
          f"one in flight (save() {timing.history[-1]['save_s'] * 1e3:.1f} ms of it, write "
          f"{timing.history[-1]['write_s'] * 1e3:.1f} ms, still writing at the end: {in_flight})")
    del os.environ["DDL_WATCHDOG_S"]
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s ((f) runs beside phase 11's "
          f"world); main-path launches {total}")
    return total


def check_hbm_ledger(trainer: Trainer) -> None:
    """(c)'s HBM ledger: the train step's ``hbm_plan`` over its first
    dispatch, one ``hbm_sample`` an epoch from the card's allocator (not
    synthetic) with the trainer's parameter and optimizer bytes, and the
    leak of ``P8_LEAK_MB`` from step 6 in the epoch-1 watermark."""
    events = job_events("p8-reference")
    plans = [e for e in events if e["kind"] == "hbm_plan"]
    samples = [e for e in events if e["kind"] == "hbm_sample"]
    print(f"  (c) hbm_plan {[{k: e[k] for k in hbm.PLAN_FIELDS} | {'label': e['label']} for e in plans]}")
    for e in samples:
        print(f"  (c) hbm_sample epoch {e['step']}: watermark {e['watermark']}, peak {e['peak']}, "
              f"limit {e['limit']}, synthetic {e['synthetic']}, params {e['params_bytes']}, "
              f"optimizer {e['opt_bytes']}")
    require(len(plans) == 1 and plans[0]["label"] == "train_step"
            and plans[0]["analysis"] == "allocator_peak" and plans[0]["temp_bytes"] > 0,
            "(c) one hbm_plan, the train step's, with its allocator peak")
    params = hbm.tree_shard_bytes(trainer.model.parameters())
    require(len(samples) == P8_EPOCHS and all(not e["synthetic"] for e in samples),
            "(c) one hbm_sample an epoch, from the card's allocator")
    require(all(e["params_bytes"] == params and e["opt_bytes"] == 2 * params
                and e["watermark"] >= 3 * params for e in samples),
            "(c) the samples book the parameters and Adam's two moments under the watermark")
    growth = samples[1]["watermark"] - samples[0]["watermark"]
    leak = P8_LEAK_MB << 20
    print(f"  (c) leak@step:{P8_LEAK_STEP}:{P8_LEAK_MB}: watermark grew {growth} bytes between "
          f"the epochs' samples (the leak {leak}, slack {P8_LEAK_SLACK})")
    require(abs(growth - leak) <= P8_LEAK_SLACK, "(c) the leak shows in the watermark")


def oom_child_main() -> int:
    """(f)'s child: a phase-8 Trainer on the card, the process capped at
    the bytes it holds plus a margin, lowered through
    ``P8_OOM_MARGINS_MB`` until the train step runs out of memory, where
    the loop writes ``hbm_oom_dump`` and the error propagates (a nonzero
    exit).  A margin that trains an epoch moves on to the next."""
    trainer = p8_trainer(P8_OOM_JOB, **{"train.max_epochs": len(P8_OOM_MARGINS_MB)})
    total = torch.cuda.get_device_properties(0).total_memory
    for epoch, margin in enumerate(P8_OOM_MARGINS_MB):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cap = torch.cuda.memory_allocated() + (margin << 20)
        torch.cuda.set_per_process_memory_fraction(cap / total)
        print(f"oom child: capped at {cap} bytes (in use + {margin} MiB)", flush=True)
        trainer.train(epoch + 1)
    print("oom child: every margin trained", flush=True)
    return 0


def start_oom_child() -> tuple:
    """Phase 8 (f), the OOM drill, in a child process (the allocator it caps
    is its own), started beside phase 11's two-rank world, which measures
    nothing of speed; ``check_oom_child`` reads it."""
    shutil.rmtree(LOG_DIR / "by_job_id" / P8_OOM_JOB, ignore_errors=True)
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--oom-child"],
                            stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def check_oom_child(started: tuple) -> None:
    """Phase 8 (f): the child must exit nonzero with one ``hbm_oom_dump`` in
    its job's events naming the allocation failure, its watermark, the
    resident tensors and the tracked bytes."""
    proc, out, t0 = started
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    tail = out.read().strip().splitlines()
    out.close()
    dumps = [e for e in job_events(P8_OOM_JOB) if e["kind"] == "hbm_oom_dump"]
    print(f"  phase 8 (f) the OOM child exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{[line for line in tail if line.startswith('oom child')]}; last line {tail[-1:]}")
    for e in dumps:
        print(f"  phase 8 (f) hbm_oom_dump: error {e['error'][:160]!r}, watermark {e['watermark']}, "
              f"limit {e['limit']}, params {e['params_bytes']}, optimizer {e['opt_bytes']}, "
              f"top tensors {e['buffers'][:3]}, plans {list(e['plans'])}")
    require(proc.returncode != 0, "phase 8 (f) the OOM child exits nonzero")
    require(len(dumps) == 1 and hbm.is_oom_error(RuntimeError(dumps[0]["error"]))
            and dumps[0]["watermark"] and dumps[0]["buffers"] and dumps[0]["params_bytes"],
            "phase 8 (f) one hbm_oom_dump with the failure, the watermark and the resident "
            "tensors")


# Phase 9.  The LM trainer that survives its failures, on a byte corpus
# built from this checkout (ddl_tpu_torch/tools/repo_corpus.py, into a
# fresh temporary directory: a .txt under the tree would be harvested by
# the next build), at phase 6's 124M width with phase 5 B's GQA 12q/4kv and
# vocab 256 (bytes): flash, bf16 over f32 masters, full remat, batch 16 x
# 1024, AdamW 3e-4 / weight decay 1e-4, seed 0; held-out eval and snapshots
# every 20 steps, logs every 10, events on, the watchdog at 120 s.  Cut from
# the JAX package's 2500-step corpus run (commit ea36924) to 60 steps.
P9_CFG = dict(LM_124M, vocab_size=256, n_kv_heads=4)
P9_RUN = dict(batch=16, seq_len=LM_TRAIN_SEQ, steps=60, log_every=10, eval_every=20,
              eval_frac=0.05, save_every=20)
P9_PREEMPT_STEP, P9_NAN_STEP, P9_NAN_STEPS = 33, 25, 40
# (g) nan@grad:5 (test_fault_tolerance.py's drill): 8 steps in windows of
# 2, snapshots at 4 and 8; step 5's update is non-finite, window (6, 8]'s
# loss NaN, the rollback to step 4 replays (4, 6] at the grace scale
P9_GRAD = dict(steps=8, save_every=4, log_every=2, eval_every=0, nan_policy="recover",
               nan_max_consecutive=1, nan_grace_periods=1)
P9_GRAD_NAN_STEP = 5
P9_PHASES = ("data_wait", "step", "fence", "eval", "checkpoint", "logging")
# (e): decode_quality on (c)'s last snapshot; --batch 8, so that kv+w's
# decode products take #9 (it takes at most 8 rows)
P9_QUALITY = dict(batch=8, prompt_len=64, max_new=32, eval_batches=4, gen_batches=1)
# (f): the command-line entry points at d_model 512 (8 heads of 64, which
# the flash kernels take)
P9_CLI = dict(d_model=512, layers=8, batch=8, steps=6, max_new=16)
LM_COUNTERS = {**FLASH_COUNTERS, "decode_attention": decode_attention,
               "quant_decode_attention": quant_decode_attention,
               "int8_matmul_small_m": int8_matmul_small_m}


def zero_counters(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counters(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


class P9Run:
    """What the loop does to one phase-9 ``LMTrainer``: the batch each
    step consumed (a digest of its tokens), each step's loss tensor and
    learning rate, the eval batches, and each save's wall and state."""

    def __init__(self, trainer: LMTrainer) -> None:
        self.t = trainer
        self.batches, self.losses, self.lrs, self.saves = {}, {}, [], []
        self.train_steps = self.eval_batches = 0
        sample, make_fns, save = trainer._sample_batch, trainer._make_fns, trainer.save_snapshot

        def spy_sample(step):
            inp, tgt = sample(step)
            self.batches[step] = hash((inp.tobytes(), tgt.tobytes()))
            return inp, tgt

        def spy_fns():
            # every build of the step is spied: a grace window's entry and
            # exit rebuild it (BaseTrainer._rebuild_step_fns)
            fns = make_fns()

            def spy_train(state, inp, tgt):
                self.lrs.append((state.step, state.optimizer.learning_rate()))
                state, m = fns.train(state, inp, tgt)
                self.losses[state.step - 1] = m["loss"]
                self.train_steps += 1
                return state, m

            def spy_evaluate(state, inp, tgt):
                self.eval_batches += 1
                return fns.evaluate(state, inp, tgt)

            return fns._replace(train=spy_train, evaluate=spy_evaluate)

        def spy_save(period):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(period)
            self.saves.append((trainer.state.step, time.perf_counter() - t0))
            self.saved = state_copy(trainer)

        trainer._sample_batch = spy_sample
        trainer._make_fns = spy_fns
        trainer.fns = spy_fns()
        trainer.save_snapshot = spy_save

    def train(self, label: str, fault: str | None = None, rebuild: bool = False) -> dict:
        """``train()`` with ``DDL_FAULT=fault``, the counters zeroed just
        before and read just after; requires the flash launches the run's
        train steps (24 forward, 12 dQ, 12 dK/dV: remat runs each layer's
        forward twice) and eval batches (12 forward) account for.  With
        ``rebuild`` the step is built again once the fault is live (a
        build-time fault: ``nan@grad``)."""
        if fault:
            os.environ["DDL_FAULT"] = fault
        faultinject.deactivate()  # re-read DDL_FAULT
        if rebuild:
            self.t._rebuild_step_fns()
        zero_counters(FLASH_COUNTERS)
        t0 = time.perf_counter()
        try:
            self.t.train()
            torch.cuda.synchronize()
        finally:
            os.environ.pop("DDL_FAULT", None)
            faultinject.deactivate()
        self.wall = time.perf_counter() - t0
        launches = read_counters(FLASH_COUNTERS)
        n = self.t.cfg.n_layers
        want = {"flash_attention_fwd": n * (2 * self.train_steps + self.eval_batches),
                "flash_attention_bwd_dq": n * self.train_steps,
                "flash_attention_bwd_dkdv": n * self.train_steps}
        print(f"  {label}: train() {self.wall:.2f} s, {self.train_steps} steps "
              f"{min(self.batches, default=None)}-{max(self.batches, default=None)}, "
              f"{self.eval_batches} eval batches, saves (step, s) "
              f"{[(st, round(dt, 3)) for st, dt in self.saves]}, launches {launches}")
        for k, v in want.items():
            require(launches[k] == v, f"{label}: {k} launched {v} times")
        return launches


def run_nan_grad(corpus: str) -> dict:
    """(g) ``nan@grad`` under ``nan_policy="recover"``: the fault is read
    when the step is built, so step 5's update is non-finite inside the
    step; one rollback to step 4, the replayed window at the grace scale,
    the weights and the last loss finite.  Returns the run's launches."""
    job = "p9-nan-grad"
    shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    g = P9Run(p9_trainer(job, corpus, **P9_GRAD))
    launches = g.train("(g) nan@grad", fault=f"nan@grad:{P9_GRAD_NAN_STEP}", rebuild=True)
    rollbacks = [(e["step"], e["period"], e["resumed_at"])
                 for e in job_events(job) if e["kind"] == "rollback"]
    scales = [(s, round(lr / 3e-4, 6)) for s, lr in g.lrs]
    grace = g.t.run.nan_grace_scale
    losses = {s: g.losses[s].item() for s in sorted(g.losses)}
    finite = all(torch.isfinite(p).all().item() for p in g.t.state.model.parameters())
    print(f"  (g) rollback events {rollbacks}; learning rate per update / schedule: {scales}; "
          f"losses by step {losses}; weights finite {finite}")
    require(len(rollbacks) == 1 and g.t.recovery.rollbacks == 1 and rollbacks[0][2] == 2,
            "(g) one rollback, to step 4 (window 2)")
    require([x for _, x in scales] == [1.0] * 8 + [grace] * 2 + [1.0] * 2
            and [s for s, _ in scales] == [*range(8), *range(4, 8)],
            f"(g) the replayed window at {grace}x, then 1x")
    require(g.t.state.step == P9_GRAD["steps"] and finite and math.isfinite(losses[7]),
            "(g) the replay ends at step 8 with finite weights and loss")
    del g
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_ROOT / job, ignore_errors=True)
    return launches


def p9_trainer(job_id: str, corpus: str, **extra) -> LMTrainer:
    """A phase-9 trainer of job ``job_id``: its snapshots in
    ``CKPT_ROOT/<job_id>``, its CSVs and events under ``LOG_DIR``."""
    run = LMRunConfig(**{**P9_RUN, "corpus": corpus, "job_id": job_id, "log_dir": str(LOG_DIR),
                         "checkpoint_dir": str(CKPT_ROOT / job_id), **extra})
    return LMTrainer(LMConfig(**P9_CFG), LMMeshSpec(), lm_adamw, run, seed=SEED)


def quality_run(snapshot: tuple, npy: str) -> tuple[list[dict], dict]:
    """(e): ``decode_quality.main`` on a snapshot (checkpoint dir, job id,
    step), counters zeroed just before and read just after; its JSON lines
    and the launches, which must be what the generators' steps, layers and
    products account for."""
    q = P9_QUALITY
    cfg = LMConfig(**P9_CFG)
    argv = ["--checkpoint-dir", str(snapshot[0]), "--job-id", snapshot[1], "--step",
            str(snapshot[2]), "--corpus", npy, "--d-model", str(cfg.d_model), "--layers",
            str(cfg.n_layers), "--heads", str(cfg.n_heads), "--kv-heads", str(cfg.kv_heads),
            "--vocab", str(cfg.vocab_size), "--seq-len", str(LM_TRAIN_SEQ), "--batch",
            str(q["batch"]), "--prompt-len", str(q["prompt_len"]), "--max-new", str(q["max_new"]),
            "--eval-batches", str(q["eval_batches"]), "--gen-batches", str(q["gen_batches"])]
    zero_counters(LM_COUNTERS)
    out = Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        decode_quality.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters(LM_COUNTERS)
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    steps = q["gen_batches"] * q["max_new"] * cfg.n_layers
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkdv": 0, "decode_attention": steps,
            "quant_decode_attention": 2 * steps,
            # kv+w: six products a layer and the head each step, and the
            # prefill's head (its last position); the held-out eval's
            # batch x seq rows take the widening product
            "int8_matmul_small_m": q["gen_batches"] * ((6 * cfg.n_layers + 1) * q["max_new"] + 1)}
    print(f"  (e) decode_quality.main {' '.join(argv)}: {wall:.2f} s; launches {launches}")
    for k, v in want.items():
        require(launches[k] == v, f"(e) decode_quality: {k} launched {v} times")
    require([line["metric"] for line in lines] == ["heldout_ppl", "greedy_agreement",
                                                  "greedy_agreement"],
            "(e) one heldout_ppl line and two greedy_agreement lines")
    require(all(math.isfinite(v) for line in lines for v in line.values()
                if isinstance(v, (int, float))), "(e) every number finite")
    return lines, launches


def cli_runs(corpus: str) -> dict:
    """(f): ``python -m ddl_tpu_torch.examples.train_lm`` in process with a
    checkpoint directory, then ``generate_lm`` from its snapshot with the
    bf16 cache and with int8 weights and cache; each run's launches."""
    c = P9_CLI
    ckdir = CKPT_ROOT / "p9-cli"
    shutil.rmtree(LOG_DIR / "by_job_id" / "p9-cli", ignore_errors=True)
    model = ["--d-model", str(c["d_model"]), "--layers", str(c["layers"])]
    total = {}
    runs = [("train_lm", train_lm.main,
             [*model, "--flash", "on", "--steps", str(c["steps"]), "--batch", str(c["batch"]),
              "--seq-len", str(LM_TRAIN_SEQ), "--corpus", corpus, "--checkpoint-dir",
              str(ckdir), "--save-every", str(c["steps"]), "--log-every", "3", "--job-id",
              "p9-cli", "--log-dir", str(LOG_DIR), "--lr", "3e-4"],
             {"flash_attention_fwd": 2 * c["layers"] * c["steps"],
              "flash_attention_bwd_dq": c["layers"] * c["steps"],
              "flash_attention_bwd_dkdv": c["layers"] * c["steps"]})]
    for int8 in ("none", "kv+w"):
        steps = c["layers"] * c["max_new"]
        runs.append((f"generate_lm --int8 {int8}", generate_lm.main,
                     [*model, "--checkpoint-dir", str(ckdir), "--job-id", "p9-cli", "--step",
                      str(c["steps"]), "--prompt-text", "def main() -> int:", "--prompt-len",
                      "64", "--max-new", str(c["max_new"]), "--int8", int8],
                     {"decode_attention": 0 if int8 != "none" else steps,
                      "quant_decode_attention": steps if int8 != "none" else 0,
                      "int8_matmul_small_m": (6 * c["layers"] + 1) * c["max_new"] + 1
                      if int8 == "kv+w" else 0}))
    for label, main_fn, argv, want in runs:
        zero_counters(LM_COUNTERS)
        out = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_fn(argv)
            torch.cuda.synchronize()
        launches = read_counters(LM_COUNTERS)
        print(f"  (f) {label} {' '.join(argv)}: {time.perf_counter() - t0:.2f} s; launches "
              f"{launches}")
        for k, v in {k: want.get(k, 0) for k in LM_COUNTERS}.items():
            require(launches[k] == v, f"(f) {label}: {k} launched {v} times")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    rows = csv_rows("p9-cli", "loss")
    require(ckpt.snapshot_epochs(ckdir, "p9-cli") == [c["steps"]]
            and all(math.isfinite(v) for _, v in rows), "(f) a snapshot and finite losses")
    return total


def print_lm_windows(job: str) -> None:
    for e in job_events(job):
        if e["kind"] == "period":
            split = ", ".join(f"{k} {e['phases'].get(k, 0.0) * 1e3:.1f}" for k in P9_PHASES)
            print(f"  {job} window {e['period']} ({e['steps']} steps, offset {e['offset']}, "
                  f"{e['elapsed']:.3f} s): {split} ms")


def run_lm_resilience(card: dict) -> dict:
    """Phase 9: the 124M LM preempted, resumed, uninterrupted and rolled
    back on a corpus of this checkout, then ``decode_quality`` on the
    trained snapshot and the command-line entry points; returns the
    main-path launches of #4-#9."""
    t0 = time.perf_counter()
    os.environ["DDL_WATCHDOG_S"] = "120"
    jobs = ("p9-preempt", "p9-reference", "p9-rollback")
    for job in jobs:
        shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_corpus-"))
    total = dict.fromkeys(LM_COUNTERS, 0)
    save_walls = {}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    try:
        corpus = tmp / "repo_corpus.txt"
        n_bytes = build_corpus(ROOT, corpus)
        print(f"corpus: {n_bytes} bytes from {ROOT} ({len(list(iter_files(ROOT)))} files)")

        # (a) preempted at step 33
        a = P9Run(p9_trainer("p9-preempt", str(corpus)))
        add(a.train("(a) preempt", fault=f"preempt@step:{P9_PREEMPT_STEP}"))
        store = (CKPT_ROOT / "p9-preempt", "p9-preempt")
        steps = ckpt.snapshot_epochs(*store)
        verdicts = {s: ckpt.verify_snapshot(ckpt.snapshot_path(*store, s))[0] for s in steps}
        stop = P9_PREEMPT_STEP + 1
        cursor = ckpt.read_cursor(*store, stop)
        print(f"  (a) preempted {a.t.preempted} at step {a.t.state.step}; snapshots verified "
              f"{verdicts}; cursor {cursor}")
        require(a.t.preempted and a.t.state.step == stop, f"(a) preempted after step {stop - 1}")
        require(steps == [20, stop] and all(verdicts.values()),
                f"(a) snapshots at steps 20 and {stop}, both verified")
        require({"step", "shuffle_epoch", "epoch_pos"} <= cursor.keys() and cursor["step"] == stop,
                "(a) the cursor has step, shuffle_epoch and epoch_pos")
        saved, a_batches = a.saved, a.batches
        save_walls["(a)"] = [(st, round(dt, 3)) for st, dt in a.saves]
        del a
        torch.cuda.empty_cache()

        # (b) a new trainer of the same job id resumes by itself
        b = P9Run(p9_trainer("p9-preempt", str(corpus)))
        print(f"  (b) resumed at step {b.t._start_step}, window {b.t.periods_run}, offset "
              f"{b.t._resume_offset}")
        require(b.t._start_step == stop, f"(b) resumes at step {stop}")
        require_bit_equal(state_copy(b.t), saved, "(b) state after the load vs (a)'s at its save")
        del saved
        add(b.train("(b) resume"))
        require(sorted(b.batches) == list(range(stop, P9_RUN["steps"])),
                "(b) trained exactly the remaining steps")
        save_walls["(b)"] = [(st, round(dt, 3)) for st, dt in b.saves]

        # (c) the same run uninterrupted
        c = P9Run(p9_trainer("p9-reference", str(corpus)))
        add(c.train("(c) reference"))
        save_walls["(c)"] = [(st, round(dt, 3)) for st, dt in c.saves]
        require({**a_batches, **b.batches} == c.batches,
                "(a)+(b) consumed (c)'s token batches, step by step")
        b_loss = torch.stack([b.losses[s] for s in sorted(b.losses)]).float()
        c_loss = torch.stack([c.losses[s] for s in sorted(b.losses)]).float()
        rel = ((b_loss - c_loss).abs() / c_loss.abs()).max().item()
        print(f"  (b) vs (c) losses of steps {stop}-{P9_RUN['steps'] - 1}: largest relative "
              f"difference {rel:.2e} (tol {STEP_LOSS_TOL}); bit-equal: "
              f"{torch.equal(b_loss, c_loss)}")
        require(rel <= STEP_LOSS_TOL, f"(b)'s losses within {STEP_LOSS_TOL} of (c)'s")
        got, want = (dict(r.t.state.model.named_parameters()) for r in (b, c))
        big = max(p.abs().max().item() for p in want.values())
        worst = max((got[k] - want[k]).abs().max().item() for k in want)
        equal = all(torch.equal(got[k], want[k]) for k in want)
        print(f"  (b) vs (c) final parameters: max |diff| {worst:.3e} = {worst / big:.2e} of "
              f"the largest parameter (tol {STEP_GRAD_TOL}); bit-equal: {equal}")
        require(worst <= STEP_GRAD_TOL * big, f"final parameters within {STEP_GRAD_TOL} of (c)'s")
        ppl = csv_rows("p9-reference", "val_ppl")
        losses = csv_rows("p9-reference", "loss")
        print(f"  (c) held-out perplexity by step {ppl}; train loss by logged step {losses}")
        require(len(ppl) == 3 and all(math.isfinite(v) for _, v in ppl) and ppl[-1][1] < ppl[0][1],
                "(c) held-out perplexity finite and falling")
        a_ppl = csv_rows("p9-preempt", "val_ppl")
        print(f"  (a)+(b) held-out perplexity by step {a_ppl}")
        final = (CKPT_ROOT / "p9-reference", "p9-reference", P9_RUN["steps"])
        del b, c, got, want
        torch.cuda.empty_cache()
        shutil.rmtree(store[0], ignore_errors=True)  # ~0.9 GB a snapshot

        # (d) a NaN at step 25 rolls back to step 20 with a reduced-LR grace window
        d = P9Run(p9_trainer("p9-rollback", str(corpus), steps=P9_NAN_STEPS,
                             nan_policy="recover", nan_max_consecutive=1,
                             nan_grace_periods=1))
        after = {}
        restore = d.t._rollback_restore

        def spy_restore(step):
            restore(step)
            after["state"] = state_copy(d.t)
            snap = ckpt.snapshot_path(CKPT_ROOT / "p9-rollback", "p9-rollback", step)
            after["file"] = flat_state(torch.load(snap / ckpt.STATE_FILE, map_location="cuda",
                                                  weights_only=True)["state"])
            after["step"] = step

        d.t._rollback_restore = spy_restore
        add(d.train("(d) rollback", fault=f"nan@step:{P9_NAN_STEP}"))
        save_walls["(d)"] = [(st, round(dt, 3)) for st, dt in d.saves]
        rollbacks = [e for e in job_events("p9-rollback") if e["kind"] == "rollback"]
        events = [(e["step"], e["period"], e["resumed_at"]) for e in rollbacks]
        print(f"  (d) rollback events {events}, restored step {after.get('step')}")
        require(len(rollbacks) == 1 and d.t.recovery.rollbacks == 1 and after["step"] == 20,
                "(d) one rollback, to step 20")
        require_bit_equal(after["state"], after["file"], "(d) state after the rollback vs step 20")
        del after
        scales = [(s, round(lr / 3e-4, 6)) for s, lr in d.lrs]
        grace = d.t.run.nan_grace_scale
        print(f"  (d) learning rate per update / schedule: {scales}")
        require([x for _, x in scales] == [1.0] * 30 + [grace] * 10 + [1.0] * 10
                and [s for s, _ in scales] == [*range(30), *range(20, 40)],
                f"(d) updates at 1x, the window after the rollback at {grace}x, then 1x")
        d_loss = csv_rows("p9-rollback", "loss")
        require(d.t.state.step == P9_NAN_STEPS and math.isfinite(d_loss[-1][1]),
                "(d) the run ends with a finite loss")
        del d
        torch.cuda.empty_cache()
        shutil.rmtree(CKPT_ROOT / "p9-rollback", ignore_errors=True)

        add(run_nan_grad(str(corpus)))

        # (e) decode_quality on (c)'s last snapshot
        lines, launches = quality_run(final, str(corpus) + ".npy")
        for line in lines:
            print(f"  (e) {json.dumps(line)}")
        add(launches)

        # what a user of the trainer pays
        size = (ckpt.snapshot_path(*final) / ckpt.STATE_FILE).stat().st_size
        print(f"  snapshot {size / 1e6:.1f} MB (model, AdamW moments, step); synchronous saves "
              f"(step, s): {save_walls}")
        periods = [e for e in job_events("p9-reference") if e["kind"] == "period"]
        saving = sum(e["phases"].get("checkpoint", 0.0) for e in periods)
        windows = sum(e["elapsed"] for e in periods)
        n = P9_RUN["steps"]
        print(f"  (c) train ms/step on {smi()}: {windows / n * 1e3:.1f} without snapshots (the "
              f"windows' walls), {(windows + saving) / n * 1e3:.1f} with them (+ the checkpoint "
              f"phases, {saving:.2f} s for {len(save_walls['(c)'])} saves)")
        restores = [e for e in job_events("p9-preempt") if e["kind"] == "snapshot_restore"]
        print(f"  (b) snapshot_restore dur {restores[0]['dur']:.3f} s (step {restores[0]['epoch']},"
              f" window {restores[0]['period']}, offset {restores[0]['offset']}); (d) rollback "
              f"restore {rollbacks[0]['restore_dur']:.3f} s")
        for job in jobs:
            print_lm_windows(job)

        # (f) the command-line entry points
        add(cli_runs(str(corpus)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del os.environ["DDL_WATCHDOG_S"]
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s; main-path launches {total}")
    return total


# Phase 10.  The command line on image files: the reference's user path
# (single.py over a folder of 224x224 PNGs and a CSV of labels) through
# ``ddl_tpu_torch.cli`` with phase 4's fused configuration, DenseNet121 at
# full width and depth, batch 30, 5 classes, 2 epochs.  Cut from APTOS's
# 2930 + 732 images to the synthetic set's first 90 + 60, written as PNG
# files: 3 train steps and 2 eval batches an epoch.  (e) is preempted at
# global step 4 (epoch 1, batch 1) and relaunched by the supervisor.
P10_TRAIN, P10_TEST, P10_EPOCHS, P10_PREEMPT_STEP = 90, 60, 2, 4
P10_MEMORY_EPOCHS = 1  # (d), held to (c) at the end of that epoch (the phase's time)
P10_FUSED = ("model.compute_dtype=bfloat16", "model.dense_block_impl=fused",
             "model.pallas_normalize=true", f"train.max_epochs={P10_EPOCHS}")
P10_JOBS = ("p10-files", "p10-memory", "p10-supervised")


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` ((H, W, 3) uint8) as libpng writes one
    by default: each row under the filter (0-4) whose bytes, read as
    signed, have the least absolute sum, and the zlib stream (level 6) in
    IDAT chunks of 8 KiB.  numpy and the standard library only, since PIL
    may be absent."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    left, up, up_left = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, 3:], up[1:], up_left[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    filtered = (np.stack([x, x - left, x - up, x - (left + up) // 2, x - paeth]) % 256
                ).astype(np.uint8)
    kind = np.abs(filtered.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    raw = np.concatenate([kind.astype(np.uint8)[:, None], filtered[kind, np.arange(h)]], axis=1)
    stream = zlib.compress(raw.tobytes(), 6)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", stream[i:i + 8192]) for i in range(0, len(stream), 8192))
            + chunk(b"IEND", b""))


def fundus_like(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` seeded (size, size, 3) uint8 images shaped like a fundus
    photograph rather than like the synthetic set's per-pixel noise: a
    smooth colour field (a random 6x6 grid, upsampled bilinearly) inside
    a lit disc on black, with a sensor noise of about one level.  Such
    files take filters 1-4 and long matches where the synthetic set's are
    mostly literals."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 5, size)
    i0 = np.minimum(t.astype(int), 4)
    frac = (t - i0)[:, None]
    yy, xx = np.mgrid[0:size, 0:size] - (size - 1) / 2
    disc = (np.hypot(yy, xx) < 0.46 * size)[..., None]
    out = []
    for _ in range(n):
        grid = rng.uniform([40, 10, 0], [230, 120, 60], (6, 6, 3))
        rows = grid[i0] * (1 - frac[..., None]) + grid[i0 + 1] * frac[..., None]
        field = rows[:, i0] * (1 - frac[None]) + rows[:, i0 + 1] * frac[None]
        img = (field + rng.normal(0, 1, field.shape)) * disc
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def write_aptos_tree(root: Path, train, test) -> None:
    """The APTOS layout under ``root``: ``train.csv`` (new_id_code,
    diagnosis) beside ``train_images/<id>.png`` and ``test.csv`` (id_code,
    diagnosis) beside ``test_images/<id>.png``, from two datasets of
    (uint8 image, label); the files are written on a thread pool."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for ds, name, col in ((train, "train", "new_id_code"), (test, "test", "id_code")):
            (root / f"{name}_images").mkdir(parents=True, exist_ok=True)

            def write(i: int, ds=ds, name=name) -> str:
                img, label = ds[i]
                (root / f"{name}_images" / f"{name}{i:05d}.png").write_bytes(png_bytes(img))
                return f"{name}{i:05d},{label}"

            rows = [f"{col},diagnosis", *pool.map(write, range(len(ds)))]
            (root / f"{name}.csv").write_text("\n".join(rows) + "\n")


@contextlib.contextmanager
def recording_trainer(states: list):
    """While open, every Trainer the command line builds copies its whole
    state (parameters, statistics, Adam moments) into ``states`` after
    each train step."""
    real = train_pkg.Trainer

    def make(cfg, device=None):
        t = real(cfg, device=device)
        step = t.train_step

        def spy(images, labels):
            out = step(images, labels)
            states.append(state_copy(t))
            return out

        t.train_step = spy
        return t

    train_pkg.Trainer = make
    try:
        yield
    finally:
        train_pkg.Trainer = real


def cli_counted(label: str, job: str, args: list[str], steps: int, evals: int) -> tuple:
    """``cli.main(args)`` in this process as job ``job``, #1-#3's counters
    and the loader's batch counts zeroed just before and read just after;
    requires the launches the steps and eval batches account for (phase
    4's formula) and every batch decoded by the native decoder when
    ``data.dataset_dir`` is set.  Returns (the Trainer, the launches)."""
    zero_counters(DENSE_COUNTERS)
    native.batches.update(native=0, pil=0)
    os.environ["DDL_JOB_ID"] = job
    t0 = time.perf_counter()
    try:
        trainer = cli.main(args)
        torch.cuda.synchronize()
    finally:
        del os.environ["DDL_JOB_ID"]
    wall = time.perf_counter() - t0
    launches = read_counters(DENSE_COUNTERS)
    per_layer = sum(trainer.cfg.model.block_config[b]
                    for b in trainer.cfg.model.dense_block_fused_blocks)
    want = {"normalize": steps + evals, "fused_dense_block": per_layer * (steps + evals),
            "fused_dense_block_bwd": per_layer * steps}
    periods = [e for e in job_events(job) if e["kind"] == "period"]
    walls = [e["elapsed"] for e in periods]
    waits = [e["phases"].get("data_wait", 0.0) for e in periods]
    print(f"  {label}: cli.main {wall:.2f} s (epochs {', '.join(f'{x:.3f}' for x in walls)} "
          f"s; data_wait {', '.join(f'{x * 1e3:.1f}' for x in waits)} ms, "
          f"{sum(waits) / sum(walls):.2%} of the epochs' walls), "
          f"launches {launches}, loader batches {native.batches}")
    for k, n in want.items():
        require(launches[k] == n, f"{label}: {k} launched {n} times")
    if trainer.cfg.data.dataset_dir:
        require(native.batches == {"native": steps + evals, "pil": 0},
                f"{label}: all {steps + evals} batches decoded natively, none through PIL")
    for metric in ("loss", "qwk"):
        rows = csv_rows(job, metric)
        require([e for e, _ in rows] == list(range(trainer.cfg.train.max_epochs))
                and all(math.isfinite(v) for _, v in rows),
                f"{label}: {metric}.csv has a finite row for each epoch")
    return trainer, launches


def run_cli_files(card: dict) -> dict:
    """Phase 10: the command line on APTOS-layout PNG files, the same run
    over the in-memory set, and a supervised run preempted and
    relaunched; returns the main-path launches of #1-#3."""
    t0 = time.perf_counter()
    for job in P10_JOBS:
        shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_aptos-"))
    total = dict.fromkeys(DENSE_COUNTERS, 0)
    try:
        # (a) the data, while (b)'s decoder builds beside it
        ta = time.perf_counter()
        found = native.probe()

        def timed_build():
            tb = time.perf_counter()
            return native.build(**found), time.perf_counter() - tb

        with ThreadPoolExecutor(1) as pool:
            building = pool.submit(timed_build)
            train_ds = SyntheticAptosDataset(P10_TRAIN, 224, 5, seed=1)
            test_ds = SyntheticAptosDataset(P10_TEST, 224, 5, seed=2)
            tree = tmp / "aptos"
            write_aptos_tree(tree, train_ds, test_ds)
            size = sum(f.stat().st_size for f in tree.rglob("*.png"))
            print(f"  (a) {P10_TRAIN} + {P10_TEST} PNG files, {size / 1e6:.1f} MB, "
                  f"{time.perf_counter() - ta:.2f} s")
            # (b)'s batch of photograph-like files
            (tmp / "fundus").mkdir()
            fundus = fundus_like(EVAL_BATCH, 224, seed=3)
            fundus_paths = [tmp / "fundus" / f"{i:05d}.png" for i in range(EVAL_BATCH)]
            with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as writers:
                list(writers.map(lambda f, img: f.write_bytes(png_bytes(img)), fundus_paths,
                                 fundus))
            lib_path, build_s = building.result()

        # (b) the decoder, on the tree's files and on a batch of
        # photograph-like ones
        print(f"  (b) probe {found}; {lib_path.name} built in {build_s:.2f} s (beside (a))")
        require(native.loader_lib() is not None, "(b) the native decoder loads")
        paths = [tree / "train_images" / f"train{i:05d}.png" for i in range(EVAL_BATCH)]
        want = np.stack([train_ds[i][0] for i in range(EVAL_BATCH)])
        require(native.image_size(paths[0]) == (224, 224), "(b) image_size is (224, 224)")
        for kind, files, arrays in (("synthetic", paths, want), ("fundus-like", fundus_paths,
                                                                 fundus)):
            got = native.load_batch(files, 224, 224)
            require(got is not None and np.array_equal(got, arrays),
                    f"(b) load_batch of {EVAL_BATCH} {kind} files bit-equal to their arrays")
            decode_ms = []
            for _ in range(5):
                tc = time.perf_counter()
                native.load_batch(files, 224, 224)
                decode_ms.append((time.perf_counter() - tc) * 1e3)
            size = sum(f.stat().st_size for f in files)
            print(f"  (b) on {smi()}: decode of {EVAL_BATCH} {kind} files ({size / 1e6:.2f} MB) "
                  f"{np.median(decode_ms):.3f} ms (median of 5: "
                  f"{', '.join(f'{x:.3f}' for x in decode_ms)}; {os.cpu_count()} host cores)")
        pinned = torch.from_numpy(want).pin_memory()
        h2d_ms = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pinned.to("cuda", non_blocking=True)
            end.record()
            end.synchronize()
            h2d_ms.append(start.elapsed_time(end))
        print(f"  (b) pinned host-to-device copy of the {want.nbytes / 1e6:.2f} MB batch "
              f"{np.median(h2d_ms):.3f} ms (median of 5)")

        # (c) the command line on the files, in this process
        tc = time.perf_counter()
        steps, evals = P10_EPOCHS * P10_TRAIN // EVAL_BATCH, P10_EPOCHS * P10_TEST // EVAL_BATCH
        states: list = []

        def args(job: str, *data: str) -> list[str]:
            return ["--preset", "single", "--set", *P10_FUSED, f"train.log_dir={LOG_DIR}",
                f"train.checkpoint_dir={CKPT_ROOT / job}", "train.auto_resume=false", *data]

        with recording_trainer(states):
            c, launches = cli_counted("(c) files", "p10-files",
                                      args("p10-files", f"data.dataset_dir={tree}"), steps, evals)
        for k, n in launches.items():
            total[k] += n
        require(len(states) == steps, f"(c) {steps} train steps")
        print(f"  (c) took {time.perf_counter() - tc:.1f} s")

        # (d) the same run over the in-memory synthetic set
        td = time.perf_counter()
        d, launches = cli_counted("(d) memory", "p10-memory", args(
            "p10-memory", "data.dataset_dir=", f"data.synthetic_num_train={P10_TRAIN}",
            f"data.synthetic_num_test={P10_TEST}", f"train.max_epochs={P10_MEMORY_EPOCHS}"),
            steps * P10_MEMORY_EPOCHS // P10_EPOCHS, evals * P10_MEMORY_EPOCHS // P10_EPOCHS)
        for k, n in launches.items():
            total[k] += n
        c_loss = csv_rows("p10-files", "loss")[:P10_MEMORY_EPOCHS]
        d_loss = csv_rows("p10-memory", "loss")
        print(f"  (d) epoch losses {[v for _, v in d_loss]} vs (c)'s {[v for _, v in c_loss]}")
        require(c_loss == d_loss, "(d)'s epoch losses bit-equal to (c)'s")
        at = P10_MEMORY_EPOCHS * P10_TRAIN // EVAL_BATCH - 1
        require_bit_equal(state_copy(d), states[at], f"(d) final state vs (c)'s after step {at}")
        print(f"  (d) took {time.perf_counter() - td:.1f} s")
        del c, d

        # (e) supervised, preempted at step 4 and relaunched
        te = time.perf_counter()
        store = (CKPT_ROOT / "p10-supervised", "p10-supervised")
        env = dict(os.environ, DDL_JOB_ID="p10-supervised", DDL_LOG_DIR=str(LOG_DIR),
                   DDL_CHECKPOINT_DIR=str(store[0]), DDL_WATCHDOG_S="120",
                   DDL_FAULT=f"preempt@step:{P10_PREEMPT_STEP}")
        for var in ("DDL_FAULT_STATE", "DDL_FAULT_PERSIST", "DDL_RELAUNCH_TS", "DDL_SUPERVISED"):
            env.pop(var, None)
        proc = subprocess.run(
            [sys.executable, "-m", "ddl_tpu_torch.cli", "train", "--supervise",
             "--max-restarts", "2", "--preset", "single", "--set", *P10_FUSED,
             f"data.dataset_dir={tree}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("[supervisor]", "Epoch",
                                                                          "Preempted", "Resuming"))]
        print("\n".join(f"  (e) | {ln}" for ln in lines))
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
        require(proc.returncode == 0, "(e) the supervised run exits 0")
        events = job_events("p10-supervised")
        kinds = [e["kind"] for e in events]
        relaunches = [e for e in events if e["kind"] == "supervisor_relaunch"]
        dones = [e for e in events if e["kind"] == "supervisor_done"]
        latency = [e for e in events if e["kind"] == "restart_latency"]
        restores = [e for e in events if e["kind"] == "snapshot_restore"]
        print(f"  (e) relaunches {[(e['reason'], e['rc']) for e in relaunches]}, done "
              f"{[(e['rc'], e['gave_up']) for e in dones]}, snapshot_restore "
              f"{[(e['epoch'], e['period'], e['offset'], round(e['dur'], 3)) for e in restores]}")
        require("supervisor_start" in kinds, "(e) a supervisor_start event")
        require([e["reason"] for e in relaunches] == ["preempt"], "(e) one relaunch, on preempt")
        require([(e["rc"], e["gave_up"]) for e in dones] == [(0, False)],
                "(e) supervisor_done with rc 0")
        require(len(restores) == 1 and (restores[0]["period"], restores[0]["offset"])
                == divmod(P10_PREEMPT_STEP + 1, P10_TRAIN // EVAL_BATCH),
                "(e) one snapshot_restore at the preemption's cursor")
        require(len(latency) == 1, "(e) one restart_latency event")
        starts = [e["ts"] for e in events if e["kind"] == "run_start"]
        origin = latency[0]["decision_ts"]
        print(f"  (e) relaunch: the child's exit to its first step (restart_latency) "
              f"{latency[0]['latency']:.3f} s: to the new Trainer's run_start "
              f"{starts[-1] - origin:.3f} s (process, imports, CUDA, the model), to the end of "
              f"its snapshot_restore {restores[0]['ts'] - origin:.3f} s, then the first step")
        # the supervised run's last snapshot against (c)'s state at its cursor
        epoch = ckpt.latest_epoch(*store)
        cursor = ckpt.read_cursor(*store, epoch)
        at = cursor["period"] * (P10_TRAIN // EVAL_BATCH) + cursor["offset"] - 1
        saved = flat_state(torch.load(ckpt.snapshot_path(*store, epoch) / ckpt.STATE_FILE,
                                      map_location="cuda", weights_only=True)["state"])
        print(f"  (e) last snapshot epoch_{epoch}, cursor {cursor}: (c)'s state after step {at}")
        require_bit_equal(saved, states[at], "(e) last snapshot vs (c)'s state at its cursor")
        # the preempted epoch logs its first batches and an eval, the relaunch
        # its last batch and an eval: each epoch's last eval is of its end
        e_rows = {m: dict(csv_rows("p10-supervised", m)) for m in ("val_loss", "qwk")}
        c_rows = {m: dict(csv_rows("p10-files", m)) for m in e_rows}
        print(f"  (e) each epoch's last val_loss and qwk {e_rows}")
        require(e_rows == c_rows, "(e) each epoch's last val_loss and qwk bit-equal to (c)'s")
        print(f"  (e) took {time.perf_counter() - te:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s; main-path launches {total}")
    return total


# Phase 11: data parallelism on the one card, two ranks over gloo (NCCL
# refuses two ranks on one GPU), each a process started by the port's
# spawner.  (a) SGD, not Adam: Adam's first step is lr * sign(g), which
# turns f32 noise on near-zero gradients into full steps.
P11_WORLD, P11_TRAIN = 2, 90
P11_LOSS_TOL, P11_PARAM_TOL, P11_STATS_TOL, P11_LOGIT_TOL = 1e-5, 1e-4, 1e-4, 1e-4
P11_FUSED_LOSS_TOL = 1e-2
P11_FLOOR_X = 2.0
# one timed step a rank (two until the pod phase needed the time)
P11_TIMED_STEPS = 1
P11_DIR = ROOT / "build" / "chip_smoke_dp"
P11_JOBS = ("p11-dp", "p11-single", "p11-pp")
# (f)-(h): ZeRO-1 in the same world; Adam's two f32 moments of DenseNet121
# a rank, replicated and at dp 2 (parallel/rules.optimizer_hbm_bytes)
P11_ZERO_JOB = "p11-zero"
P11_OPT_BYTES = {"replicated": 55_671_848, "zero": 28_191_016}
# (c)-(e): GPipe against 1F1B, the same math clocked otherwise
P11_SCHEDULE_TOL = 1e-6
P11_SCHEDULES = ("gpipe", "1f1b")
P11_DP_PP = (2, 2)


def p11_args(preset_name: str, job: str, device: str) -> list[str]:
    """(b)'s command line: phase 4's fused configuration, one epoch of 3
    global batches of 30 and the eval pass over ``EVAL_SET`` images."""
    return ["--preset", preset_name, "--device", device, "--set",
            *P10_FUSED[:3], "train.max_epochs=1", f"data.synthetic_num_train={P11_TRAIN}",
            f"data.synthetic_num_test={EVAL_SET}", f"data.global_batch_size={EVAL_BATCH}",
            f"data.eval_batch_size={EVAL_BATCH}", f"train.seed={SEED}",
            f"train.log_dir={LOG_DIR}", f"train.checkpoint_dir={CKPT_ROOT / job}",
            "train.auto_resume=false"]


def dp_rank_main() -> int:
    """One rank of phase 11's world: (a), then (b) through the command
    line with the launch counters zeroed just before and read just after,
    then the rank's step timed with each BatchNorm all-reduce timed;
    writes ``P11_DIR/rank<r>.json`` (and rank 0 ``a.pt``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.bootstrap("cuda:0", backend="gloo")
    mesh = build_mesh(MeshSpec(P11_WORLD, 1), "cuda:0")
    a = bench_dp.parity_run(mesh)
    if mesh.rank == 0:
        torch.save(a, P11_DIR / "a.pt")
    zero_counters(DENSE_COUNTERS)
    trainer = cli.main(p11_args("dp", P11_JOBS[0], "cuda:0"))
    torch.cuda.synchronize()
    report = {"launches": read_counters(DENSE_COUNTERS), "steps": len(trainer.train_loader),
              "evals": len(trainer.test_loader)}
    batches = [to_device(i, l, "cuda:0") for i, l in trainer.train_loader]
    trainer.model.train()
    COLLECTIVES.update(all_reduces=0, seconds=0.0, timed=True)
    mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for images, labels in batches[:P11_TIMED_STEPS]:
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / P11_TIMED_STEPS
    report["timed"] = {
        "step_ms": wall * 1e3, "all_reduces": COLLECTIVES["all_reduces"] / P11_TIMED_STEPS,
        "all_reduce_ms": COLLECTIVES["seconds"] / P11_TIMED_STEPS * 1e3}
    COLLECTIVES["timed"] = False
    (P11_DIR / f"rank{mesh.rank}.json").write_text(json.dumps(report))
    mesh.barrier()
    zero_rank_part(mesh, trainer)
    pp_rank_part(mesh.rank)
    return 0


def zero_rank_part(mesh, rep: Trainer) -> None:
    """(f) ``bench_dp.zero_parity`` in this world, (g) the fused
    configuration through the command line with ``train.zero_sharding=
    true``, the launch counters zeroed just before and read just after,
    and this rank's optimizer bytes beside (b)'s, (h) (g)'s snapshot into
    a replicated Trainer and (b)'s into a ZeRO one, each state right after
    the load against the file; writes ``P11_DIR/zero-rank<r>.json``."""
    report = {"parity": bench_dp.zero_parity(mesh)}
    os.environ["DDL_JOB_ID"] = P11_ZERO_JOB
    zero_counters(DENSE_COUNTERS)
    ZERO.update(reduce_scatters=0, all_gathers=0, bytes=0)
    trainer = cli.main([*p11_args("dp", P11_ZERO_JOB, "cuda:0"), "train.zero_sharding=true"])
    torch.cuda.synchronize()
    report.update(launches=read_counters(DENSE_COUNTERS), steps=len(trainer.train_loader),
                  evals=len(trainer.test_loader), collectives=dict(ZERO),
                  sharded=len(trainer.optimizer.zero.leaves),
                  opt_bytes={"replicated": rep.optimizer.state_bytes(),
                             "zero": trainer.optimizer.state_bytes()})
    del trainer
    for name, zero, job in (("zero_into_replicated", False, P11_ZERO_JOB),
                            ("replicated_into_zero", True, P11_JOBS[0])):
        cfg, _ = parse_cli([*p11_args("dp", job, "cuda:0"), f"train.zero_sharding={zero}",
                            f"train.snapshot_job_id={job}", "train.snapshot_epoch=0"])
        t = Trainer(cfg, mesh=mesh)
        got = flat_state(t.snapshot_state())
        want = flat_state(ckpt.load_snapshot(CKPT_ROOT / job, job, 0, map_location="cpu")[0])
        report[name] = {"tensors": len(want), "keys_equal": got.keys() == want.keys(),
                        "differ": [k for k in want if k in got
                                   and not torch.equal(got[k].cpu(), want[k])],
                        "zero": t.optimizer.zero is not None}
        del t
    torch.cuda.empty_cache()
    (P11_DIR / f"zero-rank{mesh.rank}.json").write_text(json.dumps(report))
    mesh.barrier()


def pp_parity(mesh) -> None:
    """(c)/(e) on this rank: ``bench_pp.parity_run`` under both schedules,
    each saved as ``P11_DIR/pp<data>x<pipe>-<schedule>-r<rank>.pt``."""
    tag = f"pp{mesh.spec.data}x{mesh.spec.pipe}"
    for schedule in P11_SCHEDULES:
        got = bench_pp.parity_run(mesh, schedule)
        torch.save(got, P11_DIR / f"{tag}-{schedule}-r{mesh.rank}.pt")


def pp_rank_main() -> int:
    """One rank of phase 11's four-rank world: (e)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.bootstrap("cuda:0", backend="gloo")
    pp_parity(build_mesh(MeshSpec(*P11_DP_PP), "cuda:0"))
    return 0


def pp_rank_part(rank: int) -> None:
    """(c), then (d) through the command line with the launch counters
    zeroed just before and read just after, then the pipeline step timed;
    writes ``P11_DIR/pp-rank<r>.json``."""
    pp_parity(build_mesh(MeshSpec(1, 2), "cuda:0"))
    os.environ["DDL_JOB_ID"] = P11_JOBS[2]
    zero_counters(DENSE_COUNTERS)
    HANDOFF.update(sends=0, recvs=0, bytes=0)
    trainer = cli.main(p11_args("pp", P11_JOBS[2], "cuda:0"))
    torch.cuda.synchronize()
    report = {"launches": read_counters(DENSE_COUNTERS), "steps": len(trainer.train_loader),
              "evals": len(trainer.test_loader), "handoff": dict(HANDOFF)}
    batches = [to_device(i, l, "cuda:0") for i, l in trainer.train_loader]
    trainer.mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for images, labels in batches[:P11_TIMED_STEPS]:
        trainer.train_step(images, labels)
    torch.cuda.synchronize()
    report["step_ms"] = (time.perf_counter() - t0) / P11_TIMED_STEPS * 1e3
    (P11_DIR / f"pp-rank{rank}.json").write_text(json.dumps(report))
    trainer.mesh.barrier()


def run_dp(card: dict) -> dict:
    """Phase 11: data parallelism, a world of two ranks on the one card
    over gloo; returns the main-path launches of #1-#3 (both ranks')."""
    t0 = time.perf_counter()
    shutil.rmtree(P11_DIR, ignore_errors=True)
    P11_DIR.mkdir(parents=True)
    for job in (*P11_JOBS, P11_ZERO_JOB):
        shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    # the world, and beside it phase 8's OOM child and the one-process
    # references: (a)'s run, the same with each batch's rows reversed (its
    # f32 noise floor), and (b)'s as the single preset (the world's times
    # are no speed figures, and these are numbers, not times)
    tw = time.perf_counter()
    oom = start_oom_child()
    pool = ThreadPoolExecutor(1)
    world = pool.submit(launch.spawn_local,
                        [sys.executable, str(Path(__file__).resolve()), "--dp-rank"], P11_WORLD,
                        env=dict(os.environ, DDL_JOB_ID=P11_JOBS[0]),
                        log_dir=P11_DIR / "ranks")
    try:
        single = bench_dp.parity_run()
        floor = bench_dp.parity_errors(bench_dp.parity_run(reverse=True), single)
        os.environ["DDL_JOB_ID"] = P11_JOBS[1]
        try:
            cli.main(p11_args("single", P11_JOBS[1], "cuda"))
        finally:
            del os.environ["DDL_JOB_ID"]
        torch.cuda.synchronize()
    finally:
        code = world.result()
        pool.shutdown()
    world_s = time.perf_counter() - tw
    check_oom_child(oom)
    if code:
        for r in range(P11_WORLD):
            print(f"--- rank {r}:\n" + (P11_DIR / "ranks" / f"rank{r}.log").read_text()[-3000:])
    require(code == 0, f"the {P11_WORLD}-rank world exits 0 (it returned {code})")
    print(f"  the {P11_WORLD}-rank world (gloo, both ranks on cuda:0) took {world_s:.1f} s, "
          "process starts included, with this process's references beside it")

    # (a) f32 parity against the same run in one process.  The first step's
    # loss is the forward alone, the parameters move by lr * gradient and
    # the running statistics by 0.1 * the global batch's: all three are
    # held to the fixed limits.  The second step's loss and the eval logits
    # sit at the f32 noise floor of a mere change of summation order (the
    # one-process run with its rows reversed: 1.12e-5 and 5.95e-3 in the
    # first card runs, above 1e-5 and 1e-4), so they are held to
    # P11_FLOOR_X times this run's floor where that exceeds the limit.
    dp = torch.load(P11_DIR / "a.pt", weights_only=False)
    err = bench_dp.parity_errors(dp, single)
    print(f"  (a) f32, packed, {bench_dp.PARITY_STEPS} SGD steps of {bench_dp.PARITY_BATCH} and "
          f"the eval of {bench_dp.PARITY_EVAL}: losses {dp['losses'].tolist()} vs one process "
          f"{single['losses'].tolist()}; errors (loss per step relative; parameters, running "
          f"statistics and logits as shares of their largest) {err}; the one-process run with "
          f"each batch's rows reversed: {floor}")
    require(err["loss_rel"][0] <= P11_LOSS_TOL, f"(a) step 1's loss within {P11_LOSS_TOL}")
    require(err["param"] <= P11_PARAM_TOL, f"(a) parameters within {P11_PARAM_TOL}")
    require(err["stats"] <= P11_STATS_TOL, f"(a) running statistics within {P11_STATS_TOL}")
    loss_lim = max(P11_LOSS_TOL, P11_FLOOR_X * max(floor["loss_rel"]))
    logit_lim = max(P11_LOGIT_TOL, P11_FLOOR_X * floor["logit"])
    require(max(err["loss_rel"]) <= loss_lim, f"(a) every step's loss within {loss_lim:.2e}")
    require(err["logit"] <= logit_lim, f"(a) eval logits within {logit_lim:.2e}")

    # (b) the fused configuration through the command line
    per_layer = sum(ModelConfig().block_config[b] for b in (0, 3))
    total = dict.fromkeys(DENSE_COUNTERS, 0)
    want_of = {"normalize": lambda steps, evals: steps + evals,
               "fused_dense_block": lambda steps, evals: per_layer * (steps + evals),
               "fused_dense_block_bwd": lambda steps, evals: per_layer * steps}
    for r in range(P11_WORLD):
        rep = json.loads((P11_DIR / f"rank{r}.json").read_text())
        steps, evals = rep["steps"], rep["evals"]
        want = {k: v(steps, evals) for k, v in want_of.items()}
        timed = rep["timed"]
        print(f"  (b) rank {r}: {steps} steps of {EVAL_BATCH // P11_WORLD} images and {evals} "
              f"eval batches; launches {rep['launches']}; gloo one-card world (not a speed "
              f"figure), each of the {timed['all_reduces']:.0f} BatchNorm all-reduces a step "
              f"timed from a synchronised device: step wall {timed['step_ms']:.2f} ms, of which "
              f"{timed['all_reduce_ms']:.2f} ms ({timed['all_reduce_ms'] / timed['step_ms']:.1%}) "
              "in the all-reduces")
        require(steps == P11_TRAIN // EVAL_BATCH, f"(b) rank {r} ran {P11_TRAIN // EVAL_BATCH} "
                "steps")
        for k, n in want.items():
            require(rep["launches"][k] == n, f"(b) rank {r}: {k} launched {n} times")
            total[k] += rep["launches"][k]
    rows = {job: {m: csv_rows(job, m) for m in ("loss", "qwk", "val_examples")}
            for job in P11_JOBS}
    dp_loss, one_loss = rows["p11-dp"]["loss"][0][1], rows["p11-single"]["loss"][0][1]
    print(f"  (b) epoch loss {dp_loss:.6f} vs one process {one_loss:.6f} (rel "
          f"{abs(dp_loss - one_loss) / abs(one_loss):.2e}, tol {P11_FUSED_LOSS_TOL}); QWK "
          f"{rows['p11-dp']['qwk'][0][1]:.4f} over {rows['p11-dp']['val_examples'][0][1]:.0f} "
          f"images (one process: {rows['p11-single']['qwk'][0][1]:.4f})")
    require(len(rows["p11-dp"]["loss"]) == 1, "(b) one loss row, rank 0's")
    require(math.isfinite(dp_loss), "(b) the epoch loss is finite")
    require(abs(dp_loss - one_loss) <= P11_FUSED_LOSS_TOL * abs(one_loss),
            f"(b) the epoch loss within {P11_FUSED_LOSS_TOL} of the one-process run")
    require(rows["p11-dp"]["val_examples"][0][1] == EVAL_SET,
            f"(b) QWK over all {EVAL_SET} test images once")
    require(math.isfinite(rows["p11-dp"]["qwk"][0][1]), "(b) QWK finite")
    for k, n in check_zero(rows["p11-dp"]["loss"][0][1], want_of).items():
        total[k] += n
    for k, n in run_pp(rows["p11-single"]["loss"][0][1]).items():
        total[k] += n
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s; main-path launches {total}")
    return total


def check_zero(dp_loss: float, want: dict) -> dict:
    """(f)-(h) from the ranks' reports: ZeRO-1 against the replicated step
    (at two ranks each element's sum is one addition, so the trajectory
    must be bit-equal, beside ``bench_dp.zero_parity_errors``' limits), #1-#3
    on the ZeRO path as on (b)'s, each rank's optimizer bytes, (g)'s epoch
    loss against (b)'s, and the snapshots' two-way resume bit for bit.
    Returns (g)'s launches over both ranks."""
    total = dict.fromkeys(DENSE_COUNTERS, 0)
    reps = [json.loads((P11_DIR / f"zero-rank{r}.json").read_text()) for r in range(P11_WORLD)]
    par = reps[0]["parity"]
    print(f"  (f) ZeRO-1 vs replicated, f32 packed, Adam {bench_dp.ZERO_LR}, "
          f"{bench_dp.ZERO_STEPS} steps of {bench_dp.PER_RANK_BATCH} a rank ({par['transport']}, "
          f"{par['sharded_leaves']} of {par['leaves']} leaves sharded): gradient shard "
          f"{par['grad']}; update bit-equal given equal gradients {par['update_bit_equal']}; "
          f"trajectory {par['trajectory']}")
    bad = bench_dp.zero_parity_errors(par)
    require(not bad, f"(f) ZeRO parity: {bad}")
    require(par["trajectory"]["bit_equal"], "(f) at two ranks the ZeRO trajectory is bit-equal")
    for r, rep in enumerate(reps):
        steps, evals = rep["steps"], rep["evals"]
        want_r = {k: v(steps, evals) for k, v in want.items()}
        print(f"  (g) rank {r}, train.zero_sharding=true: {steps} steps, {evals} eval batches; "
              f"launches {rep['launches']}; {rep['sharded']} leaves sharded; collectives "
              f"{rep['collectives']}; optimizer bytes {rep['opt_bytes']} (Adam's f32 moments of "
              f"DenseNet121: 55.67 MB replicated, 28.19 MB a rank at dp 2)")
        for k, n in want_r.items():
            require(rep["launches"][k] == n, f"(g) rank {r}: {k} launched {n} times")
            total[k] += rep["launches"][k]
        require(rep["opt_bytes"] == P11_OPT_BYTES, f"(g) rank {r}: optimizer bytes "
                f"{P11_OPT_BYTES}")
        require(rep["collectives"]["reduce_scatters"] == steps,
                f"(g) rank {r}: one reduce-scatter a step")
        for name in ("zero_into_replicated", "replicated_into_zero"):
            h = rep[name]
            print(f"  (h) rank {r} {name}: {h['tensors'] - len(h['differ'])} of {h['tensors']} "
                  f"tensors bit-equal to the file" + (f"; differ {h['differ'][:5]}"
                                                      if h["differ"] else ""))
            require(h["keys_equal"] and not h["differ"]
                    and h["zero"] == (name == "replicated_into_zero"),
                    f"(h) rank {r}: {name} bit-equal")
    zero_loss = csv_rows(P11_ZERO_JOB, "loss")[0][1]
    rel = abs(zero_loss - dp_loss) / abs(dp_loss)
    print(f"  (g) epoch loss {zero_loss:.6f} vs (b)'s {dp_loss:.6f} (rel {rel:.2e}, tol "
          f"{P11_FUSED_LOSS_TOL})")
    require(rel <= P11_FUSED_LOSS_TOL, f"(g) the epoch loss within {P11_FUSED_LOSS_TOL} of (b)'s")
    return total


def check_pp_parity(label: str, spec: tuple[int, int]) -> None:
    """(c)/(e): each schedule's run (each data row's stages joined, and
    every row bit-equal to the first: ``bench_pp.merge_rows``) against the
    same math in this process, and GPipe against 1F1B.  The losses,
    parameters and running statistics hold (a)'s fixed limits and the
    schedules 1e-6 between them; the eval logits 1e-4 of the largest, or
    ``P11_FLOOR_X`` times the floor of the data axis's summation order
    (the one-process math with its data rows in the other order; none for
    one row) where that is larger, as in (a)."""
    want = bench_pp.parity_run(data=spec[0])
    floor = (bench_dp.parity_errors(bench_pp.parity_run(data=spec[0], reverse=True), want)
             if spec[0] > 1 else bench_dp.parity_errors(want, want))
    logit_lim = max(P11_LOGIT_TOL, P11_FLOOR_X * floor["logit"])
    tag = f"pp{spec[0]}x{spec[1]}"
    runs = {s: bench_pp.merge_rows([
        torch.load(P11_DIR / f"{tag}-{s}-r{r}.pt", weights_only=False)
        for r in range(spec[0] * spec[1])], spec[1]) for s in P11_SCHEDULES}
    print(f"  {label} mesh {spec}: every data row's losses, parameters, running statistics "
          "and eval logits bit-equal to row 0's")
    for schedule, run in runs.items():
        err = bench_dp.parity_errors(run, want)
        print(f"  {label} {schedule}, mesh {spec}, f32 packed, {bench_pp.PARITY_STEPS} SGD steps "
              f"of {bench_pp.PER_ROW_BATCH} images a data row in {bench_pp.MICROBATCHES} "
              f"microbatches and the eval of {bench_pp.PARITY_EVAL}: losses "
              f"{run['losses'].tolist()} vs one process {want['losses'].tolist()}; errors "
              f"(loss per step relative; parameters, running statistics and logits as shares "
              f"of their largest) {err}; the one-process math with its data rows in the "
              f"other order: {floor}")
        require(max(err["loss_rel"]) <= P11_LOSS_TOL,
                f"{label} {schedule}: every step's loss within {P11_LOSS_TOL}")
        require(err["param"] <= P11_PARAM_TOL, f"{label} {schedule}: parameters within "
                f"{P11_PARAM_TOL}")
        require(err["stats"] <= P11_STATS_TOL, f"{label} {schedule}: running statistics "
                f"within {P11_STATS_TOL}")
        require(err["logit"] <= logit_lim, f"{label} {schedule}: eval logits within "
                f"{logit_lim:.2e}")
    gap = bench_pp.run_gap(runs["gpipe"], runs["1f1b"])
    print(f"  {label} GPipe vs 1F1B: largest difference of the losses, parameters and "
          f"running statistics {gap['state']:.3e} (tol {P11_SCHEDULE_TOL}), of the eval "
          f"logits {gap['logit']:.3e}")
    require(gap["state"] <= P11_SCHEDULE_TOL, f"{label} GPipe and 1F1B within "
            f"{P11_SCHEDULE_TOL}")


def pp_one_process_loss(m: int) -> float:
    """(d)'s reference: the ``pp`` run's math in this process.  A
    ``single`` preset Trainer of (d)'s configuration (the same seeded
    weights, Adam and first epoch's batches) takes each step as the
    pipeline does, the whole network on each microbatch of ``m`` in order
    (its own BatchNorm statistics, the plain normalize, the loss over
    ``m``), one update a batch; returns the epoch's mean loss."""
    overrides = dict(a.split("=", 1) for a in p11_args("single", "p11-pp-one", "cuda")[5:])
    overrides.update({"train.log_dir": "", "train.checkpoint_dir": ""})
    trainer = Trainer(preset("single", **overrides))
    model, opt, dtype = trainer.model.train(), trainer.optimizer, trainer.compute_dtype
    trainer.train_loader.set_epoch(0)
    losses = []
    for images, labels in trainer.train_loader:
        gi, gl = to_device(images, labels, "cuda")
        mb = gi.shape[0] // m
        opt.zero_grad()
        total = torch.zeros((), device="cuda")
        for i in range(m):
            loss = cross_entropy_loss(model(normalize_images(gi[i * mb:(i + 1) * mb], dtype)),
                                      gl[i * mb:(i + 1) * mb])
            (loss / m).backward()
            total += loss.detach()
        opt.step()
        losses.append((total / m).item())
    return float(np.mean(losses))


def run_pp(single_loss: float) -> dict:
    """Phase 11's pipelines: (c) and (d) from the two ranks' files, then (e)
    in a world of four; returns (d)'s main-path launches (both ranks')."""
    t0 = time.perf_counter()
    check_pp_parity("(c)", (1, 2))
    cfg = preset("pp")
    m, blocks = cfg.train.num_microbatches, cfg.model.block_config
    total = dict.fromkeys(DENSE_COUNTERS, 0)
    for r, block in enumerate((0, len(blocks) - 1)):
        rep = json.loads((P11_DIR / f"pp-rank{r}.json").read_text())
        steps, evals = rep["steps"], rep["evals"]
        layers = blocks[block] * m
        want = {"normalize": 0, "fused_dense_block": layers * (2 * steps + evals),
                "fused_dense_block_bwd": layers * steps}
        h = rep["handoff"]
        print(f"  (d) rank {r} (stage {r}, denseblock{block + 1} fused): {steps} steps of "
              f"{EVAL_BATCH} images in {m} microbatches and {evals} eval batches; launches "
              f"{rep['launches']} (want {want}); handoff {h['transport']}, {h['sends']} sends "
              f"and {h['recvs']} receives, {h['bytes'] / 1e6:.1f} MB sent; step wall "
              f"{rep['step_ms']:.2f} ms (gloo one-card world, not a speed figure)")
        require(steps == P11_TRAIN // EVAL_BATCH, f"(d) rank {r} ran {P11_TRAIN // EVAL_BATCH} "
                "steps")
        require(h["transport"] == "gloo, through a host copy", f"(d) rank {r}: the gloo handoff")
        for k, n in want.items():
            require(rep["launches"][k] == n, f"(d) rank {r}: {k} launched {n} times")
            total[k] += rep["launches"][k]
    rows = {m: csv_rows(P11_JOBS[2], m) for m in ("loss", "qwk", "val_examples")}
    loss, want = rows["loss"][0][1], pp_one_process_loss(m)
    single_rel = abs(loss - single_loss) / abs(single_loss)
    print(f"  (d) epoch loss {loss:.6f} vs the same microbatched math in this process "
          f"{want:.6f} (rel {abs(loss - want) / abs(want):.2e}, tol {P11_FUSED_LOSS_TOL}); the "
          f"single preset's {single_loss:.6f} (rel {single_rel:.2e}: its BatchNorm normalizes "
          f"by the statistics of 30 images, the pipeline's each microbatch of "
          f"{EVAL_BATCH // m} by its own); QWK {rows['qwk'][0][1]:.4f} over "
          f"{rows['val_examples'][0][1]:.0f} images")
    require(len(rows["loss"]) == 1, "(d) one loss row, rank 0's")
    require(math.isfinite(loss), "(d) the epoch loss is finite")
    require(abs(loss - want) <= P11_FUSED_LOSS_TOL * abs(want),
            f"(d) the epoch loss within {P11_FUSED_LOSS_TOL} of the same math in one process")
    require(rows["val_examples"][0][1] == EVAL_SET, f"(d) QWK over all {EVAL_SET} test images")
    require(math.isfinite(rows["qwk"][0][1]), "(d) QWK finite")
    print(f"  (c)-(d) checked in {time.perf_counter() - t0:.1f} s")

    tw = time.perf_counter()
    world = P11_DP_PP[0] * P11_DP_PP[1]
    code = launch.spawn_local(
        [sys.executable, str(Path(__file__).resolve()), "--pp-rank"], world,
        env=dict(os.environ), log_dir=P11_DIR / "pp-ranks")
    if code:
        for r in range(world):
            print(f"--- rank {r}:\n" + (P11_DIR / "pp-ranks" / f"rank{r}.log").read_text()[-3000:])
    require(code == 0, f"the {world}-rank world exits 0 (it returned {code})")
    print(f"  (e) the {world}-rank world (gloo, every rank on cuda:0) took "
          f"{time.perf_counter() - tw:.1f} s, process starts included")
    check_pp_parity("(e)", P11_DP_PP)
    return total


# Phase 12.  The continuous-batching serving engine (ddl_tpu_torch/serve/) on
# the 124M LM of phase 5 (vocab 50304, d_model 768, 12 layers of 12 heads of
# 64, bf16, seed-0 weights) with flash="auto" (#4 takes each whole-prompt
# prefill from a 256-row bucket on): block size 16, 8 lanes, 8 steps per
# dispatch, 288 blocks (8 lanes x the 36 blocks of a 512 + 64 - 1 token
# reservation), clients from serve-bench's own generator (--seed 0).
P12_CFG = dict(LM_124M, flash="auto")
# where phase 12 runs: the card (a rehearsal of the phase's Python on the
# CPU at a tiny size sets "cpu")
P12_DEVICE = "cuda"
P12_ENGINE = dict(block_size=16, max_batch=8, max_steps_per_dispatch=8, num_blocks=288)
P12_SHARED_PREFIX, P12_LONG = 256, 2048
# (a)-(e): label -> (weights: MHA or GQA 12q/4kv, int8 weights, engine
# keywords, serve-bench scenario, clients, prompt lengths (the tails' in
# (d), the short ones' in (e)), new tokens).  (a)-(c) serve the bench's
# full mix, so that every pool retires lanes and admits into recycled
# blocks and scales; (d) takes one wave of 8 clients, and (d)-(e) 8:16 new
# tokens, cut for the phase's time; only (a)-(c) run every shape before
# they are timed.
P12_RUNS = {
    "a": ("mha", False, {}, "none", 16, (64, 512), (32, 64)),
    "d": ("mha", False, {"prefix_cache": True}, "shared-prefix", 8, (16, 64), (8, 16)),
    "d-off": ("mha", False, {"prefix_cache": False}, "shared-prefix", 8, (16, 64), (8, 16)),
    "e-256": ("mha", False, {"prefill_chunk": 256}, "long-prompt", 16, (16, 64), (8, 16)),
    "e-2048": ("mha", False, {"prefill_chunk": 2048}, "long-prompt", 16, (16, 64), (8, 16)),
    "b": ("gqa", False, {"kv_quant": True}, "none", 16, (64, 512), (32, 64)),
    "c": ("gqa", True, {"kv_quant": True}, "none", 16, (64, 512), (32, 64)),
}
# the clients that the sequential generator replays in (a)-(c), cut to the
# first 4 of 16 for the command's time; the other streams are held by
# teacher forcing
P12_REPLAYED = {"a": 4, "b": 4, "c": 4}


def p12_clients(label: str) -> list[dict]:
    """``label``'s clients from serve-bench's own generator (``--seed 0``,
    all present at t0)."""
    _, _, _, scenario, n, prompt, new = P12_RUNS[label]
    args = argparse.Namespace(seed=SEED, clients=n, scenario=scenario, arrival_s=0.0,
                              shared_prefix_len=P12_SHARED_PREFIX, long_prompt_len=P12_LONG)
    return serve_bench._make_clients(args, LMConfig(**P12_CFG), *prompt, *new)


class LogitRecorder:
    """The engine's own logits, kept on the card: each decode step's
    (B, V) rows by lane and position (a forward hook on the ``ServeDecode``)
    and each prefill's first-token row (hooks on the prefill and chunk
    models, attributed when the engine finishes the request's prefill).
    ``rows(rid)`` returns ``{output index: logits}`` of one request."""

    def __init__(self, eng: ServeEngine, clients: list[dict]) -> None:
        self.eng, self.p0 = eng, {c["id"]: len(c["prompt"]) for c in clients}
        self.steps, self.prefills, self.last = [], [], None
        models = eng.fns.models
        self.hooks = [models["decode"].register_forward_hook(self.decode)]
        for name in ("prefill", "prefill_flash", "chunk"):
            self.hooks.append(models[name].register_forward_hook(self.prefill))
        finish = eng._finish_prefill

        def finished(state, tok0, gen, cold):
            self.prefills.append((state.request.id, state.request.prompt_len, self.last))
            finish(state, tok0, gen, cold)

        eng._finish_prefill = finished

    def decode(self, _mod, args, out):
        lanes = {s.lane: s.request.id for s in self.eng.scheduler.active()
                 if s.prefill_done and not s.done}
        self.steps.append((lanes, args[4].clone(), out[0][:, 0].float().clone()))

    def prefill(self, _mod, _args, out):
        self.last = out[0][0, 0].float().clone()

    def rows(self, rid: str) -> dict:
        p0, out = self.p0[rid], {}
        for r, plen, logits in self.prefills:
            if r == rid:
                out[plen - p0] = logits
        for lanes, lengths, logits in self.steps:
            if rid in lanes.values():
                pos = lengths.cpu()
                for b, r in lanes.items():
                    if r == rid:
                        out[int(pos[b]) + 1 - p0] = logits[b]
        return out

    def close(self) -> None:
        for h in self.hooks:
            h.remove()


def teacher_forced_streams(cfg: LMConfig, params: dict, kv_quant: bool, streams: list) -> str:
    """Phase 5's three checks on the engine's own logits along its own
    tokens, for each stream that is not bit-identical to its reference:
    the tokens teacher-forced (the prompt's prefill, then every token but
    the last as one masked cached pass at the prompt's end, the int8 cache
    where the engine has it) through the plain versions and the plain
    versions in f32.  Every step's logits within LM_LOGIT_TOL of the
    largest against the plain path, top-1 equal where the plain path's
    top-2 margin exceeds that, and the engine no farther than LM_L2_RATIO x
    the plain path from the f32 path over all the streams' steps."""
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain = dict(decode_attend=kv_decode_plain, int8_matmul=int8_matmul_small_m_plain)
    paths = {"plain": (decode_model(cfg, params, **plain), cfg),
             "f32": (decode_model(f32, params, **plain), f32)}
    worst, checked, agree, d_eng, d_plain, norm = 0.0, 0, 0, 0.0, 0.0, 0.0
    with torch.inference_mode():
        for prompt, toks, engine_rows in streams:
            p, n = len(prompt), len(toks)
            got = torch.stack([engine_rows[j] for j in range(n)])
            logits = {}
            for k, (m, c) in paths.items():
                caches = init_kv_cache(c, 1, p + n, quant=kv_quant, device=P12_DEVICE)
                x = torch.as_tensor(prompt, device=P12_DEVICE)[None].long()
                rows = [m(x, caches, 0, last_only=True)[0][0, -1:]]
                if n > 1:
                    t = torch.as_tensor(toks[:-1], device=P12_DEVICE)[None].long()
                    rows.append(m(t, caches, p)[0][0])
                logits[k] = torch.cat(rows).float()
            want, exact = logits["plain"], logits["f32"]
            big = want.abs().amax(-1, keepdim=True)
            worst = max(worst, ((got - want).abs().amax(-1, keepdim=True) / big).max().item())
            top2 = want.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_LOGIT_TOL * big[:, 0]
            checked += int(sure.sum())
            agree += int((got.argmax(-1) == want.argmax(-1))[sure].sum())
            d_eng += (got - exact).square().sum().item()
            d_plain += (want - exact).square().sum().item()
            norm += exact.square().sum().item()
    if not streams:
        return "no stream to teacher-force"
    l2_eng, l2_plain = math.sqrt(d_eng / norm), math.sqrt(d_plain / norm)
    require(worst <= LM_LOGIT_TOL, f"engine logits within {LM_LOGIT_TOL} of the plain path")
    require(agree == checked, "engine top-1 equal wherever the plain margin exceeds the tolerance")
    require(l2_eng <= LM_L2_RATIO * l2_plain,
            f"engine within {LM_L2_RATIO}x the plain path's distance to f32")
    return (f"teacher-forced {len(streams)} stream(s): max |engine - plain| {worst:.2e} of the "
            f"largest (tol {LM_LOGIT_TOL}); top-1 equal at {agree}/{checked} sure steps; relative "
            f"L2 to f32: engine {l2_eng:.3e}, plain {l2_plain:.3e} (ratio "
            f"{l2_eng / l2_plain if l2_plain else math.inf:.3f}, tol {LM_L2_RATIO})")


def hold_tokens(label: str, cfg: LMConfig, params: dict, kv_quant: bool, clients: list[dict],
                got: dict, want: dict, rec: LogitRecorder, against: str) -> int:
    """Each stream bit-identical to ``want`` or teacher-forced (a stream
    that ``want`` lacks too); prints the share of ``want``'s streams that
    is bit-identical.  Returns how many are."""
    same = [c["id"] for c in clients
            if c["id"] in want and np.array_equal(got[c["id"]], want[c["id"]])]
    for c in clients:
        toks = got[c["id"]]
        require(len(toks) == c["max_new"] and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"({label}) {c['id']}: {c['max_new']} tokens inside the vocabulary")
    other = [(c["prompt"], got[c["id"]], rec.rows(c["id"])) for c in clients
             if c["id"] not in same]
    for prompt, toks, rows in other:
        require(sorted(rows) == list(range(len(toks))), f"({label}) every token's logits kept")
    t0 = time.perf_counter()
    tf = teacher_forced_streams(cfg, params, kv_quant, other)
    held = sum(c["id"] in want for c in clients)
    unheld = f", {len(clients) - held} not replayed" if held < len(clients) else ""
    print(f"  ({label}) tokens vs {against}: {len(same)}/{held} streams bit-identical "
          f"({len(same) / held:.0%}){unheld}; {tf} ({time.perf_counter() - t0:.1f} s)")
    return len(same)


def serve_run(card: dict, label: str, cfg: LMConfig, params: dict, clients: list[dict],
              seq: dict | None = None, **engine_kw) -> dict:
    """One engine run of phase 12: for (a)-(c) every reachable shape run
    once (``precompile``; elsewhere a shape's first run is cold and out of
    the percentiles), the logit recorder on, the counters zeroed just
    before the clients are served (``serve.bench.run_clients``) and read
    just after; the launches each kernel must show from the steps,
    prefills and chunks the run took; the serving numbers."""
    eng = ServeEngine(cfg, params, **P12_ENGINE, **engine_kw, device=P12_DEVICE)
    t0 = time.perf_counter()
    pre = (eng.precompile(max(len(c["prompt"]) for c in clients),
                          max(c["max_new"] for c in clients))
           if label in ("a", "b", "c") else "none")
    pre_s = time.perf_counter() - t0
    rec = LogitRecorder(eng, clients)
    full = []
    full_prefill = eng._full_prefill

    def counted(state, t0):
        full.append(prompt_bucket(state.request.prompt_len, eng.fns.block_size))
        full_prefill(state, t0)

    eng._full_prefill = counted
    torch.cuda.synchronize()
    zero_counters(LM_COUNTERS)
    wall = serve_bench.run_clients(eng, clients, SEED)
    torch.cuda.synchronize()
    launches = read_counters(LM_COUNTERS)
    st = eng.stats
    quant, w8 = eng.fns.kv_quant, "lm_head.scale" in params
    steps = cfg.n_layers * st["decode_steps"]
    want = {"flash_attention_fwd": cfg.n_layers * sum(b >= FLASH_AUTO_MIN_T for b in full),
            "decode_attention": 0 if quant else steps,
            "quant_decode_attention": steps if quant else 0,
            # a step's products: q, k, v, out, wi, wo per layer and the head;
            # each prefill program's head adds one (its last row)
            "int8_matmul_small_m": ((6 * cfg.n_layers + 1) * st["decode_steps"] + len(full)
                                    + st["prefill_chunks"]) if w8 else 0}
    for k, v in want.items():
        require(launches[k] == v, f"({label}) {k} launched {v} times")
    results = {k: np.asarray(v) for k, v in eng.results.items()}
    require(sorted(results) == sorted(c["id"] for c in clients) and st["shed"] == 0,
            f"({label}) every client served")
    summary = ServingStats.from_events(eng.request_log).summary()
    tokens = sum(len(v) for v in results.values())
    total_prompt = st["prefix_hit_tokens"] + st["prefill_tokens"]
    print(f"({label}) {smi()}: {len(clients)} clients, {tokens} tokens in {wall:.3f} s: "
          f"{tokens / wall:.1f} tokens/s aggregate; {st['decode_dispatches']} dispatches, "
          f"{st['decode_steps']} steps, {len(full)} whole-prompt prefills (buckets "
          f"{sorted(set(full))}), {st['prefill_chunks']} chunks; peak lanes "
          f"{eng.scheduler.peak_lanes}, peak blocks {st['peak_blocks']}/{eng.fns.num_blocks} "
          f"({st['peak_blocks'] / eng.fns.num_blocks:.0%} occupancy); prefix hit rate "
          f"{st['prefix_hit_tokens'] / total_prompt:.1%} ({st['prefix_hit_tokens']}/"
          f"{total_prompt} prompt tokens), prefill tokens computed {st['prefill_tokens']}, "
          f"cow copies {st['cow_copies']}; shapes run before timing {pre} in {pre_s:.1f} s; warm "
          f"requests {summary['requests'] - summary['cold']}/{summary['requests']}; launches "
          f"{launches}")
    for line in render_percentiles(summary["percentiles"]):
        print(f"  ({label}) {line}")
    if seq is not None:
        print(f"  ({label}) sequential replay {seq['rate']:.1f} tokens/s: continuous batching "
              f"x{tokens / wall / seq['rate']:.2f}")
    return {"eng": eng, "rec": rec, "results": results, "launches": launches, "wall": wall,
            "summary": summary}


def sequential_tokens(cfg: LMConfig, params: dict, clients: list[dict],
                      kv_quant: bool) -> dict:
    """The sequential generator's tokens at equal settings: the clients one
    at a time through ``make_lm_generator`` at batch 1, greedy, each
    request's generator seeded ``SEED`` (serve-bench's replay), in one
    pass whose rate is ``--compare-sequential``'s: each request's first run
    (the kernels already built) where serve-bench runs each shape once
    first."""
    tokens, n = {}, 0
    t0 = time.perf_counter()
    for c in clients:
        gen = make_lm_generator(cfg, prompt_len=len(c["prompt"]), max_new=c["max_new"], batch=1,
                                kv_quant=kv_quant, device=P12_DEVICE)
        tokens[c["id"]] = gen(params, torch.as_tensor(c["prompt"], device=P12_DEVICE)[None].long(),
                              torch.Generator(P12_DEVICE).manual_seed(SEED))[0].cpu().numpy()
        n += len(tokens[c["id"]])
    wall = time.perf_counter() - t0
    return {"rate": n / wall, "wall": wall, "tokens": tokens}


def dispatch_profile(eng: ServeEngine, label: str, k: int = 8, nmax: int = 32) -> dict:
    """One K-step decode dispatch over 8 lanes at nmax blocks each
    (positions 400-407), timed: its wall, its device busy time and its top
    kernels per step (``measure``)."""
    fns = eng.fns
    lanes = fns.max_batch
    tables = torch.arange(lanes * nmax, device="cuda").reshape(lanes, nmax) % fns.num_blocks
    lengths = torch.arange(400, 400 + lanes, device="cuda")
    pending = torch.randint(0, fns.cfg.vocab_size, (lanes,), device="cuda")
    prog, _ = fns.decode_for(k, nmax)
    busy, wall, kernels = measure(lambda _: prog(eng.pools, tables, lengths, pending,
                                                 [None] * lanes), [None], iters=1, warmup=1)
    print(f"  ({label}) one {k}-step decode dispatch, {lanes} lanes x {nmax * fns.block_size} "
          f"rows, on {smi()}: {wall / k:.3f} ms wall a step, device busy {busy / k:.3f} ms "
          f"({busy / wall:.1%}), {len(kernels)} distinct kernels")
    for i, (name, k_ms) in enumerate(sorted(kernels.items(), key=lambda kv: -kv[1])):
        # the top 6 on the console; every kernel into the log a caller tees
        print(f"    {k_ms / k:8.4f} ms/step  {k_ms / busy:6.1%}  {name[:90 if i < 6 else 160]}",
              file=sys.stdout if i < 6 else sys.stderr)
    return kernels


def p12_weights() -> dict:
    """The MHA model's seed-0 weights on the device."""
    model = TransformerLM(LMConfig(**P12_CFG))
    init_lm_weights(model, SEED)
    return {k: v.to(P12_DEVICE) for k, v in model.state_dict().items()}


def gqa_weights(params: dict) -> dict:
    """GQA 12q/4kv weights from the MHA ones: each layer's k and v kernels
    cut to their first 4 heads' columns (the same lecun-normal draw over the
    same fan-in), so phase 12 draws 124M weights once."""
    cols = 4 * P12_CFG["head_dim"]
    return {k: v[:, :cols].contiguous() if k.endswith((".attn.k.kernel", ".attn.v.kernel"))
            else v for k, v in params.items()}


def p12_run(card: dict, label: str, params: dict, runs: dict, seqs: dict, total: dict) -> None:
    """Run ``label`` of P12_RUNS from ``params`` (the f32 masters of its
    kind) and hold its tokens: against the sequential generator, (d)
    also against the cache-off run, (e) the short requests' queue delay,
    (a)-(c) one decode dispatch profiled."""
    kind, w8, kw, scenario = P12_RUNS[label][:4]
    if w8:
        params = quantize_lm_params(params)
    cfg = LMConfig(**{**P12_CFG, "n_kv_heads": 4 if kind == "gqa" else 0})
    clients = p12_clients(label)
    quant = kw.get("kv_quant", False)
    key = (kind, w8, scenario)
    if key not in seqs:
        seqs[key] = sequential_tokens(cfg, params, clients[:P12_REPLAYED.get(label)], quant)
        print(f"({label}) the sequential generator's tokens: {seqs[key]['wall']:.1f} s, "
              f"{seqs[key]['rate']:.1f} tokens/s")
    run = runs[label] = serve_run(card, label, cfg, params, clients, seqs[key], **kw)
    for k, n in run["launches"].items():
        total[k] = total.get(k, 0) + n
    hold_tokens(label, cfg, params, quant, clients, run["results"], seqs[key]["tokens"],
                run["rec"], "the sequential generator")
    if label == "a":
        p12_hbm_sample(run["eng"])
    if label == "d-off":
        hold_tokens("d", cfg, params, quant, clients, runs["d"]["results"], run["results"],
                    runs["d"].pop("rec"), "the same clients with the cache off")
    if label.startswith("e-"):
        short = [r["queue_delay"] for r in run["eng"].request_log
                 if not r["request_id"].startswith("long")]
        print(f"  ({label}) short requests' queue delay: p50 {np.percentile(short, 50):.4f} s, "
              f"p99 {np.percentile(short, 99):.4f} s, max {max(short):.4f} s over {len(short)} "
              f"(the long prompt in chunks of {kw['prefill_chunk']})")
    # the recorder's hooks come off before the profile: the dispatch timed
    # is the engine's alone
    run["rec"].close()
    if label in ("a", "b", "c"):
        run["kernels"] = dispatch_profile(run.pop("eng"), label)
    if label != "d":
        run.pop("rec")
    run.pop("eng", None)


def p12_hbm_sample(eng: ServeEngine) -> None:
    """One ``hbm_sample`` of (a)'s engine once its clients are served, as
    the engine emits one with each pool-stats event: the weights and the
    pool split into the allocator's cached, private and free blocks, which
    sum to the whole pool, against the card's watermark."""
    job = "p12-hbm"
    shutil.rmtree(LOG_DIR / "by_job_id" / job, ignore_errors=True)
    eng.obs = EventWriter(LOG_DIR, job)
    try:
        eng._emit_pool_stats()
    finally:
        eng.obs.close()
        eng.obs = None
    samples = [e for e in job_events(job) if e["kind"] == "hbm_sample"]
    pool = hbm.tree_shard_bytes(eng.pools)
    cats = {k: samples[0][k] for k in ("params_bytes", "kv_cached_bytes", "kv_private_bytes",
                                       "kv_free_bytes")} if samples else {}
    print(f"  (a) hbm_sample after the run: {cats}, pool {pool}, watermark "
          f"{samples[0]['watermark'] if samples else None}, synthetic "
          f"{samples[0]['synthetic'] if samples else None}")
    require(len(samples) == 1 and not samples[0]["synthetic"], "(a) one hbm_sample from the "
            "card's allocator")
    kv = cats["kv_cached_bytes"] + cats["kv_private_bytes"] + cats["kv_free_bytes"]
    require(kv == pool and samples[0]["watermark"] >= kv + cats["params_bytes"],
            "(a) the cached, private and free blocks sum to the pool, under the watermark")


def park_and_resume(params: dict, want: dict) -> dict:
    """(f): (a)'s clients, parked by ``drain(park=True)`` once the queue is
    empty and a lane is mid-decode, then ``resume_parked()`` and served to
    the end; tokens held against the uninterrupted run (a).  Returns the
    launches."""
    cfg = LMConfig(**P12_CFG)
    clients = p12_clients("a")
    eng = ServeEngine(cfg, params, **P12_ENGINE, device=P12_DEVICE)
    rec = LogitRecorder(eng, clients)
    zero_counters(LM_COUNTERS)
    for c in clients:
        eng.submit(c["prompt"], c["max_new"], request_id=c["id"], rng_seed=SEED)
    while eng.busy and (eng.admission.queue or not any(
            0 < len(s.outputs) < s.request.max_new for s in eng.scheduler.active())):
        eng.step()
    parked = eng.drain("scale_up", park=True)
    resumed = eng.resume_parked()
    require(parked["shed"] == 0 and parked["parked"] > 0 and resumed["resumed"] == parked["parked"],
            "(f) the in-flight lanes parked and resumed")
    eng.run()
    torch.cuda.synchronize()
    launches = read_counters(LM_COUNTERS)
    require(all(eng.outcomes[c["id"]] == "ok" for c in clients), "(f) every client completed")
    print(f"(f) drain(park=True) with the queue empty: {parked}, resume_parked {resumed}, "
          f"{eng.stats['prefix_hits']} re-admission(s) through the prefix cache; launches "
          f"{launches}")
    got = {k: np.asarray(v) for k, v in eng.results.items()}
    hold_tokens("f", cfg, params, False, clients, got, want, rec, "the uninterrupted run (a)")
    rec.close()
    return launches


def run_entry_points(total: dict) -> None:
    """The entry points: ``cli serve-bench`` at the 124M width, 2 layers (its
    vocab of 256 bytes, a dense prefill: the bench's config has no flash) and
    ``examples.serve_lm --int8 kv+w`` on phase 9's ``train_lm`` snapshot;
    each with the counters zeroed just before and read just after."""
    c = P9_CLI
    entry = [("cli serve-bench", cli.main,
              ["serve-bench", "--d-model", "768", "--heads", "12", "--layers", "2",
               "--clients", "8", "--prompt-len", "16:64", "--max-new", "8:16",
               "--block-size", "16", "--num-blocks", "288", "--max-batch", "8", "--device",
               P12_DEVICE]),
             ("examples.serve_lm --int8 kv+w", serve_lm.main,
              ["--checkpoint-dir", str(CKPT_ROOT / "p9-cli"), "--job-id", "p9-cli", "--step",
               str(c["steps"]), "--d-model", str(c["d_model"]), "--layers", str(c["layers"]),
               "--clients", "8", "--prompt-len", "16:64", "--max-new", "16", "--int8", "kv+w",
               "--block-size", "16", "--num-blocks", "96", "--max-batch", "8", "--device",
               P12_DEVICE])]
    for label, main_fn, argv in entry:
        zero_counters(LM_COUNTERS)
        out = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_fn(argv)
            torch.cuda.synchronize()
        launches = read_counters(LM_COUNTERS)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        text = out.getvalue()
        require("completed: 8 | shed: 0" in text and "-- percentiles (warm requests) --" in text,
                f"{label}: every client served and the percentile report")
        w8 = "kv+w" in label
        require(launches["quant_decode_attention" if w8 else "decode_attention"] > 0
                and (launches["int8_matmul_small_m"] > 0) == w8,
                f"{label}: the decode kernels launched")
        print(f"  {label} {' '.join(argv)}: {time.perf_counter() - t0:.2f} s; launches {launches}")


def run_serve(card: dict) -> dict:
    """Phase 12: (a), (d), (e) and (f) from the MHA weights, (b) and (c)
    from the GQA ones, the token checks, the dispatch profiles and the
    entry points.  Returns the phase's launches."""
    t_start = time.perf_counter()
    total, seqs, runs = {}, {}, {}
    params = p12_weights()
    for label in ("a", "d", "d-off", "e-256", "e-2048"):
        p12_run(card, label, params, runs, seqs, total)
    for k, n in park_and_resume(params, runs["a"]["results"]).items():
        total[k] = total.get(k, 0) + n
    params = gqa_weights(params)
    torch.cuda.empty_cache()
    for label in ("b", "c"):
        p12_run(card, label, params, runs, seqs, total)
    del params
    torch.cuda.empty_cache()
    # #9 at M = 8 against cuBLAS on this path: the products of (c)'s step
    # (int8 weights) beside the same products of (b)'s (bf16 weights, an
    # f32 head), summed over each dispatch's kernels by name
    gemm = sum(v for n, v in runs["b"]["kernels"].items()
               if any(s in n.lower() for s in ("gemm", "nvjet", "xmma", "cutlass")))
    int8 = sum(v for n, v in runs["c"]["kernels"].items() if "matvec" in n.lower())
    print(f"  #9 at M = 8 on this path ({smi()}): (c)'s int8 products {int8 / 8:.4f} ms a step, "
          f"(b)'s cuBLAS products {gemm / 8:.4f} ms a step")
    run_entry_points(total)
    for k in ("flash_attention_fwd", "decode_attention", "quant_decode_attention",
              "int8_matmul_small_m"):
        require(total.get(k, 0) > 0, f"phase 12 launched {k}")
    print(f"phase 12 took {time.perf_counter() - t_start:.1f} s; launches {total}")
    return total


# Phase 13: pod supervision across hosts.  (a) The pod crash drill of
# bench/pod.py through the user's command, `python -m ddl_tpu_torch.cli
# train --supervise --pod DIR --hosts 2 --host-id 0|1`: two hosts of one
# rank each on the one card over gloo (NCCL refuses two ranks on one GPU;
# DDL_DIST_BACKEND), phase 11 (b)'s fused configuration for 2 epochs of 3
# global steps of 30, whole and with host 1 crashing at global step 4
# (epoch 2).  (b) The elastic scale-down drill of tests/test_torch_pod_sim.py
# on the card: host 1's supervisor arrives, beats once and dies; the
# survivors 0 and 2 run the pod-sim child at the 124M width (vocab 256) for
# 6 steps of 1 x 256 tokens (flash="auto" takes #4-#6 there).
P13_DIR = ROOT / "build" / "chip_smoke_pod"
P13_CRASH_STEP = 4
P13_SIM_STEPS = 6
P13_SIM_CONFIG = {"model": dict(vocab_size=256, d_model=768, n_layers=12, n_heads=12,
                                head_dim=64, d_ff=3072, compute_dtype="bfloat16", flash="auto"),
                  "run": dict(batch=1, seq_len=256, save_every=3)}


def run_pod_crash(card: dict) -> dict:
    """Phase 13 (a); returns #1-#3's launches over every rank and
    incarnation of both pods."""
    out = bench_pod.crash_drill(P13_DIR / "crash", [None, None], P13_CRASH_STEP, "gloo",
                                together=True)
    print(f"  (a) the whole pod took {out['seconds']['whole']:.1f} s, the crashed one beside it "
          f"{out['seconds']['crashed']:.1f} s (supervisors, ranks and their process starts)")
    for what, ok in out["checks"][:1]:
        require(ok, f"(a) {what}")
    print(f"  (a) epoch 1 record {out['record']}; each epoch's world {out['coordinators']}")
    print(f"  (a) agreed resume epoch {out['agreed_resume']}; snapshots committed before the "
          f"decision {out['committed_before']}; steps each rank ran by restart epoch "
          f"{out['steps_run']}")
    for h, r in out["restart"].items():
        restored = ("none (a fresh start)" if r["to_restored_s"] is None else
                    f"{r['to_restored_s']:.3f} s (the restore {r['restore_s']:.3f} s)")
        print(f"  (a) host {h}: restart_latency {r['restart_latency_s']:.3f} s from the decision "
              f"to the first step; to run_start {r['to_run_start_s']:.3f} s, to the end of the "
              f"snapshot restore {restored}; step wall {r['step_ms_before']:.1f} ms before the "
              f"restart, {r['step_ms_after']:.1f} ms after (gloo, both ranks on one card, the whole "
              "pod's two ranks beside them)")
    total = dict.fromkeys(DENSE_COUNTERS, 0)
    for run, tags in out["launches"].items():
        for tag, launches in tags.items():
            print(f"  (a) {run} {tag}: launches {launches}")
            for k, n in launches.items():
                total[k] += n
    for what, ok in out["checks"][1:]:
        require(ok, f"(a) {what}")
    print(f"  (a) epoch rows {out['rows']}; the whole pod's {out['rows_whole']}")
    print(f"  (a) final parameters, BatchNorm statistics and epoch rows bit-equal to the whole "
          f"pod's: {out['bit_equal']}")
    if not out["bit_equal"]:
        # phase 8's limits, the most a resumed run may differ on the card
        # (cuDNN's backward in blocks 2-3 need not be deterministic)
        got = torch.load(P13_DIR / "crash" / "crashed" / "reports" / "state-e1-r0.pt")
        ref = torch.load(P13_DIR / "crash" / "whole" / "reports" / "state-e0-r0.pt")
        big = max(float(t.float().abs().max()) for t in ref.values() if t.is_floating_point())
        worst = max(float((got[k].float() - ref[k].float()).abs().max()) for k in ref
                    if ref[k].is_floating_point())
        rel = max(abs(float(a[1]) - float(b[1])) / max(abs(float(b[1])), 1e-12)
                  for m in ("loss", "val_loss")
                  for a, b in zip(out["rows"][m], out["rows_whole"][m]))
        print(f"  (a) not bit-equal: final parameters max |diff| {worst:.3e} = {worst / big:.2e} "
              f"of the largest (tol {STEP_GRAD_TOL}); losses rel {rel:.2e} (tol {STEP_LOSS_TOL})")
        require(worst <= STEP_GRAD_TOL * big and rel <= STEP_LOSS_TOL,
                "(a) the resumed pod within phase 8's limits of the whole one")
    return total


def run_pod_elastic(card: dict, rv1) -> dict:
    """Phase 13 (b): host 1 beat once (``rv1``, at the phase's start) and
    died; returns #4-#6's launches over both survivors."""
    from ddl_tpu_torch import coord
    from ddl_tpu_torch.supervisor import supervise_pod_command
    from ddl_tpu_torch.utils.backoff import Backoff

    sim, nas = P13_DIR / "elastic", P13_DIR / "elastic" / "nas"
    env = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    env.update(DDL_SIM_DIR=str(sim), DDL_SIM_STEPS=str(P13_SIM_STEPS), DDL_SIM_PACE="0",
               DDL_JOB_ID="p13-elastic", DDL_LOG_DIR=str(sim / "suplogs"),
               DDL_WATCHDOG_S="120", DDL_SIM_CONFIG=json.dumps(P13_SIM_CONFIG))
    results = {}

    def host(i):
        results[i] = supervise_pod_command(
            [sys.executable, str(ROOT / "tests" / "torch_pod_sim_child.py"), "--device", "cuda"],
            nas, i, 3, env=dict(env), max_restarts=3, backoff=Backoff(base=0.01, jitter=0.0),
            poll_s=0.05, heartbeat_s=0.2, stale_after_s=1.5, elastic=True,
            elastic_grace_s=1.5, log=lambda m: print(f"  (b) {m}"))

    threads = [threading.Thread(target=host, args=(i,)) for i in (0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not any(t.is_alive() for t in threads), "(b) the elastic pod ends")
    require(results == {0: 0, 2: 0}, f"(b) both survivors exit 0 ({results})")
    launch_dir = coord.active_launch_root(nas)
    require(launch_dir == rv1.root, "(b) the survivors joined the dead host's launch")
    rv = coord.Rendezvous(launch_dir, 0, 3)
    rec = rv.epoch_record(1)
    print(f"  (b) epoch 1 record {rec}")
    require(rv.current_epoch() == 1 and rec["reason"] == "peer_lost" and rec["hosts"] == [0, 2]
            and rec["world"] == 2, "(b) epoch 1: peer_lost, hosts [0, 2], world 2")
    finals = {}
    for i in (0, 2):
        e, step, digest = (sim / f"final_h{i}.log").read_text().splitlines()[-1].split()
        finals[i] = (int(e), int(step), digest)
        print(f"  (b) host {i}: env {(sim / f'env_h{i}.log').read_text().split(chr(10))[:-1]}, "
              f"final {finals[i]}")
    require(finals[0] == finals[2] and finals[0][:2] == (1, P13_SIM_STEPS),
            "(b) both survivors end at the last step with identical parameter digests")
    agreed = json.loads((launch_dir / "agree" / "resume-p13-elastic-e1.json").read_text())["value"]
    resume = 0 if agreed is None else agreed
    total = dict.fromkeys(FLASH_COUNTERS, 0)
    for i in (0, 2):
        consumed = [tuple(map(int, ln.split()))
                    for ln in (sim / f"consumed_h{i}.log").read_text().splitlines()]
        tail = [s for e, s in consumed if e == 1]
        require(tail == list(range(resume, P13_SIM_STEPS)), f"(b) host {i}'s epoch-1 tail is "
                f"exactly [{resume}, {P13_SIM_STEPS}) ({tail})")
        for line in (sim / f"launches_h{i}.log").read_text().splitlines():
            counts = json.loads(line.split(" ", 1)[1])
            print(f"  (b) host {i} epoch {line.split()[0]} launches {counts}")
            for k, n in counts.items():
                total[k] += n
    require(all(n > 0 for n in total.values()), f"(b) #4-#6 launched ({total})")
    return total


def run_pod(card: dict) -> tuple[dict, dict]:
    """Phase 13: pod supervision across hosts, (b) beside (a); returns
    (a)'s #1-#3 and (b)'s #4-#6 launches."""
    from ddl_tpu_torch import coord

    t0 = time.perf_counter()
    shutil.rmtree(P13_DIR, ignore_errors=True)
    P13_DIR.mkdir(parents=True)
    # (b)'s host 1 beats once and dies; its survivors' epoch-0 children are
    # still importing when its grace runs out, so they are killed untrained
    # and the first children to train are epoch 1's, as in the JAX
    # package's run of this scenario
    rv1 = coord.Rendezvous(coord.acquire_launch(P13_DIR / "elastic" / "nas"), 1, 3)
    rv1.arrive("start")
    rv1.publish_heartbeat("running", 0)
    got, took = {}, {}

    def elastic():
        try:
            got["b"] = run_pod_elastic(card, rv1)
        except BaseException as e:  # raised again below, in the main thread
            got["b_error"] = e
        took["b"] = time.perf_counter() - t0

    tb = threading.Thread(target=elastic)
    tb.start()
    dense = run_pod_crash(card)
    took["a"] = time.perf_counter() - t0
    tb.join(timeout=900)
    require(not tb.is_alive(), "(b) ends")
    if "b_error" in got:
        raise got["b_error"]
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s ((a) {took['a']:.1f}, (b) beside it "
          f"{took['b']:.1f}); launches {dense}, {got['b']}")
    return dense, got["b"]


def main(only: set[int] | None = None) -> int:
    """Every phase, the kernel table and the last line; with ``only`` (the
    ``--only 8,11`` of a quicker run while iterating) the set-up and those
    phases alone (phase 7 takes phase 6's bench with it), and no table and
    no last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if only is not None and 7 in only:
        only = only | {6}

    def want(*phases) -> bool:
        return only is None or bool(only & set(phases))

    marks = [("start", time.perf_counter())]
    card = setup()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    marks.append(("set-up", time.perf_counter()))
    rows = []
    if want(2):
        rows = [check_normalize(card, rng), check_fused_block(card, rng),
                check_fused_block_bwd(card, rng), check_flash(card), check_decode(card, False),
                check_decode(card, True), *check_flash_bwd(card), check_int8_matvec(card)]
        check_flash_sass()
        check_flash_bwd_sass()
        check_dense_sass()
        check_kernel_sass()
        check_decode_groupings()
        check_gates()
        marks.append(("phase 2", time.perf_counter()))
    parts, launches = {}, {}
    if want(3, 4):
        parts["eval slice"] = run_slice(card)
        launches = run_train_slice(card)
        parts["train slice"] = dict(launches)
        marks.append(("phases 3-4", time.perf_counter()))
    if want(5):
        parts["LM decode slice (variants A, B and C)"] = run_lm_slice(card)
        int8_weights_gate()
        marks.append(("phase 5", time.perf_counter()))
    if want(6):
        parts["LM train slice"], dense_bench = run_lm_train_slice(card)
        marks.append(("phase 6", time.perf_counter()))
    if want(7):
        parts["MoE train and decode (phase 7)"] = run_slice10(card, dense_bench)
        marks.append(("phase 7", time.perf_counter()))
    if want(8, 9, 10):
        if want(8):
            parts["snapshots, resume and rollback (phase 8)"] = run_resilience(card)
        if want(9):
            parts["the LM's (phase 9)"] = run_lm_resilience(card)
        if want(10):
            parts["the command line on image files (phase 10)"] = run_cli_files(card)
        marks.append(("phases 8-10", time.perf_counter()))
    if want(11):
        parts["data and pipeline parallelism (phase 11, both ranks of each command line)"] = (
            run_dp(card))
        marks.append(("phase 11", time.perf_counter()))
    if want(12):
        parts["the serving engine (phase 12)"] = run_serve(card)
        marks.append(("phase 12", time.perf_counter()))
    if want(13):
        pod_dense, pod_flash = run_pod(card)
        parts["the pods (phase 13: every rank and incarnation)"] = pod_dense
        parts["the pods' elastic drill (phase 13)"] = pod_flash
        marks.append(("phase 13", time.perf_counter()))
    print("seconds: " + ", ".join(f"{label} {t - marks[i][1]:.1f}"
                                  for i, (label, t) in enumerate(marks[1:])))
    print("launches: " + ", ".join(f"{label} {n}" for label, n in parts.items()))
    if only is not None:
        print(f"partial run of phases {sorted(only)}: every check held")
        return 0
    for label, part in parts.items():
        if label in ("eval slice", "train slice"):
            continue
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi())
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--only"]:
        sys.exit(main({int(p) for p in sys.argv[2].split(",")}))
    sys.exit({"--dp-rank": dp_rank_main, "--pp-rank": pp_rank_main,
              "--oom-child": oom_child_main}.get(sys.argv[1] if sys.argv[1:] else "", main)())
