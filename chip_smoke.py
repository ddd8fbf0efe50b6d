#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``chanamq_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

Phases, each a function of a device and a size so that a CPU test can
rehearse it; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); float32
   products in full float32 (``allow_tf32 = False``) for the router's
   plain versions;
2. build: ``csrc/router_match.cu``, ``csrc/forecaster.cu`` and
   ``csrc/forecaster_train.cu``, one nvcc each, started together, for
   sm_90a, with ptxas's register, shared-memory and spill report and the
   count of tensor-core instructions (HMMA/HGMMA) in each attention
   kernel's SASS (``cuobjdump``; "not available" without it);
3. kernels at the router's caps: both router match kernels at N=512
   rows, W=128 mask words and full token widths (topic P=S=8, headers
   R=8, H=16) against their plain PyTorch versions, word for word, at B in
   {16, 256, 1024}, with device times and the bound for those inputs,
   each kernel's time at 1, 2 and 4 messages a block, and each wrapper's
   host time split into its steps (checks, ``torch.empty``, binding, the
   launch);
4. forecaster kernels at the flagship width (``ForecasterConfig()``: T=64,
   d_model 256, 4 heads of 64, d_ff 1024) at B in {1, 32} (the service's
   one window; ``__graft_entry__``'s batch), layernorm also at B = 16 (the
   training batch): layernorm, causal attention and tanh-GELU against
   their plain versions in bf16, each within its stated limit, with device
   times, the bound, and one PyTorch library call as a yardstick; then the
   floor under those times, an empty kernel launched and timed the same
   way (``[floor]``);
5. forward at full width: ``ForecasterConfig()`` at B in {1, 32}, the
   kernel path against the plain path, with host-clock and CUDA-event ms,
   under the reference's product precision (``set_matmul_precision``:
   bf16 products accumulate in float32, float32 products avoid TF32);
6. training kernels at the flagship width at B in {16, 32} (the service's
   training batch; ``__graft_entry__``'s): the layernorm, attention and
   GELU backward passes against their plain versions within their stated
   bf16 limits, and the clip + momentum + SGD update over all 29 parameter
   tensors bit for bit at the kernel's clip scale, with device times, the
   bound and a PyTorch library yardstick (autograd of ``F.layer_norm``,
   ``F.scaled_dot_product_attention``, ``F.gelu``; ``clip_grad_norm_``
   and a foreach ``SGD`` step), attention's backward with its two
   launches and the forward keeping its row statistics timed apart; the
   backward's main kernel on four and on eight warps at B in {8, 16, 32}
   and at the compact default, the same bits (``[bwd-warps]``); then both
   attention kernels at long windows, T in {400, 1024, 2048} at head
   widths 16 and 64 (the forward at B = 1, the backward at B = 16), within
   the same limits and twice for the same bits;
7. train step at full width: ``make_train_step`` through the kernels
   against the same step through the plain versions under torch autograd,
   from one state on one ``synthetic_batch`` (B=16), 20 steps: every
   parameter and momentum tree within its stated limit after 1 and 20
   steps, the loss falling, host-clock and CUDA-event ms of a step, and
   each kernel's launches a step (8 / 4 / 4 forward, 8 / 8 / 4 backward,
   2 for the update); then the flagship's default parameters (the
   reference's ``PRNGKey(0)`` draw, made on the host) on the card, bit for
   bit the host's draw;
8. main path: the port's ``BrokerServer`` on 127.0.0.1 with default
   router config (backend torch, device cuda) and verify on; 4 publisher
   connections with confirms send 100,000 topic and 50,000 headers
   messages of 256 B; every queue's count must equal a host oracle built
   from the port's Python matchers, 16 consumers must receive their
   messages in publish order with identical bodies, and both kernels'
   launch counts must be above zero. The publish window is traced with
   ``torch.profiler`` for the card's busy time and idle share, and every
   kernel call's arguments are kept;
9. main-path kernels: every kept call replayed through the kernel and its
   plain version, word for word; the most common shape is timed and
   bounded (the wrapper's host time split as in 3), and the kernels line
   reports it;
10. forecast path: the port's ``BrokerServer`` under a publishing load,
   with a ``ForecastService`` at flagship width (window 64, no training)
   on the card until it has made at least 200 forecasts, a forecast
   every ~0.04 s; the first forward (the worker thread's first cuBLAS
   call) is reported apart from the latency statistics of the rest. The
   product precision is reset to torch's default first, so the service
   must set its own. The forecasts must be finite and non-negative, each
   kernel's launches must equal the forwards times its launches a
   forward (8 layernorm, 4 attention, 4 GELU), the sampler must have seen
   the load, and every forward's window is replayed through the plain
   path;
11. training forecast path: the same with the reference's training
   defaults (20 steps a round on a batch of 16 at lr 1e-3) for at least
   20 rounds: ms per round and per step (the first apart), finite losses,
   each kernel's launches equal to the steps and forwards times their
   launches each, every forward replayed on the parameters it forwarded,
   and the card's busy and idle share;
12. long window: the same service with the service's compact default
   model (d_model 64, 4 heads, 2 layers) at a window of 1,024, training
   at its defaults for 3 rounds: finite forecasts and losses, every
   forward replayed through the plain path, each kernel's launches those
   of the steps and forwards made;
13. sharded train step: ``make_sharded_train_step`` at the flagship width
   from the [train] state (B = 16, lr 1e-3, 5 steps), (a) over NCCL with
   one rank a card (in this process on a one-card host) and (b) as 4
   tensor-parallel ranks sharing the first card over gloo with CUDA
   tensors: the loss bit for bit on every rank, falling, and within one
   bf16 step of the one-device kernel step's on the same card after 1 and
   5 steps; the gathered trees within ``tree_limits``; replicated leaves
   bit-equal on every rank; each kernel launched as often as a sharded
   step launches it; every kernel call of each rank's first step (its
   inputs copied before the call) replayed through the wrapper and its
   plain version at the kernel's own limits, at that rank's shapes (one
   head of 64 and 256 w1 columns at tp = 4); host-clock ms a step, one
   traced step's device split and host ops, and one tp all-reduce's host
   time;
14. durable node: a port node from ``BrokerServer.from_config`` in a child
   process, every ``chana.mq.wal.*`` key at its default (fsync, flush-ms
   2), its router on the card, the main path's tables (512 topic patterns
   and 512 headers bindings over 4,096 queues, all durable); 4 publishers
   with confirms send 50,000 persistent 256 B messages (a third of the
   main path's stream, at its topic : headers mix); after the last confirm
   the node is SIGKILLed, a new node starts from the same directory and
   every queue is consumed: every confirmed message in every queue it was
   routed to, exactly once, in publish order per publisher, with its body,
   against a host oracle; confirmed msg/s, the card's busy share of the
   publish window (traced in the node), the WAL's commits and their µs,
   records replayed and the time from the restart to the first delivery;
15. node: the port's node as an operator starts it, ``python -m
   chanamq_tpu_torch.broker.server --config node.json --port P
   --admin-port A`` (``main``, unchanged, in a child process of this
   script), with admin, telemetry, SLOs, control (dry-run) and the
   forecaster on, the router and the forecaster on the card, every other
   key at its default except three cadences, so that rounds happen inside
   the phase: forecast interval 0.1 s, train-interval 2 s (default 30 s),
   telemetry interval 0.25 s. Over AMQP the main path's tables and 4
   confirming publishers' 50,000 transient 256 B messages at its topic :
   headers mix (the [durable] phase's count, a third of the main path's);
   every queue's count from ``/admin/queues`` against the host oracle,
   then consumers drain every queue against it; ``/admin/forecast`` at
   least 3 rounds, finite loss and forecasts, no error; the forecast
   gauges on ``/metrics``; ``/admin/health`` 200; ``/admin/control``
   ticking; SIGTERM exit 0 within 30 s. The node reports every kernel's
   launches in its own process (each of the nine at least once, the
   update's two under their split names) and its last forecast replayed
   through the plain path on the parameters that made it, within
   FORWARD_LIMIT; seconds from spawn to listening and confirmed msg/s;
16. cluster: three port nodes, each ``main`` in a child
   (``cluster_child``: its router kernel calls counted and kept), as the
   README's "Replication & failover" deploys them: ``replicate.factor`` 2,
   ``replicate.sync`` true, a private store each (the WAL at its
   defaults), the router on the card, every other key at its default (two
   data-plane streams a peer) but ``replicate.ack-timeout-ms`` 60,000
   (``CLUSTER_ACK_TIMEOUT_MS``). The main path's tables,
   all durable, declared through node 1; 4 confirming publishers, two on
   each node but the victim (the owner of the most queues), send 25,000
   persistent 256 B messages at the main path's mix; the victim is
   SIGKILLed after the last confirm; the survivors must promote every
   queue it held, consumers on them drain every queue against the host
   oracle (exactly once, in order, with its body), each survivor's router
   kernels must have launched in its process and replay word for word,
   and SIGTERM exits each 0; convergence, confirmed msg/s, the kill to
   the last promotion and to the first delivery, the messages served from
   promoted copies, the router's compiles and generation on each node
   before and after the kill, and each process's card memory;
17. shard: one sharded node, ``main`` in a child (``shard_child``) with
   ``chana.mq.shard.count`` 4, reuse-port, admin on, the router on the
   card, two data-plane streams a peer (the default); the supervisor
   spawns four workers of the port's server module (each run as
   ``cluster_child``); the main path's tables (transient queues) and 4
   confirming publishers' 50,000
   transient 256 B messages, one publisher a worker; every queue's count
   at its owner's ``/admin/queues`` against the oracle, every queue
   drained against it, router batches on every worker, cross-shard pushes,
   each worker's kernels launched and replayed, nvidia-smi showing the
   four workers on the card and not the supervisor, and SIGTERM to the
   supervisor exiting 0 within 30 s with every worker gone;
18. bench-route: ``python -m chanamq_tpu_torch.bench --route``'s spec
   (``run_route_spec``) in this process with the router on the card:
   topic tables of 1,000, 10,000 and 100,000 bindings, 16,384 keys in
   batches of 512 through the torch backend (warm and cold) and the numpy
   body against the trie, every routed set against the trie's, the
   1,000,000-binding compile and the key-shared fan-out; 0 parity
   mismatches, the topic kernel launched, every router call kept and
   replayed word for word;
19. bench: the PerfTest specs ``transient_autoack_3p3c``,
   ``persistent_ack_3p1c``, ``fanout_1p8c`` and ``topic_3p3c_wildcards``
   through the port's bench harness (``run_spec``, 5 s each, every
   producer and consumer a process), each broker ``main`` in a child
   (``cluster_child``) on the card reporting its kernel launches and
   router counters and replaying its kernel calls; no error and
   deliveries above 0; delivered msg/s, p50/p99 and the broker's CPU µs
   a message;
20. soak: the nine soak runners of ``chaos/soak.py`` at the bench's seeds
   and sizes plus the chaos soak over Unix sockets (the shard-crash
   drill), every broker on the card, with the bench's gates (no
   violation, the overload soak under its hard limit, the elastic soak's
   two runs with one decision-log digest); each run's seconds and its
   router launches counted from 0;
21. the kernels line (nine kernels, each with its launches in the
   [node] phase's node as ``node_path``, the router's also in each
   [cluster] survivor and [shard] worker as ``cluster_path``, on the
   bench's paths as ``bench_path`` and in each soak run as
   ``soak_path``), the card line, and the result line.

Without a card, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import math
import os
import random
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType

STAR, PAD, MISS = -1, -2, -3

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3. Integer compares and
# ORs have no tensor-core path: 132 SMs x 64 INT32 lanes x 1.98 GHz boost =
# 16.7 Tops/s (the same clock and SM count that give the data sheet's
# 67 TFLOP/s fp32 as 132 x 128 lanes x 2 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNEL_N, KERNEL_W = 512, 128
TOPIC_P = TOPIC_S = 8
HEADERS_R, HEADERS_H = 8, 16
BATCHES = (16, 256, 1024)
# ~0.1 s at the H100's 1.98 GHz: long enough for the host to queue a timed
# loop behind it
SLEEP_CYCLES = 200_000_000

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and
# dense bf16 on them
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
# the service forwards one window; __graft_entry__.entry() a batch of 32
FORECAST_BATCHES = (1, 32)
# the forward layernorm also runs in every train step, at the service's
# training batch of 16
LAYERNORM_BATCHES = (1, 16, 32)
# the limit the tests hold the port's forward to against the JAX forward
# in bf16 (measured 0.031 there): the two paths differ only in the order
# of float32 sums, so bf16 roundings that land on the other side of a
# boundary carry through the layers
FORWARD_LIMIT = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. device -----------------------------------------------------------------


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; nvidia-smi: {smi}")
    return {"kind": name, "smi": smi, "count": torch.cuda.device_count()}


# -- 2. build ------------------------------------------------------------------


SOURCES = ("router_match", "forecaster", "forecaster_train")
# the kernels whose tensor-core instructions the build reports
MMA_KERNELS = {"forecaster": "causal_attention",
               "forecaster_train": "causal_attention_bwd"}


def sass_mma_count(lib_path: str, kernel: str):
    """HMMA and HGMMA instructions (the tensor cores' mma.sync and wgmma)
    in ``kernel``'s SASS in a built library, by ``cuobjdump -sass`` from
    nvcc's toolkit; the string "not available" where it has none."""
    from chanamq_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return "not available"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = f"{kernel}_kernel" in line
        elif inside and re.search(r"\bHG?MMA\b", line):
            count += 1
    return count


def phase_build() -> dict:
    """Every CUDA source of the port, one nvcc each, all started together;
    raises if any build fails. Reports ptxas's registers, shared memory
    and spills, and the attention kernels' tensor-core instructions."""
    from concurrent.futures import ThreadPoolExecutor

    from chanamq_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    out = {}
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if re.search(r"registers|spill|Compiling entry", ln)]
        log(f"[build] {b.path} in {b.seconds:.2f} s"
            f"{' (already built)' if b.seconds == 0.0 else ''}")
        for ln in ptxas:
            log(f"[build] ptxas: {ln}")
        out[name] = {"seconds": b.seconds, "ptxas": ptxas}
        if name in MMA_KERNELS:
            kernel = MMA_KERNELS[name]
            out[name]["hmma"] = sass_mma_count(b.path, kernel)
            log(f"[build] sass: {kernel}_kernel has {out[name]['hmma']} "
                "HMMA/HGMMA instructions")
    log(f"[build] {len(SOURCES)} sources in "
        f"{time.perf_counter() - t0:.2f} s (wall)")
    return out


# -- 3. kernels at full width --------------------------------------------------


def _set_bits(masks: np.ndarray, rng: np.random.Generator, n_real: int,
              n_bits: int) -> None:
    """Random queue bits per real row, and bit 31 of every word somewhere
    (the bit whose int32 view is negative)."""
    for i in range(n_real):
        for b in rng.choice(n_bits, size=int(rng.integers(1, 17)),
                            replace=False):
            masks[i, b >> 5] |= np.uint32(1 << (int(b) & 31))
    for w in range(masks.shape[1]):
        masks[w % n_real, w] |= np.uint32(1 << 31)


def topic_tables(rng: np.random.Generator, n: int = KERNEL_N,
                 w: int = KERNEL_W, p: int = TOPIC_P, s: int = TOPIC_S,
                 vocab: int = 64) -> dict:
    """A compiled-topic-shaped table (numpy, as compile.py builds it) with
    random patterns; the last rows are padding (PAD cells, zero masks)."""
    n_real = max(1, n - max(1, n // 40))
    pre = np.full((n, p), PAD, np.int32)
    suf = np.full((n, s), PAD, np.int32)
    plen = np.zeros(n, np.int32)
    slen = np.zeros(n, np.int32)
    has_hash = np.zeros(n, bool)
    masks = np.zeros((n, w), np.uint32)
    for i in range(n_real):
        hh = bool(rng.random() < 0.5)
        pl = int(rng.integers(0 if hh else 1, p + 1))
        sl = int(rng.integers(0, s + 1)) if hh else 0
        cells = rng.integers(0, vocab, size=pl + sl).astype(np.int32)
        cells[rng.random(pl + sl) < 0.25] = STAR
        pre[i, :pl] = cells[:pl]
        if sl:
            suf[i, s - sl:] = cells[pl:]
        plen[i], slen[i], has_hash[i] = pl, sl, hh
    _set_bits(masks, rng, n_real, w * 32)
    return {"n": n_real, "p": p, "s": s, "pre": pre, "suf": suf,
            "plen": plen, "slen": slen, "has_hash": has_hash,
            "masks": masks, "mask_words": w}


def topic_messages(rng: np.random.Generator, table: dict, b: int,
                   vocab: int = 64):
    """``b`` message rows: most instantiate a random pattern row (so they
    match), some are random words, some out-of-vocab (MISS), and the last
    are batch padding (mlen 0), as route_batch pads a batch."""
    p, s = table["p"], table["s"]
    pre_m = np.full((b, p), MISS, np.int32)
    suf_m = np.full((b, s), MISS, np.int32)
    mlen = np.zeros(b, np.int32)
    for i in range(b - max(1, b // 16)):
        if rng.random() < 0.8:
            r = int(rng.integers(0, table["n"]))
            pl, sl = int(table["plen"][r]), int(table["slen"][r])
            mid = int(rng.integers(0, 3)) if table["has_hash"][r] else 0
            cells = list(table["pre"][r, :pl]) + [STAR] * mid + (
                list(table["suf"][r, s - sl:]) if sl else [])
        else:
            cells = [STAR] * int(rng.integers(1, p + s))
        words = [int(rng.integers(0, vocab)) if c == STAR else int(c)
                 for c in cells]
        words = [MISS if rng.random() < 0.03 else x for x in words]
        m = len(words)
        if m == 0:
            words, m = [MISS], 1  # an empty key is one empty word
        mlen[i] = m
        for j in range(min(m, p)):
            pre_m[i, j] = words[j]
        for j in range(min(m, s)):
            suf_m[i, s - 1 - j] = words[m - 1 - j]
    return pre_m, suf_m, mlen


def headers_tables(rng: np.random.Generator, n: int = KERNEL_N,
                   w: int = KERNEL_W, r: int = HEADERS_R,
                   pairs: int = 256) -> dict:
    n_real = max(1, n - max(1, n // 40))
    req = np.full((n, r), PAD, np.int32)
    rcount = np.zeros(n, np.int32)
    is_all = np.zeros(n, bool)
    masks = np.zeros((n, w), np.uint32)
    for i in range(n_real):
        k = int(rng.integers(1, r + 1))
        req[i, :k] = rng.choice(pairs, size=k, replace=False)
        rcount[i] = k
        is_all[i] = bool(rng.random() < 0.5)
    _set_bits(masks, rng, n_real, w * 32)
    return {"n": n_real, "r": r, "req": req, "rcount": rcount,
            "is_all": is_all, "masks": masks, "mask_words": w}


def headers_messages(rng: np.random.Generator, table: dict, b: int,
                     h: int = HEADERS_H, pairs: int = 256) -> np.ndarray:
    pids = np.full((b, h), MISS, np.int32)
    for i in range(b - max(1, b // 16)):
        got: list = []
        if rng.random() < 0.8:
            row = int(rng.integers(0, table["n"]))
            req = [int(x) for x in table["req"][row, :table["rcount"][row]]]
            keep = len(req) if rng.random() < 0.5 else int(
                rng.integers(1, len(req) + 1))
            got = req[:keep]
        for x in rng.choice(pairs, size=int(rng.integers(0, h)),
                            replace=False):
            if len(got) < h and int(x) not in got:
                got.append(int(x))
        pids[i, :len(got)] = got
    return pids


def _time_ms(fn, iters: int, *, device_only: bool) -> float:
    """Mean time of one ``fn()`` call by CUDA events around a loop of
    ``iters`` calls. With ``device_only`` the loop is queued behind a
    sleeping kernel, so the calls run back to back and the events time the
    card's work alone; without it the host's cost of each call is in it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _before_first(flags: np.ndarray) -> np.ndarray:
    """True at every cell up to and including the first True along the
    last axis (all True where there is none): where a loop that stops at
    its first such cell has been."""
    return (np.cumsum(flags, axis=-1) - flags) == 0


def _or_work(ok: np.ndarray, w: int) -> tuple[int, int]:
    """ORs to merge each message's matched mask rows: ``(hits - 1) * W``
    a message. Returns (operations, matched pairs)."""
    hits = ok.sum(axis=1)
    return int(np.maximum(hits - 1, 0).sum()) * w, int(hits.sum())


def topic_work(pre, suf, plen, slen, has_hash, masks, pre_m, suf_m,
               mlen) -> tuple[int, int]:
    """(int32 operations, matched pairs) that the topic match needs on
    these inputs (numpy arrays). Only real messages (mlen > 0) and real
    rows (a non-zero mask: padding rows carry no queue) count; a pair
    costs its length test and, when that passes, its literal pattern
    cells up to and including the first that differs. STAR and PAD cells
    need no compare."""
    real = masks.any(axis=1)
    msg = mlen > 0
    cells = np.concatenate([pre[real], suf[real]], axis=1)      # [N,C]
    toks = np.concatenate([pre_m[msg], suf_m[msg]], axis=1)     # [B,C]
    m = mlen[msg][:, None]
    pl, sl = plen[real][None, :], slen[real][None, :]
    len_ok = np.where(has_hash[real][None, :], m >= pl + sl, m == pl)
    lit = cells >= 0
    differ = lit[None] & (cells[None] != toks[:, None])          # [B,N,C]
    compares = (lit[None] & _before_first(differ)).sum(axis=2)
    ops = len_ok.size + int(compares[len_ok].sum())
    or_ops, matched = _or_work(len_ok & ~differ.any(axis=2),
                               masks.shape[1])
    return ops + or_ops, matched


def headers_work(req, rcount, is_all, masks, pids) -> tuple[int, int]:
    """(int32 operations, matched pairs) that the headers match needs on
    these inputs (numpy arrays). Only real rows (non-zero mask) and
    messages with a known pair id count. A required pair id is searched
    for among the message's known ids up to the first equal one; a row
    stops at its first deciding cell (a missing id for ``all``, a present
    one for ``any``) and then tests its count. PAD cells need nothing."""
    real = masks.any(axis=1)
    known = pids != MISS
    msg = known.any(axis=1)
    req, rcount, is_all = req[real], rcount[real], is_all[real]
    known = known[msg]
    eq = ((req[None, :, :, None] == pids[msg][:, None, None, :])
          & known[:, None, None, :])                             # [B,N,R,H]
    present = eq.any(axis=3)
    # compares a search makes: the 1-based rank of the first equal id
    # among the message's known ids, or all of them when none is equal
    rank = np.cumsum(known, axis=1)[:, None, None, :]
    nknown = known.sum(axis=1)[:, None, None]
    searched = np.where(eq, rank, nknown[..., None]).min(axis=3)
    cell = (req != PAD)[None]
    decides = np.where(is_all[None, :, None], ~present, present) & cell
    ops = int((searched * (cell & _before_first(decides))).sum())
    ops += present.shape[0] * present.shape[1]   # the count test
    cnt = (present & cell).sum(axis=2)
    ok = np.where(is_all[None, :], cnt == rcount[None, :], cnt > 0)
    or_ops, matched = _or_work(ok, masks.shape[1])
    return ops + or_ops, matched


def _kernel_fns(name: str):
    """(wrapper, plain version, prepare, work counter) of one kernel."""
    from chanamq_tpu_torch.kernels import router_match as rm

    if name == "topic_match":
        return (rm.topic_match, rm.topic_match_ref, rm.prepare_topic_match,
                topic_work)
    return (rm.headers_match, rm.headers_match_ref,
            rm.prepare_headers_match, headers_work)


def shape_of(name: str, args) -> str:
    """The dims of one kernel call ``(table, *messages)``, as the CUDA
    launcher takes them."""
    table = args[0]
    if name == "topic_match":
        n, p = table.pre.shape
        return (f"B={args[1].shape[0]} N={n} P={p} S={table.suf.shape[1]} "
                f"W={table.masks.shape[1]}")
    n, r = table.req.shape
    b, h = args[1].shape
    return f"B={b} N={n} R={r} H={h} W={table.masks.shape[1]}"


def _numpy_args(name: str, args) -> list:
    """One call's table (its row-major tensors) and messages as numpy
    arrays, as the work counters take them."""
    table = args[0]
    fields = (("pre", "suf", "plen", "slen", "has_hash", "masks")
              if name == "topic_match" else
              ("req", "rcount", "is_all", "masks"))
    return [getattr(table, f).cpu().numpy() for f in fields] + [
        a.cpu().numpy() for a in args[1:]]


def hold(name: str, args, *, timed: bool = True, iters: int = 100,
         mb: int | None = None) -> dict:
    """One call's inputs ``(table, *messages)`` through the kernel's
    wrapper and its plain version: every word must agree. With ``timed``
    (on a card), also the kernel's device time, the wrapper's per-call
    time, the plain version's device time, and the bound for these
    inputs. ``mb`` times the kernel at that many messages a block instead
    of the wrapper's choice (the wrapper's own call is checked as well)."""
    kern, ref, prepare, work = _kernel_fns(name)
    got = kern(*args)
    want = ref(*args)
    outs = [got]
    if mb is not None and got.is_cuda:
        out, launch = prepare(*args, mb=mb)
        launch()
        outs.append(out)
    bad = 0
    for out in outs:
        diff = (out.to(torch.int64) - want.to(torch.int64)).abs()
        bad += int((diff != 0).sum())
    if bad:
        raise AssertionError(f"{name} {shape_of(name, args)}: {bad} words "
                             "differ from the plain version")
    row = {"shape": shape_of(name, args), "mismatched_words": bad,
           "max_abs_err": float(diff.max()) if diff.numel() else 0.0}
    if not timed:
        return row
    ops, matched = work(*_numpy_args(name, args))
    # the row-major tables (not the transposes beside them), the messages
    # and the output
    nbytes = _nbytes(*args[0][:-2], *args[1:], got)
    bound_ms, bound_by = _bound(nbytes, ops)
    row.update({"matched_pairs": matched, "ops": ops, "bytes": nbytes,
                "bound_ms": bound_ms, "bound_by": bound_by})
    if got.is_cuda:
        _, launch = prepare(*args, mb=mb)
        row["ms"] = _time_ms(launch, iters, device_only=True)
        row["wrapper_ms"] = _time_ms(lambda: kern(*args), iters,
                                     device_only=False)
        row["plain_ms"] = _time_ms(lambda: ref(*args), max(5, iters // 10),
                                   device_only=True)
    return row


def wrapper_split(name: str, args, iters: int = 200) -> dict:
    """Host us of one router wrapper call at these inputs, and of its
    steps, each the mean of ``iters`` back-to-back calls on the host clock
    (one synchronize after each loop): ``call`` the whole wrapper,
    ``prepare`` its checks, output and binding without the launch,
    ``empty`` the output's ``torch.empty``, ``bind`` binding a launcher
    (``build.launcher``), ``launch`` the bound launch alone; ``call_nogc``
    the wrapper with Python's collector off; ``tracked`` the objects the
    collector tracks."""
    import gc

    from chanamq_tpu_torch.kernels import build

    from chanamq_tpu_torch.kernels import forecaster as fk

    kern, _, prepare, _ = _kernel_fns(name)
    out, launch = prepare(*args)
    lib = fk.library()
    device = out.device

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        return (t1 - t0) / iters / 1e3

    res = {"call": host_us(lambda: kern(*args)),
           "prepare": host_us(lambda: prepare(*args)),
           "empty": host_us(lambda: torch.empty(out.shape, dtype=out.dtype,
                                                device=device)),
           "bind": host_us(lambda: build.launcher(
               lib, lib.chana_empty, "empty", device, 1, 32)),
           "launch": host_us(launch)}
    gc.disable()
    try:
        res["call_nogc"] = host_us(lambda: kern(*args))
    finally:
        gc.enable()
    res["tracked"] = len(gc.get_objects())
    return res


def _log_split(tag: str, name: str, shape: str, split: dict) -> None:
    log(f"[{tag}] {name} {shape}: wrapper host us: call "
        f"{split['call']:.3f} (collector off {split['call_nogc']:.3f}); "
        f"prepare {split['prepare']:.3f}, of it torch.empty "
        f"{split['empty']:.3f} and binding a launcher {split['bind']:.3f}; "
        f"the bound launch {split['launch']:.3f}; "
        f"{split['tracked']} objects tracked by the collector")


def _log_row(tag: str, name: str, row: dict) -> None:
    nan = float("nan")
    log(f"[{tag}] {name} {row['shape']}: 0 differing words, "
        f"{row['matched_pairs']} matched pairs; kernel "
        f"{row.get('ms', nan) * 1e3:.3f} us (wrapper call "
        f"{row.get('wrapper_ms', nan) * 1e3:.3f} us), plain "
        f"{row.get('plain_ms', nan) * 1e3:.3f} us, bound "
        f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: {row['ops']} "
        f"int32 ops, {row['bytes']} B); library: none")


def phase_kernels(device: torch.device, seed: int, n: int = KERNEL_N,
                  w: int = KERNEL_W, batches=BATCHES,
                  iters: int = 100) -> dict:
    """Both kernels against their plain versions at the router's caps
    (full token widths, every mask word). Returns {kernel name: {B: row}}
    and raises on any differing word. On a card each kernel is also timed
    at each of ``MSGS_PER_BLOCK`` messages a block (``by_mb``), every
    instance held word for word too."""
    from chanamq_tpu_torch.kernels import router_match as rm
    from chanamq_tpu_torch.router.tables import tables_from_numpy

    rng = np.random.default_rng(seed)
    out: dict = {"topic_match": {}, "headers_match": {}}
    tt = topic_tables(rng, n, w)
    td = tables_from_numpy(tt, device)
    ht = headers_tables(rng, n, w)
    hd = tables_from_numpy(ht, device)
    for b in batches:
        msg = [torch.from_numpy(a).to(device)
               for a in topic_messages(rng, tt, b)]
        pids = torch.from_numpy(headers_messages(rng, ht, b)).to(device)
        cases = (("topic_match", (td, *msg)), ("headers_match", (hd, pids)))
        for name, args in cases:
            row = out[name][b] = hold(name, args, iters=iters)
            _log_row("kernels", name, row)
            if device.type == "cuda":
                row["split"] = wrapper_split(name, args)
                _log_split("kernels", name, row["shape"], row["split"])
                # messages a block: each instance against the wrapper's
                # choice, on the same inputs
                row["by_mb"] = {}
                for mb in rm.MSGS_PER_BLOCK:
                    alt = hold(name, args, iters=iters, mb=mb)
                    row["by_mb"][mb] = alt["ms"]
                log(f"[kernels] {name} B={b}: kernel us by messages a "
                    "block " + ", ".join(
                        f"{mb}: {ms * 1e3:.3f}"
                        for mb, ms in row["by_mb"].items())
                    + f" (the wrapper takes {rm.msgs_per_block(b)})")
    return out


def phase_path_kernels(calls: dict, iters: int = 100,
                       tag: str = "path-kernels",
                       path: str = "main-path") -> dict:
    """Every kernel call a path made (the main path unless ``path`` says
    otherwise), replayed: the wrapper against the plain version on the
    same inputs, word for word. The most common shape's last call is
    timed and bounded, on a card also at each of ``MSGS_PER_BLOCK``
    messages a block; it stands for the kernel in the kernels line.
    Returns {kernel name: row}."""
    from chanamq_tpu_torch.kernels import router_match as rm

    out = {}
    for name, recorded in calls.items():
        if not recorded:
            raise AssertionError(f"the {path} made no {name} call")
        shapes: dict = {}
        worst = 0.0
        for args in recorded:
            r = hold(name, args, timed=False)
            worst = max(worst, r["max_abs_err"])
            shapes[r["shape"]] = shapes.get(r["shape"], 0) + 1
        common = max(shapes, key=shapes.get)
        rep = [a for a in recorded if shape_of(name, a) == common][-1]
        row = out[name] = hold(name, rep, iters=iters)
        row.update({"calls": len(recorded), "shapes": shapes,
                    "max_abs_err": max(worst, row["max_abs_err"])})
        log(f"[{tag}] {name}: {len(recorded)} {path} calls "
            f"replayed, 0 differing words; shapes {shapes}")
        _log_row(tag, name, row)
        if rep[1].is_cuda:
            row["split"] = wrapper_split(name, rep)
            _log_split(tag, name, common, row["split"])
            row["by_mb"] = {mb: hold(name, rep, iters=iters, mb=mb)["ms"]
                            for mb in rm.MSGS_PER_BLOCK}
            log(f"[{tag}] {name}: kernel us by messages a block "
                + ", ".join(f"{mb}: {ms * 1e3:.3f}"
                            for mb, ms in row["by_mb"].items()))
    return out


# -- 4. main path ----------------------------------------------------------------


class Workload:
    """A seeded topic + headers deployment at the router's documented caps
    and the publish stream over it, with the host oracle of every route.

    Topic: ``n_patterns`` wildcard patterns of 2-6 words from a 64-word
    vocabulary (a literal first word, then ``*`` or at most one ``#``
    among literals) over ``n_queues``
    queues, each queue bound once. Half the patterns own 1-3 queues, the
    rest share the remaining queues; keys instantiate a pattern (mostly a
    small one) and are kept when they reach 1-16 queues. Headers:
    ``n_patterns`` all/any bindings of 1-4 (header, value) pairs over 16
    headers with 64 values each, one queue
    each, and ``n_header_sets`` message header sets built around a binding,
    kept when they reach 1-16 queues."""

    def __init__(self, seed: int, *, n_queues: int = 4096,
                 n_patterns: int = 512, n_keys: int = 32768,
                 n_header_sets: int = 1024, n_topic: int = 100_000,
                 n_headers: int = 50_000, publishers: int = 4,
                 body_size: int = 256) -> None:
        from chanamq_tpu_torch.amqp.properties import BasicProperties
        from chanamq_tpu_torch.broker.matchers import (
            HeadersMatcher, TopicMatcher)

        rng = random.Random(seed)
        self.queues = [f"q{i:04d}" for i in range(n_queues)]
        vocab = [f"w{i}" for i in range(64)]
        patterns: list = []
        seen: set = set()
        while len(patterns) < n_patterns:
            # a literal first word keeps patterns specific enough that a
            # key reaches a handful of queues, as in a real topic tree
            toks = [rng.choice(vocab)] + [
                rng.choice(vocab) if rng.random() < 0.8 else "*"
                for _ in range(rng.randint(1, 5))]
            if rng.random() < 0.3:
                toks[rng.randrange(1, len(toks))] = "#"
            elif "*" not in toks:
                toks[rng.randrange(1, len(toks))] = "*"
            pat = ".".join(toks)
            if pat not in seen:
                seen.add(pat)
                patterns.append(pat)
        order = list(self.queues)
        rng.shuffle(order)
        n_small = n_patterns // 2
        sizes = [rng.randint(1, 3) for _ in range(n_small)]
        rest = n_queues - sum(sizes)
        n_large = n_patterns - n_small
        sizes += [rest // n_large + (1 if i < rest % n_large else 0)
                  for i in range(n_large)]
        self.topic_bindings: list = []  # (pattern, queue)
        pos = 0
        for pat, k in zip(patterns, sizes):
            for q in order[pos:pos + k]:
                self.topic_bindings.append((pat, q))
            pos += k
        self.topic = TopicMatcher()
        for pat, q in self.topic_bindings:
            self.topic.bind(pat, q)

        keys: list = []
        self.key_routes: dict = {}
        while len(keys) < n_keys:
            i = rng.randrange(n_small) if rng.random() < 0.9 else \
                rng.randrange(n_small, n_patterns)
            words = []
            for t in patterns[i].split("."):
                if t == "#":
                    words += [rng.choice(vocab)
                              for _ in range(rng.randint(0, 2))]
                elif t == "*":
                    words.append(rng.choice(vocab) if rng.random() < 0.9
                                 else f"oov{rng.randrange(1000)}")
                else:
                    words.append(t)
            key = ".".join(words)
            if key in self.key_routes:
                continue
            route = self.topic.route(key)
            if 1 <= len(route) <= 16:
                self.key_routes[key] = route
                keys.append(key)

        names = [f"h{i}" for i in range(16)]
        values = [f"v{i}" for i in range(64)]
        hq = rng.sample(self.queues, min(n_patterns, n_queues))
        self.headers_bindings: list = []  # (queue, args)
        for q in hq:
            args = {h: rng.choice(values)
                    for h in rng.sample(names, rng.randint(1, 4))}
            args["x-match"] = rng.choice(["all", "any"])
            self.headers_bindings.append((q, args))
        self.headers = HeadersMatcher()
        for q, args in self.headers_bindings:
            self.headers.bind("", q, args)
        header_sets: list = []
        self.header_routes: list = []
        while len(header_sets) < n_header_sets:
            _, args = rng.choice(self.headers_bindings)
            hs = {h: v for h, v in args.items() if h != "x-match"}
            for h in rng.sample(names, rng.randint(1, 4)):
                hs.setdefault(h, rng.choice(values))
            route = self.headers.route("", hs)
            if 1 <= len(route) <= 16:
                header_sets.append(hs)
                self.header_routes.append(route)
        # one properties object per set: the client caches its encoding
        self.header_props = [BasicProperties(headers=hs)
                             for hs in header_sets]

        # the stream: per publisher, (kind, key or header-set index)
        self.publishers = publishers
        self.body_size = body_size
        per_pub_t = n_topic // publishers
        per_pub_h = n_headers // publishers
        self.streams: list = []
        for _ in range(publishers):
            items = [("t", rng.choice(keys)) for _ in range(per_pub_t)]
            items += [("h", rng.randrange(n_header_sets))
                      for _ in range(per_pub_h)]
            rng.shuffle(items)
            self.streams.append(items)
        self.expected: dict = {q: [] for q in self.queues}  # q -> [(p, i)]
        for p, items in enumerate(self.streams):
            for i, (kind, x) in enumerate(items):
                route = (self.key_routes[x] if kind == "t"
                         else self.header_routes[x])
                for q in route:
                    self.expected[q].append((p, i))
        self.n_messages = sum(len(s) for s in self.streams)
        self.mean_fanout = (sum(len(v) for v in self.expected.values())
                            / max(1, self.n_messages))

    def body(self, p: int, i: int) -> bytes:
        head = f"{p}:{i}:".encode()
        fill = bytes((p * 131 + i * 7 + j) & 0xFF
                     for j in range(self.body_size - len(head)))
        return head + fill


async def _drive(server, wl: Workload, consumers: int, window: int,
                 trace=None) -> dict:
    from chanamq_tpu_torch.client import AMQPClient

    port = server.bound_port
    setup = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
    ch = await setup.channel()
    await ch.exchange_declare("smoke.topic", "topic")
    await ch.exchange_declare("smoke.headers", "headers")
    for q in wl.queues:
        await ch.queue_declare(q)
    for pat, q in wl.topic_bindings:
        await ch.queue_bind(q, "smoke.topic", pat)
    for q, args in wl.headers_bindings:
        await ch.queue_bind(q, "smoke.headers", "", arguments=args)

    async def publish(p: int) -> None:
        c = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
        pch = await c.channel()
        await pch.confirm_select()
        for i, (kind, x) in enumerate(wl.streams[p]):
            if kind == "t":
                pch.basic_publish(wl.body(p, i), exchange="smoke.topic",
                                  routing_key=x)
            else:
                pch.basic_publish(wl.body(p, i), exchange="smoke.headers",
                                  properties=wl.header_props[x])
            if len(pch.unconfirmed) >= window:
                await pch.wait_unconfirmed_below(window // 2, timeout=120)
        await pch.wait_unconfirmed_below(1, timeout=300)
        await c.close()

    if trace is not None:
        trace.start()
    try:
        t0 = time.perf_counter()
        await asyncio.gather(*(publish(p) for p in range(wl.publishers)))
        publish_s = time.perf_counter() - t0
    finally:
        if trace is not None:
            trace.stop()

    vq = server.broker.vhosts["/"].queues
    wrong = [(q, vq[q].message_count, len(wl.expected[q]))
             for q in wl.queues if vq[q].message_count != len(wl.expected[q])]
    if wrong:
        raise AssertionError(f"{len(wrong)} queue counts differ from the "
                             f"oracle, e.g. {wrong[:5]}")

    # consumers on queues with traffic: per publisher, publish order, and
    # the exact (routing key, body) that was published
    crng = random.Random(len(wl.queues))
    busy = [q for q in wl.queues if wl.expected[q]]
    chosen = crng.sample(busy, min(consumers, len(busy)))
    got: dict = {q: [] for q in chosen}
    done = asyncio.Event()
    remaining = [sum(len(wl.expected[q]) for q in chosen)]

    cons = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
    cch = await cons.channel()
    for q in chosen:
        def cb(msg, _q=q) -> None:
            got[_q].append(msg)
            remaining[0] -= 1
            if remaining[0] == 0:
                done.set()
        await cch.basic_consume(q, cb, no_ack=True)
    if remaining[0]:
        await asyncio.wait_for(done.wait(), timeout=120)
    delivered = 0
    for q in chosen:
        want = wl.expected[q]
        if len(got[q]) != len(want):
            raise AssertionError(f"{q}: {len(got[q])} delivered, "
                                 f"{len(want)} expected")
        per_pub: dict = {}
        for msg in got[q]:
            p, i = (int(x) for x in msg.body.split(b":", 2)[:2])
            kind, x = wl.streams[p][i]
            key = x if kind == "t" else ""
            if msg.body != wl.body(p, i) or msg.routing_key != key:
                raise AssertionError(f"{q}: message {p}:{i} altered")
            per_pub.setdefault(p, []).append(i)
        for p, seq in per_pub.items():
            if seq != [i for pp, i in want if pp == p]:
                raise AssertionError(f"{q}: publisher {p} out of order")
        delivered += len(got[q])
    await cons.close()
    await setup.close()
    return {"publish_s": publish_s, "consumed_queues": len(chosen),
            "delivered": delivered}


def _timed(fn, spent: dict, key: str):
    """``fn`` with its host-clock time summed into ``spent[key]`` (ns)."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] += time.perf_counter_ns() - t0
    return wrapper


def _recording(fn, calls: list):
    """``fn`` that also keeps every call's arguments in ``calls``."""
    def wrapper(*args):
        calls.append(args)
        return fn(*args)
    return wrapper


# the CUDA kernels behind a wrapper whose kernels are not "<name>_kernel"
KERNEL_SYMBOLS = {"clip_momentum_sgd": ("sumsq_kernel", "momentum_sgd_kernel"),
                  "sum_of_squares": ("sumsq_kernel",),
                  "causal_attention_bwd": ("causal_attention_bwd_stats_kernel",
                                           "causal_attention_bwd_kernel")}


def device_busy(trace, names=("topic_match", "headers_match")) -> dict:
    """The card's work in a ``torch.profiler`` trace: the union of its
    kernel and copy intervals (us), and per kernel of ``names`` its
    launches and device time (us)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in trace.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels: dict = {}
    for e in trace.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if any(sym in e.name for sym in KERNEL_SYMBOLS.get(
                    name, (f"{name}_kernel",))):
                k = kernels.setdefault(name, {"launches": 0, "us": 0.0})
                k["launches"] += 1
                k["us"] += e.time_range.elapsed_us()
    return {"events": len(spans), "busy_us": busy, "kernels": kernels}


def phase_main(device: torch.device, seed: int, *, consumers: int = 16,
               window: int = 2048, calls: dict | None = None,
               **sizes) -> dict:
    """Drive the port's BrokerServer over real sockets through the router
    kernels on ``device`` and hold every queue to the oracle. ``calls``,
    if given, receives every kernel wrapper call's arguments under the
    kernel's name. On a card the publish window is traced with
    ``torch.profiler`` for the device's busy time."""
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.config import Config
    from chanamq_tpu_torch.router import compile as rcompile

    t0 = time.perf_counter()
    wl = Workload(seed, **sizes)
    log(f"[main] workload: {len(wl.topic_bindings)} topic bindings over "
        f"{len({q for _, q in wl.topic_bindings})} queues, "
        f"{len(wl.headers_bindings)} headers bindings, "
        f"{len(wl.key_routes)} keys, {len(wl.header_props)} header sets, "
        f"{wl.n_messages} messages, mean fan-out {wl.mean_fanout:.3f} "
        f"(built in {time.perf_counter() - t0:.1f} s)")
    overrides = {"amqp.interface": "127.0.0.1", "amqp.port": 0,
                 "router.verify": True}
    if device.type != "cuda":
        overrides["router.device"] = str(device)
    server = BrokerServer.from_config(Config(overrides, env={}))
    router = server.broker.router
    # host-clock split of the publish window: the whole deferred-flush
    # routing call (verify's oracle included), and inside it the
    # compiled-table batch call (tokenize, upload, kernel, decode)
    spent = {"route_pending": 0, "route_batch": 0}
    router.route_pending = _timed(router.route_pending, spent,
                                  "route_pending")
    real_route_batch = rcompile.route_batch
    rcompile.route_batch = _timed(real_route_batch, spent, "route_batch")
    trace = None
    if device.type == "cuda":
        trace = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    async def run() -> dict:
        await server.start()
        try:
            return await _drive(server, wl, consumers, window, trace)
        finally:
            await server.stop()

    try:
        with (recording_router(calls) if calls is not None
              else contextlib.nullcontext()):
            res = asyncio.run(run())
    finally:
        rcompile.route_batch = real_route_batch
    m = server.broker.metrics
    res.update({
        "route_pending_s": spent["route_pending"] / 1e9,
        "route_batch_s": spent["route_batch"] / 1e9,
        "messages": wl.n_messages, "mean_fanout": wl.mean_fanout,
        "msgs_per_s": wl.n_messages / res["publish_s"],
        "router_batches": m.router_batches,
        "router_batch_msgs": m.router_batch_msgs,
        "router_fallback_msgs": m.router_fallback_msgs,
        "router_parity_mismatches": m.router_parity_mismatches,
        "backend": server.broker.router.backend,
        "device": str(server.broker.router.device),
        "trace": device_busy(trace) if trace is not None else None,
    })
    if m.router_parity_mismatches:
        raise AssertionError(
            f"{m.router_parity_mismatches} router parity mismatches")
    return res


# -- 6. forecaster kernels -------------------------------------------------------


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def forecaster_limit(name: str, want: torch.Tensor) -> float:
    """Max abs error allowed between a forecaster kernel and its plain
    version on the same bf16 inputs. Both compute in float32 and round to
    bf16 at the same points, but sum in a different order, so a value can
    round to the neighbouring bf16: one step at the largest output for
    layernorm and GELU. Attention rounds twice inside (q . k and the
    weights), and a flipped logit or weight moves the output by about one
    step more: two steps."""
    top = float(want.float().abs().max()) if want.numel() else 0.0
    return (2.0 if name == "causal_attention" else 1.0) * bf16_ulp(top)


def forecaster_inputs(gen: torch.Generator, cfg, b: int,
                      device: torch.device) -> dict:
    """Seeded bf16 inputs at the shapes ``forward`` gives each kernel at
    batch ``b``: the residual stream [b, T, d_model] (offset, so the mean
    matters) with a layernorm scale, the fused qkv product [b, T,
    3 d_model], and the w1 product [b, T, d_ff]."""
    t, d, f = cfg.seq_len, cfg.d_model, cfg.d_ff

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    bf16 = torch.bfloat16
    return {
        "layernorm": ((randn(b, t, d) * 2 + 0.5).to(bf16).to(device),
                      (1 + 0.1 * randn(d)).to(device)),
        "causal_attention": (randn(b, t, 3 * d).to(bf16).to(device),
                             cfg.n_heads),
        "gelu_tanh": ((randn(b, t, f) * 2).to(bf16).to(device),),
    }


def forecaster_work(name: str, args) -> tuple[int, int, float]:
    """(bytes, operations, least seconds for those operations) that one
    forecaster kernel call needs: each input read once, each output
    written once. Layernorm does 7 float32 operations a value (sum; sub,
    square, add; sub, two multiplies), GELU 9 (tanh counted as one);
    attention two bf16 products over the causal pairs (2 * head_dim a
    pair each, on the tensor cores) and 5 float32 softmax operations a
    pair (divide, subtract, exp, add, divide)."""
    if name == "layernorm":
        x, scale = args
        nbytes = 2 * x.numel() * x.element_size() + _nbytes(scale)
        ops = 7 * x.numel()
        return nbytes, ops, ops / F32_FLOPS_PER_S
    if name == "gelu_tanh":
        (x,) = args
        ops = 9 * x.numel()
        return 2 * x.numel() * x.element_size(), ops, ops / F32_FLOPS_PER_S
    qkv, heads = args
    b, t, d3 = qkv.shape
    hd = d3 // 3 // heads
    pairs = b * heads * t * (t + 1) // 2
    mma, soft = 2 * 2 * hd * pairs, 5 * pairs
    nbytes = qkv.numel() * qkv.element_size() * 4 // 3  # qkv + [B,T,D] out
    return (nbytes, mma + soft,
            mma / BF16_TC_FLOPS_PER_S + soft / F32_FLOPS_PER_S)


def _library_call(name: str, args):
    """One PyTorch call that computes the same function, as a yardstick:
    the port never calls it."""
    import torch.nn.functional as F

    if name == "layernorm":
        x, scale = args
        w = scale.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), w, None, 1e-6)
    if name == "gelu_tanh":
        (x,) = args
        return lambda: F.gelu(x, approximate="tanh")
    qkv, heads = args
    b, t, d3 = qkv.shape
    q, k, v = qkv.view(b, t, 3, heads, d3 // 3 // heads).permute(
        2, 0, 3, 1, 4)
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)


def hold_forecaster(name: str, args, *, timed: bool = True,
                    iters: int = 100, kern=None) -> dict:
    """One forecaster kernel call through its wrapper (``kern``, else the
    wrapper named ``name``) and its plain version on the same inputs,
    within ``forecaster_limit``, and the bound; with ``timed``, on a card,
    also the kernel's device time, the wrapper's per-call time, and the
    plain version's and the library call's device times."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    kern = kern or getattr(fk, name)
    ref = getattr(fk, f"{name}_ref")
    got = kern(*args)
    want = ref(*args)
    err = float((got.float() - want.float()).abs().max())
    limit = forecaster_limit(name, want)
    shape = "x".join(str(n) for n in args[0].shape)
    if not err <= limit:
        raise AssertionError(f"{name} [{shape}]: max abs error {err} over "
                             f"the limit {limit}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} [{shape}]: non-finite output")
    nbytes, ops, ops_s = forecaster_work(name, args)
    bytes_s = nbytes / HBM_BYTES_PER_S
    row = {"shape": shape, "max_abs_err": err, "limit": limit,
           "bytes": nbytes, "ops": ops, "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "operations" if ops_s > bytes_s else "bytes"}
    if timed and got.is_cuda:
        _, launch = getattr(fk, f"prepare_{name}")(*args)
        row["ms"] = _time_ms(launch, iters, device_only=True)
        row["wrapper_ms"] = _time_ms(lambda: kern(*args), iters,
                                     device_only=False)
        row["plain_ms"] = _time_ms(lambda: ref(*args), iters,
                                   device_only=True)
        row["library_ms"] = _time_ms(_library_call(name, args), iters,
                                     device_only=True)
    return row


FORECASTER_KERNELS = ("layernorm", "causal_attention", "gelu_tanh")


def phase_forecaster_kernels(device: torch.device, seed: int, cfg=None,
                             batches=FORECAST_BATCHES,
                             layernorm_batches=(),
                             iters: int = 100) -> dict:
    """The three forecaster kernels against their plain versions at the
    shapes ``forward`` gives them at each batch, layernorm also at the
    batches of ``layernorm_batches`` (after the others, so the inputs of
    ``batches`` stay the same). Returns {kernel name: {B: row}} and raises
    on an error over its limit."""
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    cfg = cfg or ForecasterConfig()
    gen = torch.Generator().manual_seed(seed)
    out: dict = {name: {} for name in FORECASTER_KERNELS}
    extra = [b for b in layernorm_batches if b not in batches]
    for b in tuple(batches) + tuple(extra):
        inputs = forecaster_inputs(gen, cfg, b, device)
        for name in FORECASTER_KERNELS if b in batches else ("layernorm",):
            row = out[name][b] = hold_forecaster(name, inputs[name],
                                                 iters=iters)
            nan = float("nan")
            log(f"[fc-kernels] {name} B={b} [{row['shape']}]: max abs err "
                f"{row['max_abs_err']:.6g} (limit {row['limit']:.6g}); "
                f"kernel {row.get('ms', nan) * 1e3:.3f} us (wrapper call "
                f"{row.get('wrapper_ms', nan) * 1e3:.3f} us), plain "
                f"{row.get('plain_ms', nan) * 1e3:.3f} us, library "
                f"{row.get('library_ms', nan) * 1e3:.3f} us, bound "
                f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: "
                f"{row['ops']} ops, {row['bytes']} B)")
    return out


def phase_floor(device: torch.device, iters: int = 100) -> dict:
    """The floor under every kernel time above: ``_time_ms`` over launches
    of an empty kernel (``csrc/forecaster.cu``'s ``chana_empty``), through
    the same ctypes launch, as one block of 32 threads and as the
    layernorm backward's grid at the training batch."""
    from chanamq_tpu_torch.kernels import build
    from chanamq_tpu_torch.kernels import forecaster as fk

    lib = fk.library()
    grid = fk.layernorm_geometry(16 * 64, 256).grid
    out = {}
    for key, blocks, threads in (("one_block", 1, 32),
                                 ("ln_grid", grid, 32 * fk.LN_WARPS)):
        launch = build.launcher(lib, lib.chana_empty, "empty", device,
                                blocks, threads)
        out[key] = {"blocks": blocks, "threads": threads,
                    "ms": _time_ms(launch, iters, device_only=True)}
    log(f"[floor] an empty launch, timed as the kernels are: "
        f"{out['one_block']['ms'] * 1e3:.3f} us at 1 block of 32 threads, "
        f"{out['ln_grid']['ms'] * 1e3:.3f} us at {grid} blocks of "
        f"{32 * fk.LN_WARPS}")
    return out


# -- 7. forward at full width ----------------------------------------------------


def _host_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn()`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


# cuBLAS's matrix-product kernels on this card are named after GEMMs
# ("gemm", "xmma", "cutlass") or, for many of cuBLAS 12's Hopper products,
# "nvjet"
GEMM_MARKERS = ("gemm", "nvjet", "xmma", "cutlass")


def device_split(fn, names) -> dict:
    """One call of ``fn`` (after a warm-up call) traced with
    ``torch.profiler``: the device time and launches of the matrix
    products (cuBLAS), of the port's kernels ``names``, of NCCL's
    collectives, and of the rest (elementwise ops, casts, reductions,
    copies), in us."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {k: {"launches": 0, "us": 0.0}
           for k in ("products", "port_kernels", "collectives", "other")}
    out["other"]["fills"] = 0  # of them torch's fills (zeros, zero_)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        if any(any(sym in e.name for sym in KERNEL_SYMBOLS.get(
                n, (f"{n}_kernel",))) for n in names):
            kind = "port_kernels"
        elif any(m in low for m in GEMM_MARKERS):
            kind = "products"
        elif "nccl" in low:
            kind = "collectives"
        else:
            kind = "other"
            out[kind]["fills"] += "fill" in low
        out[kind]["launches"] += 1
        out[kind]["us"] += e.time_range.elapsed_us()
    return out


def products_work(cfg, b: int) -> tuple[int, float]:
    """(bytes, least seconds) of ``forward``'s matrix products at batch
    ``b``: the embed, each layer's qkv, proj, w1 and w2 (bf16, on the
    tensor cores) and the float32 head; each operand read once and each
    product written once."""
    t, d, f, n = cfg.seq_len, cfg.d_model, cfg.d_ff, cfg.n_features
    rows = b * t
    shapes = [(rows, n, d)] + [(rows, d, 3 * d), (rows, d, d), (rows, d, f),
                               (rows, f, d)] * cfg.n_layers
    nbytes = sum(2 * (m * k + k * e + m * e) for m, k, e in shapes)
    flops = sum(2 * m * k * e for m, k, e in shapes)
    head = 2 * b * d * n
    nbytes += 4 * (b * d + d * n + b * n)
    seconds = max(nbytes / HBM_BYTES_PER_S,
                  flops / BF16_TC_FLOPS_PER_S + head / F32_FLOPS_PER_S)
    return nbytes, seconds


def phase_forward(device: torch.device, seed: int, cfg=None,
                  batches=FORECAST_BATCHES, iters: int = 20) -> dict:
    """``forward`` through the kernels against ``forward`` through the
    plain versions, same parameters and inputs, within FORWARD_LIMIT.
    Returns {B: row}; on a card with the host-clock ms of one forward
    (synchronized) and its CUDA-event ms, for both paths."""
    from chanamq_tpu_torch.kernels.forecaster import PLAIN
    from chanamq_tpu_torch.models.forecaster import (
        ForecasterConfig, cast_weights, forward, init_params,
        set_matmul_precision, synthetic_batch)

    if device.type == "cuda":
        set_matmul_precision()
    cfg = cfg or ForecasterConfig()
    params = init_params(seed, cfg, device)
    weights = cast_weights(params, cfg)
    out = {}
    for b in batches:
        x, _ = synthetic_batch(np.random.default_rng(seed + b), cfg, b,
                               device)

        def kern():
            return forward(params, x, cfg, weights=weights)

        def plain():
            return forward(params, x, cfg, weights=weights, ops=PLAIN)

        got, want = kern(), plain()
        err = float((got - want).abs().max())
        if got.shape != (b, cfg.n_features) or not torch.isfinite(got).all():
            raise AssertionError(f"forward B={b}: shape {tuple(got.shape)} "
                                 "or non-finite values")
        if not err <= FORWARD_LIMIT:
            raise AssertionError(f"forward B={b}: max abs error {err} over "
                                 f"the limit {FORWARD_LIMIT}")
        row = out[b] = {"max_abs_err": err, "limit": FORWARD_LIMIT,
                        "max_abs_out": float(want.abs().max())}
        nbytes, seconds = products_work(cfg, b)
        row.update({"products_bytes": nbytes,
                    "products_bound_ms": seconds * 1e3})
        if got.is_cuda:
            row.update({
                "host_ms": _host_ms(kern, iters),
                "event_ms": _time_ms(kern, iters, device_only=False),
                "plain_host_ms": _host_ms(plain, iters),
                "plain_event_ms": _time_ms(plain, iters, device_only=False),
                "traced": device_split(kern, FORECASTER_KERNELS)})
        nan = float("nan")
        log(f"[forward] B={b} {cfg.n_layers} layers d_model {cfg.d_model}: "
            f"kernel path against plain path max abs err {err:.6g} (limit "
            f"{FORWARD_LIMIT}, outputs up to {row['max_abs_out']:.4g}); one "
            f"forward {row.get('host_ms', nan):.4f} ms host clock, "
            f"{row.get('event_ms', nan):.4f} ms CUDA events (plain path "
            f"{row.get('plain_host_ms', nan):.4f} / "
            f"{row.get('plain_event_ms', nan):.4f} ms); traced on the card: "
            f"{row.get('traced')}; the products' bound "
            f"{row['products_bound_ms'] * 1e3:.4f} us "
            f"({row['products_bytes']} B)")
    return out


# -- 8. training kernels ---------------------------------------------------------


TRAIN_KERNELS = ("layernorm_bwd", "causal_attention_bwd", "gelu_tanh_bwd",
                 "clip_momentum_sgd")
# the service's training batch, and __graft_entry__'s batch
TRAIN_BATCHES = (16, 32)
# bf16 steps at the largest output between a backward kernel and its plain
# version: layernorm and GELU round once from float32 math summed in
# another order (one step); attention rounds dout . v, the logits'
# cotangent and the weights inside before its output, and a value that
# lands on the other side of one of those boundaries moves the sums it
# enters by about a step more each (four)
TRAIN_STEPS = {"layernorm_bwd": 1.0, "causal_attention_bwd": 4.0,
               "gelu_tanh_bwd": 1.0}
# relative limit between the update kernel's clip scale and the plain
# version's: both sum 3.2 M float32 squares, in blocks of 16 a thread and
# in a pairwise tree, each within a few 1e-7 of the exact sum
SCALE_RTOL = 1e-5


def attention_bwd_inputs(qkv: torch.Tensor, dout: torch.Tensor,
                         heads: int) -> tuple:
    """The attention backward's arguments ``(qkv, dout, heads, stats)``:
    ``stats``, the row statistics the forward keeps in training, from one
    launch of the forward kernel on a card (None on the CPU)."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    return qkv, dout, heads, fk.causal_attention_with_stats(qkv, heads)[1]


def train_inputs(gen: torch.Generator, cfg, b: int,
                 device: torch.device) -> dict:
    """Seeded inputs at the shapes the train step gives each backward
    kernel at batch ``b`` (bf16 activations and cotangents), and, for the
    update, float32 parameters, momentum and gradients at ``cfg``'s
    parameter shapes (gradients of global norm about 2, so that the clip
    at 1 is active)."""
    from chanamq_tpu_torch.models.forecaster import param_shapes

    t, d, f = cfg.seq_len, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    shapes = sorted(param_shapes(cfg).items())
    g_std = 2.0 / math.sqrt(sum(math.prod(s) for _, s in shapes))
    return {
        "layernorm_bwd": (randn(b, t, d).to(bf16).to(device),
                          (randn(b, t, d, std=2.0) + 0.5).to(bf16).to(device),
                          (1 + 0.1 * randn(d)).to(device)),
        "causal_attention_bwd": attention_bwd_inputs(
            randn(b, t, 3 * d).to(bf16).to(device),
            randn(b, t, d).to(bf16).to(device), cfg.n_heads),
        "gelu_tanh_bwd": (randn(b, t, f).to(bf16).to(device),
                          randn(b, t, f, std=2.0).to(bf16).to(device)),
        "clip_momentum_sgd": (
            [randn(*s, std=0.05).to(device) for _, s in shapes],
            [randn(*s, std=0.01).to(device) for _, s in shapes],
            [randn(*s, std=g_std).to(device) for _, s in shapes],
            1e-3, 1.0),
    }


def train_work(name: str, args) -> tuple[int, int, float]:
    """(bytes, operations, least seconds for those operations) of one
    training kernel call: each input read once, each output written once.
    Layernorm's backward does ~17 float32 operations a value (the
    statistics again, 7; the backward, 10), GELU's ~16; attention's
    backward five bf16 products over the causal pairs (q . k, dout . v,
    dq, dk, dv: 2 * head_dim each, on the tensor cores) and ~8 float32
    softmax operations a pair; the update 7 float32 operations a
    parameter (g^2 and its sum, g * s, 0.9 m, + g, lr * m, p -)."""
    if name == "layernorm_bwd":
        dy, x, scale = args
        nbytes = 3 * _nbytes(x) + 2 * _nbytes(scale)
        ops = 17 * x.numel()
        return nbytes, ops, ops / F32_FLOPS_PER_S
    if name == "gelu_tanh_bwd":
        dy, x = args
        ops = 16 * x.numel()
        return 3 * _nbytes(x), ops, ops / F32_FLOPS_PER_S
    if name == "clip_momentum_sgd":
        params, _, _, _, _ = args
        n = sum(p.numel() for p in params)
        return 5 * 4 * n, 7 * n, 7 * n / F32_FLOPS_PER_S
    qkv, dout, heads = args[:3]
    b, t, d3 = qkv.shape
    hd = d3 // 3 // heads
    pairs = b * heads * t * (t + 1) // 2
    mma, soft = 5 * 2 * hd * pairs, 8 * pairs
    return (2 * _nbytes(qkv) + _nbytes(dout), mma + soft,
            mma / BF16_TC_FLOPS_PER_S + soft / F32_FLOPS_PER_S)


def _train_library_call(name: str, args):
    """One PyTorch call that computes the same function, as a yardstick
    the port never calls: autograd's backward of ``F.layer_norm`` (weight
    only, eps 1e-6), ``F.scaled_dot_product_attention(is_causal=True)``
    and ``F.gelu(approximate="tanh")``; ``clip_grad_norm_`` and a foreach
    ``SGD(momentum=0.9)`` step for the update."""
    import torch.nn.functional as F

    if name == "clip_momentum_sgd":
        params, momentum, grads, lr, clip = args
        leaves = [torch.nn.Parameter(p.clone()) for p in params]
        for leaf, g in zip(leaves, grads):
            leaf.grad = g.clone()
        opt = torch.optim.SGD(leaves, lr=lr, momentum=0.9, foreach=True)
        opt.step()  # the momentum buffers exist from here on

        def update():
            torch.nn.utils.clip_grad_norm_(leaves, clip, foreach=True)
            opt.step()
        return update
    if name == "layernorm_bwd":
        dy, x, scale = args
        xr = x.detach().requires_grad_()
        w = scale.to(x.dtype).requires_grad_()
        out = F.layer_norm(xr, (x.shape[-1],), w, None, 1e-6)
        inputs = (xr, w)
    elif name == "gelu_tanh_bwd":
        dy, x = args
        xr = x.detach().requires_grad_()
        out = F.gelu(xr, approximate="tanh")
        inputs = (xr,)
    else:
        qkv, dy, heads = args[:3]
        b, t, d3 = qkv.shape
        q, k, v = (z.detach().requires_grad_() for z in qkv.view(
            b, t, 3, heads, d3 // 3 // heads).permute(2, 0, 3, 1, 4))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        dy = dy.view(b, t, heads, -1).transpose(1, 2)
        inputs = (q, k, v)
    return lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True)


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def hold_train_kernel(name: str, args, *, timed: bool = True,
                      iters: int = 100) -> dict:
    """One training kernel call through its wrapper and its plain version
    on the same inputs: the backward passes within ``TRAIN_STEPS`` bf16
    steps at the largest output (layernorm's float32 dscale within the
    float32 error of a sum over its rows), the update's clip scale within
    ``SCALE_RTOL`` and, given the kernel's scale, its parameters and
    momentum bit for bit; and the bound. With ``timed``, on a card, also
    the kernel's device time, the wrapper's per-call time, and the plain
    version's and the library call's device times."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.kernels import update as upd

    mod = upd if name == "clip_momentum_sgd" else fk
    kern = getattr(mod, name)
    ref = getattr(mod, f"{name}_ref")
    shape = "x".join(str(n) for n in args[0].shape) if name != \
        "clip_momentum_sgd" else f"{len(args[0])} tensors, " \
        f"{sum(p.numel() for p in args[0])} values"
    row: dict = {"shape": shape}
    if name == "clip_momentum_sgd":
        params, momentum, grads, lr, clip = args
        p_k = [p.clone() for p in params]
        m_k = [m.clone() for m in momentum]
        p_r = [p.clone() for p in params]
        m_r = [m.clone() for m in momentum]
        s_k = kern(p_k, m_k, grads, lr, clip)
        s_r = ref([p.clone() for p in params], [m.clone() for m in momentum],
                  grads, lr, clip)
        ref(p_r, m_r, grads, lr, clip, scale=s_k)
        err = max(_max_err(a, b) for a, b in zip(p_k + m_k, p_r + m_r))
        s_err = abs(float(s_k) - float(s_r)) / float(s_r)
        row.update({"max_abs_err": err, "limit": 0.0, "scale": float(s_k),
                    "scale_rel_err": s_err, "scale_limit": SCALE_RTOL})
        if err != 0.0 or not s_err <= SCALE_RTOL or not float(s_k) < 1.0:
            raise AssertionError(f"{name}: update differs by {err} at the "
                                 f"kernel's scale, scale {float(s_k)} vs "
                                 f"{float(s_r)} (clip must be active)")
    else:
        got = kern(*args)
        want = ref(*args)
        if name == "layernorm_bwd":
            (got, got_ds), (want, want_ds) = got, want
            dy, x, _ = args
            rows = x.numel() // x.shape[-1]
            x32 = x.float()
            xhat = (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
                x32.var(-1, unbiased=False, keepdim=True) + 1e-6)
            terms = (dy.float() * xhat).abs().reshape(rows, -1).sum(0)
            ds_limit = rows * 2.0 ** -24 * float(terms.max())
            ds_err = _max_err(got_ds, want_ds)
            row.update({"dscale_err": ds_err, "dscale_limit": ds_limit})
            if not ds_err <= ds_limit:
                raise AssertionError(f"{name} [{shape}]: dscale error "
                                     f"{ds_err} over {ds_limit}")
        err = _max_err(got, want)
        top = float(want.float().abs().max())
        limit = TRAIN_STEPS[name] * bf16_ulp(top)
        row.update({"max_abs_err": err, "limit": limit})
        if not err <= limit or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} [{shape}]: max abs error {err} "
                                 f"over the limit {limit}, or non-finite")
    nbytes, ops, ops_s = train_work(name, args)
    bytes_s = nbytes / HBM_BYTES_PER_S
    row.update({"bytes": nbytes, "ops": ops,
                "bound_ms": max(bytes_s, ops_s) * 1e3,
                "bound_by": "operations" if ops_s > bytes_s else "bytes"})
    on_card = (args[0][0] if name == "clip_momentum_sgd" else args[0]).is_cuda
    if timed and on_card:
        if name == "clip_momentum_sgd":
            params, momentum, grads, lr, clip = args
            work = ([p.clone() for p in params], [m.clone() for m in momentum],
                    grads, lr, clip)
            _, launches = upd.prepare_clip_momentum_sgd(*work)

            def launch():
                for one in launches:
                    one()
        else:
            _, launch = getattr(mod, f"prepare_{name}")(*args)
            work = args
            if hasattr(launch, "parts"):  # attention's row pass and main
                row["parts_ms"] = [_time_ms(part, iters, device_only=True)
                                   for part in launch.parts]
                # what keeping the row statistics costs the forward
                qkv, _, heads, _ = args
                row["fwd_ms"], row["fwd_stats_ms"] = (
                    _time_ms(mod.prepare_causal_attention(
                        qkv, heads, keep_stats=keep)[1], iters,
                        device_only=True) for keep in (False, True))
        row["ms"] = _time_ms(launch, iters, device_only=True)
        row["wrapper_ms"] = _time_ms(lambda: kern(*work), iters,
                                     device_only=False)
        row["plain_ms"] = _time_ms(lambda: ref(*work), iters,
                                   device_only=True)
        row["library_ms"] = _time_ms(_train_library_call(name, args), iters,
                                     device_only=True)
    return row


# windows past every limit the attention kernels had when they held a head
# whole, at the service's compact head width (16) and the flagship's (64)
LONG_WINDOWS = (400, 1024, 2048)
LONG_WIDTHS = (16, 64)
LONG_HEADS = 4


def phase_long_windows(device: torch.device, seed: int,
                       windows=LONG_WINDOWS, widths=LONG_WIDTHS,
                       fwd_batch: int = 1, bwd_batch: int = 16,
                       iters: int = 20) -> dict:
    """Both attention kernels at long windows against their plain versions
    within their limits (the forward at ``fwd_batch``, the service's one
    window; the backward at ``bwd_batch``, its training batch), each also
    launched twice for the same bits; with times and bounds on a card.
    Returns {(T, head width): {"causal_attention": row,
    "causal_attention_bwd": row}}."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    gen = torch.Generator().manual_seed(seed + 2)
    bf16 = torch.bfloat16
    out: dict = {}
    nan = float("nan")
    for t in windows:
        for hd in widths:
            cfg = ForecasterConfig(seq_len=t, d_model=LONG_HEADS * hd,
                                   n_heads=LONG_HEADS, d_ff=4 * LONG_HEADS * hd)
            d = cfg.d_model
            fwd = forecaster_inputs(gen, cfg, fwd_batch, device)[
                "causal_attention"]
            bwd = attention_bwd_inputs(
                torch.randn(bwd_batch, t, 3 * d, generator=gen).to(bf16)
                .to(device),
                torch.randn(bwd_batch, t, d, generator=gen).to(bf16)
                .to(device), LONG_HEADS)
            rows = out[(t, hd)] = {
                "causal_attention": hold_forecaster(
                    "causal_attention", fwd, iters=iters),
                "causal_attention_bwd": hold_train_kernel(
                    "causal_attention_bwd", bwd, iters=iters)}
            for name, args in (("causal_attention", fwd),
                               ("causal_attention_bwd", bwd)):
                fn = getattr(fk, name)
                if not torch.equal(fn(*args), fn(*args)):
                    raise AssertionError(f"{name} T={t} head width {hd}: "
                                         "two launches differ")
                row = rows[name]
                tag = "fc-kernels" if name == "causal_attention" else \
                    "fc-train-kernels"
                log(f"[{tag}] {name} T={t} head width {hd} "
                    f"[{row['shape']}]: max abs err "
                    f"{row['max_abs_err']:.6g} (limit {row['limit']:.6g}), "
                    f"two launches the same bits{_parts_note(row)}; kernel "
                    f"{row.get('ms', nan) * 1e3:.3f} us (wrapper call "
                    f"{row.get('wrapper_ms', nan) * 1e3:.3f} us), plain "
                    f"{row.get('plain_ms', nan) * 1e3:.3f} us, library "
                    f"{row.get('library_ms', nan) * 1e3:.3f} us, bound "
                    f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']})")
    return out


def phase_init(device: torch.device) -> dict:
    """The flagship's default parameters (``init_params(0, cfg)``, the
    reference's ``PRNGKey(0)`` draw, made on the host) on the card equal
    the host's draw bit for bit: nothing random runs on the card."""
    from chanamq_tpu_torch.models.forecaster import (
        ForecasterConfig, init_params,
    )

    cfg = ForecasterConfig()
    t0 = time.perf_counter()
    card = init_params(0, cfg, device)
    seconds = time.perf_counter() - t0
    host = init_params(0, cfg, "cpu")
    bad = [k for k in host if not torch.equal(card[k].cpu(), host[k])]
    if bad or list(card) != list(host):
        raise AssertionError(f"default parameters differ on the card: {bad}")
    values = sum(v.numel() for v in host.values())
    log(f"[init] the flagship's default parameters (key 0): {len(host)} "
        f"tensors, {values} values, on the card bit for bit the host's "
        f"draw; drawn and moved in {seconds:.3f} s (host clock)")
    return {"tensors": len(host), "values": values, "seconds": seconds}


def phase_bwd_warps(device: torch.device, seed: int = 0,
                    rounds: int = 3, iters: int = 200) -> dict:
    """The backward's main kernel alone on eight warps and on four, in
    turn, each held bit for bit to the wrapper's choice, at the flagship's
    training batches (8: 128 blocks; 16: 256; 32: 512) and the compact
    default's (d_model 64, 4 heads, window 64, batch 16: 256 blocks):
    {"B=.. d_model ..": {warps: [us a round]}}. The wrapper takes eight
    while the grid fits two blocks an SM."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    out: dict = {}
    for b, d in ((8, 256), (16, 256), (32, 256), (16, 64)):
        args = attention_bwd_inputs(
            torch.randn(b, 64, 3 * d, generator=gen).to(bf16).to(device),
            torch.randn(b, 64, d, generator=gen).to(bf16).to(device), 4)
        want = fk.causal_attention_bwd(*args)
        times: dict = {8: [], 4: []}
        for _ in range(rounds):
            for warps in times:
                dqkv, launch = fk.prepare_causal_attention_bwd(
                    *args, warps=warps)
                launch()
                torch.cuda.synchronize()
                if not torch.equal(dqkv, want):
                    raise AssertionError(f"B={b} d_model {d}: {warps} warps "
                                         "differ from the wrapper's choice")
                times[warps].append(_time_ms(launch.parts[1], iters,
                                             device_only=True))
        key = f"B={b} d_model {d}"
        out[key] = times
        chosen = fk.attention_bwd_warps(b * 16, fk._sm_count(device))
        log(f"[bwd-warps] {key} (T=64, 4 heads, {b * 16} blocks): main "
            f"kernel us alone, {rounds} rounds each: 8 warps "
            + ", ".join(f"{x * 1e3:.3f}" for x in times[8]) + "; 4 warps "
            + ", ".join(f"{x * 1e3:.3f}" for x in times[4])
            + f"; the wrapper takes {chosen}")
    return out


def _parts_note(row: dict) -> str:
    """The attention backward's two launches timed alone, for a log line."""
    if "parts_ms" not in row:
        return ""
    row_pass, main = (ms * 1e3 for ms in row["parts_ms"])
    return (f"; row pass {row_pass:.3f} us + main kernel {main:.3f} us "
            f"alone; the forward keeping the row statistics "
            f"{row['fwd_stats_ms'] * 1e3:.3f} us ({row['fwd_ms'] * 1e3:.3f} "
            "us without)")


def phase_train_kernels(device: torch.device, seed: int, cfg=None,
                        batches=TRAIN_BATCHES, iters: int = 100) -> dict:
    """The four training kernels against their plain versions at the
    shapes the train step gives them at each batch (the update's shapes
    do not depend on the batch). Returns {kernel name: {B: row}} and
    raises on an error over its limit."""
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    cfg = cfg or ForecasterConfig()
    gen = torch.Generator().manual_seed(seed + 1)
    out: dict = {name: {} for name in TRAIN_KERNELS}
    nan = float("nan")
    for b in batches:
        inputs = train_inputs(gen, cfg, b, device)
        for name in TRAIN_KERNELS:
            row = out[name][b] = hold_train_kernel(name, inputs[name],
                                                   iters=iters)
            extra = ""
            if name == "layernorm_bwd":
                extra = (f", dscale err {row['dscale_err']:.6g} (limit "
                         f"{row['dscale_limit']:.6g})")
            elif name == "clip_momentum_sgd":
                extra = (f" at the kernel's scale {row['scale']:.9g}, which "
                         f"is within {row['scale_rel_err']:.3g} of the plain "
                         f"version's (limit {SCALE_RTOL})")
            extra += _parts_note(row)
            log(f"[fc-train-kernels] {name} B={b} [{row['shape']}]: max abs "
                f"err {row['max_abs_err']:.6g} (limit {row['limit']:.6g})"
                f"{extra}; kernel {row.get('ms', nan) * 1e3:.3f} us "
                f"(wrapper call {row.get('wrapper_ms', nan) * 1e3:.3f} us), "
                f"plain {row.get('plain_ms', nan) * 1e3:.3f} us, library "
                f"{row.get('library_ms', nan) * 1e3:.3f} us, bound "
                f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: "
                f"{row['ops']} ops, {row['bytes']} B)")
    return out


# -- 9. train step at full width --------------------------------------------------


# max abs difference between the train step through the kernels and the
# same step through the plain versions under torch autograd, from one state
# (bf16 activations): a momentum tree within MOMENTUM_STEPS bf16 steps at
# its largest value (each gradient is a bf16 product's output, rounded
# where the two paths may round to neighbours, and the clip scales both
# alike); a parameter tree within what its momentum differences allow,
# |dp_n| <= lr * sum over steps of |dm_k|, plus the float32 rounding of
# each subtraction
MOMENTUM_STEPS = 3.0


def tree_limits(p_k: dict, p_r: dict, m_k: dict, m_r: dict, lr: float,
                dm_sum: dict, steps: int) -> dict:
    """Per tree: (max abs diff, limit) of the momentum and the parameters
    after ``steps`` steps; ``dm_sum`` accumulates each tree's largest
    momentum difference over the steps so far (updated in place)."""
    out = {}
    for name in p_k:
        dm = float((m_k[name] - m_r[name]).abs().max())
        dm_sum[name] = dm_sum.get(name, 0.0) + dm
        dp = float((p_k[name] - p_r[name]).abs().max())
        top_m = float(m_r[name].abs().max())
        top_p = float(p_r[name].abs().max())
        out[name] = {
            "momentum": (dm, MOMENTUM_STEPS * bf16_ulp(top_m)),
            # lr as float32 is above 1e-3 by 5e-8 of itself
            "params": (dp, lr * (1 + 2.0 ** -20) * dm_sum[name]
                       + 8 * steps * 2.0 ** -24 * top_p),
        }
    return out


def phase_train(device: torch.device, seed: int, cfg=None, batch: int = 16,
                steps: int = 20, iters: int = 10) -> dict:
    """``make_train_step`` through the kernels against the same step
    through the plain versions (``ops=PLAIN``), from one state on one
    ``synthetic_batch``, for ``steps`` steps: every tree within
    ``tree_limits`` after step 1 and after the last, finite losses, and
    the loss must fall. On a card also the host-clock and CUDA-event ms
    of one step (the kernel step from where the run ended) and each
    kernel's launches in one step."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.models.forecaster import (
        ForecasterConfig, init_momentum, init_params, make_train_step,
        set_matmul_precision, synthetic_batch)

    if device.type == "cuda":
        set_matmul_precision()
    cfg = cfg or ForecasterConfig()
    lr = 1e-3
    params = init_params(seed, cfg, device)
    p_k = {k: v.clone() for k, v in params.items()}
    p_r = {k: v.clone() for k, v in params.items()}
    m_k, m_r = init_momentum(p_k), init_momentum(p_r)
    data = synthetic_batch(np.random.default_rng(seed), cfg, batch, device)
    kern = make_train_step(cfg, lr=lr)
    plain = make_train_step(cfg, lr=lr, ops=fk.PLAIN)
    losses_k, losses_r = [], []
    dm_sum: dict = {}
    checked = {}
    for step in range(1, steps + 1):
        _, _, lk = kern(p_k, m_k, data)
        _, _, lr_ = plain(p_r, m_r, data)
        losses_k.append(float(lk))
        losses_r.append(float(lr_))
        trees = tree_limits(p_k, p_r, m_k, m_r, lr, dm_sum, step)
        if step in (1, steps):
            checked[step] = trees
            bad = {(n, kind): v for n, t in trees.items()
                   for kind, v in t.items() if not v[0] <= v[1]}
            if bad:
                raise AssertionError(f"train step {step}: trees over their "
                                     f"limits {bad}")
    losses = np.array(losses_k + losses_r)
    if not np.isfinite(losses).all():
        raise AssertionError("train: a non-finite loss")
    if not (losses_k[-1] < losses_k[0] and losses_r[-1] < losses_r[0]):
        raise AssertionError(f"train: the loss did not fall: {losses_k}")
    res = {"losses": losses_k, "plain_losses": losses_r, "trees": checked,
           "cfg": cfg, "batch": batch}
    if device.type == "cuda":
        counted = counted_wrappers()
        before = {k: f.launches for k, f in counted.items()}
        kern(p_k, m_k, data)
        torch.cuda.synchronize()
        res["launches_per_step"] = {k: f.launches - before[k]
                                    for k, f in counted.items()}
        res["traced"] = device_split(lambda: kern(p_k, m_k, data),
                                     FORECASTER_KERNELS + TRAIN_KERNELS)
        res.update({
            "host_ms": _host_ms(lambda: kern(p_k, m_k, data), iters),
            "event_ms": _time_ms(lambda: kern(p_k, m_k, data), iters,
                                 device_only=False),
            "plain_host_ms": _host_ms(lambda: plain(p_r, m_r, data), iters),
            "plain_event_ms": _time_ms(lambda: plain(p_r, m_r, data), iters,
                                       device_only=False)})
    return res


# -- 10. forecast path ------------------------------------------------------------


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


async def _forecast_run(device: torch.device, svc_kwargs: dict,
                        min_rounds: int, timeout_s: float,
                        forwards: list, trace=None,
                        rounds: list | None = None,
                        steps: list | None = None) -> dict:
    from chanamq_tpu_torch.broker.broker import Broker
    from chanamq_tpu_torch.broker.server import BrokerServer
    from chanamq_tpu_torch.client import AMQPClient
    from chanamq_tpu_torch.models.service import ForecastService

    broker = Broker(router_device=device.type)
    server = BrokerServer(broker, host="127.0.0.1", port=0, heartbeat_s=0)
    await server.start()
    svc = ForecastService(server.broker, device=device, **svc_kwargs)
    real_setup = svc._torch_setup
    training = svc.steps_per_round > 0

    def setup(params=None) -> dict:
        # the worker builds its state as always; its forward is wrapped to
        # keep each window, its forecast, the parameters it forwarded
        # (copied when training changes them) and its host-clock time, and
        # its train step to keep each step's host-clock time, synchronized
        state = real_setup(params)
        real_forward, real_step = state["forward"], state["step"]

        def recorded(window):
            t0 = time.perf_counter()
            pred = real_forward(window)
            forwards.append({
                "window": window, "pred": pred,
                "s": time.perf_counter() - t0, "state": state,
                "params": ({k: v.clone() for k, v in state["params"].items()}
                           if training else state["params"])})
            return pred

        def step(*args):
            t0 = time.perf_counter()
            out = real_step(*args)
            _synchronize(device)
            steps.append((t0, time.perf_counter()))
            return out

        state["forward"] = recorded
        if steps is not None:
            state["step"] = step
        return state

    svc._torch_setup = setup
    if rounds is not None:
        real_round = svc._round

        def timed_round(history):
            t0 = time.perf_counter()
            out = real_round(history)
            if out[2] is not None:  # a round that bailed is not counted
                rounds.append(time.perf_counter() - t0)
            return out

        svc._round = timed_round
    published = [0]
    stop = asyncio.Event()
    client = await AMQPClient.connect("127.0.0.1", server.bound_port,
                                      heartbeat=0)
    try:
        await svc.start()
        ch = await client.channel()
        await ch.queue_declare("forecast.q")
        received: list = []
        await ch.basic_consume("forecast.q", received.append, no_ack=True)

        async def load() -> None:
            while not stop.is_set():
                for _ in range(20):
                    ch.basic_publish(b"x" * 512, exchange="",
                                     routing_key="forecast.q")
                    published[0] += 1
                await asyncio.sleep(0.01)

        task = asyncio.get_event_loop().create_task(load())
        if trace is not None:
            trace.start()
        try:
            t0 = time.perf_counter()
            while svc.rounds < min_rounds:
                if time.perf_counter() - t0 > timeout_s:
                    raise AssertionError(
                        f"{svc.rounds} forecasts in {timeout_s} s; last "
                        f"error {svc.last_error}")
                await asyncio.sleep(0.05)
            t_end = time.perf_counter()
            run_s = t_end - t0
            stop.set()
            await task
        finally:
            if trace is not None:
                trace.stop()
        snap = svc.snapshot()
        history = svc.ring.history()
    finally:
        stop.set()
        await client.close()
        await svc.stop()
        # no round may still run when the launch counts are read
        await asyncio.to_thread(svc._executor.shutdown, wait=True)
        await server.stop()
    return {"snapshot": snap, "history": history, "run_s": run_s,
            "t_end": t_end,
            "published": published[0], "received": len(received),
            "feature_names": svc.feature_names}


def _ms_stats(seconds: list) -> dict:
    """The first apart, and the mean, median, p90, p99 and max of the
    rest, in ms."""
    ms = np.array(seconds[1:]) * 1e3
    return {"first": seconds[0] * 1e3, "n": len(ms), "mean": float(ms.mean()),
            "median": float(np.median(ms)),
            "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)), "max": float(ms.max())}


def phase_forecast(device: torch.device, *,
                   model_kwargs: dict | None = None, seq_len: int = 64,
                   interval_s: float = 0.02, train_interval_s: float = 0.03,
                   min_rounds: int = 200, timeout_s: float = 120.0,
                   steps_per_round: int = 0, batch: int = 16,
                   lr: float = 1e-3) -> dict:
    """The forecast path end to end: a ForecastService on ``device``
    (``steps_per_round`` train steps a round at ``batch`` and ``lr``; 0
    for none) beside the port's BrokerServer under a publishing load,
    until ``min_rounds`` forecasts. Checks that the forecasts are finite
    and non-negative, the losses finite, and that the sampler saw the
    load; every forward's window is replayed through the plain path, on
    the parameters it forwarded, within FORWARD_LIMIT. Returns the run's
    numbers with ``forwards`` and ``steps``, the counts of forwards and
    train steps made (each kernel's launches must be those times its
    launches a forward and a step), and the host-clock ms of each forward,
    and when training of each round and each step that ended in the
    window (synchronized): the first (the worker thread's first products)
    apart, and the mean, median, p90 and p99 of the rest. On a card the run is traced with
    ``torch.profiler`` for the device's busy time and each kernel's
    in-path launches and time."""
    from chanamq_tpu_torch.kernels.forecaster import PLAIN
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig, forward
    from chanamq_tpu_torch.models.telemetry import FEATURES

    if model_kwargs is None:  # the flagship width, ForecasterConfig()'s
        flagship = ForecasterConfig()
        model_kwargs = {k: getattr(flagship, k)
                        for k in ("d_model", "n_heads", "d_ff", "n_layers")}
    forwards: list = []
    rounds: list = []
    steps: list = []
    kwargs = {"interval_s": interval_s, "train_interval_s": train_interval_s,
              "seq_len": seq_len, "model_kwargs": model_kwargs,
              "steps_per_round": steps_per_round, "batch": batch, "lr": lr}
    trace = None
    if device.type == "cuda":
        trace = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    res = asyncio.run(_forecast_run(device, kwargs, min_rounds, timeout_s,
                                    forwards, trace, rounds, steps))
    snap = res["snapshot"]
    forecast = snap["forecast"]
    if snap["error"] is not None or not forecast:
        raise AssertionError(f"forecast path: error {snap['error']}")
    bad = {k: v for k, v in forecast.items()
           if not (np.isfinite(v) and v >= 0.0)}
    if bad:
        raise AssertionError(f"forecast path: bad forecasts {bad}")
    saw = float(res["history"][:, FEATURES.index("publish_rate")].max())
    if not saw > 0:
        raise AssertionError("the sampler saw no publish traffic")
    if steps_per_round and not (snap["loss"] is not None
                                and np.isfinite(snap["loss"])):
        raise AssertionError(f"forecast path: loss {snap['loss']}")
    worst = 0.0
    for fw in forwards:
        x = torch.from_numpy(fw["window"]).to(device)
        want = forward(fw["params"], x, fw["state"]["cfg"],
                       ops=PLAIN).cpu().numpy()
        if not np.isfinite(fw["pred"]).all():
            raise AssertionError("a forward gave non-finite values")
        worst = max(worst, float(np.abs(fw["pred"] - want).max()))
    if not worst <= FORWARD_LIMIT:
        raise AssertionError(f"forecast path: a forward differs from the "
                             f"plain path by {worst} (limit {FORWARD_LIMIT})")
    if len(forwards) < 2:
        raise AssertionError(f"forecast path: {len(forwards)} forwards")
    out = {"rounds": snap["rounds"], "forwards": len(forwards),
           "steps": len(steps), "trained_steps": snap["trained_steps"],
           "loss": snap["loss"], "samples": snap["samples"],
           "run_s": res["run_s"], "published": res["published"],
           "received": res["received"], "max_publish_rate": saw,
           "forecast": forecast, "replay_max_abs_err": worst,
           "cfg": forwards[0]["state"]["cfg"],
           "ms_first_forward": forwards[0]["s"] * 1e3,
           "ms_per_forward": {k: v for k, v in _ms_stats(
               [fw["s"] for fw in forwards]).items() if k != "first"},
           "trace": (device_busy(trace, FORECASTER_KERNELS + TRAIN_KERNELS)
                     if trace is not None else None)}
    if steps_per_round:
        if len(rounds) < 2 or len(steps) < 2:
            raise AssertionError(f"forecast path: {len(rounds)} trained "
                                 f"rounds, {len(steps)} steps")
        out["ms_per_round"] = _ms_stats(rounds)
        # steps that ended in the window: a round still running when the
        # window closes competes with the trace's processing
        out["ms_per_step"] = _ms_stats([b - a for a, b in steps
                                        if b <= res["t_end"]])
    return out


# -- 11. entry point -------------------------------------------------------------


# the service's defaults, and enough rounds for a median and a p99
STEPS_PER_ROUND = 20
TRAIN_ROUNDS = 20
# a long window on the service's compact default model (ForecastService's
# model_kwargs), past the limit the attention kernels once had at its head
# width of 16
WINDOW_T = 1024
WINDOW_MODEL = {"d_model": 64, "n_heads": 4, "d_ff": 256, "n_layers": 2}
WINDOW_ROUNDS = 3


def counted_wrappers() -> dict:
    """Every forecaster kernel wrapper with a launch count, by name."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.kernels import update as upd

    out = {name: getattr(fk, name)
           for name in FORECASTER_KERNELS + TRAIN_KERNELS[:3]}
    out["clip_momentum_sgd"] = upd.clip_momentum_sgd
    return out


def train_per_step(cfg) -> dict:
    """Each kernel's launches in one train step: the forward's (two
    layernorms, one attention and one GELU a layer), as many backward
    passes (attention's two launches each: row pass, then gradients), and
    the update's two (sum of squares, then update)."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    fwd = {"layernorm": 2 * cfg.n_layers, "causal_attention": cfg.n_layers,
           "gelu_tanh": cfg.n_layers}
    per_call = {"causal_attention": fk.ATT_BWD_LAUNCHES}
    return {**fwd, **{f"{k}_bwd": n * per_call.get(k, 1)
                      for k, n in fwd.items()},
            "clip_momentum_sgd": 2}


def log_train(train: dict, dev: dict) -> None:
    """The [train] line; raises unless a step launched each kernel as
    often as ``train_per_step`` says."""
    cfg = train["cfg"]
    worst = {}
    for step, trees in train["trees"].items():
        for kind in ("momentum", "params"):
            err, limit, name = max((v[kind][0] / max(v[kind][1], 1e-30),
                                    v[kind][1], n) for n, v in trees.items())
            worst[f"{kind} after {step}"] = (
                f"{name} {trees[name][kind][0]:.6g} (limit {limit:.6g})")
    want = train_per_step(cfg)
    got = train.get("launches_per_step")
    log(f"[train] {len(train['losses'])} steps at d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, batch {train['batch']}: losses through the "
        f"kernels {[round(v, 6) for v in train['losses']]}, through the plain "
        f"versions {[round(v, 6) for v in train['plain_losses']]}; closest "
        f"to its limit, kernels against plain: {worst}; one step "
        f"{train.get('host_ms', float('nan')):.4f} ms host clock, "
        f"{train.get('event_ms', float('nan')):.4f} ms CUDA events (plain "
        f"{train.get('plain_host_ms', float('nan')):.4f} / "
        f"{train.get('plain_event_ms', float('nan')):.4f} ms); launches a "
        f"step {got}; one step traced on the card: {train.get('traced')}; "
        f"card {dev['smi']}")
    for step, trees in train["trees"].items():
        log(f"[train-trees] after step {step}, max abs difference (limit) "
            "of each tree, momentum | parameters: " + "; ".join(
                f"{n} {t['momentum'][0]:.3g} ({t['momentum'][1]:.3g}) | "
                f"{t['params'][0]:.3g} ({t['params'][1]:.3g})"
                for n, t in trees.items()))
    if got != want:
        raise AssertionError(f"train: launches a step {got}, want {want}")


def log_trace(tag: str, res: dict) -> None:
    tr = res["trace"]
    window_us = res["run_s"] * 1e6
    if tr["events"]:
        traced = {k: {"launches": v["launches"],
                      "mean_us": v["us"] / max(1, v["launches"])}
                  for k, v in tr["kernels"].items()}
        log(f"[{tag}] window {window_us:.0f} us: {tr['events']} device "
            f"events, busy {tr['busy_us']:.1f} us = "
            f"{100 * tr['busy_us'] / window_us:.4f}%, idle "
            f"{100 * (1 - tr['busy_us'] / window_us):.4f}%; forecaster "
            f"kernels {traced}")
    else:
        log(f"[{tag}] the profiler saw no device event: device busy time "
            "and idle share not measured")


# -- 13. sharded train step -------------------------------------------------------


SHARDED_STEPS = 5
SHARDED_LR = 1e-3
# (b): tensor-parallel ranks sharing one card, over gloo
SHARDED_TP = 4
# the sharded step's loss within one bf16 step (2^-8 relative) of the
# one-device step's: tp ranks round a row-split product's partial sums
# once more (tests/test_torch_parallel.py)
SHARDED_LOSS_RTOL = 2.0 ** -8
SHARDED_KERNELS = FORECASTER_KERNELS + TRAIN_KERNELS[:3] + (
    "sum_of_squares", "momentum_sgd")


def sharded_per_step(cfg) -> dict:
    """Each kernel's launches in one sharded step: a one-device step's
    forward and backward, and the update as two sums of squares (sharded
    and replicated leaves) and one update."""
    per = train_per_step(cfg)
    del per["clip_momentum_sgd"]
    return {**per, "sum_of_squares": 2, "momentum_sgd": 1}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(target, world: int, args: tuple, *, start: str = "spawn",
                  preload: tuple = (), timeout_s: float = 300.0) -> list:
    """``target(rank, *args, results)`` in ``world`` processes made by the
    ``start`` method (``preload``: the modules a forkserver imports
    first); each puts ``(rank, result)`` on ``results``. Returns the
    results by rank; raises if a process exits non-zero or the lot has
    not reported and exited within ``timeout_s``, and kills what still
    runs."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context(start)
    if preload:
        ctx.set_forkserver_preload(list(preload))
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead or time.monotonic() > deadline:
                raise AssertionError(f"ranks failed (exit codes {dead}) or "
                                     f"did not report in {timeout_s} s")
            try:
                rank, result = results.get(timeout=0.5)
                got[rank] = result
            except queue.Empty:
                pass
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise AssertionError(f"a rank did not exit cleanly: exit "
                                     f"code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


# the forecaster wrappers a train step's forward and backward call (in
# training the forward attention keeps its row statistics)
STEP_WRAPPERS = ("layernorm", "causal_attention_with_stats", "gelu_tanh",
                 "layernorm_bwd", "causal_attention_bwd", "gelu_tanh_bwd")


def _copied(args) -> tuple:
    """``args`` with every tensor, also in a list, copied."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return [one(x) for x in a]
        return a
    return tuple(one(a) for a in args)


def _keeping(fn, calls: list):
    """``fn`` that also keeps a copy of every call's arguments in
    ``calls``, made before the call (the update and the attention
    backward write into their inputs)."""
    def wrapper(*args):
        calls.append(_copied(args))
        return fn(*args)
    return wrapper


@contextlib.contextmanager
def keeping_step_wrappers(calls: dict):
    """While it is open, every ``STEP_WRAPPERS`` call that the autograd
    Functions make (they look the wrappers up on ``kernels/forecaster``'s
    module names) also keeps a copy of its arguments in
    ``calls[name]``. A wrapper counts its launches on the module's name
    for it, so the stand-in carries the count and hands it back."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    real = {name: getattr(fk, name) for name in STEP_WRAPPERS}
    stand_in = {name: _keeping(fn, calls.setdefault(name, []))
                for name, fn in real.items()}
    for name, fn in real.items():
        if hasattr(fn, "launches"):
            stand_in[name].launches = fn.launches
        setattr(fk, name, stand_in[name])
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(fk, name, fn)
            if hasattr(fn, "launches"):
                fn.launches = stand_in[name].launches


def hold_step_call(wrapper: str, args) -> dict:
    """One recorded train-step kernel call through its wrapper and its
    plain version on the same inputs, at the limits of the kernel's own
    phase ([fc-kernels], [fc-train-kernels]); the split update's sum of
    squares within ``SCALE_RTOL`` of the plain sum, its update as
    ``hold_train_kernel`` holds the whole one: the scale within
    ``SCALE_RTOL``, and at the kernel's scale every value bit for bit."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.kernels import update as upd

    if wrapper in FORECASTER_KERNELS:
        return hold_forecaster(wrapper, args, timed=False)
    if wrapper == "causal_attention_with_stats":
        return hold_forecaster(
            "causal_attention", args, timed=False,
            kern=lambda qkv, heads: fk.causal_attention_with_stats(
                qkv, heads)[0])
    if wrapper in TRAIN_KERNELS:
        return hold_train_kernel(wrapper, args, timed=False)
    if wrapper == "sum_of_squares":
        grads, out = args
        got = float(upd.sum_of_squares(grads, torch.empty_like(out)))
        want = float(upd.sum_of_squares_ref(grads))
        err, limit = abs(got - want), SCALE_RTOL * want
        shape = f"{len(grads)} tensors, {sum(g.numel() for g in grads)} values"
        if not err <= limit:
            raise AssertionError(f"sum_of_squares [{shape}]: {got}, plain "
                                 f"{want}")
        return {"shape": shape, "max_abs_err": err, "limit": limit}
    params, momentum, grads, lr, sq, clip = args
    shape = f"{len(params)} tensors, {sum(p.numel() for p in params)} values"
    p_k, m_k = _copied((params, momentum))
    s_k = upd.momentum_sgd(p_k, m_k, grads, lr, sq, clip)
    s_r = upd.momentum_sgd_ref(*_copied((params, momentum)), grads, lr, sq,
                               clip)
    p_r, m_r = _copied((params, momentum))
    upd.momentum_sgd_ref(p_r, m_r, grads, lr, sq, clip, scale=s_k)
    err = max(_max_err(a, b) for a, b in zip(p_k + m_k, p_r + m_r))
    s_err = abs(float(s_k) - float(s_r)) / float(s_r)
    if err != 0.0 or not s_err <= SCALE_RTOL:
        raise AssertionError(f"momentum_sgd [{shape}]: differs by {err} at "
                             f"the kernel's scale, scale {float(s_k)} vs "
                             f"{float(s_r)}")
    return {"shape": shape, "max_abs_err": err, "limit": 0.0,
            "scale_rel_err": s_err}


def hold_step_calls(calls: dict) -> dict:
    """Every recorded call (``{wrapper: [args, ...]}``) held by
    ``hold_step_call``; by kernel name, its calls, their shapes and the
    largest error and ratio of error to limit."""
    out: dict = {}
    for wrapper, recorded in calls.items():
        name = ("causal_attention" if wrapper == "causal_attention_with_stats"
                else wrapper)
        row = out.setdefault(name, {"calls": 0, "shapes": {},
                                    "max_abs_err": 0.0, "of_limit": 0.0})
        for args in recorded:
            r = hold_step_call(wrapper, args)
            row["calls"] += 1
            row["shapes"][r["shape"]] = row["shapes"].get(r["shape"], 0) + 1
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            if r["limit"]:
                row["of_limit"] = max(row["of_limit"],
                                      r["max_abs_err"] / r["limit"])
    return out


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def sharded_rank(rank: int, world: int, tp: int | None, init: str,
                 backend: str, devices: list, seed: int, batch: int,
                 steps: int, cfg_kwargs: dict | None = None,
                 results=None) -> dict:
    """Rank ``rank`` (on ``devices[rank]``) of ``make_sharded_train_step``
    from ``init_params(seed, cfg)`` on ``synthetic_batch`` (the [train]
    state): ``steps`` steps, each rank's losses, launches and leaf
    digests; on rank 0 also the one-device kernel step from the same state
    on the same card, and after each step the gathered trees held to
    ``tree_limits`` (kept at step 1 and the last). The first step goes
    through the same wrappers with each kernel call's inputs kept, and
    every kept call is replayed by ``hold_step_calls`` after the run. On a
    card also the host-clock ms a step and one traced step's device split.
    Puts ``(rank, result)`` on ``results`` if given (a rank of its own
    process, which then runs torch on one host thread: its host work is
    launches, and ranks sharing a host must not crowd each other out)."""
    import torch.distributed as dist

    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.kernels import update as upd
    from chanamq_tpu_torch.models.forecaster import (
        ForecasterConfig, init_momentum, init_params, make_train_step,
        set_matmul_precision, synthetic_batch)
    from chanamq_tpu_torch.parallel import mesh as pm

    dev = torch.device(devices[rank])
    if results is not None:
        torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        set_matmul_precision()
    cfg = ForecasterConfig(**(cfg_kwargs or {}))
    full = init_params(seed, cfg, dev)
    data = synthetic_batch(np.random.default_rng(seed), cfg, batch, dev)
    one = []
    if rank == 0:
        p1 = {k: v.clone() for k, v in full.items()}
        m1 = init_momentum(p1)
        step1 = make_train_step(cfg, lr=SHARDED_LR)
        for _ in range(steps):
            _, _, loss = step1(p1, m1, data)
            one.append((float(loss), {k: v.clone() for k, v in p1.items()},
                        {k: v.clone() for k, v in m1.items()}))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        mesh = pm.make_mesh(world, tp, backend=backend, device=dev)
        params, part = pm.place(mesh, full, data)
        momentum = pm.place_params(mesh, init_momentum(full))
        step = pm.make_sharded_train_step(mesh, cfg, lr=SHARDED_LR)
        # the first step: the same step through the same wrappers, each
        # call's inputs kept (the update's through its ops, the forward's
        # and backward's where the autograd Functions look them up)
        calls: dict = {}
        kept = pm.make_sharded_train_step(
            mesh, cfg, lr=SHARDED_LR, ops=fk.KERNELS._replace(**{
                name: _keeping(getattr(upd, name),
                               calls.setdefault(name, []))
                for name in ("sum_of_squares", "momentum_sgd")}))

        counted = {**counted_wrappers(), "sum_of_squares": upd.sum_of_squares,
                   "momentum_sgd": upd.momentum_sgd}
        for wrapper in counted.values():
            wrapper.launches = 0
        losses, seconds, checked, dm_sum = [], [], {}, {}
        for n in range(1, steps + 1):
            t0 = time.perf_counter()
            if n == 1:
                with keeping_step_wrappers(calls):
                    _, _, loss = kept(params, momentum, part)
            else:
                _, _, loss = step(params, momentum, part)
            losses.append(float(loss))  # waits for the step
            seconds.append(time.perf_counter() - t0)
            got_p = pm.gather_params(mesh, params)
            got_m = pm.gather_params(mesh, momentum)
            if one:
                trees = tree_limits(got_p, one[n - 1][1], got_m,
                                    one[n - 1][2], SHARDED_LR, dm_sum, n)
                if n in (1, steps):
                    checked[n] = trees
        out = {"rank": rank, "device": str(dev), "shape": mesh.shape,
               "tp_index": mesh.tp_index,
               "losses": losses, "one_device_losses": [o[0] for o in one],
               "trees": checked,
               "launches": {k: w.launches for k, w in counted.items()},
               "digests": {k: _digest(v) for k, v in params.items()},
               "step_ms": _ms_stats(seconds)}
        if dev.type == "cuda":
            out["host_ms"] = _host_ms(lambda: step(params, momentum, part), 5)
            out["traced"] = device_split(
                lambda: step(params, momentum, part), SHARDED_KERNELS)
            # where a step's host time goes: the ops of most host time in
            # one step, and one tp all-reduce of an activation alone
            out["host_ops"] = host_ops(lambda: step(params, momentum, part))
            act = torch.ones(batch // mesh.dp * cfg.seq_len, cfg.d_model,
                             device=dev)
            out["all_reduce_us"] = 1e3 * _host_ms(
                lambda: dist.all_reduce(act, group=mesh.tp_group), 20)
            if one:
                out["one_device_host_ops"] = host_ops(
                    lambda: step1(p1, m1, data))
    finally:
        dist.destroy_process_group()
    # after the counts were read: these launches are not the path's
    out["replay"] = hold_step_calls(calls)
    if results is not None:
        results.put((rank, out))
    return out


def host_ops(fn, top: int = 8) -> list:
    """The ``top`` ops of most host time (self, µs) in one synchronized
    call of ``fn``, traced on the CPU: ``[(name, calls, us), ...]``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [(e.key, e.count, round(e.self_cpu_time_total, 1))
            for e in rows[:top]]


def run_ranks(world: int, tp: int | None, backend: str, devices: list,
              seed: int, batch: int, steps: int,
              cfg_kwargs: dict | None = None,
              timeout_s: float = 300.0) -> list:
    """``sharded_rank`` on ``world`` ranks (``tp`` of them a tensor-
    parallel group; None: the reference's rule), rank r on ``devices[r]``: in
    this process for one rank, else in spawned processes
    (``run_processes``). The results by rank."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    args = (world, tp, init, backend, devices, seed, batch, steps, cfg_kwargs)
    if world == 1:
        return [sharded_rank(0, *args)]
    return run_processes(sharded_rank, world, args, timeout_s=timeout_s)


def check_sharded(label: str, ranks: list, cfg, steps: int) -> dict:
    """Hold one run's ranks: the loss bit for bit on every rank, finite,
    falling, and within ``SHARDED_LOSS_RTOL`` of the one-device step at
    step 1 and the last (at step 1 equal to it on a mesh of one rank);
    rank 0's gathered trees within ``tree_limits``;
    every replicated leaf bit-equal on all ranks and every shard on its dp
    replicas; each kernel launched ``sharded_per_step`` times a step, and
    each rank's first step replayed call by call (``hold_step_calls``,
    which raised on an error over its limit), every kernel as often as a
    step calls it. Returns the worst tree and loss errors."""
    from chanamq_tpu_torch.kernels import forecaster as fk
    from chanamq_tpu_torch.parallel.mesh import _spec_for

    first = ranks[0]
    losses = first["losses"]
    if any(r["losses"] != losses for r in ranks):
        raise AssertionError(f"{label}: the ranks' losses differ")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses} not finite and "
                             "falling")
    loss_err = {}
    for n in (1, steps):
        got, want = losses[n - 1], first["one_device_losses"][n - 1]
        loss_err[n] = abs(got - want) / abs(want)
        if not loss_err[n] <= SHARDED_LOSS_RTOL:
            raise AssertionError(f"{label}: loss after {n} steps {got}, "
                                 f"one-device {want}")
    if len(ranks) == 1 and loss_err[1] != 0.0:
        # one rank sums nothing across ranks: its first forward is the
        # one-device step's, bit for bit
        raise AssertionError(f"{label}: one rank's first loss differs")
    worst = {}
    for n, trees in first["trees"].items():
        for kind in ("momentum", "params"):
            ratio, name = max((v[kind][0] / max(v[kind][1], 1e-30), k)
                              for k, v in trees.items())
            worst[f"{kind} after {n}"] = (name, trees[name][kind])
            if not ratio <= 1.0:
                raise AssertionError(f"{label}: {name} {kind} after {n} "
                                     f"steps {trees[name][kind]} over its "
                                     "limit")
    for r in ranks:
        for name, digest in r["digests"].items():
            peers = [q for q in ranks if not _spec_for(name)
                     or q["tp_index"] == r["tp_index"]]
            if any(q["digests"][name] != digest for q in peers):
                raise AssertionError(f"{label}: {name} differs between "
                                     "ranks that must hold the same bits")
    per_call = {"causal_attention_bwd": fk.ATT_BWD_LAUNCHES}
    calls = {k: v // per_call.get(k, 1)
             for k, v in sharded_per_step(cfg).items()}
    for r in ranks:
        got = {k: v["calls"] for k, v in r["replay"].items()}
        if got != calls:
            raise AssertionError(f"{label}: rank {r['rank']} replayed "
                                 f"{got}, want {calls}")
    want = {k: v * steps for k, v in sharded_per_step(cfg).items()}
    for r in ranks:
        if not r["device"].startswith("cuda"):
            continue  # the plain versions run on the CPU: no launch
        got = {k: r["launches"][k] for k in want}
        if got != want or any(r["launches"][k] for k in r["launches"]
                              if k not in want):
            raise AssertionError(f"{label}: rank {r['rank']} launches "
                                 f"{r['launches']}, want {want}")
    return {"loss_rel_err": loss_err, "worst_trees": worst}


def phase_sharded_train(runs: list, seed: int, cfg_kwargs: dict | None = None,
                        batch: int = 16, steps: int = SHARDED_STEPS) -> dict:
    """``make_sharded_train_step`` at ``cfg_kwargs`` (the flagship by
    default) from the [train] state, one run per ``(label, backend,
    devices, tp)`` of ``runs`` (one rank a device; ``tp`` None: the
    reference's rule), each held by ``check_sharded``."""
    from chanamq_tpu_torch.models.forecaster import ForecasterConfig

    cfg = ForecasterConfig(**(cfg_kwargs or {}))
    out = {}
    for label, backend, devices, tp in runs:
        t0 = time.perf_counter()
        ranks = run_ranks(len(devices), tp, backend, devices, seed, batch,
                          steps, cfg_kwargs)
        out[label] = {"ranks": ranks, "seconds": time.perf_counter() - t0,
                      "batch": batch,
                      **check_sharded(label, ranks, cfg, steps)}
    return out


def log_sharded(res: dict, dev: dict) -> None:
    for label, run in res.items():
        r0 = run["ranks"][0]
        per_rank = [{"rank": r["rank"],
                     "host_ms": r.get("host_ms"),
                     "step_ms": r["step_ms"]["median"] if r["step_ms"]["n"]
                     else r["step_ms"]["first"],
                     "all_reduce_us": r.get("all_reduce_us"),
                     "traced": r.get("traced")} for r in run["ranks"]]
        for name in r0["replay"]:
            rows = [r["replay"][name] for r in run["ranks"]]
            shapes = sorted({s for row in rows for s in row["shapes"]})
            log(f"[sharded-replay] {label}: {name}: {rows[0]['calls']} calls "
                f"of the first step on each of {len(rows)} ranks replayed "
                f"against the plain version at shapes {shapes}; largest "
                f"error {max(row['max_abs_err'] for row in rows):.6g}, "
                f"{max(row['of_limit'] for row in rows):.4g} of its limit")
        log(f"[sharded-train] {label}: mesh {r0['shape']}, "
            f"{len(run['ranks'])} ranks, {len(r0['losses'])} steps at "
            f"batch {run['batch']}; losses {[round(v, 6) for v in r0['losses']]}, "
            f"one-device {[round(v, 6) for v in r0['one_device_losses']]}, "
            f"relative loss error {run['loss_rel_err']}; closest to its "
            f"limit {run['worst_trees']}; launches a rank {r0['launches']}; "
            f"replicated leaves bit-equal on every rank; per rank (host-"
            f"clock ms a step, median of the checked steps, one traced step "
            f"on the card, host-clock us of one tp all-reduce of a "
            f"[B*T, d_model] float32 activation) {per_rank}; rank 0's ops "
            f"of most host time (name, calls, self us) in a sharded step "
            f"{r0.get('host_ops')}, in a one-device step "
            f"{r0.get('one_device_host_ops')}; phase {run['seconds']:.1f} s; "
            f"card {dev['smi']}")


# -- 14. durable node ---------------------------------------------------------------


# persistent messages through a durable port node at the WAL's defaults;
# the same topic : headers mix and tables as the main path
DURABLE_TOPIC = 33_336
DURABLE_HEADERS = 16_664


def durable_node(port: int, db: str, device: str, state: str,
                 make_server=None) -> None:
    """A port node from ``BrokerServer.from_config`` on 127.0.0.1:``port``
    with its store at ``db`` and every ``chana.mq.wal.*`` key at its
    default (fsync, flush-ms 2), its router on ``device``; serves until
    killed (``make_server(settings)``, given, builds the server from the
    same settings instead). It writes JSON files into the directory
    ``state``:
    ``ready.json`` once it listens (records its WAL replayed, seconds to
    start, its store's classes); after SIGUSR1 a ``torch.profiler`` trace
    of the card runs (``tracing.json``), and SIGUSR2 stops it
    (``trace.json``: the card's busy time and the router kernels, the
    WAL's commits and their µs, the router's batches)."""
    import signal

    t0 = time.perf_counter()
    settings = {"amqp.interface": "127.0.0.1", "amqp.port": port,
                "store.path": db, "router.device": device}
    if make_server is None:
        from chanamq_tpu_torch.broker.server import BrokerServer
        from chanamq_tpu_torch.config import Config

        server = BrokerServer.from_config(Config(settings, env={}))
    else:
        server = make_server(settings)
    store = server.broker.store
    trace = None
    if device.startswith("cuda"):
        trace = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def dump(name: str, obj) -> None:
        path = os.path.join(state, name)
        with open(path + ".tmp", "w") as f:
            json.dump(obj, f)
        os.replace(path + ".tmp", path)

    def start_trace() -> None:
        if trace is not None:
            trace.start()
        dump("tracing.json", {})

    def stop_trace() -> None:
        if trace is not None:
            trace.stop()
        m, bm = store.metrics, server.broker.metrics
        dump("trace.json", {
            "trace": device_busy(trace) if trace is not None else None,
            "wal": {"commits": m.wal_commits, "fsyncs": m.wal_fsyncs,
                    "appends": m.wal_appends,
                    "commit_us_mean": m.wal_commit_us.mean_us,
                    "commit_us_p50": m.wal_commit_us.percentile_us(0.5),
                    "commit_us_p99": m.wal_commit_us.percentile_us(0.99),
                    "commit_errors": m.wal_commit_errors},
            "router": {"batches": bm.router_batches,
                       "batch_msgs": bm.router_batch_msgs,
                       "fallback_msgs": bm.router_fallback_msgs}})

    async def run() -> None:
        loop = asyncio.get_running_loop()
        loop.add_signal_handler(signal.SIGUSR1, start_trace)
        loop.add_signal_handler(signal.SIGUSR2, stop_trace)
        await server.start()
        dump("ready.json", {
            "recovered_records": store.recovered_records,
            "start_s": time.perf_counter() - t0,
            "store": type(store).__name__,
            "inner": type(store._inner).__name__})
        await asyncio.Event().wait()

    asyncio.run(run())


async def _wait_file(path: str, proc, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"durable node exited ({proc.returncode})")
        if time.monotonic() > deadline:
            raise AssertionError(f"durable node: no {os.path.basename(path)}"
                                 f" in {timeout_s} s")
        await asyncio.sleep(0.01)
    with open(path) as f:
        return json.load(f)


def _start_node(port: int, db: str, device: str, state: str):
    os.makedirs(state)
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--durable-node",
         str(port), db, device, state], cwd=here)


async def _durable_run(wl: Workload, device: str, tmp: str, window: int,
                       node_timeout_s: float, start_node=None) -> dict:
    import signal

    from chanamq_tpu_torch.client import AMQPClient

    start_node = start_node or _start_node
    db = os.path.join(tmp, "node.db")
    port = _free_port()
    nodes = []
    try:
        nodes.append(start_node(port, db, device, os.path.join(tmp, "a")))
        ready = await _wait_file(os.path.join(tmp, "a", "ready.json"),
                                 nodes[0], node_timeout_s)
        if (ready["store"], ready["inner"]) != ("WalStore", "SqliteStore"):
            raise AssertionError(f"durable node store {ready}")
        setup = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
        ch = await setup.channel()
        await ch.exchange_declare("durable.topic", "topic", durable=True)
        await ch.exchange_declare("durable.headers", "headers", durable=True)
        for q in wl.queues:
            await ch.queue_declare(q, durable=True)
        for pat, q in wl.topic_bindings:
            await ch.queue_bind(q, "durable.topic", pat)
        for q, args in wl.headers_bindings:
            await ch.queue_bind(q, "durable.headers", "", arguments=args)
        await setup.close()

        async def publish(p: int) -> None:
            c = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
            await _publish_stream(c, wl, p, "durable", window,
                                  persistent=True)
            await c.close()

        nodes[0].send_signal(signal.SIGUSR1)
        await _wait_file(os.path.join(tmp, "a", "tracing.json"), nodes[0],
                         node_timeout_s)
        t0 = time.perf_counter()
        await asyncio.gather(*(publish(p) for p in range(wl.publishers)))
        publish_s = time.perf_counter() - t0
        nodes[0].send_signal(signal.SIGUSR2)
        traced = await _wait_file(os.path.join(tmp, "a", "trace.json"),
                                  nodes[0], node_timeout_s)
        # every message is confirmed: now the crash
        nodes[0].send_signal(signal.SIGKILL)
        nodes[0].wait(timeout=30)

        t_restart = time.perf_counter()
        nodes.append(start_node(port, db, device, os.path.join(tmp, "b")))
        ready_b = await _wait_file(os.path.join(tmp, "b", "ready.json"),
                                   nodes[1], node_timeout_s)
        ready_s = time.perf_counter() - t_restart
        busy = [q for q in wl.queues if wl.expected[q]]
        want_total = sum(len(wl.expected[q]) for q in busy)
        got: dict = {q: [] for q in busy}
        first = []
        count = [0]
        done = asyncio.Event()
        cons = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
        cch = await cons.channel()
        for q in busy:
            def cb(msg, _q=q) -> None:
                if not first:
                    first.append(time.perf_counter())
                got[_q].append(msg)
                count[0] += 1
                if count[0] >= want_total:
                    done.set()
            await cch.basic_consume(q, cb, no_ack=True)
        await asyncio.wait_for(done.wait(), timeout=300)
        await asyncio.sleep(0.5)  # a duplicate would arrive now
        drained_s = time.perf_counter() - t_restart
        idle = [q for q in wl.queues if not wl.expected[q]]
        stray = 0
        for q in idle:
            ok = await cch.queue_declare(q, durable=True, passive=True)
            stray += ok.message_count
        await cons.close()
    finally:
        for proc in nodes:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)

    return {"publish_s": publish_s,
            "msgs_per_s": wl.n_messages / publish_s,
            **hold_deliveries(wl, got),
            "expected_deliveries": want_total, "stray": stray,
            "restart_to_ready_s": ready_s,
            "restart_to_first_delivery_s": first[0] - t_restart,
            "restart_to_drained_s": drained_s,
            "node_start_s": ready_b["start_s"],
            "recovered_records": ready_b["recovered_records"],
            "first_start_recovered": ready["recovered_records"],
            "traced": traced}


def phase_durable(device: torch.device, seed: int, *, window: int = 2048,
                  node_timeout_s: float = 120.0, n_topic: int = DURABLE_TOPIC,
                  n_headers: int = DURABLE_HEADERS, start_node=None,
                  **sizes) -> dict:
    """A durable port node in a child process (``durable_node``: WAL
    defaults, router on ``device``) takes the main path's tables, all
    durable, and 4 confirming publishers' persistent 256 B messages; after
    the last confirm it is SIGKILLed and a new node starts from the same
    directory; every queue is consumed and held to the host oracle: every
    confirmed message in every queue it was routed to, exactly once, in
    publish order per publisher, with its body; no message in a queue
    that was routed none. ``start_node(port, db, device, state)``, given,
    starts each node's process instead of ``_start_node``."""
    import tempfile

    t0 = time.perf_counter()
    wl = Workload(seed, n_topic=n_topic, n_headers=n_headers, **sizes)
    built_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        res = asyncio.run(_durable_run(wl, str(device), tmp, window,
                                       node_timeout_s, start_node))
    res.update({"messages": wl.n_messages, "mean_fanout": wl.mean_fanout,
                "queues": len(wl.queues), "workload_s": built_s})
    bad = {k: res[k] for k in ("lost", "duplicated", "reordered_streams",
                               "altered", "stray") if res[k]}
    if bad or res["deliveries"] != res["expected_deliveries"]:
        raise AssertionError(f"durable: {bad}, {res['deliveries']} "
                             f"deliveries of {res['expected_deliveries']}")
    if res["recovered_records"] <= 0:
        raise AssertionError("durable: the restarted node replayed no WAL "
                             "record")
    return res


def log_durable(res: dict, dev: dict) -> None:
    tr = res["traced"]
    busy = tr["trace"]
    window_us = res["publish_s"] * 1e6
    card = (f"busy {busy['busy_us']:.1f} us = "
            f"{100 * busy['busy_us'] / window_us:.4f}% of the publish "
            f"window ({busy['events']} device events; router kernels "
            f"{busy['kernels']})" if busy and busy["events"] else
            "busy time not measured (no device event traced)")
    log(f"[durable] {res['messages']} persistent messages of 256 B, 4 "
        f"publishers with confirms, {res['queues']} durable queues, mean "
        f"fan-out {res['mean_fanout']:.3f}, WAL at its defaults (fsync, "
        f"flush-ms 2): {res['msgs_per_s']:.1f} confirmed msg/s "
        f"({res['publish_s']:.3f} s, host clock); the card {card}; WAL "
        f"{tr['wal']}; router {tr['router']}; SIGKILL after the last "
        f"confirm, restart: {res['recovered_records']} records replayed, "
        f"node listening {res['restart_to_ready_s']:.3f} s after its "
        f"process started ({res['node_start_s']:.3f} s of it from its "
        f"config to listening, replay included), first delivery "
        f"{res['restart_to_first_delivery_s']:.3f} s after the restart, "
        f"all {res['deliveries']} deliveries in "
        f"{res['restart_to_drained_s']:.3f} s; lost {res['lost']}, "
        f"duplicated {res['duplicated']}, reordered streams "
        f"{res['reordered_streams']}, altered {res['altered']}; card "
        f"{dev['smi']}")


# -- 15. the node through its entry point -------------------------------------------

# the [durable] phase's 50,000 messages at the main path's topic : headers mix
NODE_TOPIC, NODE_HEADERS = DURABLE_TOPIC, DURABLE_HEADERS
# the only keys the [node] phase moves from their defaults besides turning
# the layers on and naming the node's device: cadences short enough
# that the forecaster trains and forecasts several rounds inside the phase
# (defaults 1 s, 30 s and 1 s)
NODE_CADENCE = {"chana.mq.forecast.interval": "100ms",
                "chana.mq.forecast.train-interval": "2s",
                "chana.mq.telemetry.interval": "250ms"}
NODE_ROUNDS = 3
NODE_KERNELS = ("topic_match", "headers_match") + FORECASTER_KERNELS \
    + TRAIN_KERNELS[:3] + ("sum_of_squares", "momentum_sgd")


def node_config(device: str) -> dict:
    """The [node] phase's config file: admin, telemetry, SLOs, control
    (dry-run, its default) and the forecaster on, the node's device (the
    router's and the forecaster's) ``device``, ``NODE_CADENCE``; every
    other key at its default."""
    return {"chana.mq.admin.enabled": True,
            "chana.mq.telemetry.enabled": True,
            "chana.mq.slo.enabled": True,
            "chana.mq.control.enabled": True,
            "chana.mq.forecast.enabled": True,
            "chana.mq.router.device": device, **NODE_CADENCE}


def step_calls(cfg) -> dict:
    """Each wrapper's calls in one one-device train step, by the names
    ``hold_step_calls`` reports: ``train_per_step``'s launches with
    attention's backward as one call, and the update as one sum of
    squares and one update."""
    from chanamq_tpu_torch.kernels import forecaster as fk

    per = train_per_step(cfg)
    del per["clip_momentum_sgd"]
    per["causal_attention_bwd"] //= fk.ATT_BWD_LAUNCHES
    return {**per, "sum_of_squares": 1, "momentum_sgd": 1}


def node_child(out: str, argv: list) -> None:
    """The [node] phase's node process: the port's ``main()`` unchanged on
    ``argv``, as ``chanamq-server-torch`` runs it. Around it, the
    ``ForecastService`` that ``main`` builds is kept (its ``start`` is
    wrapped) with every forward's window, forecast and parameters, and
    the update's two launches are counted under their split names (the
    prepared launches are wrapped, as ``_recording`` wraps calls). The
    first ``steps_per_round`` train steps (the first trained round) keep
    every kernel call's inputs, copied before the call: the forward's and
    backward's through ``keeping_step_wrappers``, the update's two
    launches where they launch. After ``main()`` returns, the JSON file
    ``out`` gets every kernel wrapper's launch count, each forecast, the
    last one included, replayed through the plain path on the parameters
    that made it, and every kept call replayed against its plain version
    by ``hold_step_calls`` (after the counts were read)."""
    from chanamq_tpu_torch.broker import server
    from chanamq_tpu_torch.kernels import router_match as rm
    from chanamq_tpu_torch.kernels import update as upd
    from chanamq_tpu_torch.kernels.forecaster import PLAIN
    from chanamq_tpu_torch.models.forecaster import forward
    from chanamq_tpu_torch.models.service import ForecastService

    kept: list = []
    forwards: list = []
    split = {"sum_of_squares": 0, "momentum_sgd": 0}
    calls: dict = {}  # the first trained round's kernel calls
    keep = {"on": False, "steps": 0, "cfg": None}

    def counting(launch, name: str, args: tuple):
        def run():
            if keep["on"]:
                calls.setdefault(name, []).append(_copied(args))
            launch()
            split[name] += 1
        return run

    real_sumsq = upd.prepare_sum_of_squares
    real_msgd = upd.prepare_momentum_sgd
    upd.prepare_sum_of_squares = lambda *a, **k: counting(
        real_sumsq(*a, **k), "sum_of_squares", a)

    def prepare_msgd(*a, **k):
        scale, launch = real_msgd(*a, **k)
        return scale, counting(launch, "momentum_sgd", a)

    upd.prepare_momentum_sgd = prepare_msgd
    real_start = ForecastService.start

    async def start(svc) -> None:
        kept.append(svc)
        real_setup = svc._torch_setup

        def setup(params=None) -> dict:
            state = real_setup(params)
            real_forward, real_step = state["forward"], state["step"]
            keep["cfg"] = state["cfg"]

            def recorded(window):
                pred = real_forward(window)
                forwards.append((window, pred, state["cfg"], {
                    k: v.clone() for k, v in state["params"].items()}))
                return pred

            def step(params, momentum, batch):
                if keep["steps"] >= svc.steps_per_round:
                    return real_step(params, momentum, batch)
                keep["steps"] += 1
                keep["on"] = True
                try:
                    with keeping_step_wrappers(calls):
                        return real_step(params, momentum, batch)
                finally:
                    keep["on"] = False

            state.update(forward=recorded, step=step)
            return state

        svc._torch_setup = setup
        await real_start(svc)

    ForecastService.start = start
    sys.argv = ["chanamq-server-torch", *argv]
    server.main()
    res: dict = {"services": len(kept), "main_returned": time.time()}
    if kept:
        svc = kept[0]
        # no round may still run when the counts are read
        svc._executor.shutdown(wait=True)
        res.update(snapshot=svc.snapshot(),
                   steps_per_round=svc.steps_per_round)
    counted = counted_wrappers()
    res["launches"] = {name: w.launches for name, w in counted.items()}
    res["launches"].update(topic_match=rm.topic_match.launches,
                           headers_match=rm.headers_match.launches, **split)
    errs = []
    for window, pred, cfg, params in forwards:
        device = next(iter(params.values())).device
        want = forward(params, torch.from_numpy(window).to(device), cfg,
                       ops=PLAIN).cpu().numpy()
        errs.append(float(np.abs(pred - want).max()))
    if forwards:
        res.update(forwards=len(forwards),
                   pred_finite=bool(np.isfinite(forwards[-1][1]).all()),
                   replay_last_abs_err=errs[-1],
                   replay_max_abs_err=max(errs))
    res["kept_steps"] = keep["steps"]
    if keep["cfg"] is not None:
        res["step_calls"] = step_calls(keep["cfg"])
    try:
        res["replay"] = hold_step_calls(calls)
    except AssertionError as exc:  # the parent fails the phase with it
        res["replay_error"] = str(exc)
    with open(out + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(out + ".tmp", out)


def _http(port: int, path: str) -> "tuple[int, str]":
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


async def _node_run(wl: Workload, device: str, tmp: str, window: int,
                    min_rounds: int, timeout_s: float) -> dict:
    import signal

    from chanamq_tpu_torch.client import AMQPClient

    cfg_path = os.path.join(tmp, "node.json")
    with open(cfg_path, "w") as f:
        json.dump(node_config(device), f)
    out = os.path.join(tmp, "child.json")
    port, admin = _free_port(), _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--node-child", out,
         "--config", cfg_path, "--port", str(port), "--admin-port",
         str(admin)], cwd=here)

    async def get(path: str) -> "tuple[int, str]":
        return await asyncio.to_thread(_http, admin, path)

    res: dict = {}
    try:
        deadline = time.monotonic() + timeout_s
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"node exited ({proc.returncode}) "
                                     "before listening")
            try:
                _, w = await asyncio.open_connection("127.0.0.1", port)
                w.close()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError(f"node not listening in "
                                         f"{timeout_s} s") from None
                await asyncio.sleep(0.05)
        res["listen_s"] = time.perf_counter() - t_spawn
        while True:  # the admin server opens after the other layers
            try:
                await get("/admin/overview")
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError("admin API not up") from None
                await asyncio.sleep(0.05)

        setup = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
        ch = await setup.channel()
        await ch.exchange_declare("node.topic", "topic")
        await ch.exchange_declare("node.headers", "headers")
        for q in wl.queues:
            await ch.queue_declare(q)
        for pat, q in wl.topic_bindings:
            await ch.queue_bind(q, "node.topic", pat)
        for q, args in wl.headers_bindings:
            await ch.queue_bind(q, "node.headers", "", arguments=args)

        async def publish(p: int) -> None:
            c = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
            await _publish_stream(c, wl, p, "node", window,
                                  persistent=False)
            await c.close()

        t0 = time.perf_counter()
        await asyncio.gather(*(publish(p) for p in range(wl.publishers)))
        res["publish_s"] = time.perf_counter() - t0

        # every queue's count, read the operator's way, against the oracle
        status, body = await get("/admin/queues/%2F")
        counts = {q["name"]: q["messages"] for q in json.loads(body)}
        wrong = [(q, counts.get(q), len(wl.expected[q])) for q in wl.queues
                 if counts.get(q) != len(wl.expected[q])]
        if status != 200 or wrong:
            raise AssertionError(f"{len(wrong)} queue counts differ from "
                                 f"the oracle, e.g. {wrong[:5]}")

        # consumers drain every queue: each message once, in publish order
        # per publisher, with its body
        busy = [q for q in wl.queues if wl.expected[q]]
        want_total = sum(len(wl.expected[q]) for q in busy)
        got: dict = {q: [] for q in busy}
        count = [0]
        done = asyncio.Event()
        cons = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
        cch = await cons.channel()
        t0 = time.perf_counter()
        for q in busy:
            def cb(msg, _q=q) -> None:
                got[_q].append(msg)
                count[0] += 1
                if count[0] >= want_total:
                    done.set()
            await cch.basic_consume(q, cb, no_ack=True)
        await asyncio.wait_for(done.wait(), timeout=300)
        res["drain_s"] = time.perf_counter() - t0
        for q in busy:
            want = wl.expected[q]
            seen = [(int(a), int(b)) for a, b in
                    (m.body.split(b":", 2)[:2] for m in got[q])]
            if sorted(seen) != sorted(want) or any(
                    [i for pp, i in seen if pp == p]
                    != [i for pp, i in want if pp == p]
                    for p in range(wl.publishers)) or any(
                    m.body != wl.body(p, i) for m, (p, i) in zip(got[q],
                                                                 seen)):
                raise AssertionError(f"{q}: deliveries differ from the "
                                     "oracle")
        await cons.close()
        await setup.close()
        res["deliveries"] = count[0]

        # the forecaster's rounds, as /admin/forecast serves them
        while True:
            status, body = await get("/admin/forecast")
            snap = json.loads(body)
            if snap.get("error") is not None:
                raise AssertionError(f"forecaster error {snap['error']}")
            if snap.get("rounds", 0) >= min_rounds:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{snap.get('rounds')} forecast rounds "
                                     f"in {timeout_s} s")
            await asyncio.sleep(0.2)
        forecast = snap["forecast"] or {}
        if not (forecast and all(math.isfinite(v) for v in forecast.values())
                and snap["loss"] is not None and math.isfinite(snap["loss"])):
            raise AssertionError(f"/admin/forecast: {snap}")
        res["forecast"] = snap
        _, text = await get("/metrics")
        for name in ('chanamq_forecast{feature="', "chanamq_forecast_loss"):
            if name not in text:
                raise AssertionError(f"/metrics has no {name}")
        # health is a live verdict: the load is over, so it should be ready
        for _ in range(100):
            status, body = await get("/admin/health")
            if status == 200:
                break
            await asyncio.sleep(0.1)
        if status != 200:
            raise AssertionError(f"/admin/health {status}: {body}")
        ticks = []
        for _ in range(2):
            _, body = await get("/admin/control")
            ticks.append(json.loads(body)["tick"])
            await asyncio.sleep(1.5)  # longer than the control interval
        if not ticks[1] > ticks[0]:
            raise AssertionError(f"control engine not ticking: {ticks}")
        res["control_ticks"] = ticks

        # the node's exit is timed to main()'s return in the child; the
        # child then replays its kept kernel calls before it ends
        t0, sent = time.perf_counter(), time.time()
        proc.send_signal(signal.SIGTERM)
        res["exit"] = await asyncio.to_thread(proc.wait, 30 + 120)
        res["exit_total_s"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if res["exit"] != 0:
        raise AssertionError(f"node exited {res['exit']} on SIGTERM")
    with open(out) as f:
        res["child"] = json.load(f)
    res["exit_s"] = res["child"]["main_returned"] - sent
    if not res["exit_s"] <= 30:
        raise AssertionError(f"main() returned {res['exit_s']} s after "
                             "SIGTERM")
    return res


def phase_node(device: torch.device, seed: int, *, window: int = 2048,
               min_rounds: int = NODE_ROUNDS, timeout_s: float = 240.0,
               n_topic: int = NODE_TOPIC, n_headers: int = NODE_HEADERS,
               **sizes) -> dict:
    """The port's node as an operator starts it: ``main`` in a child
    process (``node_child``) with ``node_config(device)``; over AMQP, the
    main path's tables (512 topic patterns and 512 headers bindings over
    4,096 queues) and 4 confirming publishers' transient 256 B messages
    at its topic : headers mix; every queue's count (``/admin/queues``)
    against the host oracle, then consumers drain every queue, each
    message once, in order, with its body. Then ``/admin/forecast`` must
    show at least ``min_rounds`` rounds, a finite loss and forecasts and
    no error, ``/metrics`` the forecast gauges, ``/admin/health`` 200,
    ``/admin/control`` a ticking engine, and SIGTERM exit 0 within 30 s.
    The child reports every kernel wrapper's launches (on a card each of
    ``NODE_KERNELS`` at least once, on the CPU none), its last forecast
    replayed through the plain path within FORWARD_LIMIT, and its first
    trained round's kernel calls replayed against their plain versions at
    each kernel's own limits: a whole round, every kernel as often as
    ``step_calls`` says a step calls it (on the CPU, where the update's
    plain version runs, the forward's and backward's)."""
    import tempfile

    wl = Workload(seed, n_topic=n_topic, n_headers=n_headers, **sizes)
    with tempfile.TemporaryDirectory() as tmp:
        res = asyncio.run(_node_run(wl, str(device), tmp, window,
                                    min_rounds, timeout_s))
    child = res["child"]
    launches = child["launches"]
    if device.type == "cuda":
        idle = [k for k in NODE_KERNELS if launches[k] < 1]
        if idle:
            raise AssertionError(f"node path: {idle} never launched")
        if (launches["clip_momentum_sgd"] != launches["sum_of_squares"]
                + launches["momentum_sgd"]):
            raise AssertionError(f"node path: update launches {launches}")
    elif any(launches.values()):
        raise AssertionError(f"node path on the CPU launched {launches}")
    if not (child.get("pred_finite") and child["replay_max_abs_err"]
            <= FORWARD_LIMIT):
        raise AssertionError(f"node path: a forecast differs from the "
                             f"plain path by "
                             f"{child.get('replay_max_abs_err')}")
    if "replay_error" in child:
        raise AssertionError(f"node path: {child['replay_error']}")
    steps = child["kept_steps"]
    want = {k: v * steps for k, v in child["step_calls"].items()
            if device.type == "cuda" or k not in ("sum_of_squares",
                                                  "momentum_sgd")}
    got = {k: v["calls"] for k, v in child["replay"].items()}
    if steps != child["steps_per_round"] or got != want:
        raise AssertionError(f"node path: {steps} train steps kept, "
                             f"{got} calls replayed, want {want}")
    res.update(messages=wl.n_messages, mean_fanout=wl.mean_fanout,
               queues=len(wl.queues),
               msgs_per_s=wl.n_messages / res["publish_s"])
    return res


def log_node(res: dict, dev: dict) -> None:
    child = res["child"]
    snap = res["forecast"]
    for name, row in child["replay"].items():
        log(f"[node-replay] {name}: {row['calls']} calls of the node's "
            f"first trained round ({child['kept_steps']} steps) replayed "
            f"against the plain version at shapes {row['shapes']}; largest "
            f"error {row['max_abs_err']:.6g}, {row['of_limit']:.4g} of its "
            f"limit; card {dev['smi']}")
    log(f"[node] python -m chanamq_tpu_torch.broker.server (main) in a "
        f"child: AMQP listening {res['listen_s']:.3f} s after spawn; "
        f"{res['messages']} transient 256 B messages, 4 confirming "
        f"publishers, {res['queues']} queues, mean fan-out "
        f"{res['mean_fanout']:.3f}: {res['msgs_per_s']:.1f} confirmed msg/s "
        f"({res['publish_s']:.3f} s, host clock); queue counts equal the "
        f"oracle; {res['deliveries']} deliveries drained in "
        f"{res['drain_s']:.3f} s (from the first consume), in order; forecaster {snap['rounds']} "
        f"rounds, {snap['trained_steps']} trained steps, "
        f"{child.get('forwards')} forecasts, loss {snap['loss']:.6g}; "
        f"forecasts replayed through the plain path on their parameters: "
        f"the last max abs err {child['replay_last_abs_err']:.6g}, all "
        f"{child['replay_max_abs_err']:.6g}; control ticks "
        f"{res['control_ticks']}; SIGTERM exit {res['exit']} in "
        f"{res['exit_s']:.3f} s (main() returned; the process ended after "
        f"its replay in {res['exit_total_s']:.3f} s); kernel launches in "
        f"the node "
        f"{child['launches']}; card {dev['smi']}")


# -- 16. a replicated cluster -------------------------------------------------------

# half the [durable] phase's 50,000 persistent messages, at the main
# path's mix: 25,000 keep the script inside its time limit with the bench
# and soak phases after it (a sync confirm here runs at ~600-950 msg/s)
CLUSTER_TOPIC, CLUSTER_HEADERS = DURABLE_TOPIC // 2, DURABLE_HEADERS // 2
CLUSTER_NODES = 3
ROUTER_KERNELS = ("topic_match", "headers_match")
# the [cluster] phase's replica ack timeout (default 1,000 ms). A sync
# confirm waits for the followers' acks only this long, then is released
# anyway (counted in repl_ack_timeouts): at the default the followers
# fall behind this burst and a confirmed message can die with its owner.
# Waiting longer holds every confirm to its replica, the guarantee the
# phase checks
CLUSTER_ACK_TIMEOUT_MS = 60_000


def cluster_child(out: str, argv: list) -> None:
    """A [cluster] node, a [shard] worker or a [bench] broker: the port's
    ``main()`` unchanged on ``argv``. Every router kernel call is kept
    (``recording_router``). After ``main()`` returns, the JSON file
    ``out`` gets each wrapper's launches, read first, the broker's router
    counters, then every kept call replayed against its plain version,
    word for word."""
    from chanamq_tpu_torch.broker import server
    from chanamq_tpu_torch.broker.broker import Broker

    brokers: list = []
    real_start = Broker.start

    async def start(self) -> None:
        brokers.append(self)
        await real_start(self)

    Broker.start = start
    calls: dict = {}
    with open(out + ".pid", "w") as f:  # the parent watches this process
        f.write(str(os.getpid()))
    sys.argv = ["chanamq-server-torch", *argv]
    with recording_router(calls):
        server.main()
    res: dict = {"main_returned": time.time(),
                 "launches": _router_launches(), "replay": {}}
    if brokers:
        m = brokers[0].metrics
        res["router"] = {"batches": m.router_batches,
                         "batch_msgs": m.router_batch_msgs,
                         "fallback_msgs": m.router_fallback_msgs,
                         "device": str(brokers[0].router.device)}
    try:
        for name, recorded in calls.items():
            shapes: dict = {}
            worst = 0.0
            for args in recorded:
                row = hold(name, args, timed=False)
                worst = max(worst, row["max_abs_err"])
                shapes[row["shape"]] = shapes.get(row["shape"], 0) + 1
            res["replay"][name] = {"calls": len(recorded), "shapes": shapes,
                                   "max_abs_err": worst}
    except AssertionError as exc:  # the parent fails the phase with it
        res["replay_error"] = str(exc)
    with open(out + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(out + ".tmp", out)


def _distinct_free_ports(n: int) -> list:
    """``n`` free ports, all different (held open together while picked)."""
    import socket

    probes = [socket.socket() for _ in range(n)]
    try:
        for probe in probes:
            probe.bind(("127.0.0.1", 0))
        return [probe.getsockname()[1] for probe in probes]
    finally:
        for probe in probes:
            probe.close()


def _free_ports(n: int) -> int:
    """The first of ``n`` consecutive free ports (a shard's cluster and
    admin ports are a base + its index)."""
    import socket

    for _ in range(200):
        base = _free_port()
        if base + n > 65535:
            continue
        probes = []
        try:
            for i in range(n):
                probe = socket.socket()
                probes.append(probe)
                probe.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for probe in probes:
                probe.close()
    raise AssertionError(f"no {n} consecutive free ports")


def compute_apps() -> "list | None":
    """(pid, MiB) of each process holding a context on the card, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them (its
    pids may be another namespace's, even repeat); None where nvidia-smi
    does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    apps = []
    for line in out.strip().splitlines():
        pid, mib = (x.strip() for x in line.split(","))
        apps.append((int(pid), float(mib)))
    return apps


def card_usage(pids: dict) -> "dict | None":
    """The processes holding a context on the card, as nvidia-smi lists
    them: ``processes`` their count and ``mib`` their memory, and under
    ``named`` each process of ``pids`` with its MiB (0: no context) where
    nvidia-smi's pids are this machine's; where they are not (another
    pid namespace's) ``named`` is None. None where nvidia-smi does not
    run."""
    apps = compute_apps()
    if apps is None:
        return None
    by_pid = dict(apps)
    mapped = len(by_pid) == len(apps) and (
        os.getpid() in by_pid or any(p in by_pid for p in pids.values()))
    return {"processes": len(apps), "mib": sorted(m for _, m in apps),
            "named": ({name: by_pid.get(pid, 0.0)
                       for name, pid in pids.items()} if mapped else None)}


def _joined(view: dict, n: int) -> bool:
    """``/admin/cluster`` shows ``n`` members alive and active: a seed
    counts as alive before any contact, a member turns active only once
    it has exchanged a heartbeat with the cluster."""
    members = view.get("members", {}).values()
    return len(view.get("alive", [])) == n and len(members) == n and all(
        m["lifecycle"] == "active" for m in members)


async def _get_json(port: int, path: str):
    status, body = await asyncio.to_thread(_http, port, path)
    if status != 200:
        raise AssertionError(f"GET {path} on {port}: {status} {body[:200]}")
    return json.loads(body)


async def _until(check, what: str, deadline: float, procs=()):
    """Poll ``check()`` (async) until it returns a true value; fail at the
    deadline or when a process in ``procs`` has exited."""
    while True:
        for proc in procs:
            if proc.poll() is not None:
                raise AssertionError(f"a node exited ({proc.returncode}) "
                                     f"while waiting for {what}")
        try:
            got = await check()
            if got:
                return got
        except (OSError, ValueError, KeyError, AssertionError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def _declare_tables(port: int, wl: Workload, prefix: str,
                          durable: bool, admins: list, deadline: float,
                          procs: list) -> None:
    """The main path's tables through the node at ``port``: exchanges and
    queues, then, once every node knows every queue (a queue's metadata
    reaches the other nodes after its owner declared it), the bindings,
    until every node holds every binding (so each routes its own
    publishes)."""
    from chanamq_tpu_torch.client import AMQPClient

    want = {f"{prefix}.topic": len(wl.topic_bindings),
            f"{prefix}.headers": len(wl.headers_bindings)}

    async def known(bindings: bool) -> bool:
        for admin in admins:
            view = await _get_json(admin, "/admin/cluster")
            if view["known_queues"] != len(wl.queues):
                return False
            got = {e["name"]: e["bindings"]
                   for e in await _get_json(admin, "/admin/exchanges/%2F")}
            if bindings and any(got.get(k) != n for k, n in want.items()):
                return False
        return True

    setup = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
    ch = await setup.channel()
    await ch.exchange_declare(f"{prefix}.topic", "topic", durable=durable)
    await ch.exchange_declare(f"{prefix}.headers", "headers",
                              durable=durable)
    for q in wl.queues:
        await ch.queue_declare(q, durable=durable)
    await _until(lambda: known(False), "every queue on every node",
                 deadline, procs)
    for pat, q in wl.topic_bindings:
        await ch.queue_bind(q, f"{prefix}.topic", pat)
    for q, args in wl.headers_bindings:
        await ch.queue_bind(q, f"{prefix}.headers", "", arguments=args)
    await setup.close()
    await _until(lambda: known(True), "every binding on every node",
                 deadline, procs)


async def _publish_stream(client, wl: Workload, p: int, prefix: str,
                          window: int, persistent: bool) -> None:
    from chanamq_tpu_torch.amqp.properties import BasicProperties

    topic_props = BasicProperties(delivery_mode=2) if persistent else None
    header_props = ([BasicProperties(headers=h.headers, delivery_mode=2)
                     for h in wl.header_props] if persistent
                    else wl.header_props)
    pch = await client.channel()
    await pch.confirm_select()
    for i, (kind, x) in enumerate(wl.streams[p]):
        if kind == "t":
            pch.basic_publish(wl.body(p, i), exchange=f"{prefix}.topic",
                              routing_key=x, properties=topic_props)
        else:
            pch.basic_publish(wl.body(p, i), exchange=f"{prefix}.headers",
                              properties=header_props[x])
        if len(pch.unconfirmed) >= window:
            await pch.wait_unconfirmed_below(window // 2, timeout=120)
    await pch.wait_unconfirmed_below(1, timeout=300)


def hold_deliveries(wl: Workload, got: dict) -> dict:
    """Deliveries (queue -> messages) against the oracle: messages lost,
    duplicated, altered (body or routing key), and (queue, publisher)
    streams out of publish order."""
    lost = dup = reordered = altered = 0
    for q, msgs in got.items():
        want = wl.expected[q]
        seen = [(int(a), int(b)) for a, b in
                (m.body.split(b":", 2)[:2] for m in msgs)]
        dup += len(seen) - len(set(seen))
        lost += len(set(want) - set(seen))
        for m, (p, i) in zip(msgs, seen):
            kind, x = wl.streams[p][i]
            if m.body != wl.body(p, i) or m.routing_key != (
                    x if kind == "t" else ""):
                altered += 1
        for p in range(wl.publishers):
            if [i for pp, i in seen if pp == p] != [i for pp, i in want
                                                    if pp == p]:
                reordered += 1
    return {"lost": lost, "duplicated": dup, "reordered_streams": reordered,
            "altered": altered,
            "deliveries": sum(len(v) for v in got.values())}


def _spawn_child(flag: str, out: str, cfg: dict, tmp: str, name: str):
    """``chip_smoke.py <flag> <out> --config <cfg>``: ``main`` in a child
    whose log goes to ``<tmp>/<name>.log``, in a session of its own so
    that ``_reap`` also ends any process it spawned."""
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    logf = open(os.path.join(tmp, f"{name}.log"), "w")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, out,
             "--config", path, "--log-level", "WARNING"],
            cwd=here, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)
    finally:
        logf.close()


def _reap(proc) -> None:
    """Kill whatever is left of ``proc``'s session (a node, or a shard
    supervisor and its workers) and wait for ``proc``."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def _log_tail(tmp: str, name: str, n: int = 1500) -> str:
    try:
        with open(os.path.join(tmp, f"{name}.log")) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _log_warnings(tmp: str, name: str, top: int = 6) -> dict:
    """The child's WARNING and ERROR lines, counted by message with its
    numbers and addresses blanked, the most frequent first."""
    counts: dict = {}
    try:
        with open(os.path.join(tmp, f"{name}.log")) as f:
            for line in f:
                if " WARNING " not in line and " ERROR " not in line:
                    continue
                key = re.sub(r"[0-9.:]+", "#", line.split(" ", 2)[-1])[:120]
                counts[key.strip()] = counts.get(key.strip(), 0) + 1
    except OSError:
        return {}
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])


REPL_COUNTERS = ("repl_events_shipped", "repl_events_applied",
                 "repl_ack_timeouts", "repl_resyncs", "repl_promotions",
                 "flow_cluster_stalls")


def _router_counters(metrics: dict) -> dict:
    return {k: metrics[k] for k in ("router_compiles", "router_generation",
                                    "router_batches", "router_batch_msgs",
                                    "router_fallback_msgs")}


async def _consume_all(ports_by_queue: dict, wl: Workload, want_total: int,
                       timeout_s: float, first: list) -> dict:
    """Consume every busy queue through the node ``ports_by_queue`` names
    for it (no ack) until ``want_total`` deliveries arrived, then wait
    0.5 s for a duplicate; returns queue -> messages."""
    from chanamq_tpu_torch.client import AMQPClient

    got: dict = {q: [] for q in ports_by_queue}
    count = [0]
    done = asyncio.Event()
    clients = {}
    try:
        for q, port in ports_by_queue.items():
            if port not in clients:
                c = await AMQPClient.connect("127.0.0.1", port, heartbeat=0)
                clients[port] = (c, await c.channel())

            def cb(msg, _q=q) -> None:
                if not first:
                    first.append(time.perf_counter())
                got[_q].append(msg)
                count[0] += 1
                if count[0] >= want_total:
                    done.set()
            await clients[port][1].basic_consume(q, cb, no_ack=True)
        try:
            await asyncio.wait_for(done.wait(), timeout=timeout_s)
        except asyncio.TimeoutError:
            # what never arrived is counted as lost by the caller
            log(f"drain: {count[0]} of {want_total} deliveries in "
                f"{timeout_s} s")
        await asyncio.sleep(0.5)  # a duplicate would arrive now
    finally:
        for c, _ in clients.values():
            await c.close()
    return got


async def _cluster_run(wl: Workload, device: str, tmp: str, window: int,
                       timeout_s: float) -> dict:
    import signal

    from chanamq_tpu_torch.client import AMQPClient

    n = CLUSTER_NODES
    ports = _distinct_free_ports(3 * n)
    amqp, admin, cport = ports[:n], ports[n:2 * n], ports[2 * n:]
    names = [f"127.0.0.1:{p}" for p in cport]
    outs = [os.path.join(tmp, f"node{i}.out.json") for i in range(n)]
    procs: list = []
    res: dict = {}
    deadline = time.monotonic() + timeout_s
    t_spawn = time.perf_counter()
    try:
        for i in range(n):
            procs.append(_spawn_child("--cluster-child", outs[i], {
                "chana.mq.amqp.interface": "127.0.0.1",
                "chana.mq.amqp.port": amqp[i],
                "chana.mq.admin.enabled": True,
                "chana.mq.admin.interface": "127.0.0.1",
                "chana.mq.admin.port": admin[i],
                "chana.mq.cluster.enabled": True,
                "chana.mq.cluster.host": "127.0.0.1",
                "chana.mq.cluster.port": cport[i],
                "chana.mq.cluster.seeds": [names[0]] if i else [],
                "chana.mq.replicate.factor": 2,
                "chana.mq.replicate.sync": True,
                "chana.mq.replicate.ack-timeout-ms": CLUSTER_ACK_TIMEOUT_MS,
                "chana.mq.store.path": os.path.join(tmp, f"node{i}.db"),
                "chana.mq.router.device": device}, tmp, f"node{i}"))

        async def converged():
            views = [await _get_json(a, "/admin/cluster") for a in admin]
            return all(sorted(v["alive"]) == sorted(names)
                       and _joined(v, n) for v in views)

        await _until(converged, "three members alive on every node",
                     deadline, procs)
        res["converge_s"] = time.perf_counter() - t_spawn
        # two heartbeats (the default 1 s): every pair has exchanged one
        # directly, and a worker-id clash between private stores resolves
        # on direct contact
        await asyncio.sleep(2.0)
        await _declare_tables(amqp[0], wl, "cluster", True, admin,
                              deadline, procs)
        views = [await _get_json(a, "/admin/cluster") for a in admin]
        owned = [v["owned_queues"] for v in views]
        victim = max(range(n), key=lambda i: owned[i])
        alive = [i for i in range(n) if i != victim]
        victim_held = {q["name"] for q in
                       await _get_json(admin[victim], "/admin/queues/%2F")}
        res.update(owned=owned, victim=victim)

        clients = []
        try:
            for p in range(wl.publishers):
                clients.append(await AMQPClient.connect(
                    "127.0.0.1", amqp[alive[p % 2]], heartbeat=0))
            t0 = time.perf_counter()
            await asyncio.gather(*(
                _publish_stream(clients[p], wl, p, "cluster", window,
                                persistent=True)
                for p in range(wl.publishers)))
            res["publish_s"] = time.perf_counter() - t0
        finally:
            for c in clients:
                await c.close()
        before = [await _get_json(a, "/admin/metrics") for a in admin]
        res["before"] = [_router_counters(m) for m in before]
        res["repl_before"] = [{k: m[k] for k in REPL_COUNTERS}
                              for m in before]
        log(f"[cluster] {time.perf_counter() - t_spawn:.1f} s: published "
            f"in {res['publish_s']:.3f} s; replication {res['repl_before']}")
        res["card"] = card_usage({f"node{i}": procs[i].pid
                                  for i in range(n)})

        # every message is confirmed: now the owner of the most queues dies
        t_kill = time.perf_counter()
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)

        async def promoted():
            ms = [await _get_json(admin[i], "/admin/metrics") for i in alive]
            return sum(m["repl_promotions"] for m in ms) >= len(victim_held)

        await _until(promoted, "the victim's queues promoted", deadline,
                     [procs[i] for i in alive])
        res["kill_to_promoted_s"] = time.perf_counter() - t_kill
        after = [await _get_json(admin[i], "/admin/metrics") for i in alive]
        res["promotions"] = [m["repl_promotions"] for m in after]
        if not sum(res["promotions"]) == len(victim_held) == owned[victim]:
            raise AssertionError(
                f"survivors promoted {res['promotions']}; the victim held "
                f"{len(victim_held)} queues and owned {owned[victim]}")
        # each busy queue is consumed through the survivor that holds it
        held: dict = {}
        for i in alive:
            for q in await _get_json(admin[i], "/admin/queues/%2F"):
                held[q["name"]] = i
        busy = [q for q in wl.queues if wl.expected[q]]
        missing = [q for q in busy if q not in held]
        if missing:
            raise AssertionError(f"{len(missing)} queues held by no "
                                 f"survivor, e.g. {missing[:5]}")
        want_total = sum(len(wl.expected[q]) for q in busy)
        first: list = []
        got = await _consume_all({q: amqp[held[q]] for q in busy}, wl,
                                 want_total, 300.0, first)
        res["kill_to_first_delivery_s"] = first[0] - t_kill
        res["drained_s"] = time.perf_counter() - t_kill
        res.update(hold_deliveries(wl, got))
        res["lost_in_promoted"] = hold_deliveries(wl, {
            q: got[q] for q in busy if q in victim_held})["lost"]
        res["expected_deliveries"] = want_total
        res["promoted_queues"] = len(victim_held)
        res["served_from_promoted"] = sum(len(got[q]) for q in busy
                                          if q in victim_held)
        res["after"] = [_router_counters(m) for m in after]

        t_term, sent = time.perf_counter(), time.time()
        for i in alive:
            procs[i].send_signal(signal.SIGTERM)
        res["exit"] = [await asyncio.to_thread(procs[i].wait, 30 + 120)
                       for i in alive]
        res["exit_total_s"] = time.perf_counter() - t_term
    except BaseException:
        for i in range(len(procs)):
            log(f"[cluster] node{i} log tail: {_log_tail(tmp, f'node{i}')}")
        raise
    finally:
        for proc in procs:
            _reap(proc)
        res["warnings"] = {f"node{i}": _log_warnings(tmp, f"node{i}")
                           for i in range(len(procs))}
    if res["exit"] != [0, 0]:
        raise AssertionError(f"survivors exited {res['exit']} on SIGTERM")
    children = []
    for i in alive:
        with open(outs[i]) as f:
            children.append(json.load(f))
    res["children"] = children
    res["exit_s"] = [c["main_returned"] - sent for c in children]
    res["alive"] = alive
    return res


def phase_cluster(device: torch.device, seed: int, *, window: int = 2048,
                  timeout_s: float = 300.0, n_topic: int = CLUSTER_TOPIC,
                  n_headers: int = CLUSTER_HEADERS, **sizes) -> dict:
    """Three port nodes, each ``main`` in a child (``cluster_child``),
    replicated as the README's "Replication & failover" documents:
    ``replicate.factor`` 2, ``replicate.sync`` true, a private store each
    (the WAL at its defaults), admin on, the router on ``device``, nodes 2
    and 3 seeded with node 1, every other key at its default (two
    data-plane streams a peer) but the replica ack timeout. Once
    ``/admin/cluster`` shows three members alive everywhere, the main path's tables, all
    durable, are declared through node 1; the node owning the most queues
    is the victim, and no client connects to it. Two confirming
    publishers on each survivor send persistent 256 B messages at the main
    path's mix. After the last confirm the victim is SIGKILLed: the
    survivors' ``repl_promotions`` must sum to its queue count, consumers
    on the survivors drain every queue against the host oracle (each
    confirmed message in every queue it was routed to, exactly once, in
    publish order per publisher, with its body), each survivor's router
    kernels must have launched in its own process (on a card; none on the
    CPU) and its every kernel call must replay word for word, and SIGTERM
    must exit each survivor 0 with ``main()`` back within 30 s."""
    import tempfile

    wl = Workload(seed, n_topic=n_topic, n_headers=n_headers, **sizes)
    with tempfile.TemporaryDirectory() as tmp:
        res = asyncio.run(_cluster_run(wl, str(device), tmp, window,
                                       timeout_s))
    res.update(messages=wl.n_messages, mean_fanout=wl.mean_fanout,
               queues=len(wl.queues),
               msgs_per_s=wl.n_messages / res["publish_s"])
    bad = {k: res[k] for k in ("lost", "duplicated", "reordered_streams",
                               "altered") if res[k]}
    if bad or res["deliveries"] != res["expected_deliveries"]:
        raise AssertionError(
            f"cluster: {bad} ({res['lost_in_promoted']} lost in promoted "
            f"queues), {res['deliveries']} deliveries of "
            f"{res['expected_deliveries']}; replication before the kill "
            f"{res['repl_before']}; promotions {res['promotions']}; node "
            f"warnings {res['warnings']}")
    _hold_children("cluster", res["children"], device)
    if not all(s <= 30 for s in res["exit_s"]):
        raise AssertionError(f"cluster: main() returned {res['exit_s']} s "
                             "after SIGTERM")
    return res


def _hold_children(tag: str, children: list, device: torch.device, *,
                   need_launches: bool = True) -> None:
    """Each node process's router kernels launched (on a card, unless
    ``need_launches`` is false; none on the CPU, where the plain versions
    run) and every kept call replayed word for word."""
    for child in children:
        launches = child["launches"]
        if "replay_error" in child:
            raise AssertionError(f"{tag}: {child['replay_error']}")
        if device.type == "cuda":
            idle = [k for k in ROUTER_KERNELS if launches[k] < 1]
            if idle and need_launches:
                raise AssertionError(f"{tag}: {idle} never launched in a "
                                     f"node: {launches}")
            calls = {k: child["replay"].get(k, {}).get("calls", 0)
                     for k in ROUTER_KERNELS}
            if calls != launches:
                raise AssertionError(f"{tag}: {calls} calls kept for "
                                     f"{launches} launches")
        elif any(launches.values()):
            raise AssertionError(f"{tag} on the CPU launched {launches}")


def log_cluster(res: dict, dev: dict) -> None:
    for i, child in zip(res["alive"], res["children"]):
        for name, row in child["replay"].items():
            log(f"[cluster-replay] node{i} {name}: {row['calls']} calls "
                f"replayed against the plain version, 0 differing words, "
                f"shapes {row['shapes']}; card {dev['smi']}")
    log(f"[cluster] 3 port nodes (main in children), replicate.factor 2, "
        f"sync, a private store each, cluster.streams 2 (default): "
        f"membership converged {res['converge_s']:.3f} s after spawn; "
        f"{res['queues']} durable queues owned {res['owned']}, victim "
        f"node{res['victim']}; {res['messages']} persistent 256 B messages, "
        f"4 confirming publishers on the survivors, mean fan-out "
        f"{res['mean_fanout']:.3f}: {res['msgs_per_s']:.1f} confirmed msg/s "
        f"({res['publish_s']:.3f} s, host clock); SIGKILL after the last "
        f"confirm: {res['promoted_queues']} queues promoted "
        f"({res['promotions']} by survivor) {res['kill_to_promoted_s']:.3f} "
        f"s after it (polled every 50 ms), first delivery "
        f"{res['kill_to_first_delivery_s']:.3f} s, every queue drained "
        f"{res['drained_s']:.3f} s after it; {res['deliveries']} deliveries, "
        f"{res['served_from_promoted']} from promoted copies; lost "
        f"{res['lost']}, duplicated {res['duplicated']}, reordered streams "
        f"{res['reordered_streams']}, altered {res['altered']}; "
        f"replication before the kill {res['repl_before']}; node warnings "
        f"{res['warnings']}; router "
        f"counters before the kill {res['before']}, survivors after "
        f"{res['after']}; on the card {res['card']}; kernel launches in "
        f"the survivors {[c['launches'] for c in res['children']]}; "
        f"SIGTERM exit {res['exit']}, main() back {res['exit_s']} s after "
        f"it (processes gone in {res['exit_total_s']:.3f} s, replays "
        f"included); card {dev['smi']}")


# -- 17. a sharded node ---------------------------------------------------------------

SHARDS = 4


def shard_child(outdir: str, argv: list) -> None:
    """The [shard] phase's supervisor: the port's ``main()`` unchanged on
    ``argv`` (``chana.mq.shard.count`` 4). Each worker the supervisor
    spawns must be the port's server module (``-m
    chanamq_tpu_torch.broker.server``); it runs as ``cluster_child`` (the
    same ``main()``, its router kernel calls counted and kept), writing
    ``<outdir>/worker<index>.json``. After ``main()`` returns, the JSON
    file ``<outdir>/supervisor.json`` gets the time it returned."""
    from chanamq_tpu_torch.broker import server
    from chanamq_tpu_torch.shard import supervisor

    real_exec = supervisor.asyncio.create_subprocess_exec

    async def exec_worker(program, *args, **kwargs):
        if args[:2] != ("-m", "chanamq_tpu_torch.broker.server"):
            raise AssertionError(f"the supervisor spawned {args}")
        index = kwargs["env"]["CHANAMQ_SHARD_INDEX"]
        return await real_exec(
            program, os.path.abspath(__file__), "--cluster-child",
            os.path.join(outdir, f"worker{index}.json"), *args[2:],
            **kwargs)

    supervisor.asyncio.create_subprocess_exec = exec_worker
    sys.argv = ["chanamq-server-torch", *argv]
    server.main()
    with open(os.path.join(outdir, "supervisor.json"), "w") as f:
        json.dump({"main_returned": time.time()}, f)


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] in ("Z", "X")
    except OSError:
        return True


async def _shard_run(wl: Workload, device: str, tmp: str, window: int,
                     timeout_s: float) -> dict:
    import signal

    from chanamq_tpu_torch.client import AMQPClient

    n = SHARDS
    amqp, admin, cluster = _free_port(), _free_ports(n), _free_ports(n)
    admins = [admin + i for i in range(n)]
    res: dict = {}
    deadline = time.monotonic() + timeout_s
    t_spawn = time.perf_counter()
    proc = _spawn_child("--shard-child", tmp, {
        "chana.mq.amqp.interface": "127.0.0.1",
        "chana.mq.amqp.port": amqp,
        "chana.mq.admin.enabled": True,
        "chana.mq.admin.interface": "127.0.0.1",
        "chana.mq.admin.port": admin,
        "chana.mq.cluster.host": "127.0.0.1",
        "chana.mq.cluster.port": cluster,
        "chana.mq.shard.count": n,
        "chana.mq.shard.dir": os.path.join(tmp, "shards"),
        "chana.mq.router.device": device}, tmp, "supervisor")
    workers: list = []
    try:
        async def listening():
            for a in admins:
                await _get_json(a, "/admin/overview")
            return True

        await _until(listening, "every worker listening", deadline, [proc])
        res["listen_s"] = time.perf_counter() - t_spawn

        async def converged():
            views = [await _get_json(a, "/admin/cluster") for a in admins]
            return all(_joined(v, n) for v in views)

        await _until(converged, "the shards clustered", deadline, [proc])
        res["converge_s"] = time.perf_counter() - t_spawn
        # two shard heartbeats (the default 200 ms): every pair has
        # exchanged one directly (worker ids settle on direct contact)
        await asyncio.sleep(0.4)
        workers = []
        for i in range(n):
            with open(os.path.join(tmp, f"worker{i}.json.pid")) as f:
                workers.append(int(f.read()))
        await _declare_tables(amqp, wl, "shard", False, admins, deadline,
                              [proc])

        # one publisher a worker: the kernel spreads connections over the
        # workers by address hash, so a connection landing on a worker
        # that already has one is closed and made again
        async def opened() -> list:
            return [(await _get_json(a, "/admin/metrics"))[
                "connections_opened"] for a in admins]

        clients: dict = {}
        spare = []
        try:
            for _ in range(400):
                if len(clients) == n:
                    break
                base = await opened()
                c = await AMQPClient.connect("127.0.0.1", amqp, heartbeat=0)
                now = await opened()
                hit = [i for i in range(n) if now[i] > base[i]]
                if len(hit) == 1 and hit[0] not in clients:
                    clients[hit[0]] = c
                else:
                    spare.append(c)
            for c in spare:
                await c.close()
            if len(clients) != n:
                raise AssertionError(f"publishers reached workers "
                                     f"{sorted(clients)} only")
            t0 = time.perf_counter()
            await asyncio.gather(*(
                _publish_stream(c, wl, p, "shard", window, persistent=False)
                for p, c in enumerate(clients.values())))
            res["publish_s"] = time.perf_counter() - t0
        finally:
            for c in clients.values():
                await c.close()

        # every queue's count at its owner, read the operator's way
        counts: dict = {}
        for a in admins:
            for q in await _get_json(a, "/admin/queues/%2F"):
                counts.setdefault(q["name"], []).append(q["messages"])
        wrong = [(q, counts.get(q), len(wl.expected[q])) for q in wl.queues
                 if counts.get(q) != [len(wl.expected[q])]]
        if wrong:
            raise AssertionError(f"{len(wrong)} queue counts differ from the "
                                 f"oracle, e.g. {wrong[:5]}")
        metrics = [await _get_json(a, "/admin/metrics") for a in admins]
        res["router_batches"] = [m["router_batches"] for m in metrics]
        res["router_fallback_msgs"] = [m["router_fallback_msgs"]
                                       for m in metrics]
        res["cross_pushes"] = [m["shard_cross_pushes"] for m in metrics]
        res["card"] = card_usage({"supervisor": proc.pid, **{
            f"worker{i}": pid for i, pid in enumerate(workers)}})

        busy = [q for q in wl.queues if wl.expected[q]]
        want_total = sum(len(wl.expected[q]) for q in busy)
        t0 = time.perf_counter()
        got = await _consume_all({q: amqp for q in busy}, wl, want_total,
                                 300.0, [])
        res["drain_s"] = time.perf_counter() - t0
        res.update(hold_deliveries(wl, got))
        res["expected_deliveries"] = want_total

        t_term, sent = time.perf_counter(), time.time()
        proc.send_signal(signal.SIGTERM)
        res["exit"] = await asyncio.to_thread(proc.wait, 30 + 120)
        res["exit_total_s"] = time.perf_counter() - t_term
    except BaseException:
        log(f"[shard] supervisor log tail: {_log_tail(tmp, 'supervisor')}")
        raise
    finally:
        # the gate reads which workers outlived the supervisor before the
        # session is reaped
        res["workers_left"] = [pid for pid in workers if not _gone(pid)]
        _reap(proc)
    res["workers"] = workers
    with open(os.path.join(tmp, "supervisor.json")) as f:
        res["exit_s"] = json.load(f)["main_returned"] - sent
    children = []
    for i in range(n):
        with open(os.path.join(tmp, f"worker{i}.json")) as f:
            children.append(json.load(f))
    res["children"] = children
    return res


def phase_shard(device: torch.device, seed: int, *, window: int = 2048,
                timeout_s: float = 300.0, n_topic: int = DURABLE_TOPIC,
                n_headers: int = DURABLE_HEADERS, **sizes) -> dict:
    """One sharded node as the README documents it: ``main`` in a child
    (``shard_child``) with ``chana.mq.shard.count`` 4, reuse-port at its
    default (true), admin on (a worker's admin port is the base + its
    index), the router on ``device``, every other key at its default (two
    data-plane streams a peer). The supervisor spawns four
    workers; the main path's tables (transient queues) and 4 confirming
    publishers' transient 256 B messages, one publisher on each worker.
    Every queue's count at its owner's ``/admin/queues`` must equal the
    oracle, consumers drain every queue against it, every worker's
    ``/admin/metrics`` must show router batches (no fallback: on a card
    they ran there) and cross-shard pushes must sum above zero; on a card
    each worker's kernels launched in its own process and replay word for
    word, and nvidia-smi shows the four workers on the card and no
    supervisor; SIGTERM to the supervisor exits 0 within 30 s with every
    worker gone."""
    import tempfile

    wl = Workload(seed, n_topic=n_topic, n_headers=n_headers, **sizes)
    with tempfile.TemporaryDirectory() as tmp:
        res = asyncio.run(_shard_run(wl, str(device), tmp, window,
                                     timeout_s))
    res.update(messages=wl.n_messages, mean_fanout=wl.mean_fanout,
               queues=len(wl.queues),
               msgs_per_s=wl.n_messages / res["publish_s"])
    bad = {k: res[k] for k in ("lost", "duplicated", "reordered_streams",
                               "altered") if res[k]}
    if bad or res["deliveries"] != res["expected_deliveries"]:
        raise AssertionError(f"shard: {bad}, {res['deliveries']} "
                             f"deliveries of {res['expected_deliveries']}")
    if not all(b > 0 for b in res["router_batches"]):
        raise AssertionError(f"shard: router batches {res['router_batches']}")
    if sum(res["cross_pushes"]) <= 0:
        raise AssertionError("shard: no cross-shard push")
    if res["exit"] != 0 or res["exit_s"] > 30 or res["workers_left"]:
        raise AssertionError(f"shard: SIGTERM exit {res['exit']} after "
                             f"{res['exit_s']} s, workers left "
                             f"{res['workers_left']}")
    if len(res["workers"]) != SHARDS:
        raise AssertionError(f"shard: workers {res['workers']}")
    if device.type == "cuda":
        # four workers on the card and no supervisor: by pid where
        # nvidia-smi's pids are this machine's, else by count (the workers
        # and this process, which holds a context from earlier phases)
        card = res["card"]
        named = card and card["named"]
        if card is None or (named is not None and (
                named["supervisor"] > 0
                or any(named[f"worker{i}"] <= 0 for i in range(SHARDS)))) \
                or (named is None and card["processes"] != SHARDS + 1):
            raise AssertionError(f"shard: on the card {card}")
    _hold_children("shard", res["children"], device)
    return res


def log_shard(res: dict, dev: dict) -> None:
    for i, child in enumerate(res["children"]):
        for name, row in child["replay"].items():
            log(f"[shard-replay] worker{i} {name}: {row['calls']} calls "
                f"replayed against the plain version, 0 differing words, "
                f"shapes {row['shapes']}; card {dev['smi']}")
    cross = sum(res["cross_pushes"])
    log(f"[shard] chana.mq.shard.count {SHARDS} through main in a child, "
        f"reuse-port, cluster.streams 2 (default): every worker "
        f"listening {res['listen_s']:.3f} s after spawn, clustered "
        f"{res['converge_s']:.3f} s; {res['queues']} transient queues, "
        f"{res['messages']} transient 256 B messages, one confirming "
        f"publisher a worker, mean fan-out {res['mean_fanout']:.3f}: "
        f"{res['msgs_per_s']:.1f} confirmed msg/s ({res['publish_s']:.3f} "
        f"s, host clock); queue counts equal the oracle; "
        f"{res['deliveries']} deliveries drained in {res['drain_s']:.3f} s, "
        f"lost {res['lost']}, duplicated {res['duplicated']}, reordered "
        f"streams {res['reordered_streams']}; router batches by worker "
        f"{res['router_batches']} (fallback messages "
        f"{res['router_fallback_msgs']}); cross-shard push records "
        f"{res['cross_pushes']} = {cross / res['messages']:.3f} a message; "
        f"on the card {res['card']}; kernel launches in the workers "
        f"{[c['launches'] for c in res['children']]}; SIGTERM exit "
        f"{res['exit']}, main() back {res['exit_s']:.3f} s after it, "
        f"workers left {res['workers_left']}; card {dev['smi']}")


# -- 18-20. the bench harness and the soaks ------------------------------------

# the PerfTest specs [bench] runs (the reference's perf specs: 3
# producers and 3 consumers, the persistent single consumer, fan-out to 8
# and the wildcard topic exchange), each for BENCH_SECONDS
BENCH_SPECS = ("transient_autoack_3p3c", "persistent_ack_3p1c",
               "fanout_1p8c", "topic_3p3c_wildcards")
BENCH_SECONDS = 5.0
# the soak runners at the bench's seeds and sizes (``--chaos``,
# ``--overload``, ``--control``, ``--churn``, ``--elastic``,
# ``--tenant``, ``--tenant-churn``, ``--semantics-soak``,
# ``--federation``), plus the chaos soak over Unix sockets (the
# shard-crash drill): (label, runner, positional argument, keywords,
# the bench's time limit in s)
SOAK_RUNS = (
    ("chaos", "run_soak", 42, {"messages": 160, "wal": True}, 150),
    ("shard-crash", "run_soak", 42, {"messages": 160, "uds": True}, 150),
    ("overload", "run_overload_soak", 7, {"messages": 160}, 120),
    ("control", "run_control_soak", 7, {}, 180),
    ("churn", "run_connection_churn", 500, {}, 180),
    ("elastic", "run_elastic_soak", 11, {}, 240),
    ("tenant", "run_tenant_soak", 5, {}, 240),
    ("tenant-churn", "run_tenant_churn", 10_000, {}, 240),
    ("semantics", "run_semantics_soak", 42, {}, 240),
    ("federation", "run_federation_soak", 42, {}, 240),
)


@contextlib.contextmanager
def recording_router(calls: dict):
    """While the block runs, every router kernel call made through
    ``router/compile.py`` keeps its arguments in ``calls`` under the
    kernel's name; the wrappers and their launch counts stay as they
    are."""
    from chanamq_tpu_torch.kernels import router_match as rm
    from chanamq_tpu_torch.router import compile as rcompile

    rcompile.router_match = types.SimpleNamespace(**{
        name: _recording(getattr(rm, name), calls.setdefault(name, []))
        for name in ROUTER_KERNELS})
    try:
        yield
    finally:
        rcompile.router_match = rm


@contextlib.contextmanager
def router_device_env(device: torch.device):
    """``chana.mq.router.device`` set to ``device`` through the
    environment, which the bench's in-process brokers read and its
    spawned brokers inherit."""
    old = os.environ.get("CHANAMQ_ROUTER_DEVICE")
    os.environ["CHANAMQ_ROUTER_DEVICE"] = str(device)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CHANAMQ_ROUTER_DEVICE", None)
        else:
            os.environ["CHANAMQ_ROUTER_DEVICE"] = old


def _router_launches(reset: bool = False) -> dict:
    from chanamq_tpu_torch.kernels import router_match as rm

    out = {}
    for name in ROUTER_KERNELS:
        out[name] = getattr(rm, name).launches
        if reset:
            getattr(rm, name).launches = 0
    return out


def phase_bench_route(device: torch.device, *, quick: bool = False) -> dict:
    """``python -m chanamq_tpu_torch.bench --route``'s spec
    (``run_route_spec``) in this process with the router on ``device``:
    compiled topic tables over 1,000, 10,000 and 100,000 bindings (256
    wildcard kernel rows above 25,600), 16,384 keys routed in batches of
    512 by the torch backend (the kernels, warm and cold) and by the
    numpy body against the trie, every routed set against the trie's
    (``parity_mismatches``), the 1,000,000-binding compile and the
    key-shared fan-out through a live broker (``quick``: the bench's
    ``--quick`` sizes). Every router kernel call is kept and replayed
    against its plain version, word for word (``phase_path_kernels``);
    on a card the topic kernel must have launched, once a kept call."""
    from chanamq_tpu_torch import bench

    calls: dict = {}
    _router_launches(reset=True)
    t0 = time.perf_counter()
    with router_device_env(device), recording_router(calls):
        res = bench.run_route_spec(quick=quick)
    launches = _router_launches()
    res["phase_s"] = time.perf_counter() - t0
    res["launches"] = launches
    bad = {n: s["parity_mismatches"] for n, s in res["sizes"].items()
           if s["parity_mismatches"]}
    if bad:
        raise AssertionError(f"bench-route: parity mismatches {bad}")
    if "error" in res["key_shared_fanout"]:
        raise AssertionError(
            f"bench-route: key-shared fan-out {res['key_shared_fanout']}")
    if device.type == "cuda":
        if launches["topic_match"] < 1:
            raise AssertionError("bench-route: topic_match never launched")
        kept = {name: len(calls[name]) for name in ROUTER_KERNELS}
        if kept != launches:
            raise AssertionError(f"bench-route: {kept} calls kept for "
                                 f"{launches} launches")
    elif any(launches.values()):
        raise AssertionError(f"bench-route on the CPU launched {launches}")
    res["path"] = phase_path_kernels(
        {name: c for name, c in calls.items() if c}, tag="bench-route",
        path="bench --route")
    return res


def log_bench_route(res: dict, dev: dict) -> None:
    for n, s in res["sizes"].items():
        log(f"[bench-route] {s['bindings']} bindings, {s['kernel_rows']} "
            f"kernel rows, {s['unique_keys']} unique of {res['msgs']} keys "
            f"in batches of {res['batch']}: compile {s['compile_ms']} ms; "
            f"trie {s['trie_us_per_msg']} us a message; batched torch "
            f"{s['batched_torch_us_per_msg']} us a message warm, "
            f"{s['batched_torch_cold_us_per_key']} us a key cold; numpy "
            f"{s['batched_numpy_us_per_msg']} us a message; "
            f"{s['speedup_vs_trie']}x the trie; parity mismatches "
            f"{s['parity_mismatches']} (host clock); card {dev['smi']}")
    fan = res["key_shared_fanout"]
    log(f"[bench-route] 1,000,000 bindings compiled in "
        f"{res.get('build_1m_bindings_s')} s, "
        f"{res.get('build_1m_kernel_rows')} kernel rows; key-shared "
        f"fan-out {fan['groups']} groups x {fan['records']} records, "
        f"{fan['deliveries_per_s']} deliveries/s; kernel launches "
        f"{res['launches']}, every call replayed word for word; phase "
        f"{res['phase_s']:.1f} s; card {dev['smi']}")


def phase_bench(device: torch.device, *, specs=BENCH_SPECS,
                seconds: float = BENCH_SECONDS) -> dict:
    """The PerfTest specs through the port's bench harness
    (``run_spec``): every producer and consumer its own process, the
    broker a child running ``main`` with the router on ``device``, started
    here as ``chip_smoke.py --cluster-child <out.json> <the harness's
    broker arguments>`` (the harness's spawn, with this wrapper in front,
    so that the broker reports its kernel launches and router counters
    when it exits, and replays its kernel calls). Gates: no error,
    deliveries above 0, and on a card every launch kept and replayed word
    for word."""
    import tempfile

    from chanamq_tpu_torch import bench

    here = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-bench-")
    outs: list = []

    def popen(args, *a, **k):
        if list(args[1:3]) == ["-m", "chanamq_tpu_torch.broker.server"]:
            outs.append(os.path.join(tmp, f"bench-broker{len(outs)}.json"))
            args = [sys.executable, here, "--cluster-child", outs[-1],
                    *args[3:]]
        return subprocess.Popen(args, *a, **k)

    real_sub, real_seconds = bench.subprocess, bench.BENCH_SECONDS
    bench.subprocess = types.SimpleNamespace(
        **{k: getattr(subprocess, k) for k in dir(subprocess)
           if not k.startswith("__")})
    bench.subprocess.Popen = popen
    bench.BENCH_SECONDS = seconds
    res: dict = {}
    try:
        for name in specs:
            t0 = time.perf_counter()
            row = bench.run_spec(name, extra_env={
                "CHANAMQ_ROUTER_DEVICE": str(device)})
            row["phase_s"] = time.perf_counter() - t0
            if "error" in row:
                raise AssertionError(f"bench {name}: {row}")
            if not row["delivered"]:
                raise AssertionError(f"bench {name}: nothing delivered")
            with open(outs[-1]) as f:
                row["broker"] = json.load(f)
            if row["broker"]["router"]["device"] != str(device):
                raise AssertionError(f"bench {name}: broker routed on "
                                     f"{row['broker']['router']['device']}")
            _hold_children(f"bench {name}", [row["broker"]], device,
                           need_launches=False)
            res[name] = row
    finally:
        bench.subprocess, bench.BENCH_SECONDS = real_sub, real_seconds
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return res


def log_bench(res: dict, dev: dict) -> None:
    for name, row in res.items():
        rb = row["broker"]["router"]
        batches = (f"router batches {rb['batches']} ({rb['batch_msgs']} "
                   f"msgs, {rb['fallback_msgs']} below min-batch)"
                   if rb["batches"] else
                   f"the traffic formed no router batch "
                   f"({rb['fallback_msgs']} messages below min-batch)")
        log(f"[bench] {name}: {row['delivered_per_s']} delivered msg/s, "
            f"{row['published_per_s']} published msg/s, p50 "
            f"{row['p50_us']} us, p99 {row['p99_us']} us (publish to "
            f"deliver, client clocks); broker CPU {row['cpu_us_per_msg']} "
            f"us a message; {batches}; kernel launches in the broker "
            f"{row['broker']['launches']}; broker on {rb['device']}; "
            f"{row['phase_s']:.1f} s; card {dev['smi']}")


def phase_soak(device: torch.device, runs=SOAK_RUNS) -> dict:
    """The port's soak runners (``chaos/soak.py``) in this process, every
    broker they build on ``device``, each with the bench's time limit and
    gates: no violation, the overload soak under its hard limit, the
    elastic soak's two runs with one decision-log digest. Each runner's
    router kernel launches are counted from 0 and every call it made is
    replayed against the plain version, word for word."""
    from chanamq_tpu_torch.chaos import soak

    res: dict = {}
    for label, runner, arg, kwargs, limit in runs:
        calls: dict = {}
        _router_launches(reset=True)
        t0 = time.perf_counter()
        with recording_router(calls):
            report = asyncio.run(asyncio.wait_for(getattr(soak, runner)(
                arg, device=str(device), **kwargs), timeout=limit))
        row = {"runner": runner, "arg": arg, **kwargs,
               "seconds": time.perf_counter() - t0,
               "launches": _router_launches(),
               "violations": report["violations"]}
        if report["violations"]:
            raise AssertionError(f"soak {label}: {report['violations']}")
        if runner == "run_overload_soak":
            row["under_hard_limit"] = report["under_hard_limit"]
            row["peak_accounted_bytes"] = report["peak_accounted_bytes"]
            if not report["under_hard_limit"]:
                raise AssertionError(f"soak {label}: over the hard limit")
        if runner == "run_elastic_soak":
            digests = [r["log_sha256"] for r in report["runs"]]
            row["log_sha256"] = digests
            if len(set(digests)) != 1 or not digests[0]:
                raise AssertionError(f"soak {label}: digests {digests}")
        if runner == "run_soak":
            row.update({k: report[k] for k in (
                "fingerprint", "confirmed", "delivered_unique",
                "promotions", "handoffs", "interconnect", "store")})
        kept = {name: c for name, c in calls.items() if c}
        row["replayed_calls"] = {name: len(c) for name, c in kept.items()}
        if kept:
            phase_path_kernels(kept, iters=10, tag="soak",
                               path=f"{label} soak")
        res[label] = row
    return res


def log_soak(res: dict, dev: dict) -> None:
    for label, row in res.items():
        extra = {k: v for k, v in row.items() if k not in (
            "runner", "seconds", "launches", "violations",
            "replayed_calls")}
        log(f"[soak] {label} ({row['runner']}): {row['seconds']:.1f} s, "
            f"violations {len(row['violations'])}, router kernel launches "
            f"{row['launches']} (calls replayed {row['replayed_calls']}); "
            f"{extra}; card {dev['smi']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the [durable] phase's node process: port, store path, device, state
    ap.add_argument("--durable-node", nargs=4, help=argparse.SUPPRESS)
    if sys.argv[1:2] == ["--node-child"]:
        # the [node] phase's node: --node-child <out.json> <main's args>
        node_child(sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--cluster-child"]:
        # a [cluster] node, [shard] worker or [bench] broker:
        # --cluster-child <out.json> <main's args>
        cluster_child(sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--shard-child"]:
        # the [shard] phase's supervisor: --shard-child <dir> <main's args>
        shard_child(sys.argv[2], sys.argv[3:])
        return 0
    args = ap.parse_args()
    if args.durable_node:
        port, db, device, state = args.durable_node
        durable_node(int(port), db, device, state)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was measured",
              file=sys.stderr)
        return 2
    from chanamq_tpu_torch.kernels import router_match as rm

    t_run = time.perf_counter()
    dev = phase_device()
    built = phase_build()
    device = torch.device("cuda", 0)
    caps = phase_kernels(device, args.seed)
    fc_kernels = phase_forecaster_kernels(
        device, args.seed, layernorm_batches=LAYERNORM_BATCHES)
    floor = phase_floor(device)
    phase_forward(device, args.seed)
    train_kernels = phase_train_kernels(device, args.seed)
    bwd_warps = phase_bwd_warps(device, args.seed)
    long_windows = phase_long_windows(device, args.seed)
    train = phase_train(device, args.seed)
    log_train(train, dev)
    phase_init(device)

    calls: dict = {}
    rm.topic_match.launches = 0
    rm.headers_match.launches = 0
    t0 = time.perf_counter()
    main_res = phase_main(device, args.seed, calls=calls)
    launches = {"topic_match": rm.topic_match.launches,
                "headers_match": rm.headers_match.launches}
    phase_s = time.perf_counter() - t0
    log(f"[main] {main_res['messages']} messages published and confirmed "
        f"in {main_res['publish_s']:.3f} s = {main_res['msgs_per_s']:.1f} "
        f"msg/s (host clock, publish to last confirm, traced), mean fan-out "
        f"{main_res['mean_fanout']:.3f}; router batches "
        f"{main_res['router_batches']} ({main_res['router_batch_msgs']} msgs,"
        f" {main_res['router_fallback_msgs']} below min-batch); parity "
        f"mismatches {main_res['router_parity_mismatches']}; kernel "
        f"launches {launches}; host time in route_pending "
        f"{main_res['route_pending_s']:.3f} s, of it route_batch "
        f"{main_res['route_batch_s']:.3f} s; "
        f"{main_res['delivered']} deliveries on "
        f"{main_res['consumed_queues']} queues in order; phase "
        f"{phase_s:.1f} s; card {dev['smi']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if n != len(calls[name]):
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{len(calls[name])} wrapper calls")
    tr = main_res["trace"]
    window_us = main_res["publish_s"] * 1e6
    if tr["events"]:
        log(f"[trace] publish window {window_us:.0f} us: {tr['events']} "
            f"device events, busy {tr['busy_us']:.1f} us = "
            f"{100 * tr['busy_us'] / window_us:.4f}%, idle "
            f"{100 * (1 - tr['busy_us'] / window_us):.4f}%; router kernels "
            f"{tr['kernels']}")
    else:
        log("[trace] the profiler saw no device event: device busy time "
            "and idle share not measured")
    path = phase_path_kernels(calls)

    # torch's default: the service must set the reference's precision
    # itself (its forward raises on the card while this allows less)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    counted = counted_wrappers()
    for wrapper in counted.values():
        wrapper.launches = 0
    fc = phase_forecast(device)
    for name in FORECASTER_KERNELS + TRAIN_KERNELS:
        launches[name] = counted[name].launches
    cfg = fc["cfg"]
    ms_stats = ", ".join(f"{k} {v:.4f}" for k, v in
                         fc["ms_per_forward"].items() if k != "n")
    per_forward = {"layernorm": 2 * cfg.n_layers,
                   "causal_attention": cfg.n_layers,
                   "gelu_tanh": cfg.n_layers}
    log(f"[forecast] {fc['rounds']} rounds, {fc['forwards']} forwards at "
        f"d_model {cfg.d_model}, {cfg.n_layers} layers, window "
        f"{cfg.seq_len}, on the card in {fc['run_s']:.3f} s; ms per "
        f"forward (host clock, synchronized) over forwards 2-"
        f"{fc['forwards']}: {ms_stats}; the first "
        f"{fc['ms_first_forward']:.4f}; kernel launches "
        f"{ {k: launches[k] for k in FORECASTER_KERNELS} }; replay against "
        f"the plain path max abs err {fc['replay_max_abs_err']:.6g}; "
        f"{fc['samples']} samples, publish rate up to "
        f"{fc['max_publish_rate']:.1f}/s, {fc['published']} published; "
        f"card {dev['smi']}")
    log_trace("forecast-trace", fc)
    for name, n in per_forward.items():
        if fc["forwards"] < 1 or launches[name] != n * fc["forwards"]:
            raise AssertionError(
                f"{name}: {launches[name]} launches for {fc['forwards']} "
                f"forwards of {n} each")
    for name in TRAIN_KERNELS:
        if launches[name]:
            raise AssertionError(f"{name}: {launches[name]} launches on a "
                                 "path that does not train")

    # the training path, with the service's defaults: 20 steps a round on
    # a batch of 16 at lr 1e-3
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for wrapper in counted.values():
        wrapper.launches = 0
    ft = phase_forecast(device, steps_per_round=STEPS_PER_ROUND, batch=16,
                        lr=1e-3, min_rounds=TRAIN_ROUNDS, timeout_s=300.0)
    train_launches = {name: w.launches for name, w in counted.items()}
    per_step = train_per_step(ft["cfg"])
    want = {name: per_step.get(name, 0) * ft["steps"]
            + per_forward.get(name, 0) * ft["forwards"]
            for name in FORECASTER_KERNELS + TRAIN_KERNELS}
    stats = {kind: ", ".join(f"{k} {v:.4f}" for k, v in ft[kind].items()
                             if k not in ("n", "first"))
             for kind in ("ms_per_round", "ms_per_step", "ms_per_forward")}
    log(f"[forecast-train] {ft['rounds']} rounds of {STEPS_PER_ROUND} steps "
        f"(batch 16, lr 1e-3), {ft['steps']} steps and {ft['forwards']} "
        f"forwards at d_model {cfg.d_model}, {cfg.n_layers} layers, on the "
        f"card in {ft['run_s']:.3f} s; ms per round (host clock) over rounds "
        f"2-{ft['ms_per_round']['n'] + 1}: {stats['ms_per_round']}; the "
        f"first {ft['ms_per_round']['first']:.4f}; ms per step (host clock, "
        f"synchronized): {stats['ms_per_step']}; the first "
        f"{ft['ms_per_step']['first']:.4f}; ms per forward: "
        f"{stats['ms_per_forward']}; last loss {ft['loss']:.6g}; kernel "
        f"launches {train_launches} (want {want}); replay against the plain "
        f"path max abs err {ft['replay_max_abs_err']:.6g}; card {dev['smi']}")
    log_trace("forecast-train-trace", ft)
    if train_launches != want or ft["steps"] < STEPS_PER_ROUND * TRAIN_ROUNDS:
        raise AssertionError(f"training path: launches {train_launches}, "
                             f"want {want} for {ft['steps']} steps")

    # the service's compact default model at a window of 1,024, training
    # at its defaults: every round must train and forecast on the card
    for wrapper in counted.values():
        wrapper.launches = 0
    fw = phase_forecast(device, model_kwargs=dict(WINDOW_MODEL),
                        seq_len=WINDOW_T, interval_s=0.005,
                        steps_per_round=STEPS_PER_ROUND, batch=16, lr=1e-3,
                        min_rounds=WINDOW_ROUNDS, timeout_s=300.0)
    window_launches = {name: w.launches for name, w in counted.items()}
    per_step = train_per_step(fw["cfg"])
    fw_per_forward = {"layernorm": 2 * fw["cfg"].n_layers,
                      "causal_attention": fw["cfg"].n_layers,
                      "gelu_tanh": fw["cfg"].n_layers}
    want = {name: per_step.get(name, 0) * fw["steps"]
            + fw_per_forward.get(name, 0) * fw["forwards"]
            for name in FORECASTER_KERNELS + TRAIN_KERNELS}
    log(f"[forecast-window] window {fw['cfg'].seq_len}, d_model "
        f"{fw['cfg'].d_model}, {fw['cfg'].n_heads} heads, "
        f"{fw['cfg'].n_layers} layers: {fw['rounds']} rounds of "
        f"{STEPS_PER_ROUND} steps (batch 16, lr 1e-3), {fw['steps']} steps "
        f"and {fw['forwards']} forwards on the card in {fw['run_s']:.3f} s; "
        f"ms per round {fw['ms_per_round']['median']:.4f} median (the first "
        f"{fw['ms_per_round']['first']:.4f}); last loss {fw['loss']:.6g}; "
        f"forecasts finite and non-negative; replay against the plain path "
        f"max abs err {fw['replay_max_abs_err']:.6g}; kernel launches "
        f"{window_launches} (want {want}); card {dev['smi']}")
    if window_launches != want or fw["steps"] < STEPS_PER_ROUND \
            or not np.isfinite(fw["loss"]):
        raise AssertionError(f"window {WINDOW_T}: launches "
                             f"{window_launches}, want {want}, loss "
                             f"{fw['loss']}")

    # the sharded train step: (a) over NCCL, one rank a card; (b) tp ranks
    # sharing the first card over gloo with CUDA tensors
    cards = [f"cuda:{i}" for i in range(dev["count"])]
    sharded = phase_sharded_train(
        [("nccl", "nccl", cards, None),
         ("gloo-tp4", "gloo", [cards[0]] * SHARDED_TP, SHARDED_TP)],
        args.seed)
    log_sharded(sharded, dev)

    def sharded_path(name: str) -> dict:
        """A kernel on the sharded path: rank 0's launches in each run and
        the replay of every rank's first step."""
        return {label: {
            "launches": run["ranks"][0]["launches"][name],
            "replayed_calls": sum(r["replay"][name]["calls"]
                                  for r in run["ranks"]),
            "shapes": sorted({s for r in run["ranks"]
                              for s in r["replay"][name]["shapes"]}),
            "max_abs_err": max(r["replay"][name]["max_abs_err"]
                               for r in run["ranks"])}
            for label, run in sharded.items()}

    # a durable node at the WAL's defaults, killed after its last confirm
    durable = phase_durable(device, args.seed)
    log_durable(durable, dev)

    # the node as an operator starts it, through main, with its forecaster
    # on the card: the kernels' launches counted in the node's process
    node = phase_node(device, args.seed)
    log_node(node, dev)
    node_launches = node["child"]["launches"]

    node_replay = node["child"]["replay"]

    # a replicated cluster of three port nodes, the owner of the most
    # queues killed; then one sharded node of four workers. Each node's
    # router kernels are counted in its own process, from 0
    cluster = phase_cluster(device, args.seed)
    log_cluster(cluster, dev)
    shard = phase_shard(device, args.seed)
    log_shard(shard, dev)

    # the bench harness: --route's spec in this process, then the
    # PerfTest specs with each broker a child on the card; then the
    # soak runners, every broker on the card
    bench_route = phase_bench_route(device)
    log_bench_route(bench_route, dev)
    bench_specs = phase_bench(device)
    log_bench(bench_specs, dev)
    soaks = phase_soak(device)
    log_soak(soaks, dev)

    def bench_path(name: str) -> dict:
        """A router kernel's launches on the bench harness's paths: the
        route spec (its calls replayed) and each PerfTest spec's broker."""
        row = {"route": {"launches": bench_route["launches"][name]}}
        if name in bench_route["path"]:
            r = bench_route["path"][name]
            row["route"].update(replayed_calls=r["calls"],
                                shapes=r["shapes"],
                                max_abs_err=r["max_abs_err"], ms=r["ms"],
                                plain_ms=r["plain_ms"],
                                bound_ms=r["bound_ms"])
        row["perftest"] = {spec: r["broker"]["launches"][name]
                           for spec, r in bench_specs.items()}
        return row

    def soak_path(name: str) -> dict:
        """A router kernel's launches in each soak run, from 0."""
        return {label: r["launches"][name] for label, r in soaks.items()}

    def cluster_path(name: str) -> dict:
        """A router kernel's launches in each [cluster] survivor and each
        [shard] worker, and the replay of their calls."""
        def rows(children, labels):
            return {label: {"launches": c["launches"][name],
                            "replayed_calls": c["replay"][name]["calls"],
                            "shapes": c["replay"][name]["shapes"],
                            "max_abs_err": c["replay"][name]["max_abs_err"]}
                    for label, c in zip(labels, children)}
        return {"cluster_survivors": rows(
                    cluster["children"],
                    [f"node{i}" for i in cluster["alive"]]),
                "shard_workers": rows(
                    shard["children"],
                    [f"worker{i}" for i in range(SHARDS)])}

    def node_path(name: str) -> dict:
        """A kernel's launches in the [node] phase's node and the replay of
        its calls in the node's first trained round (the router kernels'
        calls are held on the main path); the update's two under their
        split names."""
        if name == "clip_momentum_sgd":
            return {split: node_path(split) for split in (
                "sum_of_squares", "momentum_sgd")}
        row = {"launches": node_launches[name]}
        if name in node_replay:
            r = node_replay[name]
            row.update(replayed_calls=r["calls"], shapes=sorted(r["shapes"]),
                       max_abs_err=r["max_abs_err"], of_limit=r["of_limit"])
        return row

    replaces = {"topic_match": "chanamq_tpu/router/compile.py:289",
                "headers_match": "chanamq_tpu/router/compile.py:372",
                "layernorm": "chanamq_tpu/models/forecaster.py:77",
                "causal_attention": "chanamq_tpu/models/forecaster.py:84",
                "gelu_tanh": "chanamq_tpu/models/forecaster.py:116",
                "layernorm_bwd": "chanamq_tpu/models/forecaster.py:141",
                "causal_attention_bwd": "chanamq_tpu/models/forecaster.py:141",
                "gelu_tanh_bwd": "chanamq_tpu/models/forecaster.py:141",
                "clip_momentum_sgd": "chanamq_tpu/models/forecaster.py:142"}
    line = []
    for name in ("topic_match", "headers_match"):
        row = path[name]
        line.append({
            "name": name, "route": "cuda",
            "source": "chanamq_tpu_torch/csrc/router_match.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max([row["max_abs_err"]] + [
                r["max_abs_err"] for r in caps[name].values()]),
            "mismatched_words": row["mismatched_words"],
            "shape": row["shape"],
            "ms": row["ms"], "wrapper_ms": row["wrapper_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "node_path": node_path(name),
            "cluster_path": cluster_path(name),
            "bench_path": bench_path(name), "soak_path": soak_path(name),
            "at_caps": {b: {k: caps[name][b][k] for k in (
                "shape", "ms", "wrapper_ms", "plain_ms", "bound_ms",
                "bound_by", "by_mb")} for b in caps[name]}})
    keys = ("shape", "max_abs_err", "limit", "ms", "wrapper_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")
    # the attention kernels' tensor-core instructions, by kernel name
    hmma = {kernel: built[src]["hmma"] for src, kernel in MMA_KERNELS.items()}
    # the empty launch's time beside each layernorm kernel's
    floor_ms = {"floor_ms": floor["one_block"]["ms"]}
    lw_keys = ("shape", "max_abs_err", "limit", "ms", "plain_ms",
               "library_ms", "bound_ms", "bound_by")
    long_rows = {name: {f"t{t}_hd{hd}": {k: rows[name][k] for k in lw_keys}
                        for (t, hd), rows in long_windows.items()}
                 for name in ("causal_attention", "causal_attention_bwd")}
    for name in FORECASTER_KERNELS:
        rows = fc_kernels[name]
        main_b = FORECAST_BATCHES[0]  # the service's batch first
        line.append({
            "name": name, "route": "cuda",
            "source": "chanamq_tpu_torch/csrc/forecaster.cu",
            "replaces": replaces[name], "launches": launches[name],
            "launches_training_path": train_launches[name],
            **{k: rows[main_b][k] for k in keys},
            **{f"at_b{b}": {k: rows[b][k] for k in keys}
               for b in rows if b != main_b},
            **({"hmma": hmma[name]} if name in hmma else {}),
            **({"long_windows": long_rows[name]} if name in long_rows
               else {}),
            "sharded_path": sharded_path(name), "node_path": node_path(name),
            **(floor_ms if name == "layernorm" else {})})
    for name in TRAIN_KERNELS:
        rows = train_kernels[name]
        main_b, other_b = TRAIN_BATCHES  # the service's batch first
        line.append({
            "name": name, "route": "cuda",
            "source": "chanamq_tpu_torch/csrc/forecaster_train.cu",
            "replaces": replaces[name], "launches": train_launches[name],
            **{k: rows[main_b][k] for k in keys},
            f"at_b{other_b}": {k: rows[other_b][k] for k in keys},
            **({"hmma": hmma[name]} if name in hmma else {}),
            **({"long_windows": long_rows[name]} if name in long_rows
               else {}),
            **({"main_kernel_by_warps": bwd_warps}
               if name == "causal_attention_bwd" else {}),
            # the update's two kernels, launched apart on the sharded path
            "sharded_path": ({split: sharded_path(split) for split in (
                "sum_of_squares", "momentum_sgd")}
                if name == "clip_momentum_sgd" else sharded_path(name)),
            "node_path": node_path(name),
            **(floor_ms if name == "layernorm_bwd" else {})})
    log(f"[time] every phase in {time.perf_counter() - t_run:.1f} s (host "
        f"clock, builds included); card {dev['smi']}")
    print(json.dumps({"kernels": line}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
