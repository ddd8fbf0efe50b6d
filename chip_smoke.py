#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``chanamq_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

Phases, each a function of a device and a size so that a CPU test can
rehearse it; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``csrc/router_match.cu`` with nvcc for sm_90a, with ptxas's
   register, shared-memory and spill report;
3. kernels at the router's caps: both router match kernels at N=512
   rows, W=128 mask words and full token widths (topic P=S=8, headers
   R=8, H=16) against their plain PyTorch versions, word for word, at B in
   {16, 256, 1024}, with device times and the bound for those inputs;
4. main path: the port's ``BrokerServer`` on 127.0.0.1 with default
   router config (backend torch, device cuda) and verify on; 4 publisher
   connections with confirms send 100,000 topic and 50,000 headers
   messages of 256 B; every queue's count must equal a host oracle built
   from the port's Python matchers, 16 consumers must receive their
   messages in publish order with identical bodies, and both kernels'
   launch counts must be above zero. The publish window is traced with
   ``torch.profiler`` for the card's busy time and idle share, and every
   kernel call's arguments are kept;
5. main-path kernels: every kept call replayed through the kernel and its
   plain version, word for word; the most common shape is timed and
   bounded, and the kernels line reports it;
6. the kernels line, the card line, and the result line.

Without a card, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
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
CAPS_REPORT_B = 256  # the caps run's batch that the kernels line also shows
# ~0.1 s at the H100's 1.98 GHz: long enough for the host to queue a timed
# loop behind it
SLEEP_CYCLES = 200_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. device -----------------------------------------------------------------


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; nvidia-smi: {smi}")
    return {"kind": name, "smi": smi, "count": torch.cuda.device_count()}


# -- 2. build ------------------------------------------------------------------


def phase_build() -> dict:
    from chanamq_tpu_torch.kernels import build

    built = build.build("router_match")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    log(f"[build] {built.path} in {built.seconds:.2f} s"
        f"{' (already built)' if built.seconds == 0.0 else ''}")
    for ln in ptxas:
        log(f"[build] ptxas: {ln}")
    return {"seconds": built.seconds, "ptxas": ptxas}


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
    """The dims of one kernel call, as the CUDA launcher takes them."""
    if name == "topic_match":
        pre, suf, masks, pre_m = args[0], args[1], args[5], args[6]
        return (f"B={pre_m.shape[0]} N={pre.shape[0]} P={pre.shape[1]} "
                f"S={suf.shape[1]} W={masks.shape[1]}")
    req, masks, pids = args[0], args[3], args[4]
    return (f"B={pids.shape[0]} N={req.shape[0]} R={req.shape[1]} "
            f"H={pids.shape[1]} W={masks.shape[1]}")


def hold(name: str, args, *, timed: bool = True, iters: int = 100) -> dict:
    """One call's inputs through the kernel's wrapper and its plain
    version: every word must agree. With ``timed`` (on a card), also the
    kernel's device time, the wrapper's per-call time, the plain
    version's device time, and the bound for these inputs."""
    kern, ref, prepare, work = _kernel_fns(name)
    got = kern(*args)
    want = ref(*args)
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    bad = int((diff != 0).sum())
    if bad:
        raise AssertionError(f"{name} {shape_of(name, args)}: {bad} words "
                             "differ from the plain version")
    row = {"shape": shape_of(name, args), "mismatched_words": bad,
           "max_abs_err": float(diff.max()) if diff.numel() else 0.0}
    if not timed:
        return row
    ops, matched = work(*(a.cpu().numpy() for a in args))
    nbytes = _nbytes(*args, got)
    bound_ms, bound_by = _bound(nbytes, ops)
    row.update({"matched_pairs": matched, "ops": ops, "bytes": nbytes,
                "bound_ms": bound_ms, "bound_by": bound_by})
    if got.is_cuda:
        _, launch = prepare(*args)
        row["ms"] = _time_ms(launch, iters, device_only=True)
        row["wrapper_ms"] = _time_ms(lambda: kern(*args), iters,
                                     device_only=False)
        row["plain_ms"] = _time_ms(lambda: ref(*args), max(5, iters // 10),
                                   device_only=True)
    return row


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
    and raises on any differing word."""
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
        cases = (("topic_match", (td["pre"], td["suf"], td["plen"],
                                  td["slen"], td["has_hash"], td["masks"],
                                  *msg)),
                 ("headers_match", (hd["req"], hd["rcount"], hd["is_all"],
                                    hd["masks"], pids)))
        for name, args in cases:
            row = out[name][b] = hold(name, args, iters=iters)
            _log_row("kernels", name, row)
    return out


def phase_path_kernels(calls: dict, iters: int = 100) -> dict:
    """Every kernel call the main path made, replayed: the wrapper against
    the plain version on the same inputs, word for word. The most common
    shape's last call is timed and bounded; it stands for the kernel in
    the kernels line. Returns {kernel name: row}."""
    out = {}
    for name, recorded in calls.items():
        if not recorded:
            raise AssertionError(f"the main path made no {name} call")
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
        log(f"[path-kernels] {name}: {len(recorded)} main-path calls "
            f"replayed, 0 differing words; shapes {shapes}")
        _log_row("path-kernels", name, row)
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


def device_busy(trace) -> dict:
    """The card's work in a ``torch.profiler`` trace: the union of its
    kernel and copy intervals (us), and per router kernel its launches
    and device time (us)."""
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
        for name in ("topic_match", "headers_match"):
            if f"{name}_kernel" in e.name:
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
    from chanamq_tpu_torch.kernels import router_match as rm
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
    if calls is not None:
        # the router reaches the wrappers through its module reference;
        # the wrappers themselves (and their launch counts) stay as they are
        rcompile.router_match = types.SimpleNamespace(**{
            name: _recording(getattr(rm, name), calls.setdefault(name, []))
            for name in ("topic_match", "headers_match")})
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
        res = asyncio.run(run())
    finally:
        rcompile.route_batch = real_route_batch
        rcompile.router_match = rm
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


# -- 5. entry point -------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was measured",
              file=sys.stderr)
        return 2
    from chanamq_tpu_torch.kernels import router_match as rm

    dev = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    caps = phase_kernels(device, args.seed)

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
    replaces = {"topic_match": "chanamq_tpu/router/compile.py:289",
                "headers_match": "chanamq_tpu/router/compile.py:372"}
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
            "library_ms": None,
            "at_caps": {k: caps[name][CAPS_REPORT_B][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by")}})
    print(json.dumps({"kernels": line}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
