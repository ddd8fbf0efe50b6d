"""Binding-table compiler + batch match kernels for the tensorized router.

This module is broker-free and pure: it turns one exchange's binding list
(the output of ``Matcher.bindings()``) into a ``CompiledExchange`` — host
dictionaries for the parts where a hash lookup already wins, and dense
tokenized matrices for the parts where a data-parallel kernel wins — and
evaluates whole publish batches against it.

Compilation strategy (driven by 1-core measurements, see BENCH_r08.json):

- **Exact patterns** (direct bindings; topic patterns without wildcards)
  stay a host dict ``routing_key -> queue names``. A dict probe is ~0.1µs;
  no kernel beats that, and a dense table over a million exact patterns
  would be a memory blowout for zero gain.
- **Always-match rows** (fanout bindings, the lone ``#`` topic pattern,
  empty x-match=all headers bindings) fold into one host set.
- **Wildcard topic patterns** and **headers bindings** become tokenized
  int32 matrices plus uint32 queue-bitmask rows, evaluated for the whole
  batch in ONE kernel call: match booleans ``[B, N]`` are expanded against
  the mask rows and OR-reduced into per-message destination bitmasks
  ``[B, mask_words]``. backend="torch" runs the hand-written CUDA match
  kernels (``kernels/router_match.py``) on the router's device, against
  tables uploaded there once per compiled snapshot; on a CPU device the
  same wrappers run their plain PyTorch versions. backend="python" runs the
  numpy kernel body below (the runtime-selectable pure-Python path).

Token encoding: literal words get vocab ids >= 0; ``STAR`` marks ``*``,
``PAD`` fills a row past its pattern's length, and message words absent
from the vocab (or past the message's length) are ``MISS``. The positional
match condition is ``(pat == tok) | (pat < 0)``: a negative pattern cell is
STAR or PAD and matches any position, while MISS (< 0 too, but only ever on
the *message* side) never equals a literal id. Length predicates do the
rest: a no-``#`` pattern needs ``m == plen``; a single-``#`` pattern splits
into a left-aligned prefix and a RIGHT-aligned suffix (compared against the
right-aligned last words of the message, so no dynamic gather is needed)
and requires ``m >= plen + slen``.

Not everything compiles. Patterns with more than one ``#``, headers
bindings with unhashable values, and tables past the wildcard/queue caps
raise ``Uncompilable`` — the caller keeps the Python matcher as the
always-available fallback for that exchange.

All array dims (pattern rows, prefix/suffix width, batch size, header
counts) are padded up to power-of-two buckets, so the set of shapes the
kernels see stays bounded as tables and batches grow.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..kernels import router_match
from .tables import tables_from_numpy

STAR = -1   # pattern cell: '*' (matches exactly one word)
PAD = -2    # pattern cell: beyond this pattern's length
MISS = -3   # message cell: out-of-vocab word, or beyond the message length

# a pattern prefix/suffix deeper than this is compiled nowhere: fall back
MAX_PATTERN_WORDS = 32

_EMPTY: frozenset = frozenset()

# decoded (mask -> names) and routed (key -> names) memo caps, per compiled
# snapshot; snapshots are immutable so entries never go stale, the cap only
# bounds memory against hostile key cardinality
_MEMO_CAP = 8192


class Uncompilable(Exception):
    """This binding table cannot be tensorized; use the Python matcher."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


def _bucket(n: int, floor: int = 4) -> int:
    """Next power-of-two >= max(n, floor): bounds distinct jit trace shapes."""
    b = floor
    while b < n:
        b <<= 1
    return b


class CompiledExchange:
    """Immutable compiled snapshot of one exchange's binding table."""

    __slots__ = ("kind", "generation", "exact", "always", "bit_names",
                 "wild", "headers", "_route_memo", "_device_tables")

    def __init__(self, kind: str, generation: int) -> None:
        self.kind = kind
        self.generation = generation
        # routing_key -> frozenset of queue names (exact patterns)
        self.exact: dict[str, frozenset] = {}
        # queues every message matches (fanout / '#' / empty x-match=all)
        self.always: frozenset = _EMPTY
        # bitmask bit index -> queue name (kernel destinations only)
        self.bit_names: tuple = ()
        self.wild: Optional[dict] = None      # topic wildcard tables
        self.headers: Optional[dict] = None   # headers-exchange tables
        # bounded result memo: topic keys it by bare routing key (the
        # match is a pure function of the key within this compiled
        # generation), headers by the kernel's mask bytes
        self._route_memo: dict = {}
        # (torch.device, tables_from_numpy(...)): the kernel table uploaded
        # once per snapshot, on the first torch-backend batch
        self._device_tables: Optional[tuple] = None

    @property
    def kernel_rows(self) -> int:
        if self.wild is not None:
            return self.wild["n"]
        if self.headers is not None:
            return self.headers["n"]
        return 0

    # -- mask decode -------------------------------------------------------

    def _decode_mask(self, row: np.ndarray) -> frozenset:
        names = []
        bit_names = self.bit_names
        for wi in range(row.shape[0]):
            w = int(row[wi])
            base = wi << 5
            while w:
                low = w & -w
                names.append(bit_names[base + low.bit_length() - 1])
                w ^= low
        return frozenset(names)


def compile_exchange(
    kind: str,
    bindings: Iterable[tuple[str, str, Optional[dict]]],
    *,
    generation: int = 0,
    max_wildcards: int = 512,
    max_queues: int = 4096,
) -> CompiledExchange:
    """Compile one exchange's ``Matcher.bindings()`` list. Raises
    ``Uncompilable`` when the table can't be tensorized faithfully."""
    kind = kind.lower()
    ce = CompiledExchange(kind, generation)
    if kind == "direct":
        exact: dict[str, set] = {}
        for key, queue, _ in bindings:
            exact.setdefault(key, set()).add(queue)
        ce.exact = {k: frozenset(v) for k, v in exact.items()}
        return ce
    if kind == "fanout":
        ce.always = frozenset(q for _, q, _ in bindings)
        return ce
    if kind == "topic":
        _compile_topic(ce, bindings, max_wildcards, max_queues)
        return ce
    if kind == "headers":
        _compile_headers(ce, bindings, max_wildcards, max_queues)
        return ce
    raise Uncompilable(f"unknown exchange type {kind!r}")


# -- topic -----------------------------------------------------------------


def _compile_topic(ce, bindings, max_wildcards: int, max_queues: int) -> None:
    exact: dict[str, set] = {}
    always: set = set()
    wild: dict[str, set] = {}  # pattern -> queues
    for key, queue, _ in bindings:
        toks = key.split(".")
        nhash = toks.count("#")
        if nhash == 0 and "*" not in toks:
            exact.setdefault(key, set()).add(queue)
        elif toks == ["#"]:
            always.add(queue)  # '#' alone matches every key
        elif nhash > 1:
            raise Uncompilable("multi-# pattern")
        else:
            wild.setdefault(key, set()).add(queue)
    ce.exact = {k: frozenset(v) for k, v in exact.items()}
    ce.always = frozenset(always)
    _build_wild_table(ce, wild, max_wildcards, max_queues)


def _build_wild_table(ce, wild: dict, max_wildcards: int,
                      max_queues: int) -> None:
    """Tokenize wildcard topic patterns (pattern -> queue-name set) into
    the kernel matrices. Shared by the single-exchange topic compile and
    the e2e closure compile (compile_effective)."""
    if not wild:
        return
    if len(wild) > max_wildcards:
        raise Uncompilable("wildcard pattern count over cap")
    bit_names = tuple(sorted({q for qs in wild.values() for q in qs}))
    if len(bit_names) > max_queues:
        raise Uncompilable("kernel queue count over cap")
    bit_of = {q: i for i, q in enumerate(bit_names)}
    vocab: dict[str, int] = {}
    rows = []
    for pattern, queues in wild.items():
        toks = pattern.split(".")
        if "#" in toks:
            hi = toks.index("#")
            pre_toks, suf_toks, has_hash = toks[:hi], toks[hi + 1:], True
        else:
            pre_toks, suf_toks, has_hash = toks, [], False
        if len(pre_toks) > MAX_PATTERN_WORDS or len(suf_toks) > MAX_PATTERN_WORDS:
            raise Uncompilable("pattern too deep")
        pre = [STAR if t == "*" else vocab.setdefault(t, len(vocab))
               for t in pre_toks]
        suf = [STAR if t == "*" else vocab.setdefault(t, len(vocab))
               for t in suf_toks]
        rows.append((pre, suf, has_hash, queues))
    n = _bucket(len(rows))
    p = _bucket(max((len(r[0]) for r in rows), default=1), 2)
    s = _bucket(max((len(r[1]) for r in rows), default=1), 2)
    mask_words = (len(bit_names) + 31) >> 5
    pre_t = np.full((n, p), PAD, dtype=np.int32)
    suf_t = np.full((n, s), PAD, dtype=np.int32)
    plen = np.zeros(n, dtype=np.int32)
    slen = np.zeros(n, dtype=np.int32)
    has_h = np.zeros(n, dtype=bool)
    masks = np.zeros((n, mask_words), dtype=np.uint32)
    for i, (pre, suf, hh, queues) in enumerate(rows):
        pre_t[i, :len(pre)] = pre
        # RIGHT-aligned: compared against the message's last-S words
        if suf:
            suf_t[i, s - len(suf):] = suf
        plen[i] = len(pre)
        slen[i] = len(suf)
        has_h[i] = hh
        for q in queues:
            b = bit_of[q]
            masks[i, b >> 5] |= np.uint32(1 << (b & 31))
        # padding rows past len(rows) keep all-zero masks: harmless
    ce.bit_names = bit_names
    ce.wild = {"n": len(rows), "vocab": vocab, "p": p, "s": s,
               "pre": pre_t, "suf": suf_t, "plen": plen, "slen": slen,
               "has_hash": has_h, "masks": masks, "mask_words": mask_words}


def compile_effective(
    exact: dict,
    always: Iterable[str],
    wild: dict,
    *,
    generation: int = 0,
    max_wildcards: int = 512,
    max_queues: int = 4096,
) -> CompiledExchange:
    """Compile a FLATTENED e2e closure (TensorRouter._closure_bindings):
    ``exact`` maps routing keys (string equality — covers direct bindings
    and wildcard-free topic patterns) to queue-name sets, ``always`` is
    the unconditional set (fanout members, lone-'#' patterns), ``wild``
    maps genuine topic wildcard patterns to queue-name sets. Compiled as
    kind "topic" because the topic evaluation path (exact dict + always +
    wildcard kernel) is the universal shape the closure folds into."""
    ce = CompiledExchange("topic", generation)
    ce.exact = {k: frozenset(v) for k, v in exact.items()}
    ce.always = frozenset(always)
    _build_wild_table(ce, dict(wild), max_wildcards, max_queues)
    return ce


def topic_match(pattern: str, key: str) -> bool:
    """One AMQP topic pattern against one concrete key, as a pure
    function ('*' = exactly one word, '#' = zero or more). Used at
    closure-compile time to evaluate hop-predicate conjunctions against
    known keys — never on the publish path."""
    pt = pattern.split(".")
    kt = key.split(".")
    memo: dict[tuple[int, int], bool] = {}

    def m(i: int, j: int) -> bool:
        got = memo.get((i, j))
        if got is not None:
            return got
        if i == len(pt):
            out = j == len(kt)
        elif pt[i] == "#":
            # zero words, or absorb one and stay on the '#'
            out = m(i + 1, j) or (j < len(kt) and m(i, j + 1))
        elif j == len(kt):
            out = False
        else:
            out = (pt[i] == "*" or pt[i] == kt[j]) and m(i + 1, j + 1)
        memo[(i, j)] = out
        return out

    return m(0, 0)


def _topic_kernel(xp, pre_t, suf_t, plen, slen, has_h, masks,
                  pre_m, suf_m, mlen):
    # [B,N,P]: positional match; a negative pattern cell (STAR/PAD) always
    # matches, and MISS on the message side never equals a literal id
    pm = (pre_t[None, :, :] == pre_m[:, None, :]) | (pre_t[None, :, :] < 0)
    sm = (suf_t[None, :, :] == suf_m[:, None, :]) | (suf_t[None, :, :] < 0)
    need = plen[None, :] + slen[None, :]
    len_ok = xp.where(has_h[None, :],
                      mlen[:, None] >= need,
                      mlen[:, None] == plen[None, :])
    ok = pm.all(axis=2) & sm.all(axis=2) & len_ok                 # [B,N]
    hit = masks[None, :, :] * ok[:, :, None].astype(xp.uint32)    # [B,N,W]
    return xp.bitwise_or.reduce(hit, axis=1)                      # [B,W]


def _tokenize_topic(wild: dict, keys: list, b: int):
    p, s, vocab = wild["p"], wild["s"], wild["vocab"]
    pre_m = np.full((b, p), MISS, dtype=np.int32)
    suf_m = np.full((b, s), MISS, dtype=np.int32)
    mlen = np.zeros(b, dtype=np.int32)
    get = vocab.get
    for i, key in enumerate(keys):
        words = key.split(".") if key else [""]
        m = len(words)
        mlen[i] = m
        for j in range(min(m, p)):
            pre_m[i, j] = get(words[j], MISS)
        for j in range(min(m, s)):
            suf_m[i, s - 1 - j] = get(words[m - 1 - j], MISS)
    return pre_m, suf_m, mlen


# -- headers ---------------------------------------------------------------


def _compile_headers(ce, bindings, max_wildcards: int, max_queues: int) -> None:
    always: set = set()
    rows = []  # (required {h: v}, is_all, queue)
    for _, queue, args in bindings:
        args = dict(args or {})
        is_all = str(args.pop("x-match", "all")).lower() != "any"
        if not args:
            if is_all:
                always.add(queue)  # empty all-binding matches everything
            continue  # empty any-binding can never match: no row
        for h, v in args.items():
            try:
                hash(v)
            except TypeError:
                raise Uncompilable("unhashable headers binding value")
        if len(args) > MAX_PATTERN_WORDS:
            raise Uncompilable("headers binding too wide")
        rows.append((args, is_all, queue))
    ce.always = frozenset(always)
    if not rows:
        return
    if len(rows) > max_wildcards:
        raise Uncompilable("headers binding count over cap")
    bit_names = tuple(sorted({q for _, _, q in rows}))
    if len(bit_names) > max_queues:
        raise Uncompilable("kernel queue count over cap")
    bit_of = {q: i for i, q in enumerate(bit_names)}
    vocab: dict[tuple, int] = {}  # (header, value) -> pair id
    n = _bucket(len(rows))
    r = _bucket(max(len(a) for a, _, _ in rows), 2)
    mask_words = (len(bit_names) + 31) >> 5
    req = np.full((n, r), PAD, dtype=np.int32)
    rcount = np.zeros(n, dtype=np.int32)
    is_all_v = np.zeros(n, dtype=bool)
    masks = np.zeros((n, mask_words), dtype=np.uint32)
    for i, (args, is_all, queue) in enumerate(rows):
        pids = [vocab.setdefault((h, v), len(vocab)) for h, v in args.items()]
        req[i, :len(pids)] = pids
        rcount[i] = len(pids)
        is_all_v[i] = is_all
        b = bit_of[queue]
        masks[i, b >> 5] |= np.uint32(1 << (b & 31))
    ce.bit_names = bit_names
    ce.headers = {"n": len(rows), "vocab": vocab, "r": r, "req": req,
                  "rcount": rcount, "is_all": is_all_v, "masks": masks,
                  "mask_words": mask_words}


def _headers_kernel(xp, req, rcount, is_all, masks, pids):
    # req [N,R] vs message pair ids pids [B,H]
    eq = req[None, :, :, None] == pids[:, None, None, :]           # [B,N,R,H]
    hitp = eq.any(axis=3) & (req[None, :, :] != PAD)               # [B,N,R]
    cnt = hitp.sum(axis=2, dtype=xp.int32)
    ok = xp.where(is_all[None, :], cnt == rcount[None, :], cnt > 0)
    hit = masks[None, :, :] * ok[:, :, None].astype(xp.uint32)
    return xp.bitwise_or.reduce(hit, axis=1)


def _tokenize_headers(table: dict, headers_list: list, b: int):
    vocab = table["vocab"]
    get = vocab.get
    per_msg = []
    hmax = 1
    for headers in headers_list:
        pids = []
        if headers:
            for h, v in headers.items():
                try:
                    pid = get((h, v))
                except TypeError:
                    continue  # unhashable message value never equals a
                    # (hashable) compiled binding value
                if pid is not None:
                    pids.append(pid)
        per_msg.append(pids)
        if len(pids) > hmax:
            hmax = len(pids)
    h = _bucket(hmax, 2)
    out = np.full((b, h), MISS, dtype=np.int32)
    for i, pids in enumerate(per_msg):
        out[i, :len(pids)] = pids
    return out


# -- batch evaluation ------------------------------------------------------

BACKENDS = ("torch", "python")


def _device_tables(compiled: CompiledExchange, table: dict,
                   device: torch.device) -> dict:
    """The snapshot's kernel table on ``device``, uploaded on first use.
    Snapshots are immutable, so the upload is valid for their lifetime."""
    cached = compiled._device_tables
    if cached is None or cached[0] != device:
        cached = compiled._device_tables = (
            device, tables_from_numpy(table, device))
    return cached[1]


def _host_rows(out: torch.Tensor) -> np.ndarray:
    # the kernels keep masks as int32 bit patterns (torch has no uint32
    # shift on the CPU); _decode_mask needs non-negative words, or its
    # `w & -w` loop never ends on a word with bit 31 set
    return out.cpu().numpy().view(np.uint32)


def route_batch(
    compiled: CompiledExchange,
    items: list,
    backend: str = "torch",
    device: "torch.device | str" = "cuda",
) -> list:
    """Route a batch through a compiled snapshot.

    ``items`` is a list of ``(routing_key, headers-or-None)``; the return
    is an aligned list of frozensets of queue names. backend="torch" runs
    the match kernels on ``device`` (the CUDA kernels on a card, their
    plain PyTorch versions on the CPU); backend="python" runs the numpy
    kernel body. A CUDA device without a card raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown router backend {backend!r}")
    kind = compiled.kind
    if kind == "fanout":
        always = compiled.always
        return [always] * len(items)
    memo = compiled._route_memo
    if kind == "direct":
        exact = compiled.exact
        return [exact.get(k, _EMPTY) for k, _ in items]

    if kind == "topic":
        # a topic result is a pure function of the routing key, so the
        # memo is keyed on the key alone: steady-state routing (bounded
        # key cardinality, the common AMQP shape) is one dict hit per
        # message and only never-seen keys pay tokenize + kernel
        wild = compiled.wild
        out = [None] * len(items)
        miss: dict = {}  # unique unseen keys -> their positions
        for i, (key, _) in enumerate(items):
            names = memo.get(key)
            if names is None:
                miss.setdefault(key, []).append(i)
            else:
                out[i] = names
        if not miss:
            return out
        if len(memo) + len(miss) >= _MEMO_CAP:
            memo.clear()
        if wild is None:
            for key, idxs in miss.items():
                names = compiled.exact.get(key, _EMPTY) | compiled.always
                memo[key] = names
                for i in idxs:
                    out[i] = names
            return out
        uniq = list(miss)
        b = _bucket(len(uniq), 16)
        pre_m, suf_m, mlen = _tokenize_topic(wild, uniq, b)
        if backend == "torch":
            device = torch.device(device)
            t = _device_tables(compiled, wild, device)
            rows = _host_rows(router_match.topic_match(
                t["pre"], t["suf"], t["plen"], t["slen"], t["has_hash"],
                t["masks"], torch.from_numpy(pre_m).to(device),
                torch.from_numpy(suf_m).to(device),
                torch.from_numpy(mlen).to(device)))
        else:
            rows = _topic_kernel(
                np, wild["pre"], wild["suf"], wild["plen"], wild["slen"],
                wild["has_hash"], wild["masks"], pre_m, suf_m, mlen)
        for j, key in enumerate(uniq):
            names = (compiled.exact.get(key, _EMPTY) | compiled.always
                     | compiled._decode_mask(rows[j]))
            memo[key] = names
            for i in miss[key]:
                out[i] = names
        return out

    if kind == "headers":
        table = compiled.headers
        if table is None:
            return [compiled.always] * len(items)
        b = _bucket(len(items), 16)
        pids = _tokenize_headers(table, [h for _, h in items], b)
        if backend == "torch":
            device = torch.device(device)
            t = _device_tables(compiled, table, device)
            rows = _host_rows(router_match.headers_match(
                t["req"], t["rcount"], t["is_all"], t["masks"],
                torch.from_numpy(pids).to(device)))
        else:
            rows = _headers_kernel(
                np, table["req"], table["rcount"], table["is_all"],
                table["masks"], pids)
        out = []
        for i in range(len(items)):
            row = rows[i]
            mk = row.tobytes()
            names = memo.get(mk)
            if names is None:
                names = compiled.always | compiled._decode_mask(row)
                if len(memo) >= _MEMO_CAP:
                    memo.clear()
                memo[mk] = names
            out.append(names)
        return out

    raise Uncompilable(f"unknown exchange type {kind!r}")
