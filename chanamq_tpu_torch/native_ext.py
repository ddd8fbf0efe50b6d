"""ctypes bindings for the native hot paths (native/chanamq_native.cpp).

Compiles the repo checkout's native/chanamq_native.cpp on first use (with
the Makefile's flags) into the port's own git-ignored
``chanamq_tpu_torch/_build/libchanamq_native.so`` when a C++ toolchain is
present; it never writes ``native/libchanamq_native.so``, the reference's
build. Each build writes a temporary file of its own and renames it into
place, so processes building at once each load a whole library. Falls back
silently (callers keep the pure-Python implementations) when no library
can be found or built, or CHANAMQ_NATIVE=0.

Exposes:
  NativeFrameParser   — drop-in for amqp.frame.FrameParser; batches also
                        carry fused-publish triple marks (chana_scan_publish)
  NativeTopicMatcher  — drop-in for broker.matchers.TopicMatcher
  NativeEgressEncoder — batch basic.deliver encode into pooled native
                        buffers (chana_encode_deliveries + chana_pool_*)
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import time
from typing import Iterator, Optional

from . import profile
from .amqp.constants import ErrorCode
from .amqp.frame import Frame, FrameError
from .broker.matchers import Matcher

log = logging.getLogger("chanamq.native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "chanamq_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libchanamq_native.so")
# native/Makefile's compile line
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
# the loaded library carries the fused-pipeline entry points (scan_publish /
# encode_deliveries / pool). False for a stale pip-built lib predating them:
# frame scan + trie still run native, the pipeline extras fall back.
_has_pipeline = False


def _build() -> bool:
    """Compile the source into a temporary file of this process's own,
    then rename it over ``_LIB_PATH``: a concurrent build or load never
    sees a half-written library."""
    if not os.path.exists(_SRC_PATH):
        return False
    tmp = f"{_LIB_PATH}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
                        _SRC_PATH], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception as exc:
        log.info("native build unavailable: %r", exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _find_lib() -> Optional[str]:
    needs_build = not os.path.exists(_LIB_PATH) or (
        os.path.exists(_SRC_PATH)
        and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH))
    if needs_build and not _build():
        return None
    return _LIB_PATH


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it on demand. None when unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return None
    _load_attempted = True
    if os.environ.get("CHANAMQ_NATIVE", "1") in ("0", "false", "no"):
        return None
    lib_path = _find_lib()
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as exc:
        log.info("native lib load failed: %r", exc)
        return None
    lib.chana_scan_frames.restype = ctypes.c_int
    lib.chana_scan_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.chana_trie_new.restype = ctypes.c_void_p
    lib.chana_trie_free.argtypes = [ctypes.c_void_p]
    lib.chana_trie_bind.restype = ctypes.c_int
    lib.chana_trie_bind.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.chana_trie_unbind.restype = ctypes.c_int
    lib.chana_trie_unbind.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.chana_trie_route.restype = ctypes.c_int
    lib.chana_trie_route.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.chana_trie_size.restype = ctypes.c_int
    lib.chana_trie_size.argtypes = [ctypes.c_void_p]
    global _has_pipeline
    try:
        _setup_pipeline_signatures(lib)
        _has_pipeline = True
    except AttributeError:
        log.info("native lib predates the fused pipeline entry points; "
                 "scan/trie stay native, encode/pool fall back")
    _lib = lib
    log.info("native hot paths loaded from %s", lib_path)
    return _lib


def _setup_pipeline_signatures(lib: ctypes.CDLL) -> None:
    lib.chana_scan_publish.restype = ctypes.c_int
    lib.chana_scan_publish.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.chana_encode_deliveries.restype = ctypes.c_int64
    lib.chana_encode_deliveries.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.chana_encode_deliveries_packed.restype = ctypes.c_int64
    lib.chana_encode_deliveries_packed.argtypes = [
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.chana_pool_new.restype = ctypes.c_void_p
    lib.chana_pool_new.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.chana_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.chana_pool_acquire.restype = ctypes.c_int32
    lib.chana_pool_acquire.argtypes = [ctypes.c_void_p]
    lib.chana_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.chana_pool_buf.restype = ctypes.c_void_p
    lib.chana_pool_buf.argtypes = [ctypes.c_void_p, ctypes.c_int32]


def available() -> bool:
    return load() is not None


def pipeline_available() -> bool:
    """True when the loaded library has the fused-pipeline entry points."""
    return load() is not None and _has_pipeline


_MAX_FRAMES_PER_SCAN = 4096


class NativeFrameParser:
    """Drop-in FrameParser backed by the C scanner: one native call per read
    chunk instead of a Python loop per frame."""

    __slots__ = ("frame_max", "_buf", "_dead", "_lib", "_scan_publish",
                 "_types", "_channels", "_offsets", "_lengths",
                 "_pub_mark", "_body_off", "_body_len",
                 "_consumed", "_error")

    def __init__(self, frame_max: int = 0) -> None:
        self.frame_max = frame_max
        self._buf = bytearray()
        self._dead = False
        self._lib = load()
        assert self._lib is not None, "native library unavailable"
        self._scan_publish = _has_pipeline
        self._types = (ctypes.c_int32 * _MAX_FRAMES_PER_SCAN)()
        self._channels = (ctypes.c_int32 * _MAX_FRAMES_PER_SCAN)()
        self._offsets = (ctypes.c_int64 * _MAX_FRAMES_PER_SCAN)()
        self._lengths = (ctypes.c_int64 * _MAX_FRAMES_PER_SCAN)()
        # fused-publish triple marks (chana_scan_publish); stay all-zero —
        # "no fusable publish" — when the lib predates the pipeline
        self._pub_mark = (ctypes.c_int32 * _MAX_FRAMES_PER_SCAN)()
        self._body_off = (ctypes.c_int64 * _MAX_FRAMES_PER_SCAN)()
        self._body_len = (ctypes.c_int64 * _MAX_FRAMES_PER_SCAN)()
        self._consumed = ctypes.c_int64()
        self._error = ctypes.c_int32()

    def scan_batches(self, data: bytes) -> Iterator[tuple | FrameError]:
        """Scan a read chunk into frame-index batches WITHOUT creating Frame
        objects: yields ``(raw, n, types, channels, offsets, lengths,
        pub_mark, body_off, body_len)`` tuples (the arrays are reused
        between yields — consume a batch fully before advancing), then a
        FrameError if the stream is corrupt. pub_mark[i] > 0 marks a frame
        that starts a complete Basic.Publish triple the native scanner
        already validated (2 = empty body, 3 = single body frame at
        body_off/body_len). The connection hot loop walks the arrays
        directly; feed() adapts them to Frame objects for everything
        else."""
        if self._dead:
            return
        # One buffer->bytes conversion per call (NOT per scan pass — a
        # per-pass copy would be O(n^2) when a backlog accumulates); the
        # rare >_MAX_FRAMES_PER_SCAN continuation slices off the consumed
        # prefix, amortized O(1) per byte.
        if self._buf:
            self._buf += data
            raw = bytes(self._buf)
            self._buf = bytearray()
        else:
            raw = bytes(data)
        while True:
            # batch-granular cost ledger: one stamp pair per scan pass (up
            # to _MAX_FRAMES_PER_SCAN frames), accumulated inside the lazy
            # generator so the native call itself is what gets timed
            prof = profile.ACTIVE
            t_prof = time.perf_counter_ns() if prof is not None else 0
            if self._scan_publish:
                n = self._lib.chana_scan_publish(
                    raw, len(raw), self.frame_max,
                    self._types, self._channels, self._offsets,
                    self._lengths, self._pub_mark, self._body_off,
                    self._body_len,
                    _MAX_FRAMES_PER_SCAN, ctypes.byref(self._consumed),
                    ctypes.byref(self._error))
            else:
                n = self._lib.chana_scan_frames(
                    raw, len(raw), self.frame_max,
                    self._types, self._channels, self._offsets,
                    self._lengths,
                    _MAX_FRAMES_PER_SCAN, ctypes.byref(self._consumed),
                    ctypes.byref(self._error))
            if prof is not None and n:
                prof.stage_ns[profile.INGRESS_PARSE] += (
                    time.perf_counter_ns() - t_prof)
                prof.stage_calls[profile.INGRESS_PARSE] += n
            if n:
                yield (raw, n, self._types, self._channels,
                       self._offsets, self._lengths,
                       self._pub_mark, self._body_off, self._body_len)
            consumed = self._consumed.value
            error = self._error.value
            if error:
                self._dead = True
                if error == 1:
                    yield FrameError(ErrorCode.FRAME_ERROR,
                                     "unknown frame type")
                elif error == 2:
                    yield FrameError(
                        ErrorCode.FRAME_ERROR,
                        f"frame exceeds negotiated frame-max {self.frame_max}")
                else:
                    yield FrameError(ErrorCode.FRAME_ERROR,
                                     "missing frame-end octet")
                return
            if n < _MAX_FRAMES_PER_SCAN:
                if consumed < len(raw):
                    self._buf = bytearray(raw[consumed:])
                return
            raw = raw[consumed:]

    def feed(self, data: bytes) -> Iterator[Frame | FrameError]:
        for batch in self.scan_batches(data):
            if isinstance(batch, FrameError):
                yield batch
                return
            raw, n, types, channels, offsets, lengths = batch[:6]
            for i in range(n):
                off = offsets[i]
                yield Frame(types[i], channels[i], raw[off:off + lengths[i]])


class NativeTopicMatcher(Matcher):
    """Drop-in TopicMatcher routing through the C++ trie. The (pattern,
    queue) registry stays Python-side for bindings()/recovery; the trie is
    the routing fast path."""

    def __init__(self) -> None:
        lib = load()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.chana_trie_new())
        self._queue_ids: dict[str, int] = {}
        self._queue_names: dict[int, str] = {}
        self._next_id = 1
        self._patterns: dict[tuple[str, str], int] = {}
        self.binding_table = self._patterns
        # per-queue key index: queue -> its bound patterns, so unbind_queue
        # (mass teardown, 10k-tenant churn) walks its OWN bindings instead
        # of scanning every (key, queue) pair in the exchange
        self._queue_keys: dict[str, set[str]] = {}
        self._out = (ctypes.c_int32 * 4096)()

    def __del__(self) -> None:  # pragma: no cover
        try:
            if self._handle:
                self._lib.chana_trie_free(self._handle)
        except Exception:
            pass

    def _queue_id(self, queue: str) -> int:
        qid = self._queue_ids.get(queue)
        if qid is None:
            qid = self._next_id
            self._next_id += 1
            self._queue_ids[queue] = qid
            self._queue_names[qid] = queue
        return qid

    def bind(self, key: str, queue: str, arguments: Optional[dict] = None) -> bool:
        if (key, queue) in self._patterns:
            return False
        self._patterns[(key, queue)] = 1
        self._queue_keys.setdefault(queue, set()).add(key)
        self._lib.chana_trie_bind(
            self._handle, key.encode(), self._queue_id(queue))
        return True

    def unbind(self, key: str, queue: str, arguments: Optional[dict] = None) -> bool:
        if self._patterns.pop((key, queue), None) is None:
            return False
        keys = self._queue_keys.get(queue)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._queue_keys[queue]
        self._lib.chana_trie_unbind(
            self._handle, key.encode(), self._queue_id(queue))
        return True

    def unbind_queue(self, queue: str) -> int:
        # O(own bindings): pop the queue's key set up front (unbind's
        # discard then runs against the popped set, a safe no-op miss)
        keys = self._queue_keys.pop(queue, None)
        if not keys:
            return 0
        for key in keys:
            self.unbind(key, queue)
        return len(keys)

    def route(self, key: str, headers: Optional[dict] = None) -> set[str]:
        kb = key.encode()
        n = self._lib.chana_trie_route(self._handle, kb, self._out, len(self._out))
        while n > len(self._out):
            # returned count is the TOTAL match count: grow and re-route
            # instead of silently truncating at the buffer size
            self._out = (ctypes.c_int32 * max(n, len(self._out) * 2))()
            n = self._lib.chana_trie_route(
                self._handle, kb, self._out, len(self._out))
        return {self._queue_names[self._out[i]] for i in range(n)}

    def bindings(self) -> list[tuple[str, str, Optional[dict]]]:
        return [(k, q, None) for (k, q) in sorted(self._patterns)]

    def is_empty(self) -> bool:
        return not self._patterns


# per-record meta header of the packed encode blob; must mirror the layout
# chana_encode_deliveries_packed reads — canonical definition lives next to
# the pure-Python renderer in amqp.frame (imported late: this module loads
# before the package's broker imports settle)
from .amqp.frame import ENC_META as _ENC_META  # noqa: E402


class NativeEgressEncoder:
    """Batch basic.deliver encode into a native buffer pool.

    One ``chana_encode_deliveries`` call renders a whole dispatch pass's
    deliveries (method + content-header + split body frames, byte-identical
    to ServerChannel._render_deliver) into one contiguous buffer drawn from
    a reusable native arena — steady-state delivery allocates zero Python
    bytes per message. Buffers are handed to the connection writer as
    memoryview slices and returned to the pool once the kernel write
    completes (slot -1 = pool exhausted or batch oversized: the encode
    landed in a fresh bytearray instead, nothing to release).

    Single event-loop-thread use only (like everything else on the broker
    data plane): acquire/encode happen in dispatch, release in the writer
    task, both on the loop thread.
    """

    def __init__(self, pool_buffers: int = 16,
                 pool_buffer_bytes: int = 256 * 1024) -> None:
        lib = load()
        assert lib is not None and _has_pipeline, "native pipeline unavailable"
        self._lib = lib
        self.pool_buffers = pool_buffers
        self.buf_bytes = pool_buffer_bytes
        self._pool = ctypes.c_void_p(
            lib.chana_pool_new(pool_buffer_bytes, pool_buffers))
        # each arena slot wrapped ONCE as a writable view; encode() hands
        # out zero-copy slices of these
        self._views: list[memoryview] = []
        self._ptrs: list = []
        for slot in range(pool_buffers):
            ptr = lib.chana_pool_buf(self._pool, slot)
            arr = (ctypes.c_ubyte * pool_buffer_bytes).from_address(ptr)
            self._views.append(memoryview(arr))
            self._ptrs.append(ctypes.cast(
                ctypes.c_void_p(ptr), ctypes.POINTER(ctypes.c_uint8)))

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        try:
            self._views.clear()
            if self._pool:
                self._lib.chana_pool_destroy(self._pool)
                self._pool = ctypes.c_void_p()
        except Exception:
            pass

    def encode_packed(self, parts: list, n: int, frame_max: int,
                      nbytes: int):
        """Encode a pre-packed parts list (the connection's egress buffer:
        ``meta, prefix, exrk, header, body`` per record, meta from
        ``_ENC_META``) into one wire buffer of exactly ``nbytes``. One
        b"".join and one lib call per batch — the per-record marshalling
        happened incrementally at egress_deliver time. Returns the same
        ``(buffer, slot)`` / None contract as encode()."""
        blob = b"".join(parts)
        slot = -1
        if nbytes <= self.buf_bytes:
            slot = self._lib.chana_pool_acquire(self._pool)
        if slot >= 0:
            view = self._views[slot]
            out = self._ptrs[slot]
            written = self._lib.chana_encode_deliveries_packed(
                n, blob, len(blob), frame_max, out, self.buf_bytes)
            if written != nbytes:
                self._lib.chana_pool_release(self._pool, slot)
                return None
            return view[:nbytes], slot
        heap = bytearray(nbytes)
        out = (ctypes.c_uint8 * nbytes).from_buffer(heap)
        written = self._lib.chana_encode_deliveries_packed(
            n, blob, len(blob), frame_max, out, nbytes)
        del out  # drop the exported buffer so the bytearray is usable
        if written != nbytes:
            return None
        return heap, -1

    def encode(self, records: list, frame_max: int, nbytes: int):
        """Encode ``(channel_id, prefix, tag, redelivered, exrk, header,
        body)`` records into one wire buffer of exactly ``nbytes`` (the
        caller pre-computed the wire size). Returns ``(buffer, slot)`` —
        a pooled memoryview slice (release(slot) after the kernel write)
        or a fresh bytearray with slot -1 — or None if the native encode
        disagreed with the expected size (caller falls back to Python
        rendering; defensive, never expected)."""
        # one packed meta+payload blob per batch: a single c_char_p
        # conversion at the call boundary (per-element c_char_p stores
        # cost more than the whole Python fallback encode)
        pack = _ENC_META.pack
        parts = []
        for cid, prefix, tag, red, exrk, header, body in records:
            parts += (
                pack(cid, tag, 1 if red else 0, len(prefix), len(exrk),
                     len(header), len(body)),
                prefix, exrk, header, body)  # join takes memoryviews too
        return self.encode_packed(parts, len(records), frame_max, nbytes)

    def release(self, slot: int) -> None:
        self._lib.chana_pool_release(self._pool, slot)


_EGRESS_ENCODER: Optional[NativeEgressEncoder] = None


def egress_encoder(pool_buffers: int = 16,
                   pool_buffer_kb: int = 256) -> Optional[NativeEgressEncoder]:
    """Process-wide encoder + pool singleton (brokers share one loop thread
    per process; the first caller's sizing wins and later callers reuse the
    arena instead of re-allocating it per Broker). None when the native
    pipeline is unavailable or CHANAMQ_NATIVE_EGRESS=0."""
    global _EGRESS_ENCODER
    if not pipeline_available():
        return None
    if os.environ.get("CHANAMQ_NATIVE_EGRESS", "1") in ("0", "false", "no"):
        return None
    if _EGRESS_ENCODER is None:
        _EGRESS_ENCODER = NativeEgressEncoder(
            pool_buffers, pool_buffer_kb * 1024)
    return _EGRESS_ENCODER
