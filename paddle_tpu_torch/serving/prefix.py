"""Prefix-aware KV reuse over the paged pool (the port's copy of
``paddle_tpu/serving/prefix.py``, DESIGN.md §21).

  * **Chained block hashes.**  A full block of ``block_size`` tokens is
    identified by ``blake2b(parent_digest || tokens)``: a block's identity
    includes its whole prefix, so two requests share a block only when
    everything before it matched too.  The root bytes and the recipe are
    the JAX package's, so the digests are equal bit for bit.
  * **Read-only mapping with refcounts.**  Matched blocks map into the
    joining slot's table as they are; the cache counts every mapping.  The
    decode cursor of a matched request starts past the shared run, so a
    shared block is never written.
  * **Copy-on-write by private recompute.**  The first divergent or partly
    covered block is never shared: the joiner recomputes it into a private
    block through the engine's decode step (``prefill_tail``).
  * **Recycle at refcount zero, LRU eviction under pressure.**  A released
    block stays cached until the pool runs dry; the engine then reclaims
    unreferenced cached blocks, least recently released first, before the
    scheduler preempts.  ``occupied ∪ free ∪ cached`` partitions the pool.

Host bookkeeping over block indices only; called under the scheduler lock.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import profiler as _profiler

#: the parent digest of block 0 for a float32 pool (the JAX package's bytes)
ROOT_DIGEST = b"paddle-tpu-prefix-root"


def root_for_kv_dtype(kv_dtype: Optional[str]) -> bytes:
    """The chain seed for a pool of ``kv_dtype``: ``ROOT_DIGEST`` for
    float32 (and unset), a root derived from it for every other dtype, so
    chains minted under one storage format never match another's."""
    if kv_dtype in (None, "", "float32"):
        return ROOT_DIGEST
    h = hashlib.blake2b(ROOT_DIGEST, digest_size=16)
    h.update(b"|kv_dtype=" + str(kv_dtype).encode())
    return h.digest()


def chain_hashes(tokens: np.ndarray, block_size: int,
                 root: bytes = ROOT_DIGEST) -> List[bytes]:
    """Chained digests of every FULL block of ``tokens``: ``h[i] =
    blake2b(h[i-1] || tokens[i*bs:(i+1)*bs] as int32 bytes)``, 16 bytes,
    with ``h[-1] = root``.  The trailing partial block has none."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    n_full = toks.size // int(block_size)
    digests: List[bytes] = []
    prev = root
    for i in range(n_full):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        digests.append(prev)
    return digests


class _Entry:
    """One cached block: its digest, its parent digest and how many live
    slots map it."""

    __slots__ = ("digest", "parent", "refs")

    def __init__(self, digest: bytes, parent: bytes):
        self.digest = digest
        self.parent = parent
        self.refs = 1  # born held by the slot that registered it


class PrefixCache:
    """Registry of reusable blocks keyed by chained hash: which pool blocks
    hold cached prefixes, the refcount of each, and an LRU order over the
    unreferenced ones.  ``counters``: hits, misses, hit_tokens, evictions
    and cow_copies (a hit whose next cached block it could not map)."""

    def __init__(self, block_size: int, kv_dtype: Optional[str] = None):
        self.block_size = int(block_size)
        self.kv_dtype = "float32" if kv_dtype in (None, "") else str(kv_dtype)
        self.root = root_for_kv_dtype(kv_dtype)
        self._by_digest: Dict[bytes, int] = {}     # digest -> block id
        self._entries: Dict[int, _Entry] = {}      # block id -> entry
        self._children: Dict[bytes, int] = {}      # parent digest -> n cached
        # refcount-zero blocks in release order: the head is evicted first
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.counters = {"hits": 0, "misses": 0, "hit_tokens": 0,
                         "evictions": 0, "cow_copies": 0}

    # -------------------------------------------------------------- queries
    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    @property
    def evictable_blocks(self) -> int:
        """Unreferenced cached blocks: reclaimable without touching a live
        slot, so admission counts them as capacity."""
        return len(self._lru)

    def refcount(self, block: int) -> int:
        e = self._entries.get(int(block))
        return 0 if e is None else e.refs

    def lookup(self, digests: Sequence[bytes],
               history_len: int) -> Tuple[List[int], bool]:
        """Longest cached run of a digest chain (pure: no counters, no LRU
        touch).  Returns ``(blocks, diverged)``: the cached block ids to
        map, and whether some cached block continues the matched chain
        that this request cannot map (the copy-on-write case).  The match
        is capped at ``(history_len - 1) // block_size``: the last history
        token is always recomputed, since its logits seed the stream."""
        cap = max((int(history_len) - 1) // self.block_size, 0)
        blocks: List[int] = []
        m = 0
        while m < min(len(digests), cap) and digests[m] in self._by_digest:
            blocks.append(self._by_digest[digests[m]])
            m += 1
        diverged = bool(m > 0 and self._children.get(digests[m - 1], 0))
        return blocks, diverged

    def match_len(self, history: np.ndarray) -> int:
        """How many leading blocks of ``history`` the cache could map."""
        history = np.asarray(history)
        return len(self.lookup(chain_hashes(history, self.block_size,
                                            root=self.root),
                               history.size)[0])

    def match(self, history: np.ndarray) -> Tuple[List[int], List[bytes],
                                                  bool]:
        """``lookup`` plus the digest chain: ``(blocks, digests,
        diverged)``.  Counting is the caller's, through ``record``."""
        history = np.asarray(history)
        digests = chain_hashes(history, self.block_size, root=self.root)
        blocks, diverged = self.lookup(digests, history.size)
        return blocks, digests, diverged

    def record(self, matched_blocks: int, diverged: bool) -> None:
        """Count one seated admission: a hit (with its tokens and the
        copy-on-write marker) or a miss."""
        if matched_blocks > 0:
            self.counters["hits"] += 1
            self.counters["hit_tokens"] += matched_blocks * self.block_size
            _profiler.incr("serving.prefix.hits")
            _profiler.incr("serving.prefix.hit_tokens",
                           matched_blocks * self.block_size)
            if diverged:
                self.counters["cow_copies"] += 1
                _profiler.incr("serving.prefix.cow_copies")
        else:
            self.counters["misses"] += 1
            _profiler.incr("serving.prefix.miss")

    # ------------------------------------------------------------ refcounts
    def acquire(self, blocks: Sequence[int]) -> None:
        """One more slot maps ``blocks``: refcount + 1 each; a block leaving
        refcount 0 stops being an eviction candidate."""
        for b in blocks:
            e = self._entries[int(b)]
            if e.refs == 0:
                self._lru.pop(int(b), None)
            e.refs += 1

    def release(self, blocks: Sequence[int]) -> None:
        """A slot let go of ``blocks``: refcount - 1 each; a block at 0
        stays cached and joins the LRU order.  Callers release in reverse
        table order, so a chain's deep blocks age out before the shallow
        ones a match walks through first.  An under-release raises."""
        for b in blocks:
            e = self._entries[int(b)]
            if e.refs <= 0:
                raise AssertionError(
                    f"prefix-cache refcount drift: release of block {b} "
                    f"already at {e.refs}")
            e.refs -= 1
            if e.refs == 0:
                self._lru[int(b)] = None

    # ------------------------------------------------------------- register
    def register(self, digest: bytes, parent: bytes, block: int) -> bool:
        """Admit a freshly written full block under ``digest``, held
        (refcount 1) by the registering slot.  False when the digest is
        already cached (the caller's block stays private) or the block is
        already tracked."""
        block = int(block)
        if digest in self._by_digest or block in self._entries:
            return False
        self._by_digest[digest] = block
        self._entries[block] = _Entry(digest, parent)
        self._children[parent] = self._children.get(parent, 0) + 1
        _profiler.gauge("serving.prefix.cached_blocks", len(self._entries))
        return True

    # -------------------------------------------------------------- evict
    def evict(self, n: int) -> List[int]:
        """Reclaim up to ``n`` unreferenced cached blocks, least recently
        released first; the caller returns them to the pool.  Never touches
        a block a live slot maps."""
        out: List[int] = []
        while len(out) < n and self._lru:
            b, _ = self._lru.popitem(last=False)
            self._forget(b)
            out.append(b)
        self.counters["evictions"] += len(out)
        if out:
            _profiler.incr("serving.prefix.evictions", len(out))
            _profiler.gauge("serving.prefix.cached_blocks",
                            len(self._entries))
        return out

    def _forget(self, block: int) -> None:
        e = self._entries.pop(block)
        self._by_digest.pop(e.digest, None)
        left = self._children.get(e.parent, 0) - 1
        if left > 0:
            self._children[e.parent] = left
        else:
            self._children.pop(e.parent, None)

    def drop_all(self) -> int:
        """Forget everything (the scheduler aborted: the arenas may hold
        half-written steps).  Returns how many blocks were dropped; none
        goes back to the free list."""
        n = len(self._entries)
        self._by_digest.clear()
        self._entries.clear()
        self._children.clear()
        self._lru.clear()
        _profiler.gauge("serving.prefix.cached_blocks", 0)
        return n

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict:
        hits = self.counters["hits"]
        misses = self.counters["misses"]
        return {
            "cached_blocks": len(self._entries),
            "evictable_blocks": len(self._lru),
            "hit_rate": hits / max(hits + misses, 1),
            **self.counters,
        }
