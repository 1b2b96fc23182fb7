"""Continuous batching over a paged KV pool for the Transformer LM (PyTorch
port of the continuous half of ``paddle_tpu/serving/decode.py``).

``ContinuousScheduler`` runs an iteration-level loop: between two decode
steps, finished or expired requests RETIRE (their blocks go back to the free
list) and waiting requests JOIN (length-tiered admission + prefill-insert
into a free slot).  ``ContinuousDecodeEngine`` holds the model, the paged
pool and the two device functions the loop calls:

  * prefill-insert — one dense causal forward over a request's history
    padded to its prompt bucket (``lm_forward``), its K/V scattered into
    the slot's blocks, and the next-token logits at the true length;
  * the windowed decode step — ``lm_paged_decode_window`` over every slot
    (inactive slots ride along with all-trash tables) followed by the
    per-slot token selection ``masked_select_tokens``.  Each layer of the
    step runs the paged decode-attention kernel once.

Each call shape (a prefill at one prompt bucket, a step at one window width,
greedy or with a sampling policy) is a SIGNATURE with static input and
output tensors.  On the card a signature is one CUDA graph, captured once
(``warm()``, or lazily at its first call) and replayed every call: the
counterpart of the reference's one compiled executable per signature.  The
arenas are written in place.  A speculative arm (``spec=True``) proposes
n-gram prompt-lookup drafts and verifies them greedily in one W-window step:
the token streams are those of the plain loop, in fewer steps.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.graphs import Graphs, Staged, WarmError
from ..models.transformer import TransformerLM
from ..models.weights import from_jax_params, torch_dtype
from ..ops import attention as _attn
from ..ops.paged_attention import check_kernel_shape
from ..ops.sampling import masked_select_tokens
from ..resilience import DeadlineExceeded
from .batcher import (AdmissionShed, DecodeAdmissionQueue,
                      build_bucket_ladder, bucket_for)
from .sampling import SamplingParams


class PagedKVPool:
    """Host-side block allocator over the device K/V arenas
    ([n_blocks + 1, L, H, block_size, Dh]; index ``n_blocks`` is the trash
    block).  Allocation and recycling are LIFO free-list pops and pushes; the
    device only ever sees the block tables each step is handed.

    ``kv_dtype="int8"`` stores K/V as symmetric int8 with float32 scale rows
    per (block, layer, head, position): ``self.k``/``self.v`` are then
    (payload, scales) pairs, quantized at scatter and dequantized at read."""

    def __init__(self, n_blocks: int, n_layers: int, n_heads: int,
                 block_size: int, head_dim: int, dtype="float32",
                 kv_dtype=None, device=None):
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.trash = self.n_blocks
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.quantized = kv_dtype == "int8"
        dev = resolve_device(device)
        if self.quantized:
            self.kv_dtype = "int8"
            self.k, self.v = _attn.init_kv_pool_quant(
                self.n_blocks, n_layers, n_heads, self.block_size, head_dim,
                device=dev)
        else:
            tdt = torch_dtype(kv_dtype if kv_dtype is not None else dtype)
            self.kv_dtype = str(tdt).replace("torch.", "")
            self.k, self.v = _attn.init_kv_pool(
                self.n_blocks, n_layers, n_heads, self.block_size, head_dim,
                tdt, device=dev)
        # LIFO free list: a just-retired request's blocks are the next
        # allocated.  The membership set lets free() reject a double-free.
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self.bad_frees = 0

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)  # ceil

    @staticmethod
    def block_bytes(n_layers: int, n_heads: int, block_size: int,
                    head_dim: int, kv_dtype: str = "float32") -> int:
        """Device bytes ONE block costs (K + V payloads plus, for int8, the
        per-head-position scale rows)."""
        if kv_dtype == "int8":
            per_pos = n_heads * (head_dim * 1 + 4)
        else:
            per_pos = n_heads * head_dim * torch_dtype(kv_dtype).itemsize
        return 2 * n_layers * block_size * per_pos

    @property
    def bytes_per_token(self) -> int:
        return self.block_bytes(self.n_layers, self.n_heads, 1,
                                self.head_dim, self.kv_dtype)

    def alloc(self, n: int):
        """``n`` block indices, or None when the pool can't cover them."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks) -> None:
        """Return blocks to the free list.  A double-free, a free of the
        trash block or an out-of-range index raises (after validating the
        whole batch) instead of corrupting the list."""
        blocks = [int(b) for b in blocks]
        seen = set()
        for b in blocks:
            bad = ("trash block" if b == self.trash
                   else "out-of-range block" if not 0 <= b < self.n_blocks
                   else "double-free" if b in self._free_set or b in seen
                   else None)
            if bad is not None:
                self.bad_frees += 1
                raise ValueError(
                    f"refused KV pool free of block {b}: {bad} "
                    f"(free list would be corrupted)")
            seen.add(b)
        self._free.extend(blocks)
        self._free_set.update(blocks)


class DecodeRequest:
    """One streaming generation request riding the continuous loop.

    Filled in by the scheduler: ``tokens`` (generated so far), ``error``
    (AdmissionShed / DeadlineExceeded / scheduler closed) and the latency
    stamps ``t_submit`` / ``t_first_token`` (TTFT) / ``t_done``, all
    ``time.perf_counter`` seconds."""

    _seq = itertools.count(1)  # next() is atomic: concurrent submits are safe

    def __init__(self, prompt, max_gen: int, eos_id: Optional[int] = None,
                 deadline=None, sampling=None):
        self.id = next(DecodeRequest._seq)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_gen = int(max_gen)
        self.eos_id = eos_id
        self.deadline = deadline  # resilience.Deadline or None
        self.sampling = sampling if sampling is not None else SamplingParams()
        self.tokens: list = []
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.enqueued_at = time.monotonic()  # refreshed by the queue's push
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.preemptions = 0

    @property
    def prompt_len(self) -> int:
        """Admission length: the prompt plus tokens generated before a
        preemption (a resumed request re-prefills its whole history)."""
        return int(self.prompt.size) + len(self.tokens)

    def history(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request retires; raises its error if it failed."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"decode request {self.id} still running")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)


class _Slot:
    """One occupied decode slot: the request, its block table (numpy row),
    the blocks it owns, and ``pos`` — the cache position its CURRENT last
    token will occupy on the next step (write-then-attend).  ``seq`` orders
    slots by insertion: under pool pressure the youngest is preempted."""

    __slots__ = ("req", "table", "blocks", "pos", "limit", "seq")

    def __init__(self, req: DecodeRequest, table, blocks, pos: int,
                 limit: int, seq: int):
        self.req = req
        self.table = table
        self.blocks = blocks
        self.pos = pos
        self.limit = limit  # original prompt + max_gen: the write budget
        self.seq = seq


class _Signature:
    """One call shape of the engine: ``key`` is ``("prefill", pb)`` or
    ``("step", W, policy)``.  ``ins`` (and ``mask``, policy steps only)
    hold the static inputs, ``logits`` and ``res`` the static outputs
    (``res`` [S, W + 1] int32: the argmax of each window row, then the
    chosen token), ``body`` the device function run on them, ``run`` that
    body prepared (``core.graphs.Prepared``: on the card its CUDA graph)."""

    __slots__ = ("key", "body", "ins", "mask", "logits", "res", "run")

    def __init__(self, key, body, ins, mask, logits, res):
        self.key, self.body, self.ins, self.mask = key, body, ins, mask
        self.logits, self.res = logits, res
        self.run = None


class ContinuousDecodeEngine:
    """The device half of continuous decode: prefill-insert and the windowed
    paged decode step over a fixed slot count.

    ``params`` is a numpy dict under the JAX names (``init_lm_params`` of
    either package, or a checkpoint).  ``device`` defaults to the CUDA card
    and raises when there is none; the CPU tests pass ``device="cpu"``.  On
    a card it raises at once, before it allocates the pool, on a window
    (``spec_window``) or head dim the paged kernel does not take; the CPU
    runs every shape on the plain versions.

    Every call runs a signature (see the module docstring): prefill per
    prompt bucket, the decode step per window width W in {1, spec_window},
    each W greedy (every row argmax) or with a sampling policy.
    ``warm()`` prepares them all; one not warmed is prepared at its first
    call.  On the card each is a CUDA graph, and a call fills its static
    inputs and replays it: a failed capture or replay raises, and nothing
    runs the steps op by op in its place.  Warm before ``start()``ing a
    scheduler's thread: a capture fails if another thread uses the card
    meanwhile.

    Counters, per call: ``step_dispatches`` (decode steps by W),
    ``prefill_dispatches`` (by prompt bucket), and on the card ``replays``
    (graph replays by signature key).  A replay adds its graph's
    paged-kernel calls to ``paged_attention.launches``, so that counter
    keeps counting the calls that ran the kernel on the device."""

    def __init__(self, params: Dict, *, vocab_size: int, max_len: int,
                 d_model: int = 512, n_heads: int = 8, n_layers: int = 6,
                 d_ff: int = 2048, tie_embeddings: bool = True,
                 dtype="float32", n_slots: int = 4, block_size: int = 16,
                 n_blocks: Optional[int] = None, prompt_buckets=None,
                 spec_window: int = 0, kv_dtype: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.n_slots = int(n_slots)
        self.block_size = int(block_size)
        self.n_tbl = -(-self.max_len // self.block_size)
        self.spec_window = int(spec_window)
        self.cd = torch_dtype(dtype)
        self.Dh = d_model // n_heads
        self.prompt_buckets = build_bucket_ladder(max_len, prompt_buckets,
                                                  base=8)
        if self.prompt_buckets[-1] < self.max_len:
            # a preempt-resumed history can grow to any length < max_len and
            # must tier somewhere
            self.prompt_buckets.append(self.max_len)
        if self.device.type == "cuda":
            # the paged kernel's limits, checked before the pool exists:
            # the widest window a step dispatches and the head dim
            check_kernel_shape(max(1, self.spec_window), self.Dh)
        if n_blocks is None:
            n_blocks = self.n_slots * self.n_tbl  # dense-equivalent capacity
        self.pool = PagedKVPool(n_blocks, n_layers, n_heads, self.block_size,
                                self.Dh, self.cd, kv_dtype=kv_dtype,
                                device=self.device)
        self.kv_dtype = self.pool.kv_dtype
        self.model = TransformerLM(
            from_jax_params(params, vocab_size=vocab_size, max_len=max_len,
                            d_model=d_model, n_heads=n_heads,
                            n_layers=n_layers, d_ff=d_ff,
                            tie_embeddings=tie_embeddings, dtype=self.cd,
                            device=self.device),
            n_heads=n_heads, n_layers=n_layers,
            tie_embeddings=tie_embeddings)
        self.step_dispatches = collections.Counter()
        self.prefill_dispatches = collections.Counter()
        self.replays = collections.Counter()
        self._samp0 = None
        self._sigs: Dict[tuple, _Signature] = {}
        self._traces = 0
        self._graphs = Graphs(self.device)

    # ---------------------------------------------------------- signatures
    def _trash_table(self) -> np.ndarray:
        return np.full(self.n_tbl, self.pool.trash, np.int32)

    def warm(self) -> int:
        """Prepare every signature the loop can hit, as the reference's
        ``warm`` (``paddle_tpu/serving/decode.py:1029``) compiles them:
        prefill per prompt bucket (``true_len`` = the bucket) and the decode
        step per W in {1, max(1, spec_window)}, against all-trash tables and
        zero limits, so warming writes only the trash block.  On the card
        each signature's body runs once eagerly on a side stream (the
        kernel library builds, cuBLAS loads), then is captured as a CUDA
        graph, all graphs in one memory pool: the engine replays one graph
        at a time, and a graph keeps nothing in the pool from one replay
        to the next (its inputs and outputs are static tensors outside
        it).  On the CPU each body runs once.

        Returns the signatures prepared by this call: ``len(prompt_buckets)
        + 2 x len({1, spec_window})``.  The reference returns
        ``len(prompt_buckets) + len({1, spec_window})``: its step always
        runs the policy pass, where this engine keeps a greedy signature
        (argmax only) beside the policy one for each W."""
        before = self._traces
        for pb in self.prompt_buckets:
            self._signature(("prefill", pb))
        for w in sorted({1, max(1, self.spec_window)}):
            for policy in (False, True):
                self._signature(("step", w, policy))
        return self._traces - before

    def trace_count(self) -> int:
        """Signatures prepared so far (graphs captured on the card, first
        runs on the CPU).  Serving after ``warm()`` never adds one."""
        return self._traces

    def _signature(self, key) -> _Signature:
        sig = self._sigs.get(key)
        return sig if sig is not None else self._prepare(key)

    def _prepare(self, key) -> _Signature:
        """Allocate ``key``'s buffers, fill them with its warm inputs and run
        its body once (CPU) or capture it (card).  Raises ``WarmError``."""
        S, V, trash = self.n_slots, self.vocab_size, self.pool.trash
        dev = self.device
        if key[0] == "prefill":
            pb = key[1]
            ins = Staged([("tokens", (1, pb), np.int32),
                           ("true_len", (1,), np.int32),
                           ("table", (self.n_tbl,), np.int32)], dev)
            ins.np["true_len"][0] = pb
            ins.np["table"][:] = trash
            sig = _Signature(key, self._prefill_body, ins, None,
                             torch.zeros(V, dtype=torch.float32, device=dev),
                             None)
        else:
            _, W, policy = key
            fields = [("toks", (S, W), np.int32), ("pos0", (S,), np.int32),
                      ("tables", (S, self.n_tbl), np.int32),
                      ("limits", (S,), np.int32)]
            if policy:
                fields += [("seeds", (S,), np.uint32),
                           ("subs", (S,), np.int32),
                           ("temps", (S,), np.float32),
                           ("topks", (S,), np.int32),
                           ("topps", (S,), np.float32)]
            ins = Staged(fields, dev)
            ins.np["tables"][:] = trash
            mask = None
            if policy:
                ins.np["topps"][:] = 1.0
                mask = Staged([("mask", (S, V), np.float32)], dev)
            sig = _Signature(key, self._step_body, ins, mask,
                             torch.zeros((S, W, V), dtype=torch.float32,
                                         device=dev),
                             torch.zeros((S, W + 1), dtype=torch.int32,
                                         device=dev))
        try:
            ins.upload()
            sig.run = self._graphs.prepare(lambda: sig.body(sig))
        except Exception as exc:  # noqa: BLE001 — re-raised as WarmError
            raise WarmError(f"preparing signature {key} failed: "
                            f"{exc}") from exc
        self._traces += 1
        self._sigs[key] = sig
        return sig

    def _dispatch(self, sig: _Signature) -> None:
        """Run ``sig`` on its staged inputs: upload them, then replay its
        graph (card) or run its body (CPU)."""
        sig.ins.upload()
        if sig.key[0] == "prefill":
            self.prefill_dispatches[sig.key[1]] += 1
        else:
            self.step_dispatches[sig.key[1]] += 1
        sig.run.replay()
        if sig.run.captured:
            self.replays[sig.key] += 1

    # ------------------------------------------------------------- bodies
    @torch.no_grad()
    def _prefill_body(self, sig: _Signature) -> None:
        """Prefill-insert on ``sig``'s buffers: a dense causal forward over
        the bucket-padded tokens, the K/V of all pb positions scattered
        through the table (positions past the allocated blocks hit trash
        via the table), then the logits at ``true_len - 1``.  Padding sits
        after every real position, so causality keeps it out of them."""
        a = sig.ins.t
        x, kvs = self.model(a["tokens"], collect_kv=True)
        t = torch.arange(a["tokens"].shape[1], device=self.device)
        blk = a["table"][torch.clamp(t // self.block_size,
                                     max=self.n_tbl - 1)]
        off = t % self.block_size
        for i, (kh, vh) in enumerate(kvs):
            # kh/vh [1, H, pb, Dh] -> window form [pb, H, Dh]
            _attn.paged_cache_set_window(self.pool.k, i, blk, off,
                                         kh[0].transpose(0, 1))
            _attn.paged_cache_set_window(self.pool.v, i, blk, off,
                                         vh[0].transpose(0, 1))
        last = x[0].index_select(0, a["true_len"] - 1)
        sig.logits.copy_(self.model.logits(last)[0])

    @torch.no_grad()
    def _step_body(self, sig: _Signature) -> None:
        """One windowed decode step over ALL slots on ``sig``'s buffers:
        the logits [S, W, V], their argmax per window row, and the token
        chosen from the first row (the policy pass, or the argmax)."""
        a = sig.ins.t
        logits, _, _ = self.model.decode_window(
            a["toks"], a["pos0"], a["tables"], a["limits"], self.pool.k,
            self.pool.v, block_size=self.block_size)
        top = torch.argmax(logits, dim=-1).to(torch.int32)
        if sig.mask is None:
            chosen = top[:, 0]  # all-greedy rows: the policy ladder's argmax
        else:
            chosen = masked_select_tokens(
                logits[:, 0, :], a["seeds"], a["subs"], a["temps"],
                a["topks"], a["topps"], sig.mask.t["mask"])
        sig.logits.copy_(logits)
        sig.res[:, :-1].copy_(top)
        sig.res[:, -1].copy_(chosen)

    # ------------------------------------------------------------- prefill
    def prefill(self, history: np.ndarray, table: np.ndarray) -> np.ndarray:
        """One request's prefill-insert: ``history`` padded to its prompt
        bucket, its per-layer K/V scattered through ``table`` into the
        arena.  Returns the first next-token logits [V] float32."""
        tl = int(history.size)
        pb = bucket_for(self.prompt_buckets, tl, what="prompt length")
        sig = self._signature(("prefill", pb))
        f = sig.ins.np
        f["tokens"][0, :tl] = history
        f["tokens"][0, tl:] = 0
        f["true_len"][0] = tl
        f["table"][:] = table
        self._dispatch(sig)
        return sig.logits.to("cpu", copy=True).numpy()

    # ------------------------------------------------------- sampling args
    def default_samp(self):
        """The all-greedy per-slot sampling arguments (seeds, substeps,
        temperature, top-k, top-p, additive mask) as numpy arrays."""
        if self._samp0 is None:
            S, V = self.n_slots, self.vocab_size
            self._samp0 = (np.zeros(S, np.uint32), np.zeros(S, np.int32),
                           np.zeros(S, np.float32), np.zeros(S, np.int32),
                           np.ones(S, np.float32),
                           np.zeros((S, V), np.float32))
        return self._samp0

    def make_samp(self):
        """A WRITABLE copy of the default samp arrays."""
        return tuple(a.copy() for a in self.default_samp())

    @staticmethod
    def set_samp_row(samp, i: int, row) -> None:
        """Write one slot's policy: ``row`` is (seed, substep, temperature,
        top_k, top_p, mask_row-or-None)."""
        seed, sub, temp, topk, topp, mask = row
        samp[0][i] = np.uint32(seed)
        samp[1][i] = np.int32(sub)
        samp[2][i] = np.float32(temp)
        samp[3][i] = np.int32(topk)
        samp[4][i] = np.float32(topp)
        if mask is not None:
            samp[5][i] = mask

    # ---------------------------------------------------------- decode step
    def _stage_step(self, toks, pos0, tables, limits, samp) -> _Signature:
        """The signature for this step (greedy when ``samp`` is None or the
        default arrays, else the policy one), with its inputs staged.  The
        [S, V] mask is uploaded only when it differs from the last one."""
        policy = samp is not None and samp is not self._samp0
        sig = self._signature(("step", int(toks.shape[1]), policy))
        f = sig.ins.np
        f["toks"][...] = toks
        f["pos0"][...] = pos0
        f["tables"][...] = tables
        f["limits"][...] = limits
        if policy:
            seeds, subs, temps, topks, topps, mask = samp
            f["seeds"][...] = seeds
            f["subs"][...] = subs
            f["temps"][...] = temps
            f["topks"][...] = topks
            f["topps"][...] = topps
            staged = sig.mask.np["mask"]
            if not np.array_equal(staged, mask):
                staged[...] = mask
                sig.mask.upload()
        return sig

    def step_full(self, toks: np.ndarray, pos0: np.ndarray,
                  tables: np.ndarray, limits: np.ndarray, samp=None):
        """One windowed decode step; returns ``(logits [S, W, V], chosen
        [S])`` as numpy — the raw logits plus the per-slot policy selection
        over the window's first position."""
        sig = self._stage_step(toks, pos0, tables, limits, samp)
        self._dispatch(sig)
        return (sig.logits.to("cpu", copy=True).numpy(),
                sig.res[:, -1].to("cpu", copy=True).numpy())

    def step_tokens(self, toks: np.ndarray, pos0: np.ndarray,
                    tables: np.ndarray, limits: np.ndarray, samp=None):
        """One windowed decode step returning only what the scheduler reads:
        ``(argmax [S, W] int32, chosen [S] int32)`` in one read back — the
        logits stay on the device."""
        sig = self._stage_step(toks, pos0, tables, limits, samp)
        self._dispatch(sig)
        res = sig.res.to("cpu", copy=True).numpy()
        return res[:, :-1], res[:, -1]

    def step(self, toks: np.ndarray, pos0: np.ndarray, tables: np.ndarray,
             limits: np.ndarray) -> np.ndarray:
        """One windowed decode step; returns argmax tokens [S, W]."""
        return self.step_tokens(toks, pos0, tables, limits)[0]

    def step_logits(self, toks: np.ndarray, pos0: np.ndarray,
                    tables: np.ndarray, limits: np.ndarray) -> np.ndarray:
        """One decode step returning the raw logits [S, W, V] (the
        teacher-forced probe)."""
        return self.step_full(toks, pos0, tables, limits)[0]

    def prefill_tail(self, tail: np.ndarray, pos0: int, table: np.ndarray,
                     limit: int, samp_row=None) -> int:
        """Write ``tail``'s K/V at cache positions ``pos0``.. through the W=1
        decode step, ``n_slots`` tokens per dispatch riding the slot axis:
        row ``j`` of a chunk carries tail token ``j`` at ``pos0 + j``, every
        row mapping the same table.  Each layer scatters all rows' K/V
        before any row attends, so row ``j`` sees rows ``< j`` of the same
        call.  Returns the token after the last tail position: the argmax,
        or the policy pick of ``samp_row`` (seed, substep, temperature,
        top_k, top_p, mask_row) applied to the last row."""
        S = self.n_slots
        tail = np.asarray(tail, np.int32).reshape(-1)
        trash = self._trash_table()
        out, chosen, n = None, None, 0
        for base in range(0, tail.size, S):
            chunk = tail[base:base + S]
            n = chunk.size
            toks = np.zeros((S, 1), np.int32)
            toks[:n, 0] = chunk
            poss = np.zeros(S, np.int32)
            poss[:n] = int(pos0) + base + np.arange(n)
            lims = np.zeros(S, np.int32)  # idle rows: limit 0 = trash writes
            lims[:n] = int(limit)
            tables = np.tile(trash, (S, 1))
            tables[:n] = table
            samp = None
            if samp_row is not None and base + n >= tail.size:
                samp = self.make_samp()
                self.set_samp_row(samp, n - 1, samp_row)
            out, chosen = self.step_tokens(toks, poss, tables, lims,
                                           samp=samp)
        return int(chosen[n - 1]) if samp_row is not None else int(
            out[n - 1, 0])

    def alloc_blocks(self, n: int):
        """Pool allocation: ``n`` blocks or None (the caller preempts)."""
        return self.pool.alloc(n)


def _ngram_draft(history: np.ndarray, width: int) -> Optional[np.ndarray]:
    """Prompt-lookup draft: find the latest earlier occurrence of the
    trailing bigram and propose the ``width`` tokens that followed it.  None
    when the history has no repeat to mine."""
    n = history.size
    if n < 3:
        return None
    a, b = history[-2], history[-1]
    hits = np.flatnonzero((history[:-2] == a) & (history[1:-1] == b))
    if hits.size == 0:
        return None
    i = int(hits[-1])
    draft = history[i + 2: i + 2 + width]
    if draft.size == 0:
        return None
    if draft.size < width:
        draft = np.concatenate(
            [draft, np.full(width - draft.size, history[-1], np.int32)])
    return draft.astype(np.int32)


class ContinuousScheduler:
    """Iteration-level scheduling over the paged pool.

    Admission seats a request when a slot is free AND the pool covers its
    prompt blocks plus a growth headroom (every live slot may need a new
    block before anything retires).  If growth still fails, the youngest
    slot is PREEMPTED back to the queue (its history re-prefills on
    re-admission; its token stream continues unchanged), so the loop never
    deadlocks on a full pool.

    ``spec=True`` turns on the speculative arm: n-gram drafts verified by
    one windowed step (greedy verification: the streams are those of the
    plain loop).

    Thread-safe: ``submit`` from any thread; drive the loop synchronously
    (``step``/``run_until_idle``) or with the background thread
    (``start``/``close``)."""

    def __init__(self, engine: ContinuousDecodeEngine, *,
                 max_wait_ms: float = 200.0, spec: bool = False):
        self.eng = engine
        self.spec = bool(spec) and engine.spec_window > 1
        self.queue = DecodeAdmissionQueue(engine.prompt_buckets,
                                          max_wait_ms=max_wait_ms)
        self._slots = [None] * engine.n_slots
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._thread = None
        self._closed = False
        self._seq = 0  # insertion order: preemption evicts the youngest
        self.counters = {"prefill_inserts": 0, "retired": 0, "sheds": 0,
                         "preemptions": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "steps": 0, "sampled": 0}
        self._snapshot: Dict = {}
        self._update_snapshot()

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_gen: int, eos_id: Optional[int] = None,
               deadline=None, sampling=None) -> DecodeRequest:
        """Queue one streaming generation; returns its request handle."""
        sp = sampling if sampling is not None else SamplingParams()
        if not isinstance(sp, SamplingParams):
            sp = SamplingParams.from_record(sp)
        if sp.beam > 1 or sp.n > 1:
            raise ValueError("beam search and parallel-n sampling are not "
                             "ported to paddle_tpu_torch yet")
        req = DecodeRequest(prompt, max_gen, eos_id=eos_id, deadline=deadline,
                            sampling=sp)
        if req.prompt.size + req.max_gen > self.eng.max_len:
            raise ValueError(
                f"prompt {req.prompt.size} + max_gen {req.max_gen} exceeds "
                f"max_len={self.eng.max_len}")
        pool = self.eng.pool
        growth = 1 + (1 if self.spec else 0)
        need = pool.blocks_for(req.prompt.size + req.max_gen)
        if need + growth > pool.n_blocks:
            # could never be seated, even alone in an empty pool
            raise ValueError(
                f"request needs {need} KV blocks (+{growth} growth "
                f"headroom) but the pool only has {pool.n_blocks}")
        if not sp.is_default:
            self.counters["sampled"] += 1
        with self._cv:
            if self._closed:
                raise RuntimeError("continuous scheduler is closed")
            self.queue.push(req)
            self._update_snapshot()
            self._cv.notify_all()
        return req

    def stats(self) -> Dict:
        """Lock-free read of the snapshot republished after every step."""
        return dict(self._snapshot)

    def run_until_idle(self, max_steps: int = 100000) -> int:
        """Drive the loop synchronously until no slot is active and nothing
        waits; returns tokens emitted."""
        total = 0
        for _ in range(max_steps):
            emitted = self.step()
            total += emitted
            with self._lock:
                idle = (not any(self._slots)) and len(self.queue) == 0
            if emitted == 0 and idle:
                break
        return total

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ContinuousScheduler":
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="continuous-decode")
                self._thread.start()
        return self

    def _loop(self):
        while True:
            with self._cv:
                if self._closed:
                    return
                if not any(self._slots) and len(self.queue) == 0:
                    self._cv.wait(timeout=0.05)
                    continue
            try:
                emitted = self.step()
            except Exception:  # noqa: BLE001
                # per-request failures never leave step(); anything that
                # did has already aborted the scheduler (every waiter and
                # live slot failed with it), so the loop ends instead of
                # stalling its submitters silently
                return
            if emitted == 0:
                with self._cv:
                    if not self._closed:
                        self._cv.wait(timeout=0.01)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._abort(RuntimeError("continuous scheduler closed"))

    def _abort(self, exc: BaseException) -> None:
        """Close the scheduler and fail every waiter and every live slot with
        ``exc``: submitters get the error, never a silent stall.  A second
        call finds nothing left to fail."""
        with self._cv:
            self._closed = True
            for req in self.queue.drain():
                req.error = exc
                req.t_done = time.perf_counter()
                req.done.set()
            for si, slot in enumerate(self._slots):
                if slot is not None:
                    self._retire(si, error=exc)
            self._update_snapshot()
            self._cv.notify_all()

    # ----------------------------------------------------------- internals
    def _update_snapshot(self):
        """Publish the dict ``stats()`` reads (callers hold the lock)."""
        active = sum(1 for s in self._slots if s is not None)
        pool = self.eng.pool
        self._snapshot = {
            "slots": self.eng.n_slots,
            "slots_active": active,
            "occupancy": active / max(self.eng.n_slots, 1),
            "waiting": len(self.queue),
            "blocks_total": pool.n_blocks,
            "blocks_free": pool.blocks_free,
            "kv_dtype": pool.kv_dtype,
            "kv_bytes_per_token": pool.bytes_per_token,
            "spec": self.spec,
            "closed": self._closed,
            **self.counters,
        }

    def check_block_accounting(self) -> Dict:
        """Assert that occupied and free blocks partition the pool (every
        block in exactly one place) and return the census."""
        pool = self.eng.pool
        with self._lock:
            free = set(pool._free)
            private = [b for s in self._slots if s is not None
                       for b in s.blocks]
            priv_set = set(private)
            assert len(private) == len(priv_set), \
                f"block owned twice: {sorted(private)}"
            assert len(free) == len(pool._free), "free list holds duplicates"
            assert not (free & priv_set), \
                f"blocks both free and occupied: {sorted(free & priv_set)}"
            union = free | priv_set
            assert union == set(range(pool.n_blocks)), \
                f"pool not partitioned: missing " \
                f"{sorted(set(range(pool.n_blocks)) - union)}"
            return {"free": len(free), "occupied": len(priv_set),
                    "leaked": pool.n_blocks - len(union)}

    def _retire(self, si: int, error: Optional[BaseException] = None):
        slot = self._slots[si]
        self._slots[si] = None
        self.eng.pool.free(slot.blocks)
        slot.req.error = error
        slot.req.t_done = time.perf_counter()
        self.counters["retired"] += 1
        slot.req.done.set()

    def _preempt(self, si: int):
        """Pool pressure: push the slot's request (with its progress) back to
        the queue, keeping its original enqueue stamp; its history
        re-prefills on re-admission."""
        slot = self._slots[si]
        self._slots[si] = None
        self.eng.pool.free(slot.blocks)
        slot.req.preemptions += 1
        self.counters["preemptions"] += 1
        self.queue.requeue(slot.req)

    def _fits(self, req) -> bool:
        need = self.eng.pool.blocks_for(req.prompt_len)
        growth = 1 + (1 if self.spec else 0)
        n_active = sum(1 for s in self._slots if s is not None)
        return self.eng.pool.blocks_free >= need + (n_active + 1) * growth

    def _samp_row_for(self, req: DecodeRequest, history) -> tuple:
        """One slot's (seed, substep, temperature, top_k, top_p, mask_row)
        for the token about to be selected; substep is the generated-token
        index, so a resumed stream replays the same draws."""
        sp = req.sampling
        mask = None
        if sp.mask_fn is not None:
            mask = sp.mask_row(history, self.eng.vocab_size)
        return (sp.seed, len(req.tokens), sp.temperature, sp.top_k,
                sp.top_p, mask)

    def _insert(self, si: int, req: DecodeRequest):
        """Seat ``req`` in slot ``si``: prefill its history and emit its
        first token.  Returns tokens emitted (1, or 0 when the request
        failed on its own), or None when allocation raced ``_fits``."""
        pool = self.eng.pool
        history = req.history()
        blocks = self.eng.alloc_blocks(pool.blocks_for(history.size))
        if blocks is None:  # _fits raced; retry next step (aging preserved)
            self.queue.requeue(req)
            return None
        table = self.eng._trash_table()
        table[:len(blocks)] = blocks
        limit = history.size + (req.max_gen - len(req.tokens))
        try:
            logits = self.eng.prefill(history, table)
            if req.sampling.is_default:
                tok = int(logits.argmax())
            else:
                # sampled first token: re-run the LAST history position
                # through the W=1 step (its K/V rewrite is identical) so the
                # selection runs the same policy pass as every later token
                tok = self.eng.prefill_tail(
                    history[-1:], history.size - 1, table, limit,
                    samp_row=self._samp_row_for(req, history))
        except WarmError:
            # the engine cannot run this shape at all: back to the queue,
            # and step() aborts the scheduler, failing every waiter
            pool.free(blocks)
            self.queue.requeue(req)
            raise
        except Exception as exc:  # noqa: BLE001 — this request's problem
            # a poisoned request costs its owner, never the loop: blocks go
            # straight back, the submitter sees ITS error
            pool.free(blocks)
            req.error = exc
            req.t_done = time.perf_counter()
            req.done.set()
            return 0
        self.counters["prefill_inserts"] += 1
        self._seq += 1
        self._slots[si] = _Slot(req, table, blocks, pos=int(history.size),
                                limit=limit, seq=self._seq)
        if req.t_first_token is None:
            req.t_first_token = time.perf_counter()
        # the prefill-emitted token is the NEXT step's input: not yet in the
        # cache, so it must not advance the write cursor
        self._emit(si, [tok], advance=False)
        return 1

    def _emit(self, si: int, toks, advance: bool = True) -> int:
        """Append emitted tokens, honoring eos and max_gen; retires the slot
        when the request completes.  ``advance`` moves the write cursor one
        position per kept token (False for the prefill-emitted token)."""
        slot = self._slots[si]
        req = slot.req
        kept = 0
        for t in toks:
            req.tokens.append(int(t))
            kept += 1
            if advance:
                slot.pos += 1
            if ((req.eos_id is not None and int(t) == req.eos_id)
                    or len(req.tokens) >= req.max_gen):
                self._retire(si)
                return kept
        return kept

    def _grow(self, si: int, upto: int) -> bool:
        """Ensure the slot's table covers cache positions < upto (capped at
        its limit).  False = pool exhausted (caller preempts)."""
        pool = self.eng.pool
        slot = self._slots[si]
        need = pool.blocks_for(min(upto, slot.limit)) - len(slot.blocks)
        if need <= 0:
            return True
        got = self.eng.alloc_blocks(need)
        if got is None:
            return False
        slot.table[len(slot.blocks):len(slot.blocks) + need] = got
        slot.blocks.extend(got)
        return True

    def step(self) -> int:
        """ONE iteration of the loop: shed expired waiters, retire expired
        rows, admit joiners (prefill-insert), then one windowed decode step
        over every occupied slot.  Returns tokens emitted."""
        with self._lock:
            if self._closed:
                return 0
            try:
                emitted = 0
                for req in self.queue.shed_expired():
                    req.error = AdmissionShed(
                        "decode request deadline expired while waiting for "
                        "a slot")
                    req.t_done = time.perf_counter()
                    self.counters["sheds"] += 1
                    req.done.set()
                for si, slot in enumerate(self._slots):
                    if (slot is not None and slot.req.deadline is not None
                            and slot.req.deadline.expired()):
                        self._retire(si, error=DeadlineExceeded(
                            "per-slot deadline expired mid-generation"))
                while True:  # admit: join between steps, never mid-step
                    free = [i for i, s in enumerate(self._slots)
                            if s is None]
                    if not free or len(self.queue) == 0:
                        break
                    req = self.queue.pop(self._fits)
                    if req is None:
                        break
                    got = self._insert(free[0], req)
                    if got is None:
                        break  # alloc raced _fits; retry next step
                    emitted += got
                active = [(i, s) for i, s in enumerate(self._slots)
                          if s is not None]
                if active:
                    emitted += self._decode_step(active)
                self.counters["steps"] += 1
                return emitted
            except Exception as exc:
                # a failure outside one request's own handling (a kernel
                # that will not build or launch, a device error): the step
                # may have half-written the arenas, so stop serving
                self._abort(exc)
                raise
            finally:
                self._update_snapshot()

    def _decode_step(self, active) -> int:
        eng = self.eng
        S = eng.n_slots
        drafts = {}
        if self.spec:
            # drafts only for greedy slots: a sampled slot's pick is a PRNG
            # draw, which greedy verification would change
            for si, slot in active:
                if not slot.req.sampling.is_default:
                    continue
                d = _ngram_draft(slot.req.history(), eng.spec_window - 1)
                if d is not None:
                    drafts[si] = d
        W = eng.spec_window if drafts else 1
        toks = np.zeros((S, W), np.int32)
        pos0 = np.zeros(S, np.int32)
        limits = np.zeros(S, np.int32)
        tables = np.tile(eng._trash_table(), (S, 1))
        stepped = []
        for si, slot in active:
            if self._slots[si] is None:
                continue  # preempted earlier in this marshal loop
            while (self._slots[si] is not None
                   and not self._grow(si, slot.pos + W)):
                # pool exhausted: evict the YOUNGEST slot not yet marshalled
                # into this step (an already-staged row would write through
                # freed blocks); a row is always its own candidate, so the
                # pool can never wedge
                victims = [j for j, s in enumerate(self._slots)
                           if s is not None and j not in stepped]
                self._preempt(max(victims,
                                  key=lambda j: self._slots[j].seq))
            if self._slots[si] is None:
                continue  # this row was itself the youngest: preempted
            toks[si, 0] = slot.req.tokens[-1]
            if si in drafts:
                toks[si, 1:] = drafts[si]
                self.counters["spec_proposed"] += W - 1
            elif W > 1:
                toks[si, 1:] = slot.req.tokens[-1]
            pos0[si] = slot.pos
            limits[si] = slot.limit
            tables[si] = slot.table
            stepped.append(si)
        if not stepped:
            return 0
        samp = None
        if any(not self._slots[si].req.sampling.is_default for si in stepped):
            samp = eng.make_samp()
            for si in stepped:
                req = self._slots[si].req
                if not req.sampling.is_default:
                    eng.set_samp_row(samp, si,
                                     self._samp_row_for(req, req.history()))
        out, chosen = eng.step_tokens(toks, pos0, tables, limits, samp=samp)
        emitted = 0
        for si in stepped:
            slot = self._slots[si]
            if not slot.req.sampling.is_default:
                # the policy pick IS the emission; sampled slots are never
                # drafted, so no window overhang is accepted
                emitted += self._emit(si, [int(chosen[si])])
                continue
            if W == 1:
                emitted += self._emit(si, [out[si, 0]])
                continue
            # greedy verify: accept the draft prefix the model agrees with,
            # then the model's own next token
            acc = 0
            while acc < W - 1 and toks[si, acc + 1] == out[si, acc]:
                acc += 1
            if si in drafts:
                self.counters["spec_accepted"] += acc
            emitted += self._emit(si, list(out[si, :acc + 1]))
        return emitted
