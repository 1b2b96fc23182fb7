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

The scheduler also carries the reference's serving extras:
  * the prefix cache (``prefix_cache=True``, ``serving/prefix.py``): a
    joiner maps the cached blocks of its prompt's longest cached run
    read-only and recomputes only its tail through the warmed step
    (``prefill_tail``);
  * beam search (``SamplingParams(beam=K)``) and parallel-n sampling
    (``n=N``) as forks over copy-on-write blocks: a fork acquires the
    parent's full blocks and recomputes its partial block privately;
  * migration: ``snapshot_slots(drain=True)`` hands out resume records and
    ``submit(resume_prefix=...)`` continues them elsewhere.
None of them prepares a new signature: a hit, a fork or a resume runs the
warmed prefill and step graphs.  ``DecodeEngine`` is the dense engine
(batch-as-unit over static per-batch caches), the greedy oracle and A/B
baseline of the reference.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import profiler as _profiler
from .._device import resolve_device
from ..core.graphs import Graphs, Prepared, Staged, WarmError, sync
from ..layers import beam as _beam
from ..models.transformer import (TransformerLM, lm_decode_step,
                                  paged_window_coords)
from ..models.weights import from_jax_params, torch_dtype
from ..obs import prof as _prof
from ..obs import trace as _trace
from ..ops import attention as _attn
from ..ops.paged_attention import check_kernel_shape
from ..ops.sampling import masked_select_tokens
from ..resilience import DeadlineExceeded, faults
from .batcher import (AdmissionShed, DecodeAdmissionQueue,
                      build_bucket_ladder, bucket_for)
from .prefix import PrefixCache, chain_hashes
from .sampling import SamplingParams


class GenerationMigrated(RuntimeError):
    """The generation was snapshot off this scheduler for migration
    (``snapshot_slots(drain=True)``): its resume record (prompt, tokens so
    far, budget, remaining deadline) continues it elsewhere through
    ``submit(resume_prefix=...)``.  Local waiters see this error, so
    nothing blocks on a drained scheduler."""


class _ForkFailed(RuntimeError):
    """A beam branch fork could not seat (the pool exhausted even after
    preemption).  Internal: the scheduler fails the whole group."""


class _Signature:
    """One call shape of an engine: ``key`` names it (``("prefill", pb)``
    or ``("step", W, policy)`` for the continuous engine, ``("prefill",
    nb, pb)``, ``("step", nb)`` or ``("naive", nb, tb)`` for the dense
    one).  ``ins`` (and ``mask``, policy steps only) hold the static
    inputs, ``logits`` and ``res`` the static outputs, ``body`` the device
    function run on them, ``run`` that body prepared
    (``core.graphs.Prepared``: on the card its CUDA graph)."""

    __slots__ = ("key", "body", "ins", "mask", "logits", "res", "run",
                 "local", "prof_key")

    def __init__(self, key, body, ins, mask, logits, res):
        self.key, self.body, self.ins, self.mask = key, body, ins, mask
        self.logits, self.res = logits, res
        self.run = None
        self.prof_key = None  # the continuous engine's timing/ledger key
        # a data-sharded step's own rows: logits, res and the new K/V
        # (ContinuousDecodeEngine with a mesh), gathered after the body
        self.local = None


class DecodeEngine:
    """Greedy KV-cached generation over dense per-batch caches (the port of
    the reference's batch-as-unit ``DecodeEngine``): a batch is admitted as
    a unit, its prompts padded to a prompt bucket and the batch to a batch
    bucket.  The greedy oracle and the A/B baseline of the continuous
    engine.

    Signatures, each a CUDA graph on the card (``warm()``, or at its first
    call) replayed by every later call, the body run on static buffers on
    the CPU: ``("prefill", nb, pb)`` (a causal forward over the padded
    prompts filling the caches' first pb positions; the true length is a
    staged input), ``("step", nb)`` (``lm_decode_step`` at a staged
    position) and ``("naive", nb, tb)`` (the full-recompute arm).  Each
    batch bucket owns one pair of caches [nb, L, H, max_len, Dh], written
    in place.  A failed capture or replay raises.  Counters:
    ``dispatches`` and ``replays`` by signature key.  ``generate`` and
    ``generate_naive`` hold one lock per engine (the caches and the
    signatures' buffers are static), so concurrent calls are serialised."""

    def __init__(self, params: Dict, *, vocab_size: int, max_len: int,
                 d_model: int = 512, n_heads: int = 8, n_layers: int = 6,
                 d_ff: int = 2048, tie_embeddings: bool = True,
                 dtype="float32", prompt_buckets=None,
                 batch_buckets=(1, 8), device=None):
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.cd = torch_dtype(dtype)
        self.Dh = d_model // n_heads
        self.prompt_buckets = build_bucket_ladder(max_len, prompt_buckets,
                                                  base=8)
        self.batch_buckets = build_bucket_ladder(max(batch_buckets),
                                                 batch_buckets)
        self.model = TransformerLM(
            from_jax_params(params, vocab_size=vocab_size, max_len=max_len,
                            d_model=d_model, n_heads=n_heads,
                            n_layers=n_layers, d_ff=d_ff,
                            tie_embeddings=tie_embeddings, dtype=self.cd,
                            device=self.device),
            n_heads=n_heads, n_layers=n_layers,
            tie_embeddings=tie_embeddings)
        self.caches: Dict[int, tuple] = {}   # batch bucket -> (ck, cv)
        self.dispatches = collections.Counter()
        self.replays = collections.Counter()
        self._sigs: Dict[tuple, _Signature] = {}
        self._traces = 0
        self._graphs = Graphs(self.device)
        self._lock = threading.RLock()

    # ---------------------------------------------------------- signatures
    def trace_count(self) -> int:
        """Signatures prepared so far."""
        return self._traces

    @property
    def cache_bytes(self) -> int:
        """Device bytes of the dense K and V caches allocated so far."""
        return sum(2 * ck.numel() * ck.element_size()
                   for ck, _ in self.caches.values())

    def _cache(self, nb: int) -> tuple:
        if nb not in self.caches:
            self.caches[nb] = _attn.init_kv_cache(
                nb, self.n_layers, self.n_heads, self.max_len, self.Dh,
                self.cd, device=self.device)
        return self.caches[nb]

    def _signature(self, key) -> _Signature:
        sig = self._sigs.get(key)
        return sig if sig is not None else self._prepare(key)

    def _prepare(self, key) -> _Signature:
        V, dev = self.vocab_size, self.device
        nb = key[1]
        if key[0] == "prefill":
            ins = Staged([("tokens", (nb, key[2]), np.int32),
                          ("true_len", (1,), np.int32)], dev)
            ins.np["true_len"][0] = key[2]
            body = self._prefill_body
        elif key[0] == "step":
            ins = Staged([("token", (nb,), np.int32),
                          ("pos", (1,), np.int32)], dev)
            body = self._step_body
        else:
            ins = Staged([("tokens", (nb, key[2]), np.int32),
                          ("cur_len", (1,), np.int32)], dev)
            ins.np["cur_len"][0] = 1
            body = self._naive_body
        self._cache(nb)
        sig = _Signature(key, body, ins, None,
                         torch.zeros((nb, V), dtype=torch.float32,
                                     device=dev),
                         torch.zeros(nb, dtype=torch.int32, device=dev))
        try:
            ins.upload()
            sig.run = self._graphs.prepare(lambda: sig.body(sig))
        except Exception as exc:  # noqa: BLE001 — re-raised as WarmError
            raise WarmError(f"preparing signature {key} failed: "
                            f"{exc}") from exc
        self._traces += 1
        if key[0] != "naive":  # the reference counts prefill and step only
            _profiler.incr("serving.decode_traces")
        self._sigs[key] = sig
        return sig

    def _dispatch(self, sig: _Signature) -> None:
        sig.ins.upload()
        self.dispatches[sig.key] += 1
        sig.run.replay()
        if sig.run.captured:
            self.replays[sig.key] += 1

    def _finish(self, sig: _Signature, x_last: torch.Tensor) -> None:
        logits = self.model.logits(x_last)
        sig.logits.copy_(logits)
        sig.res.copy_(torch.argmax(logits, dim=-1).to(torch.int32))

    @torch.no_grad()
    def _prefill_body(self, sig: _Signature) -> None:
        """Causal forward over the padded prompts; their K/V into the
        caches' first pb positions; the logits at ``true_len - 1``."""
        a = sig.ins.t
        ck, cv = self.caches[sig.key[1]]
        x, kvs = self.model(a["tokens"], collect_kv=True)
        for i, (kh, vh) in enumerate(kvs):
            _attn.cache_set_prefix(ck, i, kh)
            _attn.cache_set_prefix(cv, i, vh)
        self._finish(sig, x.index_select(1, (a["true_len"] - 1).long())[:, 0])

    @torch.no_grad()
    def _step_body(self, sig: _Signature) -> None:
        """``lm_decode_step`` at the staged position."""
        a = sig.ins.t
        ck, cv = self.caches[sig.key[1]]
        m = self.model
        logits, _, _ = lm_decode_step(
            m.prm, a["token"], a["pos"], ck, cv, n_heads=m.n_heads,
            n_layers=m.n_layers, cd=m.cd, tie_embeddings=m.tie_embeddings)
        sig.logits.copy_(logits)
        sig.res.copy_(torch.argmax(logits, dim=-1).to(torch.int32))

    @torch.no_grad()
    def _naive_body(self, sig: _Signature) -> None:
        """Full recompute over the whole buffer, logits at cur_len - 1."""
        a = sig.ins.t
        x, _ = self.model(a["tokens"])
        self._finish(sig, x.index_select(1, (a["cur_len"] - 1).long())[:, 0])

    def warm(self, prompt_len: Optional[int] = None) -> int:
        """Prepare prefill for every (batch bucket, prompt bucket), or only
        the prompt bucket covering ``prompt_len``, and the step per batch
        bucket.  Returns the signatures prepared by this call."""
        before = self._traces
        pls = ([bucket_for(self.prompt_buckets, prompt_len, what="prompt")]
               if prompt_len is not None else self.prompt_buckets)
        for nb in self.batch_buckets:
            for pb in pls:
                self._signature(("prefill", nb, pb))
            self._signature(("step", nb))
        return self._traces - before

    # -------------------------------------------------------------- generate
    def _check_len(self, Tp: int, max_gen: int) -> None:
        if Tp + max_gen > self.max_len:
            raise ValueError(f"prompt {Tp} + max_gen {max_gen} exceeds the "
                             f"cache size max_len={self.max_len}")

    def _run_prefill(self, prompts: np.ndarray) -> _Signature:
        """Stage and dispatch the prefill of ``prompts`` [N, Tp]; returns
        its signature (``res`` the first greedy tokens)."""
        N, Tp = prompts.shape
        nb = bucket_for(self.batch_buckets, N, what="batch")
        pb = bucket_for(self.prompt_buckets, Tp, what="prompt length")
        sig = self._signature(("prefill", nb, pb))
        buf = sig.ins.np["tokens"]
        buf[...] = 0
        buf[:N, :Tp] = prompts
        buf[N:, :Tp] = prompts[:1]  # batch pad rows: real tokens, sliced away
        sig.ins.np["true_len"][0] = Tp
        self._dispatch(sig)
        return sig

    def generate(self, prompts: np.ndarray, max_gen: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy decode: prompts [N, Tp] int32 (one length) -> tokens
        [N, max_gen].  Rows that emitted ``eos_id`` keep their output."""
        with self._lock:
            return self._generate(prompts, max_gen, eos_id)

    def _generate(self, prompts, max_gen, eos_id):
        prompts = np.asarray(prompts, np.int32)
        N, Tp = prompts.shape
        self._check_len(Tp, max_gen)
        nb = bucket_for(self.batch_buckets, N, what="batch")
        with _trace.span("serving.decode_prefill", batch=nb,
                         prompt_bucket=bucket_for(self.prompt_buckets, Tp,
                                                  what="prompt length")):
            sig = self._run_prefill(prompts)
        out = np.zeros((nb, max_gen), np.int32)
        done = np.zeros(nb, bool)
        tok = sig.res.to("cpu", copy=True).numpy()
        step = self._signature(("step", nb))
        with _trace.span("serving.decode_loop", batch=nb, max_gen=max_gen):
            for i in range(max_gen):
                out[~done, i] = tok[~done]
                if eos_id is not None:
                    done |= tok == eos_id
                    if done[:N].all():
                        break
                if i == max_gen - 1:
                    break
                step.ins.np["token"][...] = tok
                step.ins.np["pos"][0] = Tp + i
                self._dispatch(step)
                tok = step.res.to("cpu", copy=True).numpy()
        return out[:N]

    def generate_naive(self, prompts: np.ndarray, max_gen: int,
                       eos_id: Optional[int] = None) -> np.ndarray:
        """Full-recompute greedy decode (the A/B baseline): every token pays
        a whole forward over the token buffer."""
        with self._lock:
            return self._generate_naive(prompts, max_gen, eos_id)

    def _generate_naive(self, prompts, max_gen, eos_id):
        prompts = np.asarray(prompts, np.int32)
        N, Tp = prompts.shape
        self._check_len(Tp, max_gen)
        nb = bucket_for(self.batch_buckets, N, what="batch")
        tb = bucket_for(self.prompt_buckets + [self.max_len], Tp + max_gen,
                        what="sequence")
        sig = self._signature(("naive", nb, tb))
        buf = sig.ins.np["tokens"]
        buf[...] = 0
        buf[:N, :Tp] = prompts
        buf[N:, :Tp] = prompts[:1]
        out = np.zeros((nb, max_gen), np.int32)
        done = np.zeros(nb, bool)
        for i in range(max_gen):
            sig.ins.np["cur_len"][0] = Tp + i
            self._dispatch(sig)
            tok = sig.res.to("cpu", copy=True).numpy()
            out[~done, i] = tok[~done]
            buf[:, Tp + i] = tok
            if eos_id is not None:
                done |= tok == eos_id
                if done[:N].all():
                    break
        return out[:N]

    def measure(self, batch: int, prompt_len: int, max_gen: int,
                repeats: int = 1) -> Dict:
        """Tokens/s of the prefill, the KV-cached decode and the naive
        full-recompute arm over the same random prompts (every signature
        prepared first, so the times hold no capture)."""
        rng = np.random.RandomState(0)
        prompts = rng.randint(2, self.vocab_size,
                              (batch, prompt_len)).astype(np.int32)
        self.warm(prompt_len)
        nb = bucket_for(self.batch_buckets, batch, what="batch")
        self._signature(("naive", nb, bucket_for(
            self.prompt_buckets + [self.max_len], prompt_len + max_gen,
            what="sequence")))
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            sig = self._run_prefill(prompts)
        sig.res.to("cpu")
        prefill_s = (time.perf_counter() - t0) / repeats
        t0 = time.perf_counter()
        kv_tokens = self.generate(prompts, max_gen)
        kv_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        naive_tokens = self.generate_naive(prompts, max_gen)
        naive_s = time.perf_counter() - t0
        return {
            "batch": batch, "prompt_len": prompt_len, "max_gen": max_gen,
            "prefill_tokens_per_sec": batch * prompt_len / prefill_s,
            "kv_decode_tokens_per_sec": batch * max_gen / kv_s,
            "naive_decode_tokens_per_sec": batch * max_gen / naive_s,
            "kv_vs_naive_speedup": naive_s / kv_s,
            "tokens_match": bool((kv_tokens == naive_tokens).all()),
        }


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

    @property
    def arena_bytes(self) -> int:
        """Device bytes of the allocatable arena (the trash block is
        overhead, not capacity)."""
        return self.n_blocks * self.block_bytes(
            self.n_layers, self.n_heads, self.block_size, self.head_dim,
            self.kv_dtype)

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
                _profiler.incr("serving.decode.bad_frees")
                raise ValueError(
                    f"refused KV pool free of block {b}: {bad} "
                    f"(free list would be corrupted)")
            seen.add(b)
        self._free.extend(blocks)
        self._free_set.update(blocks)


class DecodeRequest:
    """One streaming generation request riding the continuous loop.

    Filled in by the scheduler: ``tokens`` (generated so far), ``error``
    (AdmissionShed / DeadlineExceeded / GenerationMigrated / scheduler
    closed) and the latency stamps ``t_submit`` / ``t_first_token`` (TTFT)
    / ``t_done``, all ``time.perf_counter`` seconds.  ``fork_of`` marks a
    parallel-n branch (the root's id) and ``branches`` on a parallel-n root
    lists [root, *children]; a beam request's ranked results land in
    ``beams`` / ``beam_scores`` / ``beam_lens``.  ``cold_resume`` marks a
    resume record from a pool of another kv_dtype: its admission maps and
    registers nothing in the prefix cache."""

    _seq = itertools.count(1)  # next() is atomic: concurrent submits are safe

    def __init__(self, prompt, max_gen: int, eos_id: Optional[int] = None,
                 deadline=None, sampling=None):
        self.id = next(DecodeRequest._seq)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_gen = int(max_gen)
        self.eos_id = eos_id
        self.deadline = deadline  # resilience.Deadline or None
        self.sampling = sampling if sampling is not None else SamplingParams()
        self.fork_of: Optional[int] = None
        self.branches: Optional[list] = None
        self.beams: Optional[list] = None
        self.beam_scores: Optional[list] = None
        self.beam_lens: Optional[list] = None
        self.tokens: list = []
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.enqueued_at = time.monotonic()  # refreshed by the queue's push
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.preemptions = 0
        # (prompt_len, digest chain): the history is fixed while the
        # request waits, so admission hashes it once
        self._digest_memo = None
        self.cold_resume = False

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
    the blocks it maps, and ``pos`` — the cache position its CURRENT last
    token will occupy on the next step (write-then-attend).  ``seq`` orders
    slots by insertion: under pool pressure the youngest is preempted.
    ``cached`` is the subset of ``blocks`` the prefix cache tracks
    (released by refcount, not freed).  ``group`` binds a beam branch to
    its ``_BeamGroup`` (never retired or preempted alone); a ``parked``
    branch (done or pruned) holds no blocks and is not stepped, but keeps
    its slot so that the group always owns K slots."""

    __slots__ = ("req", "table", "blocks", "pos", "limit", "seq", "cached",
                 "group", "parked")

    def __init__(self, req: DecodeRequest, table, blocks, pos: int,
                 limit: int, seq: int, cached=frozenset(), group=None):
        self.req = req
        self.table = table
        self.blocks = blocks
        self.pos = pos
        self.limit = limit  # original prompt + max_gen: the write budget
        self.seq = seq
        self.cached = set(cached)
        self.group = group
        self.parked = False


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
    keeps counting the calls that ran the kernel on the device.

    ``prefix_cache=True`` gives the engine a ``PrefixCache`` (``prefix``),
    seeded with the pool's kv_dtype so that an int8 pool never matches a
    float32 digest; ``alloc_blocks`` then evicts unreferenced cached
    blocks before it reports a dry pool.

    ``mesh``: a ``serving.mesh.ServingMesh`` over the ranks of a process
    group (SPMD: every rank builds this engine and runs the same scheduler
    over the same requests, and every rank ends each call with the same
    tokens).  A one-device ServingMesh (``mesh.mesh is None``) takes the
    exact single-device path.  Otherwise the model runs on
    ``serving.mesh.ShardedParams``, the rank's parameter shards (fsdp
    gathered at use, tp column / row / vocab parallel) and the pool holds
    the rank's ``H / tp`` heads when ``heads_shardable`` (an int8 pool:
    its payload and its float32 scale plane alike, as the reference's
    ``paddle_tpu/serving/decode.py:336-346``; a ``kv_dtype`` other than
    the compute dtype is taken as on one device).  Over ``data`` (when it
    divides ``n_slots``) a step runs the rank's slots' rows; after the
    body, outside any graph, the logits, the chosen tokens and each
    layer's new K/V rows (in the pool's dtype; int8 payload and scales)
    are all-gathered over data and the other ranks' rows scattered into
    this rank's arena, so every arena holds every slot's blocks (a prefix hit, a fork or a migration reads blocks
    another slot wrote).  ``prefill_tail`` then puts at most ``n_slots /
    data`` runs in a call, all on the first data rank's rows, since a run
    reads the runs before it in the same call.  Prefill runs replicated
    over data.  ``warm()`` captures a data-only mesh's bodies; with tp or
    fsdp above 1 the collectives lie inside the body, which gloo cannot
    capture, so ``warm()`` raises ``WarmError`` before any capture and
    every call runs its body eagerly."""

    def __init__(self, params: Dict, *, vocab_size: int, max_len: int,
                 d_model: int = 512, n_heads: int = 8, n_layers: int = 6,
                 d_ff: int = 2048, tie_embeddings: bool = True,
                 dtype="float32", n_slots: int = 4, block_size: int = 16,
                 n_blocks: Optional[int] = None, prompt_buckets=None,
                 spec_window: int = 0, kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.mesh is not None
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
        pool_heads = n_heads
        # rows a step runs here (the slots of this data rank), the first of
        # them, and whether the body holds collectives (tp, fsdp)
        self._rows, self._row0, self._eager = self.n_slots, 0, False
        if self._sharded:
            from .mesh import DATA_AXIS, FSDP_AXIS, TP_AXIS

            data = mesh.axis(DATA_AXIS)
            if data > 1 and self.n_slots % data == 0:
                self._rows = self.n_slots // data
                self._row0 = mesh.coord(DATA_AXIS) * self._rows
            self._eager = mesh.axis(TP_AXIS) > 1 or mesh.axis(FSDP_AXIS) > 1
            if mesh.heads_shardable(n_heads):
                pool_heads = n_heads // mesh.axis(TP_AXIS)
        self.pool = PagedKVPool(n_blocks, n_layers, pool_heads,
                                self.block_size, self.Dh, self.cd,
                                kv_dtype=kv_dtype, device=self.device)
        self.kv_dtype = self.pool.kv_dtype
        if self.pool.quantized:
            _profiler.gauge("serving.quant.bytes_per_token",
                            self.pool.bytes_per_token)
            _profiler.gauge("serving.quant.slots_per_gib",
                            self.slots_resident_per_gib())
        # 1: the paged CUDA kernel runs the attention; 0: the CPU's plain
        # version (there is no fallback: a card that cannot run the kernel
        # raises, so serving.pallas.fallbacks is never emitted)
        _profiler.gauge("serving.decode.kernel_impl",
                        1 if self.device.type == "cuda" else 0)
        # model identity for the cost-ledger fingerprints and the scope of
        # this engine's dispatch-timing keys (two engines in one process
        # must not merge timing rows), the reference's recipe
        self._model_desc = (f"paged_decode(V={vocab_size},T={self.max_len},"
                            f"d={d_model},H={n_heads},L={n_layers},"
                            f"ff={d_ff},S={self.n_slots},"
                            f"Bs={self.block_size},kv={kv_dtype or dtype},"
                            f"tie={tie_embeddings})")
        import hashlib

        self._sig_scope = hashlib.sha1(
            self._model_desc.encode()).hexdigest()[:8]
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.block_size, kv_dtype=self.kv_dtype)
            if prefix_cache else None)
        prm = from_jax_params(params, vocab_size=vocab_size, max_len=max_len,
                              d_model=d_model, n_heads=n_heads,
                              n_layers=n_layers, d_ff=d_ff,
                              tie_embeddings=tie_embeddings, dtype=self.cd,
                              device=self.device)
        heads, shard = n_heads, None
        if self._sharded:
            from .mesh import ShardedParams

            prm = ShardedParams(prm, mesh, n_heads)
            heads, shard = prm.heads, prm.shard
        self.model = TransformerLM(prm, n_heads=heads, n_layers=n_layers,
                                   tie_embeddings=tie_embeddings, cd=self.cd,
                                   head_dim=self.Dh, shard=shard)
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
        (argmax only) beside the policy one for each W.

        With a mesh whose tp or fsdp is above 1, raises ``WarmError``
        before any capture (the body's collectives; see the class
        docstring)."""
        if self._eager:
            raise WarmError(
                "warm(): this engine's mesh shards tp or fsdp, so its step "
                "and prefill hold collectives, which a gloo group cannot "
                "capture in a CUDA graph; every call runs its body eagerly "
                "(ROADMAP A.9 part 3)")
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
            if self._rows < S:
                R, pool = self._rows, self.pool
                kv = (pool.n_layers, R, W, pool.n_heads, pool.head_dim)
                sig.local = {
                    "logits": torch.zeros((R, W, V), dtype=torch.float32,
                                          device=dev),
                    "res": torch.zeros((R, W + 1), dtype=torch.int32,
                                       device=dev),
                    "k": torch.zeros(kv, dtype=self.cd, device=dev),
                    "v": torch.zeros(kv, dtype=self.cd, device=dev)}
        sig.prof_key = self._prof_key(key)
        try:
            ins.upload()
            t0 = time.perf_counter()
            if self._eager:
                # collectives in the body: run eagerly at every call
                sig.run = Prepared(lambda: sig.body(sig))
            else:
                sig.run = self._graphs.prepare(lambda: sig.body(sig),
                                               count=True)
            ms = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # noqa: BLE001 — re-raised as WarmError
            raise WarmError(f"preparing signature {key} failed: "
                            f"{exc}") from exc
        self._traces += 1
        _profiler.incr("serving.decode_traces")
        if sig.run.cost is not None:
            kind = "decode_prefill" if key[0] == "prefill" else "decode_step"
            _prof.register(
                _prof.fingerprint(kind, sig.prof_key, self._model_desc,
                                  [self.cd, self.pool.kv_dtype]),
                label=f"{kind} {key}", sig_key=sig.prof_key, source="live",
                compile_ms=ms, cost=sig.run.cost)
        self._sigs[key] = sig
        return sig

    def _prof_key(self, key) -> str:
        """The dispatch-timing and ledger key of a signature: the
        reference's ``decode_prefill:<scope>:pb<bucket>`` and
        ``decode_step:<scope>:w<W>``, a policy step's with ``:policy``
        (the port keeps the greedy and the policy step apart)."""
        if key[0] == "prefill":
            return f"decode_prefill:{self._sig_scope}:pb{key[1]}"
        return (f"decode_step:{self._sig_scope}:w{key[1]}"
                + (":policy" if key[2] else ""))

    def _dispatch(self, sig: _Signature) -> None:
        """Run ``sig`` on its staged inputs: upload them, then replay its
        graph (card) or run its body (CPU).  Every call ticks the
        signature's sampled dispatch timing; a sampled call synchronises
        the stream after the replay, the arena writes included, before
        ``tock`` (no capture, no extra replay)."""
        t_prof = _prof.tick(sig.prof_key)
        sig.ins.upload()
        if sig.key[0] == "prefill":
            self.prefill_dispatches[sig.key[1]] += 1
        else:
            self.step_dispatches[sig.key[1]] += 1
        sig.run.replay()
        if sig.run.captured:
            self.replays[sig.key] += 1
        if t_prof is not None:
            sync(self.device)
            _prof.tock(sig.prof_key, t_prof)
        if sig.local is not None:
            self._gather_rows(sig)

    def _gather_rows(self, sig: _Signature) -> None:
        """After a data-sharded step: gather every data rank's logits,
        chosen tokens and new K/V rows, and scatter the other ranks' rows
        into this rank's arena (each layer; this rank's own rows again,
        the same values), so that every arena holds every slot's blocks."""
        from ..parallel import comm
        from .mesh import DATA_AXIS

        group = self.mesh.group(DATA_AXIS)
        loc = sig.local
        sig.logits.copy_(comm.all_gather(loc["logits"], group, 0))
        sig.res.copy_(comm.all_gather(loc["res"], group, 0))
        a = sig.ins.t
        W = loc["k"].shape[2]
        _, blk, off = paged_window_coords(a["tables"], a["pos0"],
                                          a["limits"], W, self.block_size,
                                          self.pool.trash)
        for arena, rows in ((self.pool.k, loc["k"]),
                            (self.pool.v, loc["v"])):
            if self.pool.quantized:
                # the rows as the writer stored them: int8 payload and
                # float32 scales, both gathered
                q, sc = _attn.quantize_kv(rows)
                q = comm.all_gather(q, group, 1)
                sc = comm.all_gather(sc, group, 1)
                for i in range(q.shape[0]):
                    _attn.paged_cache_put_window(arena, i, blk, off, q[i],
                                                 sc[i])
            else:
                rows = comm.all_gather(rows.to(_attn.pool_arena(
                    arena).dtype), group, 1)
                for i in range(rows.shape[0]):
                    _attn.paged_cache_set_window(arena, i, blk, off,
                                                 rows[i])

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
        out, res, kw = sig.logits, sig.res, {}
        mask = None if sig.mask is None else sig.mask.t["mask"]
        if sig.local is not None:
            # a data-sharded step: this rank's rows (gathered in _dispatch)
            rows = slice(self._row0, self._row0 + self._rows)
            a = {n: t[rows] for n, t in a.items()}
            mask = None if mask is None else mask[rows]
            out, res = sig.local["logits"], sig.local["res"]
            kw["kv_out"] = (sig.local["k"], sig.local["v"])
        logits, _, _ = self.model.decode_window(
            a["toks"], a["pos0"], a["tables"], a["limits"], self.pool.k,
            self.pool.v, block_size=self.block_size, **kw)
        top = torch.argmax(logits, dim=-1).to(torch.int32)
        if mask is None:
            chosen = top[:, 0]  # all-greedy rows: the policy ladder's argmax
        else:
            chosen = masked_select_tokens(
                logits[:, 0, :], a["seeds"], a["subs"], a["temps"],
                a["topks"], a["topps"], mask)
        out.copy_(logits)
        res[:, :-1].copy_(top)
        res[:, -1].copy_(chosen)

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
                    tables: np.ndarray, limits: np.ndarray, samp=None,
                    with_logits: bool = False):
        """One windowed decode step returning only what the scheduler reads:
        ``(argmax [S, W] int32, chosen [S] int32)`` in one read back — the
        logits stay on the device unless ``with_logits`` (then a third
        item, the logits [S, W, V], for the beam controller)."""
        sig = self._stage_step(toks, pos0, tables, limits, samp)
        self._dispatch(sig)
        res = sig.res.to("cpu", copy=True).numpy()
        if with_logits:
            return (res[:, :-1], res[:, -1],
                    sig.logits.to("cpu", copy=True).numpy())
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

    def logp_rows(self, rows: np.ndarray) -> np.ndarray:
        """log-softmax over logits rows [n, V] on the engine's device (the
        op the dense ``generate`` applies to its step's logits): the beam
        controller's scoring."""
        t = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        return torch.log_softmax(t.to(self.device), dim=-1).cpu().numpy()

    def slots_resident_per_gib(self) -> int:
        """Full slots (max_len tokens of K and V, scales included) one GiB
        of arena holds at this pool's kv_dtype."""
        return int((1 << 30) // max(self.pool.bytes_per_token * self.max_len,
                                    1))

    def prefill_tail(self, tail: np.ndarray, pos0: int, table: np.ndarray,
                     limit: int, samp_row=None, return_logits: bool = False):
        """Write ``tail``'s K/V at cache positions ``pos0``.. through the
        decode step, up to ``n_slots`` runs of consecutive tail tokens per
        dispatch riding the slot axis, every row mapping the same table.
        A run is W tokens in one row's window: W = ``spec_window`` when the
        tail outgrows one W=1 dispatch, else 1.  A row's limit ends at its
        run (or at ``limit``, the slot's write budget, if that is sooner),
        so a short run's idle window positions write the trash block.
        Each layer scatters all rows' K/V before any row attends, so a run
        sees the runs before it in the same call.  Returns the token after
        the last tail position: the argmax, or the policy pick of
        ``samp_row`` (seed, substep, temperature, top_k, top_p, mask_row),
        which reads window column 0, so there the last token is a run of
        its own.  With ``return_logits`` returns ``(token, logits [V] of
        the last position)``.  A prefix-cache hit, a fork and a sampled
        first token run here: the warmed step graphs, no signature of
        their own."""
        S = self.n_slots
        # runs a call: on a data-sharded mesh those of the first data
        # rank's rows (a run reads the runs before it in the same call)
        per = self._rows
        tail = np.asarray(tail, np.int32).reshape(-1)
        W = self.spec_window if self.spec_window > 1 and tail.size > S else 1
        body = tail.size - (1 if samp_row is not None and W > 1 else 0)
        cuts = list(range(0, body, W)) + [body, tail.size]
        runs = [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]
        trash = self._trash_table()
        for g in range(0, len(runs), per):
            chunk = runs[g:g + per]
            toks = np.zeros((S, W), np.int32)
            poss = np.zeros(S, np.int32)
            lims = np.zeros(S, np.int32)  # idle rows: limit 0 = trash writes
            tables = np.tile(trash, (S, 1))
            for j, (a, b) in enumerate(chunk):
                toks[j, :b - a] = tail[a:b]
                poss[j] = int(pos0) + a
                lims[j] = min(int(limit), int(pos0) + b)
                tables[j] = table
            last = g + per >= len(runs)
            samp = None
            if samp_row is not None and last:
                samp = self.make_samp()
                self.set_samp_row(samp, len(chunk) - 1, samp_row)
            got = self.step_tokens(toks, poss, tables, lims, samp=samp,
                                   with_logits=return_logits and last)
        j, (a, b) = len(chunk) - 1, chunk[-1]
        tok = int(got[1][j]) if samp_row is not None else int(
            got[0][j, b - a - 1])
        return (tok, got[2][j, b - a - 1]) if return_logits else tok

    def alloc_blocks(self, n: int):
        """Pool allocation: ``n`` blocks or None (the caller preempts).
        With a prefix cache a dry pool first evicts unreferenced cached
        blocks (least recently released first); a block a live slot maps
        is never evicted."""
        got = self.pool.alloc(n)
        if got is not None or self.prefix is None:
            return got
        evicted = self.prefix.evict(n - self.pool.blocks_free)
        if evicted:
            self.pool.free(evicted)
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


class _BeamGroup:
    """One beam-search generation riding the continuous batch as K forked
    branches.  The group owns K slots for its whole life; its host
    controller replicates ``layers/beam.py``'s loop (the candidates, the
    eos handling, the first-index tie order, the length-penalty re-sort)
    over per-branch logits from the W=1 step, which makes the dense
    ``generate`` its oracle.  Branch k's KV lives in slot ``slots[k]``; a
    re-gather that moves a branch's ancestry to another slot forks."""

    __slots__ = ("req", "k", "slots", "tokens", "scores", "done", "lens",
                 "t", "eos", "max_len")

    def __init__(self, req: DecodeRequest, slots, eos_id: int):
        self.req = req
        self.k = req.sampling.beam
        self.slots = list(slots)
        self.tokens = [[] for _ in range(self.k)]
        # only beam 0 is live at the first expansion
        self.scores = np.full(self.k, -1e9, np.float32)
        self.scores[0] = 0.0
        self.done = np.zeros(self.k, bool)
        self.lens = np.zeros(self.k, np.int32)
        self.t = 0
        self.eos = int(eos_id)
        self.max_len = int(req.max_gen)

    def select(self, logp_rows) -> list:
        """One iteration's selection: ``logp_rows[k]`` is branch k's
        log-softmax row [V] (None for a done branch, which proposes only
        eos at its unchanged score).  Returns the plan ``[(parent, token,
        score, done, len)]`` of length K, ranked; changes no state."""
        v = next(r.shape[-1] for r in logp_rows if r is not None)
        neg = np.float32(-1e9)
        cand = np.empty((self.k, v), np.float32)
        for k in range(self.k):
            if self.done[k] or logp_rows[k] is None:
                cand[k] = self.scores[k] + neg
                cand[k, self.eos] = self.scores[k]
            else:
                cand[k] = self.scores[k] + logp_rows[k]
        flat = cand.reshape(-1)
        # the dense loop's top_k order: float32's total order, ties toward
        # the lower flat index
        top = _beam.top_k(torch.from_numpy(flat)[None], self.k)[1][0].numpy()
        plan = []
        for i in top:
            parent, tok = int(i) // v, int(i) % v
            was_done = bool(self.done[parent])
            emitted = (not was_done) and tok != self.eos
            plan.append((parent, tok, np.float32(flat[i]),
                         was_done or tok == self.eos,
                         int(self.lens[parent]) + (1 if emitted else 0)))
        return plan

    def apply(self, plan) -> None:
        """Commit a plan: re-gather buffers, scores, done flags and lengths
        and append this iteration's token to each branch."""
        self.tokens = [self.tokens[p] + [tok] for p, tok, *_ in plan]
        self.scores = np.asarray([s for _, _, s, _, _ in plan], np.float32)
        self.done = np.asarray([d for *_, d, _ in plan], bool)
        self.lens = np.asarray([ln for *_, ln in plan], np.int32)
        self.t += 1

    def finished(self) -> bool:
        return self.t >= self.max_len or bool(self.done.all())

    def finalize(self):
        """Eos-pad every buffer to max_len and, under a positive length
        penalty, rescale and stably re-sort.  Returns (tokens, scores,
        lens), best first."""
        toks = [list(b) + [self.eos] * (self.max_len - len(b))
                for b in self.tokens]
        scores, lens = self.scores.copy(), self.lens.copy()
        lp = float(self.req.sampling.length_penalty)
        if lp > 0:
            scores = (scores / (((5.0 + lens.astype(np.float32)) / 6.0)
                                ** np.float32(lp))).astype(np.float32)
            order = _beam.top_k(torch.from_numpy(scores)[None],
                                self.k)[1][0].numpy()
            toks = [toks[i] for i in order]
            scores, lens = scores[order], lens[order]
        return toks, scores, lens


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

    With the engine's prefix cache, admission tiers on the unshared tail
    (``effective_len``), a joiner maps its longest cached run and
    registers its own new full blocks (``_seat``), and cached blocks stay
    out of the free list until evicted.  ``SamplingParams(beam=K)`` seats
    a beam group of K slots (``eos_id`` required); ``n=N`` queues N
    sampled branches under ``sampling.branch_seed``, the children mapping
    the root's registered prompt blocks.  ``snapshot_slots`` hands out
    resume records; ``submit(resume_prefix=...)`` continues one.

    Thread-safe: ``submit`` from any thread; drive the loop synchronously
    (``step``/``run_until_idle``) or with the background thread
    (``start``/``close``)."""

    def __init__(self, engine: ContinuousDecodeEngine, *,
                 max_wait_ms: float = 200.0, spec: bool = False):
        self.eng = engine
        self.spec = bool(spec) and engine.spec_window > 1
        eff = None
        if engine.prefix is not None:
            eff = (lambda req:
                   req.prompt_len if req.cold_resume else
                   req.prompt_len
                   - len(engine.prefix.lookup(self._digests_for(req),
                                              req.prompt_len)[0])
                   * engine.block_size)
        self.queue = DecodeAdmissionQueue(engine.prompt_buckets,
                                          max_wait_ms=max_wait_ms,
                                          effective_len=eff)
        self._slots = [None] * engine.n_slots
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._thread = None
        self._closed = False
        self._seq = 0  # insertion order: preemption evicts the youngest
        self.counters = {"prefill_inserts": 0, "retired": 0, "sheds": 0,
                         "preemptions": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "steps": 0,
                         "resumed_in": 0, "migrated_out": 0,
                         "sampled": 0, "forks": 0, "fork_cow_blocks": 0,
                         "fork_private": 0, "beam_groups": 0}
        self._groups: list = []  # live _BeamGroups
        self._snapshot: Dict = {}
        self._update_snapshot()

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_gen: int, eos_id: Optional[int] = None,
               deadline=None, resume_prefix=None,
               resume_kv_dtype: Optional[str] = None,
               sampling=None) -> DecodeRequest:
        """Queue one streaming generation; returns its request handle.

        ``resume_prefix`` seeds the request with tokens generated elsewhere
        (a migrated stream): admission re-prefills prompt + prefix, as a
        preemption re-prefills its history, and generation continues from
        the prefix's last token.  ``max_gen`` stays the original total
        budget, and ``result()`` returns prefix + continuation.
        ``resume_kv_dtype`` is the source pool's kv_dtype: a record from a
        pool of another kv_dtype re-prefills cold (no prefix-cache mapping
        for that admission)."""
        sp = sampling if sampling is not None else SamplingParams()
        if not isinstance(sp, SamplingParams):
            sp = SamplingParams.from_record(sp)
        resuming = resume_prefix is not None and len(resume_prefix) > 0
        if sp.beam > 1:
            # the whole group seats at once, needs a live eos, and starts
            # fresh (a migrated beam restarts: beam search is deterministic)
            if eos_id is None:
                raise ValueError("beam search requires eos_id")
            if sp.beam > self.eng.n_slots:
                raise ValueError(f"beam width {sp.beam} exceeds n_slots="
                                 f"{self.eng.n_slots}")
            if sp.beam > self.eng.vocab_size:
                raise ValueError(f"beam width {sp.beam} exceeds vocab "
                                 f"{self.eng.vocab_size}")
            if resuming:
                raise ValueError(
                    "beam search does not resume from a prefix; migrated "
                    "beams restart deterministically")
        if sp.n > 1 and resuming:
            raise ValueError(
                "a parallel-n root cannot resume from a prefix; branches "
                "migrate as independent sampled streams")
        req = DecodeRequest(prompt, max_gen, eos_id=eos_id, deadline=deadline,
                            sampling=sp)
        if resuming:
            prefix = [int(t) for t in resume_prefix]
            if len(prefix) >= int(max_gen):
                raise ValueError(
                    f"resume_prefix of {len(prefix)} tokens already covers "
                    f"max_gen={max_gen}: nothing left to generate")
            req.tokens = prefix
            if (resume_kv_dtype is not None
                    and str(resume_kv_dtype) != self.eng.pool.kv_dtype):
                req.cold_resume = True
                _profiler.incr("serving.quant.resume_dtype_mismatch")
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
        subs = [req]
        if sp.n > 1:
            # branch b samples under branch_seed(seed, b); branch 0 is the
            # root.  The children queue behind the root and map its
            # registered prompt blocks through the prefix cache.
            req.sampling = sp.branch(0)
            req.branches = [req]
            for b in range(1, sp.n):
                child = DecodeRequest(prompt, max_gen, eos_id=eos_id,
                                      deadline=deadline,
                                      sampling=sp.branch(b))
                child.fork_of = req.id
                req.branches.append(child)
                subs.append(child)
        with self._cv:
            if self._closed:
                raise RuntimeError("continuous scheduler is closed")
            if resuming:
                self.counters["resumed_in"] += 1
                _profiler.incr("serving.decode.resumed_in")
            if not sp.is_default:
                self.counters["sampled"] += 1
                _profiler.incr("serving.sample.requests")
            for r in subs:
                self.queue.push(r)
            _profiler.gauge("serving.decode.waiting", len(self.queue))
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

    def snapshot_slots(self, drain: bool = False) -> list:
        """Resume records of every live generation, seated and waiting:
        id, prompt, tokens so far, max_gen, eos_id, the deadline's
        remaining seconds, seated, preemptions, sampling and the pool's
        kv_dtype.  A beam group is one record of its umbrella request with
        no tokens (it restarts).  With ``drain=True`` the scheduler closes,
        every request fails locally with :class:`GenerationMigrated` (slots
        retire, blocks go back) and the records are handed out, to be
        re-admitted elsewhere through ``submit(resume_prefix=...)``."""

        def rec(req: DecodeRequest, seated: bool, tokens=None) -> dict:
            rem = None
            if req.deadline is not None:
                r = req.deadline.remaining()
                rem = None if r == float("inf") else max(float(r), 0.0)
            return {"id": int(req.id),
                    "prompt": [int(t) for t in req.prompt],
                    "tokens": [int(t) for t in
                               (req.tokens if tokens is None else tokens)],
                    "max_gen": int(req.max_gen),
                    "eos_id": (None if req.eos_id is None
                               else int(req.eos_id)),
                    "deadline_remaining_s": rem,
                    "seated": bool(seated),
                    "preemptions": int(req.preemptions),
                    "sampling": req.sampling.to_record(),
                    "kv_dtype": self.eng.pool.kv_dtype}

        with self._cv:
            records = [rec(s.req, True) for s in self._slots
                       if s is not None and s.group is None]
            records += [rec(g.req, True, tokens=[]) for g in self._groups]
            if not drain:
                records += [rec(r, False) for r in self.queue._q]
                return records
            exc = GenerationMigrated(
                "generation snapshot off a draining scheduler; its resume "
                "record re-admits it elsewhere")
            self._closed = True
            for req in self.queue.drain():
                records.append(rec(req, False))
                req.error = exc
                req.t_done = time.perf_counter()
                req.done.set()
            for g in list(self._groups):
                self._fail_group(g, exc)
            for si, slot in enumerate(self._slots):
                if slot is not None:
                    self._retire(si, error=exc)
            self.counters["migrated_out"] += len(records)
            if records:
                _profiler.incr("serving.decode.migrated_out", len(records))
            self._gauges()
            self._cv.notify_all()
        return records

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._cv:
            # the engine and its prefix cache outlive this scheduler
            self._fail_all(RuntimeError("continuous scheduler closed"))
            self._update_snapshot()
            self._cv.notify_all()

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every waiter, beam group and live slot with ``exc``
        (callers hold the lock)."""
        for req in self.queue.drain():
            req.error = exc
            req.t_done = time.perf_counter()
            req.done.set()
        for g in list(self._groups):
            self._fail_group(g, exc)
        for si, slot in enumerate(self._slots):
            if slot is not None:
                self._retire(si, error=exc)
        self._gauges()

    def _abort(self, exc: BaseException) -> None:
        """Close the scheduler and fail every waiter and every live slot with
        ``exc``: submitters get the error, never a silent stall.  The
        prefix cache drops with it, since a failed step may have half
        written the arenas; its blocks, all unreferenced once the slots
        retired, go back to the free list.  A second call finds nothing
        left to fail."""
        with self._cv:
            self._closed = True
            self._fail_all(exc)
            cache = self.eng.prefix
            if cache is not None and cache.cached_blocks:
                blocks = list(cache._entries)
                cache.drop_all()
                self.eng.pool.free(blocks)
            self._update_snapshot()
            self._cv.notify_all()

    # ----------------------------------------------------------- internals
    def _update_snapshot(self):
        """Publish the dict ``stats()`` reads (callers hold the lock)."""
        active = sum(1 for s in self._slots if s is not None)
        pool = self.eng.pool
        cache = self.eng.prefix
        self._snapshot = {
            "slots": self.eng.n_slots,
            "slots_active": active,
            "occupancy": active / max(self.eng.n_slots, 1),
            "waiting": len(self.queue),
            "blocks_total": pool.n_blocks,
            "blocks_free": pool.blocks_free,
            "kv_dtype": pool.kv_dtype,
            "kv_bytes_per_token": pool.bytes_per_token,
            "kv_slots_per_gib": self.eng.slots_resident_per_gib(),
            "blocks_reclaimable": (0 if cache is None
                                   else cache.evictable_blocks),
            "prefix": None if cache is None else cache.stats(),
            "spec": self.spec,
            "closed": self._closed,
            # which mesh the engine decodes on (static for its lifetime)
            "mesh": (self.eng.mesh.summary()
                     if getattr(self.eng, "mesh", None) is not None
                     else None),
            **self.counters,
        }

    def _gauges(self):
        """Publish the snapshot and the reference's load gauges (callers
        hold the lock)."""
        self._update_snapshot()
        snap = self._snapshot
        _profiler.gauge("serving.decode.slots_active", snap["slots_active"])
        _profiler.gauge("serving.decode.blocks_free", snap["blocks_free"])
        _profiler.gauge("serving.decode.waiting", snap["waiting"])
        _profiler.gauge("serving.fork.groups", len(self._groups))

    def check_block_accounting(self) -> Dict:
        """Assert that occupied, free and cached blocks partition the pool
        (every block in exactly one place: a slot's private blocks are
        occupied, blocks the prefix cache tracks are cached whether mapped
        or not) and that each cached block's refcount equals the number of
        live slots that map it.  Returns the census: free, occupied and
        leaked, and with a prefix cache cached and referenced."""
        pool = self.eng.pool
        cache = self.eng.prefix
        with self._lock:
            free = set(pool._free)
            cached = set() if cache is None else set(cache._entries)
            private: list = []
            refs: Dict[int, int] = {}
            for s in self._slots:
                if s is None:
                    continue
                for b in s.blocks:
                    if b in s.cached:
                        refs[b] = refs.get(b, 0) + 1
                    else:
                        private.append(b)
            priv_set = set(private)
            assert len(private) == len(priv_set), \
                f"private block owned twice: {sorted(private)}"
            assert len(free) == len(pool._free), "free list holds duplicates"
            assert not (free & cached), \
                f"blocks both free and cached: {sorted(free & cached)}"
            assert not (free & priv_set), \
                f"blocks both free and occupied: {sorted(free & priv_set)}"
            assert not (cached & priv_set), \
                f"blocks both cached and private: {sorted(cached & priv_set)}"
            union = free | cached | priv_set
            assert union == set(range(pool.n_blocks)), \
                f"pool not partitioned: missing " \
                f"{sorted(set(range(pool.n_blocks)) - union)}"
            for b in cached:
                want, got = refs.get(b, 0), cache.refcount(b)
                assert got == want, \
                    f"refcount drift on block {b}: cache says {got}, " \
                    f"{want} live slots map it"
            for b in refs:
                assert b in cached, \
                    f"slot maps block {b} as cached but the cache forgot it"
            census = {"free": len(free), "occupied": len(priv_set),
                      "leaked": pool.n_blocks - len(union)}
            if cache is not None:
                census["cached"] = len(cached)
                census["referenced"] = sum(1 for b in cached
                                           if cache.refcount(b) > 0)
            return census

    def _release_blocks(self, slot: _Slot) -> None:
        """Give a slot's blocks back: cached ones release their refcount
        (in reverse table order, so a chain's deep blocks age out first),
        private ones return to the free list."""
        if slot.cached:
            self.eng.prefix.release(
                [b for b in reversed(slot.blocks) if b in slot.cached])
            self.eng.pool.free(
                [b for b in slot.blocks if b not in slot.cached])
        else:
            self.eng.pool.free(slot.blocks)

    def _retire(self, si: int, error: Optional[BaseException] = None):
        slot = self._slots[si]
        self._slots[si] = None
        if not slot.parked:
            self._release_blocks(slot)
        slot.req.error = error
        slot.req.t_done = time.perf_counter()
        self.counters["retired"] += 1
        _profiler.incr("serving.decode.retired")
        slot.req.done.set()

    def _preempt(self, si: int):
        """Pool pressure: push the slot's request (with its progress) back to
        the queue, keeping its original enqueue stamp; its history
        re-prefills on re-admission."""
        slot = self._slots[si]
        self._slots[si] = None
        self._release_blocks(slot)
        slot.req.preemptions += 1
        self.counters["preemptions"] += 1
        _profiler.incr("serving.decode.preemptions")
        self.queue.requeue(slot.req)

    def _digests_for(self, req) -> list:
        """The request's chained block digests (seeded with the pool's
        kv_dtype), memoized on the request for as long as its history
        stands."""
        memo = req._digest_memo
        if memo is not None and memo[0] == req.prompt_len:
            return memo[1]
        digs = chain_hashes(req.history(), self.eng.block_size,
                            root=self.eng.prefix.root)
        req._digest_memo = (req.prompt_len, digs)
        return digs

    def _fits(self, req) -> bool:
        cache = self.eng.prefix
        sp = req.sampling
        if sp.beam > 1 and sum(1 for s in self._slots if s is None) < sp.beam:
            return False  # a beam group seats whole or not at all
        free_blocks = self.eng.pool.blocks_free
        need = self.eng.pool.blocks_for(req.prompt_len)
        if cache is not None and req.cold_resume:
            free_blocks += cache.evictable_blocks
        elif cache is not None:
            # matched blocks cost nothing; unreferenced cached blocks are
            # reclaimable, except the matched ones, which seating acquires
            m = len(cache.lookup(self._digests_for(req), req.prompt_len)[0])
            need -= m
            free_blocks += max(cache.evictable_blocks - m, 0)
        joiners = 1
        if sp.beam > 1:
            # K - 1 forks of the root: with a cache each shares the full
            # prompt blocks and pays its partial block, without one each
            # is a private copy
            n_full = (req.prompt_len // self.eng.block_size
                      if cache is not None else 0)
            per_fork = self.eng.pool.blocks_for(req.prompt_len) - n_full
            need += (sp.beam - 1) * per_fork
            joiners = sp.beam
        growth = 1 + (1 if self.spec else 0)
        n_active = sum(1 for s in self._slots if s is not None)
        return free_blocks >= need + (n_active + joiners) * growth

    def _match_prefix(self, req, history: np.ndarray):
        """Longest cached run for admission: ``(hit_blocks, digests,
        diverged)``, empty on a miss, with no cache, on a cold resume, or
        when the ``serving.prefix_match`` fault site fires (that admission
        pays a cold prefill; its stream is unchanged)."""
        cache = self.eng.prefix
        if cache is None or req.cold_resume:
            return [], [], False
        with _trace.span("serving.prefix.match",
                         prompt_len=int(history.size)):
            try:
                faults.check("serving.prefix_match")
            except Exception:  # noqa: BLE001 — degrade to a miss
                return [], [], False
            digests = self._digests_for(req)
            hit, diverged = cache.lookup(digests, history.size)
        return hit, digests, diverged

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

    def _seat(self, si: int, req: DecodeRequest, group=None,
              want_logits: bool = False):
        """Seat ``req`` in slot ``si`` and prefill its history.  With a
        prefix cache the longest cached run maps into the table read-only
        (refcounted) and only the tail is computed (``prefill_tail``);
        the request's own new full blocks are registered after.  The first
        token is chosen by the request's policy: the argmax, or the policy
        pass through a one-position tail.

        Returns ``(slot, tok, row)`` (row = the last position's logits [V]
        when ``want_logits``), 0 after failing the request on its own
        error, or None when allocation raced ``_fits`` (requeued)."""
        pool = self.eng.pool
        cache = self.eng.prefix
        history = req.history()
        hit, digests, diverged = self._match_prefix(req, history)
        m = len(hit)
        if m:
            # hold the run before allocating: alloc_blocks may evict
            # refcount-zero cached blocks, never the ones just matched
            cache.acquire(hit)
        priv = self.eng.alloc_blocks(pool.blocks_for(history.size) - m)
        if priv is None:  # _fits raced; retry next step (aging preserved)
            if m:
                cache.release(list(reversed(hit)))
            self.queue.requeue(req)
            return None
        blocks = list(hit) + list(priv)
        table = self.eng._trash_table()
        table[:len(blocks)] = blocks
        limit = history.size + (req.max_gen - len(req.tokens))
        shared = m * self.eng.block_size
        samp_row = (None if req.sampling.is_default
                    else self._samp_row_for(req, history))
        row = None
        try:
            with _trace.span("serving.decode.prefill_insert", slot=si,
                             prompt_len=int(history.size),
                             cached_tokens=shared):
                if m:
                    out = self.eng.prefill_tail(
                        history[shared:], shared, table, limit,
                        samp_row=samp_row, return_logits=want_logits)
                    tok, row = out if want_logits else (out, None)
                else:
                    logits = self.eng.prefill(history, table)
                    if want_logits:
                        row = logits
                    if samp_row is None:
                        tok = int(logits.argmax())
                    else:
                        # sampled first token: re-run the LAST history position
                        # through the W=1 step (its K/V rewrite is identical) so
                        # the selection runs the same policy pass as every
                        # later token
                        tok = self.eng.prefill_tail(
                            history[-1:], history.size - 1, table, limit,
                            samp_row=samp_row)
        except WarmError:
            # the engine cannot run this shape at all: back to the queue,
            # and step() aborts the scheduler, failing every waiter
            if m:
                cache.release(list(reversed(hit)))
            pool.free(priv)
            self.queue.requeue(req)
            raise
        except Exception as exc:  # noqa: BLE001 — this request's problem
            if m:
                cache.release(list(reversed(hit)))
            pool.free(priv)
            req.error = exc
            req.t_done = time.perf_counter()
            req.done.set()
            return 0
        self.counters["prefill_inserts"] += 1
        _profiler.incr("serving.decode.prefill_inserts")
        if cache is not None:
            cache.record(m, diverged)
        if req.fork_of is not None:
            # a parallel-n branch: its copy-on-write share is the run it
            # mapped; a missed or faulted lookup makes it a private copy
            self.counters["forks"] += 1
            _profiler.incr("serving.fork.forks")
            if m:
                self.counters["fork_cow_blocks"] += m
                _profiler.incr("serving.fork.cow_blocks", m)
            else:
                self.counters["fork_private"] += 1
                _profiler.incr("serving.fork.private")
        self._seq += 1
        slot = _Slot(req, table, blocks, pos=int(history.size), limit=limit,
                     seq=self._seq, cached=hit, group=group)
        # register this request's new full blocks (written just now) so the
        # next request sharing the prefix maps them; a digest already
        # cached keeps its block and ours stays private
        for i in range(m, len(digests)):
            parent = digests[i - 1] if i else cache.root
            if cache.register(digests[i], parent, blocks[i]):
                slot.cached.add(blocks[i])
        self._slots[si] = slot
        if req.t_first_token is None:
            req.t_first_token = time.perf_counter()
        return slot, tok, row

    def _insert(self, si: int, req: DecodeRequest):
        """Prefill-insert one plain request and emit its first token.
        Returns tokens emitted (1, or 0 when the request failed on its
        own), or None when allocation raced ``_fits``."""
        got = self._seat(si, req)
        if got is None or got == 0:
            return got
        # the prefill-emitted token is the NEXT step's input: not yet in the
        # cache, so it must not advance the write cursor
        self._emit(si, [got[1]], advance=False)
        return 1

    # -------------------------------------------------------- beam machinery
    def _admit_beam(self, req: DecodeRequest, free):
        """Seat a beam request: prefill the prompt once into a root slot,
        run the first expansion on its last position's logits, and fork the
        surviving branches.  Returns tokens emitted, 0 (the request failed
        on its own) or None (allocation raced ``_fits``; requeued)."""
        k = req.sampling.beam
        if len(free) < k:
            self.queue.requeue(req)
            return None
        got = self._seat(free[0], req, want_logits=True)
        if got is None or got == 0:
            return got
        root_slot, _, row = got
        group = _BeamGroup(req, free[:k], req.eos_id)
        root_slot.group = group
        self._groups.append(group)
        self.counters["beam_groups"] += 1
        # branch carriers 1..k-1: parked placeholders the first plan forks
        # into (the umbrella request carries branch 0)
        for b in range(1, k):
            self._seq += 1
            child = DecodeRequest(req.prompt, req.max_gen)
            child.fork_of = req.id
            s = _Slot(child, self.eng._trash_table(), [], pos=0,
                      limit=root_slot.limit, seq=self._seq, group=group)
            s.parked = True
            self._slots[free[b]] = s
        # the dense loop's t=0: every candidate comes from beam 0
        logp0 = self.eng.logp_rows(np.asarray(row, np.float32)[None])[0]
        plan = group.select([logp0] * k)
        return self._apply_beam_plan(group, plan)

    def _fork_alloc(self, n: int):
        """``n`` blocks for a fork, preempting plain slots (youngest first)
        until they fit or no victim is left.  Returns the blocks or None."""
        while True:
            got = self.eng.alloc_blocks(n)
            if got is not None:
                return got
            victims = [j for j, s in enumerate(self._slots)
                       if s is not None and s.group is None]
            if not victims:
                return None
            self._preempt(max(victims, key=lambda j: self._slots[j].seq))

    def _fork_state(self, group: _BeamGroup, parent_branch: int) -> dict:
        """A new slot state holding the parent branch's KV lineage.  With a
        prefix cache (copy-on-write): register the parent's full blocks
        under the lineage's digests, acquire them, and recompute only the
        partial block into a private one.  Without one, or when the
        ``serving.fork`` fault site fires, a private copy: the whole
        lineage re-prefilled.  The streams are the same either way.  Reads
        the parent slot without changing its blocks; raises
        :class:`_ForkFailed` when the pool cannot seat the fork."""
        lineage = np.concatenate(
            [group.req.prompt,
             np.asarray(group.tokens[parent_branch], np.int32)])
        with _trace.span("serving.fork", parent_branch=int(parent_branch),
                         lineage=int(lineage.size)):
            return self._fork_lineage(group, parent_branch, lineage)

    def _fork_lineage(self, group: _BeamGroup, parent_branch: int,
                      lineage: np.ndarray) -> dict:
        eng = self.eng
        cache = eng.prefix
        parent_slot = self._slots[group.slots[parent_branch]]
        bs = eng.block_size
        n_full = int(lineage.size) // bs
        cow = cache is not None
        if cow:
            try:
                faults.check("serving.fork")
            except Exception:  # noqa: BLE001 — degrade, by contract
                cow = False
        shared: list = []
        if cow and n_full:
            digs = chain_hashes(lineage, bs, root=cache.root)
            for i in range(n_full):
                parent = digs[i - 1] if i else cache.root
                if cache.register(digs[i], parent, parent_slot.blocks[i]):
                    parent_slot.cached.add(parent_slot.blocks[i])
            # a history length past the lineage lifts the lookup's cap: a
            # fork maps every full block (an admission must recompute its
            # last position, a fork's pending token is not in the lineage)
            hit, _ = cache.lookup(digs, int(lineage.size) + bs)
            if len(hit) == n_full:
                cache.acquire(hit)
                shared = list(hit)
        m = len(shared)
        priv = self._fork_alloc(eng.pool.blocks_for(int(lineage.size)) - m)
        if priv is None:
            if m:
                cache.release(list(reversed(shared)))
            raise _ForkFailed(
                f"KV pool exhausted forking a {lineage.size}-token lineage")
        blocks = shared + list(priv)
        table = eng._trash_table()
        table[:len(blocks)] = blocks
        try:
            if m:
                tail = lineage[m * bs:]
                if tail.size:
                    eng.prefill_tail(tail, m * bs, table, parent_slot.limit)
            else:
                eng.prefill(lineage, table)
        except BaseException:
            if m:
                cache.release(list(reversed(shared)))
            eng.pool.free(priv)
            raise
        self.counters["forks"] += 1
        _profiler.incr("serving.fork.forks")
        if cow:
            self.counters["fork_cow_blocks"] += m
            if m:
                _profiler.incr("serving.fork.cow_blocks", m)
        else:
            self.counters["fork_private"] += 1
            _profiler.incr("serving.fork.private")
        return {"table": table, "blocks": blocks, "cached": set(shared),
                "pos": int(lineage.size)}

    def _apply_beam_plan(self, group: _BeamGroup, plan) -> int:
        """Commit one beam iteration's plan to the slots: keep branches whose
        ancestry stayed, fork the ones whose parent is another branch, park
        the done ones.  Every fork is built before any old block set is
        released, so a swap reads both lineages intact.  Returns tokens
        emitted (K a live iteration)."""
        k = group.k
        keep = set()
        for b, (p, _tok, _s, d, _ln) in enumerate(plan):
            slot_b = self._slots[group.slots[b]]
            if p == b and not slot_b.parked and not d:
                keep.add(b)
        states = {}
        for b, (p, _tok, _s, d, _ln) in enumerate(plan):
            if d or b in keep:
                continue
            try:
                states[b] = self._fork_state(group, p)
            except WarmError:
                raise  # the engine cannot run: step() aborts the scheduler
            except Exception as exc:  # noqa: BLE001 — the group's problem
                # hand back the forks built for this plan, then fail the
                # group: a partial beam would change the search
                for st in states.values():
                    cached = st["cached"]
                    if cached:
                        self.eng.prefix.release(
                            [blk for blk in reversed(st["blocks"])
                             if blk in cached])
                    self.eng.pool.free(
                        [blk for blk in st["blocks"] if blk not in cached])
                self._fail_group(group, RuntimeError(
                    f"beam group could not fork: {exc}"))
                return 0
        # release every block set neither kept nor already parked; the
        # refcounts the forks acquired keep shared blocks alive
        for b in range(k):
            slot = self._slots[group.slots[b]]
            if b in keep or slot.parked:
                continue
            self._release_blocks(slot)
            slot.blocks = []
            slot.cached = set()
            slot.table = self.eng._trash_table()
            slot.parked = True
        for b, (_p, _tok, _s, d, _ln) in enumerate(plan):
            if d or b in keep:
                continue  # done branches stay parked
            slot = self._slots[group.slots[b]]
            st = states[b]
            slot.table = st["table"]
            slot.blocks = st["blocks"]
            slot.cached = st["cached"]
            slot.pos = st["pos"]
            slot.parked = False
        group.apply(plan)
        for b in range(k):
            # each carrier's tokens mirror its branch, so the marshal loop
            # reads tokens[-1] as for any slot
            self._slots[group.slots[b]].req.tokens = list(group.tokens[b])
        if group.finished():
            self._finish_group(group)
        return k

    def _beam_advance(self, group: _BeamGroup, logits, stepped) -> int:
        """One beam iteration after a decode step: advance the stepped
        branches' cursors, log-softmax their last-position logits, select,
        and commit the plan."""
        k = group.k
        rows = [None] * k
        for b in range(k):
            si = group.slots[b]
            slot = self._slots[si]
            if slot is None or slot.parked or si not in stepped:
                continue
            slot.pos += 1
            rows[b] = logits[si, 0, :]
        live = [b for b in range(k) if rows[b] is not None]
        if not live:
            return 0
        lp = self.eng.logp_rows(np.stack([rows[b] for b in live]))
        logp = [None] * k
        for j, b in enumerate(live):
            logp[b] = lp[j]
        return self._apply_beam_plan(group, group.select(logp))

    def _finish_group(self, group: _BeamGroup) -> None:
        """Beam completion: finalize, publish the ranked beams on the
        umbrella request, retire all K slots."""
        toks, scores, lens = group.finalize()
        req = group.req
        for si in group.slots:
            slot = self._slots[si]
            self._slots[si] = None
            if slot is not None and not slot.parked:
                self._release_blocks(slot)
        self._groups.remove(group)
        req.beams = [[int(t) for t in b] for b in toks]
        req.beam_scores = [float(s) for s in scores]
        req.beam_lens = [int(x) for x in lens]
        # req.tokens: the winning beam, cut after its eos
        best = req.beams[0]
        cut = best.index(group.eos) + 1 if group.eos in best else len(best)
        req.tokens = best[:cut]
        req.error = None
        req.t_done = time.perf_counter()
        self.counters["retired"] += 1
        _profiler.incr("serving.decode.retired")
        req.done.set()

    def _fail_group(self, group: _BeamGroup, exc: BaseException) -> None:
        """Fail a whole beam group: release every branch's blocks, clear its
        K slots, and hand ``exc`` to the umbrella request."""
        for si in group.slots:
            slot = self._slots[si]
            if slot is not None:
                self._slots[si] = None
                if not slot.parked:
                    self._release_blocks(slot)
        if group in self._groups:
            self._groups.remove(group)
        req = group.req
        req.error = exc
        req.t_done = time.perf_counter()
        self.counters["retired"] += 1
        _profiler.incr("serving.decode.retired")
        req.done.set()

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
        rows and beam groups, admit joiners (prefill-insert), then one
        windowed decode step over every occupied slot.  Returns tokens
        emitted."""
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
                    _profiler.incr("serving.decode.sheds")
                    req.done.set()
                for si, slot in enumerate(self._slots):
                    if (slot is not None and slot.group is None
                            and slot.req.deadline is not None
                            and slot.req.deadline.expired()):
                        self._retire(si, error=DeadlineExceeded(
                            "per-slot deadline expired mid-generation"))
                for g in list(self._groups):
                    if (g.req.deadline is not None
                            and g.req.deadline.expired()):
                        self._fail_group(g, DeadlineExceeded(
                            "beam-group deadline expired mid-generation"))
                while True:  # admit: join between steps, never mid-step
                    free = [i for i, s in enumerate(self._slots)
                            if s is None]
                    if not free or len(self.queue) == 0:
                        break
                    req = self.queue.pop(self._fits)
                    if req is None:
                        break
                    if req.sampling.beam > 1:
                        got = self._admit_beam(req, free)
                    else:
                        got = self._insert(free[0], req)
                    if got is None:
                        break  # alloc raced _fits; retry next step
                    emitted += got
                active = [(i, s) for i, s in enumerate(self._slots)
                          if s is not None and not s.parked]
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
                self._gauges()

    def _decode_step(self, active) -> int:
        eng = self.eng
        S = eng.n_slots
        drafts = {}
        if self.spec and not self._groups:
            # drafts only for plain greedy slots (a sampled slot's pick is a
            # PRNG draw, which greedy verification would change); while a
            # beam group is live, drafting pauses so every branch's logits
            # sit at window column 0
            for si, slot in active:
                if slot.group is not None or not slot.req.sampling.is_default:
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
                continue  # preempted or failed earlier in this marshal loop
            grown = True
            while (self._slots[si] is not None
                   and not (grown := self._grow(si, slot.pos + W))):
                # pool exhausted: evict the YOUNGEST plain slot not yet
                # marshalled into this step (an already-staged row would
                # write through freed blocks); a plain row is always its
                # own candidate, so the pool can never wedge on plain load
                victims = [j for j, s in enumerate(self._slots)
                           if s is not None and j not in stepped
                           and s.group is None]
                if not victims:
                    break
                self._preempt(max(victims,
                                  key=lambda j: self._slots[j].seq))
            if self._slots[si] is None:
                continue  # this row was itself the youngest: preempted
            if not grown:
                # only beam branches are left to evict: fail THIS row's
                # group, un-staging its branches already marshalled
                for sj in list(slot.group.slots):
                    if sj in stepped:
                        stepped.remove(sj)
                        toks[sj, :] = 0
                        pos0[sj] = 0
                        limits[sj] = 0
                        tables[sj] = eng._trash_table()
                self._fail_group(slot.group, RuntimeError(
                    "KV pool exhausted growing a beam group"))
                continue
            toks[si, 0] = slot.req.tokens[-1]
            if si in drafts:
                toks[si, 1:] = drafts[si]
                self.counters["spec_proposed"] += W - 1
                _profiler.incr("serving.decode.spec_proposed", W - 1)
            elif W > 1:
                toks[si, 1:] = slot.req.tokens[-1]
            pos0[si] = slot.pos
            limits[si] = slot.limit
            tables[si] = slot.table
            stepped.append(si)
        if not stepped:
            return 0
        samp = None
        if any(self._slots[si].group is None
               and not self._slots[si].req.sampling.is_default
               for si in stepped):
            samp = eng.make_samp()
            for si in stepped:
                slot = self._slots[si]
                if slot.group is not None or slot.req.sampling.is_default:
                    continue
                eng.set_samp_row(samp, si,
                                 self._samp_row_for(slot.req,
                                                    slot.req.history()))
        beamed = any(self._slots[si].group is not None for si in stepped)
        with _trace.span("serving.decode.step", active=len(stepped),
                         window=W):
            got = eng.step_tokens(toks, pos0, tables, limits, samp=samp,
                                  with_logits=beamed)
        out, chosen = got[0], got[1]
        emitted = 0
        for si in stepped:
            slot = self._slots[si]
            if slot is None or slot.group is not None:
                continue  # beam branches advance through their controller
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
                if acc:
                    _profiler.incr("serving.decode.spec_accepted", acc)
            emitted += self._emit(si, list(out[si, :acc + 1]))
        if beamed:
            sset = set(stepped)
            for g in list(self._groups):
                emitted += self._beam_advance(g, got[2], sset)
        return emitted
