"""CUDA graph helpers shared by the decode engine (``serving/decode.py``) and
the Executor's warmed steps (``core/executor.py``).

``Staged`` holds a signature's static inputs: named fields of any dtype in
one device buffer, filled from the host through one pinned buffer and one
asynchronous upload.  ``Graphs.prepare`` makes a body a ``Prepared``: on
the card a CUDA graph recorded after one eager run (``capture``), whose
every replay adds its kernel launches to the counters
(``ops/_counters.py``); on the CPU the body, run once, and again at every
replay.  ``prepare(body, count=True)`` counts the work of that first run
(``obs.prof.analyze``: flops and bytes accessed) into ``Prepared.cost``,
once per signature and never at a replay.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..ops import _counters

_ALIGN = 256  # bytes: every field starts where cudaMalloc would put it


def sync(device) -> None:
    """A sampled dispatch's wait before ``obs.prof.tock``: the current
    stream's work done (nothing to wait for on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class WarmError(RuntimeError):
    """Preparing a signature failed (its first run, or on the card its CUDA
    graph capture), or replaying it did.  Nothing runs that signature op
    by op in its place: a decode engine stops serving, an Executor's
    ``run`` raises."""


def _torch_dtype(dtype) -> torch.dtype:
    """A field's device dtype: a torch dtype as given, a numpy one as torch
    names it, except uint32, which the device reads as int32 (kernels and
    ops mask the bits they need)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dtype = np.dtype(dtype)
    if dtype == np.uint32:
        return torch.int32
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class Staged:
    """Named fields ``(name, shape, dtype)`` packed into ONE byte buffer on
    ``device``, each field aligned to 256 bytes, filled from the host
    through one host buffer: pinned on the card, so that the whole upload
    is one asynchronous copy; on the CPU the host buffer is the device
    buffer itself.

    ``t[name]`` is a field's device view, ``host[name]`` its view in the
    host buffer and ``np[name]`` that view as numpy (fields whose dtype
    numpy has; a uint32 field is uint32 here and int32 on the device)."""

    def __init__(self, fields, device: torch.device):
        device = torch.device(device)
        specs, o = [], 0
        for name, shape, dtype in fields:
            tdt = _torch_dtype(dtype)
            n = int(np.prod(shape, dtype=np.int64)) * tdt.itemsize
            specs.append((name, tuple(shape), dtype, tdt, o, n))
            o += -(-n // _ALIGN) * _ALIGN
        self.dev = torch.zeros(max(o, 1), dtype=torch.uint8, device=device)
        self.buf = (self.dev if device.type == "cpu" else
                    torch.zeros(max(o, 1), dtype=torch.uint8,
                                pin_memory=True))
        self._read = None if device.type == "cpu" else torch.cuda.Event()
        self.t, self.host, self.np = {}, {}, {}
        for name, shape, dtype, tdt, o, n in specs:
            self.t[name] = self.dev[o:o + n].view(tdt).view(shape)
            h = self.buf[o:o + n].view(tdt).view(shape)
            self.host[name] = h
            if tdt != torch.bfloat16:
                a = h.numpy()
                self.np[name] = (a if isinstance(dtype, torch.dtype)
                                 else a.view(np.dtype(dtype)))

    def upload(self) -> None:
        """Enqueue the host buffer's copy to the device on the current
        stream; an event marks when the host buffer is free again."""
        if self.buf is not self.dev:
            self.dev.copy_(self.buf, non_blocking=True)
            self._read.record()

    def stage(self, values: Dict[str, object]) -> None:
        """Fill fields from ``values`` (name -> numpy array or tensor of the
        field's shape): host values through the host buffer and one upload,
        which first waits for the last upload to have read the buffer; a
        value already on the card copied device to device into its field,
        after the upload."""
        on_card = {n: v for n, v in values.items()
                   if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
        host = {n: v for n, v in values.items() if n not in on_card}
        if host:
            if self._read is not None:
                self._read.synchronize()
            for name, v in host.items():
                self.host[name].copy_(torch.as_tensor(v))
            self.upload()
        for name, v in on_card.items():
            self.t[name].copy_(v)


class Prepared:
    """A body made ready to run again: on the card its CUDA graph and the
    kernel counters' deltas one replay adds, on the CPU the body itself.
    ``replay()`` replays the graph and adds its deltas (``_counters.add``),
    so that the counters count the launches of replays too; on the CPU it
    runs the body."""

    __slots__ = ("body", "graph", "launches", "cost")

    def __init__(self, body: Callable[[], None], graph=None, launches=None,
                 cost=None):
        self.body, self.graph, self.launches = body, graph, launches
        self.cost = cost

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def replay(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        _counters.add(self.launches)


class Graphs:
    """Prepares bodies on one device.  On the card every graph goes into
    one memory pool, made at the first capture and freed with the last
    graph: its owner replays one graph at a time, and a graph keeps
    nothing in the pool from one replay to the next that another needs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = None

    def prepare(self, body: Callable[[], None],
                count: bool = False) -> Prepared:
        """On the card ``capture`` ``body`` into the pool; on the CPU run
        it once.  With ``count`` that first run's work goes to the
        returned ``cost`` ({} when the count failed)."""
        if self.device.type != "cuda":
            cost = _first_run(body, count)
            return Prepared(body, cost=cost)
        if self._pool is None:
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()
        return capture(body, self._pool, self.device, count)


def _first_run(body: Callable[[], None], count: bool):
    """Run ``body`` once; with ``count`` under ``obs.prof.analyze``, and if
    the count fails, once more uncounted (the cost is then {}: attribution
    never breaks a preparation).  Returns the cost, None uncounted."""
    if not count:
        body()
        return None
    from ..obs import prof

    try:
        return prof.analyze(body)
    except Exception:  # noqa: BLE001 — the body's own error re-raises below
        body()
        return {}


def capture(body: Callable[[], None], pool, device,
            count: bool = False) -> Prepared:
    """Run ``body()`` once eagerly on a side stream (first-use work, such
    as loading a kernel library, creating cuBLAS handles or starting
    autograd's device thread, may not happen inside a capture), then
    capture a second call into a CUDA graph in the memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``).  The capture launches nothing,
    so the kernel counters it moved are restored, and their deltas go to
    the returned ``Prepared`` for its replays to add."""
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            cost = _first_run(body, count)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _counters.snapshot()
        try:
            with torch.cuda.graph(graph, pool=pool):
                body()
        finally:
            after = _counters.snapshot()
            _counters.restore(before)
    return Prepared(body, graph, _counters.delta(before, after), cost)
