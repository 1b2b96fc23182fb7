"""The dropout counter map of a rank's slice (``ops/dropout.py``
``CounterMap``, ``parallel/strategy.py`` ``StepLayout.counter_map``) on
the CPU: every rank of a {dp 2, sp 2, tp 2} mesh draws, at its slice, the
bits of the global tensor's mask, which is JAX's ``bernoulli`` bit for bit
(rows over dp, the sequence contiguous or striped over sp, the last dim
over tp: the one-level map of a tp slice alone and the two-level map of a
tp slice inside a sequence slice).  The CUDA kernel's mapped walk
(``dropout_mask_kernel<T, kMapped>``: a thread's first index divided
once, then quotients and remainders advanced by the grid stride's, one
carry at most each) is transcribed and held to ``global_index`` at launch
shapes that make every carry happen.  Exact equality throughout."""
import itertools

import jax
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.dropout import (CounterMap, ThreefryKey,
                                          global_index, keep_mask)
from paddle_tpu_torch.param_attr import SeqAxis
from paddle_tpu_torch.parallel.mesh import Mesh
from paddle_tpu_torch.parallel.strategy import StepLayout, seq_index

KEY = ThreefryKey(11, 3, 5)
P = 0.3


def _layout(rank, striped, axes=("dp", "sp", "tp")):
    mesh = Mesh(np.arange(8).reshape(2, 2, 2), axes, rank)
    return StepLayout(mesh, "dp", SeqAxis("sp", striped=striped), 8)


def _slice(a, lay, seq, col, batch=True):
    """The rank's slice of the global array ``a``."""
    mesh = lay.mesh
    if batch:
        k = a.shape[0] // 2
        a = a[mesh.coord("dp") * k:(mesh.coord("dp") + 1) * k]
    if seq:
        a = np.take(a, seq_index(a.shape[1], 2, mesh.coord("sp"),
                                 lay.seq_axis.striped), axis=1)
    if col:
        w = a.shape[-1] // 2
        a = a[..., mesh.coord("tp") * w:(mesh.coord("tp") + 1) * w]
    return a


def test_global_mask_is_jax_bernoulli():
    shape = (4, 8, 3, 6)
    k0, k1 = KEY.words()
    jkey = jax.random.wrap_key_data(np.array([k0, k1], np.uint32),
                                    impl="threefry2x32")
    want = np.asarray(jax.random.bernoulli(jkey, 1 - P, shape))
    np.testing.assert_array_equal(keep_mask(KEY, shape, P).numpy(), want)


@pytest.mark.parametrize("seq,col,striped", [
    (True, False, False), (True, False, True), (False, True, False),
    (True, True, False), (True, True, True)])
def test_every_rank_draws_its_slice_of_the_global_mask(seq, col, striped):
    gshape = (4, 8, 3, 6)
    whole = keep_mask(KEY, gshape, P).numpy()
    for rank in range(8):
        lay = _layout(rank, striped)
        want = _slice(whole, lay, seq, col)
        cmap = lay.counter_map(want.shape, lay.seq_axis if seq else None,
                               True, "tp" if col else None)
        if col:
            assert cmap.row > 0 and (cmap.row2 > 0) == seq
        got = keep_mask(KEY, want.shape, P, cmap=cmap).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")


def test_tp_slice_of_a_replicated_tensor():
    """A non-batch tensor with its last dim over tp: columns only."""
    whole = keep_mask(KEY, (5, 8), P).numpy()
    for rank in range(8):
        lay = _layout(rank, False)
        want = _slice(whole, lay, False, True, batch=False)
        cmap = lay.counter_map(want.shape, None, False, "tp")
        np.testing.assert_array_equal(
            keep_mask(KEY, want.shape, P, cmap=cmap).numpy(), want)


def _kernel_walk(n, cmap: CounterMap, threads, blocks):
    """The global indices ``dropout_mask_kernel`` draws for local indices
    0..n-1, thread by thread as the ``.cu`` advances them."""
    out = np.full(n, -1, np.int64)
    stride = threads * blocks
    mode = 0 if cmap.row == 0 else (1 if cmap.row2 == 0 else 2)
    for t0 in range(stride):
        i = t0
        r = c = dr = dc = q = dq = qrow = 0
        if mode > 0:
            r, c = divmod(i, cmap.row)
            dr, dc = divmod(stride, cmap.row)
        if mode == 2:
            qrow = cmap.row // cmap.row2
            q, c = divmod(c, cmap.row2)
            dq, dc = divmod(dc, cmap.row2)
        while i < n:
            if mode == 1:
                g = (cmap.base + r * cmap.stride
                     + (cmap.off0 if c < cmap.seg else cmap.off1) + c)
                r += dr
                c += dc
                if c >= cmap.row:
                    c -= cmap.row
                    r += 1
            elif mode == 2:
                g = (cmap.base + r * cmap.stride
                     + ((cmap.off0 if q < cmap.seg else cmap.off1) + q)
                     * cmap.stride2 + cmap.off2 + c)
                r += dr
                c += dc
                if c >= cmap.row2:
                    c -= cmap.row2
                    q += 1
                q += dq
                if q >= qrow:
                    q -= qrow
                    r += 1
            else:
                g = cmap.base + i
            assert out[i] == -1
            out[i] = g
            i += stride
    return out


@pytest.mark.parametrize("striped,col", itertools.product((False, True),
                                                          (False, True)))
@pytest.mark.parametrize("threads,blocks", [(1, 1), (7, 3), (32, 5),
                                            (256, 1)])
def test_kernel_walk_matches_global_index(striped, col, threads, blocks):
    lay = _layout(5, striped)
    shape = (2, 4, 3, 6 if col else 12)
    cmap = lay.counter_map(shape, lay.seq_axis, True, "tp" if col else None)
    n = int(np.prod(shape))
    want = global_index(torch.arange(n, dtype=torch.int64), cmap).numpy()
    np.testing.assert_array_equal(_kernel_walk(n, cmap, threads, blocks),
                                  want)


def test_kernel_source_takes_the_two_level_map():
    """The .cu's CounterMap and launch carry the second level, and the
    plain version's argument list matches the binding's."""
    import pathlib

    src = (pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"
           / "ops" / "csrc" / "dropout.cu").read_text()
    assert "int64_t base, row, stride, seg, off0, off1, row2, stride2, off2" \
        in src
    assert "dropout_mask_kernel<T, 2>" in src
    assert len(CounterMap._fields) == 9
