"""B8 (``csrc/deform_sample.cu``, ``sample_cuda``): the kernel's partition of
samples and channels over threads, and its arithmetic, emulated in plain
numpy / torch on the CPU, held against the port's ``sample_plain`` and
against the JAX ``_sample_pallas`` (the Pallas kernel in TPU interpret mode,
as tests/test_torch_mask2former.py runs it).

The partition: the entry picks the widest access (16, 8 or 4 bytes, else one
element) that divides a sample's C * itemsize bytes and both pointers'
alignment; a sample's channels are ``tps`` such vectors, taken by ``lanes =
min(tps, 256)`` threads of a 256-thread block (each striding over the
vectors by ``lanes``), so a block row holds ``256 // lanes`` samples, one a
thread group. Blocks are persistent: the grid is min(block rows, SMs x
blocks a SM), and block k takes the k-th of that many contiguous runs of
block rows. The arithmetic:
x = xn * W - 0.5 and y in fp32, the taps' in-plane predicates on floor(x),
floor(y) in fp32, taps outside read as zero, the lerp in fp32 in the order
top = v00 (1 - fx) + v01 fx, bot likewise, out = top (1 - fy) + bot fy,
rounded once to the value's dtype. The kernel itself runs only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops import deform_attn as jdeform
from vfmseg_tpu_torch.ops.deform_attn import sample_plain

THREADS = 256
SMS, PER_SM = 132, 5
# (name, [B, H, W, C], N, dtype, offset of the value's data in bytes): the
# eval level's 32 bf16 channels (16-byte accesses, 4 threads a sample) and
# in fp32 (8 threads), 5 channels (one element an access, 5 threads, 51
# samples a block row), 64 channels, 36 channels 8 bytes off a 16-byte
# boundary (8-byte accesses), and 4104 channels (513 vectors a sample: 256
# threads stride over them); N is no multiple of a block's samples
CASES = [("c32_bf16", (3, 8, 8, 32), 1100, torch.bfloat16, 0),
         ("c32_fp32", (3, 8, 8, 32), 700, torch.float32, 0),
         ("c5_bf16", (2, 7, 9, 5), 333, torch.bfloat16, 0),
         ("c5_fp32", (2, 7, 9, 5), 333, torch.float32, 0),
         ("c64_bf16", (2, 6, 6, 64), 517, torch.bfloat16, 0),
         ("c36_offset", (2, 5, 7, 36), 130, torch.bfloat16, 8),
         ("c4104_bf16", (1, 3, 4, 4104), 5, torch.bfloat16, 0)]


def vec_bytes(c, item, value_off=0, out_off=0):
    """The entry's access width in bytes."""
    vb = 16
    while vb > item:
        if (c * item) % vb == 0 and value_off % vb == 0 and out_off % vb == 0:
            return vb
        vb //= 2
    return item


def partition(samples, c, item, value_off=0):
    """[samples, C] counts of the kernel's writes of each (sample, channel),
    with the launch's geometry."""
    vb = vec_bytes(c, item, value_off)
    elems = vb // item
    tps = c // elems
    lanes = min(tps, THREADS)
    rows = THREADS // lanes
    block_rows = -(-samples // rows)
    grid = min(block_rows, SMS * PER_SM)
    writes = np.zeros((samples, c), np.int64)
    tid = np.arange(THREADS)
    slot, sl = tid // lanes, tid % lanes
    live_t = slot < rows
    for blk in range(grid):
        for g in range(block_rows * blk // grid,
                       block_rows * (blk + 1) // grid):
            s = g * rows + slot
            ok = live_t & (s < samples)
            for vi0 in range(0, tps, lanes):
                vi = vi0 + sl
                use = ok & (vi < tps)
                for e in range(elems):
                    np.add.at(writes, (s[use], vi[use] * elems + e), 1)
    return writes, dict(vec=vb, tps=tps, lanes=lanes, rows=rows,
                        block_rows=block_rows, grid=grid)


def emulate(value, xn, yn):
    """The kernel's arithmetic: fp32 from any value dtype, rounded once."""
    b, h, w, c = value.shape
    v = value.float().reshape(b, h * w, c)
    x = xn * w - 0.5
    y = yn * h - 0.5
    xf, yf = torch.floor(x), torch.floor(y)
    fx, fy = (x - xf)[..., None], (y - yf)[..., None]
    in_x0 = (xf >= 0) & (xf <= w - 1)
    in_x1 = (xf >= -1) & (xf <= w - 2)
    in_y0 = (yf >= 0) & (yf <= h - 1)
    in_y1 = (yf >= -1) & (yf <= h - 2)
    x0 = torch.where(in_x0 | in_x1, xf, torch.zeros_like(xf)).long()
    y0 = torch.where(in_y0 | in_y1, yf, torch.zeros_like(yf)).long()

    def tap(dy, dx, inside):
        idx = ((y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1))
        got = torch.gather(v, 1, idx[..., None].expand(b, idx.shape[1], c))
        return torch.where(inside[..., None], got, torch.zeros_like(got))

    top = tap(0, 0, in_y0 & in_x0) * (1 - fx) + tap(0, 1, in_y0 & in_x1) * fx
    bot = tap(1, 0, in_y1 & in_x0) * (1 - fx) + tap(1, 1, in_y1 & in_x1) * fx
    return (top * (1 - fy) + bot * fy).to(value.dtype)


def _case(shape, n, dtype, seed):
    """Seeded value and coordinates in [-0.2, 1.2], a few of them far
    outside (+-1e6)."""
    rs = np.random.RandomState(seed)
    value = torch.from_numpy(rs.standard_normal(shape).astype(
        np.float32)).to(dtype)
    xn, yn = (torch.from_numpy(rs.uniform(-0.2, 1.2, (shape[0], n)).astype(
        np.float32)) for _ in range(2))
    xn[0, :4] = torch.tensor([1e6, -1e6, 0.5, 1e6])
    yn[0, :4] = torch.tensor([0.5, 0.5, -1e6, 1e6])
    return value, xn, yn


@pytest.mark.parametrize("name,shape,n,dtype,off", CASES)
def test_partition_writes_each_channel_once(name, shape, n, dtype, off):
    """Every (sample, channel) of the output is written by exactly one
    thread, whatever the access width, threads a sample and ragged end."""
    item = torch.empty((), dtype=dtype).element_size()
    writes, geo = partition(shape[0] * n, shape[3], item, off)
    assert (writes == 1).all(), geo
    want_vec = {"c32_bf16": 16, "c32_fp32": 16, "c5_bf16": 2, "c5_fp32": 4,
                "c64_bf16": 16, "c36_offset": 8, "c4104_bf16": 16}[name]
    assert geo["vec"] == want_vec
    if name == "c32_bf16":
        assert geo["tps"] == 4 and geo["rows"] == 64
    if name == "c4104_bf16":
        assert geo["tps"] == 513 and geo["lanes"] == THREADS


@pytest.mark.parametrize("name,shape,n,dtype,off", CASES)
def test_arithmetic_matches_plain_and_zero_outside(name, shape, n, dtype,
                                                   off):
    """The kernel's arithmetic against sample_plain in fp32 on the same
    values (the same fp32 operations in the same order), rounded once to the
    value's dtype; taps outside the plane, and samples far outside, read
    zero."""
    value, xn, yn = _case(shape, n, dtype, seed=len(name) + n)
    got = emulate(value, xn, yn)
    want = sample_plain(value.float(), xn, yn)
    torch.testing.assert_close(got.float(), want.to(dtype).float(), atol=0,
                               rtol=0)
    h, w = shape[1], shape[2]
    outside = ((xn < -0.5 / w) | (xn > 1 + 0.5 / w) | (yn < -0.5 / h)
               | (yn > 1 + 0.5 / h))
    assert outside[0, :4].all()
    assert (got[outside] == 0).all()


@pytest.mark.parametrize("shape,n", [((3, 7, 9, 5), 40), ((2, 6, 6, 32), 130)])
def test_arithmetic_matches_pallas(shape, n):
    """The kernel's arithmetic in fp32 against the TPU kernel in interpret
    mode (N = 40 and 130, not multiples of its 128-sample block); fp32, atol
    1e-5 (the Pallas kernel contracts y first, with one-hot matrices)."""
    value, xn, yn = _case(shape, n, torch.float32, seed=n)
    jin = [jnp.asarray(t.numpy()) for t in (value, xn, yn)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdeform._sample_pallas(*jin))
    np.testing.assert_allclose(emulate(value, xn, yn).numpy(), want,
                               atol=1e-5, rtol=0)
