"""B1 (``csrc/layer_norm.cu``, ``layer_norm_cuda``): the warp-per-row
kernel's partition and arithmetic emulated in numpy on the CPU, held against
the port's ``layer_norm_plain`` and the JAX ``_ln_reference`` and its Pallas
kernels ``_ln_forward`` / ``_ln_forward_3d`` in TPU interpret mode.

The emulation follows the kernel:

* the choice of kernel: one 256-thread block a row where x and y lie at
  different addresses modulo 16 or a lane would hold more than 12 16-byte
  vectors; else the warp kernel, with weight and bias in registers where
  every row starts 16-byte aligned (x aligned, C a multiple of a vector)
  and a lane holds at most 4 vectors, staged in shared memory otherwise;
* each row's cut from its address: a head of h0 elements up to the first
  16-byte boundary (lane i < h0 takes element i), nvec 16-byte vectors
  (lane l takes vectors l, l + 32, ...), a tail (lane i < tl takes one);
* per lane an fp32 sum in that order, a butterfly of xor-shuffles over the
  32 lanes, mean = sum / C; the same for the centred squares; rstd =
  1 / sqrt(var + eps); y = (x - mean) * rstd * w + b, rounded to x's dtype;
* the staged (weight, bias) pairs' element-major layout ws[k][m] =
  (w, b)[kVec m + k] and the index each body element reads, and the
  persistent loop: min(rows / 4, resident) blocks of 4 warps, a warp taking
  rows w, w + 4 grid, ...

The kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops.norm import _ln_forward, _ln_forward_3d, _ln_reference
from vfmseg_tpu_torch.ops.norm import empty_at_offset_of, layer_norm_plain

VEC = {torch.bfloat16: 8, torch.float32: 4}   # elements a 16-byte vector
WARPS = 4          # warps (rows) a block
MAX_VPT = 12       # 16-byte vectors a lane, at most
MAX_REG_VPT = 4    # ... with weight and bias in registers
VPTS = (1, 2, 4, 8, 12)
# chip_smoke.py's LN_TOL: bf16 output rounding and another summation order;
# in fp32 only the order
TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
# the widths of the paths (the ViT's 1024, the decoder's 256, EVA02's
# SwiGLU sub-LN 2730) and odd ones off them, then MiT-B5's 64 and 320 (bf16
# rows of 8 and 40 vectors: lanes idle, lanes with 1 or 2)
WIDTHS = [1024, 256, 2730, 7, 2049, 64, 320]
DTYPES = [torch.bfloat16, torch.float32]


def kernel_choice(x_addr, y_addr, w_addr, b_addr, c, dtype):
    """("row", None), or ("warps", VPT, weights in registers?) as
    ``launch`` picks them."""
    kvec = VEC[dtype]
    vpt = (c // kvec + 31) // 32
    if (x_addr ^ y_addr) & 15 or vpt > MAX_VPT:
        return ("row", None, None)
    aligned = (x_addr % 16 == 0 and c % kvec == 0 and w_addr % 16 == 0
               and b_addr % 16 == 0)
    regs = aligned and vpt <= MAX_REG_VPT
    vpts = VPTS[:3] if regs else VPTS
    return ("warps", next(v for v in vpts if vpt <= v), regs)


def cut_row(addr, c, dtype):
    """(h0, nvec, tl) of a row starting at byte address ``addr``."""
    kvec = VEC[dtype]
    item = torch.empty((), dtype=dtype).element_size()
    mis = (addr % 16) // item
    h0 = min((kvec - mis) % kvec, c)
    nvec = (c - h0) // kvec
    return h0, nvec, c - h0 - nvec * kvec


def lane_columns(cut, lane, vpt, dtype):
    """The columns a lane holds, in the order it sums them."""
    h0, nvec, tl = cut
    kvec = VEC[dtype]
    cols = [lane] if lane < h0 else []
    for i in range(vpt):
        j = lane + 32 * i
        if j < nvec:
            cols += [h0 + kvec * j + e for e in range(kvec)]
    if lane < tl:
        cols.append(h0 + kvec * nvec + lane)
    return cols


def butterfly(parts):
    """The xor-shuffle sum over 32 lanes; every lane ends with the same
    value."""
    v = [np.float32(p) for p in parts]
    for off in (16, 8, 4, 2, 1):
        v = [np.float32(v[lane] + v[lane ^ off]) for lane in range(32)]
    assert all(x == v[0] for x in v)
    return v[0]


def lane_sum(values):
    """A lane's fp32 sum, element by element in order."""
    if len(values) == 0:
        return np.float32(0)
    return np.add.accumulate(np.asarray(values, np.float32),
                             dtype=np.float32)[-1]


def ln_schedule(x, w, b, eps, vpt):
    """y by the warp kernel's cut and arithmetic, row by row at each row's
    address, in x's dtype."""
    dtype = x.dtype
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    item = x.element_size()
    xs = rows.float().numpy()
    wn, bn = w.numpy(), b.numpy()
    out = np.zeros_like(xs)
    for r in range(rows.shape[0]):
        cut = cut_row(x.data_ptr() + r * c * item, c, dtype)
        lanes = [lane_columns(cut, lane, vpt, dtype) for lane in range(32)]
        row = xs[r]
        mean = np.float32(butterfly([lane_sum(row[cols]) for cols in lanes])
                          / np.float32(c))
        sq = [lane_sum((row[cols] - mean) * (row[cols] - mean))
              for cols in lanes]
        var = np.float32(butterfly(sq) / np.float32(c))
        rstd = np.float32(1) / np.sqrt(np.float32(var + np.float32(eps)))
        out[r] = (row - mean) * rstd * wn + bn
    return torch.from_numpy(out).to(dtype).reshape(x.shape)


def at_offset(shape, dtype, offset, seed):
    """Seeded x of ``shape`` starting ``offset`` elements past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    buf = torch.empty(n + offset + 16, dtype=dtype)
    start = (-buf.data_ptr() % 16) // buf.element_size() + offset
    x = buf[start:start + n].view(shape)
    data = np.random.RandomState(seed).standard_normal(shape)
    x.copy_(torch.from_numpy(data.astype(np.float32)))
    return x


def weights(c, seed):
    rs = np.random.RandomState(seed)
    w = torch.from_numpy((rs.standard_normal(c) * 0.1 + 1).astype(np.float32))
    b = torch.from_numpy((rs.standard_normal(c) * 0.1).astype(np.float32))
    return w, b


@pytest.mark.parametrize("c", WIDTHS + [1, 3079, 3080])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_column_held_once_at_every_offset(c, dtype):
    """At each start modulo 16 the row's cut holds every column exactly
    once across the 32 lanes, the body starts on a 16-byte boundary, the
    head and tail are shorter than a vector, and the lanes' vectors fit the
    VPT the launch picks."""
    item = torch.empty((), dtype=dtype).element_size()
    kvec = VEC[dtype]
    for mis in range(0, 16, item):
        cut = cut_row(mis, c, dtype)
        h0, nvec, tl = cut
        assert h0 < kvec and tl < kvec
        if nvec:
            assert (mis + h0 * item) % 16 == 0
        kind, vpt, _ = kernel_choice(mis, mis, 0, 0, c, dtype)
        if kind == "row":
            assert (c // kvec + 31) // 32 > MAX_VPT
            continue
        assert nvec <= 32 * vpt
        held = sorted(col for lane in range(32)
                      for col in lane_columns(cut, lane, vpt, dtype))
        assert held == list(range(c))


def test_rows_of_2730_cycle_through_four_heads():
    """EVA02's 2730-wide bf16 rows start 0, 4, 8, 12 bytes past a 16-byte
    boundary in turn: heads of 0, 6, 4, 2 elements, then 341 vectors and a
    tail of 2, 0, 6 or 4."""
    cuts = [cut_row(r * 2730 * 2, 2730, torch.bfloat16) for r in range(8)]
    assert cuts[:4] == [(0, 341, 2), (6, 340, 4), (4, 340, 6), (2, 341, 0)]
    assert cuts[4:] == cuts[:4]


@pytest.mark.parametrize("c,dtype,offset,want", [
    (1024, torch.bfloat16, 0, ("warps", 4, True)),
    (256, torch.bfloat16, 0, ("warps", 1, True)),
    (2730, torch.bfloat16, 0, ("warps", 12, False)),
    (2049, torch.bfloat16, 0, ("warps", 8, False)),
    (7, torch.bfloat16, 0, ("warps", 1, False)),
    (1024, torch.bfloat16, 5, ("warps", 4, False)),
    (1024, torch.float32, 0, ("warps", 8, False)),
    (256, torch.float32, 0, ("warps", 2, True)),
    (2730, torch.float32, 0, ("row", None, None)),
    (4096, torch.bfloat16, 0, ("row", None, None)),
])
def test_kernel_choice(c, dtype, offset, want):
    """The launch's choice at the paths' widths and off them; x and y at
    different addresses modulo 16 take the block-per-row kernel."""
    item = torch.empty((), dtype=dtype).element_size()
    addr = 4096 + offset * item
    assert kernel_choice(addr, addr, 0, 0, c, dtype) == want
    assert kernel_choice(addr, addr + item, 0, 0, c, dtype)[0] == "row"


@pytest.mark.parametrize("c", [2730, 2049, 7, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_weights_land_and_read_conflict_free(c, dtype):
    """The element-major staging ws[k * S + m] = w[kVec m + k], S =
    ceil(C / kVec) + 1: at every head h0 each body element's index reads
    its column's weight, and for each (vector i, element e) the lanes of a
    warp read consecutive words (no bank conflict)."""
    kvec = VEC[dtype]
    shift = kvec.bit_length() - 1
    stride = -(-c // kvec) + 1
    w = np.arange(c, dtype=np.float32) + 1
    staged = np.zeros(kvec * stride, np.float32)
    for col in range(c):
        staged[(col & (kvec - 1)) * stride + (col >> shift)] = w[col]
    for h0 in range(min(kvec, c + 1)):
        nvec = (c - h0) // kvec
        for i in range((nvec + 31) // 32):
            for e in range(kvec):
                q = h0 + e
                lanes = [lane for lane in range(32) if lane + 32 * i < nvec]
                at = [(q & (kvec - 1)) * stride + lane + 32 * i + (q >> shift)
                      for lane in lanes]
                assert at == list(range(at[0], at[0] + len(at)))
                cols = [h0 + kvec * (lane + 32 * i) + e for lane in lanes]
                assert list(staged[at]) == list(w[cols])
        for col in list(range(h0)) + list(range(h0 + kvec * nvec, c)):
            assert staged[(col & (kvec - 1)) * stride + (col >> shift)] == \
                w[col]


@pytest.mark.parametrize("rows,resident", [(18 * 1025, 132 * 3),
                                           (2049, 132 * 3), (1, 396),
                                           (7, 1), (33, 2)])
def test_persistent_loop_takes_each_row_once(rows, resident):
    """min(ceil(rows / 4), resident) blocks of 4 warps, warp w taking rows
    w, w + 4 grid, ...: every row exactly once."""
    grid = min(-(-rows // WARPS), resident)
    seen = np.zeros(rows, np.int64)
    for warp in range(grid * WARPS):
        seen[warp:rows:grid * WARPS] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_schedule_matches_plain_and_jax(c, dtype):
    """The kernel's arithmetic over its cut, on rows starting at every
    offset the width gives (x one element past a 16-byte boundary, so odd
    widths walk every head), against layer_norm_plain and the JAX
    _ln_reference and its Pallas kernels (_ln_forward on [rows, C],
    _ln_forward_3d on [lead, N, C]) in interpret mode: within chip_smoke's
    tolerance for the dtype."""
    shape = (2, 3, c)
    x = at_offset(shape, dtype, 1, c)
    w, b = weights(c, c + 1)
    kind, vpt, _ = kernel_choice(x.data_ptr(), x.data_ptr(), 0, 0, c, dtype)
    atol, rtol = TOL[dtype]
    want = layer_norm_plain(x, w, b, 1e-6).float()
    if kind == "warps":
        got = ln_schedule(x, w, b, 1e-6, vpt).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                   rtol=rtol)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy()).astype(jdtype)
    jw, jb = jnp.asarray(w.numpy()), jnp.asarray(b.numpy())
    with pltpu.force_tpu_interpret_mode():
        flat = _ln_forward(jx.reshape(-1, c), jw, jb, 1e-6)
        three = _ln_forward_3d(jx, jw, jb, 1e-6)
    for other in (_ln_reference(jx, jw, jb, 1e-6), flat.reshape(shape), three):
        np.testing.assert_allclose(
            np.asarray(other.astype(jnp.float32)), want.numpy(), atol=atol,
            rtol=rtol)


@pytest.mark.parametrize("offset", range(8))
def test_schedule_at_every_head_of_2730(offset):
    """EVA02's width with x 0-7 elements past a 16-byte boundary: every
    head length the kernel peels, against the plain version."""
    x = at_offset((5, 2730), torch.bfloat16, offset, 40 + offset)
    w, b = weights(2730, 41)
    got = ln_schedule(x, w, b, 1e-6, 12).float()
    want = layer_norm_plain(x, w, b, 1e-6).float()
    atol, rtol = TOL[torch.bfloat16]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_row(dtype):
    """A single row (the persistent loop's one warp) of 1024."""
    x = at_offset((1, 1024), dtype, 0, 7)
    w, b = weights(1024, 8)
    got = ln_schedule(x, w, b, 1e-5, 4 if dtype == torch.bfloat16 else 8)
    want = layer_norm_plain(x, w, b, 1e-5)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_output_lies_at_x_offset(dtype):
    """The wrapper's y starts where x does modulo 16 bytes, contiguous and
    of x's shape, so the kernel cuts both alike."""
    item = torch.empty((), dtype=dtype).element_size()
    for offset in range(16 // item):
        x = at_offset((3, 77), dtype, offset, offset)
        y = empty_at_offset_of(x)
        assert y.data_ptr() % 16 == x.data_ptr() % 16 == offset * item
        assert y.shape == x.shape and y.is_contiguous() and y.dtype == dtype
