"""The fused deformable-attention core (``ops/deform_attn.py``
``ms_deform_attn``, the kernel ``csrc/deform_attn.cu``) on the CPU: its
plain twin ``ms_deform_attn_plain`` held against the kernel's partition and
arithmetic emulated in torch, against the training route
(``ms_deform_attn_levels``: ``sample_plain`` a level and the einsum) and
against the JAX package's ``ms_deform_attn_core``; and the route
``MSDeformAttention`` takes.

The kernel's arithmetic, per (crop, query, head), all in fp32: the softmax
of the head's L P logits (max, exp(x - max), over the sum); each location
as ``ref + off * float32(1 / W_l)``, the product rounded, then the sum;
B8's taps (``x = xn W - 0.5``, the in-plane predicates on floor(x) in fp32,
zero outside, top = v00 (1 - fx) + v01 fx, bot likewise, top (1 - fy) +
bot fy); ``acc += w_i sample_i`` over the levels, then the points; one
rounding to the value's dtype at the store. Its partition is emulated by
``partition`` (see its docstring). The kernel itself runs only on the card
(``tests/test_torch_deform_attn_card.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfmseg_tpu.ops import deform_attn as jdeform
from vfmseg_tpu_torch.models.heads import mask2former as m2f
from vfmseg_tpu_torch.ops.deform_attn import (
    ms_deform_attn,
    ms_deform_attn_levels,
    ms_deform_attn_plain,
)


def inputs(b, nq, shapes, heads, d, points, dtype, seed):
    """Seeded value, offsets, logits and reference points: offsets of a few
    pixels, every fifth query's thirty times as far, and reference points
    in [-0.1, 1.1], so taps and whole samples fall off the planes."""
    gen = torch.Generator().manual_seed(seed)
    lp = len(shapes) * points
    nv = sum(h * w for h, w in shapes)
    value = torch.randn(b, nv, heads * d, generator=gen).to(dtype)
    off = torch.randn(b, nq, heads * lp * 2, generator=gen) * 2
    off[:, ::5] *= 30
    logits = torch.randn(b, nq, heads * lp, generator=gen) * 2
    ref_x, ref_y = (torch.rand(nq, generator=gen) * 1.2 - 0.1
                    for _ in range(2))
    return value, off.to(dtype), logits.to(dtype), ref_x, ref_y


def emulate(value, offsets, logits, ref_x, ref_y, shapes, heads, points):
    """The kernel's arithmetic in torch fp32 (module docstring), before
    its one rounding."""
    b, nv, c = value.shape
    nq = offsets.shape[1]
    d, lp = c // heads, len(shapes) * points
    v = value.float().reshape(b * nv, heads, d)
    off = offsets.float().reshape(b, nq, heads, lp, 2)
    x = logits.float().reshape(b, nq, heads, lp)
    # numpy's fp32 exp: torch's can come out ~1e-4 off on one pool thread
    # the first time a process calls it
    ex = torch.from_numpy(np.exp((x - x.max(-1, keepdim=True).values).numpy()))
    wt = ex / ex.sum(-1, keepdim=True)
    crop = torch.arange(b)[:, None, None] * nv
    head = torch.arange(heads)[None, None, :]
    acc = torch.zeros(b, nq, heads, d)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        for p in range(points):
            i = lvl * points + p
            xn = ref_x[:, None] + off[..., i, 0] * np.float32(1.0 / w)
            yn = ref_y[:, None] + off[..., i, 1] * np.float32(1.0 / h)
            px, py = xn * w - 0.5, yn * h - 0.5
            xf, yf = torch.floor(px), torch.floor(py)
            fx, fy = (px - xf)[..., None], (py - yf)[..., None]
            in_x0, in_x1 = (xf >= 0) & (xf <= w - 1), (xf >= -1) & (xf <= w - 2)
            in_y0, in_y1 = (yf >= 0) & (yf <= h - 1), (yf >= -1) & (yf <= h - 2)
            x0 = torch.where(in_x0 | in_x1, xf, 0).long()
            y0 = torch.where(in_y0 | in_y1, yf, 0).long()

            def tap(dy, dx, inside):
                row = crop + start + (y0 + dy) * w + x0 + dx
                got = v[row.clamp(0, b * nv - 1), head]
                return torch.where(inside[..., None], got, 0.0)

            top = (tap(0, 0, in_y0 & in_x0) * (1 - fx)
                   + tap(0, 1, in_y0 & in_x1) * fx)
            bot = (tap(1, 0, in_y1 & in_x0) * (1 - fx)
                   + tap(1, 1, in_y1 & in_x1) * fx)
            acc = acc + wt[..., i, None] * (top * (1 - fy) + bot * fy)
        start += h * w
    return acc.reshape(b, nq, c)


WARPS = 8
SMS, PER_SM = 132, 3
PRE = 12  # offsets and logits a lane stages


def vec_bytes(c, item, offset=0):
    """The entry's access width: the widest of 16, 8, 4 bytes that divides
    a head's d * itemsize bytes and both pointers' alignment, else one
    element."""
    vb = 16
    while vb > item:
        if c * item % vb == 0 and offset % vb == 0:
            return vb
        vb //= 2
    return item


def partition(b, nq, heads, d, levels, points, item, offset=0):
    """[B, Nq, heads * d] counts of the kernel's writes, emulating its
    partition: a warp takes a tile of ``qpw`` neighbouring queries of one
    crop and head, as many as its lanes hold vectors of the head (``vph``
    a query) and can stage (``PRE`` offsets and logits a lane, ``lpi``
    lanes a query); tiles run crop by crop, head by head, queries fastest;
    the grid is min(block rows, SMS x PER_SM) persistent 8-warp blocks,
    block k taking the k-th of that many contiguous runs of block rows and
    warp w the w-th tile of each. Also checks that each query's 3 L P
    staged elements are loaded once each and fit the warp's buffers."""
    lp = levels * points
    elems = vec_bytes(d, item, offset) // item
    vph = d // elems
    staged = 32 // -(-3 * lp // PRE)
    qpw = min(32 // vph if vph < 32 else 1, staged)
    lpi = 32 // qpw
    loaded = np.zeros(3 * lp, int)
    for lane in range(qpw * lpi):
        loaded[[lane % lpi + k * lpi for k in range(PRE)
                if lane % lpi + k * lpi < 3 * lp]] += 1
    assert (loaded == qpw).all()
    assert qpw * 3 * lp <= 32 * PRE and qpw * lp <= 32 * PRE // 3
    chunks = -(-nq // qpw)
    tiles = b * heads * chunks
    block_rows = -(-tiles // WARPS)
    grid = min(block_rows, SMS * PER_SM)
    rows = np.concatenate([np.arange(block_rows * k // grid,
                                     block_rows * (k + 1) // grid)
                           for k in range(grid)])
    t = (rows[:, None] * WARPS + np.arange(WARPS)).ravel()
    t = t[t < tiles]
    bh, q0 = t // chunks, t % chunks * qpw
    v = np.arange(qpw * vph)
    q = q0[:, None] + v // vph
    ch = (bh % heads * d)[:, None] + v % vph * elems
    row = (bh // heads)[:, None] * nq + q
    keep = q < nq
    flat = ((row * heads * d + ch)[keep][:, None] + np.arange(elems)).ravel()
    counts = np.bincount(flat, minlength=b * nq * heads * d)
    return counts.reshape(b, nq, heads * d)


def jax_core(value, offsets, logits, ref_x, ref_y, shapes, heads, points):
    """The JAX package's ``ms_deform_attn_core`` in fp32 from the same
    projections' outputs: the fp32 softmax and locations laid out as its
    pixel decoder lays them (Nq last)."""
    b, _, c = value.shape
    nq, levels, d = offsets.shape[1], len(shapes), c // heads
    off = offsets.float().numpy().reshape(b, nq, heads, levels, points, 2)
    x = logits.float().numpy().reshape(b, nq, heads, levels * points)
    ex = np.exp(x - x.max(-1, keepdims=True))
    wts = (ex / ex.sum(-1, keepdims=True)).reshape(
        b, nq, heads, levels, points).transpose(0, 2, 3, 4, 1)
    inv = [(np.float32(1.0 / w), np.float32(1.0 / h)) for h, w in shapes]
    loc = [np.stack([ref.numpy()[None, None, None]
                     + off[..., lvl, :, axis].transpose(0, 2, 3, 1)
                     * inv[lvl][axis] for lvl in range(levels)], axis=2)
           for axis, ref in ((0, ref_x), (1, ref_y))]
    vals, start = [], 0
    v = value.float().numpy()
    for h, w in shapes:
        vals.append(jnp.asarray(v[:, start:start + h * w].reshape(
            b, h, w, heads, d)))
        start += h * w
    out = jax.jit(jdeform.ms_deform_attn_core)(
        vals, jnp.asarray(loc[0]), jnp.asarray(loc[1]), jnp.asarray(wts))
    return torch.from_numpy(np.array(out))


# (name, B, Nq, level shapes, heads, d, points, dtype, byte offset of the
# value's and the output's data): Rein's 8 heads of 32 in bf16 (16-byte
# lanes, 4 a query, 8 queries a tile) and fp32 over three levels, one level
# of one point, four levels, 8 channels a head (one lane a query, 10
# queries a tile: what its lanes can stage), 64 in fp32 (16 lanes a query),
# the 32 L P a head that limit a tile to 4 queries, and data 4 and 2 bytes
# off a 16-byte boundary (4-byte and one-element accesses); Nq is no
# multiple of a tile's or a block's queries, and the planes are small, so
# taps fall off every edge
CASES = [
    ("l3_p4_bf16", 2, 77, ((4, 4), (8, 8), (3, 5)), 8, 32, 4,
     torch.bfloat16, 0),
    ("l3_p4_fp32", 2, 77, ((4, 4), (8, 8), (3, 5)), 8, 32, 4,
     torch.float32, 0),
    ("l1_p1_bf16", 3, 41, ((5, 7),), 8, 32, 1, torch.bfloat16, 0),
    ("l4_p4_bf16", 1, 101, ((3, 4), (6, 8), (12, 16), (2, 2)), 8, 32, 4,
     torch.bfloat16, 0),
    ("d8_bf16", 2, 50, ((4, 4), (8, 8), (16, 16)), 8, 8, 4, torch.bfloat16,
     0),
    ("d64_fp32", 2, 45, ((4, 4), (8, 8), (16, 16)), 4, 64, 4, torch.float32,
     0),
    ("lp32_fp32", 1, 40, ((6, 6), (3, 3)), 1, 32, 16, torch.float32, 0),
    ("off4_bf16", 2, 30, ((4, 4), (8, 8)), 8, 32, 4, torch.bfloat16, 4),
    ("off2_bf16", 1, 30, ((4, 4), (3, 3)), 3, 6, 2, torch.bfloat16, 2),
]
# against the JAX core (each of its ops compiles for each shape): three
# levels, four, and 64 channels a head
JAX_CASES = {"l3_p4_bf16", "l4_p4_bf16", "d64_fp32"}
# the twin's output against the emulation before its rounding: bf16 rounds
# once (half an ulp, at most 2^-8 relative), and both sum in fp32 in their
# own orders
TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -8),
       torch.float32: dict(atol=1e-5, rtol=1e-5)}


@pytest.mark.parametrize(
    "name, b, nq, shapes, heads, d, points, dtype, offset", CASES,
    ids=[c[0] for c in CASES])
def test_twin_matches_kernel_partition_arithmetic_levels_route_and_jax(
        name, b, nq, shapes, heads, d, points, dtype, offset):
    item = torch.empty((), dtype=dtype).element_size()
    counts = partition(b, nq, heads, d, len(shapes), points, item, offset)
    assert (counts == 1).all()
    args = inputs(b, nq, shapes, heads, d, points, dtype, seed=nq + d)
    got = ms_deform_attn(*args, shapes, heads, points)
    assert got.shape == (b, nq, heads * d) and got.dtype == dtype
    torch.testing.assert_close(got, ms_deform_attn_plain(
        *args, shapes, heads, points))
    torch.testing.assert_close(
        got.float(), emulate(*args, shapes, heads, points), **TOL[dtype])
    # in fp32 from the same (exactly upcast) outputs: the training route
    # and the JAX core, which round nothing here either
    f32 = [t.float() for t in args]
    twin = ms_deform_attn_plain(*f32, shapes, heads, points)
    values, start = [], 0
    for h, w in shapes:
        values.append(f32[0][:, start:start + h * w].reshape(b, h, w, -1))
        start += h * w
    levels = ms_deform_attn_levels(values, *f32[1:], heads, points)
    torch.testing.assert_close(twin, levels, atol=1e-5, rtol=1e-5)
    if name in JAX_CASES:
        torch.testing.assert_close(
            twin, jax_core(*f32, shapes, heads, points), atol=1e-5,
            rtol=1e-5)
    if dtype == torch.bfloat16:
        # one rounding: within half a bf16 ulp of the fp32 twin
        torch.testing.assert_close(got.float(), twin, atol=1e-5,
                                   rtol=2.0 ** -8)


def _attention(dtype):
    torch.manual_seed(5)
    attn = m2f.MSDeformAttention(embed_dims=64, num_heads=8, num_levels=3,
                                 num_points=4, dtype=dtype)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2)
    shapes = ((4, 4), (8, 8), (3, 5))
    nv = sum(h * w for h, w in shapes)
    gen = torch.Generator().manual_seed(6)
    value = torch.randn(2, nv, 64, generator=gen).to(dtype)
    query = torch.randn(2, nv, 64, generator=gen).to(dtype)
    ref_x, ref_y = m2f._reference_points(shapes, torch.device("cpu"))
    return attn, (query, value, shapes, ref_x, ref_y)


def _spy(monkeypatch):
    """Count the calls of each route's core as mask2former.py calls them."""
    calls = {"fused": 0, "levels": 0}
    for key, name in (("fused", "ms_deform_attn"),
                      ("levels", "ms_deform_attn_levels")):
        real = getattr(m2f, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(m2f, name, counted)
    return calls


def test_route_by_what_needs_a_gradient(monkeypatch):
    """MSDeformAttention takes the fused core where nothing needs a
    gradient (no_grad, inference_mode, or no parameter and no input
    requiring one) and matches the grad route within bf16 rounding: the
    grad route rounds the weights, each level's sum and the level adds to
    bf16, the fused core rounds once, each after the same bf16 projections.
    Wherever a gradient is wanted it
    keeps the grad route, whose backward reaches the value."""
    calls = _spy(monkeypatch)
    attn, args = _attention(torch.bfloat16)
    with torch.no_grad():
        fused = attn(*args)
    assert calls == {"fused": 1, "levels": 0}
    with torch.inference_mode():
        torch.testing.assert_close(attn(*args), fused, atol=0, rtol=0)
    assert calls == {"fused": 2, "levels": 0}
    grad_route = attn(*args)
    assert grad_route.requires_grad and calls == {"fused": 2, "levels": 1}
    attn.requires_grad_(False)
    torch.testing.assert_close(attn(*args), fused, atol=0, rtol=0)
    assert calls == {"fused": 3, "levels": 1}
    value = args[1].clone().requires_grad_(True)
    out = attn(args[0], value, *args[2:])
    assert calls == {"fused": 3, "levels": 2}
    out.float().square().sum().backward()
    assert value.grad is not None and value.grad.abs().sum() > 0
    # the two routes within bf16 rounding of each other, in the units of
    # the output's largest entry: the core's roundings carried through the
    # bf16 output projection, a few ulps at the top of the range and far
    # less on average
    scale = float(fused.float().abs().max())
    diff = (fused.float() - grad_route.detach().float()).abs()
    assert float(diff.max()) <= scale * 2.0 ** -5
    assert float(diff.mean()) <= scale * 2.0 ** -9
