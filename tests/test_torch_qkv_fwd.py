"""B2 and B3 (``csrc/attention_qkv.cu``, ``attention_qkv_tm`` and
``attention_fwd_lse_tm``): the warp-specialised kernel's schedule emulated
in plain torch on the CPU, held against the port's
``attention_plain`` / ``attention_fwd_lse_plain`` and against the JAX
``flash_attention_qkv_tm`` forward with the LSE its VJP keeps (the Pallas
kernels in TPU interpret mode, as tests/test_ops.py runs them); and the
geometry the kernel's TMA maps read the token-major views with.

The emulation walks the kernel's schedule: each view read through its map
(dims (64, H, N, B), element strides (1, 64, stride_n, stride_b) from the
view's start, rows past N zero-filled), query tiles of 128 rows as two
64-row slabs (a slab whose rows all lie past N computes nothing), key steps
of 128 keys, the last one a 16-key box where N mod 128 is in (0, 16], then
per step S = Q.K^T in fp32, keys past N at -inf, a running max m in log2
units (m = max(m, rowmax(S) * scale * log2 e)), P = 2^(S * scale * log2 e -
m) with the row sums taken in fp32 before P is rounded to bf16 for P.V (or
kept in fp32 to check the algebra), O and the sums rescaled by 2^(m_old -
m_new), O divided by the row sum once at the end and rounded to bf16, lse =
(m + log2(sum)) * ln 2; rows past N are dropped. The kernel itself runs only
on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops.flash_attention import (
    _flash_qkv_tm_fwd_rule,
    flash_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.attention import (
    attention_fwd_lse_plain,
    attention_plain,
    qkv_view_geometry,
    qkv_view_strides,
)

QUERIES = 128   # rows of a query tile
SLAB = 64       # rows of a consumer warpgroup
KEYS = 128      # keys of a K/V tile
TAIL = 16       # keys of the tail step
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# N: a single key step, a one-key and a 16-key tail, 17 keys (no tail: a
# whole second step), the decoder's ragged case, and DINOv2's refine and
# stage-1 lengths (a one-key tail, the last query tile one real row)
LENGTHS = [1, 16, 77, 129, 144, 145, 1025, 2049]
# the schedule in fp32 against the plain forward: the same algebra, with exp
# as 2^(x log2 e) and sums in another order
FP32_ATOL = 2e-5
# the kernel's numerics against the fp32 plain forward, as chip_smoke.py
# holds the kernel on the card: P rounds to bf16 before P.V and the output
# is bf16 (ATTN_ATOL); the LSE is fp32 sums in another order (LSE_ATOL)
ATTN_ATOL = 1e-2
LSE_ATOL = 1e-3
# against the Pallas kernels in interpret mode: the repo's attention budget
JAX_ATOL = 2e-4


def has_tail(n):
    """Whether the kernel's last key step is a 16-key box."""
    return n > KEYS and 0 < n % KEYS <= TAIL


def key_steps(n):
    """(first key, width) of each key step the kernel takes."""
    steps = [(k0, KEYS) for k0 in range(0, n, KEYS)]
    if has_tail(n):
        steps[-1] = (steps[-1][0], TAIL)
    return steps


def _views(b, n, h, fused, seed):
    """Seeded bf16 [B, N, H*64] q, k, v: the thirds of one fused qkv, or
    three tensors."""
    e = h * 64
    x = np.random.RandomState(seed).standard_normal((b, n, 3 * e))
    qkv = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    if fused:
        return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    return tuple(qkv[..., i * e:(i + 1) * e].clone() for i in range(3))


def tma_read(t, geometry, h, rows):
    """The [B, H, rows, 64] fp32 boxes of view t at token rows `rows`
    (a slice), read through the map's geometry: rows past N come back as
    zeros."""
    b, n, stride_b, stride_n = geometry
    grid = torch.as_strided(t, (b, n, h, 64), (stride_b, stride_n, 64, 1))
    box = grid[:, rows.start:min(rows.stop, n)].float().transpose(1, 2)
    return torch.nn.functional.pad(box, (0, 0, 0, rows.stop - rows.start
                                         - box.shape[2]))


def fwd_schedule(q, k, v, h, scale, *, round_bf16=True, strides=None):
    """(out [B, N, H*64], lse [B, H, N], slabs computed) by the kernel's
    schedule over token-major views, each read through its own map (element
    strides ``strides``, one (stride_b, stride_n) pair a view, by default
    ``qkv_view_strides`` of q, k, v); out in bf16 values (as fp32) with
    ``round_bf16``, else fp32."""
    if strides is None:
        strides = qkv_view_strides("fwd_schedule", h, q, k, v)[2]
    b, n = q.shape[:2]
    gq, gk, gv = ((b, n) + tuple(pair) for pair in strides)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E

    def rnd(x):
        return x.to(torch.bfloat16).float() if round_bf16 else x

    out = torch.zeros((b, h, n, 64))
    lse = torch.zeros((b, h, n))
    slabs = 0
    for row0 in range(0, -(-n // QUERIES) * QUERIES, SLAB):
        if row0 >= n:
            continue  # an idle consumer
        slabs += 1
        qs = tma_read(q, gq, h, slice(row0, row0 + SLAB))
        m = torch.full((b, h, SLAB), -torch.inf)
        l = torch.zeros((b, h, SLAB))
        o = torch.zeros((b, h, SLAB, 64))
        for k0, width in key_steps(n):
            ks = tma_read(k, gk, h, slice(k0, k0 + width))
            vs = tma_read(v, gv, h, slice(k0, k0 + width))
            s = qs @ ks.transpose(-1, -2)
            s = s.masked_fill(torch.arange(k0, k0 + width) >= n, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + rnd(p) @ vs
            m = m_new
        rows = slice(row0, min(row0 + SLAB, n))
        valid = rows.stop - rows.start
        out[:, :, rows] = rnd(o / l[..., None])[:, :, :valid]
        lse[:, :, rows] = ((m + torch.log2(l)) * LN2)[:, :, :valid]
    return out.transpose(1, 2).reshape(b, n, h * 64), lse, slabs


def _plain(q, k, v, h, scale):
    """attention_fwd_lse_plain in fp32 over the same values."""
    b, n, _ = q.shape
    out, lse = attention_fwd_lse_plain(
        *(t.float().reshape(b, n, h, 64) for t in (q, k, v)), scale=scale)
    return out.reshape(b, n, h * 64), lse


def _shape(n):
    """(B, H) at length n: an odd head count, smaller at the long lengths
    to keep the CPU time down."""
    return (1, 1) if n > 1100 else (2, 3)


def test_schedule_steps_and_slabs():
    """The schedule's structure: 16-key tails exactly where N mod 128 is in
    (0, 16] past the first tile, and a consumer idle on the last query tile
    exactly where N mod 128 is in (0, 64]."""
    assert [w for _, w in key_steps(1025)] == [KEYS] * 8 + [TAIL]
    assert [w for _, w in key_steps(2049)] == [KEYS] * 16 + [TAIL]
    assert [w for _, w in key_steps(144)] == [KEYS, TAIL]
    assert [w for _, w in key_steps(145)] == [KEYS, KEYS]
    assert [w for _, w in key_steps(1024)] == [KEYS] * 8
    assert [w for _, w in key_steps(16)] == [KEYS]
    for n, slabs in ((1025, 17), (1024, 16), (77, 2), (64, 1), (65, 2),
                     (2049, 33)):
        q, k, v = _views(1, n, 1, True, 0)
        assert fwd_schedule(q, k, v, 1, 0.125)[2] == slabs


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("fused", [True, False])
def test_schedule_in_fp32_matches_plain(n, fused):
    """With P kept in fp32 the schedule is the plain forward's algebra in
    another order: out and lse within FP32_ATOL, over fused thirds and
    three tensors."""
    b, h = _shape(n)
    q, k, v = _views(b, n, h, fused, n)
    out, lse, _ = fwd_schedule(q, k, v, h, 0.125, round_bf16=False)
    want, want_lse = _plain(q, k, v, h, 0.125)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=FP32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("n", LENGTHS)
def test_schedule_in_bf16_within_atol(n):
    """The kernel's numerics (P rounded to bf16 before P.V, a bf16 output)
    against the fp32 plain forward: out within ATTN_ATOL and lse within
    LSE_ATOL, the budgets chip_smoke.py holds the kernel to on the card; the
    bf16 plain twin (what a CPU caller gets) agrees as closely."""
    b, h = _shape(n)
    q, k, v = _views(b, n, h, True, n + 1)
    out, lse, _ = fwd_schedule(q, k, v, h, 0.125)
    want, want_lse = _plain(q, k, v, h, 0.125)
    assert float((out - want).abs().max()) <= ATTN_ATOL
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL
    twin = attention_plain(*(t.reshape(b, n, h, 64) for t in (q, k, v)),
                           scale=0.125).reshape(b, n, h * 64)
    assert float((twin.float() - want).abs().max()) <= ATTN_ATOL


JAX_CASES = [(2, 77, 2, True), (1, 1025, 2, True), (1, 1025, 2, False),
             (1, 2049, 2, True)]


@pytest.mark.parametrize("b,n,h,fused", JAX_CASES)
def test_schedule_matches_jax_forward(b, n, h, fused):
    """The schedule in fp32 against the JAX forwards in interpret mode:
    flash_attention_qkv_tm's primal and its VJP's forward rule, whose
    residuals hold the natural-log LSE (_fwd_kernel_qkv with with_lse). The
    TPU kernels take a fused qkv with an even head count; three tensors are
    handed to them concatenated, as the JAX package does. atol JAX_ATOL."""
    q, k, v = _views(b, n, h, fused, 50 + n)
    scale = 64 ** -0.5
    out, lse, _ = fwd_schedule(q, k, v, h, scale, round_bf16=False)
    qkv = jnp.asarray(torch.cat([q, k, v], -1).float().numpy())
    with pltpu.force_tpu_interpret_mode():
        primal = np.asarray(flash_attention_qkv_tm(qkv, h))
        fwd, res = _flash_qkv_tm_fwd_rule(qkv, h, scale)
    want_lse = np.asarray(res[1]).reshape(b, h, n)
    np.testing.assert_allclose(out.numpy(), primal, atol=JAX_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(fwd), atol=JAX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=JAX_ATOL, rtol=0)


def test_geometry_of_fused_thirds_and_three_tensors():
    """At DINOv2's train shape (4, 1025, 16 heads) the thirds of one fused
    qkv share (stride_b, stride_n) = (1025 * 3072, 3072) and start 2048
    bytes (H * 128) apart, whole 16 bytes; three tensors give (1025 * 1024,
    1024). Through the map's strides the emulation reads exactly the
    view's values."""
    b, n, h = 4, 1025, 16
    e = h * 64
    qkv = torch.zeros((b, n, 3 * e), dtype=torch.bfloat16)
    thirds = (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:])
    assert qkv_view_geometry("t", h, *thirds) == (b, n, n * 3 * e, 3 * e)
    starts = [t.data_ptr() for t in thirds]
    assert [s - starts[0] for s in starts] == [0, h * 128, 2 * h * 128]
    assert all(s % 16 == 0 for s in starts)
    three = torch.zeros((3, b, n, e), dtype=torch.bfloat16)
    assert qkv_view_geometry("t", h, *three) == (b, n, n * e, e)

    q, k, v = _views(2, 77, 3, True, 3)
    geometry = qkv_view_geometry("t", 3, q, k, v)
    for t in (q, k, v):
        box = tma_read(t, geometry, 3, slice(64, 192))
        assert box.shape == (2, 3, 128, 64)
        np.testing.assert_array_equal(
            box[:, :, :13].numpy(),
            t.float().reshape(2, 77, 3, 64)[:, 64:].transpose(1, 2).numpy())
        assert not box[:, :, 13:].any()


def test_geometry_refuses_what_a_map_cannot_read():
    """A view one element off the 16-byte grid, a token stride that is not
    whole 16 bytes, views of two strides, a feature width that is not H*64
    and a dtype other than bf16 are refused rather than copied; a batch of
    one may carry any batch stride."""
    b, n, h = 2, 33, 2
    e = h * 64
    off = torch.zeros((b, n, e + 1), dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        qkv_view_geometry("t", h, off, off, off)
    odd = torch.zeros((b, n, e + 4), dtype=torch.bfloat16)[..., :e]
    with pytest.raises(ValueError, match="multiples of 8"):
        qkv_view_geometry("t", h, odd, odd, odd)
    a = torch.zeros((b, n, e), dtype=torch.bfloat16)
    fused = torch.zeros((b, n, 3 * e), dtype=torch.bfloat16)[..., :e]
    with pytest.raises(ValueError, match="one stride"):
        qkv_view_geometry("t", h, a, fused, a)
    with pytest.raises(ValueError, match="head_dim"):
        qkv_view_geometry("t", h + 1, a, a, a)
    with pytest.raises(TypeError, match="bf16"):
        qkv_view_geometry("t", h, a.float(), a.float(), a.float())
    one = torch.as_strided(torch.zeros(4 * n * e, dtype=torch.bfloat16),
                           (1, n, e), (12345, e, 1))
    assert qkv_view_geometry("t", h, one, one, one) == (1, n, 12345, e)
