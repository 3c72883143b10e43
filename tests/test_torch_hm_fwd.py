"""B5's forward (``csrc/attention_hm.cu``, ``attention_hm_fwd``): its
schedule emulated in plain torch on the CPU, held against the port's
``attention_fwd_lse_plain`` and against the JAX forwards of
``flash_attention_headmajor`` and ``flash_attention(bias=)`` (the Pallas
kernels in TPU interpret mode, as tests/test_ops.py runs them); and the
route that runs B3's backward (B4's function) on B5's fused backward, over
``[B, H, N, 64]`` views of the token-major tensors.

The emulation walks the kernel's schedule: q zero-filled to whole
128-query blocks, k, v and the bias to whole 64-key tiles, then per key
tile S = Q.K^T in fp32, the scores in log2 units (y = s * scale * log2 e,
plus bias * log2 e with a bias), keys >= Nk at -inf, a running max m, P =
2^(y - m) with the row sums taken in fp32 before P is rounded to bf16 for
P.V (or kept in fp32 to check the algebra), O and the sums rescaled by
2^(m_old - m_new), O divided by the row sum once at the end and rounded to
bf16, lse = (m + log2(sum)) * ln 2; rows >= Nq are dropped. The kernel
itself runs only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops.flash_attention import (
    flash_attention,
    flash_attention_headmajor,
    flash_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.attention import (
    _heads_hm,
    _hm_strides_ok,
    attention_bwd_plain,
    attention_bwd_tm,
    attention_fwd_lse_plain,
)

QUERIES = 128   # queries a block (two warpgroups of 64)
KEYS = 64       # keys a tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# (Nq, Nk): a ragged Nq != Nk case, SAM's windows (Nk = 196: 4 real keys in
# the last key tile) and EVA02's train length (Nq = 1025: one real row in
# the last query block)
LENGTHS = [(77, 130), (196, 196), (1025, 1025)]
# None; a bf16 or fp32 [B, H, Nq, Nk] bias; a bf16 bias broadcast over the
# heads (a stride-0 view of [B, 1, Nq, Nk])
BIASES = [None, "bf16", "fp32", "bf16_heads"]
# the schedule in fp32 against the plain forward: the same algebra, with
# exp as 2^(x log2 e) and sums in another order
FP32_ATOL = 2e-5
# the kernel's numerics against the fp32 plain forward, as chip_smoke.py
# holds the kernel on the card: P rounds to bf16 before P.V and the output
# is bf16 (ATTN_ATOL); the LSE is fp32 sums in another order (LSE_ATOL)
ATTN_ATOL = 1e-2
LSE_ATOL = 1e-3
# against the Pallas kernels in interpret mode: the repo's attention budget
JAX_ATOL = 2e-4


def _bf16(shape, seed, scale=1.0):
    """Seeded normals rounded to bf16, as fp32."""
    x = np.random.RandomState(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


def _inputs(nq, nk, d, bias_kind, b=2, h=2, seed=0):
    """Head-major q [B, H, Nq, D], k, v [B, H, Nk, D] and the bias view (or
    None)."""
    q = _bf16((b, h, nq, d), seed)
    k, v = _bf16((b, h, nk, d), seed + 1), _bf16((b, h, nk, d), seed + 2)
    bias = None
    if bias_kind == "bf16_heads":
        bias = _bf16((b, 1, nq, nk), seed + 3, 0.5).to(torch.bfloat16)
        bias = bias.expand(b, h, nq, nk)
    elif bias_kind == "bf16":
        bias = _bf16((b, h, nq, nk), seed + 3, 0.5).to(torch.bfloat16)
    elif bias_kind == "fp32":
        # fp32 values off bf16's grid
        bias = torch.from_numpy((np.random.RandomState(seed + 3)
                                 .standard_normal((b, h, nq, nk)) * 0.5)
                                .astype(np.float32))
    return q, k, v, bias


def _tok(t):
    return t.transpose(1, 2)


def _pad_rows(t, n):
    """Zero-fill dim 2 to n rows (the kernel's loads past Nq or Nk)."""
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


def fwd_schedule(q, k, v, scale, bias=None, *, round_bf16=True):
    """(out [B, H, Nq, D], lse [B, H, Nq]) by the kernel's schedule; out in
    bf16 values (as fp32) with ``round_bf16``, else fp32."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    nqp = -(-nq // QUERIES) * QUERIES
    nkp = -(-nk // KEYS) * KEYS
    qp, kp, vp = _pad_rows(q, nqp), _pad_rows(k, nkp), _pad_rows(v, nkp)
    if bias is not None:
        biasp = torch.nn.functional.pad(bias.float(),
                                        (0, nkp - nk, 0, nqp - nq))
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E

    def rnd(x):
        return x.to(torch.bfloat16).float() if round_bf16 else x

    m = torch.full((b, h, nqp), -torch.inf)
    l = torch.zeros((b, h, nqp))
    o = torch.zeros((b, h, nqp, d))
    for k0 in range(0, nkp, KEYS):
        ks = slice(k0, k0 + KEYS)
        s = qp @ kp[:, :, ks].transpose(-1, -2)
        if bias is not None:
            y = s * scale_log2 + biasp[:, :, :, ks] * LOG2E
        else:
            y = s
        y = y.masked_fill(torch.arange(k0, k0 + KEYS) >= nk, -torch.inf)
        mx = y.amax(-1)
        m_new = torch.maximum(m, mx if bias is not None else mx * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2((y if bias is not None else y * scale_log2)
                       - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + rnd(p) @ vp[:, :, ks]
        m = m_new
    out = rnd(o / l[..., None])
    lse = (m + torch.log2(l)) * LN2
    return out[:, :, :nq], lse[:, :, :nq]


def _plain(q, k, v, scale, bias):
    """attention_fwd_lse_plain in fp32, head-major."""
    out, lse = attention_fwd_lse_plain(*map(_tok, (q, k, v)), scale=scale,
                                       bias=None if bias is None
                                       else bias.float())
    return _tok(out), lse


CASES = [(nq, nk, d, bias) for nq, nk in LENGTHS for d in (64, 80)
         for bias in BIASES]


@pytest.mark.parametrize("nq,nk,d,bias_kind", CASES)
def test_schedule_in_fp32_matches_plain(nq, nk, d, bias_kind):
    """With P kept in fp32 the schedule is the plain forward's algebra in
    another order: out and lse within FP32_ATOL."""
    scale = d ** -0.5
    q, k, v, bias = _inputs(nq, nk, d, bias_kind)
    out, lse = fwd_schedule(q, k, v, scale, bias, round_bf16=False)
    want, want_lse = _plain(q, k, v, scale, bias)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=FP32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("nq,nk,d,bias_kind", CASES)
def test_schedule_in_bf16_within_atol(nq, nk, d, bias_kind):
    """The kernel's numerics (P rounded to bf16 before P.V, a bf16 output)
    against the fp32 plain forward: out within ATTN_ATOL and lse within
    LSE_ATOL, the budgets chip_smoke.py holds the kernel to on the card."""
    scale = d ** -0.5
    q, k, v, bias = _inputs(nq, nk, d, bias_kind, seed=10)
    out, lse = fwd_schedule(q, k, v, scale, bias)
    want, want_lse = _plain(q, k, v, scale, bias)
    assert float((out - want).abs().max()) <= ATTN_ATOL
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL


JAX_CASES = [(77, 130, 64, None), (196, 196, 80, None),
             (1025, 1025, 64, None), (77, 130, 80, "bf16_heads"),
             (196, 196, 64, "fp32"), (1025, 1025, 80, "bf16")]


@pytest.mark.parametrize("nq,nk,d,bias_kind", JAX_CASES)
def test_schedule_matches_jax_forward(nq, nk, d, bias_kind):
    """The schedule in fp32 against the Pallas forwards in interpret mode:
    flash_attention_headmajor without a bias, flash_attention(bias=) with
    one (a head-broadcast bias handed over as [B, 1, Nq, Nk]); atol
    JAX_ATOL."""
    scale = d ** -0.5
    b, h = (1, 1) if nq > 512 else (2, 2)
    q, k, v, bias = _inputs(nq, nk, d, bias_kind, b=b, h=h, seed=20)
    out, _ = fwd_schedule(q, k, v, scale, bias, round_bf16=False)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        if bias is None:
            want = flash_attention_headmajor(jq, jk, jv)
        else:
            jb = jnp.asarray(bias[:, :1].float().numpy()
                             if bias_kind == "bf16_heads"
                             else bias.float().numpy())
            want = jnp.swapaxes(flash_attention(
                *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), bias=jb),
                1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=JAX_ATOL,
                               rtol=0)


# (B, N, H): B3's backward shapes for the route, head dim 64 (the one B3
# takes; the TPU kernels pair heads, so H is even): a ragged case and one
# of three 64-query tiles
QKV_SHAPES = [(2, 37, 2), (1, 130, 4)]


def _route_grads(q, k, v, dout, num_heads, grads):
    """The route's arithmetic on the CPU: the [B, H, N, 64] views it hands
    to B5's fused backward, read back token-major ([B, N, H, 64]) for
    attention_bwd_plain, whose gradients are written through the views of
    ``grads``."""
    views = [_tok(_heads_hm(t, num_heads)) for t in (q, k, v, dout)]
    out, lse = attention_fwd_lse_plain(*views[:3])
    got = attention_bwd_plain(*views[:3], out, lse, views[3])
    for dst, g in zip(grads, got):
        _heads_hm(dst, num_heads).copy_(_tok(g))


@pytest.mark.parametrize("b,n,h", QKV_SHAPES)
@pytest.mark.parametrize("fused", [True, False])
def test_b4_route_views_match_jax_vjp(b, n, h, fused):
    """The head-major views the B4 route builds, from the thirds of a fused
    qkv (and its d(qkv)) or from three tensors, carry the plain backward
    to d(qkv) as jax.grad through flash_attention_qkv_tm (the TPU kernels
    _fwd_kernel_qkv, _bwd_dq_kernel_qkv and _bwd_dkv_kernel_qkv in interpret
    mode) gives it; every view is one B5 reads as it is. fp32, atol
    JAX_ATOL. attention_bwd_tm runs the same on the CPU."""
    e = h * 64
    qkv = _bf16((b, n, 3 * e), 40)
    w = _bf16((b, n, e), 41)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(lambda x: jnp.sum(
            flash_attention_qkv_tm(x, h) * jnp.asarray(w.numpy())))(
                jnp.asarray(qkv.numpy())))
    if fused:
        q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        dqkv = torch.full_like(qkv, torch.nan)
        grads = (dqkv[..., :e], dqkv[..., e:2 * e], dqkv[..., 2 * e:])
    else:
        q, k, v = (qkv[..., i * e:(i + 1) * e].clone() for i in range(3))
        grads = torch.full((3, b, n, e), torch.nan)
    for t in (q, k, v, w, *grads):
        assert _hm_strides_ok(_heads_hm(t, h))
    _route_grads(q, k, v, w, h, grads)
    got = torch.cat(list(grads), -1)
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL, rtol=0)

    out, lse = attention_fwd_lse_plain(*(t.reshape(b, n, h, 64)
                                         for t in (q, k, v)))
    again = torch.full((3, b, n, e), torch.nan)
    attention_bwd_tm(q, k, v, out.reshape(b, n, e), lse, w, h, 64 ** -0.5,
                     *again)
    np.testing.assert_allclose(torch.cat(list(again), -1).numpy(), want,
                               atol=JAX_ATOL, rtol=0)


def test_b4_route_takes_dinov2_views_as_they_are():
    """At DINOv2's train shape, a fused qkv of (4, 1025, 3*16*64) bf16: the
    thirds of qkv and of d(qkv) and the contiguous dO are [B, H, N, 64]
    views B5 reads with no copy (same storage, token stride 3*16*64); a view
    one element off the 16-byte grid is not, and the route would raise on
    it rather than copy."""
    b, n, h = 4, 1025, 16
    e = h * 64
    for t in (torch.empty((b, n, 3 * e), dtype=torch.bfloat16),
              torch.empty((b, n, 3 * e), dtype=torch.bfloat16)):
        for i in range(3):
            view = _heads_hm(t[..., i * e:(i + 1) * e], h)
            assert view.shape == (b, h, n, 64)
            assert view.stride() == (n * 3 * e, 64, 3 * e, 1)
            assert view.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr()
            assert _hm_strides_ok(view)
    dout = torch.empty((b, n, e), dtype=torch.bfloat16)
    assert _hm_strides_ok(_heads_hm(dout, h))
    off = torch.empty((b, n, e + 1), dtype=torch.bfloat16)[..., 1:]
    assert not _hm_strides_ok(_heads_hm(off, h))
