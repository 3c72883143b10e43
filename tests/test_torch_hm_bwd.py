"""B5's fused backward (``csrc/attention_hm.cu``, ``attention_hm_bwd``):
its schedule emulated in plain torch on the CPU, held against the port's
``attention_bwd_plain`` and against the JAX VJPs of
``flash_attention_headmajor`` and ``flash_attention(bias=)`` (the Pallas
kernels in TPU interpret mode, as tests/test_ops.py runs them).

The emulation walks the kernel's schedule: the inputs zero-filled to whole
64-row tiles, one pass per 64-key tile over the 64-query tiles, S^T and dP^T
once per tile pair, P and dS set to 0 for query rows >= Nq and keys >= Nk,
P and dS rounded to bf16 before their products (the kernel's numerics, or
kept in fp32 to check the algebra), dV and dK accumulated per key tile and
stored once, dbias stored once per tile pair in the bias's dtype, and dq
summed in fp32 over the key tiles in a shuffled order (the kernel's atomics
add them in an order that changes from run to run), rounded once at the
end. The kernel itself runs only on the card (``chip_smoke.py``).
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
)
from vfmseg_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_fwd_lse_plain,
)

TILE = 64
# (Nq, Nk): a ragged Nq != Nk case (one real row in the last query tile)
# and SAM's windows (Nk = 196: 4 real keys in the last key tile)
LENGTHS = [(77, 130), (196, 196)]
# None; a bf16 or fp32 [B, H, Nq, Nk] bias; a bf16 bias broadcast over the
# heads (a stride-0 view of [B, 1, Nq, Nk])
BIASES = [None, "bf16", "fp32", "bf16_heads"]
# the kernel's numerics against the fp32 plain backward: P and dS round to
# bf16 before their products (2^-9 each), as chip_smoke.py's GRAD_REL holds
# the kernel on the card (max abs error over max |reference|)
GRAD_REL = 2e-2
# the schedule in fp32 against the plain backward: the same algebra summed
# in another order
FP32_ATOL = 2e-5
# against the Pallas kernels in interpret mode: the repo's attention budget
JAX_ATOL = 2e-4


def _bf16(shape, seed, scale=1.0):
    """Seeded normals rounded to bf16, as fp32."""
    x = np.random.RandomState(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


def _inputs(nq, nk, d, bias_kind, b=2, h=2, seed=0):
    """Head-major q, dO [B, H, Nq, D], k, v [B, H, Nk, D] and the bias view
    (or None)."""
    q, dout = _bf16((b, h, nq, d), seed), _bf16((b, h, nq, d), seed + 1)
    k, v = _bf16((b, h, nk, d), seed + 2), _bf16((b, h, nk, d), seed + 3)
    bias = None
    if bias_kind == "bf16_heads":
        bias = _bf16((b, 1, nq, nk), seed + 4, 0.5).to(torch.bfloat16)
        bias = bias.expand(b, h, nq, nk)
    elif bias_kind is not None:
        bias = _bf16((b, h, nq, nk), seed + 4, 0.5)
        bias = bias.to({"bf16": torch.bfloat16, "fp32": torch.float32}[
            bias_kind])
    return q, k, v, dout, bias


def _tok(t):
    return t.transpose(1, 2)


def _forward(q, k, v, dout, bias, scale, bf16_out=True):
    """lse and delta as the autograd Function hands them to the kernel:
    the LSE of the forward, and rowsum(dO * O) from the output, rounded to
    bf16 as the card's forward writes it (or kept in fp32, as the JAX VJP
    takes it from fp32 inputs)."""
    out, lse = attention_fwd_lse_plain(*map(_tok, (q, k, v)), scale=scale,
                                       bias=bias)
    out = _tok(out)
    if bf16_out:
        out = out.to(torch.bfloat16).float()
    return out, lse, (dout * out).sum(-1)


def _pad_rows(t, n):
    """Zero-fill dim 2 to n rows (the kernel's loads past Nq or Nk)."""
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


def fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias=None, *,
                       round_bf16=True, order_seed=0):
    """dq, dk, dv (bf16 values in fp32 with ``round_bf16``, else fp32) and
    dbias (the bias's dtype, or None) by the fused kernel's schedule."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    nqp, nkp = -(-nq // TILE) * TILE, -(-nk // TILE) * TILE
    qp, dop = _pad_rows(q, nqp), _pad_rows(dout, nqp)
    kp, vp = _pad_rows(k, nkp), _pad_rows(v, nkp)
    lsep = torch.nn.functional.pad(lse, (0, nqp - nq))
    deltap = torch.nn.functional.pad(delta, (0, nqp - nq))
    if bias is not None:
        biasp = torch.nn.functional.pad(bias.float(),
                                        (0, nkp - nk, 0, nqp - nq))
        dbias = torch.empty((b, h, nq, nk), dtype=bias.dtype)

    def rnd(x):
        return x.to(torch.bfloat16).float() if round_bf16 else x

    dq_acc = torch.zeros((b, h, nqp, d))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    key_tiles = list(range(0, nkp, TILE))
    np.random.RandomState(order_seed).shuffle(key_tiles)
    for k0 in key_tiles:
        ks = slice(k0, k0 + TILE)
        kt, vt = kp[:, :, ks], vp[:, :, ks]
        key_ok = (torch.arange(k0, k0 + TILE) < nk)[:, None]
        dk_t = torch.zeros((b, h, TILE, d))
        dv_t = torch.zeros((b, h, TILE, d))
        for q0 in range(0, nqp, TILE):
            qs = slice(q0, q0 + TILE)
            st = kt @ qp[:, :, qs].transpose(-1, -2)      # S^T [keys, queries]
            dpt = vt @ dop[:, :, qs].transpose(-1, -2)    # dP^T
            x = st * scale
            if bias is not None:
                x = x + biasp[:, :, qs, ks].transpose(-1, -2)
            p = torch.exp(x - lsep[:, :, None, qs])
            ds = p * (dpt - deltap[:, :, None, qs])
            ok = key_ok & (torch.arange(q0, q0 + TILE) < nq)[None, :]
            p, ds = p * ok, ds * ok
            if bias is not None:
                rows, cols = min(TILE, nq - q0), min(TILE, nk - k0)
                dbias[:, :, q0:q0 + rows, k0:k0 + cols] = (
                    ds.transpose(-1, -2)[:, :, :rows, :cols].to(bias.dtype))
            pb, dsb = rnd(p), rnd(ds * scale)
            dv_t += pb @ dop[:, :, qs]
            dk_t += dsb @ qp[:, :, qs]
            dq_acc[:, :, qs] += dsb.transpose(-1, -2) @ kt
        cols = min(TILE, nk - k0)
        dk[:, :, k0:k0 + cols] = rnd(dk_t[:, :, :cols])
        dv[:, :, k0:k0 + cols] = rnd(dv_t[:, :, :cols])
    dq = rnd(dq_acc[:, :, :nq])
    return dq, dk, dv, (dbias if bias is not None else None)


def _plain(q, k, v, out, lse, dout, scale, bias):
    """attention_bwd_plain in fp32, head-major."""
    grads = attention_bwd_plain(*map(_tok, (q, k, v, out)), lse, _tok(dout),
                                scale=scale,
                                bias=None if bias is None else bias.float())
    return [_tok(g) for g in grads[:3]] + list(grads[3:])


CASES = [(nq, nk, d, bias) for nq, nk in LENGTHS for d in (64, 80)
         for bias in BIASES]


@pytest.mark.parametrize("nq,nk,d,bias_kind", CASES)
def test_schedule_in_fp32_matches_plain(nq, nk, d, bias_kind):
    """With P and dS kept in fp32 the schedule is the plain backward's
    algebra in another summation order: dq, dk, dv within FP32_ATOL, and
    dbias within one rounding of the bias's dtype."""
    scale = d ** -0.5
    q, k, v, dout, bias = _inputs(nq, nk, d, bias_kind)
    out, lse, delta = _forward(q, k, v, dout, bias, scale)
    got = fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias,
                             round_bf16=False)
    want = _plain(q, k, v, out, lse, dout, scale, bias)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=FP32_ATOL,
                                   rtol=0, err_msg=name)
    if bias is not None:
        ulp = 2.0 ** -8 if bias.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(got[3].float().numpy(), want[3].numpy(),
                                   atol=FP32_ATOL, rtol=ulp, err_msg="dbias")


@pytest.mark.parametrize("nq,nk,d,bias_kind", CASES)
def test_schedule_in_bf16_within_grad_rel(nq, nk, d, bias_kind):
    """The kernel's numerics (P and dS rounded to bf16 before their
    products, bf16 outputs, dbias in the bias's dtype) against the fp32
    plain backward: max abs error within GRAD_REL of max |reference|, the
    budget chip_smoke.py holds the kernel to on the card."""
    scale = d ** -0.5
    q, k, v, dout, bias = _inputs(nq, nk, d, bias_kind, seed=10)
    out, lse, delta = _forward(q, k, v, dout, bias, scale)
    got = fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias)
    want = _plain(q, k, v, out, lse, dout, scale, bias)
    names = ("dq", "dk", "dv", "dbias")
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        rel = float((g.float() - w).abs().max() / w.abs().max())
        assert rel <= GRAD_REL, (name, rel)


JAX_CASES = [(77, 130, 64, None), (196, 196, 80, None),
             (77, 130, 80, "bf16_heads"), (196, 196, 64, "fp32")]


@pytest.mark.parametrize("nq,nk,d,bias_kind", JAX_CASES)
def test_schedule_matches_jax_vjp(nq, nk, d, bias_kind):
    """The schedule in fp32 against jax.grad through the Pallas backward
    kernels in interpret mode: flash_attention_headmajor without a bias,
    flash_attention(bias=) with one (a head-broadcast bias's gradient summed
    over the heads, as jax.grad returns it); atol JAX_ATOL."""
    scale = d ** -0.5
    q, k, v, dout, bias = _inputs(nq, nk, d, bias_kind, seed=20)
    _, lse, delta = _forward(q, k, v, dout, bias, scale, bf16_out=False)
    got = fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias,
                             round_bf16=False)
    w = jnp.asarray(dout.numpy())
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        if bias is None:
            want = jax.grad(lambda q, k, v: jnp.sum(
                flash_attention_headmajor(q, k, v) * w), argnums=(0, 1, 2))(
                    jq, jk, jv)
        else:
            jb = jnp.asarray(bias[:, :1].float().numpy()
                             if bias_kind == "bf16_heads"
                             else bias.float().numpy())
            tm = [jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)]
            grads = jax.grad(lambda q, k, v, b: jnp.sum(
                flash_attention(q, k, v, bias=b) * jnp.swapaxes(w, 1, 2)),
                argnums=(0, 1, 2, 3))(*tm, jb)
            want = [jnp.swapaxes(g, 1, 2) for g in grads[:3]] + [grads[3]]
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=JAX_ATOL,
                                   rtol=0, err_msg=name)
    if bias is not None:
        # a bf16 dbias rounds each head's term once (half a bf16 step,
        # 2^-9 of it; 2^-8 leaves room for fp32 reassociation) before
        # the sum over the heads that jax.grad takes in fp32
        dbias = got[3].float()
        tol = JAX_ATOL
        if bias_kind == "bf16_heads":
            tol = tol + 2.0 ** -8 * dbias.abs().sum(1, keepdim=True).numpy()
            dbias = dbias.sum(1, keepdim=True)
        err = np.abs(dbias.numpy() - np.asarray(want[3]))
        assert (err <= tol).all(), ("dbias", float(err.max()))


@pytest.mark.parametrize("bias_kind", [None, "bf16"])
def test_key_tile_order_moves_only_dq_rounding(bias_kind):
    """Another order of the key tiles (the atomics' order on the card)
    changes dq only by fp32 reassociation before its one bf16 rounding (at
    most one bf16 step of |dq|), and leaves dk, dv and dbias bit for bit."""
    scale = 80 ** -0.5
    q, k, v, dout, bias = _inputs(196, 196, 80, bias_kind, seed=30)
    _, lse, delta = _forward(q, k, v, dout, bias, scale)
    a = fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias,
                           order_seed=1)
    b = fused_bwd_schedule(q, k, v, dout, lse, delta, scale, bias,
                           order_seed=2)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=1e-6,
                               rtol=2.0 ** -7)
    for x, y in zip(a[1:], b[1:]):
        if x is not None:
            assert torch.equal(x, y)
