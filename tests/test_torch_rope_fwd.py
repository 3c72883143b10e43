"""B2-RoPE (``csrc/attention_qkv_rope.cu``, ``attention_qkv_rope_tm``):
EVA02's inference attention as a rotation pass into a workspace followed by
B2's kernel over the rotated q, k and v where it lies. Both are emulated in
plain torch on the CPU.

The rotation pass's partition: thread u takes the 16-byte chunk u % 4 (8
columns c..c+7 of the low half row) of head (u // 4) % H of token
u // (4 H) = b * N + t, for q and for k, with the partner chunk of the high
half (c + 32..); it reads them through each view's (batch, token) element
strides and the token's rows of the fp32 [N, 64] tables, computes
lo' = xl * cl + xh * sl and hi' = xh * ch + xl * sh in fp32 with each
product rounded before the sum, rounds once to bf16, and writes rotated q
and k into a contiguous [B, N, 2*H*64] workspace (q's heads, then k's). It
is held bit for bit to ``apply_rope_permuted(x.float(), cos, sin)`` rounded
to bf16 (what ``attention_qkv_rope_plain`` rotates with), every workspace
element written exactly once, the cls row the identity.

Then tests/test_torch_qkv_fwd.py's ``fwd_schedule`` runs over the workspace's
q and k (token stride 2*H*64) and v (its own strides): in fp32 against
``attention_qkv_rope_plain`` and the JAX ``flash_attention_qkv_tm(rope_cs=)``
in TPU interpret mode (atol 2e-4, as tests/test_torch_eva02.py holds the
twin), and with the kernel's roundings against the fp32 plain attention
within chip_smoke.py's ATTN_ATOL. The kernels run only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_qkv_fwd import ATTN_ATOL, fwd_schedule

from vfmseg_tpu.ops.flash_attention import flash_attention_qkv_tm
from vfmseg_tpu_torch.ops import rope
from vfmseg_tpu_torch.ops.attention import (
    attention_plain,
    attention_qkv_rope_plain,
    attention_qkv_rope_tm,
    qkv_view_geometry,
    qkv_view_strides,
)

CHUNKS = 4      # 16-byte chunks of a half row
HALF = 32       # partner columns lie HALF apart
# N: the cls row alone, one patch, EVA02-like ragged lengths (the key tail
# and the idle slab of B2's schedule), and the refine and stage-1 lengths
LENGTHS = [1, 2, 17, 77, 129, 145, 1025, 2049]
# the rope attention in fp32 against the plain twin and the JAX kernel
JAX_ATOL = 2e-4


def tables(n):
    """fp32 [n, 64] cos/sin in the evens|odds layout: the cls token's
    identity row, then a 1 x (n - 1) grid's rows."""
    if n == 1:
        return torch.ones(1, 64), torch.zeros(1, 64)
    cos, sin = rope.permuted_rope_tables(*rope.vit_rope_tables(
        1, n - 1, 64, 1, 16, True))
    return torch.from_numpy(cos.copy()), torch.from_numpy(sin.copy())


def views(b, n, h, layout, seed):
    """Seeded bf16 [B, N, H*64] q, k, v: the thirds of one fused qkv
    ("fused"), three tensors ("three"), or the fused thirds with v a tensor
    of its own ("v_apart")."""
    e = h * 64
    rs = np.random.RandomState(seed)
    qkv = torch.from_numpy(rs.standard_normal((b, n, 3 * e)).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    if layout == "three":
        return q.clone(), k.clone(), v.clone()
    if layout == "v_apart":
        return q, k, v.clone()
    return q, k, v


def rotate_schedule(q, k, cos, sin, h, strides, *, dtype=torch.bfloat16):
    """(workspace [B, N, 2*H*64], writes per element) by the rotation pass's
    partition over q and k read through their (batch, token) element
    strides; the workspace holds the rotated values in ``dtype`` (the
    kernel's bf16, or fp32 to check the algebra)."""
    b, n = q.shape[:2]
    e = h * 64
    u = torch.arange(b * n * h * CHUNKS)
    c = (u % CHUNKS) * 8
    hd = (u // CHUNKS) % h
    tok = u // (CHUNKS * h)
    t, bb = tok % n, tok // n
    cols = torch.arange(8)
    row = (t * 64 + c)[:, None] + cols
    cl, ch = cos.reshape(-1)[row], cos.reshape(-1)[row + HALF]
    sl, sh = sin.reshape(-1)[row], sin.reshape(-1)[row + HALF]
    rot = torch.zeros(b * n * 2 * e, dtype=dtype)
    writes = torch.zeros(b * n * 2 * e, dtype=torch.int64)
    for i, (x, (sb, sn)) in enumerate(((q, strides[0]), (k, strides[1]))):
        last = (b - 1) * sb + (n - 1) * sn + e
        flat = torch.as_strided(x, (last,), (1,))
        src = (bb * sb + t * sn + hd * 64 + c)[:, None] + cols
        xl, xh = flat[src].float(), flat[src + HALF].float()
        dst = (tok * 2 * e + i * e + hd * 64 + c)[:, None] + cols
        rot[dst] = (xl * cl + xh * sl).to(dtype)
        rot[dst + HALF] = (xh * ch + xl * sh).to(dtype)
        for d in (dst, dst + HALF):
            writes.index_add_(0, d.reshape(-1), torch.ones(d.numel(),
                                                           dtype=torch.int64))
    return rot.view(b, n, 2 * e), writes.view(b, n, 2 * e)


def twin_rotation(x, cos, sin, h, dtype=torch.bfloat16):
    """``attention_qkv_rope_plain``'s rotation of a [B, N, H*64] view."""
    b, n, e = x.shape
    return rope.apply_rope_permuted(
        x.float().reshape(b, n, h, 64), cos[None, :, None, :],
        sin[None, :, None, :]).to(dtype).reshape(b, n, e)


def _shape(n):
    """(B, H) at length n: smaller at the long lengths for the CPU's time."""
    return (1, 2) if n > 1100 else (2, 3)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("layout", ["fused", "three"])
def test_rotation_partition_matches_twin(n, layout):
    """Every workspace element written once, q's then k's heads, each
    equal bit for bit to the twin's rotation rounded to bf16; the cls row
    (token 0, identity tables) is q's and k's own values."""
    b, h = _shape(n)
    e = h * 64
    q, k, v = views(b, n, h, layout, n)
    cos, sin = tables(n)
    strides = qkv_view_strides("t", h, q, k, v)[2]
    rot, writes = rotate_schedule(q, k, cos, sin, h, strides)
    assert bool((writes == 1).all())
    assert torch.equal(rot[..., :e], twin_rotation(q, cos, sin, h))
    assert torch.equal(rot[..., e:], twin_rotation(k, cos, sin, h))
    assert torch.equal(rot[:, 0, :e], q[:, 0])
    assert torch.equal(rot[:, 0, e:], k[:, 0])


def test_rotation_reads_views_of_their_own_strides():
    """q a third of a fused qkv (token stride 3*H*64), k a tensor of its
    own (H*64) and a batch of one with a batch stride that is no multiple of
    8: each read through its own pair, the same rotation."""
    n, h = 77, 2
    e = h * 64
    q, _, v = views(1, n, h, "fused", 5)
    k = views(1, n, h, "three", 6)[1]
    odd = torch.as_strided(torch.zeros(n * e + 40, dtype=torch.bfloat16),
                           (1, n, e), (12345, e, 1))
    odd.copy_(k)
    cos, sin = tables(n)
    b, _, strides = qkv_view_strides("t", h, q, odd, v)
    assert strides == ((n * 3 * e, 3 * e), (12345, e), (n * 3 * e, 3 * e))
    rot, writes = rotate_schedule(q, odd, cos, sin, h, strides)
    assert bool((writes == 1).all())
    assert torch.equal(rot[..., :e], twin_rotation(q, cos, sin, h))
    assert torch.equal(rot[..., e:], twin_rotation(k, cos, sin, h))


def _rope_schedule(q, k, v, cos, sin, h, scale, round_bf16):
    """The entry's two kernels emulated: the rotation into the workspace
    (bf16, or fp32 to check the algebra), then B2's schedule over its q and
    k halves (token stride 2*H*64) and v (its own strides)."""
    b, n, e = q.shape
    strides = qkv_view_strides("t", h, q, k, v)[2]
    dtype = torch.bfloat16 if round_bf16 else torch.float32
    rot, _ = rotate_schedule(q, k, cos, sin, h, strides, dtype=dtype)
    rotated = (n * 2 * e, 2 * e)
    out, _, _ = fwd_schedule(rot[..., :e], rot[..., e:], v, h, scale,
                             round_bf16=round_bf16,
                             strides=(rotated, rotated, strides[2]))
    return out


JAX_CASES = [(2, 77, 2, "fused"), (1, 129, 2, "fused"), (2, 145, 2, "v_apart"),
             (1, 1025, 2, "fused")]


@pytest.mark.parametrize("b,n,h,layout", JAX_CASES)
def test_rope_schedule_matches_plain_and_jax(b, n, h, layout):
    """The rotation and B2's schedule in fp32 against the plain twin and the
    JAX flash_attention_qkv_tm with rope_cs (TPU interpret mode) on the same
    values: q, k, v thirds of one fused qkv, or v a tensor of its own
    (handed to the TPU kernel concatenated, as the JAX package does);
    atol JAX_ATOL."""
    q, k, v = views(b, n, h, layout, 70 + n)
    cos, sin = tables(n)
    scale = 64 ** -0.5
    out = _rope_schedule(q, k, v, cos, sin, h, scale, round_bf16=False)
    e = h * 64
    twin = attention_qkv_rope_plain(
        *(t.float().reshape(b, n, h, 64) for t in (q, k, v)), cos, sin,
        scale=scale).reshape(b, n, e)
    qkv = jnp.asarray(torch.cat([q, k, v], -1).float().numpy())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention_qkv_tm(
            qkv, h, rope_cs=(jnp.asarray(cos.numpy()),
                             jnp.asarray(sin.numpy()))))
    np.testing.assert_allclose(out.numpy(), twin.numpy(), atol=JAX_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), want, atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("n", [17, 129, 145, 1025])
def test_rope_schedule_in_bf16_within_atol(n):
    """The kernels' numerics (the rotation rounded to bf16, P rounded to
    bf16 before P.V, a bf16 output) against the fp32 plain attention over
    the twin's rotated values, as chip_smoke.py holds B2-RoPE on the card:
    within ATTN_ATOL."""
    b, h = _shape(n)
    q, k, v = views(b, n, h, "v_apart", 90 + n)
    cos, sin = tables(n)
    scale = 64 ** -0.5
    out = _rope_schedule(q, k, v, cos, sin, h, scale, round_bf16=True)
    qr, kr = (twin_rotation(t, cos, sin, h).float().reshape(b, n, h, 64)
              for t in (q, k))
    want = attention_plain(qr, kr, v.float().reshape(b, n, h, 64),
                           scale=scale).reshape(b, n, h * 64)
    assert float((out - want).abs().max()) <= ATTN_ATOL


def test_view_strides_per_view_and_refusals():
    """qkv_view_strides gives each view its pair and refuses, view by view,
    what a map cannot read: a start off the 16-byte grid, a token stride
    that is not whole 16 bytes, another shape, another dtype; the shared
    form (B2's and B3's own entries) still refuses two strides."""
    b, n, h = 2, 33, 2
    e = h * 64
    fused = torch.zeros((b, n, 3 * e), dtype=torch.bfloat16)
    q, k = fused[..., :e], fused[..., e:2 * e]
    v = torch.zeros((b, n, e), dtype=torch.bfloat16)
    assert qkv_view_strides("t", h, q, k, v) == (
        b, n, ((n * 3 * e, 3 * e), (n * 3 * e, 3 * e), (n * e, e)))
    with pytest.raises(ValueError, match="one stride"):
        qkv_view_geometry("t", h, q, k, v)
    off = torch.zeros((b, n, e + 1), dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        qkv_view_strides("t", h, q, k, off)
    odd = torch.zeros((b, n, e + 4), dtype=torch.bfloat16)[..., :e]
    with pytest.raises(ValueError, match="multiples of 8"):
        qkv_view_strides("t", h, q, odd, v)
    with pytest.raises(ValueError, match="shape"):
        qkv_view_strides("t", h, q, k, v[:, :-1])
    with pytest.raises(TypeError, match="bf16"):
        qkv_view_strides("t", h, q, k, v.float())


def test_rope_entry_refuses_cpu_views_of_their_own_strides():
    """On the CPU the entry raises rather than rotate: nothing falls back
    from the kernel to the plain twin."""
    q, k, v = views(1, 5, 1, "v_apart", 1)
    cos, sin = tables(5)
    with pytest.raises(ValueError, match="CUDA"):
        attention_qkv_rope_tm(q, k, v, cos, sin, 1, 0.125)
