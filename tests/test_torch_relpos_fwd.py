"""B7 (``csrc/attention_relpos.cu``, ``attention_relpos_hm``): the
warp-specialised kernel's schedule emulated in plain torch on the CPU, held
against the port's ``attention_decomposed_plain`` and against the JAX
``flash_attention_relpos_hm`` (the Pallas kernel in TPU interpret mode, as
tests/test_torch_sam.py runs it).

The emulation walks the kernel's schedule: query tiles of 128 rows as two
64-row slabs (a slab whose rows all lie past N computes nothing), key steps
of 128 keys and a last step sized to the keys that remain (16, 64 or 80
columns, or a whole masked step above 80), and per step S = Q.K^T in fp32
turned into log2-unit scores with the rel terms staged as fp32 times log2 e:
score = S * scale * log2 e + (rel_h' + rel_w'), each column's (grid row,
grid column) taken from the index map the kernel adds the bias with. Where
kw is 32 or 64 at head dim 80, a thread keeps the rel_w of its columns
(8j + 2t + e, j < 16) in registers for the whole tile, at grid column
8 (j % (kw / 8)) + 2t + e, and reads rel_h at row k0 / kw + j / (kw / 8);
elsewhere it advances a (row, column) index from k0 + 2t by 8 keys a j with
no division, and with kw even reads both columns of a pair at (row, w) and
(row, w + 1). Keys past N score -inf; the online softmax keeps a running
max m in log2 units, P = 2^(score - m) with the row sums in fp32 before P
rounds to bf16 for P.V (or stays fp32 to check the algebra), O and the sums
rescale by 2^(m_old - m_new), and O is divided by the row sum once at the
end; rows past N are dropped. The kernel itself runs only on the card
(``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops.flash_attention import flash_attention_relpos_hm
from vfmseg_tpu_torch.ops.attention import attention_decomposed_plain

QUERIES = 128   # rows of a query tile
SLAB = 64       # rows of a consumer warpgroup
KEYS = 128      # keys of a ring stage
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232448  # a block's shared memory on an H100
# (grid, head dim, heads): SAM's global grids at refine/train (32x32) and
# stage 1 (32x64), its 14x14 windows (N = 196: 128 + an 80-key tail, the
# second query tile one 64-row slab and one of 4 rows), and a 6x9 grid (one
# 64-key step, odd kw, the second slab idle), at head dims 80 and 64
GRIDS = [((32, 32), 80, 1), ((32, 64), 80, 1), ((14, 14), 80, 2),
         ((6, 9), 80, 2), ((32, 32), 64, 1), ((32, 64), 64, 1),
         ((14, 14), 64, 2), ((6, 9), 64, 2)]
# the index maps at the kernel's other branches: a 16-key tail (N 400, kw
# 20), a whole masked step (N 224, kw 32 in registers), kw 1 and 2 (8 keys
# cross several grid rows)
MAP_GRIDS = [(20, 20), (7, 32), (5, 1), (9, 2), (4, 16)]
# the schedule in fp32 against the plain forward: the same algebra, with exp
# as 2^(x log2 e) and sums in another order
FP32_ATOL = 2e-5
# with P in bf16 before P.V and a bf16 output, as chip_smoke.py holds the
# kernel on the card (ATTN_ATOL)
ATTN_ATOL = 1e-2
# against the Pallas kernel in interpret mode: the repo's attention budget
JAX_ATOL = 2e-4


def key_steps(n):
    """(first key, width) of each key step the kernel takes."""
    rem = n % KEYS
    full = n // KEYS + (1 if rem > 80 else 0)
    steps = [(j * KEYS, KEYS) for j in range(full)]
    if 0 < rem <= 80:
        steps.append((full * KEYS, 16 if rem <= 16 else 64 if rem <= 64
                       else 80))
    return steps


def rel_strides(kh, kw):
    """Row strides of the staged fp32 rel rows: rel_h odd, rel_w an odd
    multiple of 8."""
    sw = (kw + 7) // 8 * 8
    return kh | 1, sw if (sw // 8) % 2 == 1 else sw + 8


def layout(kh, kw, d):
    """(Q stages, K/V ring stages, shared bytes) the entry picks: two Q and
    three ring stages where they fit beside two rel stages, then one Q, then
    two ring stages; None where the rel rows leave no room (the mma.sync
    kernel)."""
    tile = QUERIES * d * 2
    sh, sw = rel_strides(kh, kw)
    rel = QUERIES * (sh + sw) * 4
    for qs, kv in ((2, 3), (1, 3), (2, 2), (1, 2)):
        total = qs * tile + kv * 2 * tile + 2 * rel + 256 + 1024
        if total <= SMEM_LIMIT:
            return qs, kv, total
    return None


def passes(kh, kw, d):
    """Query tiles a unit takes over one load of K and V: all of a row's
    where its key steps leave a ring stage free, else one."""
    n = kh * kw
    return -(-n // QUERIES) if len(key_steps(n)) < layout(kh, kw, d)[1] else 1


def reg_k(kw, d):
    """kw / 8 where the kernel keeps rel_w in registers, else 0."""
    return kw // 8 if d == 80 and kw in (32, 64) else 0


def bias_index(kw, k0, width, rk):
    """The (grid row, grid column) the kernel adds at each column of a key
    step of ``width`` keys from k0: column 8j + 2t + e is held by the
    threads with t, in pair e of block j."""
    rows = np.zeros(width, np.int64)
    cols = np.zeros(width, np.int64)
    d8i, d8w = 8 // kw, 8 % kw
    for t in range(4):
        key = k0 + 2 * t
        i, w = key // kw, key - (key // kw) * kw
        for j in range(width // 8):
            c = 8 * j + 2 * t
            if rk:
                rows[c:c + 2] = k0 // kw + j // rk
                cols[c:c + 2] = [8 * (j % rk) + 2 * t, 8 * (j % rk) + 2 * t + 1]
            elif kw % 2 == 0:
                rows[c:c + 2] = i
                cols[c:c + 2] = [w, w + 1]
            else:
                w1, i1 = (0, i + 1) if w + 1 == kw else (w + 1, i)
                rows[c], cols[c], rows[c + 1], cols[c + 1] = i, w, i1, w1
            w += d8w
            i += d8i
            if w >= kw:
                w -= kw
                i += 1
    return rows, cols


def emulate(q, k, v, rel_h, rel_w, scale, p_bf16):
    """The kernel's schedule on fp32 [B, H, N, D] q, k, v (bf16 values) and
    bf16 rel terms; returns fp32 [B, H, N, D] (bf16 values with
    ``p_bf16``)."""
    b, h, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    rk = reg_k(kw, d)
    sl2 = scale * LOG2E
    rhs = rel_h.float() * LOG2E
    rws = rel_w.float() * LOG2E
    out = torch.zeros(b, h, n, d)
    for r0 in range(0, n, SLAB):   # the slabs of every query tile
        r1 = min(r0 + SLAB, n)
        qs = q[:, :, r0:r1]
        m = torch.full((b, h, r1 - r0), -torch.inf)
        s_sum = torch.zeros(b, h, r1 - r0)
        o = torch.zeros(b, h, r1 - r0, d)
        for k0, width in key_steps(n):
            valid = min(width, n - k0)
            s = qs @ k[:, :, k0:k0 + valid].transpose(-1, -2)
            gi, gw = (torch.from_numpy(t[:valid])
                      for t in bias_index(kw, k0, width, rk))
            x = s * sl2 + rhs[:, :, r0:r1, gi] + rws[:, :, r0:r1, gw]
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            s_sum = s_sum * alpha + p.sum(-1)
            if p_bf16:
                p = p.to(torch.bfloat16).float()
            o = o * alpha[..., None] + p @ v[:, :, k0:k0 + valid]
            m = m_new
        o = o / s_sum[..., None]
        out[:, :, r0:r1] = o.to(torch.bfloat16).float() if p_bf16 else o
    return out


def _inputs(grid, d, h, seed):
    """Seeded bf16 q, k, v [1, H, N, D] and rel terms of SAM's scale (the
    products of q with 0.05-scaled tables: ~0.5)."""
    n = grid[0] * grid[1]
    rs = np.random.RandomState(seed)

    def t(shape, s=1.0):
        return torch.from_numpy((rs.standard_normal(shape) * s).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v = (t((1, h, n, d)) for _ in range(3))
    return q, k, v, t((1, h, n, grid[0]), 0.5), t((1, h, n, grid[1]), 0.5)


def test_key_steps_and_slabs():
    """The steps cover every key once, the last sized to what remains; a
    window's 196 keys are 128 + 80 and its rows two tiles, the second a
    64-row slab and a 4-row one."""
    assert key_steps(196) == [(0, 128), (128, 80)]
    assert key_steps(1024) == [(j * 128, 128) for j in range(8)]
    assert key_steps(54) == [(0, 64)]
    assert key_steps(400)[-1] == (384, 16)
    assert key_steps(224) == [(0, 128), (128, 128)]
    for n in range(1, 700, 7):
        steps = key_steps(n)
        assert steps[0][0] == 0 and all(
            a[0] + a[1] == b[0] for a, b in zip(steps, steps[1:]))
        assert steps[-1][0] < n <= steps[-1][0] + steps[-1][1]
        assert steps[-1][1] - (n - steps[-1][0]) < 64
    slabs = [(r, min(r + SLAB, 196)) for r in range(0, 196, SLAB)]
    assert [b - a for a, b in slabs] == [64, 64, 64, 4]


def test_shared_memory_layout_and_units():
    """Every grid on SAM's paths fits the warp-specialised kernel: the
    windows with two Q and three ring stages, one unit per (window, head)
    taking both query tiles over one load of K and V; the global grids one
    query tile a unit. Grids with kh + kw far above the paths' take the
    mma.sync kernel."""
    assert layout(14, 14, 80)[:2] == (2, 3) and passes(14, 14, 80) == 2
    assert layout(32, 32, 80)[:2] == (1, 3) and passes(32, 32, 80) == 1
    assert layout(32, 64, 80)[:2] == (2, 2) and passes(32, 64, 80) == 1
    assert layout(6, 9, 64)[:2] == (2, 3) and passes(6, 9, 64) == 1
    assert layout(4, 196, 80) is None
    for kh, kw in [(14, 14), (32, 32), (32, 64), (20, 20), (7, 32)]:
        assert layout(kh, kw, 80)[2] <= SMEM_LIMIT


@pytest.mark.parametrize("grid,d", [(g, d) for g, d, _ in GRIDS]
                         + [(g, 80) for g in MAP_GRIDS])
def test_bias_index_map_is_exact(grid, d):
    """Every real column of every key step gets the grid row c // kw and
    grid column c % kw, from registers (kw 32, 64 at D 80) or the
    incremental lookup, and the lookup's indices stay inside the staged
    rows (grid row < kh + 128 / kw, column < kw)."""
    kh, kw = grid
    n = kh * kw
    rk = reg_k(kw, d)
    assert rk == (kw // 8 if (d, kw) in ((80, 32), (80, 64)) else 0)
    for k0, width in key_steps(n):
        rows, cols = bias_index(kw, k0, width, rk)
        keys = k0 + np.arange(width)
        real = keys < n
        np.testing.assert_array_equal(rows[real], keys[real] // kw)
        np.testing.assert_array_equal(cols[real], keys[real] % kw)
        assert rows.max() < kh + 128 // kw + 1 and cols.max() < kw


@pytest.mark.parametrize("grid,d,h", GRIDS)
def test_schedule_in_fp32_matches_plain(grid, d, h):
    """The schedule with P kept in fp32 against attention_decomposed_plain
    on the same fp32 values: the algebra (slabs, sized steps, the index
    map, log2 e folded into the staged rel terms) is the plain formula."""
    q, k, v, rel_h, rel_w = _inputs(grid, d, h, seed=sum(grid) + d)
    scale = d ** -0.5
    want = attention_decomposed_plain(q.float(), k.float(), v.float(),
                                      rel_h, rel_w, scale=scale)
    got = emulate(q.float(), k.float(), v.float(), rel_h, rel_w, scale,
                  p_bf16=False)
    torch.testing.assert_close(got, want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("grid,d,h", GRIDS)
def test_schedule_in_bf16_within_atol(grid, d, h):
    """The schedule as the kernel rounds (P in bf16 before P.V, a bf16
    output) against the fp32 plain forward, within ATTN_ATOL."""
    q, k, v, rel_h, rel_w = _inputs(grid, d, h, seed=sum(grid) + d + 1)
    scale = d ** -0.5
    want = attention_decomposed_plain(q.float(), k.float(), v.float(),
                                      rel_h, rel_w, scale=scale)
    got = emulate(q.float(), k.float(), v.float(), rel_h, rel_w, scale,
                  p_bf16=True)
    assert float((got - want).abs().max()) <= ATTN_ATOL


@pytest.mark.parametrize("grid,d,h", [((6, 9), 80, 2), ((6, 9), 64, 1),
                                      ((14, 14), 80, 1)])
def test_schedule_matches_jax_forward(grid, d, h):
    """The schedule in fp32 against the JAX flash_attention_relpos_hm (the
    Pallas kernel in interpret mode; its softmax is the no-max exp2 one)."""
    q, k, v, rel_h, rel_w = _inputs(grid, d, h, seed=3 * sum(grid) + d)
    scale = d ** -0.5
    jin = [jnp.asarray(t.float().numpy()) for t in (q, k, v, rel_h, rel_w)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention_relpos_hm(*jin, scale=scale))
    got = emulate(q.float(), k.float(), v.float(), rel_h, rel_w, scale,
                  p_bf16=False).numpy()
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
