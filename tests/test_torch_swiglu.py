"""EVA02's SwiGLU on a padded hidden (``SwiGLUEva``'s eval route,
``ops/swiglu.py``) on the CPU: the eval route against the training route,
which keeps the unpadded layers (the parent of the padded route), at a toy
width that needs padding, at EVA02-L's 2730 and at an aligned width; the
gate-and-sub-LN twin's pad columns; the cached padded weights following
parameter writes; the toy EVA02 ViT taking the route. The toy ViT's eval
against the JAX package is ``test_vit_eval_matches_jax_fused_rope_route``
in test_torch_eva02.py, which runs this route too. The kernel itself runs
only on the card (test_torch_swiglu_card.py)."""

import pytest
import torch
import torch.nn.functional as F

from vfmseg_tpu_torch.models.backbones import eva02
from vfmseg_tpu_torch.models.backbones.vit import SwiGLUEva
from vfmseg_tpu_torch.ops.norm import layer_norm_plain
from vfmseg_tpu_torch.ops.swiglu import padded_width, swiglu_gate_ln_plain

# test_torch_layer_norm.py's bf16 tolerance (output rounding, another
# summation order); fp32: rounding alone
TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-5, 1e-5)}


def _module(dim, hidden, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    m = SwiGLUEva(dim, hidden, 1e-6, dtype)
    with torch.no_grad():
        for lin in (m.w1, m.w2, m.w3):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen)
                             * lin.in_features ** -0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=gen) * 0.1)
        m.ffn_ln.weight.copy_(1 + 0.1 * torch.randn(hidden, generator=gen))
        m.ffn_ln.bias.copy_(0.1 * torch.randn(hidden, generator=gen))
    return m


def _both_routes(m, x):
    """(eval route, training route) of ``m`` on ``x``, no gradient."""
    with torch.no_grad():
        m.eval()
        got = m(x)
        m.train()
        want = m(x)
    m.eval()
    return got, want


@pytest.mark.parametrize("h, hp", [(10, 16), (2730, 2736), (2048, 2048),
                                   (1, 8), (8, 8)])
def test_padded_width(h, hp):
    assert padded_width(h) == hp


@pytest.mark.parametrize("hidden", [10, 2730, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_route_matches_training_route(hidden, dtype):
    """The padded route (one w1|w2 product, the gate-and-sub-LN twin, w3 at
    K = Hp) against the unpadded layers on the same rows; fp32 within
    rounding, bf16 within the sub-LN's tolerance (the training route rounds
    silu(a) and the product to bf16, the padded route keeps them fp32)."""
    m = _module(32, hidden, dtype)
    x = torch.randn(2, 3, 32, generator=torch.Generator().manual_seed(1))
    got, want = _both_routes(m, x)
    assert got.dtype == want.dtype == dtype
    assert m._padded is not None  # the eval route ran
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_ln_twin_writes_zero_pad(dtype):
    """The twin reads a and b from their halves only (garbage in g's pad
    columns changes nothing), normalises over the true columns with
    ``_ln_reference``'s numerics and writes exact zeros past them."""
    gen = torch.Generator().manual_seed(2)
    h, hp, rows = 2730, 2736, 5
    g = torch.randn(rows, 2 * hp, generator=gen).to(dtype)
    w = 1 + 0.1 * torch.randn(h, generator=gen)
    b = 0.1 * torch.randn(h, generator=gen)
    y = swiglu_gate_ln_plain(g, h, w, b, 1e-6)
    assert y.shape == (rows, hp) and y.dtype == dtype
    assert torch.equal(y[:, h:], torch.zeros(rows, hp - h, dtype=dtype))
    assert not y[:, h:].float().signbit().any()
    a, bb = g[:, :h].float(), g[:, hp:hp + h].float()
    want = layer_norm_plain(F.silu(a) * bb, w, b, 1e-6).to(dtype)
    assert torch.equal(y[:, :h], want)
    dirty = g.clone()
    dirty[:, h:hp] = 7.0
    dirty[:, hp + h:] = -3.0
    assert torch.equal(swiglu_gate_ln_plain(dirty, h, w, b, 1e-6), y)


def test_padded_weights_track_parameter_writes():
    """The cached padded weights follow an in-place write to any of the
    three layers' parameters and a state-dict load, and the eval route's
    output with them."""
    m = _module(16, 10, torch.float32)
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    m.eval()
    w12, b12, w3, b3 = (t.clone() for t in m.padded_weights())
    assert w12.shape == (32, 16) and b12.shape == (32,)
    assert w3.shape == (16, 16) and b3.shape == (16,)
    assert torch.equal(w12[:10], m.w1.weight) and torch.equal(
        w12[16:26], m.w2.weight)
    assert not w12[10:16].any() and not w12[26:].any()
    assert not b12[10:16].any() and not b12[26:].any()
    assert torch.equal(w3[:, :10], m.w3.weight) and not w3[:, 10:].any()
    with torch.no_grad():
        before = m(x)
        m.w2.weight.mul_(2.0)
        m.w3.bias.add_(1.0)
    now = m.padded_weights()
    assert torch.equal(now[0][:16], w12[:16])
    torch.testing.assert_close(now[0][16:26], 2 * w12[16:26])
    torch.testing.assert_close(now[3], b3 + 1.0)
    got, want = _both_routes(m, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(got, before)
    other = _module(16, 10, torch.float32, seed=9).eval()
    m.load_state_dict(other.state_dict())
    torch.testing.assert_close(m.padded_weights()[0],
                               other.padded_weights()[0], atol=0, rtol=0)
    with torch.no_grad():
        torch.testing.assert_close(m(x), other(x.clone()), atol=0, rtol=0)


def test_toy_eva02_vit_takes_the_padded_route():
    """eva02_tiny_for_tests in eval runs every block's SwiGLU on the padded
    route and matches its own training-mode forward (no dropout, no
    drop-path) in fp32."""
    model = eva02.eva02_tiny_for_tests()
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.eval()
        got = model(x)
        model.train()
        want = model(x)
    mlps = [blk.mlp for blk in model.blocks]
    assert mlps and all(isinstance(m, SwiGLUEva) and m._padded is not None
                        for m in mlps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
