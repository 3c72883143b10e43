"""The torch port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both sides. The JAX Pallas
kernels run in TPU interpret mode, as tests/test_ops.py runs them, and the
port's ops take their plain PyTorch versions, which CPU tensors select.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vfmseg_tpu.ops.attention import multi_head_attention as jax_mha
from vfmseg_tpu.ops.attention import xla_attention
from vfmseg_tpu.ops.flash_attention import flash_attention_qkv_tm
from vfmseg_tpu.ops.norm import _ln, _ln_reference
from vfmseg_tpu.ops.resize import resize as jax_resize
from vfmseg_tpu_torch import kernels
from vfmseg_tpu_torch.kernels import build as kbuild
from vfmseg_tpu_torch.ops.attention import (
    _heads_hm,
    attention_fwd_lse_tm,
    attention_hm_bwd,
    attention_plain,
    attention_qkv_tm,
    multi_head_attention,
    multi_head_attention_qkv_tm,
)
from vfmseg_tpu_torch.ops.norm import (
    LayerNorm,
    layer_norm,
    layer_norm_cuda,
    layer_norm_plain,
)
from vfmseg_tpu_torch.ops.resize import resize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


class TestLayerNorm:
    @pytest.mark.parametrize("shape", [(2, 64, 96), (2, 65, 96),
                                       (3, 5, 33, 96), (130, 96)])
    def test_matches_pallas_and_reference(self, shape):
        """Every shape branch of the TPU kernel (2D flatten, native 3D)
        against the plain port, fp32, atol 1e-5."""
        x = _np(1, shape)
        w = _np(2, shape[-1:], 0.1) + 1.0
        b = _np(3, shape[-1:], 0.1)
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(_ln(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), 1e-6))
        ref = np.asarray(_ln_reference(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-6))
        tx, tw, tb = map(torch.from_numpy, (x, w, b))
        for ours in (layer_norm_plain(tx, tw, tb, 1e-6),
                     layer_norm(tx, tw, tb, 1e-6)):
            np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-5,
                                       rtol=0)
            np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("c", [341, 2730])
    @pytest.mark.parametrize("lead", [(2, 65), (3, 5, 33)])
    def test_any_width_matches_pallas_and_reference(self, lead, c):
        """Widths off the CUDA kernel's vector path: an odd one and EVA02's
        SwiGLU sub-LN (2730, above 2048), on the 2D and 3D branches of the
        TPU kernel; fp32, atol 1e-5."""
        self.test_matches_pallas_and_reference(lead + (c,))

    def test_module_casts_to_compute_dtype(self):
        """The module computes in its dtype and keeps fp32 parameters; bf16
        rounds only the output."""
        x = torch.from_numpy(_np(4, (2, 9, 64)))
        mod = LayerNorm(64, eps=1e-5, dtype=torch.bfloat16)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(_np(5, (64,), 0.1) + 1.0))
            mod.bias.copy_(torch.from_numpy(_np(6, (64,), 0.1)))
        with torch.no_grad():
            y = mod(x)
            want = layer_norm_plain(x.to(torch.bfloat16).float(),
                                    mod.weight, mod.bias, 1e-5)
        assert y.dtype == torch.bfloat16 and mod.weight.dtype == torch.float32
        np.testing.assert_allclose(y.float().numpy(), want.numpy(),
                                   atol=3e-2, rtol=1e-2)


class TestAttention:
    @pytest.mark.parametrize("b,n,h", [(2, 37, 2), (4, 37, 4), (6, 37, 2),
                                       (2, 129, 2), (4, 129, 4), (2, 77, 4)])
    def test_qkv_tm_matches_pallas_and_xla(self, b, n, h):
        """Fused-qkv token-major attention against the TPU kernel in
        interpret mode (incl. its aligned-tail case N=129 and its batch
        packing at B=4, 6) and against xla_attention; atol 2e-4."""
        d = 16
        qkv = _np(10 + b + n + h, (b, n, 3 * h * d))
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(flash_attention_qkv_tm(jnp.asarray(qkv), h))
        r = jnp.asarray(qkv).reshape(b, n, 3, h, d)
        ref = np.asarray(xla_attention(r[:, :, 0], r[:, :, 1],
                                       r[:, :, 2])).reshape(b, n, h * d)
        ours = multi_head_attention_qkv_tm(torch.from_numpy(qkv), h).numpy()
        np.testing.assert_allclose(ours, pallas, atol=2e-4, rtol=0)
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)

    def test_odd_heads_matches_xla(self):
        """H=3: the TPU kernel needs head pairs, so xla_attention alone."""
        b, n, h, d = 2, 37, 3, 16
        qkv = _np(20, (b, n, 3 * h * d))
        r = jnp.asarray(qkv).reshape(b, n, 3, h, d)
        ref = np.asarray(xla_attention(r[:, :, 0], r[:, :, 1],
                                       r[:, :, 2])).reshape(b, n, h * d)
        ours = multi_head_attention_qkv_tm(torch.from_numpy(qkv), h).numpy()
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)

    def test_same_shape_separate_qkv(self):
        """The decoder's route: three same-shape [B, N, H, D] tensors, which
        the JAX package concatenates into a fused qkv for the TPU kernel."""
        b, n, h, d = 2, 37, 2, 64
        q, k, v = (_np(30 + i, (b, n, h, d)) for i in range(3))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jax_mha(jq, jk, jv, impl="pallas"))
        ref = np.asarray(xla_attention(jq, jk, jv))
        ours = multi_head_attention(*map(torch.from_numpy, (q, k, v))).numpy()
        np.testing.assert_allclose(ours, pallas, atol=2e-4, rtol=0)
        np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)

    def test_unmatched_lengths_and_scale(self):
        """Nq != Nk with an explicit scale, on the plain route."""
        q = _np(40, (2, 21, 2, 16))
        k, v = _np(41, (2, 33, 2, 16)), _np(42, (2, 33, 2, 16))
        ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale=0.3))
        ours = attention_plain(*map(torch.from_numpy, (q, k, v)), scale=0.3)
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=0)


class TestResize:
    @pytest.mark.parametrize("kw", [
        dict(size=(24, 40)),                       # up, bilinear
        dict(size=(7, 9)),                         # down, bilinear
        dict(scale_factor=0.5),                    # kept scale
        dict(size=(13, 21), method="bicubic"),
    ])
    def test_matches_jax(self, kw):
        x = _np(50, (2, 12, 16, 5))
        ref = np.asarray(jax_resize(jnp.asarray(x), **kw))
        ours = resize(torch.from_numpy(x), **kw).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


class TestKernelPath:
    def test_no_nvcc_raises(self, monkeypatch, tmp_path):
        """Asking for the kernels with no nvcc raises; nothing falls back."""
        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(kbuild.shutil, "which", lambda _name: None)
        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(kbuild, "_lib", None)
        with pytest.raises(kernels.KernelBuildError, match="nvcc"):
            kernels.library()
        before = kernels.LAYER_NORM.launches
        with pytest.raises(kernels.KernelBuildError):
            kernels.LAYER_NORM(0, 0, 0, 0, 1, 8, 1e-6, 0, 0)
        assert kernels.LAYER_NORM.launches == before

    def test_wrappers_refuse_cpu_tensors(self):
        x = torch.zeros(4, 64)
        w, b = torch.ones(64), torch.zeros(64)
        with pytest.raises(ValueError, match="CUDA"):
            layer_norm_cuda(x, w, b, 1e-6)
        q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            attention_qkv_tm(q, q, q, 1, 0.125)
        with pytest.raises(ValueError, match="CUDA"):
            attention_fwd_lse_tm(q, q, q, 1, 0.125)
        # B3's backward on CUDA: B5's fused backward over the [B, H, N, 64]
        # views of the token-major tensors
        lse = torch.zeros(1, 1, 8)
        hq = _heads_hm(q, 1)
        with pytest.raises(ValueError, match="CUDA"):
            attention_hm_bwd(hq, hq, hq, hq, lse, lse, 0.125, hq, hq, hq)
        qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
        thirds = [_heads_hm(qkv[..., i * 64:(i + 1) * 64], 1)
                  for i in range(3)]
        with pytest.raises(ValueError, match="CUDA"):
            attention_hm_bwd(*thirds, hq, lse, lse, 0.125, *thirds)

    def test_cpu_path_launches_nothing(self):
        counts = kernels.launch_counts()
        layer_norm(torch.zeros(3, 16), torch.ones(16), torch.zeros(16), 1e-6)
        multi_head_attention_qkv_tm(torch.zeros(1, 5, 3 * 2 * 8), 2)
        assert kernels.launch_counts() == counts


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) leaves jax and
    the JAX package out of sys.modules; PIL too, which only the eval data
    readers import, when they read a file. The eval path's modules (the
    compact engine, B9, metrics, TTA, transforms, datasets, the CLI) and the
    train entry's (the config loader, the train CLI, the converters) are
    among those imported; loading the headline and a config whose
    get_config() calls the loader imports nothing of the JAX package
    either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vfmseg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from vfmseg_tpu_torch.core.config import load_config\n"
        "load_config('dg_lora_dinov2_ms_masked')\n"
        "load_config('dg_lora_dinov2_ms_masked_consistency')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'vfmseg_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "need = ['eval.compact', 'eval.metrics', 'eval.tta',\n"
        "        'ops.window_blend', 'data.transforms', 'data.datasets',\n"
        "        'utils.visualization', 'tools.test', 'core.config',\n"
        "        'tools.train', 'tools.convert_dinov2', 'tools.convert_eva2',\n"
        "        'tools.convert_sam', 'data.synthetic', 'train.loop']\n"
        "missing = [n for n in need if p.__name__ + '.' + n\n"
        "           not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50
