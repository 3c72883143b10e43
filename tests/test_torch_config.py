"""The port's config loader against the JAX package's, on the CPU.

Every file under ``configs/`` loads through both ``load_config``s to the
same tree. The files import the JAX package's presets and loader; the
port's loader resolves those two modules to its own twins through the
file's ``__import__`` and leaves ``sys.modules`` alone.
"""

import glob
import os
import sys

import pytest

from vfmseg_tpu.core import config as jax_config
from vfmseg_tpu_torch.core import config as port_config
from vfmseg_tpu_torch.models import presets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs", "**", "*.py"),
                       recursive=True))


def test_every_config_file_is_listed():
    assert len(CONFIG_FILES) == 77


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_config_equals_jax_load_config(path):
    """The whole tree, ``_base_`` merges, ``_delete_`` and get_config()
    files (the consistency config's loads the headline through the loader)
    included."""
    full = os.path.join(REPO, path)
    assert port_config.load_config(full).to_dict() == (
        jax_config.load_config(full).to_dict())


@pytest.mark.parametrize("name", ["dg_lora_dinov2_ms_masked",
                                  "smoke_tiny_dg_msvfm",
                                  "dg_lora_dinov2_ms_masked_consistency"])
def test_bare_names_resolve_as_in_jax(name):
    assert port_config._resolve(name) == jax_config._resolve(name)
    assert presets.config(name).to_dict() == (
        jax_config.load_config(name).to_dict())


def _jax_modules():
    return {k: v for k, v in sys.modules.items()
            if k.split(".")[0] == "vfmseg_tpu"}


def test_jax_modules_left_untouched():
    """Loading configs through the port imports no JAX module and replaces
    none in sys.modules; the JAX loader still gets the JAX presets."""
    jax_config.load_config("dg_lora_dinov2_ms_masked")
    before = _jax_modules()
    for name in ("dg_lora_dinov2_ms_masked", "dg_lora_sam_ms_masked",
                 "dg_lora_dinov2_ms_masked_consistency",
                 "smoke_tiny_dg_msvfm"):
        port_config.load_config(name)
    after = _jax_modules()
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    from vfmseg_tpu.models import presets as jax_presets

    assert jax_presets.__name__ == "vfmseg_tpu.models.presets"
    assert jax_presets is not presets


def test_unmapped_jax_import_raises(tmp_path):
    """Any vfmseg_tpu import but the two mapped ones raises, naming the
    file; the mapped ones work in each import form."""
    bad = tmp_path / "bad_cfg.py"
    bad.write_text("from vfmseg_tpu.models.build import build_segmentor\n"
                   "config = dict(a=1)\n")
    with pytest.raises(ImportError, match="bad_cfg.py"):
        port_config.load_config(str(bad))
    bad.write_text("import vfmseg_tpu\nconfig = dict(a=1)\n")
    with pytest.raises(ImportError, match="bad_cfg.py"):
        port_config.load_config(str(bad))
    ok = tmp_path / "ok_cfg.py"
    ok.write_text("import vfmseg_tpu.models.presets as P\n"
                  "from vfmseg_tpu.models.presets import FEAT_DIM\n"
                  "from vfmseg_tpu.core import config as C\n"
                  "config = dict(d=FEAT_DIM['sam'], head=P.linear_head(),\n"
                  "              merged=C.deep_merge({'a': 1}, {'b': 2}))\n")
    cfg = port_config.load_config(str(ok))
    assert cfg.d == 1280 and cfg.merged == {"a": 1, "b": 2}
    assert cfg.head == presets.linear_head()
    assert cfg.name == "ok_cfg"


def test_cfg_options_match_jax():
    """``--cfg-options`` parsing: literals, strings, new paths, lists of
    dicts, tuples; an override without '=' raises in both."""
    overrides = ["optimizer.lr=3e-4", "schedule.save_best=synth_mIoU",
                 "new.key.path=hello", "data.num_workers=1",
                 "data.val=[{'type': 'GTADataset', 'data_root': 'x'}]",
                 "test_cfg.stride=(16, 16)", "compute.attn_impl=xla",
                 "peft.enabled=False", "model.aux_head.transformer.x=None"]
    ours = port_config.load_config("smoke_tiny_ms_masked", overrides)
    theirs = jax_config.load_config("smoke_tiny_ms_masked", overrides)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.get_path("schedule.save_best") == "synth_mIoU"
    assert ours.get_path("data.val")[0].data_root == "x"
    for load in (port_config.load_config, jax_config.load_config):
        with pytest.raises(ValueError):
            load("smoke_tiny_ms_masked", ["no_equals_sign"])


def test_deep_merge_and_presets_match_jax():
    base = {"a": {"b": 1, "c": [1, 2]}, "d": 3}
    over = {"a": {"c": [3]}, "d": {"_delete_": True, "e": 4}}
    assert port_config.deep_merge(base, over) == (
        jax_config.deep_merge(base, over))
    from vfmseg_tpu.models import presets as jp

    for fn, args in [("backbone", ("clip",)), ("lora_backbone", ("eva02",)),
                     ("reins_backbone", ("sam", 512, True)),
                     ("vfm_aux_head", (1024, 256, 19, False)),
                     ("mask2former_head", (1024, 19, False)),
                     ("hrda_head", ()), ("hrda_test_cfg", ()),
                     ("ms_test_cfg", (False,)), ("segformer_head", ()),
                     ("daformer_head", ()), ("mit_b5", ())]:
        assert getattr(presets, fn)(*args) == getattr(jp, fn)(*args), fn
    for name in ("FEAT_DIM", "LORA_TARGETS", "CHECKPOINTS", "PREPROCESSOR"):
        assert getattr(presets, name) == getattr(jp, name), name
