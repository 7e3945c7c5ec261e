"""Port parity: the LM architecture registry. ``repro_torch.configs`` holds
its own copy of the reference's dataclasses; every full config, every
``reduced()`` config, the layer plans, padded vocabularies, the shape table
and the shape-applicability rule must equal the reference's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)


def _fields(cfg) -> dict:
    """Every dataclass field, the MLA sub-config as a dict."""
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def _prop(cfg, name):
    """A derived property, or the type of the error it raises (the
    attention-free falcon-mamba has no head dim in either package)."""
    try:
        return getattr(cfg, name)
    except ZeroDivisionError as e:
        return type(e)


def test_registry_names():
    assert sorted(tconfigs.ARCHS) == ARCHS
    for arch in ARCHS:
        assert tconfigs.get_config(arch).name == arch
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_fields_equal(arch, reduced):
    j, t = jconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert _fields(t) == _fields(j)
    assert t.layer_plan() == j.layer_plan()
    for name in ("padded_vocab", "resolved_head_dim", "resolved_dt_rank", "period",
                 "n_periods", "attention_free"):
        assert _prop(t, name) == _prop(j, name), name


def test_reduced_overrides_equal():
    over = dict(capacity_factor=8.0, flash_min_seq=8, dtype="bfloat16")
    for arch in ARCHS:
        assert _fields(tconfigs.ARCHS[arch].reduced(**over)) == \
            _fields(jconfigs.ARCHS[arch].reduced(**over))


def test_shapes_and_applicability():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        for name in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(tconfigs.ARCHS[arch], tconfigs.SHAPES[name]) == \
                jconfigs.shape_applicable(jconfigs.ARCHS[arch], jconfigs.SHAPES[name])


def test_torch_dtype():
    assert tconfigs.torch_dtype(tconfigs.ARCHS["internlm2-1.8b"]) is torch.bfloat16
    assert tconfigs.torch_dtype(tconfigs.ARCHS["internlm2-1.8b"].reduced()) is torch.float32
    with pytest.raises(ValueError):
        tconfigs.torch_dtype(tconfigs.ARCHS["internlm2-1.8b"].reduced(dtype="no_such_type"))
