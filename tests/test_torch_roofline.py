"""The port's roofline pieces against the reference's
(``repro.launch.{shapes,roofline}``): the shape table and
``cell_supported`` for every arch x shape, ``RooflineTerms`` at the
H100's constants, and ``param_counts_exact`` / ``sparse_weight_bytes``
over the port's ``meta`` model against the reference's over its
``jax.eval_shape`` tree, for every arch of the registry at full size,
the serving and the training trees."""

import dataclasses

import pytest

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget
from repro.launch import roofline as jroof
from repro.launch import shapes as jshapes
from repro.launch.steps import abstract_params as jabstract
from repro_torch.configs import get_config as tget
from repro_torch.launch import roofline as troof
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.steps import abstract_params


def test_shape_table_equals_reference():
    assert tshapes.ALL_SHAPES == jshapes.ALL_SHAPES
    for name, want in jshapes.SHAPES.items():
        assert dataclasses.astuple(tshapes.SHAPES[name]) == \
            dataclasses.astuple(want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_supported_equals_reference(arch):
    for shape in jshapes.ALL_SHAPES:
        assert tshapes.cell_supported(tget(arch), shape) == \
            jshapes.cell_supported(jget(arch), shape), (arch, shape)


def test_h100_constants():
    """The H100 SXM's published peaks (bf16 dense, HBM3, NVLink 4 each
    way)."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.HBM_BYTES,
            troof.LINK_BW) == (989e12, 3.35e12, 80e9, 450e9)


def test_roofline_terms():
    """The reference's ``test_roofline_terms`` case at H100 constants."""
    t = troof.RooflineTerms(flops=troof.PEAK_FLOPS,
                            bytes_accessed=troof.HBM_BW,
                            collective_bytes=troof.LINK_BW / 2, chips=2,
                            model_flops=troof.PEAK_FLOPS)
    assert t.compute_s() == pytest.approx(1.0)
    assert t.memory_s() == pytest.approx(1.0)
    assert t.collective_s() == pytest.approx(0.5)
    assert t.dominant() in ("compute", "memory")
    assert t.useful_flops_ratio() == pytest.approx(0.5)
    assert t.roofline_fraction() == pytest.approx(0.5)
    d = t.as_dict()
    j = jroof.RooflineTerms(flops=1.0, bytes_accessed=1.0,
                            collective_bytes=1.0, chips=2,
                            model_flops=1.0).as_dict()
    assert sorted(d) == sorted(j)


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_and_sparse_bytes_equal_reference(arch, serve):
    jshape, _, jc = jabstract(jget(arch), serve=serve)
    model, _, tc = abstract_params(tget(arch), serve=serve)
    assert next(model.parameters()).is_meta
    assert troof.param_counts_exact(model, tget(arch)) == \
        jroof.param_counts_exact(jshape, jget(arch))
    assert troof.sparse_weight_bytes(model, tc.sparsity) == \
        jroof.sparse_weight_bytes(jshape, jc.sparsity)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equals_reference(kind):
    for arch in ("llama3.2-1b", "deepseek-v2-lite-16b"):
        n = troof.param_counts_exact(abstract_params(tget(arch))[0],
                                     tget(arch))[1]
        assert troof.model_flops_for(tget(arch), kind, 256, 4096, n) == \
            jroof.model_flops_for(jget(arch), kind, 256, 4096, n)
