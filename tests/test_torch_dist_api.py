"""The port's sharding rules and traffic models against the reference's:
``logical_to_pspec`` over a grid of specs, rule tables, mesh sizes and
shapes; ``param_shard_specs`` of every arch the tensor-parallel engine
serves, on the dense and the compressed model, mapped through
``convert.reference_path``; ``ring_step_bytes`` / ``ring_matmul_bytes``;
``serve_ring_traffic_bytes``.  No process group is needed: a stand-in
mesh with a ``.shape`` is all the resolution reads."""

import itertools

import pytest
import torch

from _torch_engines import DEEPSEEK, LLAMA, one_thread, pair  # noqa: F401
from repro.dist import api as japi
from repro.dist.collectives import ring_matmul_bytes as j_ring_matmul_bytes
from repro.dist.collectives import ring_step_bytes as j_ring_step_bytes
from repro.models import param_shard_specs as j_param_shard_specs
from repro.models import serve_ring_traffic_bytes as j_traffic
from repro_torch.convert import reference_path
from repro_torch.dist import api
from repro_torch.dist.collectives import ring_matmul_bytes, ring_step_bytes
from repro_torch.models import param_shard_specs, serve_ring_traffic_bytes
from repro_torch.models.transformer import _linears

SLICE = (LLAMA, DEEPSEEK, "deepseek-67b")
NAMES = [None, "tp", "fsdp", "ep", "act_batch", "act_seq", "act_seq_sp",
         "act_heads", "act_vocab", "act_ep", "not_a_rule"]
SPECS = ([(a,) for a in NAMES] + list(itertools.product(NAMES, NAMES))
         + [("act_batch", "act_seq_sp", "act_heads", None),
            (None, "act_batch", "act_seq_sp", "act_heads", None),
            ("tp", "tp", "fsdp"), ("fsdp", "tp", "ep"),
            ("act_heads", "act_seq_sp", "act_vocab")])
SHAPES = [None, (8, 12, 16, 6, 4), (6, 4, 10, 3, 8), (3, 5, 7, 9, 11),
          (16, 2, 64, 8, 128), (1, 1, 1, 1, 1)]


class _Mesh:
    """A stand-in mesh: what ``logical_to_pspec`` reads."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _meshes(n):
    return [_Mesh(model=n), _Mesh(data=n, model=2), _Mesh(data=2, model=n),
            _Mesh(pod=2, data=n, model=2)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("table", ["DEFAULT_RULES", "MULTIPOD_RULES",
                                   "SERVE_TP_RULES"])
def test_logical_to_pspec_matches_reference(table, n):
    """Entry for entry the reference's ``PartitionSpec`` (dedupe,
    divisibility, axes the mesh lacks, no trailing None), with and without
    a mesh and a shape."""
    rules, jrules = getattr(api, table), getattr(japi, table)
    assert rules == jrules
    for mesh in [None] + _meshes(n):
        for spec in SPECS:
            for shape in SHAPES:
                shape = None if shape is None else shape[:len(spec)]
                want = tuple(japi.logical_to_pspec(spec, jrules, mesh=mesh,
                                                   shape=shape))
                got = api.logical_to_pspec(spec, rules, mesh=mesh,
                                           shape=shape)
                assert got == want, (table, mesh and mesh.shape, spec, shape)


def _flat(tree, path=()):
    """{key path: spec} of a reference spec tree (dict nodes; leaves are
    tuples of names, or None)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", SLICE)
def test_param_shard_specs_match_reference(arch, compressed):
    """Every parameter and buffer of the port's model has the reference's
    spec of the leaf it maps to, without the reference's stacked layer
    axes (the port keeps one module per layer)."""
    _, params, tc, model = pair(arch, compressed)
    ref = _flat(j_param_shard_specs(params))
    port = param_shard_specs(model)
    names = {n for n, _ in model.named_parameters()} | {
        n for n, _ in model.named_buffers()}
    assert set(port) == names
    kinds = set()
    for name, spec in port.items():
        path, idx = reference_path(name, tc)
        assert path in ref, name
        want = ref[path]
        want = None if want is None else tuple(want)[len(idx):]
        assert spec == want, (name, path, spec, want)
        kinds.add(name.rsplit(".", 1)[-1])
    linear = {"w_vals", "w_idx"} if compressed else {"w"}
    assert linear | {"emb"} <= kinds
    if arch == DEEPSEEK:
        assert "router" in kinds


def test_shard_model_cuts_each_leaf_to_its_rank():
    """``shard_model`` cuts the leaves its specs split (rows of a linear
    and of its bias, the vocab, the router's experts) to rank r's part,
    records the whole row counts, and leaves the model it was given
    whole."""
    from repro_torch.models import shard_model
    _, _, tc, model = pair(DEEPSEEK, True)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    mesh = api.ServeMesh(size=2, rank=1, device=torch.device("cpu"),
                         backend="gloo")
    local = shard_model(model, mesh)
    specs = param_shard_specs(model)
    whole = model.state_dict()
    for name, t in local.state_dict().items():
        pspec = api.logical_to_pspec(specs[name] or (), api.SERVE_TP_RULES,
                                     mesh=mesh, shape=whole[name].shape)
        want = whole[name]
        for dim, entry in enumerate(pspec):
            if entry is not None:
                part = want.shape[dim] // 2
                want = want.narrow(dim, part, part)
        assert torch.equal(t, want), name
    for name, t in model.state_dict().items():
        assert torch.equal(t, before[name])
    assert local.embed.tp_rows == tc.vocab
    assert local.layers[0].moe.tp_router == tc.n_experts
    assert local.layers[0].attn.wq.tp_rows == model.layers[0].attn.wq.w_vals \
        .shape[0]
    assert not hasattr(model.embed, "tp_rows")


def test_shard_model_moves_only_the_shard():
    """``shard_model(device=)`` puts every leaf of the shard, cut or
    replicated, on the device (``meta`` stands in for the card) and moves
    no leaf of the whole model, which stays where its caller keeps it."""
    from repro_torch.models import shard_model
    _, _, tc, model = pair(DEEPSEEK, True)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    mesh = api.ServeMesh(size=2, rank=0, device=torch.device("cpu"),
                         backend="gloo")
    meta = torch.device("meta")
    local = shard_model(model, mesh, device=meta)
    cut = shard_model(model, mesh)
    shapes = {n: t.shape for n, t in cut.state_dict().items()}
    got = local.state_dict()
    assert set(got) == set(shapes)
    for name, t in got.items():
        assert t.device == meta and t.shape == shapes[name], name
    for name, t in model.state_dict().items():
        assert t.device.type == "cpu" and torch.equal(t, before[name]), name
    assert local.embed.tp_rows == tc.vocab


@pytest.mark.parametrize("arch", SLICE[:2])
def test_init_model_store_keeps_every_leaf_there(arch):
    """``init_model(store=)`` moves each block to ``store`` as it is
    drawn: drawn on the CPU and kept on ``meta``, every leaf has the CPU
    model's shape and dtype and none is left on the CPU.  (That the numbers
    are the device's is held on the card, where the tensor-parallel ranks'
    tokens equal a single-rank engine's over a model drawn there.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config(arch, smoke=True)
    want = init_model(cfg, seed=3, device="cpu").state_dict()
    got = init_model(cfg, seed=3, device="cpu", store="meta").state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert (t.shape, t.dtype) == (want[name].shape, want[name].dtype)


@pytest.mark.parametrize("arch", SLICE[:2])
def test_packed_at_init_equals_packed_after(arch):
    """A tensor-parallel CLI rank serving compressed weights draws them
    packed (``mode='compressed'``): the same leaves, bit for bit, as the
    dense draw that the engine's ``convert_to_compressed`` packs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import convert_to_compressed, init_model
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="srste"))
    want = convert_to_compressed(init_model(cfg, seed=2, device="cpu"),
                                 cfg).state_dict()
    packed = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                      mode="compressed"))
    got = init_model(packed, seed=2, device="cpu").state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("sparse", [True, False])
def test_ring_bytes_match_reference(sparse, packed):
    for o, k, ndev, (n, m), db in itertools.product(
            (64, 128, 1024, 2048, 1000), (128, 512, 4096, 40),
            (1, 2, 4, 8), ((2, 4), (1, 4), (1, 2), (2, 8), (4, 8)), (2, 4)):
        kw = dict(dtype_bytes=db, sparse=sparse, packed=packed)
        assert ring_step_bytes(o // ndev, k, n, m, **kw) == \
            j_ring_step_bytes(o // ndev, k, n, m, **kw)
        assert ring_matmul_bytes(o, k, ndev, n, m, **kw) == \
            j_ring_matmul_bytes(o, k, ndev, n, m, **kw)


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", SLICE)
def test_serve_ring_traffic_matches_reference(arch, compressed, ndev):
    """The modeled ring bytes of a decode step equal the reference's
    (bytes and ratio; the port counts linears per layer, the reference
    per stacked leaf); the compressed ring ships at most 0.6 x the dense
    one."""
    jc, params, tc, model = pair(arch, compressed)
    want = j_traffic(params, jc, ndev)
    got = serve_ring_traffic_bytes(model, tc, ndev)
    for key in ("ring_bytes", "dense_ring_bytes", "ratio"):
        assert got[key] == want[key], key
    assert got["ring_linears"] + got["local_linears"] == len(_linears(model))
    if ndev > 1:
        assert got["ring_linears"] > 0
        assert got["ratio"] <= (0.6 if compressed else 1.0)
        assert compressed or got["ratio"] == 1.0
    else:
        assert got["ring_bytes"] == 0 and got["ring_linears"] == 0
