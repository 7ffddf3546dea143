"""The compressed N:M ring and the transport of tensor-parallel serving on
the CPU, over gloo at world size 2 and 4: ``ring_sparse_linear`` is bit
for bit the local plain product of the whole weight (f32 and bf16, also
through ``nm_matmul(impl="ring")``); the bytes the transport counts per
step are ``ring_step_bytes(packed=True)``, plus the stated padding of each
row's packed indices to whole 32-bit words; ``collective_matmul_ag``
equals ``x @ w``.  Then ``BlockPool(mesh=)``'s local leaves against the
reference's resolved cache specs (no process group needed)."""

import pytest
import torch

from _torch_engines import DEEPSEEK, LLAMA, one_thread  # noqa: F401
from _torch_tp import run_ranks

_RING = r'''
def body(mesh):
    from repro_torch.core.sparse_matmul import nm_matmul
    from repro_torch.core.sparsity import NMSparse, compress
    from repro_torch.dist.api import axis_rules
    from repro_torch.core.sparsity import index_bits
    from repro_torch.dist.collectives import (
        collective_matmul_ag, ring_sparse_linear, ring_step_bytes)

    def packed_row_padding(rows, k, n, m):
        """Bytes the transport's packed words carry beyond
        ring_step_bytes' index stream: each row's indices are packed into
        whole 32-bit words, so a row whose nnz does not fill its last
        word sends that word's empty slots."""
        per_word = 32 // index_bits(m)
        words = rows * -(-(k // m * n) // per_word) * 4
        return words - ring_step_bytes(rows, k, n, m)["index_bytes"]

    n, r = mesh.size, mesh.rank
    gen = torch.Generator().manual_seed(0)
    out = {"ring": [], "ag": []}
    # (O, K, x's leading shape): decode-shaped rows, a ragged K (40: 20
    # slots a row, not a whole number of 16-slot words), a prefill span
    for dtype in (torch.float32, torch.bfloat16):
        for o, k, lead in ((128, 128, (4, 1)), (256, 512, (3,)),
                           (64, 40, (2, 1)), (512, 256, (1, 9))):
            w = torch.randn(o, k, generator=gen).to(dtype)
            sp = compress(w, 2, 4)
            x = torch.randn(*lead, k, generator=gen).to(dtype)
            whole = nm_matmul(x, sp, "plain")
            part = o // n
            v = sp.values[r * part:(r + 1) * part].clone()
            i = sp.indices[r * part:(r + 1) * part].clone()
            mesh.reset_stats()
            y = ring_sparse_linear(x, v, i, 2, 4, mesh, "plain", plan_o=o)
            sent = mesh.stats["ring_bytes"]
            with axis_rules(mesh):
                y2 = nm_matmul(x, NMSparse(v, i, 2, 4, (part, k)), "ring")
            step = ring_step_bytes(part, k, 2, 4,
                                   dtype_bytes=x.element_size())
            out["ring"].append(dict(
                case=[str(dtype), o, k, list(lead)],
                bitwise=bool(torch.equal(y, whole)),
                via_nm_matmul=bool(torch.equal(y2, whole)),
                shape=list(y.shape) == list(whole.shape),
                sent=sent, step=step["total_bytes"],
                padding=packed_row_padding(part, k, 2, 4)))
    for o, k in ((64, 128), (96, 256)):
        x = torch.randn(3, k, generator=gen)
        w = torch.randn(k, o, generator=gen)
        ck, co = k // n, o // n
        y = collective_matmul_ag(x[:, r * ck:(r + 1) * ck].contiguous(),
                                 w[:, r * co:(r + 1) * co].contiguous(),
                                 mesh)
        want = (x @ w)[:, r * co:(r + 1) * co]
        out["ag"].append(float((y - want).abs().max()))
    return out
'''


@pytest.mark.parametrize("n", [2, 4])
def test_ring_is_bitwise_the_local_product_and_counts_its_bytes(tmp_path, n):
    ranks = run_ranks(_RING, n, tmp_path / "ring")
    for rank, res in enumerate(ranks):
        for case in res["ring"]:
            assert case["bitwise"] and case["via_nm_matmul"], (rank, case)
            assert case["shape"], case
            # each rank passes its held shard on n - 1 times; what it sends
            # is ring_step_bytes(packed=True) plus its rows' word padding,
            # which is zero where a row's nnz fills whole 32-bit words
            assert case["sent"] == (n - 1) * (case["step"] + case["padding"])
            k = case["case"][2]
            if (k // 4 * 2) % 16 == 0:
                assert case["padding"] == 0, case
            else:     # K 40: 20 slots a row, 12 empty slots = 3 bytes a row
                assert case["padding"] == case["case"][1] // n * 3, case
        assert max(res["ag"]) <= 1e-4, res["ag"]
    assert ranks[0]["ring"] == [dict(c) for c in ranks[-1]["ring"]]


def _shard_shape(shape, pspec, n):
    out = list(shape)
    for dim, entry in enumerate(pspec):
        if entry is not None:
            out[dim] //= n
    return tuple(out)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_blockpool_leaves_are_the_reference_specs_shards(arch, n):
    """Each leaf of the port's ``BlockPool(mesh=)`` has the shape of rank
    r's shard of the reference pool's leaf under its resolved spec (GQA's
    kv heads split, block axes and MLA's latent leaves whole); the table
    stays host numpy."""
    import jax
    import numpy as np
    from repro.configs import get_config as jget
    from repro.dist.api import SERVE_TP_RULES as JRULES
    from repro.dist.api import logical_to_pspec
    from repro.serve.paged import BlockPool as JPool
    from repro_torch.configs import get_config
    from repro_torch.dist.api import ServeMesh
    from repro_torch.serve.cache import leaves
    from repro_torch.serve.paged import BlockPool

    class Stand:
        shape = {"model": n}

    ref = JPool(jget(arch, smoke=True), n_slots=2, max_len=16, block_size=4)
    ref_leaves = jax.tree_util.tree_leaves(ref.caches)
    specs = ref._treedef.flatten_up_to(ref.cache_specs)
    for rank in range(n):
        mesh = ServeMesh(size=n, rank=rank, device=torch.device("cpu"),
                         backend="gloo")
        pool = BlockPool(get_config(arch, smoke=True), 2, 16, 4,
                         device="cpu", mesh=mesh)
        got = leaves(pool.caches)
        assert len(got) == len(ref_leaves)
        split = False
        for leaf, rleaf, spec in zip(got, ref_leaves, specs):
            pspec = logical_to_pspec(spec, JRULES, mesh=Stand(),
                                     shape=rleaf.shape)
            assert tuple(leaf.shape) == _shard_shape(rleaf.shape, pspec, n)
            split |= any(e is not None for e in pspec)
        assert split == (arch == LLAMA)    # into n parts (n = 1: whole)
        assert isinstance(pool.table, np.ndarray)
