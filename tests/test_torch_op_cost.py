"""``launch.op_cost``, the port's stand-in for ``repro.launch.hlo_cost``:
the cases of ``tests/test_hlo_cost.py`` restated for eager code (dot
FLOPs, a loop of T counts T times and nested loops multiply, a slice of a
stacked buffer counts the slice, a collective in a loop counts T times on
the abstract mesh and on a real 2-rank gloo group), the kernel regions
(one count per call, none for the ops inside; the same counts on ``meta``
as on the CPU), and the FLOPs of smoke steps against the reference's
``analyze_hlo`` of the same steps."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import batch as train_batch
from _torch_engines import one_thread, pair  # noqa: F401 (autouse)
from _torch_tp import run_ranks
from repro.launch import steps as jsteps
from repro.launch.hlo_cost import analyze_hlo
from repro.models import transformer as jtfm
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro_torch.core.sparse_matmul import nm_matmul
from repro_torch.core.sparsity import compress
from repro_torch.data import to_device
from repro_torch.dist.api import make_abstract_mesh
from repro_torch.dist.collectives import all_gather, all_reduce
from repro_torch.kernels.flash_attention import paged_gqa_decode
from repro_torch.launch import steps as tsteps
from repro_torch.launch.op_cost import OpCost, region
from repro_torch.models import transformer as ttfm
from repro_torch.optim import AdamWConfig, adamw_init


def _count(fn, *args, mesh=None):
    with OpCost(mesh) as cost:
        fn(*args)
    return cost


def test_dot_flops_counted():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    assert _count(lambda: a @ b).flops == 2 * 64 * 128 * 32
    x, w = torch.randn(3, 5, 16), torch.randn(3, 16, 8)
    assert _count(lambda: torch.einsum("bik,bkj->bij", x, w)).flops == \
        2 * 3 * 5 * 16 * 8
    lin = torch.nn.functional.linear
    assert _count(lambda: lin(a, b.t(), torch.zeros(32))).flops == \
        2 * 64 * 128 * 32


def test_loop_counts_each_iteration():
    """The eager counterpart of a scan's trip multiplier: a dot in a loop
    of T counts T times."""
    T = 7
    x, w = torch.randn(8, 16), torch.randn(T, 16, 16)

    def f():
        c = x
        for i in range(T):
            c = torch.tanh(c @ w[i])

    cost = _count(f)
    assert cost.flops == T * 2 * 8 * 16 * 16
    assert cost.op_counts["mm"] == T
    assert cost.result()["loops"] == {}


def test_nested_loops_multiply():
    T1, T2 = 3, 5
    x, w = torch.randn(4, 8), torch.randn(T1, T2, 8, 8)

    def f():
        c = x
        for i in range(T1):
            for j in range(T2):
                c = c @ w[i, j]

    assert _count(f).flops == T1 * T2 * 2 * 4 * 8 * 8


def test_slice_of_stacked_buffer_counts_the_slice():
    """Reading one slice of a large stacked buffer per iteration counts the
    slice, not the whole buffer every step."""
    T, D = 50, 256
    x, w = torch.randn(D), torch.randn(T, D)

    def f():
        c = x
        for i in range(T):
            c = c + w[i]

    cost = _count(f)
    assert cost.bytes == T * 3 * D * 4          # c, w[i] read; c written
    assert cost.bytes < T * (T * D * 4) * 0.5


def test_in_place_update_counts_the_update():
    buf, upd = torch.zeros(100, 64), torch.randn(64)
    assert _count(lambda: buf[3].copy_(upd)).bytes == 2 * 64 * 4
    idx = torch.tensor([1, 5])
    vals = torch.randn(2, 64)
    assert _count(lambda: buf.index_put_((idx,), vals)).bytes == \
        2 * (2 * 64 * 4 + 2 * 8)
    assert _count(lambda: buf.zero_()).bytes == 100 * 64 * 4


def test_collective_in_loop_counts_each_iteration_abstract():
    T, n = 6, 4
    mesh = make_abstract_mesh((n, 1))
    x = torch.empty(32, device="meta")
    grp = mesh.axis("data")

    def f():
        for _ in range(T):
            all_reduce(x, grp)
            all_gather(x, grp)

    coll = _count(f, mesh=mesh).result()["collectives_by_type"]
    assert coll == {"all-reduce": T * 2 * (n - 1) * 32 * 4 // n,
                    "all-gather": T * (n - 1) * 32 * 4}


_COLL = r'''
def body(mesh, t):
    from repro_torch.dist.collectives import all_gather, all_reduce
    from repro_torch.launch.op_cost import OpCost
    x = torch.ones(32)
    with OpCost(mesh) as cost:
        for _ in range(int(t)):
            y = all_reduce(x, mesh)
            z = all_gather(x, mesh)
    assert float(y[0]) == mesh.size and z.shape == (mesh.size, 32)
    return cost.result()["collectives_by_type"]
'''


def test_collective_in_loop_counts_each_iteration_gloo(tmp_path):
    """The same counts on a real 2-rank gloo group as on the abstract
    mesh of two."""
    T = 6
    ranks = run_ranks(_COLL, 2, tmp_path / "out", T)
    mesh = make_abstract_mesh((2, 1))
    x = torch.empty(32, device="meta")

    def f():
        for _ in range(T):
            all_reduce(x, mesh.axis("data"))
            all_gather(x, mesh.axis("data"))

    want = _count(f, mesh=mesh).result()["collectives_by_type"]
    assert ranks == [want, want]


def test_kernel_region_counts_once():
    """``nm_matmul`` on the plain path counts one call by its model; the
    decompress and product inside count nothing; a region inside a region
    counts nothing."""
    w = torch.randn(48, 64)
    sp = compress(w, 2, 4)
    x = torch.randn(5, 64)
    cost = _count(lambda: nm_matmul(x, sp))
    assert dict(cost.op_counts) == {"nm_matmul": 1}
    assert cost.flops == 2 * 5 * 64 * 48
    assert cost.bytes == 4 * (5 * 64 + 48 * 32 + 5 * 48) + 48 * 32

    def nested():
        with region("outer") as r:
            nm_matmul(x, sp)
            r.add(7, 9)

    cost = _count(nested)
    assert dict(cost.op_counts) == {"outer": 1}
    assert (cost.flops, cost.bytes) == (7, 9)


def test_paged_attention_region_counts_its_table():
    b, kvh, g, d, bs, tw = 2, 2, 3, 16, 4, 5
    q = torch.randn(b, kvh, g, d)
    kp, vp = torch.randn(12, bs, kvh, d), torch.randn(12, bs, kvh, d)
    tbl = torch.arange(b * tw, dtype=torch.int32).reshape(b, tw)
    lens = torch.tensor([7, 13], dtype=torch.int32)
    cost = _count(lambda: paged_gqa_decode(q, kp, vp, tbl, lens))
    assert dict(cost.op_counts) == {"paged_gqa_decode": 1}
    pos = tw * bs
    assert cost.flops == 2 * b * kvh * g * pos * 2 * d
    assert cost.bytes == (2 * q.numel() * 4 + tbl.numel() * 4 + 2 * 4
                          + b * pos * kvh * 2 * d * 4)


def _batch(cfg, rng, b, s):
    out = {}
    if cfg.input_mode == "embeds":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


B, S, MAXLEN = 2, 16, 32


def _serve_counts(arch, kind, device="cpu"):
    """The port's smoke step on ``device`` (the converted reference
    weights on the CPU, a model of the same config on ``meta``) ->
    its ``OpCost``."""
    _, _, tc, model = pair(arch, compressed=True)
    if device == "meta":
        model = ttfm.init_model(tc, device="meta")
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(v).to(device)
         for k, v in _batch(tc, rng, B, S).items()}
    if kind == "prefill":
        return _count(tsteps.make_prefill_step(tc), model, b)
    caches = ttfm.init_caches(tc, B, MAXLEN, device=device)
    tok = torch.zeros(B, dtype=torch.int32, device=device)
    pos = torch.tensor(3, dtype=torch.int32, device=device)
    return _count(tsteps.make_decode_step(tc), model, caches, tok, pos)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_serve_step_flops_equal_reference(arch, kind):
    """Within 1% of the reference's ``analyze_hlo`` (measured: equal)."""
    jc, jp, tc, _ = pair(arch, compressed=True)
    b = _batch(jc, np.random.default_rng(0), B, S)
    if kind == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(jc)).lower(
            jp, jax.tree.map(jnp.asarray, b))
    else:
        caches = jtfm.init_caches(jc, B, MAXLEN)[0]
        lowered = jax.jit(jsteps.make_decode_step(jc)).lower(
            jp, caches, jnp.zeros(B, jnp.int32), jnp.int32(3))
    want = analyze_hlo(lowered.compile().as_text())["flops"]
    got = _serve_counts(arch, kind).flops
    assert got == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "whisper-small"])
def test_meta_step_counts_equal_cpu_step(arch, kind):
    """The abstract step (``meta``) counts the FLOPs and bytes of the same
    step run on the CPU: the kernel regions count by their model, so the
    route inside them does not move the counts."""
    cpu = _serve_counts(arch, kind)
    meta = _serve_counts(arch, kind, device="meta")
    assert (meta.flops, meta.bytes) == (cpu.flops, cpu.bytes)
    assert meta.regions == cpu.regions and cpu.regions["nm_matmul"] > 0


# the port's train step counts these FLOPs more than the reference's
# (accum 1): the port's activation checkpoint recomputes each MoE block's
# whole forward in the backward, where the reference's compiled remat
# recomputes less of it (without remat the port counts 917504 fewer).
TRAIN_GAP = {"llama3.2-1b": 0, "deepseek-v2-lite-16b": 52166656}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", sorted(TRAIN_GAP))
def test_train_step_flops_equal_reference(arch, accum):
    jc, jp, tc, model = pair(arch)
    b = train_batch(tc)
    jfn = jax.jit(jsteps.make_train_step(jc, JAdamW(master_weights=False),
                                         accum=accum))
    want = analyze_hlo(jfn.lower(
        jp, jadamw_init(jp, JAdamW(master_weights=False)),
        jax.tree.map(jnp.asarray, b), jnp.int32(1)).compile().as_text())
    model = copy.deepcopy(model)
    ocfg = AdamWConfig(master_weights=False)
    opt = adamw_init(tsteps.named_params(model), ocfg)
    step = tsteps.make_train_step(tc, ocfg, accum=accum)
    got = _count(step, model, opt, to_device(b, "cpu"), 1).flops
    assert got == pytest.approx(want["flops"], rel=0.05)
    assert got - want["flops"] == TRAIN_GAP[arch]
