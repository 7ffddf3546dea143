"""Port parity for self-speculative serving: ``nm_rerank``, the draft views,
the span write, the verify attention (plain versions of the two verify
kernels), ``verify_step``, ``BlockPool.rollback`` and the speculative
engine, each against the reference (llama3.2-1b and deepseek-v2-lite-16b
smoke configs, f32, the reference's jax.random weights carried over through
repro_torch.convert, inputs drawn with numpy).  The engine's token streams
against the reference engine's are in ``tests/test_torch_spec_engine.py``
and ``tests/test_torch_spec_demotion.py``.

Tolerances: re-ranking, span writes, pool bookkeeping and token streams are
exact.  Verify attention: 1e-5 in f32 (sums in other orders over a few
dozen positions) and 2e-2 in bf16 (one rounding step of O(1) outputs).
verify_step logits: 1e-4 in f32 (sums in other orders over 4 layers), with
equal argmax."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.sparse_matmul import nm_rerank as jrerank  # noqa: E402
from repro.core.sparsity import compress as jcompress  # noqa: E402
from repro.kernels.flash_attention import paged_gqa_verify as jgqa_verify  # noqa: E402
from repro.kernels.flash_attention import paged_mla_verify as jmla_verify  # noqa: E402
from repro.models import make_draft as jmake_draft  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import verify_step as jverify  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models.attention import _paged_write_span as jwrite_span  # noqa: E402
from repro.serve import BlockPool as JPool  # noqa: E402
from repro.serve import SpecConfig as JSpec  # noqa: E402
from repro.serve.speculative import accept_greedy as jaccept  # noqa: E402
from repro.serve.speculative import draft_propose_k as jpropose  # noqa: E402
from _torch_engines import DEEPSEEK, LLAMA, one_thread  # noqa: E402,F401
from _torch_engines import pair as _pair  # noqa: E402
from _torch_engines import ragged as _ragged  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.core.sparse_matmul import nm_rerank  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_gqa_decode_plain, paged_gqa_verify_plain, paged_mla_decode_plain,
    paged_mla_verify_plain)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import (decode_step, make_draft,  # noqa: E402
                                verify_step, weight_stream_bytes)
from repro_torch.models.attention import _paged_write_span  # noqa: E402
from repro_torch.serve import (BlockPool, ServeEngine, SpecConfig,  # noqa: E402
                               accept_greedy, draft_propose_k,
                               synthetic_request)
from repro_torch.serve import engine as engine_mod  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_CACHE = {}
_jverify_jit = jax.jit(jverify, static_argnums=(1,),
                       static_argnames=("attn_impl",))


# ------------------------------------------------------------- nm_rerank

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(2, 4), (2, 8)])
@pytest.mark.parametrize("stacked", [False, True])
def test_nm_rerank_bitwise_equals_reference(dtype, n, m, stacked):
    """Tied magnitudes (weights on a coarse grid, both signs) resolve to the
    lowest stored slot, as jax.lax.top_k; stacked [E, O, nnz] expert leaves
    re-rank along their last axis."""
    rng = np.random.default_rng(n * m + stacked)
    shape = (3, 24, 64) if stacked else (24, 64)
    w = rng.integers(-3, 4, size=shape).astype(np.float32) * 0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    sp = jcompress(jnp.asarray(w, jdt), n, m)
    want_v, want_i = jrerank(sp.values, sp.indices, n, m, 1)
    got_v, got_i = nm_rerank(to_torch(np.asarray(sp.values), "cpu"),
                             to_torch(np.asarray(sp.indices), "cpu"), n, m, 1)
    assert got_v.dtype == to_torch(np.asarray(want_v), "cpu").dtype
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v).astype(np.float32))
    with pytest.raises(ValueError, match="keep"):
        nm_rerank(got_v, got_i, n, m, n)


# -------------------------------------------------- acceptance and config

def test_accept_greedy_and_spec_config_match_reference():
    rng = np.random.default_rng(0)
    drafts = rng.integers(0, 3, (64, 4))
    va = rng.integers(0, 3, (64, 5))
    va[:8, :4] = drafts[:8]                  # some full acceptances
    np.testing.assert_array_equal(accept_greedy(drafts, va),
                                  jaccept(drafts, va))
    for kw, msg in ((dict(k=0), "k >= 1"), (dict(draft="tree"), "draft"),
                    (dict(stride=1), "stride")):
        with pytest.raises(ValueError, match=msg):
            JSpec(**kw)
        with pytest.raises(ValueError, match=msg):
            SpecConfig(**kw)
    assert dataclasses.asdict(SpecConfig()) == dataclasses.asdict(JSpec())


# ------------------------------------------------------------- span write

def test_span_write_pools_bitwise_equal():
    """S = 3 tokens per row through a shuffled table, one span crossing a
    block boundary and one idle row writing the trash block."""
    rng = np.random.default_rng(1)
    nb, bs, s = 9, 4, 3
    pools = {"k": rng.standard_normal((nb, bs, 2, 8)).astype(np.float32),
             "v": rng.standard_normal((nb, bs, 2, 8)).astype(np.float32)}
    tbl = np.array([[3, 7, 1, 0], [5, 2, 8, 6], [0, 0, 0, 0]], np.int32)
    pos = np.array([2, 9, 0], np.int32)
    upd = {n: rng.standard_normal((3, s, 2, 8)).astype(np.float32)
           for n in pools}
    want = jwrite_span({n: jnp.asarray(p) for n, p in pools.items()},
                       {n: jnp.asarray(u) for n, u in upd.items()},
                       jnp.asarray(tbl), jnp.asarray(pos))
    got = _paged_write_span({n: torch.tensor(p) for n, p in pools.items()},
                            {n: torch.tensor(u) for n, u in upd.items()},
                            torch.tensor(tbl), torch.tensor(pos))
    for name in pools:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        np.testing.assert_array_equal(got[name][7, 0].numpy(),
                                      upd[name][0, 2])   # past the boundary


def _duplicate_write_case(rng):
    """The deepseek-v2-lite verify shape: 8 rows x span 4 of the 576-wide
    latent, two live rows and six masked rows (all-trash table, position
    0) that all name trash cells 0..3."""
    b, s, bs, width = 8, 4, 16, 576
    pools = {"ckv": np.zeros((5, bs, width), np.float32)}
    tbl = np.zeros((b, 2), np.int32)
    tbl[0], tbl[1] = [1, 2], [3, 4]
    pos = np.array([5, 20] + [0] * (b - 2), np.int32)
    upd = {"ckv": rng.standard_normal((b, s, width)).astype(np.float32)}
    return pools, upd, tbl, pos


def test_span_write_duplicate_cells_take_the_last_writer():
    """A cell several masked rows name takes its last writer's value in
    (row, offset) order, on every call, as the reference leaves it: the
    masked rows read it back and, in the MoE family, compete with the live
    rows for expert capacity, so a write race there would change the live
    rows' tokens from run to run."""
    pools, upd, tbl, pos = _duplicate_write_case(np.random.default_rng(2))
    want = jwrite_span({n: jnp.asarray(p) for n, p in pools.items()},
                       {n: jnp.asarray(u) for n, u in upd.items()},
                       jnp.asarray(tbl), jnp.asarray(pos))
    np.testing.assert_array_equal(np.asarray(want["ckv"])[0, :4],
                                  upd["ckv"][-1])
    for _ in range(20):
        got = _paged_write_span(
            {n: torch.tensor(p) for n, p in pools.items()},
            {n: torch.tensor(u) for n, u in upd.items()},
            torch.tensor(tbl), torch.tensor(pos))
        np.testing.assert_array_equal(got["ckv"].numpy(),
                                      np.asarray(want["ckv"]))


# -------------------------------------------------- verify attention, plain

def _span_tables(rng, lens, s, bs, trash_row=True):
    """Slot r owns ceil((lens[r] + s - 1) / bs) shuffled blocks; the last
    row (kv_len 1) keeps an all-trash table when ``trash_row``."""
    b = len(lens)
    tw = -(-(max(lens) + s - 1) // bs)
    nb = b * tw + 1
    free = list(rng.permutation(np.arange(1, nb)))
    tbl = np.zeros((b, tw), np.int32)
    for r, ln in enumerate(lens):
        if trash_row and r == b - 1:
            continue
        for j in range(-(-(ln + s - 1) // bs)):
            tbl[r, j] = free.pop()
    return tbl, nb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [dict(), dict(window=6, cap=20.0)])
def test_paged_gqa_verify_plain_matches_reference_kernel(dtype, case):
    """Plain GQA verify (what the CUDA kernel is held against) against the
    reference kernel in interpret mode and against S calls of the port's
    decode plain version: S = 4, ragged kv_len, spans crossing block
    boundaries, hot (1e4) trash block, one trash row."""
    lens, s, bs = [1, 5, 8, 13, 1], 4, 4
    b, kvh, g, d = len(lens), 2, 3, 8
    rng = np.random.default_rng(7)
    tbl, nb = _span_tables(rng, lens, s, bs)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    kp = np.array(jnp.asarray(rng.standard_normal((nb, bs, kvh, d)), jdt))
    vp = np.array(jnp.asarray(rng.standard_normal((nb, bs, kvh, d)), jdt))
    kp[0] = 1e4
    vp[0] = 1e4
    q = np.array(jnp.asarray(rng.standard_normal((b, s, kvh, g, d)), jdt))
    kv_len = np.asarray(lens, np.int32)
    scale = d ** -0.5
    want = jgqa_verify(*(jnp.asarray(a) for a in (q, kp, vp, tbl, kv_len)),
                       scale=scale, interpret=True, **case)
    args = [to_torch(a, "cpu") for a in (q, kp, vp, tbl, kv_len)]
    got = paged_gqa_verify_plain(*args, scale=scale, **case)
    assert got.dtype == torch.float32 and got.shape == (b, s, kvh, g, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **ATTN_TOL[dtype])
    for i in range(s):
        one = paged_gqa_decode_plain(args[0][:, i], *args[1:4], args[4] + i,
                                     scale=scale, **case)
        np.testing.assert_allclose(got[:, i].numpy(), one.numpy(),
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_verify_plain_matches_reference_kernel(dtype):
    lens, s, bs = [1, 6, 8, 11, 1], 4, 4
    b, h, r, rd = len(lens), 3, 16, 8
    rng = np.random.default_rng(8)
    tbl, nb = _span_tables(rng, lens, s, bs)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cp = np.array(jnp.asarray(rng.standard_normal((nb, bs, r)), jdt))
    pp = np.array(jnp.asarray(rng.standard_normal((nb, bs, rd)), jdt))
    cp[0] = 1e4
    pp[0] = 1e4
    ql = rng.standard_normal((b, s, h, r)).astype(np.float32)
    qp = rng.standard_normal((b, s, h, rd)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    scale = (r + rd) ** -0.5
    want = jmla_verify(*(jnp.asarray(a) for a in (ql, qp, cp, pp, tbl,
                                                  kv_len)),
                       scale=scale, interpret=True)
    args = [to_torch(a, "cpu") for a in (ql, qp, cp, pp, tbl, kv_len)]
    got = paged_mla_verify_plain(*args, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **ATTN_TOL[dtype])
    for i in range(s):
        one = paged_mla_decode_plain(args[0][:, i], args[1][:, i], *args[2:5],
                                     args[5] + i, scale=scale)
        np.testing.assert_allclose(got[:, i].numpy(), one.numpy(),
                                   **ATTN_TOL[dtype])


# ------------------------------------------------------------ verify_step

def _seeded_pools(jc, params, s):
    """Pools seeded from a reference prefill of 2 rows x 9 tokens through a
    shuffled table; row 2 is idle (all-trash table).  Cached per config."""
    key = ("pools", jc.name, s)
    if key not in _CACHE:
        _CACHE[key] = _make_seeded_pools(jc, params, s)
    pools, tbl, pos, span = _CACHE[key]
    return {n: p.copy() for n, p in pools.items()}, tbl, pos, span


def _make_seeded_pools(jc, params, s):
    bs, seeded = 4, 9
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, seeded))
    _, cj = jax.jit(jprefill, static_argnums=(1,))(
        params, jc, {"tokens": jnp.asarray(toks, jnp.int32)})
    if "moe" in cj:
        cj = {n: np.concatenate([np.asarray(cj["dense"][n]),
                                 np.asarray(cj["moe"][n])]) for n in cj["moe"]}
    tbl = np.zeros((3, 4), np.int32)
    tbl[0] = [5, 1, 9, 3]
    tbl[1] = [2, 7, 4, 8]
    pools = {}
    for name, c in cj.items():                          # [L, B, S, ...]
        c = np.asarray(c)
        pool = np.zeros((c.shape[0], 10, bs) + c.shape[3:], c.dtype)
        for row in range(2):
            for p in range(seeded):
                pool[:, tbl[row, p // bs], p % bs] = c[:, row, p]
        pools[name] = pool
    # row 0 verifies at the end of its prompt, row 1 overwrites its last
    # two prompt positions (a span crossing into a new block in both)
    pos = np.array([seeded, seeded - 2, 0], np.int32)
    span = np.random.default_rng(3).integers(0, jc.vocab, (3, s)).astype(
        np.int32)
    span[2] = 0
    return pools, tbl, pos, span


@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
@pytest.mark.parametrize("attn", ["gather", "fused"])
def test_verify_step_matches_reference_and_sequential_decode(arch, attn):
    jc, params, tc, model = _pair(arch, compressed=True)
    s = 4
    pools, tbl, pos, span = _seeded_pools(jc, params, s)
    lj, jpool = _jverify_jit(params, jc, {n: jnp.asarray(p)
                                          for n, p in pools.items()},
                             jnp.asarray(span), jnp.asarray(pos),
                             jnp.asarray(tbl), attn_impl=attn)
    tpool = {n: torch.tensor(p) for n, p in pools.items()}
    lt, tpool = verify_step(model, tc, tpool, torch.tensor(span).long(),
                            torch.tensor(pos), torch.tensor(tbl),
                            attn_impl=attn)
    assert lt.shape == (3, s, tc.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], **TOL)
    np.testing.assert_array_equal(lt[:2].argmax(-1).numpy(),
                                  np.asarray(lj)[:2].argmax(-1))
    live = sorted(set(tbl[:2].ravel()) - {0})
    for name in pools:
        np.testing.assert_allclose(tpool[name][:, live].numpy(),
                                   np.asarray(jpool[name])[:, live], **TOL)
    # the same span as S one-token decode steps of the port
    seq = {n: torch.tensor(p) for n, p in pools.items()}
    for i in range(s):
        ld, seq = decode_step(model, tc, seq, torch.tensor(span[:, i]).long(),
                              torch.tensor(pos + i), torch.tensor(tbl),
                              attn_impl=attn)
        np.testing.assert_allclose(lt[:2, i].numpy(), ld[:2].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_verify_operands_are_dense_rows(monkeypatch):
    """The card's wrappers take only contiguous operands: pin the linears to
    the kernel wrappers and check every operand the xwt wrapper and the
    fused GQA verify read receive, as the C launchers would."""
    from repro_torch.core import sparse_matmul
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention
    seen = []

    def checked(fn):
        def inner(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (fn.__name__, tuple(a.shape))
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return inner
    monkeypatch.setattr(sparse_matmul.kops, "nm_xwt",
                        checked(sparse_matmul.kops.nm_xwt))
    monkeypatch.setattr(attention, "paged_gqa_verify",
                        checked(flash_attention.paged_gqa_verify))
    jc, params, tc, model = _pair(LLAMA, compressed=True)
    tc = tc.replace(sparsity=dataclasses.replace(tc.sparsity, impl="xwt"))
    pools, tbl, pos, span = _seeded_pools(jc, params, 4)
    verify_step(model, tc, {n: torch.tensor(p) for n, p in pools.items()},
                torch.tensor(span).long(), torch.tensor(pos),
                torch.tensor(tbl), attn_impl="fused")
    assert {"nm_xwt", "paged_gqa_verify"} <= set(seen)


def test_verify_step_needs_a_block_table():
    _, _, tc, model = _pair(LLAMA)
    with pytest.raises(ValueError, match="block_table"):
        verify_step(model, tc, {}, torch.zeros(1, 2).long(),
                    torch.zeros(1, dtype=torch.int32))


# ------------------------------------------------------------- make_draft

@pytest.mark.parametrize("arch,kind", [(LLAMA, "rerank"), (LLAMA, "skip"),
                                       (DEEPSEEK, "rerank"),
                                       (DEEPSEEK, "skip")])
def test_make_draft_views_match_reference(arch, kind):
    """Rerank: every compressed linear (expert stacks included) equals the
    reference's re-ranked leaf and the config has n = 1; skip: the kept
    blocks and cache_idx are the reference's.  Either way the embedding,
    norms and router are the target's own storage."""
    jc, params, tc, model = _pair(arch, compressed=True)
    jd, jdc, jidx = jmake_draft(params, jc, kind=kind)
    draft, dcfg, idx = make_draft(model, tc, kind=kind)
    assert dcfg.sparsity.n == jdc.sparsity.n
    assert dcfg.n_layers == jdc.n_layers
    assert draft.embed.emb.data_ptr() == model.embed.emb.data_ptr()
    assert draft.lnf.scale.data_ptr() == model.lnf.scale.data_ptr()
    if kind == "skip":
        np.testing.assert_array_equal(idx, jidx)
        kept = [model.blocks()[i] for i in idx]
        assert all(a is b for a, b in zip(draft.blocks(), kept))
    else:
        assert idx is None and jidx is None
        for li, blk in enumerate(draft.layers):
            ref = jd["layers"]
            lins = [("attn", n) for n in ("wq", "wo")]
            if arch == DEEPSEEK:
                lins += [("moe", n) for n in ("wg", "wu", "wd")]
                assert blk.moe.router.data_ptr() == \
                    model.layers[li].moe.router.data_ptr()
            else:
                lins += [("mlp", n) for n in ("wg", "wu", "wd")]
            for sub, name in lins:
                lin = getattr(getattr(blk, sub), name)
                np.testing.assert_array_equal(
                    lin.w_vals.numpy(), np.asarray(ref[sub][name]["w_vals"])[li])
                np.testing.assert_array_equal(
                    lin.w_idx.numpy(), np.asarray(ref[sub][name]["w_idx"])[li])
            assert blk.ln1.scale.data_ptr() == \
                model.layers[li].ln1.scale.data_ptr()
    assert weight_stream_bytes(draft, dcfg)["stream_bytes"] == \
        jstream(jd, jdc)["stream_bytes"] < \
        weight_stream_bytes(model, tc)["stream_bytes"]


@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_skip_draft_proposes_in_place_like_reference(arch):
    """k = 3 skip-draft steps from seeded pools: the drafts and the draft
    layers' pools equal the reference's ``draft_propose_k``; the draft
    writes the target's pool tensors in place (no copy of the pool) and
    leaves the skipped layers' pools untouched."""
    jc, params, tc, model = _pair(arch, compressed=True)
    k = 3
    pools, tbl, pos, span = _seeded_pools(jc, params, k)
    jd, jdc, jidx = jmake_draft(params, jc, kind="skip")
    jt, jpool = jax.jit(jpropose, static_argnums=(1,), static_argnames=(
        "k", "attn_impl", "cache_idx"))(
        jd, jdc, {n: jnp.asarray(p) for n, p in pools.items()},
        jnp.asarray(span[:, 0]), jnp.asarray(pos), jnp.asarray(tbl), k=k,
        attn_impl="fused", cache_idx=tuple(int(i) for i in jidx))
    draft, dcfg, idx = make_draft(model, tc, kind="skip")
    tpool = {n: torch.tensor(p) for n, p in pools.items()}
    ptrs = {n: t.data_ptr() for n, t in tpool.items()}
    toks, out = draft_propose_k(draft, dcfg, tpool,
                                torch.tensor(span[:, 0]).long(),
                                torch.tensor(pos), torch.tensor(tbl), k=k,
                                attn_impl="fused", cache_idx=idx)
    np.testing.assert_array_equal(toks[:2].numpy(), np.asarray(jt)[:2])
    skipped = sorted(set(range(tc.n_layers)) - set(idx.tolist()))
    live = sorted(set(tbl[:2].ravel()) - {0})
    for name in pools:
        assert out[name].data_ptr() == ptrs[name]
        got = out[name][idx][:, live].numpy()
        np.testing.assert_allclose(got, np.asarray(jpool[name])[idx][:, live],
                                   **TOL)
        np.testing.assert_array_equal(out[name][skipped].numpy(),
                                      pools[name][skipped])


def test_make_draft_rejects_bad_combinations():
    _, _, tc, model = _pair(LLAMA)
    with pytest.raises(ValueError, match="compressed"):
        make_draft(model, tc, kind="rerank")          # srste, not converted
    with pytest.raises(ValueError, match="stride"):
        make_draft(model, tc, kind="skip", stride=1)
    with pytest.raises(ValueError, match="kind"):
        make_draft(model, tc, kind="nope")
    with pytest.raises(ValueError, match="plain stacked"):
        make_draft(model, tc.replace(local_global_period=2), kind="skip")


# --------------------------------------------------------------- rollback

def test_rollback_churn_matches_reference_pool():
    """A seeded admit / speculative-span + rollback / retire churn through
    the port's pool and the reference's: tables, free heap and refcounts
    equal after every operation, and every span write window is backed and
    exclusive before its rollback."""
    jc, _, tc, _ = _pair(LLAMA)
    kw = dict(n_slots=2, max_len=16, block_size=4, n_blocks=9)
    jp, tp = JPool(jc, **kw), BlockPool(tc, device="cpu", **kw)
    rng = np.random.default_rng(11)
    pos, spans = {}, 0
    for _ in range(200):
        kind, slot, arg = (int(rng.integers(3)), int(rng.integers(2)),
                           int(rng.integers(16)))
        if kind == 0 and slot not in pos:             # admit
            n = arg % 8 + 1
            if tp.alloc(slot, tp.blocks_for(n)):
                assert jp.alloc(slot, jp.blocks_for(n))
                pos[slot] = n
        elif kind == 1 and slot in pos:               # span, then rollback
            end = min(pos[slot] + 3, tp.max_len)
            if tp.ensure(slot, end - 1):
                assert jp.ensure(slot, end - 1)
                tp.check_invariants(active_pos={slot: (pos[slot] - 1,
                                                       end - 1)})
                commit = pos[slot] + arg % (end - pos[slot] + 1)
                tp.rollback(slot, commit)
                jp.rollback(slot, commit)
                pos[slot] = max(commit, 1)
                spans += 1
        elif kind == 2 and slot in pos:               # retire
            tp.free(slot)
            jp.free(slot)
            del pos[slot]
        np.testing.assert_array_equal(tp.table, jp.table)
        np.testing.assert_array_equal(tp.ref, jp.ref)
        assert tp._free == jp._free
        tp.check_invariants(active_pos={s: n - 1 for s, n in pos.items()})
    assert spans > 20


def test_rollback_refuses_before_it_mutates():
    _, _, tc, _ = _pair(LLAMA)
    p = BlockPool(tc, 1, 16, 4, device="cpu")
    assert p.alloc(0, 4)
    table, free = p.table.copy(), list(p._free)
    p.ref[p._owned[0][2]] = 2          # a shared block inside the tail
    with pytest.raises(ValueError, match="refcount"):
        p.rollback(0, 4)
    np.testing.assert_array_equal(p.table, table)
    assert p._free == free and len(p._owned[0]) == 4
    p.ref[p._owned[0][2]] = 1
    p.rollback(0, 4)
    assert p._owned[0] == [1] and p.free_blocks == p.usable_blocks - 1
    p.check_invariants(active_pos={0: 3})


def test_check_invariants_covers_the_whole_span_window():
    """A span's read window must be backed to its last position, and every
    block it writes must be exclusively owned — not only the first."""
    _, _, tc, _ = _pair(LLAMA)
    p = BlockPool(tc, 2, 16, 4, device="cpu")
    assert p.alloc(0, 2) and p.alloc(1, 1)
    p.check_invariants(active_pos={0: (3, 7)})
    with pytest.raises(AssertionError, match="owns 2"):
        p.check_invariants(active_pos={0: (3, 8)})
    # slot 1 names slot 0's second block as well (consistent refcount 2)
    shared = p._owned[0][1]
    p.table[1, 1] = shared
    p._owned[1].append(shared)
    p.ref[shared] = 2
    p.check_invariants(active_pos={0: 3})
    with pytest.raises(AssertionError, match="refcount 2"):
        p.check_invariants(active_pos={0: (3, 6)})


# ----------------------------------------------------------------- engine

def test_engine_spec_validation():
    _, _, tc, model = _pair(LLAMA)
    with pytest.raises(ValueError, match="rerank"):
        ServeEngine(model, tc, n_slots=1, max_len=8, kv="paged",
                    device="cpu", spec=SpecConfig(draft="rerank"))
    eng = ServeEngine(model, tc, n_slots=1, max_len=8, kv="paged",
                      device="cpu", spec=SpecConfig(draft="skip"))
    assert eng.stats()["spec_proposed"] == 0.0


def test_verify_passes_are_the_engines_verify_calls(monkeypatch):
    """Each verify pass is one call of the engine's verify entry point
    (what the chip smoke counts: on the card one graph replay), and on the
    CPU one call of the engine module's ``verify_step``, with a [B, k+1]
    span."""
    calls = []
    orig = engine_mod.verify_step

    def counted(model, cfg, caches, span, *a, **k):
        calls.append(tuple(span.shape))
        return orig(model, cfg, caches, span, *a, **k)
    monkeypatch.setattr(engine_mod, "verify_step", counted)
    _, _, tc, model = _pair(LLAMA)
    eng = ServeEngine(model, tc, n_slots=2, max_len=24, kv="paged",
                      block_size=4, attn="fused", compressed=True,
                      spec=SpecConfig(k=2), device="cpu")
    eng.run(_ragged(tc, [5, 8], [6, 7], 1, synthetic_request))
    assert calls and set(calls) == {(2, 3)}
    assert eng.entries["verify"].calls == len(calls)
    st = eng.stats()
    assert len(calls) <= st["decode_steps"]
    assert 0 < st["draft_steps"] <= 2 * len(calls)


# -------------------------------------------------------------------- CLI

PAGED_CLI = ["--scheduler", "continuous", "--kv", "paged", "--attn", "fused"]


def test_cli_serves_with_spec_on_cpu(capsys):
    tlaunch.main(["--arch", LLAMA, "--smoke", "--device", "cpu", *PAGED_CLI,
                  "--slots", "2", "--requests", "3", "--prompt-len", "6",
                  "--gen-mix", "2,4", "--block-size", "4", "--spec"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out
    assert "speculative[rerank,k=3]: acceptance" in out
    tlaunch.main(["--arch", DEEPSEEK, "--smoke", "--device", "cpu",
                  *PAGED_CLI, "--slots", "2", "--requests", "2",
                  "--prompt-len", "6", "--gen", "5", "--block-size", "4",
                  "--spec", "--draft", "skip", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert "on cpu: 10 tokens" in out and "speculative[skip,k=2]" in out
    with pytest.raises(SystemExit, match="compressed"):
        tlaunch.main(["--arch", LLAMA, "--smoke", "--device", "cpu",
                      *PAGED_CLI, "--weights", "dense", "--spec"])
