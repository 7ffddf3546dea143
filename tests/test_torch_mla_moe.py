"""Port parity for the MoE family with MLA attention (deepseek-v2-lite-16b
smoke config, f32: 4 layers = 1 dense + 3 MoE, d 256, 4 heads, kv_lora 64,
8 experts top-2 + 2 shared), with the reference's jax.random weights
carried over through repro_torch.convert and inputs drawn with numpy.

Tolerances: 2e-4 for the paged MLA decode (the reference kernel's own
tolerance against its gather oracle), 1e-5 for one MoE layer and 1e-4 for
model logits (f32 sums in other orders over 4 layers).  Routing (expert ids
and capacity drops) must agree bitwise, ties included."""

import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels.flash_attention import paged_mla_decode as jmla  # noqa: E402
from repro.models import convert_to_compressed as jconvert  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_caches as jcaches  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import weight_stream_bytes as jstream  # noqa: E402
from repro.models.config import param_count as jparam  # noqa: E402
from repro.models.ffn import moe_apply as jmoe  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import synthetic_trace as jtrace  # noqa: E402
from repro.serve.cache import seed_decode_caches as jseed  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import from_reference_params, to_torch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    paged_mla_decode, paged_mla_decode_plain)
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import (MoELM, convert_to_compressed,  # noqa: E402
                                decode_step, init_caches, init_model,
                                param_count, prefill, weight_stream_bytes)
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.serve import (BlockPool, ServeEngine,  # noqa: E402
                               seed_decode_caches, synthetic_trace)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}
# the reference's entry points jitted once per config (eager dispatch of
# their scans costs seconds per call on the CPU)
_jdecode_jit = jax.jit(jdecode, static_argnums=(1,),
                       static_argnames=("attn_impl",))
_jmoe_jit = jax.jit(jmoe, static_argnums=(2,))


def _pair(compressed: bool):
    """(reference cfg, reference params, port cfg, port model), smoke size."""
    if compressed not in _CACHE:
        jc, tc = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
        params, _ = jinit(jax.random.PRNGKey(0), jc)
        if compressed:
            jc = jc.replace(sparsity=dataclasses.replace(
                jc.sparsity, mode="compressed"))
            tc = tc.replace(sparsity=dataclasses.replace(
                tc.sparsity, mode="compressed"))
            params = jconvert(params, jc)
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        _CACHE[compressed] = (jc, params, tc, model)
    return _CACHE[compressed]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------- paged MLA decode

def _owned_tables(rng, b, n_blocks, tw, lens, bs):
    tbl = np.zeros((b, tw), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for r, ln in enumerate(lens):
        for j in range(-(-ln // bs)):
            tbl[r, j] = free.pop()
    return tbl


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_decode_plain_matches_reference_kernel(bs, dtype):
    """The port's plain version (what the CUDA kernel is held against)
    against the reference Pallas kernel in interpret mode: ragged kv_len,
    shuffled table, hot (1e4) trash block."""
    lens = [1, 7, 8, 9, 16, 31, 33]
    b, h, r, rd = len(lens), 3, 32, 16
    tw = -(-max(lens) // bs)
    nb = b * tw + 1
    rng = np.random.default_rng(100 + bs)
    tbl = _owned_tables(rng, b, nb, tw, lens, bs)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cp = np.array(jnp.asarray(rng.standard_normal((nb, bs, r)), jdt))
    pp = np.array(jnp.asarray(rng.standard_normal((nb, bs, rd)), jdt))
    cp[0] = 1e4
    pp[0] = 1e4
    ql = rng.standard_normal((b, h, r)).astype(np.float32)
    qp = rng.standard_normal((b, h, rd)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    scale = (r + rd) ** -0.5
    want = jmla(jnp.asarray(ql), jnp.asarray(qp), jnp.asarray(cp),
                jnp.asarray(pp), jnp.asarray(tbl), jnp.asarray(kv_len),
                scale=scale, interpret=True)
    args = [to_torch(a, "cpu") for a in (ql, qp, cp, pp, tbl, kv_len)]
    got = paged_mla_decode_plain(*args, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, h, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        paged_mla_decode(*args, scale=scale).numpy(), got.numpy())


# --------------------------------------------------------------------- MoE

def _moe_case(kind):
    """(port MoE module, reference moe params, cfgs, x [B, S, d])."""
    jc, params, tc, model = _pair(False)
    p_ref = params["layers"]["moe"]
    p_ref = jax.tree.map(lambda a: a[0], p_ref)          # first MoE layer
    rng = np.random.default_rng(7)
    if kind == "padded":
        # a right-padded prompt: 12 real rows then 52 copies of one pad row,
        # which all route alike and overflow their experts' capacity
        x = rng.standard_normal((1, 64, jc.d_model)).astype(np.float32)
        x[0, 12:] = x[0, 11]
    else:
        x = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    if kind == "tied":
        # duplicate router rows: experts 1/5 and 2/6 get bitwise-equal
        # probabilities for every token, so top-k must break the ties
        w = np.asarray(p_ref["router"]["w"]).copy()
        w[5], w[6] = w[1], w[2]
        p_ref = dict(p_ref, router={"w": jnp.asarray(w)})
    moe = model.layers[0].moe
    port = tffn.MoE(to_torch(np.asarray(p_ref["router"]["w"]), "cpu"),
                    moe.wg, moe.wu, moe.wd, moe.shared)
    return port, p_ref, jc, tc, x


@pytest.mark.parametrize("kind", ["random", "tied", "padded"])
def test_moe_routing_bitwise_and_output_match_reference(kind):
    port, p_ref, jc, tc, x = _moe_case(kind)
    xt = x.reshape(-1, jc.d_model)
    # the reference's routing, step for step (moe_apply does not return it)
    probs = jax.nn.softmax(jnp.einsum("td,ed->te", jnp.asarray(xt),
                                      p_ref["router"]["w"]), axis=-1)
    _, jids = jax.lax.top_k(probs, jc.top_k)
    _, _, tids = tffn.moe_route(port.router, torch.tensor(xt), tc.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if kind == "tied":      # a tied pair really competed for a top-k place
        assert np.isin(np.asarray(jids), [1, 2]).any()
    yj, auxj = _jmoe_jit(p_ref, jnp.asarray(x), jc)
    yt, auxt = tffn.moe_apply(port, torch.tensor(x), tc)
    # a capacity drop that differs moves a row by O(0.1), far above 1e-5
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)


def test_moe_padded_prompt_drops_past_capacity():
    """The padded case really exercises dropping: some expert is assigned
    more rows than its capacity."""
    port, _, jc, tc, x = _moe_case("padded")
    t = x.shape[0] * x.shape[1]
    _, _, ids = tffn.moe_route(port.router, torch.tensor(x.reshape(t, -1)),
                               tc.top_k)
    cap = tffn._capacity(t, tc.n_experts, tc.top_k, tc.capacity_factor)
    assert int(torch.bincount(ids.reshape(-1)).max()) > cap


# ---------------------------------------------------------- model logits

@pytest.mark.parametrize("compressed", [False, True])
def test_prefill_logits_and_latent_caches_match(compressed):
    jc, params, tc, model = _pair(compressed)
    toks = _tokens(1, 2, 12, jc.vocab)
    lj, cj = jprefill(params, jc, {"tokens": jnp.asarray(toks)},
                      logit_pos=jnp.asarray(7))
    lt, ct = prefill(model, tc, {"tokens": torch.tensor(toks).long()},
                     logit_pos=7)
    assert lt.dtype == torch.float32 and lt.shape == (2, jc.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert set(ct) == {"dense", "moe"}
    for stack in ("dense", "moe"):
        for name in ("ckv", "kpe"):
            np.testing.assert_allclose(ct[stack][name].numpy(),
                                       np.asarray(cj[stack][name]), **TOL)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("attn", ["fused", "gather"])
def test_decode_steps_match(compressed, attn):
    """Three decode ticks over a shuffled paged latent table, ragged
    positions and one idle (trash-table) row: logits and pools agree."""
    jc, params, tc, model = _pair(compressed)
    bs, seeded = 4, 9
    toks = _tokens(2, 3, seeded, jc.vocab)
    _, cj = jprefill(params, jc, {"tokens": jnp.asarray(toks)})
    merged = {n: np.concatenate([np.asarray(cj["dense"][n]),
                                 np.asarray(cj["moe"][n])]) for n in cj["moe"]}
    tbl = np.zeros((3, 4), np.int32)
    tbl[0, :3] = [5, 1, 9]
    tbl[1, :3] = [2, 7, 4]                             # row 2 idle: all trash
    pools = {}
    for name, c in merged.items():                     # [L, B, S, r]
        pool = np.zeros((c.shape[0], 10, bs) + c.shape[3:], c.dtype)
        for b in range(2):
            for p in range(seeded):
                pool[:, tbl[b, p // bs], p % bs] = c[:, b, p]
        pools[name] = pool
    jpool = {k: jnp.asarray(v) for k, v in pools.items()}
    tpool = {k: torch.tensor(v) for k, v in pools.items()}
    pos = np.array([seeded, seeded - 2, 0], np.int32)
    tok = np.array([3, 77, 0], np.int32)
    for _ in range(3):
        lj, jpool = _jdecode_jit(params, jc, jpool, jnp.asarray(tok),
                                 jnp.asarray(pos), jnp.asarray(tbl),
                                 attn_impl=attn)
        lt, tpool = decode_step(model, tc, tpool, torch.tensor(tok).long(),
                                torch.tensor(pos), torch.tensor(tbl),
                                attn_impl=attn)
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], **TOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok[2] = 0
        np.testing.assert_array_equal(tok[:2], lt[:2].argmax(-1).numpy())
        pos[:2] += 1
    live = sorted(set(tbl[:2].ravel()) - {0})
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(tpool[name][:, live].numpy(),
                                   np.asarray(jpool[name])[:, live], **TOL)


def test_kernel_operands_are_dense_rows(monkeypatch):
    """The card's wrappers take only contiguous operands.  On the CPU, pin
    the linears to the kernel wrappers (xwt in prefill, spmv in decode) and
    check every operand each wrapper and the fused MLA read receive, as the
    C launchers would, through a prefill and a fused decode step."""
    from repro_torch.core import sparse_matmul
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention
    seen = []

    def checked(fn):
        def inner(*args, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (fn.__name__, tuple(a.shape),
                                               a.stride())
            seen.append(fn.__name__)
            return fn(*args, **kw)
        return inner
    for name in ("nm_spmv", "nm_xwt"):
        monkeypatch.setattr(sparse_matmul.kops, name,
                            checked(getattr(sparse_matmul.kops, name)))
    monkeypatch.setattr(attention, "paged_mla_decode",
                        checked(flash_attention.paged_mla_decode))
    _, _, tc, model = _pair(True)

    def pinned(impl):
        return tc.replace(sparsity=dataclasses.replace(tc.sparsity,
                                                       impl=impl))
    toks = torch.tensor(_tokens(4, 2, 8, tc.vocab)).long()
    pool = BlockPool(tc, 2, 12, 4, device="cpu")
    for slot in range(2):       # two slots: batch > 1 shows permuted views
        _, pf = prefill(model, pinned("xwt"), {"tokens": toks[slot:slot + 1]})
        pool.alloc(slot, 3)
        pool.seed(slot, pf, 8)
    decode_step(model, pinned("spmv"), pool.caches, toks[:, -1],
                torch.tensor([8, 8], dtype=torch.int32), pool.device_table(),
                attn_impl="fused")
    assert {"nm_xwt", "nm_spmv", "paged_mla_decode"} <= set(seen)


# ------------------------------------------------------ compressed weights

def test_convert_to_compressed_matches_reference_on_expert_stacks():
    jc, params, tc, model = _pair(False)
    jcc = jc.replace(sparsity=dataclasses.replace(jc.sparsity,
                                                  mode="compressed"))
    want = jconvert(params, jcc)
    got = convert_to_compressed(model, tc)
    ref = want["layers"]["moe"]
    assert ref["wg"]["w_vals"].ndim == 4                 # [L, E, out, nnz]
    for li, blk in enumerate(got.layers):
        for name in ("wg", "wu", "wd"):
            lin = getattr(blk.moe, name)
            assert lin.compressed and lin.w_vals.dim() == 3
            np.testing.assert_array_equal(lin.w_idx.numpy(),
                                          np.asarray(ref[name]["w_idx"])[li])
            np.testing.assert_array_equal(lin.w_vals.numpy(),
                                          np.asarray(ref[name]["w_vals"])[li])
        # the router stays a dense f32 tensor, shared with the original
        assert blk.moe.router is model.layers[li].moe.router
        assert blk.moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        got.layers[0].attn.wuk.w_vals.numpy(),
        np.asarray(want["layers"]["attn"]["wuk"]["w_vals"])[0])
    assert not model.layers[0].moe.wg.compressed      # original untouched
    ws, wj = weight_stream_bytes(got, tc), jstream(want, jcc)
    for key in ("dense_bytes", "stream_bytes", "ratio"):
        assert ws[key] == wj[key], key
    # the reference counts each stacked leaf once, the port once per layer:
    # 8 linears in the dense stack (5 MLA + 3 MLP), 11 per MoE layer
    # (5 MLA + 3 expert stacks + 3 shared)
    nd, nm = tc.first_dense_layers, tc.n_layers - tc.first_dense_layers
    assert wj["compressed_linears"] == 8 + 11
    assert ws["compressed_linears"] == 8 * nd + 11 * nm
    assert ws["dense_linears"] == wj["dense_linears"] == 0


def test_compressed_init_never_keeps_dense_experts():
    cfg = tget(ARCH, smoke=True)
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    model = init_model(cfg, seed=0, device="cpu")
    assert isinstance(model, MoELM)
    stacks = [m for blk in model.layers for m in (blk.moe.wg, blk.moe.wu,
                                                   blk.moe.wd)]
    assert all(s.compressed and s.w_vals.shape[0] == cfg.n_experts
               for s in stacks)
    assert convert_to_compressed(model, cfg).layers[0].moe.wg is stacks[0]


def test_param_count_matches_reference():
    for smoke in (False, True):
        jc, tc = jget(ARCH, smoke=smoke), tget(ARCH, smoke=smoke)
        for active in (False, True):
            assert param_count(tc, active_only=active) == \
                jparam(jc, active_only=active)
    tc = tget(ARCH, smoke=True)
    model = init_model(tc, seed=0, device="cpu")
    n = sum(t.numel() for t in model.buffers() if t.dtype.is_floating_point)
    n -= sum(p.scale.numel() for p in model.modules() if hasattr(p, "scale"))
    # the reference counts the (untied) LM head apart from the embedding;
    # both packages store one table
    assert n == param_count(tc) - tc.vocab * tc.d_model


# ------------------------------------------------------------------ serve

def test_seed_decode_caches_concatenates_dense_and_moe_stacks():
    jc, params, tc, model = _pair(False)
    toks = _tokens(3, 1, 6, jc.vocab)
    _, pfj = jprefill(params, jc, {"tokens": jnp.asarray(toks)})
    _, pft = prefill(model, tc, {"tokens": torch.tensor(toks).long()})
    jz, _ = jcaches(jc, 1, 8)
    want = jseed(jc, jz, pfj, src_len=5)
    got = seed_decode_caches(tc, init_caches(tc, 1, 8, device="cpu"), pft,
                             src_len=5)
    for name in ("ckv", "kpe"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **TOL)


def test_block_pool_takes_the_latent_leaves():
    cfg = tget(ARCH, smoke=True)
    p = BlockPool(cfg, n_slots=2, max_len=8, block_size=4, device="cpu")
    assert set(p.caches) == {"ckv", "kpe"}
    assert p.caches["ckv"].shape == (cfg.n_layers, 5, 4, cfg.kv_lora)
    assert p.caches["kpe"].shape == (cfg.n_layers, 5, 4, cfg.qk_rope_dim)
    assert p.bytes_per_block == cfg.n_layers * 4 * (
        cfg.kv_lora + cfg.qk_rope_dim) * 4


class _MarginProbe:
    """Logs the top-2 logit margin of every emitted argmax of the port, so
    a token mismatch can be reported with its margin."""

    def __init__(self):
        self.margins = []

    def wrap(self, fn):
        def inner(*a, **k):
            out = fn(*a, **k)
            top = torch.topk(out[0].float(), 2, dim=-1).values
            self.margins.append((top[:, 0] - top[:, 1]).min().item())
            return out
        return inner


def test_engine_token_streams_equal_reference(monkeypatch):
    """Bucketed-down prefill with forced-decode catch-up, a pad-up prompt,
    ragged generation and a replay preemption, through the fused MLA read
    and the compressed weights."""
    jc, params, tc, model = _pair(False)
    kw = dict(n_slots=3, max_len=24, compressed=True, kv="paged",
              block_size=4, n_blocks=8, attn="fused")
    args = dict(n_requests=5, prompt_len=7, gen_lens=[5, 9, 3], seed=3)
    jreqs, treqs = jtrace(jc, **args), synthetic_trace(tc, **args)
    jeng = JEngine(params, jc, **kw)
    jres = jeng.run(jreqs)
    probe = _MarginProbe()
    from repro_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "prefill", probe.wrap(prefill))
    monkeypatch.setattr(engine_mod, "decode_step", probe.wrap(decode_step))
    teng = ServeEngine(model, tc, debug_invariants=True, device="cpu", **kw)
    tres = teng.run(treqs)
    assert jeng.preemptions > 0, "trace no longer forces a preemption"
    for r in jreqs:
        want, got = jres[r.rid].tokens, tres[r.rid].tokens
        if not np.array_equal(want, got):
            i = int(np.argmax(want[:len(got)] != got[:len(want)]))
            pytest.fail(f"rid {r.rid}: token {i} flipped ({want[i]} vs "
                        f"{got[i]}); smallest top-2 logit margin seen by the "
                        f"port: {min(probe.margins):.3e}")
    js, ts = jeng.stats(), teng.stats()
    for key in ("decode_steps", "prefill_calls", "preemptions", "tokens",
                "ticks", "weight_stream_ratio", "weight_stream_bytes"):
        assert ts[key] == js[key], key
    assert teng.pool.free_blocks == teng.pool.usable_blocks


def test_cli_serves_deepseek_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--slots", "2", "--requests", "3", "--prompt-len", "6",
                  "--gen-mix", "2,4", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "continuous[compressed,paged,fused] on cpu: 8 tokens" in out


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch, and chip_smoke.py, import in a fresh
    interpreter without pulling in jax or the reference package.  The child
    gets no PYTHONPATH: src/sitecustomize.py (the reference's jax shims)
    would otherwise run at its start-up."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{os.path.join(root, 'src')!r}, {root!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
