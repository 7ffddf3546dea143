"""Card-only: each CUDA kernel of the port against its plain version, on
the device, in float32 and bfloat16, plus the fused engine against the
gather oracle.  Marked ``cuda``; each test skips (with a reason) where
torch sees no card.  Run on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the reference's 1e-4 (f32) / 2e-2 (bf16) for the matmuls and
2e-4 for attention; bf16 outputs may differ by one rounding step of the
output, which 2e-2 of values of magnitude ~1 covers.  TF32 is switched off
so the f32 plain products are full precision."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-4)


def _compressed(o, k, n, m, dtype, seed):
    """Weights scaled by k^-0.5 as ``linear_init`` draws them, so outputs
    are O(1) like the model's and an f32 sum over K terms carries absolute
    rounding noise well under 1e-4."""
    from repro_torch.core.sparsity import compress
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(o, k, generator=g, device="cuda") * k ** -0.5).to(dtype)
    return compress(w, n, m), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (1, 2), (2, 8)])
@pytest.mark.parametrize("b,o,k", [(1, 512, 2048), (8, 2048, 2048),
                                   (5, 200, 1032), (12, 96, 8192)])
def test_nm_spmv_kernel_matches_plain(dtype, nm, b, o, k):
    from repro_torch.kernels import nm_spmv as mod
    n, m = nm
    sp, g = _compressed(o, k, n, m, dtype, seed=b + o)
    x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
    before = mod.KERNEL.launches
    y = mod.nm_spmv(x, sp.values, sp.indices, n, m)
    torch.cuda.synchronize()
    assert mod.KERNEL.launches == before + 1
    want = mod.nm_spmv_plain(x, sp.values, sp.indices, n, m)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k", [(3, 1028), (9, 2052)])
def test_nm_spmv_kernel_unaligned_k_matches_plain(dtype, b, k):
    """K not a multiple of the 16-byte run: the x stage falls back to
    scalar copies (and x offset by one row is still 4-byte aligned)."""
    from repro_torch.kernels import nm_spmv as mod
    sp, g = _compressed(72, k, 2, 4, dtype, seed=k)
    x = torch.randn(b + 1, k, generator=g, device="cuda").to(dtype)[1:]
    y = mod.nm_spmv(x, sp.values, sp.indices, 2, 4)
    want = mod.nm_spmv_plain(x, sp.values, sp.indices, 2, 4)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (2, 8)])
@pytest.mark.parametrize("s,o,k", [(4, 2048, 2048), (128, 512, 2048),
                                   (37, 200, 136), (16, 2048, 8192)])
def test_nm_xwt_kernel_matches_plain(dtype, nm, s, o, k):
    from repro_torch.kernels import nm_spmm as mod
    n, m = nm
    sp, g = _compressed(o, k, n, m, dtype, seed=s + o)
    x = torch.randn(s, k, generator=g, device="cuda").to(dtype)
    before = mod.KERNEL.launches
    y = mod.nm_xwt(x, sp.values, sp.indices, n, m)
    torch.cuda.synchronize()
    assert mod.KERNEL.launches == before + 1
    want = mod.nm_xwt_plain(x, sp.values, sp.indices, n, m)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,k", [(5, 132), (70, 1028)])
def test_nm_xwt_kernel_unaligned_k_matches_plain(dtype, s, k):
    """K not a multiple of 8: scalar X-tile loads and the per-block
    decompress (no 8-slot runs)."""
    from repro_torch.kernels import nm_spmm as mod
    sp, g = _compressed(72, k, 2, 4, dtype, seed=k)
    x = torch.randn(s + 1, k, generator=g, device="cuda").to(dtype)[1:]
    y = mod.nm_xwt(x, sp.values, sp.indices, 2, 4)
    want = mod.nm_xwt_plain(x, sp.values, sp.indices, 2, 4)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("case", [dict(), dict(window=6), dict(cap=20.0),
                                  dict(window=9, cap=20.0)])
def test_paged_gqa_decode_kernel_matches_plain(dtype, bs, case):
    from repro_torch.kernels import flash_attention as mod
    lens = [1, 7, 8, 9, 16, 31, 32, 150]
    b, kvh, g, d = len(lens), 8, 4, 64
    tw = -(-max(lens) // bs)
    nb = b * tw + 1
    gen = torch.Generator(device="cuda").manual_seed(bs)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(b, tw, dtype=torch.int32, device="cuda")
    for r, ln in enumerate(lens):
        own = -(-ln // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = mod.KERNEL.launches
    out = mod.paged_gqa_decode(q, kp, vp, tbl, kv_len, scale=d ** -0.5, **case)
    torch.cuda.synchronize()
    assert mod.KERNEL.launches == before + 1
    want = mod.paged_gqa_decode_plain(q, kp, vp, tbl, kv_len,
                                      scale=d ** -0.5, **case)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_fused_engine_matches_gather_oracle_on_the_card():
    """Smoke-size f32 engine on the card: the kernel route (spmv, xwt,
    fused attention) emits the same tokens as the impl='ref' + gather
    oracle route, and every kernel was launched."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    cfg = get_config("llama3.2-1b", smoke=True)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=5, prompt_len=9,
                           gen_lens=[4, 7], seed=1)
    kw = dict(n_slots=2, max_len=16, compressed=True, block_size=4,
              n_blocks=7, device="cuda")
    kernels.reset_launch_counts()
    fused = ServeEngine(model, cfg, attn="fused", debug_invariants=True,
                        **kw)
    got = fused.run(reqs)
    assert all(k.launches > 0 for k in kernels.all_kernels())
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    want = ServeEngine(model, ref_cfg, attn="gather", **kw).run(reqs)
    assert fused.preemptions > 0
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)
