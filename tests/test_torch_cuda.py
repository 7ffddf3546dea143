"""Card-only: each CUDA kernel of the port against its plain version, on
the device, in float32 and bfloat16 (the verify kernels also against
decode launches, bit for bit), plus the fused engines (llama GQA,
deepseek MLA + MoE) against the gather oracle, the speculative engines
against the plain ones, and the graphed engines (paged and slotted) and
the graphed sequential oracle against their eager runs, and the bf16 LM
head's hand-written backward against f32 autograd.  Marked ``cuda``; each test
skips (with a reason) where torch sees no card.  Run on the card with

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


@pytest.mark.parametrize("b,o,k", [(8, 768, 3072)])
def test_nm_spmv_kernel_at_the_default_shared_memory_edge(b, o, k):
    """whisper-small's wd at B 8, bf16: the gather plan's x slice is 48 KB
    exactly (8 rows x 3072 x 2 B), which with the kernel's static
    reduction scratch passes the 48 KB a launch may take without opting
    in (the launcher used to opt in only above 48 KB of dynamic memory,
    and the launch failed with an invalid argument)."""
    from repro_torch.kernels import nm_spmv as mod
    plan = mod.gather_plan(b, o, k, 2, 4, 2)
    assert plan.smem(2) == 48 * 1024
    sp, g = _compressed(o, k, 2, 4, torch.bfloat16, seed=o)
    x = torch.randn(b, k, generator=g, device="cuda").to(torch.bfloat16)
    y = mod.nm_spmv(x, sp.values, sp.indices, 2, 4)
    torch.cuda.synchronize()
    want = mod.nm_spmv_plain(x, sp.values, sp.indices, 2, 4)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


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


# (O, K) of the deepseek-v2-lite linears the decode and prefill paths run:
# wq, wdkv, wuk/wuv (K = kv_lora 512), wo, the shared experts (2 x 1408),
# and the dense first layer's MLP (d_ff 10944)
DEEPSEEK_SHAPES = [(3072, 2048), (576, 2048), (2048, 512), (2048, 2048),
                   (2816, 2048), (2048, 2816), (10944, 2048), (2048, 10944)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o,k", DEEPSEEK_SHAPES)
def test_nm_kernels_match_plain_at_deepseek_shapes(dtype, o, k):
    from repro_torch.kernels import nm_spmm, nm_spmv
    sp, g = _compressed(o, k, 2, 4, dtype, seed=o + k)
    for b in (1, 8):
        x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
        y = nm_spmv.nm_spmv(x, sp.values, sp.indices, 2, 4)
        want = nm_spmv.nm_spmv_plain(x, sp.values, sp.indices, 2, 4)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(dtype))
    for s in (5, 128):
        x = torch.randn(s, k, generator=g, device="cuda").to(dtype)
        y = nm_spmm.nm_xwt(x, sp.values, sp.indices, 2, 4)
        want = nm_spmm.nm_xwt_plain(x, sp.values, sp.indices, 2, 4)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **_tol(dtype))


def _paged_table(gen, lens, bs):
    """A shuffled block table: each slot owns ceil(len / bs) distinct blocks
    >= 1, the rest of its row names trash block 0."""
    b, tw = len(lens), -(-max(lens) // bs)
    nb = b * tw + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tbl = torch.zeros(b, tw, dtype=torch.int32, device="cuda")
    for r, ln in enumerate(lens):
        own = -(-ln // bs)
        tbl[r, :own] = perm[r * tw:r * tw + own]
    return tbl, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h,r,rd", [(16, 16, 512, 64), (8, 3, 32, 16),
                                       (32, 4, 512, 64), (4, 2, 36, 10)])
def test_paged_mla_decode_kernel_matches_plain(dtype, bs, h, r, rd):
    """Full deepseek width (16 heads, kv_lora 512, rope 64, block 16), a
    small odd shape, block 32 (over 48 KB of shared memory), and widths
    that are not whole 16-byte runs (element-load staging): ragged kv_len,
    shuffled table, hot (1e4) trash block."""
    from repro_torch.kernels import flash_attention as mod
    lens = [1, 7, 8, 9, 16, 31, 33, 150]
    gen = torch.Generator(device="cuda").manual_seed(bs + h)
    tbl, nb = _paged_table(gen, lens, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4
    pp[0] = 1e4
    ql = torch.randn(len(lens), h, r, generator=gen, device="cuda")
    qp = torch.randn(len(lens), h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = (r + rd) ** -0.5
    before = mod.MLA_KERNEL.launches
    out = mod.paged_mla_decode(ql, qp, cp, pp, tbl, kv_len, scale=scale)
    torch.cuda.synchronize()
    assert mod.MLA_KERNEL.launches == before + 1
    want = mod.paged_mla_decode_plain(ql, qp, cp, pp, tbl, kv_len, scale=scale)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


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


def _span_table(gen, lens, s, bs):
    """Slot r owns ceil((lens[r] + s - 1) / bs) shuffled blocks (its whole
    verify span); the rest of its row names trash block 0."""
    return _paged_table(gen, [ln + s - 1 for ln in lens], bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("s", [1, 4, 7])
@pytest.mark.parametrize("case", [dict(), dict(window=9, cap=20.0)])
def test_paged_gqa_verify_kernel_matches_plain_and_decode(dtype, bs, s, case):
    """Llama width (KVH 8, G 4, d 64); S 7 splits the span rows over two
    CTAs.  Against the plain version (2e-4), and offset i against a decode
    launch at kv_len + i bit for bit (decode is the same kernel at S = 1,
    and a row's operations do not depend on the other rows)."""
    from repro_torch.kernels import flash_attention as mod
    lens = [1, 7, 8, 9, 16, 31, 32, 150]
    b, kvh, g, d = len(lens), 8, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(bs + s)
    tbl, nb = _span_table(gen, lens, s, bs)
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    q = torch.randn(b, s, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = mod.GQA_VERIFY_KERNEL.launches
    out = mod.paged_gqa_verify(q, kp, vp, tbl, kv_len, scale=d ** -0.5,
                               **case)
    torch.cuda.synchronize()
    assert mod.GQA_VERIFY_KERNEL.launches == before + 1
    want = mod.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len,
                                      scale=d ** -0.5, **case)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(s):
        one = mod.paged_gqa_decode(q[:, i].contiguous(), kp, vp, tbl,
                                   kv_len + i, scale=d ** -0.5, **case)
        assert torch.equal(out[:, i], one), f"offset {i}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h,r,rd", [(16, 16, 512, 64), (8, 3, 32, 16),
                                       (4, 2, 36, 10)])
@pytest.mark.parametrize("s", [1, 4, 6])
def test_paged_mla_verify_kernel_matches_plain_and_decode(dtype, bs, h, r, rd,
                                                          s):
    """Deepseek width and small odd shapes (element-load staging); S 6
    splits the span over two CTAs per head.  Against the plain version and,
    bit for bit, against decode launches at kv_len + i (the kernel's
    one-row instance)."""
    from repro_torch.kernels import flash_attention as mod
    lens = [1, 7, 8, 9, 16, 31, 33, 150]
    gen = torch.Generator(device="cuda").manual_seed(bs + h + s)
    tbl, nb = _span_table(gen, lens, s, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4
    pp[0] = 1e4
    ql = torch.randn(len(lens), s, h, r, generator=gen, device="cuda")
    qp = torch.randn(len(lens), s, h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = (r + rd) ** -0.5
    before = mod.MLA_VERIFY_KERNEL.launches
    out = mod.paged_mla_verify(ql, qp, cp, pp, tbl, kv_len, scale=scale)
    torch.cuda.synchronize()
    assert mod.MLA_VERIFY_KERNEL.launches == before + 1
    want = mod.paged_mla_verify_plain(ql, qp, cp, pp, tbl, kv_len,
                                      scale=scale)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(s):
        one = mod.paged_mla_decode(ql[:, i].contiguous(),
                                   qp[:, i].contiguous(), cp, pp, tbl,
                                   kv_len + i, scale=scale)
        assert torch.equal(out[:, i], one), f"offset {i}"


# the edges of the chunked tensor-core bodies (chunks of 64 positions):
# views ending at 15 / 16 / 17 and 63 / 64 / 65 positions, a long context
# (several chunks, the cross-CTA fold), a row of trash blocks only, and the
# span crossing a chunk boundary
EDGE_LENS = [15, 16, 17, 1, 2100, 1000, 63, 65]
TRASH_ROW = 3


def _edge_table(gen, s, bs):
    tbl, nb = _span_table(gen, EDGE_LENS, s, bs)
    tbl[TRASH_ROW] = 0
    return tbl, nb


def _against_decode_and_twice(out, launch, decode, s):
    """A second launch gives the same bits, and offset i equals the decode
    launch at kv_len + i bit for bit."""
    assert torch.equal(launch(), out), "a second launch changed the bits"
    for i in range(s):
        assert torch.equal(out[:, i], decode(i)), f"offset {i}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 2, 4, 5, 7])
@pytest.mark.parametrize("case", [dict(), dict(window=20, cap=30.0)])
def test_paged_gqa_kernel_edges(dtype, bs, s, case):
    """Llama width at the chunk edges and a long context; the window (20)
    is shorter than a chunk, so a long row skips all but its last chunks.
    Within 2e-4 of the plain version, the same bits twice, and offset i
    bit-equal to decode at kv_len + i."""
    from repro_torch.kernels import flash_attention as mod
    b, kvh, g, d = len(EDGE_LENS), 8, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(100 + bs + s)
    tbl, nb = _edge_table(gen, s, bs)
    kp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    q = torch.randn(b, s, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(EDGE_LENS, dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, **case)

    def launch():
        return mod.paged_gqa_verify(q, kp, vp, tbl, kv_len, **kw)
    out = launch()
    want = mod.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    _against_decode_and_twice(out, launch, lambda i: mod.paged_gqa_decode(
        q[:, i].contiguous(), kp, vp, tbl, kv_len + i, **kw), s)


# gemma2-9b's serving rows: two past the window (4096), one at it, short
# ones, and a row of trash blocks only
GEMMA2_LENS = [4160, 4100, 4096, 1, 17, 700, 2, 64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4])
def test_paged_gqa_kernel_at_gemma2_width(dtype, s):
    """gemma2-9b's decode (S 1) and verify (S 4) attention: KVH 8, G 2,
    d = dv = 256, block 16, window 4096, softcap 50 (bf16 takes the
    tensor-core body, ~74-99 KB of shared memory a CTA).  Within 2e-4 of
    the plain version, the same bits twice, and offset i bit-equal to
    decode at kv_len + i."""
    from repro_torch.kernels import flash_attention as mod
    b, kvh, g, d = len(GEMMA2_LENS), 8, 2, 256
    gen = torch.Generator(device="cuda").manual_seed(300 + s)
    tbl, nb = _span_table(gen, GEMMA2_LENS, s, 16)
    tbl[3] = 0
    kp = torch.randn(nb, 16, kvh, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, 16, kvh, d, generator=gen, device="cuda").to(dtype)
    kp[0] = 1e4
    vp[0] = 1e4
    q = torch.randn(b, s, kvh, g, d, generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(GEMMA2_LENS, dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, window=4096, cap=50.0)
    assert mod.gqa_plan(b, s, kvh, g, d, d, 16, tbl.shape[1], dtype).body \
        == ("tc" if dtype == torch.bfloat16 else "first")

    def launch():
        return mod.paged_gqa_verify(q, kp, vp, tbl, kv_len, **kw)
    out = launch()
    want = mod.paged_gqa_verify_plain(q, kp, vp, tbl, kv_len, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    _against_decode_and_twice(out, launch, lambda i: mod.paged_gqa_decode(
        q[:, i].contiguous(), kp, vp, tbl, kv_len + i, **kw), s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 2, 4, 5, 7])
@pytest.mark.parametrize("h,r,rd", [(16, 512, 64), (3, 32, 16)])
def test_paged_mla_kernel_edges(dtype, bs, s, h, r, rd):
    """Deepseek width and a narrow odd shape (3 heads of a 16-row tile) at
    the chunk edges and a long context.  Within 2e-4 of the plain version,
    the same bits twice, and offset i bit-equal to decode at kv_len + i."""
    from repro_torch.kernels import flash_attention as mod
    b = len(EDGE_LENS)
    gen = torch.Generator(device="cuda").manual_seed(200 + bs + s + h)
    tbl, nb = _edge_table(gen, s, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4
    pp[0] = 1e4
    ql = torch.randn(b, s, h, r, generator=gen, device="cuda")
    qp = torch.randn(b, s, h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(EDGE_LENS, dtype=torch.int32, device="cuda")
    scale = (r + rd) ** -0.5

    def launch():
        return mod.paged_mla_verify(ql, qp, cp, pp, tbl, kv_len, scale=scale)
    out = launch()
    want = mod.paged_mla_verify_plain(ql, qp, cp, pp, tbl, kv_len,
                                      scale=scale)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    _against_decode_and_twice(out, launch, lambda i: mod.paged_mla_decode(
        ql[:, i].contiguous(), qp[:, i].contiguous(), cp, pp, tbl,
        kv_len + i, scale=scale), s)


@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_paged_bodies_follow_the_plan(family):
    """bf16 at the models' widths takes the tensor-core body and f32 the
    first one: a launch of either agrees with the plain version, so the
    rule the CPU plan tests check is the one the card runs."""
    from repro_torch.kernels import flash_attention as mod
    gen = torch.Generator(device="cuda").manual_seed(7)
    lens = [5, 70]
    tbl, nb = _paged_table(gen, lens, 16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dtype, body in ((torch.bfloat16, "tc"), (torch.float32, "first")):
        if family == "gqa":
            assert mod.gqa_plan(2, 1, 8, 4, 64, 64, 16, tbl.shape[1],
                                dtype).body == body
            kp = torch.randn(nb, 16, 8, 64, generator=gen,
                             device="cuda").to(dtype)
            q = torch.randn(2, 8, 4, 64, generator=gen,
                            device="cuda").to(dtype)
            args = (q, kp, kp.flip(0).contiguous(), tbl, kv_len)
            got = mod.paged_gqa_decode(*args, scale=0.125)
            want = mod.paged_gqa_decode_plain(*args, scale=0.125)
        else:
            assert mod.mla_plan(2, 1, 16, 512, 64, 16, tbl.shape[1],
                                dtype).body == body
            cp = torch.randn(nb, 16, 512, generator=gen,
                             device="cuda").to(dtype)
            pp = torch.randn(nb, 16, 64, generator=gen,
                             device="cuda").to(dtype)
            ql = torch.randn(2, 16, 512, generator=gen, device="cuda")
            qp = torch.randn(2, 16, 64, generator=gen, device="cuda")
            args = (ql, qp, cp, pp, tbl, kv_len)
            got = mod.paged_mla_decode(*args, scale=0.05)
            want = mod.paged_mla_decode_plain(*args, scale=0.05)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_span_write_duplicate_cells_take_the_last_writer_on_the_card():
    """Masked rows all write the trash block; on the card the cell takes
    its last writer's value in (row, offset) order on every call (the
    deepseek-v2-lite verify shape, bf16)."""
    from repro_torch.models.attention import _paged_write_span
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, bs, width = 8, 4, 16, 576
    pool = torch.zeros(5, bs, width, dtype=torch.bfloat16, device="cuda")
    tbl = torch.zeros(b, 2, dtype=torch.int32, device="cuda")
    tbl[0, 0], tbl[0, 1], tbl[1, 0], tbl[1, 1] = 1, 2, 3, 4
    pos = torch.tensor([5, 20] + [0] * (b - 2), dtype=torch.int32,
                       device="cuda")
    upd = torch.randn(b, s, width, generator=gen, device="cuda").to(
        torch.bfloat16)
    want = _paged_write_span({"ckv": pool.cpu()}, {"ckv": upd.cpu()},
                             tbl.cpu(), pos.cpu())["ckv"]
    assert torch.equal(want[0, :s], upd[-1].cpu())
    for _ in range(50):
        got = _paged_write_span({"ckv": pool.clone()}, {"ckv": upd}, tbl,
                                pos)["ckv"]
        assert torch.equal(got.cpu(), want)


def _engine_vs_oracle(arch, attn_kernel, prompt_len=9, max_len=16,
                     n_blocks=7):
    """Smoke-size f32 engine on the card: the kernel route (spmv, xwt and
    the fused attention kernel of the family) emits the same tokens as the
    impl='ref' + gather oracle route, under a replay preemption, and each
    kernel of the path was launched."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, nm_spmm, nm_spmv
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=5, prompt_len=prompt_len,
                           gen_lens=[4, 7], seed=1)
    kw = dict(n_slots=2, max_len=max_len, compressed=True, kv="paged",
              block_size=4, n_blocks=n_blocks, device="cuda")
    kernels.reset_launch_counts()
    fused = ServeEngine(model, cfg, attn="fused", debug_invariants=True,
                        **kw)
    got = fused.run(reqs)
    path = (nm_spmv.KERNEL, nm_spmm.KERNEL,
            getattr(flash_attention, attn_kernel))
    assert all(k.launches > 0 for k in path), [k.launches for k in path]
    ref_cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                       impl="ref"))
    want = ServeEngine(model, ref_cfg, attn="gather", **kw).run(reqs)
    assert fused.preemptions > 0
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)


def test_fused_engine_matches_gather_oracle_on_the_card():
    _engine_vs_oracle("llama3.2-1b", "KERNEL")


def test_fused_mla_moe_engine_matches_gather_oracle_on_the_card():
    _engine_vs_oracle("deepseek-v2-lite-16b", "MLA_KERNEL")


def test_fused_gemma2_engine_matches_gather_oracle_on_the_card():
    """Prompts of 36 past the smoke window (32): the local layers' window
    and the softcap inside the kernel."""
    _engine_vs_oracle("gemma2-9b", "KERNEL", prompt_len=36, max_len=48,
                      n_blocks=20)


@pytest.mark.parametrize("arch,draft,attn_kernel", [
    ("llama3.2-1b", "rerank", "GQA_VERIFY_KERNEL"),
    ("deepseek-v2-lite-16b", "skip", "MLA_VERIFY_KERNEL")])
def test_spec_engine_matches_plain_engine_on_the_card(arch, draft,
                                                      attn_kernel):
    """Smoke-size f32 speculative engine on the card (2 slots, k 3, prompt
    catch-up through the span): the same tokens as the plain fused engine,
    through the family's verify kernel."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, SpecConfig, synthetic_trace
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=11,
                           gen_lens=[6, 9], seed=2)
    kw = dict(n_slots=2, max_len=24, compressed=True, kv="paged",
              block_size=4, attn="fused", device="cuda")
    want = ServeEngine(model, cfg, **kw).run(reqs)
    kernels.reset_launch_counts()
    eng = ServeEngine(model, cfg, spec=SpecConfig(k=3, draft=draft),
                      debug_invariants=True, **kw)
    got = eng.run(reqs)
    assert getattr(flash_attention, attn_kernel).launches > 0
    assert eng.stats()["spec_steps_saved"] > 0
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)


# --------------------------------------------- CUDA-graphed entry points

@pytest.mark.parametrize("arch,draft", [("llama3.2-1b", None),
                                        ("deepseek-v2-lite-16b", None),
                                        ("llama3.2-1b", "rerank"),
                                        ("deepseek-v2-lite-16b", "skip")])
def test_graphed_engine_equals_eager_engine(arch, draft):
    """Smoke-size f32 engine on the card, prewarmed and strict: every entry
    point replays its graph, and the tokens, the counters and the launch
    count of every kernel (replays adding what each graph captured) equal
    the eager engine's on the same trace."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, SpecConfig, synthetic_trace
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=5, prompt_len=9,
                           gen_lens=[4, 7], seed=1)
    kw = dict(n_slots=2, max_len=24, compressed=True, kv="paged",
              block_size=4, attn="fused", device="cuda", prewarm=True,
              strict_prewarm=True,
              spec=draft and SpecConfig(k=3, draft=draft))
    runs = {}
    for graphs in (False, True):
        eng = ServeEngine(model, cfg, graphs=graphs, **kw)
        kernels.reset_launch_counts()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        assert eng.graphs is graphs
        runs[graphs] = (res, eng.stats(),
                        {k.name: k.launches for k in kernels.all_kernels()})
    (want, ws, wl), (got, gs, gl) = runs[False], runs[True]
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)
    for key in ("tokens", "decode_steps", "prefill_calls", "preemptions"):
        assert gs[key] == ws[key], key
    assert gl == wl and gl["nm_spmv"] > 0 and gl["nm_xwt"] > 0
    assert gs["mid_serve_compiles"] == 0
    assert gs["prewarmed_executables"] == gs["executables_expected"]


def test_graphed_prefix_suspend_engine_equals_eager_engine():
    """Smoke-size f32 llama at 2 layers on the card, prewarmed and strict,
    with ``prefix_cache=True`` and ``preempt="suspend"`` on a tight pool:
    hits copy on write and preemptions swap to host between graph
    replays; tokens and counters equal the eager engine's, and the pool
    tensors the graphs captured never moved."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, shared_prefix_trace
    cfg = get_config("llama3.2-1b", smoke=True).replace(n_layers=2)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = shared_prefix_trace(cfg, n_requests=8, prefix_len=6, suffix_len=2,
                               gen_lens=[3, 5], seed=1, n_prefixes=2)
    kw = dict(n_slots=3, max_len=16, kv="paged", n_blocks=7, block_size=4,
              prefill_buckets=(4, 8), compressed=True, attn="fused",
              prefix_cache=True, preempt="suspend", debug_invariants=True,
              device="cuda", prewarm=True, strict_prewarm=True)
    runs = {}
    for graphs in (False, True):
        eng = ServeEngine(model, cfg, graphs=graphs, **kw)
        ptrs = [t.data_ptr() for t in eng.pool.caches.values()]
        res = eng.run(reqs)
        torch.cuda.synchronize()
        eng.check_invariants()
        assert [t.data_ptr() for t in eng.pool.caches.values()] == ptrs
        runs[graphs] = (res, eng.stats())
    (want, ws), (got, gs) = runs[False], runs[True]
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)
    for key in ("tokens", "ticks", "decode_steps", "prefill_calls",
                "preemptions", "prefix_hits", "prefix_hit_tokens",
                "cow_copies", "swap_outs", "swap_ins", "index_evictions"):
        assert gs[key] == ws[key], key
    assert gs["cow_copies"] > 0 and gs["swap_outs"] > 0
    assert gs["swap_ins"] == gs["swap_outs"] == gs["preemptions"]
    assert gs["mid_serve_compiles"] == 0


def test_graphed_slotted_engine_equals_eager_engine():
    """Smoke-size f32 llama at 2 layers on the card over the slotted
    layout, prewarmed with the trace's prompt lengths and strict, and
    lazy (each shape captured at first use): more requests than slots, so
    admissions scatter rows into the pool between replays; tokens,
    counters and launches equal the eager engine's, and the pool tensors
    the decode graph captured never moved."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, synthetic_request
    cfg = get_config("llama3.2-1b", smoke=True).replace(n_layers=2)
    model = init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    reqs = [synthetic_request(cfg, rng, rid=i, prompt_len=p,
                              max_new_tokens=g)
            for i, (p, g) in enumerate(zip([6, 9, 4, 9, 6], [4, 7, 3, 5, 6]))]
    kw = dict(n_slots=2, max_len=16, compressed=True, device="cuda")
    runs = {}
    for name, graphs, warm in (("eager", False, True), ("graphed", True, True),
                               ("lazy", True, False)):
        eng = ServeEngine(model, cfg, graphs=graphs, strict_prewarm=warm,
                          **kw)
        if warm:
            eng.prewarm(prompt_lens=[r.prompt_len for r in reqs])
        assert eng.kv == "slotted" and eng.graphs is graphs
        ptrs = [t.data_ptr() for t in eng.caches.values()]
        kernels.reset_launch_counts()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in eng.caches.values()] == ptrs
        runs[name] = (res, eng.stats(),
                      {k.name: k.launches for k in kernels.all_kernels()})
    want, ws, wl = runs["eager"]
    for name in ("graphed", "lazy"):
        # the lazy engine captures mid-serve, its live rows in the pool:
        # each capture's first call runs once, as the warm-up
        got, gs, gl = runs[name]
        for r in reqs:
            np.testing.assert_array_equal(got[r.rid].tokens,
                                          want[r.rid].tokens, err_msg=name)
        for key in ("tokens", "ticks", "decode_steps", "prefill_calls"):
            assert gs[key] == ws[key], (name, key)
        assert gl == wl and gl["nm_spmv"] > 0 and gl["nm_xwt"] > 0, name
    assert runs["graphed"][1]["mid_serve_compiles"] == 0
    assert runs["lazy"][1]["mid_serve_compiles"] == 4   # decode + 3 lengths


def test_graphed_sequential_decode_equals_eager_across_positions():
    """The fixed-batch oracle's decode graph reads its position from a
    static input: graphed tokens equal eager ones at every position (a
    position baked into the capture would rewrite one slot and diverge),
    over two batches of one size that reuse the graph and its caches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import serve_sequential, synthetic_trace
    from repro_torch.serve.sequential import FixedBatch
    cfg = get_config("llama3.2-1b", smoke=True).replace(n_layers=2)
    model = init_model(cfg, seed=0, device="cuda")
    reqs = synthetic_trace(cfg, n_requests=4, prompt_len=7,
                           gen_lens=[9, 6], seed=2)
    runs = {g: serve_sequential(model, cfg, reqs, n_slots=2, max_len=16,
                                device="cuda", graphs=g)
            for g in (False, True)}
    (want, ws), (got, gs) = runs[False], runs[True]
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid].tokens, want[r.rid].tokens)
    assert gs["decode_steps"] == ws["decode_steps"] == 16
    assert gs["graphs"] == 2                  # one prefill, one decode shape
    fb = FixedBatch(model, cfg, device="cuda")
    assert fb.graphs
    fb.run(reqs[:2], max_len=16)
    ptrs = [t.data_ptr() for t in fb.caches[2, 16].values()]
    fb.run(reqs[2:], max_len=16)
    assert [t.data_ptr() for t in fb.caches[2, 16].values()] == ptrs


def test_capture_over_a_syncing_function_raises():
    """A host sync in a captured function raises (in the warm-up, under
    the sync debug mode) instead of running eagerly."""
    from repro_torch.serve.prewarm import GraphEntry, abstract
    entry = GraphEntry("sync", lambda x: x + x.sum().item(),
                       device=torch.device("cuda"), graphs=True,
                       pool=torch.cuda.graph_pool_handle(),
                       stream=torch.cuda.Stream())
    with pytest.raises(RuntimeError, match="synchroniz"):
        entry.capture(abstract((4,), torch.float32))
    assert entry.n_compiles == 0


def test_graph_replay_raises_when_a_captured_pool_moved():
    """A graph writes its pool by address: a replay after the pool tensor
    was replaced raises instead of writing freed memory."""
    from repro_torch.serve.prewarm import GraphEntry
    pool = {"k": torch.zeros(4, device="cuda")}

    def fn(x):
        pool["k"].add_(x)
        return pool["k"] * 2
    entry = GraphEntry("w", fn, device=torch.device("cuda"), graphs=True,
                       pool=torch.cuda.graph_pool_handle(),
                       stream=torch.cuda.Stream(),
                       fixed=lambda: [pool["k"]])
    out = entry(torch.ones(4))           # captured at first use
    torch.cuda.synchronize()
    assert out.tolist() == [2.0] * 4     # the call ran once, as the warm-up
    assert entry(torch.ones(4)).tolist() == [4.0] * 4
    pool["k"] = torch.zeros(4, device="cuda")
    with pytest.raises(RuntimeError, match="moved"):
        entry(torch.ones(4))


# ------------------------------------------- the kernels off the serving path

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm", [(1, 4), (2, 4), (2, 8)])
@pytest.mark.parametrize("r,c,k", [(130, 96, 520), (64, 3136, 576),
                                   (64, 49, 148), (1024, 196, 256)])
def test_nm_spmm_kernel_matches_plain(dtype, nm, r, c, k):
    """The paper's orientation, the reference's ragged (130, 96, 520) and
    CNN GEMM shapes (ragged C and K, C not a multiple of 8)."""
    from repro_torch.kernels import nm_spmm as mod
    n, m = nm
    k = -(-k // m) * m
    sp, g = _compressed(r, k, n, m, dtype, seed=r + c)
    b = torch.randn(k, c, generator=g, device="cuda").to(dtype)
    before = mod.SPMM_KERNEL.launches
    y = mod.nm_spmm(sp.values, sp.indices, b, n, m)
    torch.cuda.synchronize()
    assert mod.SPMM_KERNEL.launches == before + 1
    want = mod.nm_spmm_plain(sp.values, sp.indices, b, n, m)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm,s,o,k", [((2, 4), 128, 2048, 2048),
                                      ((1, 4), 37, 200, 512),
                                      ((1, 2), 16, 192, 512),
                                      ((2, 8), 16, 64, 160),
                                      ((2, 4), 3136, 64, 576)])
def test_packed_nm_xwt_kernel_equals_int8_kernel_bitwise(dtype, nm, s, o, k):
    """The packed kernel differs from the int8 one only in its index reads:
    the same output bit for bit, and within tolerance of its plain
    version."""
    from repro_torch.kernels import nm_spmm as mod
    from repro_torch.kernels import ops
    n, m = nm
    sp, g = _compressed(o, k, n, m, dtype, seed=s + k)
    x = torch.randn(s, k, generator=g, device="cuda").to(dtype)
    block = (8, 64, 80) if m == 8 else None
    before = mod.PACKED_KERNEL.launches
    y = ops.nm_xwt(x, sp.values, sp.indices, n, m, packed=True, block=block)
    torch.cuda.synchronize()
    assert mod.PACKED_KERNEL.launches == before + 1
    assert torch.equal(y, mod.nm_xwt(x, sp.values, sp.indices, n, m))
    words = ops.pack_block_indices(sp.indices, n, m, block or (8, 64, 512))
    want = mod.nm_xwt_packed_plain(x, sp.values, words, n, m)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (2, 8)])
@pytest.mark.parametrize("b,o,k", [(1, 512, 2048), (8, 2048, 2048),
                                   (5, 200, 136), (11, 8192, 2048)])
def test_nm_spmv_onehot_kernel_matches_plain(dtype, nm, b, o, k):
    from repro_torch.kernels import nm_spmv as mod
    n, m = nm
    sp, g = _compressed(o, k, n, m, dtype, seed=b + o)
    x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
    before = mod.ONEHOT_KERNEL.launches, mod.KERNEL.launches
    y = mod.nm_spmv(x, sp.values, sp.indices, n, m, mode="onehot")
    torch.cuda.synchronize()
    assert (mod.ONEHOT_KERNEL.launches, mod.KERNEL.launches) == (
        before[0] + 1, before[1])
    want = mod.nm_spmv_onehot_plain(x, sp.values, sp.indices, n, m)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,dv,case", [
    (8, 128, 128, 64, 64, dict()),
    (4, 100, 130, 64, 64, dict(window=32)),
    (2, 256, 256, 256, 256, dict(window=64, cap=50.0)),
    (4, 96, 96, 192, 128, dict()),
    (3, 32, 128, 64, 64, dict(q_off=32)),
    (2, 40, 64, 64, 64, dict(q_off=-8)),
    (2, 64, 64, 64, 32, dict(causal=False))])
def test_flash_attention_kernel_matches_plain(dtype, bh, sq, sk, d, dv, case):
    """Causal, window, softcap, d 256 (over 48 KB of shared memory), MLA's
    d 192 / dv 128, a q_off slice, rows masked everywhere (q_off < 0: they
    must be 0), non-causal, and ragged Sq / Sk."""
    from repro_torch.kernels import flash_attention as mod
    g = torch.Generator(device="cuda").manual_seed(bh * sq + d)
    q = torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(bh, sk, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(bh, sk, dv, generator=g, device="cuda").to(dtype)
    before = mod.FLASH_KERNEL.launches
    out = mod.flash_attention_kernel(q, k, v, **case)
    torch.cuda.synchronize()
    assert mod.FLASH_KERNEL.launches == before + 1
    want = mod.flash_attention_plain(q, k, v, **case)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


# ------------------------------- the tensor-core tile body (nm_mma.cuh)
# bf16 nm_xwt (int8 and packed) and the onehot nm_spmv body share it; the
# launch plan (tile, ring, K splits) comes from nm_spmm.mma_plan.

LLAMA_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
MODEL_SHAPES = sorted(set(LLAMA_SHAPES + DEEPSEEK_SHAPES))


def _bf16_case(o, k, n, m, rows, seed):
    sp, g = _compressed(o, k, n, m, torch.bfloat16, seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    return sp, x


def _once_and_again(kernel, fn):
    """fn() twice: the launch counter moves by exactly one per call and
    the two outputs are the same bits (the split sums' order is fixed)."""
    before = kernel.launches
    y = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y2 = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(y, y2)
    return y


def _close(y, want):
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("o,k", MODEL_SHAPES)
def test_onehot_mma_body_at_model_shapes(o, k):
    """Every llama and deepseek decode shape at B 8, including the split
    shapes O 512 / 576 and K 8192 / 10944."""
    from repro_torch.kernels import nm_spmv as mod
    sp, x = _bf16_case(o, k, 2, 4, 8, seed=o + k)
    y = _once_and_again(mod.ONEHOT_KERNEL, lambda: mod.nm_spmv(
        x, sp.values, sp.indices, 2, 4, mode="onehot"))
    _close(y, mod.nm_spmv_onehot_plain(x, sp.values, sp.indices, 2, 4))


@pytest.mark.parametrize("s", [32, 128])
@pytest.mark.parametrize("o,k", MODEL_SHAPES)
def test_xwt_mma_body_at_model_shapes(o, k, s):
    """Prefill (S 128) and the verify span (S 32) at every llama and
    deepseek shape, including K 512 (wuk / wuv) and 10944."""
    from repro_torch.kernels import nm_spmm as mod
    sp, x = _bf16_case(o, k, 2, 4, s, seed=o + k + s)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_xwt(
        x, sp.values, sp.indices, 2, 4))
    _close(y, mod.nm_xwt_plain(x, sp.values, sp.indices, 2, 4))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 127, 128, 129])
@pytest.mark.parametrize("o,k", [(512, 2048), (2048, 8192)])
def test_xwt_mma_body_row_counts(s, o, k):
    """Row counts at and around the plan's row tiles (8 / 32 / 64 / 128)."""
    from repro_torch.kernels import nm_spmm as mod
    sp, x = _bf16_case(o, k, 2, 4, s, seed=s + k)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_xwt(
        x, sp.values, sp.indices, 2, 4))
    _close(y, mod.nm_xwt_plain(x, sp.values, sp.indices, 2, 4))


@pytest.mark.parametrize("b", [1, 7, 8, 9, 16])
@pytest.mark.parametrize("o,k", [(512, 2048), (2048, 10944)])
def test_onehot_mma_body_batches(b, o, k):
    """Batches around the 8-row n-tile: above 8, more CTAs along y."""
    from repro_torch.kernels import nm_spmv as mod
    sp, x = _bf16_case(o, k, 2, 4, b, seed=b + k)
    y = _once_and_again(mod.ONEHOT_KERNEL, lambda: mod.nm_spmv(
        x, sp.values, sp.indices, 2, 4, mode="onehot"))
    _close(y, mod.nm_spmv_onehot_plain(x, sp.values, sp.indices, 2, 4))


@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (1, 2), (2, 8)])
@pytest.mark.parametrize("k", [2052, 136, 520, 2112])
def test_mma_bodies_ragged_k(nm, k):
    """K not a multiple of the 64-column superstep or of the ring stage:
    the masked tail; K % 8 != 0 also takes the scalar X / value stages."""
    from repro_torch.kernels import nm_spmm, nm_spmv
    n, m = nm
    k = -(-k // m) * m
    sp, x = _bf16_case(200, k, n, m, 37, seed=k + m)
    y = _once_and_again(nm_spmm.KERNEL, lambda: nm_spmm.nm_xwt(
        x, sp.values, sp.indices, n, m))
    _close(y, nm_spmm.nm_xwt_plain(x, sp.values, sp.indices, n, m))
    xb = x[:9]
    y = _once_and_again(nm_spmv.ONEHOT_KERNEL, lambda: nm_spmv.nm_spmv(
        xb, sp.values, sp.indices, n, m, mode="onehot"))
    _close(y, nm_spmv.nm_spmv_onehot_plain(xb, sp.values, sp.indices, n, m))


@pytest.mark.parametrize("nm,s,o,k", [((2, 4), 128, 512, 2048),
                                      ((2, 4), 32, 2048, 8192),
                                      ((2, 4), 128, 2048, 10944),
                                      ((1, 4), 8, 576, 2048),
                                      ((1, 2), 33, 512, 2048),
                                      ((2, 8), 128, 512, 2560),
                                      ((2, 8), 32, 300, 2080)])
def test_packed_mma_body_equals_int8_bitwise(nm, s, o, k):
    """Packed and int8 take one plan and one summation order: the same bits
    at the split shapes.  M = 8 packs 10 indices per word, so the stages
    start inside a word (K 2560: 64 words per row, 16-byte copies; K 2080:
    52 words per row, 4-byte copies)."""
    from repro_torch.kernels import nm_spmm as mod
    from repro_torch.kernels import ops
    n, m = nm
    sp, x = _bf16_case(o, k, n, m, s, seed=s + k + m)
    words = ops.pack_block_indices(sp.indices, n, m,
                                   (8, 64, 160 if m == 8 else 512))
    y = _once_and_again(mod.PACKED_KERNEL, lambda: mod.nm_xwt_packed(
        x, sp.values, words, n, m))
    assert torch.equal(y, mod.nm_xwt(x, sp.values, sp.indices, n, m))
    _close(y, mod.nm_xwt_packed_plain(x, sp.values, words, n, m))


@pytest.mark.parametrize("nm", [(4, 8), (1, 8), (3, 4), (1, 16)])
@pytest.mark.parametrize("rows,o,k", [(8, 512, 2048), (32, 200, 1040),
                                      (128, 2048, 2048)])
def test_first_bf16_bodies_off_the_tensor_core_set(nm, rows, o, k):
    """bf16 at an N:M outside ``FAST_NM`` has no tensor-core plan and keeps
    the first bodies: nm_xwt and the onehot body within tolerance of their
    plain versions, packed nm_xwt bit-equal to int8 (K 1040 leaves a
    ragged 64-column step)."""
    from repro_torch.core.sparsity import pack_indices_i32
    from repro_torch.kernels import nm_spmm, nm_spmv
    n, m = nm
    assert nm_spmm.mma_plan(rows, o, k, n, m) is None
    assert nm_spmm.mma_plan(rows, o, k, n, m, decode=True) is None
    sp, x = _bf16_case(o, k, n, m, rows, seed=rows + k + 10 * m + n)
    y = _once_and_again(nm_spmm.KERNEL, lambda: nm_spmm.nm_xwt(
        x, sp.values, sp.indices, n, m))
    _close(y, nm_spmm.nm_xwt_plain(x, sp.values, sp.indices, n, m))
    words = pack_indices_i32(sp.indices, m)
    yp = _once_and_again(nm_spmm.PACKED_KERNEL, lambda: nm_spmm.nm_xwt_packed(
        x, sp.values, words, n, m))
    assert torch.equal(yp, y)
    xb = x[:9]
    y = _once_and_again(nm_spmv.ONEHOT_KERNEL, lambda: nm_spmv.nm_spmv(
        xb, sp.values, sp.indices, n, m, mode="onehot"))
    _close(y, nm_spmv.nm_spmv_onehot_plain(xb, sp.values, sp.indices, n, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nm", [(1, 2), (1, 4), (2, 4), (2, 8), (4, 8),
                                (1, 16)])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("o,k", [(512, 2048), (576, 2048), (2048, 8192),
                                 (200, 1040), (72, 1028)])
def test_gather_body_matches_plain_twice(dtype, nm, b, o, k):
    """The gather body under its plan: batch groups 1-8 and two groups
    (B 9, 16), split K (O 512 / 576, K 8192), K not a multiple of the
    16-byte run (1028 at M 4; rounded up to M elsewhere), the compile-time
    N:M instances and the general one (4:8, 1:16); within tolerance of the
    plain version, and the same bits on a second launch (splits added in
    order by the last CTA to arrive)."""
    from repro_torch.kernels import nm_spmv as mod
    n, m = nm
    k = -(-k // m) * m
    sp, g = _compressed(o, k, n, m, dtype, seed=b + o + k + m)
    x = torch.randn(b, k, generator=g, device="cuda").to(dtype)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_spmv(
        x, sp.values, sp.indices, n, m))
    np.testing.assert_allclose(
        y.float().cpu().numpy(),
        mod.nm_spmv_plain(x, sp.values, sp.indices, n, m).float().cpu().numpy(),
        **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 4, 5])
@pytest.mark.parametrize("bs", [16, 32])
def test_mla_kernel_lengths_around_blocks(dtype, s, bs):
    """Deepseek width (16 heads, kv_lora 512, rope 64) at kv_len 1, 15, 16,
    17 and 160 (spans ending inside, at and past a block), a hot (1e4)
    trash block, f32 and bf16 pools: verify within 2e-4 of its plain
    version, decode within 2e-4 of its own, verify offset i equal bit for
    bit to a decode launch at kv_len + i, and the same bits twice."""
    from repro_torch.kernels import flash_attention as mod
    lens = [1, 15, 16, 17, 160]
    b, h, r, rd = len(lens), 16, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(bs + s)
    tbl, nb = _span_table(gen, lens, s, bs)
    cp = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
    pp = torch.randn(nb, bs, rd, generator=gen, device="cuda").to(dtype)
    cp[0] = 1e4
    pp[0] = 1e4
    ql = torch.randn(b, s, h, r, generator=gen, device="cuda")
    qp = torch.randn(b, s, h, rd, generator=gen, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    scale = (128 + 64) ** -0.5
    out = _once_and_again(mod.MLA_VERIFY_KERNEL, lambda: mod.paged_mla_verify(
        ql, qp, cp, pp, tbl, kv_len, scale=scale))
    want = mod.paged_mla_verify_plain(ql, qp, cp, pp, tbl, kv_len,
                                      scale=scale)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(s):
        args = (ql[:, i].contiguous(), qp[:, i].contiguous(), cp, pp, tbl,
                kv_len + i)
        one = mod.paged_mla_decode(*args, scale=scale)
        np.testing.assert_allclose(
            one.cpu().numpy(),
            mod.paged_mla_decode_plain(*args, scale=scale).cpu().numpy(),
            rtol=2e-4, atol=2e-4)
        assert torch.equal(out[:, i], one), f"offset {i}"


@pytest.mark.parametrize("bh,sq,sk,d,dv,case", [
    (2, 1000, 1000, 128, 128, dict(window=300)),
    (1, 300, 700, 64, 64, dict(causal=False, window=100)),
    (2, 128, 2048, 64, 64, dict(q_off=1900, window=256)),
    (1, 200, 333, 256, 256, dict(cap=30.0)),
    (3, 64, 64, 64, 64, dict(q_off=-64)),
    (2, 130, 97, 192, 128, dict(causal=False))])
def test_flash_tensor_core_body_skips_only_masked_tiles(bh, sq, sk, d, dv,
                                                        case):
    """The bf16 tensor-core body skips key tiles outside each q tile's
    causal / window band: long windows, a non-causal window, a q_off
    slice deep in the keys, the 32-key tiles of dv 256 with a softcap,
    rows masked everywhere (0), and ragged Sq / Sk; against the plain
    version at bf16's 3e-2, finite, and the same bits twice."""
    from repro_torch.kernels import flash_attention as mod
    g = torch.Generator(device="cuda").manual_seed(bh * sq + sk + d)
    q = torch.randn(bh, sq, d, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(bh, sk, d, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(bh, sk, dv, generator=g, device="cuda").to(torch.bfloat16)
    out = _once_and_again(mod.FLASH_KERNEL, lambda: mod.flash_attention_kernel(
        q, k, v, **case))
    want = mod.flash_attention_plain(q, k, v, **case)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)


# ----------------------------------- the f32 split-TF32 body (nm_tf32.cuh)

def _cnn_gemms():
    from repro_torch.models.cnn import CNN_LAYER_GEMMS
    return [(f"{net}/{name}", co, -(-k // 4) * 4, sp)
            for net, layers in CNN_LAYER_GEMMS.items()
            for name, co, k, sp in layers]


CNN_GEMMS = _cnn_gemms()


def _f32_case(r, k, n, m, c, seed):
    """Compressed W [r, k] at k^-0.5 and dense columns [c, k] in f32."""
    sp, g = _compressed(r, k, n, m, torch.float32, seed)
    return sp, torch.randn(c, k, generator=g, device="cuda")


def _close_f32(y, want):
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               **_tol(torch.float32))


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)])
@pytest.mark.parametrize("layer,r,k,c", CNN_GEMMS,
                         ids=[g[0] for g in CNN_GEMMS])
def test_f32_body_at_cnn_batch1_shapes(layer, r, k, c, nm):
    """Every CNN GEMM at batch 1, the paper's batch, where the plans split
    K (resnet50 conv5_3x3: R 512, K 4608, 49 columns): nm_spmm (C = A_sp .
    B) and nm_xwt (Y = cols . W^T) within 1e-4 of their plain versions,
    the same bits twice, packed bit-equal to int8."""
    from repro_torch.core.sparsity import pack_indices_i32
    from repro_torch.kernels import nm_spmm as mod
    n, m = nm
    sp, cols = _f32_case(r, k, n, m, c, seed=r + k + c + n)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_xwt(
        cols, sp.values, sp.indices, n, m))
    _close_f32(y, mod.nm_xwt_plain(cols, sp.values, sp.indices, n, m))
    words = pack_indices_i32(sp.indices, m)
    yp = _once_and_again(mod.PACKED_KERNEL, lambda: mod.nm_xwt_packed(
        cols, sp.values, words, n, m))
    assert torch.equal(yp, y)
    b = cols.t().contiguous()
    y2 = _once_and_again(mod.SPMM_KERNEL, lambda: mod.nm_spmm(
        sp.values, sp.indices, b, n, m))
    _close_f32(y2, mod.nm_spmm_plain(sp.values, sp.indices, b, n, m))


@pytest.mark.parametrize("nm", [(4, 8), (1, 8), (3, 4), (1, 16), (2, 32),
                                (1, 64), (63, 64)])
@pytest.mark.parametrize("r,c,k", [(130, 96, 520), (64, 49, 1152),
                                   (200, 5, 1024), (72, 37, 4608)])
def test_f32_body_off_the_bf16_set(nm, r, c, k):
    """N:M outside ``FAST_NM`` (M up to 64: an M-block wider than the
    body's 16-column decompress group) in f32: nm_xwt, packed nm_xwt and
    nm_spmm within 1e-4 of plain, twice the same bits, packed bit-equal to
    int8; ragged rows, columns and K (C 49 and 37: dense rows not 16-byte
    aligned)."""
    from repro_torch.core.sparsity import pack_indices_i32
    from repro_torch.kernels import nm_spmm as mod
    n, m = nm
    k = -(-k // m) * m
    sp, cols = _f32_case(r, k, n, m, c, seed=r + c + k + 10 * m + n)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_xwt(
        cols, sp.values, sp.indices, n, m))
    _close_f32(y, mod.nm_xwt_plain(cols, sp.values, sp.indices, n, m))
    words = pack_indices_i32(sp.indices, m)
    yp = _once_and_again(mod.PACKED_KERNEL, lambda: mod.nm_xwt_packed(
        cols, sp.values, words, n, m))
    assert torch.equal(yp, y)
    b = cols.t().contiguous()
    y2 = _once_and_again(mod.SPMM_KERNEL, lambda: mod.nm_spmm(
        sp.values, sp.indices, b, n, m))
    _close_f32(y2, mod.nm_spmm_plain(sp.values, sp.indices, b, n, m))


@pytest.mark.parametrize("nm,r,c,k", [((2, 4), 512, 49, 4608),
                                      ((2, 4), 384, 64, 1152),
                                      ((2, 8), 256, 196, 2304),
                                      ((1, 4), 2048, 32, 8192)])
def test_f32_body_split_k_same_bits_and_packed(nm, r, c, k):
    """At shapes whose plan splits K: a second launch gives the same bits
    (partial sums added in split order, no float atomics), and packed
    nm_xwt equals int8 bit for bit (one plan for both)."""
    from repro_torch.core.sparsity import pack_indices_i32
    from repro_torch.kernels import nm_spmm as mod
    n, m = nm
    assert mod.f32_plan(r, c, k, n, m, mod.sm_count(torch.device(
        "cuda"))).splits > 1
    sp, cols = _f32_case(r, k, n, m, c, seed=r + c + k)
    y = _once_and_again(mod.KERNEL, lambda: mod.nm_xwt(
        cols, sp.values, sp.indices, n, m))
    words = pack_indices_i32(sp.indices, m)
    yp = _once_and_again(mod.PACKED_KERNEL, lambda: mod.nm_xwt_packed(
        cols, sp.values, words, n, m))
    assert torch.equal(yp, y)
    _close_f32(y, mod.nm_xwt_plain(cols, sp.values, sp.indices, n, m))
    b = cols.t().contiguous()
    y2 = _once_and_again(mod.SPMM_KERNEL, lambda: mod.nm_spmm(
        sp.values, sp.indices, b, n, m))
    _close_f32(y2, mod.nm_spmm_plain(sp.values, sp.indices, b, n, m))


@pytest.mark.parametrize("n,d,v", [(256, 2048, 8192), (37, 256, 1000)])
def test_lm_head_backward_matches_f32_autograd(n, d, v):
    """The tied LM head on bf16 operands: ``_HeadMM``'s f32 logits and its
    hand-written backward (d/dx, d/demb under an f32 cotangent) against
    autograd of the f32 product on the same card, each gradient within
    one bf16 rounding step of its largest value."""
    from repro_torch.models.common import _HeadMM
    g = torch.Generator(device="cuda").manual_seed(n + d + v)
    x = torch.randn(n, d, generator=g, device="cuda").to(torch.bfloat16)
    emb = (torch.randn(v, d, generator=g, device="cuda")
           * d ** -0.5).to(torch.bfloat16)
    ct = torch.randn(n, v, generator=g, device="cuda")
    xa, ea = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    got = _HeadMM.apply(xa, ea)
    got.backward(ct)
    xb, eb = x.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    want = xb.float() @ eb.float().t()
    want.backward(ct)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in ((xa.grad, xb.grad), (ea.grad, eb.grad)):
        assert a.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * scale)
