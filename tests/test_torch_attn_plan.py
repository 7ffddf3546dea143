"""The launch plans of the paged attention kernels, checked on the CPU:
``gqa_plan`` / ``mla_plan`` are pure functions of the shape, the table
width and the dtype, which the wrappers pass to
``csrc/paged_gqa_verify.cu`` / ``csrc/paged_mla_verify.cu`` (the launchers
only check them), and ``row_chunks`` is the set of chunks the tensor-core
bodies visit for a row.  The kernels under them are checked on the card
(``tests/test_torch_cuda.py``)."""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.build import CSRC_DIR  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
SERVE_LENS = [1, 16, 17, 64, 100, 128, 145, 160]   # chip_smoke's 8 slots
SPANS = [1, 2, 4, 5, 7]
LLAMA = dict(kvh=8, g=4, d=64, dv=64)               # llama3.2-1b attention
DEEPSEEK = dict(h=16, r=512, rd=64)                 # deepseek-v2-lite MLA
GEMMA2 = dict(kvh=8, g=2, d=256, dv=256)            # gemma2-9b attention
ZAMBA2 = dict(kvh=32, g=1, d=112, dv=112)           # zamba2-7b shared block
WHISPER = dict(kvh=12, g=1, d=64, dv=64)            # whisper-small decoder
QWEN2_VL = dict(kvh=4, g=7, d=128, dv=128)          # qwen2-vl-7b, G 7


def _gqa(b, s, bs, tw, dtype=BF, **kw):
    shape = {**LLAMA, **kw}
    return fa.gqa_plan(b, s, shape["kvh"], shape["g"], shape["d"],
                       shape["dv"], bs, tw, dtype)


def _mla(b, s, bs, tw, dtype=BF, **kw):
    shape = {**DEEPSEEK, **kw}
    return fa.mla_plan(b, s, shape["h"], shape["r"], shape["rd"], bs, tw,
                       dtype)


@pytest.mark.parametrize("bs", [1, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("window", [None, 1, 20, 64, 100])
def test_chunks_cover_each_rows_blocks_once(bs, window):
    """For every view length up to past the table, the chunks of a row
    hold each block of its view exactly once (the first
    ceil(kv_len / bs) blocks without a window), lie inside the table's
    chunks, and none of them misses the view."""
    tw = -(-300 // bs)
    per = fa.CHUNK // bs
    for length in range(0, tw * bs + 40):
        chunks = fa.row_chunks(length, tw, bs, window)
        assert chunks.step == 1 and len(chunks) >= 1
        assert 0 <= chunks.start and chunks.stop <= fa.table_chunks(tw, bs)
        top = min(length, tw * bs)
        lo = max(0, length - window) if window is not None else 0
        cover = [0] * tw
        for c in chunks:
            for j in range(c * per, min((c + 1) * per, tw)):
                cover[j] += 1
        seen = [j for j in range(tw) if j * bs < top and (j + 1) * bs > lo]
        assert all(cover[j] == 1 for j in seen)
        if window is None:
            assert seen == list(range(-(-top // bs)))
        if seen:   # every chunk holds a position of the view
            assert all(c * fa.CHUNK < top and (c + 1) * fa.CHUNK > lo
                       for c in chunks)
        else:      # a row that sees nothing: chunk 0, all of it masked
            assert chunks == range(0, 1)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_chunking_does_not_depend_on_the_span(bs):
    """The chunk and the table's chunks are the same at S 1, 2, 4, 5 and 7
    (the precondition of verify offset i = decode at kv_len + i bit for
    bit), and so is a row's chunk set: it depends on its own length."""
    tw = -(-(2100 + 6) // bs)
    for plan in (_gqa, _mla):
        ref = plan(8, 1, bs, tw)
        for s in SPANS:
            p = plan(8, s, bs, tw)
            assert p.body == "tc" and p.chunk == ref.chunk == fa.CHUNK
            assert p.grid[0] == ref.grid[0] == fa.table_chunks(tw, bs)
    for length in (15, 16, 17, 63, 64, 65, 1000, 2100):
        for i in range(7):
            assert fa.row_chunks(length + i, tw, bs) == \
                range(0, -(-(length + i) // fa.CHUNK))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("s", SPANS)
def test_shared_memory_fits_at_model_widths(dtype, bs, s):
    """Llama (KVH 8, G 4, d 64) and deepseek (H 16, r 512, rd 64) at block
    sizes 8, 16, 32 and every span: one CTA's shared memory stays within
    the 227 KB a block can take."""
    for tw in (10, 264):
        for p in (_gqa(8, s, bs, tw, dtype), _mla(8, s, bs, tw, dtype)):
            assert 0 < p.smem <= fa.SMEM_LIMIT == 232448


@pytest.mark.parametrize("s", SPANS)
def test_gemma2_width_takes_the_tensor_cores_within_shared_memory(s):
    """gemma2-9b (KVH 8, G 2, d = dv = 256) at block 16 over a 4224-position
    table: the tensor-core body, which asks 2 B x (64 x 264 for K, 64 x
    264 for V, rows x 16 x 264 for the queries): 76032 B at one span row,
    101376 B at four, against the 232448 B a CTA may opt in to (the
    launcher opts in above 48 KB).  f32 takes the first body."""
    p = _gqa(8, s, 16, 264, **GEMMA2)
    rows = -(-s // -(-s // fa.GQA_SPAN_ROWS))
    assert p.body == "tc" and p.rows == rows
    assert p.smem == 2 * (64 * 264 * 2 + rows * 16 * 264)
    assert p.smem <= fa.SMEM_LIMIT == 232448
    assert {1: 76032, 4: 101376}.get(s, p.smem) == p.smem
    assert p.grid == (fa.table_chunks(264, 16), 8 * 8, -(-s // rows)) \
        == (66, 64, -(-s // rows))
    f = _gqa(8, s, 16, 264, dtype=F32, **GEMMA2)
    assert f.body == "first" and f.smem <= fa.SMEM_LIMIT


@pytest.mark.parametrize("tw", [10, 264])
def test_zamba2_width_takes_the_tensor_cores_within_shared_memory(tw):
    """zamba2-7b's shared block (32 KV heads of d 112, G 1: multi-head) in
    decode at block 16, over a short table and a 4224-position one (a
    4160 prompt + 64): the tensor-core body (d a multiple of 16), one span
    row, asking 2 B x (64 x 120 for K, 64 x 120 for V, 16 x 120 for the
    query tile, of which G 1 fills one row) = 34560 B; a CTA per chunk x
    slot x head.  f32 takes the first body."""
    p = _gqa(8, 1, 16, tw, **ZAMBA2)
    assert p.body == "tc" and p.rows == 1 and p.threads == 128
    assert p.smem == 2 * (64 * 120 * 2 + 16 * 120) == 34560
    assert p.grid == (fa.table_chunks(tw, 16), 8 * 32, 1)
    assert p.grid[0] == {10: 3, 264: 66}[tw]
    f = _gqa(8, 1, 16, tw, dtype=F32, **ZAMBA2)
    assert f.body == "first" and 0 < f.smem <= fa.SMEM_LIMIT


@pytest.mark.parametrize("tw", [10, 132])
@pytest.mark.parametrize("s", [1, 4])
def test_whisper_and_qwen2_vl_widths_take_the_tensor_cores(s, tw):
    """whisper-small's decoder self-attention (12 KV heads of d 64, G 1:
    one of the query tile's 16 rows) in decode, and qwen2-vl-7b's (4 KV
    heads of d 128, G 7: 7 of 16 rows, not a power of two; 28 rows a kv
    head at span 4) in decode and verify, at block 16 over phase 3's
    160-position table and a 2100-position one: the tensor-core body, a
    CTA per chunk x slot x kv head, 2 B x (64 x (d + 8) for K and for V,
    rows x 16 x (d + 8) for the queries) of shared memory, and the split
    workspace holding every (row, head) of a chunk's partials."""
    rows = -(-s // -(-s // fa.GQA_SPAN_ROWS))
    for shape, kvh, g, d in ((WHISPER, 12, 1, 64), (QWEN2_VL, 4, 7, 128)):
        if shape is WHISPER and s > 1:
            continue                     # whisper takes no speculation
        p = _gqa(8, s, 16, tw, **shape)
        assert p.body == "tc" and p.rows == rows and p.threads == 128
        assert p.smem == 2 * (64 * (d + 8) * 2 + rows * 16 * (d + 8))
        assert p.smem <= fa.SMEM_LIMIT
        chunks = fa.table_chunks(tw, 16)
        assert p.grid == (chunks, 8 * kvh, -(-s // rows))
        assert chunks == {10: 3, 132: 33}[tw]
        assert p.ws == 8 * kvh * s * chunks * g * (d + 2)
        assert p.counters == 8 * kvh * s
        f = _gqa(8, s, 16, tw, dtype=F32, **shape)
        assert f.body == "first" and 0 < f.smem <= fa.SMEM_LIMIT
        assert f.rows == min(s * g, 1024 // d)


def _live_ctas(plan, lens, s, tw, bs, heads=1):
    """The CTAs of a tensor-core launch that do work: a GQA CTA when its
    chunk holds a view of one of its rows, an MLA CTA when its chunk holds
    its row's view."""
    gx, gy, gz = plan.grid
    live = 0
    for length in lens:
        for z in range(gz):
            rows = range(z * plan.rows, min(s, (z + 1) * plan.rows))
            live += sum(any(c in fa.row_chunks(length + i, tw, bs)
                            for i in rows) for c in range(gx))
    return live * heads


def test_cta_counts_at_serve_lens():
    """chip_smoke's serving shape: 8 slots at SERVE_LENS, block 16, the
    verify span 4 with its table.  The first bodies ran 64 GQA CTAs (slot x
    kv head) and 128 MLA CTAs (slot x head); the chunked bodies spread the
    long slots over more GQA CTAs, and MLA holds a slot's 16 heads in one
    CTA per chunk and span row."""
    bs = 16
    tw_dec = -(-max(SERVE_LENS) // bs)
    tw_ver = -(-(max(SERVE_LENS) + 3) // bs)
    g_dec, g_ver = _gqa(8, 1, bs, tw_dec), _gqa(8, 4, bs, tw_ver)
    assert g_dec.grid == g_ver.grid == (3, 64, 1)
    assert g_dec.threads == g_ver.threads == 32 * fa.GQA_SPAN_ROWS
    assert _live_ctas(g_dec, SERVE_LENS, 1, tw_dec, bs) == 14
    assert _live_ctas(g_dec, SERVE_LENS, 1, tw_dec, bs, heads=8) == 112
    assert _live_ctas(g_ver, SERVE_LENS, 4, tw_ver, bs, heads=8) == 128
    m_dec, m_ver = _mla(8, 1, bs, tw_dec), _mla(8, 4, bs, tw_ver)
    assert m_dec.grid == (3, 1, 8) and m_ver.grid == (3, 4, 8)
    assert m_ver.threads == 32 * fa.MLA_WARPS
    assert _live_ctas(m_dec, SERVE_LENS, 1, tw_dec, bs) == 14
    assert sum(len(fa.row_chunks(n + i, tw_ver, bs))
               for n in SERVE_LENS for i in range(4)) == 62
    assert _gqa(8, 4, bs, tw_ver, F32).grid == (64, 1, 1)
    assert _mla(8, 4, bs, tw_ver, F32).grid == (128, 1, 1)


@pytest.mark.parametrize("s", range(1, 10))
def test_gqa_span_rows_per_cta(s):
    """Span rows go to CTAs in even groups of at most 4, one warp each; a
    CTA has 4 warps at every span (all of them copy the chunk)."""
    p = _gqa(8, s, 16, 11)
    groups = p.grid[2]
    assert 1 <= p.rows <= fa.GQA_SPAN_ROWS and p.threads == 128
    assert groups * p.rows >= s > (groups - 1) * p.rows
    assert groups == -(-s // fa.GQA_SPAN_ROWS)


def test_f32_and_other_shapes_take_the_first_body():
    """The rule: bf16 at d, dv (r, rd) multiples of 16, G (H) <= 16, a
    block size dividing the chunk and 16-byte aligned operands take the
    tensor cores; all else the first body, at its old cut."""
    assert _gqa(8, 4, 16, 11).body == "tc"
    assert _mla(8, 4, 16, 11).body == "tc"
    for p in (_gqa(8, 4, 16, 11, F32), _gqa(8, 4, 16, 11, d=72, dv=72),
              _gqa(8, 4, 16, 11, g=17), _gqa(8, 4, 12, 11),
              _gqa(8, 4, 128, 11), _gqa(8, 4, 16, 11, d=272, dv=272),
              fa.gqa_plan(8, 4, 8, 4, 64, 64, 16, 11, BF, False)):
        assert p.body == "first" and p.chunk == 0 and p.threads == 128
        assert p.ws == p.counters == 0
    for p in (_mla(8, 4, 16, 11, F32), _mla(8, 4, 16, 11, r=36, rd=10),
              _mla(8, 4, 16, 11, h=32), _mla(8, 4, 16, 11, r=1024),
              _mla(8, 4, 16, 11, rd=144),
              _mla(8, 4, 48, 11),
              fa.mla_plan(8, 4, 16, 512, 64, 16, 11, BF, False)):
        assert p.body == "first" and p.chunk == 0 and p.threads == 128
    # the first bodies keep their cut: GQA rows per CTA within 1024
    # accumulators, MLA up to 4 span rows (1 at S = 1) per (slot, head)
    p = _gqa(8, 7, 16, 11, F32)
    assert p.rows == 16 and p.grid == (64, 2, 1)
    assert p.smem == (16 * 64 + 16 * 64 + 16 * 64 + 16 * 16 + 5 * 16) * 4
    p = _mla(8, 6, 16, 11, F32)
    assert p.rows == 4 and p.grid == (128, 2, 1)
    assert _mla(8, 1, 16, 11, F32).rows == 1
    with pytest.raises(ValueError, match="accumulators"):
        _gqa(8, 4, 16, 11, F32, d=2048, dv=2048)


@pytest.mark.parametrize("family", ["gqa", "mla"])
@pytest.mark.parametrize("tw", [2, 11, 140])
def test_launch_hands_the_plan_over(monkeypatch, family, tw):
    """The launcher receives the plan's eight ints after the shape, an f32
    workspace of the plan's size and zeroed int32 arrival counters exactly
    when a row's view can span more than one chunk."""
    seen = []
    kernel = fa.GQA_VERIFY_KERNEL if family == "gqa" else fa.MLA_VERIFY_KERNEL
    monkeypatch.setattr(kernel, "launch", lambda *args: seen.append(args))
    monkeypatch.setattr(fa, "_arrivals",
                        lambda dev, n: torch.zeros(max(n, 4096),
                                                   dtype=torch.int32))
    b, s, bs = 8, 4, 16
    if family == "gqa":
        plan = _gqa(b, s, bs, tw)
        fa._launch_planned(kernel, plan, torch.device("cpu"), *range(18))
        nargs = 18
    else:
        plan = _mla(b, s, bs, tw)
        fa._launch_planned(kernel, plan, torch.device("cpu"), *range(16))
        nargs = 16
    (args,) = seen
    assert args[nargs:nargs + 8] == plan.args()
    assert plan.args()[0] == 1 and plan.args()[1] == fa.CHUNK
    assert len(kernel.argtypes) == len(args) + 1          # + the stream
    split = plan.grid[0] > 1
    assert (args[-2] is not None) == (args[-1] is not None) == split
    if family == "gqa":
        assert plan.ws == (b * 8 * s * plan.grid[0] * 4 * 66 if split else 0)
        assert plan.counters == (b * 8 * s if split else 0)
    else:
        assert plan.ws == (b * s * plan.grid[0] * 16 * 514 if split else 0)
        assert plan.counters == (b * s if split else 0)


def test_plans_are_pure_in_their_arguments():
    assert _gqa(8, 4, 16, 11) == _gqa(8, 4, 16, 11)
    assert _mla(8, 4, 16, 11) == _mla(8, 4, 16, 11)
    assert _gqa(8, 4, 16, 11).grid[0] < _gqa(8, 4, 16, 140).grid[0]


@pytest.mark.parametrize("name", ["paged_gqa_verify", "paged_mla_verify"])
def test_kernel_names_carry_the_source_name(name):
    """Every kernel of csrc/<name>.cu is named <name>...: chip_smoke's
    traced breakdown files paged attention by that name and
    ``tools/port_ab.py`` counts the launches whose name holds "paged_"."""
    text = (CSRC_DIR / f"{name}.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", text)
    assert len(kernels) == 2 and all(k.startswith(name) for k in kernels)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("s,tw", [(1, 2), (1, 11), (4, 140), (1, 140)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_gqa_head_shard_keeps_the_whole_launch(parts, s, tw, dtype):
    """A tensor-parallel shard of the kv heads takes the whole launch's
    body, chunk, span rows, threads and shared memory (nothing of
    ``gqa_plan`` but the grid and workspace reads the kv head count), so
    each head sums in the whole launch's order."""
    whole = _gqa(8, s, 16, tw, dtype)
    shard = _gqa(8, s, 16, tw, dtype, kvh=LLAMA["kvh"] // parts)
    keep = ("body", "chunk", "rows", "threads", "smem")
    assert [getattr(shard, f) for f in keep] == \
        [getattr(whole, f) for f in keep]
    if whole.body == "tc":
        assert shard.grid[1] * parts == whole.grid[1]
        assert shard.ws * parts == whole.ws
    else:
        assert shard.grid[0] * parts == whole.grid[0]


@pytest.mark.parametrize("h,parts", [(16, 2), (16, 4), (32, 2), (32, 4)])
@pytest.mark.parametrize("s,tw", [(1, 11), (1, 140), (4, 11)])
def test_mla_head_shard_takes_the_whole_heads_body(h, parts, s, tw):
    """``mla_plan(..., plan_h=H)`` on H / parts heads picks the body the
    whole launch picks: at H 32 the first body, although the shard's heads
    would fit the tensor cores' 16-row tile; its grid and workspace follow
    the shard's heads."""
    whole = _mla(8, s, 16, tw, h=h)
    shard = fa.mla_plan(8, s, h // parts, DEEPSEEK["r"], DEEPSEEK["rd"], 16,
                        tw, BF, True, plan_h=h)
    assert shard.body == whole.body == ("tc" if h <= fa.TILE else "first")
    assert (shard.chunk, shard.rows, shard.threads, shard.smem) == \
        (whole.chunk, whole.rows, whole.threads, whole.smem)
    if whole.body == "tc":
        assert shard.grid == whole.grid and shard.ws * parts == whole.ws
    else:
        assert shard.grid[0] * parts == whole.grid[0]
    alone = _mla(8, s, 16, tw, h=h // parts)
    if h > fa.TILE:
        assert alone.body == "tc"            # what the pin prevents
