"""The launch plan of the gather ``nm_spmv`` body, checked on the CPU:
``gather_plan`` is a pure function of the shape and the SM count, which the
wrapper passes to ``csrc/nm_spmv.cu`` (the launcher only checks it).  The
kernel under it is checked on the card (``tests/test_torch_cuda.py``)."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import nm_spmv  # noqa: E402

SMS = 132
SMEM_LIMIT = 232448
WARPS = nm_spmv.GATHER_WARPS
# (O, K) of one llama3.2-1b layer and the deepseek-v2-lite linears the
# decode path runs (chip_smoke's LAYER_SHAPES and DS_CHECK_SHAPES)
LLAMA = [(2048, 2048), (512, 2048), (512, 2048), (2048, 2048),
         (8192, 2048), (8192, 2048), (2048, 8192)]
DEEPSEEK = [(3072, 2048), (576, 2048), (2048, 512), (2048, 2048),
            (2816, 2048), (2048, 2816), (10944, 2048), (2048, 10944)]
# falcon-mamba-7b's in / x / dt / out projections (x_proj's 288 rows,
# dt_proj's K 256) and zamba2-7b's Mamba2 in (14576 rows) / out and shared
# attention + MLP linears
SSM = [(16384, 4096), (288, 8192), (8192, 256), (4096, 8192),
       (14576, 3584), (3584, 7168), (3584, 3584), (14336, 3584),
       (3584, 14336)]
# whisper-small's decoder linears (self / cross q, k, v, o at K 768, the
# MLP's 3072 x 768 and 768 x 3072) and qwen2-vl-7b's (k / v 512 rows, the
# down projection's K 18944)
ENCDEC_VLM = [(768, 768), (3072, 768), (768, 3072), (3584, 3584),
              (512, 3584), (18944, 3584), (3584, 18944)]
MODEL = sorted(set(LLAMA + DEEPSEEK + SSM + ENCDEC_VLM))
RAGGED = [(200, 1032), (96, 8192), (72, 1028), (5, 64), (1, 2048)]
NM = [(2, 4), (1, 4), (1, 2), (2, 8), (4, 8), (1, 16), (3, 4), (5, 7)]


def _plan(b, o, k, n, m, elt=2):
    k = -(-k // m) * m
    return k, nm_spmv.gather_plan(b, o, k, n, m, elt, sms=SMS)


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("o,k", MODEL + RAGGED)
def test_gather_splits_cover_k_exactly(o, k, nm):
    """Splits tile K with no gap and no empty split; each boundary is whole
    M-blocks, whole 16-byte x runs and whole 8-slot value loads, as the
    launcher demands; x's slice fits one CTA's shared memory (bf16 and
    f32, B 1, 8 and 9)."""
    n, m = nm
    for b, elt in itertools.product((1, 8, 9), (2, 4)):
        k, p = _plan(b, o, k, n, m, elt)
        assert p.kper % m == 0 and p.kper % 8 == 0
        assert p.kper // m * n % 8 == 0
        assert p.kper % nm_spmv.gather_unit(n, m) == 0
        bounds = [(z * p.kper, min(k, (z + 1) * p.kper))
                  for z in range(p.splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(hi > lo for lo, hi in bounds), "an empty split"
        assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:]))
        assert p.smem(elt) == p.kper * p.bg * elt <= SMEM_LIMIT


@pytest.mark.parametrize("o,k", [(1, 2048), (5, 2048), (8, 2048),
                                 (9, 2048), (200, 1032), (512, 2048),
                                 (576, 2048), (2048, 2048), (2816, 2048),
                                 (8192, 2048), (10944, 2048), (2048, 512),
                                 (288, 8192), (8192, 256), (14576, 3584),
                                 (768, 768), (512, 3584), (3584, 18944)])
@pytest.mark.parametrize("b", [1, 8, 9])
def test_gather_rows_cover_o_once(b, o, k):
    """A CTA takes 8 / kw row groups of 4 rows per pass, kw warps on each
    (one K part apiece): CTA g's pass i covers rows (g + ctas * i) *
    pass_rows .. + pass_rows.  Every output row of every split and batch
    group lands in exactly one pass of one CTA, every CTA has a row, and
    the K parts of a row group cover the split in whole 64-slot steps."""
    _, p = _plan(b, o, k, 2, 4)
    assert p.kw in (1, 2, 4, 8)
    pr = p.pass_rows()
    assert pr == WARPS // p.kw * nm_spmv.GATHER_ROWS
    cover = torch.zeros(o, dtype=torch.int32)
    for g in range(p.ctas):
        rows = [(g + p.ctas * i) * pr + r for i in range(-(-o // pr))
                for r in range(pr) if (g + p.ctas * i) * pr + r < o]
        assert rows, f"CTA {g} owns no row"
        cover[rows] += 1
    assert bool((cover == 1).all())
    es = min(p.kper, k) // 4 * 2                 # a split's slots per row
    ep = -(-es // (p.kw * nm_spmv.GATHER_STEP)) * nm_spmv.GATHER_STEP
    assert p.kw * ep >= es


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 9, 16, 17])
def test_gather_batch_groups(b):
    """The batch group is the smallest power of two covering min(B, 8), and
    the groups along grid.z cover B."""
    _, p = _plan(b, 2048, 2048, 2, 4)
    assert p.bg in (1, 2, 4, 8) and p.bg >= min(b, 8)
    assert p.bg == 1 or p.bg // 2 < min(b, 8)
    assert p.groups(b) * p.bg >= b > (p.groups(b) - 1) * p.bg


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)])
@pytest.mark.parametrize("o,k", MODEL)
@pytest.mark.parametrize("b", [1, 8, 9])
def test_gather_fills_every_sm_at_model_shapes(b, o, k, nm):
    """Every llama, deepseek, falcon-mamba, zamba2, whisper and qwen2-vl
    decode linear at B 1, 8 and 9, at 2:4 and the rerank draft's 1:4, puts
    at least one CTA on each of the 132 SMs."""
    n, m = nm
    _, p = _plan(b, o, k, n, m)
    assert p.total(b) >= SMS
    assert p.grid(b) == (p.ctas, p.splits, p.groups(b))
    # no CTA without a row: the last one starts below O
    assert (p.ctas - 1) * p.pass_rows() < o


def test_gather_plan_is_pure_in_shape_and_sms():
    p = nm_spmv.gather_plan(8, 512, 2048, 2, 4, 2, 132)
    assert nm_spmv.gather_plan(8, 512, 2048, 2, 4, 2, 132) == p
    assert p.splits > 1                 # O 512 alone cannot fill 132 SMs
    q = nm_spmv.gather_plan(8, 512, 2048, 2, 4, 2, 16)
    assert q.total(8) < p.total(8)      # fewer SMs, fewer CTAs


@pytest.mark.parametrize("b,o,k,nm", [(8, 512, 2048, (2, 4)),
                                      (8, 2048, 2048, (2, 4)),
                                      (9, 576, 2048, (1, 4))])
def test_launch_gather_hands_the_plan_over(monkeypatch, b, o, k, nm):
    """The launcher receives the plan's five ints, an f32 workspace [splits,
    B, O] and zeroed int32 arrival counters (one per row group) exactly
    when there is more than one split."""
    n, m = nm
    seen = []
    monkeypatch.setattr(nm_spmv.KERNEL, "launch",
                        lambda *args: seen.append(args))
    monkeypatch.setattr(nm_spmv, "_ARRIVALS", {})
    p = nm_spmv.gather_plan(b, o, k, n, m, 2, SMS)
    x = torch.zeros(b, k, dtype=torch.bfloat16)
    vals = torch.zeros(o, k // m * n, dtype=torch.bfloat16)
    idx = torch.zeros(o, k // m * n, dtype=torch.int8)
    y = nm_spmv.launch_gather(x, vals, idx, n, m, p)
    assert y.shape == (b, o) and y.dtype == torch.bfloat16
    (args,) = seen
    assert args[4:10] == (b, o, k, n, m, 1)
    assert tuple(args[10:15]) == tuple(p)
    if p.splits > 1:
        cnt = nm_spmv._ARRIVALS[torch.device("cpu")]
        assert args[15] is not None and args[16] == cnt.data_ptr()
        assert cnt.dtype == torch.int32 and bool((cnt == 0).all())
        assert cnt.numel() >= p.ctas * p.groups(b)
    else:
        assert args[15] is None and args[16] is None
    assert len(nm_spmv.KERNEL.argtypes) == len(args) + 1   # + the stream


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("o,k", LLAMA + DEEPSEEK)
@pytest.mark.parametrize("b", [1, 4, 8])
def test_row_shard_keeps_the_whole_shapes_splits(b, o, k, parts):
    """A tensor-parallel shard of O / parts rows launched under the whole
    shape's plan (``for_rows``) keeps its batch group, K splits, columns
    per split and warps per row group, so each row sums in the whole
    launch's order; its CTAs cover the shard's row groups and no more."""
    whole = nm_spmv.gather_plan(b, o, k, 2, 4, 2, SMS)
    shard = whole.for_rows(o // parts)
    assert (shard.bg, shard.kw, shard.splits, shard.kper) == \
        (whole.bg, whole.kw, whole.splits, whole.kper)
    rows = shard.pass_rows()
    assert 1 <= shard.ctas <= whole.ctas
    assert (shard.ctas - 1) * rows < o // parts <= shard.ctas * rows * 128


@pytest.mark.parametrize("b,o,k", [(8, 2048, 2048), (4, 512, 2048),
                                   (8, 8192, 2048)])
def test_sharded_wrapper_launches_the_whole_plan(monkeypatch, b, o, k):
    """``nm_spmv(..., plan_o=O)`` on a shard of O / 2 rows hands the
    launcher the whole shape's plan, restricted to the shard's rows."""
    seen = []
    monkeypatch.setattr(nm_spmv, "launch_gather",
                        lambda x, v, i, n, m, plan: seen.append(plan)
                        or torch.zeros(x.shape[0], v.shape[0]))
    monkeypatch.setattr(nm_spmv, "check_cuda_operand", lambda *a: None)
    monkeypatch.setattr(nm_spmv, "sm_count", lambda dev: SMS)
    x = torch.zeros(b, k, dtype=torch.bfloat16)
    vals = torch.zeros(o // 2, k // 2, dtype=torch.bfloat16)
    idx = torch.zeros(o // 2, k // 2, dtype=torch.int8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    nm_spmv.nm_spmv(x, vals, idx, 2, 4, plan_o=o)
    nm_spmv.nm_spmv(x, vals, idx, 2, 4)
    whole, own = seen
    assert whole == nm_spmv.gather_plan(b, o, k, 2, 4, 2, SMS).for_rows(o // 2)
    assert own == nm_spmv.gather_plan(b, o // 2, k, 2, 4, 2, SMS)
