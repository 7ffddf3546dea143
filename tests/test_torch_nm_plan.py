"""The launch plans of the tensor-core tile body (``csrc/nm_mma.cuh``):
``nm_spmm.mma_plan``, a pure function of the shape and the SM count, which
the bf16 ``nm_xwt`` (int8 and packed) and onehot ``nm_spmv`` wrappers pass
to their launchers.  CPU only: the plan is checked here, the kernels under
it on the card (``tests/test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import nm_spmm, nm_spmv  # noqa: E402
from repro_torch.models.cnn import CNN_LAYER_GEMMS  # noqa: E402

SMS = 132
TARGET = 2 * SMS
# (O, K) of one llama3.2-1b layer and one deepseek-v2-lite layer (with the
# dense first layer's MLP and the latent up-projections, K 512)
LLAMA = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
DEEPSEEK = [(3072, 2048), (576, 2048), (2048, 2048), (2816, 2048),
            (2048, 2816), (2048, 512), (10944, 2048), (2048, 10944)]
MODEL = sorted(set(LLAMA + DEEPSEEK))
# falcon-mamba-7b's in / x / dt / out projections (x_proj's 288 rows and
# zamba2-7b's 14576 are not multiples of a tile; dt_proj's K is 256) and
# zamba2-7b's Mamba2 in / out and shared attention + MLP linears
SSM = [(16384, 4096), (288, 8192), (8192, 256), (4096, 8192),
       (14576, 3584), (3584, 7168), (3584, 3584), (14336, 3584),
       (3584, 14336)]
# whisper-small's linears (q, k, v, o at K 768, the MLP's 3072 x 768 and
# 768 x 3072), which its encoder and cross_kv run at the 1500 frames (11
# row tiles of 128 and a ragged last one), and qwen2-vl-7b's (k / v 512
# rows, the down projection's K 18944)
WHISPER = [(768, 768), (3072, 768), (768, 3072)]
QWEN2_VL = [(3584, 3584), (512, 3584), (18944, 3584), (3584, 18944)]
FRAMES = 1500
# CNN GEMMs as nm_xwt sees them (rows = spatial, O = C_out, K rounded up
# to M as the layer pads it), bf16 case
CNN = sorted({(sp, co, -(-k // 4) * 4) for layers in CNN_LAYER_GEMMS.values()
              for _, co, k, sp in layers})
RAGGED = [(37, 200, 136), (129, 72, 1028), (5, 300, 520), (33, 96, 2052),
          (1, 64, 64), (130, 96, 520)]

CASES = ([(r, o, k, False) for o, k in MODEL + SSM + WHISPER + QWEN2_VL
          for r in (1, 8, 32, 128)]
         + [(8, o, k, True) for o, k in MODEL + SSM + WHISPER + QWEN2_VL]
         + [(FRAMES, o, k, False) for o, k in WHISPER]
         + [(r, o, k, False) for r, o, k in CNN + RAGGED]
         + [(r, o, k, True) for r, o, k in RAGGED if r <= 8])


@pytest.mark.parametrize("rows", [1, 8, 128, 4160])
@pytest.mark.parametrize("o", [288, 14576])
def test_ragged_last_tile_covers_the_output_rows(o, rows):
    """x_proj's 288 and zamba2's in_proj 14576 rows: the grid's last
    column tile starts inside O; where the tile does not divide O (the
    wide prefill tiles) it ends past it, and the kernel's row guard, not
    the grid, trims it (the card holds the result against the plain
    version, chip_smoke phase 2)."""
    k = 8192 if o == 288 else 3584
    p = _plan(rows, o, k, rows == 8)
    gx, _, _ = p.grid(rows, o)
    assert (gx - 1) * p.col_tile < o <= gx * p.col_tile
    if rows >= 128:
        assert o % p.col_tile


@pytest.mark.parametrize("o,k", WHISPER)
def test_ragged_frame_rows_are_covered(o, k):
    """The encoder's 1500 frames: the grid's last row tile starts inside
    the rows and ends past them (the kernel's row guard trims it)."""
    p = _plan(FRAMES, o, k, False)
    _, gy, _ = p.grid(FRAMES, o)
    assert (gy - 1) * p.row_tile < FRAMES < gy * p.row_tile


def _plan(rows, o, k, decode, n=2, m=4):
    plan = nm_spmm.mma_plan(rows, o, k, n, m, sms=SMS, decode=decode)
    assert plan is not None
    return plan


@pytest.mark.parametrize("nm", nm_spmm.FAST_NM)
@pytest.mark.parametrize("rows,o,k,decode", CASES)
def test_splits_cover_k_in_whole_steps(rows, o, k, decode, nm):
    n, m = nm
    k = -(-k // m) * m
    p = _plan(rows, o, k, decode, n, m)
    assert p.kper % 64 == 0 and p.kper % m == 0
    bounds = [(z * p.kper, min(k, (z + 1) * p.kper)) for z in range(p.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(hi > lo for lo, hi in bounds), "an empty split"
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    # every split but the last is whole stages of the ring
    assert p.kper % (64 * p.ss) == 0


@pytest.mark.parametrize("rows,o,k,decode", CASES)
def test_every_output_in_exactly_one_tile(rows, o, k, decode):
    p = _plan(rows, o, k, decode)
    gx, gy, _ = p.grid(rows, o)
    cover = torch.zeros(rows, o, dtype=torch.int32)
    for by in range(gy):
        for bx in range(gx):
            cover[by * p.row_tile:(by + 1) * p.row_tile,
                  bx * p.col_tile:(bx + 1) * p.col_tile] += 1
    assert bool((cover == 1).all())
    # the warps tile the CTA's rows and columns, and fit one CTA
    assert p.row_tile == 8 * p.nt * p.ws and p.col_tile == 32 * p.wo
    assert p.threads <= 256 and p.nt in (1, 4, 8) and 2 <= p.stages <= 4
    assert p.ss in (1, 2, 4)
    for n, m in nm_spmm.FAST_NM:         # the ring fits one CTA
        assert nm_spmm.smem_bytes(p, n, m) <= nm_spmm.SMEM_LIMIT
    if decode:
        assert p.nt == 1 and p.ws == 1      # the batch on n = 8


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("nm", nm_spmm.FAST_NM)
@pytest.mark.parametrize("rows,o,k,decode", CASES[::3])
def test_stage_layout_holds_its_tiles(rows, o, k, decode, nm, packed):
    """The stage layout the wrapper passes holds what ``check_layout``
    (``csrc/nm_mma.cuh``) demands: 16-byte strides wide enough for a
    staged row of values, indices and X, a 128-byte stage holding the
    three tiles, and a ring within ``smem_bytes``; the X rows of one
    16-byte phase on distinct banks."""
    n, m = nm
    k = -(-k // m) * m
    p = _plan(rows, o, k, decode, n, m)
    vs, ist, xs, stage = nm_spmm.layout(p, n, m, packed)
    e = 64 * p.ss // m * n
    per_word = 32 // nm_spmm.index_bits(m)
    assert vs % 16 == ist % 16 == xs % 16 == stage % 128 == 0
    assert vs >= 2 * e and xs >= 2 * 64 * p.ss and xs % 128 == 16
    assert ist >= (4 * (-(-e // per_word) + 8) if packed else e)
    assert stage >= p.col_tile * (vs + ist) + p.row_tile * xs
    slots = min(p.stages, -(-p.kper // (64 * p.ss)))
    assert slots * stage <= nm_spmm.smem_bytes(p, n, m) <= nm_spmm.SMEM_LIMIT
    # the two index formats differ only in the index tile
    other = nm_spmm.layout(p, n, m, not packed)
    assert (other[0], other[2]) == (vs, xs)


def _fill(rows, o, k, decode):
    """(plan, resident slots of the card, most CTAs K allows)."""
    p = _plan(rows, o, k, decode)
    nst = -(-k // (64 * p.ss))
    full = p._replace(splits=1, kper=64 * p.ss * nst)
    slots = SMS * nm_spmm.resident(full, 2, 4)
    tiles = p.ctas(rows, o) // p.splits
    return p, slots, tiles * nst


@pytest.mark.parametrize("rows,o,k,decode", CASES)
def test_splits_fill_the_resident_slots_where_k_allows(rows, o, k, decode):
    """Fewer CTAs than the card holds at once only where K runs out of
    stages, and never so many that a last wave runs nearly empty: the
    split count minimises waves x stages per CTA."""
    p, slots, most = _fill(rows, o, k, decode)
    ctas = p.ctas(rows, o)
    assert ctas >= min(slots, most) // 2
    nst = -(-k // (64 * p.ss))
    per = p.kper // (64 * p.ss)
    cost = -(-ctas // slots) * per
    for s in range(1, nst + 1):        # no split count does better
        q_per = -(-nst // s)
        q_ctas = ctas // p.splits * -(-nst // q_per)
        assert -(-q_ctas // slots) * q_per >= cost


# one gemma2-9b layer's linears (O, K)
GEMMA2 = [(4096, 3584), (2048, 3584), (3584, 4096), (14336, 3584),
          (3584, 14336)]


@pytest.mark.parametrize("o,k", GEMMA2 + SSM[4:])
@pytest.mark.parametrize("rows", [128, 4096, 4160, 8320])
def test_split_partials_stay_within_their_limit(o, k, rows):
    """gemma2-9b's prefill shapes (a 4096 bucket, a 4160 prompt, the
    oracle's 2 x 4160): the f32 split partials stay within
    SPLIT_WS_LIMIT (without it the waves' rounding picked 112 splits,
    6.1 GiB, for wd at 4096 rows, and the oracle's 8320 rows ran the card
    out of memory), and among the split counts under it none does better
    in waves x stages per CTA."""
    p, slots, most = _fill(rows, o, k, False)
    assert p.splits == 1 or \
        p.splits * rows * o * 4 <= nm_spmm.SPLIT_WS_LIMIT == 256 << 20
    nst = -(-k // (64 * p.ss))
    ctas = p.ctas(rows, o)
    cost = -(-ctas // slots) * (p.kper // (64 * p.ss))
    for s in range(1, nst + 1):
        q_per = -(-nst // s)
        q_splits = -(-nst // q_per)
        if q_splits > 1 and q_splits * rows * o * 4 > nm_spmm.SPLIT_WS_LIMIT:
            continue
        q_ctas = ctas // p.splits * q_splits
        assert -(-q_ctas // slots) * q_per >= cost


@pytest.mark.parametrize("o,k", MODEL + SSM + WHISPER + QWEN2_VL)
@pytest.mark.parametrize("rows,decode", [(8, True), (32, False),
                                         (128, False)])
def test_model_shapes_put_about_two_ctas_per_sm(o, k, rows, decode):
    """Every model's decode, verify-span and prefill shape puts
    about 2 x 132 CTAs on the card (or all that its resident slots and K
    allow)."""
    p, slots, most = _fill(rows, o, k, decode)
    assert p.ctas(rows, o) >= 0.9 * min(TARGET, slots, most)


@pytest.mark.parametrize("rows,o,k", [(128, 2048, 2048), (32, 512, 2048),
                                      (8, 8192, 2048), (129, 300, 2560)])
@pytest.mark.parametrize("nm", [(2, 4), (2, 8), (1, 2)])
def test_int8_and_packed_launch_one_plan(monkeypatch, rows, o, k, nm):
    """The int8 and packed wrappers hand their launchers the same plan
    (one tile, one split, one summation order: the same bits)."""
    from repro_torch.kernels import ops
    n, m = nm
    seen = []
    monkeypatch.setattr(nm_spmm, "launch_planned",
                        lambda kern, x, v, i, n_, m_, plan:
                        seen.append((kern.name, plan)) or torch.zeros(0))
    monkeypatch.setattr(nm_spmm, "sm_count", lambda dev: SMS)
    x = torch.zeros(rows, k, dtype=torch.bfloat16)
    vals = torch.zeros(o, k // m * n, dtype=torch.bfloat16)
    idx = torch.zeros(o, k // m * n, dtype=torch.int8)
    words = ops.pack_block_indices(idx, n, m, (8, 64, 160 if m == 8 else 512))
    nm_spmm.launch_xwt(nm_spmm.KERNEL, x, vals, idx, n, m)
    nm_spmm.launch_xwt(nm_spmm.PACKED_KERNEL, x, vals, words, n, m)
    (k1, p1), (k2, p2) = seen
    assert (k1, k2) == ("nm_xwt", "nm_xwt_packed")
    assert p1 == p2 == nm_spmm.mma_plan(rows, o, k, n, m, sms=SMS)


def test_plan_is_none_off_the_tensor_core_body():
    """N:M the body is not built for (and non-positive sizes) take the
    first body: the launchers receive nt = 0 and no workspace."""
    assert nm_spmm.mma_plan(8, 64, 2048, 3, 4) is None
    assert nm_spmm.mma_plan(8, 64, 2048, 1, 32) is None
    assert nm_spmm.mma_plan(0, 64, 2048, 2, 4) is None
    args, ws = nm_spmm.plan_args(None, 8, 64, 3, 4, False,
                                 torch.device("cpu"))
    assert args == (0,) * 12 + (None,) and ws is None


def test_plan_args_allocate_the_split_workspace():
    p = nm_spmm.mma_plan(32, 512, 2048, 2, 4, sms=SMS)
    assert p.splits > 1
    args, ws = nm_spmm.plan_args(p, 32, 512, 2, 4, False,
                                 torch.device("cpu"))
    assert args[:8] == tuple(p) and args[12] == ws.data_ptr()
    assert args[8:12] == nm_spmm.layout(p, 2, 4, packed=False)
    assert ws.shape == (p.splits, 32, 512) and ws.dtype == torch.float32


def test_onehot_takes_the_decode_plan():
    """The onehot wrapper's plan keeps the batch on n = 8: B 16 is two
    8-row tiles along grid.y, not one 16-row tile."""
    p = nm_spmm.mma_plan(16, 2048, 2048, 2, 4, sms=SMS, decode=True)
    assert p.nt == 1 and p.grid(16, 2048)[1] == 2
    assert nm_spmv.ONEHOT_KERNEL.argtypes[:-1] == nm_spmm._PLAN_ARGS
    assert len(nm_spmm._PLAN_ARGS) == 23


@pytest.mark.parametrize("rows,decode", [(1, False), (8, False), (32, False),
                                         (128, False), (8, True)])
@pytest.mark.parametrize("o,k", LLAMA + DEEPSEEK)
def test_row_shard_launch_takes_the_whole_shapes_plan(monkeypatch, rows,
                                                      decode, o, k):
    """A tensor-parallel shard of O / 2 rows given the whole O
    (``plan_o``) launches under the whole shape's plan: the same K splits
    and columns per split, so each output sums in the whole launch's
    order; its own tiles are cut from the shard's rows."""
    seen = []
    monkeypatch.setattr(nm_spmm, "launch_planned",
                        lambda kern, x, v, i, n_, m_, plan:
                        seen.append(plan) or torch.zeros(0))
    monkeypatch.setattr(nm_spmm, "sm_count", lambda dev: SMS)
    x = torch.zeros(rows, k, dtype=torch.bfloat16)
    vals = torch.zeros(o // 2, k // 2, dtype=torch.bfloat16)
    idx = torch.zeros(o // 2, k // 2, dtype=torch.int8)
    if decode:
        monkeypatch.setattr(nm_spmv, "launch_planned",
                            lambda kern, x, v, i, n_, m_, plan:
                            seen.append(plan) or torch.zeros(rows, o // 2))
        monkeypatch.setattr(nm_spmv, "check_cuda_operand", lambda *a: None)
        monkeypatch.setattr(nm_spmv, "sm_count", lambda dev: SMS)
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda t: True))
        nm_spmv.nm_spmv(x, vals, idx, 2, 4, mode="onehot", plan_o=o)
    else:
        nm_spmm.launch_xwt(nm_spmm.KERNEL, x, vals, idx, 2, 4, plan_o=o)
    (plan,) = seen
    whole = nm_spmm.mma_plan(rows, o, k, 2, 4, sms=SMS, decode=decode)
    assert plan == whole
    assert (plan.splits, plan.kper) == (whole.splits, whole.kper)
    own = nm_spmm.mma_plan(rows, o // 2, k, 2, 4, sms=SMS, decode=decode)
    assert plan.grid(rows, o // 2)[2] == whole.splits
    assert own is not None


@pytest.mark.parametrize("o,k", LLAMA + DEEPSEEK)
@pytest.mark.parametrize("cols", [1, 8, 128])
def test_row_shard_f32_launch_takes_the_whole_shapes_plan(monkeypatch, o, k,
                                                          cols):
    """The f32 split-TF32 body likewise: a shard given the whole O runs
    the whole shape's K splits (at most ``F32_MAX_KPER`` columns a CTA)."""
    seen = []
    monkeypatch.setattr(nm_spmm, "launch_planned",
                        lambda kern, x, v, i, n_, m_, plan:
                        seen.append(plan) or torch.zeros(0))
    monkeypatch.setattr(nm_spmm, "sm_count", lambda dev: SMS)
    x = torch.zeros(cols, k, dtype=torch.float32)
    vals = torch.zeros(o // 2, k // 2, dtype=torch.float32)
    idx = torch.zeros(o // 2, k // 2, dtype=torch.int8)
    nm_spmm.launch_xwt(nm_spmm.KERNEL, x, vals, idx, 2, 4, plan_o=o)
    (plan,) = seen
    assert plan == nm_spmm.f32_plan(o, cols, k, 2, 4, SMS)
