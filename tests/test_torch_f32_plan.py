"""The launch plan of the split-TF32 f32 body (``csrc/nm_tf32.cuh``):
``nm_spmm.f32_plan``, a pure function of the GEMM's shape and the SM count
that the f32 ``nm_xwt`` (int8 and packed) and ``nm_spmm`` wrappers pass to
their launchers, and the arithmetic of the split itself (why three TF32
passes).  CPU only: the kernel under the plan is checked on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import nm_spmm  # noqa: E402
from repro_torch.models.cnn import CNN_LAYER_GEMMS  # noqa: E402

SMS = 132
# (rows, cols, K) as the body sees them: compressed rows (C_out / O), dense
# columns (patches x batch / S), K rounded up to M
CNN = {(f"{net}/{name}", b): (co, sp * b, -(-k // 4) * 4)
       for net, layers in CNN_LAYER_GEMMS.items()
       for name, co, k, sp in layers for b in (1, 32)}
SERVE = {(f"serve O{o} K{k}", s): (o, s, k)
         for s in (4, 32, 128)
         for o, k in ((2048, 2048), (8192, 2048), (2048, 8192))}
RAGGED = {("ragged", i): shape for i, shape in enumerate(
    [(130, 96, 520), (64, 49, 148), (72, 37, 136), (200, 5, 1028),
     (1, 1, 64), (33, 1000, 1152 + 4), (1024, 196, 256)])}
SHAPES = {**CNN, **SERVE, **RAGGED}
NM = [(2, 4), (1, 4), (1, 2), (2, 8), (4, 8), (1, 8), (3, 4), (1, 16),
      (2, 32), (1, 64), (63, 64)]


def _plan(rows, cols, k, n=2, m=4):
    k = -(-k // m) * m
    plan = nm_spmm.f32_plan(rows, cols, k, n, m, sms=SMS)
    assert plan is not None
    return plan, k


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_plan_is_a_pure_function_of_the_shape(key):
    rows, cols, k = SHAPES[key]
    fresh = nm_spmm.f32_plan.__wrapped__
    assert fresh(rows, cols, k, 2, 4, SMS) == fresh(rows, cols, k, 2, 4, SMS) \
        == nm_spmm.f32_plan(rows, cols, k, 2, 4, sms=SMS)
    assert fresh(rows, cols, k, 2, 4, 66) is not None


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("key", sorted(SHAPES)[::2])
def test_splits_cover_k_once_in_whole_steps(key, nm):
    rows, cols, k = SHAPES[key]
    p, k = _plan(rows, cols, k, *nm)
    assert p.kper % 64 == 0
    bounds = [(z * p.kper, min(k, (z + 1) * p.kper)) for z in range(p.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(hi > lo for lo, hi in bounds), "an empty split"
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_every_output_in_exactly_one_tile(key):
    rows, cols, k = SHAPES[key]
    p, _ = _plan(rows, cols, k)
    gx, gy, _ = p.grid(rows, cols)
    assert gx * p.col_tile >= cols > (gx - 1) * p.col_tile
    assert gy * p.row_tile >= rows > (gy - 1) * p.row_tile
    assert p.row_tile == 32 * p.wm and p.col_tile == 32 * p.wn
    assert p.threads <= 256 and 3 <= p.stages <= 4
    assert p.row_tile == nm_spmm.f32_row_tile(rows)


@pytest.mark.parametrize("nm", NM)
@pytest.mark.parametrize("key", sorted(SHAPES)[::3])
def test_shared_memory_fits_one_cta(key, nm):
    """The plan's shared memory (the larger of either index format and
    either dense layout, so every launcher takes one plan) fits one CTA,
    and the launcher's own layout (``check_plan``) needs no more."""
    rows, cols, k = SHAPES[key]
    n, m = nm
    p, k = _plan(rows, cols, k, n, m)
    smem = nm_spmm.f32_smem_bytes(p, n, m)
    assert smem <= nm_spmm.SMEM_LIMIT == 232448
    ks = 64 if m == 64 else 32                 # K columns per stage
    e = ks // m * n
    per_word = 32 // nm_spmm.index_bits(m)
    for idx_row in (e, 4 * (-(-e // per_word) + 1)):       # int8, packed
        for dense in (p.col_tile * (ks + 4) * 4, ks * (p.col_tile + 8) * 4):
            stage = p.row_tile * (-(-4 * e // 16) * 16
                                  + -(-idx_row // 16) * 16) + dense
            need = 2 * p.row_tile * (ks + 4) * 4 + p.stages * (
                -(-stage // 128) * 128)
            assert need <= smem
    # two CTAs share an SM wherever a 3-stage ring allows it
    if nm_spmm.f32_smem_bytes(p._replace(stages=3), n, m) <= nm_spmm.HALF_SM:
        assert smem <= nm_spmm.HALF_SM


def _most(rows, cols, k):
    """The most CTAs any plan of the shape's row tile could launch."""
    bm = nm_spmm.f32_row_tile(rows)
    narrow = min(32 * wn for _, wn in nm_spmm.F32_TILES[bm])
    return -(-rows // bm) * -(-cols // narrow) * -(-k // 64)


@pytest.mark.parametrize("key", sorted(CNN) + sorted(SERVE))
def test_cnn_and_serving_shapes_fill_the_card(key):
    """Every CNN layer at batch 1 and 32 and every serving shape puts at
    least ~one wave of CTAs on the 132 SMs, or all that K and the tiles
    allow; and no other plan of the row tile that fills as well (and
    accumulates at most ``F32_MAX_KPER`` columns of K a CTA) has a
    smaller modelled time."""
    rows, cols, k = SHAPES[key]
    p, k = _plan(rows, cols, k)
    assert p.ctas(rows, cols) >= 0.9 * min(SMS, _most(rows, cols, k))
    assert p.kper <= nm_spmm.F32_MAX_KPER == 512
    best = nm_spmm.f32_cost(p, rows, cols, 2, 4, SMS)
    nst = -(-k // 64)
    for wm, wn in nm_spmm.F32_TILES[p.row_tile]:
        for s in range(1, nst + 1):
            per = -(-nst // s)
            if 64 * per > nm_spmm.F32_MAX_KPER:
                continue
            q = p._replace(wm=wm, wn=wn, splits=-(-nst // per),
                           kper=64 * per)
            if q.ctas(rows, cols) >= 0.9 * min(SMS, _most(rows, cols, k)):
                assert nm_spmm.f32_cost(q, rows, cols, 2, 4, SMS) \
                    >= best - 1e-12


@pytest.mark.parametrize("rows", [128, 4160, 8320])
@pytest.mark.parametrize("o,k", [(4096, 3584), (3584, 14336),
                                 (14336, 3584)])
def test_long_k_splits_into_short_accumulation_chains(rows, o, k):
    """gemma2-9b's f32 linears (K 3584 and 14336) at a verify span, a
    4160-token prefill and the oracle's 2 x 4160: no CTA accumulates more
    than 512 columns of K (the tensor cores' f32 accumulation drifts with
    the chain; one CTA over all 14336 moved four layers' logits by 2.9e-3
    on the card), and the splits cover K once."""
    p = nm_spmm.f32_plan(o, rows, k, 2, 4, sms=SMS)
    assert p.kper <= 512 and p.splits * p.kper >= k
    assert (p.splits - 1) * p.kper < k


def test_deep_k_at_batch_1_splits_k():
    """resnet50 conv5_3x3 at batch 1 (R 512, K 4608, 49 columns): 4 row
    tiles alone would leave the card nearly empty, so K is split."""
    rows, cols, k = CNN[("resnet50/conv5_3x3", 1)]
    p, _ = _plan(rows, cols, k)
    assert p.splits > 1 and p.ctas(rows, cols) >= 0.9 * SMS


def test_plan_is_none_off_the_body():
    assert nm_spmm.f32_plan(0, 64, 2048, 2, 4) is None
    assert nm_spmm.f32_plan(64, 0, 2048, 2, 4) is None
    assert nm_spmm.f32_plan(64, 64, 2050, 2, 4) is None    # K % M
    assert nm_spmm.f32_plan(64, 64, 2048, 4, 4) is None    # N < M


@pytest.mark.parametrize("rows,o,k", [(128, 2048, 2048), (4, 512, 2048),
                                      (3136, 64, 576), (49, 512, 4608)])
@pytest.mark.parametrize("nm", [(2, 4), (2, 8), (1, 2)])
def test_int8_packed_and_spmm_launch_one_plan(monkeypatch, rows, o, k, nm):
    """The f32 int8 and packed nm_xwt wrappers hand their launchers the
    same plan (O compressed rows, the X rows as dense columns): one tile,
    one split, one summation order."""
    from repro_torch.kernels import ops
    n, m = nm
    seen = []
    monkeypatch.setattr(nm_spmm, "launch_planned",
                        lambda kern, x, v, i, n_, m_, plan:
                        seen.append((kern.name, plan)) or torch.zeros(0))
    monkeypatch.setattr(nm_spmm, "sm_count", lambda dev: SMS)
    x = torch.zeros(rows, k)
    vals = torch.zeros(o, k // m * n)
    idx = torch.zeros(o, k // m * n, dtype=torch.int8)
    words = ops.pack_block_indices(idx, n, m, (8, 64, 160 if m == 8 else 512))
    nm_spmm.launch_xwt(nm_spmm.KERNEL, x, vals, idx, n, m)
    nm_spmm.launch_xwt(nm_spmm.PACKED_KERNEL, x, vals, words, n, m)
    (k1, p1), (k2, p2) = seen
    assert (k1, k2) == ("nm_xwt", "nm_xwt_packed")
    assert p1 == p2 == nm_spmm.f32_plan(o, rows, k, n, m, sms=SMS)
    assert isinstance(p1, nm_spmm.F32Plan)


def test_plan_args_carry_the_f32_plan_and_its_workspace():
    """An F32Plan reaches the launcher as its five ints, its shared memory
    and six zeros in the twelve plan slots, with the split workspace."""
    p = nm_spmm.f32_plan(512, 49, 4608, 2, 4, sms=SMS)
    args, ws = nm_spmm.plan_args(p, 512, 49, 2, 4, False,
                                 torch.device("cpu"))
    assert args[:5] == tuple(p) and args[5] == nm_spmm.f32_smem_bytes(p, 2, 4)
    assert args[6:12] == (0,) * 6 and args[12] == ws.data_ptr()
    assert ws.shape == (p.splits, 512, 49) and ws.dtype == torch.float32
    assert len(args) == len(nm_spmm._PLAN_ARGS) - 10
    assert nm_spmm.SPMM_KERNEL.argtypes[:-1] == nm_spmm._PLAN_ARGS


# ------------------------------------------------- the split's arithmetic


def _tf32_rna(x):
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32):
    the low 13 mantissa bits rounded off by their bits."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x):
    """f32 -> TF32 by clearing the low 13 mantissa bits: the kernel's hi
    part, and how the tensor cores read an f32 operand's top 19 bits."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_sum(pairs, k):
    """Sum of the products of each (a [R, K], b [C, K]) pair as the tensor
    cores take them, k-step by k-step of 8: each step's products exact,
    added to an f32 accumulator in pair order."""
    acc = np.zeros((pairs[0][0].shape[0], pairs[0][1].shape[0]), np.float32)
    for k0 in range(0, k, 8):
        for a, b in pairs:
            step = a[:, k0:k0 + 8].astype(np.float64) \
                @ b[:, k0:k0 + 8].astype(np.float64).T
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def _within(got, want):
    return bool(np.all(np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)))


@pytest.mark.parametrize("k", [148, 1152, 4608])
def test_three_tf32_passes_meet_1e4_where_one_does_not(k):
    """W at K^-0.5, 2:4-pruned (half zeros), X standard normal, as the card
    checks draw them: the kernel's split (hi = x with its low 13 mantissa
    bits cleared, lo = x - hi read as TF32; lo.hi, hi.lo, then hi.hi into
    one f32 sum) lands within 1e-4 abs + 1e-4 rel of the f64 product; a
    single TF32 product (both operands rounded to nearest once) does
    not."""
    rng = np.random.default_rng(k)
    w = (rng.standard_normal((64, k)) * k ** -0.5).astype(np.float32)
    blocks = np.abs(w).reshape(64, k // 4, 4)
    drop = np.argsort(blocks, axis=-1)[..., :2]
    mask = np.ones_like(blocks, dtype=bool)
    np.put_along_axis(mask, drop, False, axis=-1)
    w = w * mask.reshape(64, k)
    x = rng.standard_normal((96, k)).astype(np.float32)
    want = w.astype(np.float64) @ x.astype(np.float64).T
    wh, xh = _tf32_trunc(w), _tf32_trunc(x)
    wl, xl = _tf32_trunc(w - wh), _tf32_trunc(x - xh)
    three = _mma_sum([(wl, xh), (wh, xl), (wh, xh)], k)
    one = _mma_sum([(_tf32_rna(w), _tf32_rna(x))], k)
    assert _within(three, want)
    assert not _within(one, want)
    # with room: the three passes sit far inside the gate
    gate = 1e-4 + 1e-4 * np.abs(want)
    assert float(np.max(np.abs(three - want) / gate)) < 0.1
