"""Port parity: the optimizer and the loop for the MoE / MLA, gemma2, SSM,
hybrid, audio and vlm families, at smoke size in f32 unless named.

AdamW over a bf16 model's f32 leaves (router, mixer leaves, norm scales)
against the reference's, leaf by leaf; ``grad_accum=2`` equal to 1 (for
MoE, to the mean of its microbatches); ``train_loop`` resumed from a
checkpoint bit-equal to the uninterrupted loop; ``cut_depth``'s rules."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from _torch_engines import one_thread, pair  # noqa: E402,F401
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (from_reference_params,  # noqa: E402
                                 to_reference_opt_state, to_reference_tree)
from repro_torch.data import SyntheticLMData, to_device  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.steps import named_params  # noqa: E402
from repro_torch.launch.train import cut_depth, train_loop  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "gemma2-9b", "falcon-mamba-7b",
            "zamba2-7b", "whisper-small", "qwen2-vl-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_adamw_f32_leaves_of_a_bf16_model_match_reference(arch):
    """A bf16 model with f32 masters: the router, the mixers' f32 leaves
    and the norm scales stay f32 beside the bf16 weights.  Two updates from
    the same gradients (each in its parameter's dtype) as the reference's
    ``adamw_update``: master, mu and nu leaf by leaf within 1e-6, the
    parameters within one bf16 rounding, every dtype kept.  The global
    norm is held to 1e-4 relative: each package sums its ~1e6 squares in
    f32 in its own order."""
    jc = jget(arch, smoke=True).replace(dtype="bfloat16")
    tc = tget(arch, smoke=True).replace(dtype="bfloat16")
    params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(2))
    model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    named = named_params(model)
    f32 = {k for k, p in named.items() if p.dtype == torch.float32}
    assert any(k.endswith(("router", "A_log")) for k in f32)
    assert any(p.dtype == torch.bfloat16 for p in named.values())
    jcfg, tcfg = JAdamW(master_weights=True), AdamWConfig(master_weights=True)
    jst, st = jadamw_init(params, jcfg), adamw_init(named, tcfg)
    update = jax.jit(lambda g, s, p, lr: jadamw_update(g, s, p, lr, jcfg))
    rng = np.random.default_rng(3)
    for i in range(2):
        draws = {k: rng.standard_normal(p.shape).astype(np.float32) * 0.1
                 for k, p in named.items()}
        grads = {k: torch.from_numpy(g).to(named[k].dtype)
                 for k, g in draws.items()}
        jg = jax.tree.map(lambda g, p: jnp.asarray(g, p.dtype),
                          to_reference_tree(grads, tc), params)
        params, jst, jgn = update(jg, jst, params, 1e-2 * (i + 1))
        _, st, gn = adamw_update(grads, st, named, 1e-2 * (i + 1), tcfg)
        # the norm sums ~1e6 squares in f32 in another order than XLA's
        assert float(gn) == pytest.approx(float(jgn), rel=1e-4)
    assert {k for k, p in named.items() if p.dtype == torch.float32} == f32
    assert all(st[part][k].dtype == torch.float32 for part in
               ("master", "mu", "nu") for k in named)
    back = to_reference_opt_state(st, tc)
    for part in ("master", "mu", "nu"):
        _close(back[part], jst[part], rtol=1e-6, atol=1e-6)
    _close(to_reference_tree(named, tc), params, rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_grad_accum_equals_full_batch(arch):
    """accum 2 on batch B == accum 1 on the same batch (the reference's
    test_grad_accum_equals_full_batch, for each family's inputs).  An MoE
    layer's expert capacity and load-balance term are per call, in the
    reference too, so for deepseek accum 2 is held to what it is
    defined as: the mean of its two microbatches' losses and gradients."""
    _, params, tc, _ = pair(arch)
    b = to_device(SyntheticLMData(tc, 4, 16, seed=1).batch_at(0), "cpu")
    model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    loss2, g2 = loss_and_grads(model, tc, b, accum=2)
    if tc.n_experts:
        halves = [loss_and_grads(model, tc, {k: v[i:i + 2]
                                             for k, v in b.items()})
                  for i in (0, 2)]
        loss1 = (halves[0][0] + halves[1][0]) / 2
        g1 = {k: (halves[0][1][k].float() + halves[1][1][k].float()) / 2
              for k in g2}
    else:
        loss1, g1 = loss_and_grads(model, tc, b)
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-5)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].float().numpy(),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_resume_equals_uninterrupted(arch, tmp_path, capsys):
    """Kill-and-resume reproduces the uninterrupted loop bit for bit on the
    CPU: the new parameters (router, mixer leaves) are saved and
    restored, and so is the data cursor of each family's inputs."""
    kw = dict(smoke=True, batch=2, seq=16, log_every=100, device="cpu")
    full = train_loop(arch, steps=4, ckpt_dir="", **kw)
    ck = str(tmp_path / "ck")
    first = train_loop(arch, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    assert first.losses == full.losses[:2]
    resumed = train_loop(arch, steps=4, ckpt_dir=ck, ckpt_every=100, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.losses == full.losses[2:]
    for (k, a), (_, b) in zip(full.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch,ok,bad", [
    ("gemma2-9b", 2, 3),                 # whole local / global pairs
    ("zamba2-7b", 12, 9),                # whole groups of 6
    ("deepseek-v2-lite-16b", 2, 1),      # the dense layer and one MoE
    ("falcon-mamba-7b", 3, 0),
    ("whisper-small", 1, 0),
])
def test_cut_depth_keeps_each_family_structure(arch, ok, bad):
    cfg = tget(arch)
    assert cut_depth(cfg, ok).n_layers == ok
    with pytest.raises(ValueError, match="cannot cut"):
        cut_depth(cfg, bad)
    if cfg.family == "audio":
        cut = cut_depth(cfg, 2, enc_layers=3)
        assert (cut.n_layers, cut.enc_layers) == (2, 3)
    else:
        with pytest.raises(ValueError, match="enc_layers"):
            cut_depth(cfg, ok, enc_layers=2)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_f32_leaves_are_parameters_shared_when_served(arch):
    """The router and the mixers' conv / A_log / D / dt_bias are
    parameters (gradients off until the trainer turns them on), f32 in a
    bf16 model; the state dict holds every parameter and buffer by name
    (the checkpoint's keys); the compressed serving copy and the rerank
    draft share the tensors."""
    import dataclasses

    from repro_torch.models import (convert_to_compressed, init_model,
                                    make_draft)
    cfg = tget(arch, smoke=True).replace(dtype="bfloat16")
    model = init_model(cfg, seed=0, device="cpu")
    leaves = {n: p for n, p in model.named_parameters()
              if n.endswith(("router", "conv_w", "conv_b", "A_log", "D",
                             "dt_bias"))}
    assert leaves and all(p.dtype == torch.float32 and not p.requires_grad
                          for p in leaves.values())
    assert not any(n.endswith(tuple(k.rsplit(".", 1)[-1] for k in leaves))
                   for n, _ in model.named_buffers())
    assert set(model.state_dict()) == (
        {n for n, _ in model.named_parameters()}
        | {n for n, _ in model.named_buffers()})
    ccfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                    mode="compressed"))
    served = convert_to_compressed(model, ccfg)
    draft, _, _ = make_draft(served, ccfg, kind="rerank")
    for view in (served, draft):
        got = dict(view.named_parameters())
        assert all(got[n] is p for n, p in leaves.items())
