"""Port parity: the training steps and the loop against the reference.
One and three ``make_train_step`` steps of a 2-layer f32 smoke llama from
converted weights (loss within 1e-5 relative, parameters and optimizer
state within 1e-4), ``grad_accum=2`` equal to 1, remat on against off
(equal gradients; the checkpoints counted), the learnable mapping's loss
drop, ``train_loop`` against the reference's on converted weights,
resume against an uninterrupted loop, the CLI on the CPU (no ``--device``
raises without a card, ``--mesh`` raises), the greedy prefill / decode
wrappers, train -> compress -> serve against the trained model's greedy
``forward``, and serving that records no autograd graph."""

import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.steps import make_decode_step as jmake_decode  # noqa: E402
from repro.launch.steps import make_prefill_step as jmake_prefill  # noqa: E402
from repro.launch.steps import make_train_step as jmake_step  # noqa: E402
from repro.launch.train import train_loop as jtrain_loop  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (from_reference_params,  # noqa: E402
                                 to_reference_opt_state, to_reference_tree)
from repro_torch.data import to_device  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step,
                                      named_params)
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import convert_to_compressed, forward  # noqa: E402
from repro_torch.models import init_caches, transformer  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.serve import (ServeEngine, serve_fixed_batch,  # noqa: E402
                               synthetic_trace)

ARCH = "llama3.2-1b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    return (jget(ARCH, smoke=True).replace(**kw),
            tget(ARCH, smoke=True).replace(**kw))


def _model(jc, tc, seed=0):
    params, _ = jinit(jax.random.PRNGKey(seed), jc)
    return params, from_reference_params(jax.tree.map(np.asarray, params),
                                         tc, device="cpu")


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaves(tree):
    return {tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got_tree, want_tree, **tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(n_steps):
    """``make_train_step`` on the same weights and batches as the
    reference's (2 layers, f32, lr past zero from the first step)."""
    jc, tc = _cfgs(n_layers=2, grad_accum=1)
    params, model = _model(jc, tc)
    jo = jadamw_init(params, JAdamW(master_weights=False))
    to = adamw_init(named_params(model), AdamWConfig(master_weights=False))
    jstep = jax.jit(jmake_step(jc, JAdamW(master_weights=False),
                               base_lr=1e-3, warmup=2))
    tstep = make_train_step(tc, AdamWConfig(master_weights=False),
                            base_lr=1e-3, warmup=2)
    for i in range(n_steps):
        b = _batch(i, 4, 16, jc.vocab)
        params, jo, jm = jstep(params, jo, jax.tree.map(jnp.asarray, b),
                               jnp.int32(i + 1))
        model, to, tm = tstep(model, to, to_device(b, "cpu"), i + 1)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close(to_reference_tree(dict(model.named_parameters())), params, **TOL)
    st = to_reference_opt_state(to)
    _close({"mu": st["mu"], "nu": st["nu"]}, {"mu": jo["mu"], "nu": jo["nu"]},
           **TOL)
    assert int(st["step"]) == int(jo["step"]) == n_steps


def test_grad_accum_equals_full_batch():
    """accum 2 on batch B == accum 1 on the same batch (the reference's
    test_grad_accum_equals_full_batch, on the port)."""
    jc, tc = _cfgs(n_layers=2, grad_accum=1)
    b = to_device(_batch(1, 4, 16, tc.vocab), "cpu")
    out = []
    for accum in (1, 2):
        _, model = _model(jc, tc)
        opt = adamw_init(named_params(model),
                         AdamWConfig(master_weights=False))
        step = make_train_step(tc.replace(grad_accum=accum),
                               AdamWConfig(master_weights=False))
        model, _, m = step(model, opt, b, 0)
        out.append((float(m["loss"]), dict(model.named_parameters())))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for k, p in out[0][1].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   out[1][1][k].detach().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("group", [0, 2])
def test_remat_gives_the_gradients_of_no_remat(group, monkeypatch):
    """Per-block checkpoints (and with ``remat_group`` 2 the two group
    checkpoints around them) recompute the same ops: the gradients equal
    those without remat, bit for bit; the checkpoints are counted."""
    jc, tc = _cfgs(n_layers=4, grad_accum=1)
    _, model = _model(jc, tc)
    b = to_device(_batch(2, 2, 16, tc.vocab), "cpu")
    calls = []
    real = transformer._checkpoint
    monkeypatch.setattr(transformer, "_checkpoint",
                        lambda fn, *a: calls.append(1) or real(fn, *a))
    _, off = steps_mod.loss_and_grads(model, tc.replace(remat=False), b)
    assert not calls
    _, on = steps_mod.loss_and_grads(
        model, tc.replace(remat=True, remat_group=group), b)
    # a block checkpoint per block; with groups, one per group, and the
    # group's recompute in the backward enters its blocks' checkpoints again
    assert len(calls) == (4 if not group else group + 4 + 4)
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_training_reduces_loss():
    """The reference's learnable mapping (label = token + 1 mod V), 40
    steps at base_lr 3e-3, warmup 5: the last five losses' mean is below
    the first five's less 1.0."""
    _, tc = _cfgs(n_layers=2, grad_accum=1)
    model = transformer.init_model(tc, seed=0, device="cpu")
    opt = adamw_init(named_params(model), AdamWConfig(master_weights=False))
    step = make_train_step(tc, AdamWConfig(master_weights=False),
                           base_lr=3e-3, warmup=5)
    rng = np.random.default_rng(0)
    losses = []
    for i in range(40):
        toks = torch.from_numpy(rng.integers(0, tc.vocab, (8, 32))).int()
        model, opt, m = step(model, opt, {"tokens": toks,
                                          "labels": (toks + 1) % tc.vocab}, i)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, \
        (losses[:5], losses[-5:])


def test_train_loop_matches_reference(monkeypatch):
    """``train_loop`` on the reference's initial weights (its draw carried
    over in place of the port's): the same losses (the same data stream,
    schedule and steps) within 1e-5."""
    want = jtrain_loop(ARCH, smoke=True, steps=6, batch=2, seq=16,
                       ckpt_dir="", log_every=100)
    jc, tc = _cfgs()
    _, model = _model(jc, tc)
    monkeypatch.setattr(train_mod, "init_model",
                        lambda cfg, seed, device: model)
    run = train_loop(ARCH, smoke=True, steps=6, batch=2, seq=16,
                     ckpt_dir="", log_every=100, device="cpu")
    np.testing.assert_allclose(run.losses, want, rtol=1e-5)
    assert len(run.step_seconds) == 6 and run.model is model


def test_resume_equals_uninterrupted(tmp_path, capsys):
    """Kill-and-resume reproduces the uninterrupted run (the reference's
    tolerance; on the CPU the parameters come out equal)."""
    full = train_loop(ARCH, smoke=True, steps=6, batch=2, seq=16,
                      ckpt_dir="", log_every=100, device="cpu")
    ck = str(tmp_path / "ck")
    first = train_loop(ARCH, smoke=True, steps=3, batch=2, seq=16,
                       ckpt_dir=ck, ckpt_every=3, log_every=100,
                       device="cpu")
    assert first.losses == full.losses[:3]
    resumed = train_loop(ARCH, smoke=True, steps=6, batch=2, seq=16,
                         ckpt_dir=ck, ckpt_every=100, log_every=100,
                         device="cpu")
    assert "resumed from step 3" in capsys.readouterr().out
    np.testing.assert_allclose(full.losses[3:], resumed.losses, rtol=2e-4,
                               atol=2e-5)
    for (k, a), (_, b) in zip(full.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), k
    assert sorted(p.name for p in pathlib.Path(ck).iterdir()) == [
        "step_0000000003", "step_0000000006"]


def test_cli_on_the_cpu(tmp_path, capsys):
    """The CLI with ``--device cpu`` trains and checkpoints; the log line
    and the final line print."""
    train_mod.main(["--arch", ARCH, "--smoke", "--steps", "6", "--batch",
                    "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path), "--ckpt-every", "4"])
    out = capsys.readouterr().out
    assert "final loss" in out and "ms/step" not in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000004", "step_0000000006"]


def test_cli_refusals():
    """Without ``--device`` the CLI asks for the card (no silent CPU
    fallback); ``--mesh`` names ROADMAP A4.  (Every family trains:
    ``tests/test_torch_train_families_serve.py`` runs the CLI for each.)"""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_mod.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="A4"):
        train_mod.main(["--arch", ARCH, "--smoke", "--steps", "1", "--mesh",
                        "--device", "cpu"])


def test_greedy_step_wrappers_match_reference():
    """``make_prefill_step`` / ``make_decode_step`` give the reference's
    greedy tokens (2 layers, f32, slotted caches)."""
    jc, tc = _cfgs(n_layers=2)
    params, model = _model(jc, tc)
    b = _batch(3, 2, 12, jc.vocab)
    jt, jcache = jmake_prefill(jc)(params, {"tokens": jnp.asarray(
        b["tokens"])})
    tt, tcache = make_prefill_step(tc)(model, to_device(
        {"tokens": b["tokens"]}, "cpu"))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    from repro.serve.cache import seed_decode_caches as jseed
    from repro_torch.serve import seed_decode_caches
    jcaches = jseed(jc, jinit_caches(jc, 2, 16)[0], jcache)
    tcaches = seed_decode_caches(tc, init_caches(tc, 2, 16, device="cpu"),
                                 tcache)
    jn, _ = jmake_decode(jc)(params, jcaches, jt, jnp.int32(12))
    tn, _ = make_decode_step(tc)(model, tcaches, tt.long(),
                                 torch.tensor(12))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert not tn.requires_grad


def _greedy_forward(model, cfg, reqs):
    """Greedy continuation of each request by full-sequence ``forward``."""
    out = {}
    with torch.no_grad():
        for r in reqs:
            toks = list(r.inputs["tokens"])
            for _ in range(r.max_new_tokens):
                logits, _ = forward(model, cfg, {"tokens": torch.tensor(
                    [toks], dtype=torch.int32)})
                toks.append(int(logits[0, -1].argmax()))
            out[r.rid] = toks[len(r.inputs["tokens"]):]
    return out


def test_train_compress_serve_equals_forward():
    """Train two steps, convert to the compressed format, serve through the
    paged engine: the tokens equal greedy decode by the trained srste
    model's ``forward``."""
    _, tc = _cfgs(n_layers=2, grad_accum=1)
    run = train_loop(ARCH, smoke=True, steps=2, batch=2, seq=16,
                     ckpt_dir="", log_every=100, device="cpu",
                     base_lr=3e-3, n_layers=2)
    reqs = synthetic_trace(tc, n_requests=3, prompt_len=12, gen_lens=[5, 3],
                           seed=4)
    want = _greedy_forward(run.model, tc, reqs)
    cfg_c = tc.replace(sparsity=dataclasses.replace(tc.sparsity,
                                                    mode="compressed"))
    served = convert_to_compressed(run.model, cfg_c)
    eng = ServeEngine(served, cfg_c, n_slots=2, max_len=24, kv="paged",
                      attn="fused", block_size=4, graphs=False, device="cpu")
    got = eng.run(reqs)
    for r in reqs:
        assert list(got[r.rid].tokens) == want[r.rid], r.rid


def _spy_logits(monkeypatch):
    seen = []
    real = transformer.lm_head_apply

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((out.requires_grad, torch.is_grad_enabled()))
        return out
    monkeypatch.setattr(transformer, "lm_head_apply", spy)
    return seen


@pytest.mark.parametrize("compressed", [False, True])
def test_serving_records_no_autograd(compressed, monkeypatch):
    """A model whose parameters require grad (as the trainer leaves them)
    served through the slotted and paged engines (graphs off) and the
    fixed-batch oracle: every logits tensor is free of autograd and the
    tokens equal those of the same weights with gradients off."""
    jc, tc = _cfgs(n_layers=2)
    _, model = _model(jc, tc)
    reqs = synthetic_trace(tc, n_requests=3, prompt_len=8, gen_lens=[4, 2],
                           seed=5)

    def serve_all():
        outs = []
        for kw in (dict(kv="slotted"), dict(kv="paged", attn="fused",
                                             block_size=4)):
            eng = ServeEngine(model, tc, n_slots=2, max_len=16,
                              compressed=compressed, graphs=False,
                              device="cpu", **kw)
            outs.append({k: list(v.tokens) for k, v in
                         eng.run(reqs).items()})
        res, _ = serve_fixed_batch(model, tc, reqs, device="cpu",
                                   graphs=False)
        outs.append({k: list(v.tokens) for k, v in res.items()})
        return outs

    before = serve_all()
    seen = _spy_logits(monkeypatch)
    named_params(model)                    # the trainer's state: grads on
    assert all(p.requires_grad for p in model.parameters())
    after = serve_all()
    assert seen and not any(req or grad for req, grad in seen)
    assert after == before


def test_serve_code_calls_no_backward():
    root = pathlib.Path(transformer.__file__).parents[1]
    for path in [*sorted((root / "serve").glob("*.py")),
                 root / "launch" / "serve.py"]:
        text = path.read_text()
        assert "backward(" not in text and "autograd.grad" not in text, path
