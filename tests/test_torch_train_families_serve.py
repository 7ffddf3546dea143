"""Port parity: train -> compress -> serve and the training CLI for the
MoE / MLA, gemma2, SSM, hybrid, audio and vlm families, at smoke size in
f32: the trained model compressed and served through the paged fused
engine, its tokens equal to greedy decode by its own ``forward``; the CLI
trains every family on the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_engines import one_thread  # noqa: E402,F401
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import convert_to_compressed, forward  # noqa: E402
from repro_torch.serve import ServeEngine, synthetic_trace  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "gemma2-9b", "falcon-mamba-7b",
            "zamba2-7b", "whisper-small", "qwen2-vl-7b"]


def _greedy_forward(model, cfg, reqs):
    """Greedy continuation of each request by full-sequence ``forward``
    (embeddings prompts extended by their generated tokens' embeddings;
    encoder frames passed whole)."""
    out = {}
    with torch.no_grad():
        for r in reqs:
            gen = []
            for _ in range(r.max_new_tokens):
                batch = {}
                if "embeds" in r.inputs:
                    new = model.embed.emb[torch.tensor(gen, dtype=torch.long)]
                    batch["embeds"] = torch.cat([torch.from_numpy(
                        r.inputs["embeds"]).to(new.dtype), new])[None]
                else:
                    batch["tokens"] = torch.tensor(
                        [list(r.inputs["tokens"]) + gen], dtype=torch.int32)
                if "enc_embeds" in r.inputs:
                    batch["enc_embeds"] = torch.from_numpy(
                        r.inputs["enc_embeds"])[None]
                logits, _ = forward(model, cfg, batch)
                gen.append(int(logits[0, -1].argmax()))
            out[r.rid] = gen
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_compress_serve_equals_forward(arch):
    """Train two steps, convert to the compressed format, serve through the
    paged fused engine: the tokens equal greedy decode by the trained
    srste model's ``forward``.  deepseek serves at a capacity factor of E
    (no route drops): ``forward`` and the engine batch tokens differently,
    so at the config's factor a route may drop in one and not the other."""
    run = train_loop(arch, smoke=True, steps=2, batch=2, seq=16,
                     ckpt_dir="", log_every=100, device="cpu", base_lr=3e-3)
    cfg = run.cfg
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    reqs = synthetic_trace(cfg, n_requests=3, prompt_len=12, gen_lens=[5, 3],
                           seed=4)
    want = _greedy_forward(run.model, cfg, reqs)
    cfg_c = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                     mode="compressed"))
    served = convert_to_compressed(run.model, cfg_c)
    eng = ServeEngine(served, cfg_c, n_slots=2, max_len=24, kv="paged",
                      attn="fused", block_size=4, graphs=False, device="cpu")
    got = eng.run(reqs)
    for r in reqs:
        assert list(got[r.rid].tokens) == want[r.rid], r.rid


@pytest.mark.parametrize("arch", FAMILIES)
def test_cli_trains_every_family_on_the_cpu(arch, capsys):
    train_mod.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                    "2", "--seq", "16", "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
