"""The port's examples (``repro_torch.examples``) and the fixed-batch
``launch.serve.serve``, on the CPU at small arguments, each with its own
asserts."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_engines import one_thread  # noqa: F401 (autouse)
from repro_torch.configs import get_config
from repro_torch.examples import (quickstart, serve_continuous, serve_decode,
                                  sparse_cnn_inference, train_sparse_lm)
from repro_torch.launch.serve import serve
from repro_torch.models import init_model
from repro_torch.serve import serve_fixed_batch, synthetic_trace


def test_serve_equals_serve_fixed_batch():
    toks, t_prefill, t_decode = serve("llama3.2-1b", True, 3, 8, 5, seed=2,
                                      device="cpu")
    cfg = get_config("llama3.2-1b", smoke=True)
    cfg = cfg.replace(sparsity=dataclasses.replace(cfg.sparsity,
                                                   mode="compressed"))
    reqs = synthetic_trace(cfg, n_requests=3, prompt_len=8, gen_lens=[5],
                           seed=2)
    res, _ = serve_fixed_batch(init_model(cfg, seed=2, device="cpu"), cfg,
                               reqs, device="cpu")
    assert toks.shape == (3, 5)
    np.testing.assert_array_equal(toks,
                                  np.stack([res[r.rid].tokens for r in reqs]))
    assert t_prefill > 0 and t_decode > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_serve_raises_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        serve("llama3.2-1b", True, 1, 4, 2)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain" in out and "generated (2, 8) tokens" in out
    assert out.rstrip().endswith("done.")


def test_serve_continuous(capsys):
    serve_continuous.main(["--device", "cpu", "--requests", "5",
                           "--slots", "2", "--prompt-len", "8",
                           "--gen-mix", "4,2,3"])
    out = capsys.readouterr().out
    cont = int(out.split("continuous: ")[1].split(" tokens")[0])
    assert cont == 4 + 2 + 3 + 4 + 2
    assert "sequential: same trace takes" in out


def test_serve_decode(capsys):
    serve_decode.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "token-for-token: MATCH" in out and "0.531x dense" in out


def test_sparse_cnn_inference(capsys):
    sparse_cnn_inference.main(["--device", "cpu", "--iters", "1"])
    out = capsys.readouterr().out
    err = float(out.split("max|err| = ")[1].split()[0])
    assert err < 1e-4 and "compressed" in out


def test_train_sparse_lm(tmp_path, capsys):
    run = train_sparse_lm.main(["--device", "cpu", "--steps", "3",
                                "--batch", "4", "--seq", "16",
                                "--ckpt-dir", str(tmp_path)])
    assert len(run.losses) == 3 and np.all(np.isfinite(run.losses))
    assert "preset=demo" in capsys.readouterr().out
    assert any(tmp_path.iterdir())          # the checkpoint
