"""The port's dry-run (``launch.dryrun`` and what it runs): ``run_cell``
at smoke configs on small abstract meshes for one arch of each family
and each kind; the abstract mesh's counts against a real 4-rank gloo run
of the same step; decode under ``DEFAULT_RULES`` / ``MULTIPOD_RULES``
with FSDP gathers on real ranks against the single-device step and the
reference's; ``gather_compressed``; ``report`` / ``postprocess`` /
``finalize_experiments`` against the reference's; ``hillclimb.VARIANTS``
against the reference's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import batch as train_batch
from _torch_engines import one_thread, pair  # noqa: F401 (autouse)
from _torch_tp import run_ranks
from repro.configs import get_config as jget
from repro.launch import postprocess as jpost
from repro.launch import report as jreport
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as tget
from repro_torch.dist.api import (DEFAULT_RULES, MULTIPOD_RULES, axis_rules,
                                  make_abstract_mesh, make_shardings)
from repro_torch.launch import dryrun, finalize_experiments, postprocess
from repro_torch.launch import report
from repro_torch.launch import steps as tsteps
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import shard_for_training
from repro_torch.optim import AdamWConfig, adamw_init

SMALL = {"train_4k": ShapeSpec("train_4k", 16, 8, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 32, 4, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 32, 8, "decode"),
         "long_500k": ShapeSpec("long_500k", 64, 1, "decode")}
FAMILIES = ["llama3.2-1b", "deepseek-v2-lite-16b", "gemma2-9b",
            "falcon-mamba-7b", "zamba2-7b", "whisper-small", "qwen2-vl-7b"]
KEYS = {"arch", "shape", "mesh", "kind", "status", "chips", "lower_s",
        "compile_s", "params_total", "params_active", "hlo_cost",
        "xla_cost_raw", "memory", "roofline", "sparse_weights"}


@pytest.fixture
def small_cells(monkeypatch):
    """Smoke configs, small shapes and a (2, 2) / (2, 2, 2) abstract mesh
    in place of the production ones."""
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tget(a, smoke=True))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_abstract_mesh(
                            (2, 2, 2) if multi_pod else (2, 2)))


@pytest.mark.parametrize("shape", list(SMALL))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_records(small_cells, arch, shape):
    multi = FAMILIES.index(arch) % 2 == 1        # half the cells multi-pod
    rec = dryrun.run_cell(arch, shape, multi)
    ok, _ = dryrun.cell_supported(tget(arch), shape)
    if not ok:
        assert rec["status"] == "SKIP" and rec["reason"]
        return
    assert rec["status"] == "OK"
    assert KEYS <= set(rec) and rec["chips"] == (8 if multi else 4)
    assert set(rec["hlo_cost"]) == {"flops", "bytes", "collective_bytes",
                                    "collectives_by_type", "op_counts",
                                    "loops"}
    assert rec["hlo_cost"]["flops"] > 0 and rec["hlo_cost"]["bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    if SMALL[shape].kind != "train":
        assert rec["hlo_cost"]["op_counts"].get("nm_matmul", 0) > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["params_total"] == pytest.approx(
        rec["params_total"]) and rec["params_active"] > 0


def test_cli_writes_records(small_cells, tmp_path, monkeypatch, capsys):
    out = tmp_path / "d.json"
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "llama3.2-1b,falcon-mamba-7b", "--shape",
        "decode_32k,long_500k", "--mesh", "both", "--out", str(out),
        "--save-hlo", str(tmp_path / "ops.txt")])
    dryrun.main()
    recs = json.load(open(out))
    assert [r["status"] for r in recs] == ["OK", "OK", "SKIP", "SKIP",
                                           "OK", "OK", "OK", "OK"]
    assert "DONE: 6 OK, 2 SKIP, 0 FAIL" in capsys.readouterr().out
    assert open(tmp_path / "ops.txt").read().split()[0]


# ------------------------------------------- the abstract mesh = real ranks

B, MAXLEN, STEPS = 4, 16, 3

_STEPS = r'''
def body(mesh, path):
    from repro_torch.dist.api import (DEFAULT_RULES, MULTIPOD_RULES,
                                      axis_rules, batch_axis,
                                      make_shardings, make_train_mesh)
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import tensor_bytes
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.transformer import (init_caches,
                                                shard_for_training)
    from repro_torch.optim import AdamWConfig, adamw_init
    results = []
    for model, cfg, data, shape, rules_name, kind in torch.load(
            path, weights_only=False):
        tmesh = make_train_mesh(shape, device="cpu")
        rules = {"default": DEFAULT_RULES, "multipod": MULTIPOD_RULES}[
            rules_name]
        out = {}
        with axis_rules(tmesh, rules):
            if kind == "train":
                skel, lay = shard_for_training(model, tmesh)
                ocfg = AdamWConfig(master_weights=False)
                opt = adamw_init(steps.named_params(skel), ocfg)
                sh = make_shardings({k: ("act_batch",) for k in data},
                                    tmesh, rules, data)
                b = {k: sh[k](torch.from_numpy(v)) for k, v in data.items()}
                step = steps.make_train_step(cfg, ocfg, param_specs=lay)
                args = (skel, opt, b, 1)
            else:
                skel, lay = shard_for_training(model, tmesh, serve=True)
                caches = steps.local_caches(
                    init_caches(cfg, data.shape[0], %d, device="cpu"),
                    tmesh, rules)
                sh = make_shardings(("act_batch",), tmesh, rules, data)
                tok = sh(torch.from_numpy(data))
                step = steps.make_decode_step(cfg, param_specs=lay)
                args = (skel, caches, tok,
                        torch.tensor(0, dtype=torch.int32))
            out["arg_bytes"] = tensor_bytes(args)
            tmesh.reset_stats()
            with OpCost(tmesh) as cost:
                res = step(*args)
            out["cost"] = [cost.flops, cost.bytes,
                           cost.result()["collectives_by_type"]]
            if kind != "train":
                toks = [res[0].tolist()]
                for i in range(1, %d):
                    toks.append(step(skel, caches, res[0],
                                     torch.tensor(i, dtype=torch.int32))[0]
                                .tolist())
                    res = (torch.tensor(toks[-1], dtype=torch.int32),)
                out["tokens"] = toks
                out["batch_rank"] = batch_axis().rank
        results.append(out)
    return results
''' % (MAXLEN, STEPS)

# (arch, mesh shape, rules, kind) of the real-rank jobs, one child for all
JOBS = [("llama3.2-1b", (2, 2), "default", "decode"),
        ("llama3.2-1b", (2, 1, 2), "multipod", "decode"),
        ("gemma2-9b", (2, 2), "default", "decode"),
        ("gemma2-9b", (2, 1, 2), "multipod", "decode"),
        ("llama3.2-1b", (2, 2), "default", "train")]


def _first_tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, B).astype(
        np.int32)


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    """Every job of ``JOBS`` on 4 gloo ranks: [rank][job] results."""
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = []
    for arch, shape, rules, kind in JOBS:
        _, _, tc, model = pair(arch, compressed=kind != "train")
        data = train_batch(tc) if kind == "train" else _first_tokens(tc)
        jobs.append((model, tc, data, shape, rules, kind))
    torch.save(jobs, tmp / "jobs.pt")
    return run_ranks(_STEPS, 4, tmp / "out", tmp / "jobs.pt", timeout=600)


def _abstract(arch, shape, rules, kind, data):
    """(argument bytes, [FLOPs, bytes, collectives]) of rank 0's step on
    the abstract mesh of ``shape`` over ``meta`` tensors."""
    _, _, tc, _ = pair(arch, compressed=kind != "train")
    mesh = make_abstract_mesh(shape)
    model = ttfm.init_model(tc, device="meta")
    with axis_rules(mesh, rules):
        if kind == "train":
            skel, lay = shard_for_training(model, mesh)
            ocfg = AdamWConfig(master_weights=False)
            opt = adamw_init(tsteps.named_params(skel), ocfg)
            sh = make_shardings({k: ("act_batch",) for k in data}, mesh,
                                rules, data)
            b = {k: sh[k](torch.from_numpy(v).to("meta"))
                 for k, v in data.items()}
            step = tsteps.make_train_step(tc, ocfg, param_specs=lay)
            args = (skel, opt, b, 1)
        else:
            skel, lay = shard_for_training(model, mesh, serve=True)
            caches = tsteps.local_caches(ttfm.init_caches(
                tc, data.shape[0], MAXLEN, device="meta"), mesh, rules)
            tok = make_shardings(("act_batch",), mesh, rules, data)(
                torch.from_numpy(data).to("meta"))
            step = tsteps.make_decode_step(tc, param_specs=lay)
            args = (skel, caches, tok, torch.tensor(0, dtype=torch.int32,
                                                    device="meta"))
        with OpCost(mesh) as cost:
            step(*args)
    return dryrun.tensor_bytes(args), [cost.flops, cost.bytes,
                                        cost.result()["collectives_by_type"]]


def _ref_tokens(arch, first):
    jc, jp, _, _ = pair(arch, compressed=True)
    step = jax.jit(jsteps.make_decode_step(jc))
    caches = jtfm.init_caches(jc, first.shape[0], MAXLEN)[0]
    tok, out = jnp.asarray(first), []
    for i in range(STEPS):
        tok, caches = step(jp, caches, tok, jnp.int32(i))
        out.append(np.asarray(tok))
    return np.stack(out)


def _port_tokens(arch, first):
    _, _, tc, model = pair(arch, compressed=True)
    step = tsteps.make_decode_step(tc)
    caches = ttfm.init_caches(tc, first.shape[0], MAXLEN, device="cpu")
    tok, out = torch.from_numpy(first), []
    for i in range(STEPS):
        tok, caches = step(model, caches, tok, torch.tensor(i))
        out.append(tok.numpy())
    return np.stack(out)


@pytest.mark.parametrize("job", [i for i, j in enumerate(JOBS)
                                 if j[3] == "decode"])
def test_decode_on_real_ranks(real_ranks, job):
    """A decode step on real gloo ranks under the 2-D / multi-pod rules
    with FSDP gathers gives the single-device step's tokens and the
    reference's (f32), and rank 0 counts what the abstract mesh counts."""
    arch, shape, rules_name, _ = JOBS[job]
    _, _, tc, _ = pair(arch, compressed=True)
    first = _first_tokens(tc)
    want = _port_tokens(arch, first)
    np.testing.assert_array_equal(want, _ref_tokens(arch, first))
    for ranks in real_ranks:
        res, part = ranks[job], B // 2
        idx = res["batch_rank"]
        np.testing.assert_array_equal(
            np.asarray(res["tokens"]), want[:, idx * part:(idx + 1) * part])
    rules = {"default": DEFAULT_RULES, "multipod": MULTIPOD_RULES}[
        rules_name]
    arg, cost = _abstract(arch, shape, rules, "decode", first)
    assert real_ranks[0][job]["arg_bytes"] == arg
    assert real_ranks[0][job]["cost"] == cost
    if rules_name == "default":
        assert cost[2]["all-gather"] > 0          # the FSDP gathers


def test_train_step_counts_equal_real_ranks(real_ranks):
    """A (2, 2) training step: the abstract mesh's collective bytes,
    FLOPs, bytes and argument bytes are rank 0's of a real gloo run."""
    job = [j[3] for j in JOBS].index("train")
    arch = JOBS[job][0]
    _, _, tc, _ = pair(arch)
    arg, cost = _abstract(arch, (2, 2), DEFAULT_RULES, "train",
                          train_batch(tc))
    got = real_ranks[0][job]
    assert got["arg_bytes"] == arg
    flops, nbytes, coll = got["cost"]
    assert (flops, coll) == (cost[0], cost[2])
    # the schedule's 0-d learning rate is made on the host and copied to
    # the step's device (meta, or the card), which a CPU step skips
    assert cost[1] - nbytes == 8
    assert set(cost[2]) == {"all-gather", "reduce-scatter", "all-reduce"}


def test_gather_compressed_moves_the_compressed_stream():
    """Under the abstract (2, 2) mesh a decode step gathers each split
    compressed leaf as values + indices (True) or as the dense view of its
    shard (False): the gathered bytes differ by exactly the leaves'
    dense - compressed bytes."""
    cfg = tget("llama3.2-1b", smoke=True)
    mesh = make_abstract_mesh((2, 2))
    got = {}
    for gc in (False, True):
        c = tsteps.serve_config(cfg.replace(sparsity=dataclasses.replace(
            cfg.sparsity, gather_compressed=gc)))
        with axis_rules(mesh, DEFAULT_RULES):
            model = ttfm.init_model(c, device="meta")
            skel, lay = shard_for_training(model, mesh, serve=True)
            caches = tsteps.local_caches(ttfm.init_caches(
                c, 4, 16, device="meta"), mesh, DEFAULT_RULES)
            tok = torch.zeros(2, dtype=torch.int32, device="meta")
            with OpCost(mesh) as cost:
                tsteps.make_decode_step(c, param_specs=lay)(
                    skel, caches, tok, torch.tensor(0, device="meta"))
        got[gc] = cost.result()["collectives_by_type"]["all-gather"]
    dense = packed = 0
    for name, t in skel.named_buffers():
        if name.endswith("w_vals") and lay[name].split:
            idx = dict(skel.named_buffers())[name[:-4] + "idx"]
            dense += t.numel() * cfg.sparsity.m // cfg.sparsity.n \
                * t.element_size()
            packed += t.numel() * t.element_size() + idx.numel()
    assert packed and dense > packed
    assert got[False] - got[True] == dense - packed    # n - 1 = 1 peer


# ------------------------------------------------- report and its tools

@pytest.fixture(scope="module")
def records():
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "SHAPES", SMALL)
    mp.setattr(dryrun, "get_config", lambda a: tget(a, smoke=True))
    mp.setattr(dryrun, "make_production_mesh",
               lambda multi_pod=False: make_abstract_mesh(
                   (2, 2, 2) if multi_pod else (2, 2)))
    try:
        with torch.no_grad():
            torch.set_num_threads(1)
            recs = [dryrun.run_cell(a, s, m)
                    for a in ("llama3.2-1b", "falcon-mamba-7b")
                    for s in ("decode_32k", "long_500k") for m in (False,
                                                                   True)]
        recs.append({"arch": "x", "shape": "train_4k", "mesh": "16x16",
                     "status": "FAIL", "error": "RuntimeError: boom"})
        return recs
    finally:
        mp.undo()


def test_report_text_equals_reference(records):
    for mesh in (None, "16x16", "2x16x16"):
        assert report.render(records, mesh) == jreport.render(records, mesh)
    assert report.render_sparse(records) == jreport.render_sparse(records)
    assert report.summarize(records) == jreport.summarize(records)


def test_postprocess_recompute_equals_reference(records):
    for rec in records:
        if rec["status"] != "OK":
            continue
        got = postprocess.recompute(json.loads(json.dumps(rec)))
        want = jpost.recompute(json.loads(json.dumps(rec)))
        for k in ("params_total", "params_active", "roofline",
                  "sparse_weights"):
            if k == "roofline":      # the same counts over other peaks
                assert got[k]["model_flops"] == want[k]["model_flops"]
            else:
                assert got[k] == want[k], k


def test_postprocess_and_finalize_in_a_tmp_dir(records, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    os.makedirs("results")
    json.dump(records, open("results/dryrun_final.json", "w"))
    json.dump(records[:2], open("results/dryrun_optimized.json", "w"))
    monkeypatch.setattr("sys.argv", ["postprocess", "results/merged.json",
                                     "results/dryrun_final.json"])
    postprocess.main()
    assert len(json.load(open("results/merged.json"))) == len(records)
    open("EXPERIMENTS.md", "w").write(
        "# E\n<!-- DRYRUN_TABLES_START -->\nold\n"
        "<!-- DRYRUN_TABLES_END -->\ntail\n")
    finalize_experiments.main()
    md = open("EXPERIMENTS.md").read()
    assert "old" not in md and md.endswith("<!-- DRYRUN_TABLES_END -->"
                                           "\ntail\n")
    assert report.render(records, "16x16") in md
    assert os.path.exists("results/dryrun_optimized_final.json")
    assert "EXPERIMENTS.md updated" in capsys.readouterr().out


def test_hillclimb_variants_equal_reference(monkeypatch):
    """Every variant names the reference's cell, rules and pregather, and
    its ``mutate`` on the port's config sets the fields the reference's
    sets on the reference's."""
    # the reference module sets XLA_FLAGS on import; monkeypatch undoes it
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.hillclimb import VARIANTS as JV
    from repro_torch.launch.hillclimb import VARIANTS as TV
    assert list(TV) == list(JV)
    for name, jv in JV.items():
        tv = TV[name]
        assert {k: v for k, v in tv.items() if k != "mutate"} == \
            {k: v for k, v in jv.items() if k != "mutate"}, name
        assert ("mutate" in tv) == ("mutate" in jv)
        if "mutate" in jv:
            jc, tc = jv["mutate"](jget(jv["arch"])), tv["mutate"](
                tget(tv["arch"]))
            for f in dataclasses.fields(tc):
                if f.name == "sparsity":
                    for g in dataclasses.fields(tc.sparsity):
                        assert getattr(tc.sparsity, g.name) == \
                            getattr(jc.sparsity, g.name), (name, g.name)
                else:
                    assert getattr(tc, f.name) == getattr(jc, f.name), \
                        (name, f.name)
