"""Helpers shared by the port's engine-against-reference test files (not a
test module: pytest collects nothing here).

* ``pair(arch, compressed, dtype)``: (reference cfg, reference params, port
  cfg, port model) at smoke size (f32 unless ``dtype``), the reference's
  jax.random weights carried over through ``repro_torch.convert``, the
  biases of a ``qkv_bias`` config drawn nonzero (``nonzero_biases``: the
  reference initialises them to zero, where a dropped bias cannot show);
  cached per process.
* ``one_thread``: an autouse fixture for the files that import it.  Smoke
  tensors gain nothing from torch's intra-op threads, which spin on every
  core while the suite's other workers share them, so those files run
  their torch ops on one thread (restored after each test);
  ``single_thread`` does the same around a block.
* ``ragged`` builds a trace of per-request prompt lengths and budgets;
  ``spec_engines`` runs the reference speculative engine, the port's and
  the port's non-speculative engine on one such trace.
* ``ref_engine`` / ``port_engine`` run the reference's or the port's
  engine over ``trace(cfg)`` (the reference's cached per process, run on
  one thread); ``make`` picks the reference's or the port's request
  function for a config.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import convert_to_compressed as jconvert
from repro.models import init_model as jinit
from repro.serve import ServeEngine as JEngine
from repro.serve import SpecConfig as JSpec
from repro.serve import synthetic_request as jrequest
from repro_torch.configs import get_config as tget
from repro_torch.convert import from_reference_params
from repro_torch.serve import ServeEngine, SpecConfig, synthetic_request

LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
_CACHE = {}


@contextlib.contextmanager
def single_thread():
    """torch's intra-op threads off inside the block (restored after), for
    module-scoped fixtures, which run outside ``one_thread``."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def one_thread():
    with single_thread():
        yield


def nonzero_biases(params, seed=1):
    """``params`` with every bias leaf ``b`` drawn from N(0, 0.5^2) (numpy,
    ``seed``), in its own dtype."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: (jax.numpy.asarray(rng.standard_normal(v.shape)
                                      .astype(np.float32) * 0.5, v.dtype)
                    if k == "b" else walk(v)) for k, v in tree.items()}
    return walk(params)


def pair(arch, compressed=False, dtype="float32"):
    """(reference cfg, reference params, port cfg, port model), smoke size,
    the same weights in both (nonzero biases where the config has them)."""
    key = (arch, compressed, dtype)
    if key not in _CACHE:
        jc = jget(arch, smoke=True).replace(dtype=dtype)
        tc = tget(arch, smoke=True).replace(dtype=dtype)
        if (arch, dtype) not in _CACHE:     # jitted: eager init takes seconds
            params = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(0))
            _CACHE[arch, dtype] = (nonzero_biases(params) if jc.qkv_bias
                                   else params)
        params = _CACHE[arch, dtype]
        if compressed:
            jc = jc.replace(sparsity=dataclasses.replace(
                jc.sparsity, mode="compressed"))
            tc = tc.replace(sparsity=dataclasses.replace(
                tc.sparsity, mode="compressed"))
            params = jax.jit(jconvert, static_argnums=(1,))(params, jc)
        model = from_reference_params(jax.tree.map(np.asarray, params), tc,
                                      device="cpu")
        _CACHE[key] = (jc, params, tc, model)
    return _CACHE[key]


def ragged(cfg, plens, gens, seed, make, spec=None):
    """Requests of prompt lengths ``plens`` and budgets ``gens`` drawn by
    ``make`` (the reference's or the port's ``synthetic_request``) from one
    seeded generator; ``spec`` sets each request's speculation opt-in."""
    rng = np.random.default_rng(seed)
    reqs = [make(cfg, rng, rid=i, prompt_len=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(plens, gens))]
    for r, on in zip(reqs, spec or ()):
        r.spec = on
    return reqs


def make(cfg, reference, port):
    """``reference`` for a reference config (it has ``jdtype``), else
    ``port``: one trace function serves both packages."""
    return reference if hasattr(cfg, "jdtype") else port


_REF = {}


def ref_engine(arch, trace, **kw):
    """The reference engine (``pair(arch)``'s weights) after running
    ``trace(cfg)``; cached per (arch, trace, options)."""
    key = (arch, trace.__name__, tuple(sorted(kw.items())))
    if key not in _REF:
        jc, params, _, _ = pair(arch)
        with single_thread():
            eng = JEngine(params, jc, **kw)
            eng.run(trace(jc))
        _REF[key] = eng
    return _REF[key]


def port_engine(arch, trace, **kw):
    """The port's engine on the CPU after running ``trace(cfg)``; a paged
    one has its invariants checked and every block back."""
    _, _, tc, model = pair(arch)
    eng = ServeEngine(model, tc, device="cpu", **kw)
    eng.run(trace(tc))
    if eng.pool is not None:
        eng.check_invariants()
        assert eng.pool.free_blocks == eng.pool.usable_blocks
    return eng


SPEC_KEYS = ("decode_steps", "tokens", "prefill_calls", "preemptions",
             "spec_proposed", "spec_accepted", "spec_steps_saved",
             "draft_steps", "draft_stream_bytes")


def spec_engines(arch, draft, plens, gens, seed, spec_on=None, **pool):
    """Token streams and stats of the reference spec engine, the port's
    spec engine and the port's non-spec engine on one trace (n_slots 2,
    k 3; prompts bucket down, so prompt catch-up rides the verify span).
    Returns (reference, port, port non-spec) as (results, stats) pairs."""
    jc, params, tc, model = pair(arch)
    kw = dict(n_slots=2, max_len=24, kv="paged", block_size=4,
              compressed=True, **pool)
    jeng = JEngine(params, jc, attn="gather", spec=JSpec(k=3, draft=draft),
                   **kw)
    jres = jeng.run(ragged(jc, plens, gens, seed, jrequest, spec_on))
    out = [(jres, jeng.stats())]
    for spec in (SpecConfig(k=3, draft=draft), None):
        teng = ServeEngine(model, tc, attn="fused", spec=spec,
                           debug_invariants=True, device="cpu", **kw)
        tres = teng.run(ragged(tc, plens, gens, seed, synthetic_request,
                               spec_on))
        assert teng.pool.free_blocks == teng.pool.usable_blocks
        out.append((tres, teng.stats()))
    return out


def assert_same_tokens(a, b, what):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].tokens, b[rid].tokens,
                                      err_msg=f"{what} rid {rid}")
