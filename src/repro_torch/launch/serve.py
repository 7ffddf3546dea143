"""Serving CLI of the port (counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --scheduler continuous --weights compressed --kv paged --attn fused

runs the continuous-batching engine over the paged pool on the card
(``--device cuda``, the default; ``--device cpu`` runs the plain path).
The defaults are the reference's: ``--scheduler sequential --kv slotted
--attn gather``, the fixed-batch oracle (``serve.sequential``); ``--scheduler
continuous --kv slotted`` is the engine over the slotted layout.  ``--arch
deepseek-v2-lite-16b`` serves the MoE family with MLA attention, ``--arch
gemma2-9b`` the local / global windowed pairs with softcaps and post norms
(its slotted local layers keep rings of the window), ``--arch
falcon-mamba-7b`` the SSM family (Mamba1) and ``--arch zamba2-7b`` the
hybrid (Mamba2 groups with one shared windowed attention block; both keep
their recurrent state one row per slot, so they take no ``--spec`` and no
prefix hit), ``--arch whisper-small`` the audio family (an encoder-decoder:
each request carries encoder frames beside its tokens, whose cross K/V
stay one row per slot, so it takes no ``--spec``) and ``--arch
qwen2-vl-7b`` the vlm family (prompts of precomputed embeddings,
prefilled at the bucket above their length); for both ``--prefix-cache``
raises, its shared-prefix trace being token-only; ``deepseek-67b``, ``mistral-large-123b``
and ``arctic-480b`` are registered too; ``--spec``
adds self-speculative decoding (``--spec-k`` drafts per verify, ``--draft
rerank|skip``).  ``--prefix-cache`` shares cached prompt prefixes across
requests (the trace becomes shared-prefix: 3/4 of ``--prompt-len`` is one
of ``--prefix-mix`` system prompts); ``--preempt suspend`` swaps a
preempted request's blocks to host and resumes it instead of replaying
it.  On the card every engine entry point runs as CUDA graphs;
``--prewarm`` captures the engine's complete graph set before the first
admission, and
``--compile-cache [DIR]`` builds and loads the kernels in DIR (default
``$REPRO_COMPILE_CACHE``, else the package's build directory), so a second
bring-up skips nvcc.  The compile line reports the capture bill.  Weights
are random, from ``--seed``.

Tensor-parallel serving (every arch of the registry): ``--tp N`` (or
``--mesh model=N``) serves over N ranks, one process each, every rank
running the continuous engine on its shard in lockstep; rank 0 prints.
On its own, ``--tp N`` starts the N processes itself (a localhost
process group); ``--distributed`` joins a group started elsewhere, from
``--coordinator host:port --num-processes N --process-id R`` or the
torchrun environment.  ``--backend`` is ``nccl`` (the default
on the card; one card per rank) or ``gloo`` (the default with ``--device
cpu``; on the card it stages through host memory, so several ranks can
share one card, eager).  ``--tp-collective ring`` (what ``auto`` means
for compressed weights) rotates the compressed N:M shards of every decode
linear; ``gspmd`` multiplies the local rows and all-gathers.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --scheduler continuous --kv paged --tp 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.dist.api import free_port, init_from_env, make_serve_mesh
from repro_torch.models import convert_to_compressed, init_model
from repro_torch.serve import (ServeEngine, SpecConfig, serve_fixed_batch,
                               serve_sequential, shared_prefix_trace,
                               synthetic_trace)
from repro_torch.serve.prewarm import enable_compile_cache


def _load(arch: str, smoke: bool, impl: str, seed: int = 0,
          mode: str = "compressed", device="cuda"):
    cfg = get_config(arch, smoke=smoke)
    cfg = cfg.replace(sparsity=dataclasses.replace(
        cfg.sparsity, mode=mode, impl=impl))
    return cfg, init_model(cfg, seed=seed, device=device)


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, impl: str = "auto", device="cuda"):
    """Fixed-batch serve (the reference's ``serve``): returns (tokens
    [B, gen] numpy, t_prefill_seconds, t_decode_seconds_per_token),
    through ``serve_fixed_batch`` on a compressed model drawn from
    ``seed``; ``impl`` pins the N:M product ('auto': the kernels on the
    card, the plain path on the CPU)."""
    cfg, model = _load(arch, smoke, impl, seed, device=device)
    reqs = synthetic_trace(cfg, n_requests=batch, prompt_len=prompt_len,
                           gen_lens=[gen], seed=seed)
    results, stats = serve_fixed_batch(model, cfg, reqs, device=device)
    toks = np.stack([results[r.rid].tokens for r in reqs])
    return toks, stats["t_prefill"], stats["t_per_decode"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheduler", default="sequential",
                    choices=["sequential", "continuous"])
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: one batch of --slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gen-mix", default="",
                    help="comma list of gen budgets cycled over the trace")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--impl", default="auto",
                    help="sparse-matmul impl ('auto': kernels on the card by "
                         "shape, plain on the CPU; 'ref' pins the oracle)")
    ap.add_argument("--weights", default="compressed",
                    choices=["dense", "compressed"])
    ap.add_argument("--kv", default="slotted", choices=["slotted", "paged"],
                    help="'paged' serves through the block-table KV pool "
                         "(continuous scheduler only); 'slotted' is the "
                         "whole-row oracle layout")
    ap.add_argument("--attn", default="gather", choices=["gather", "fused"],
                    help="paged decode attention read: 'fused' walks the "
                         "block table inside the kernel, 'gather' is the "
                         "oracle read (requires --kv paged for 'fused')")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=0,
                    help="physical block count incl. the trash block "
                         "(0 = full provisioning)")
    ap.add_argument("--preempt", default="replay",
                    choices=["replay", "suspend"],
                    help="pool-exhaustion policy: 'replay' requeues the "
                         "victim and replays it from prefill; 'suspend' "
                         "swaps its blocks to host and resumes it bit-exact")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="keep retired requests' KV blocks in a radix index "
                         "over prompt tokens; a prompt sharing a cached "
                         "prefix skips prefill for the shared span "
                         "(refcounted blocks, copy-on-write)")
    ap.add_argument("--prefix-mix", type=int, default=1,
                    help="with --prefix-cache: number of distinct shared "
                         "system prompts in the trace (3/4 of --prompt-len "
                         "shared, 1/4 per-request suffix)")
    ap.add_argument("--spec", action="store_true",
                    help="self-speculative decoding: a cheap draft view of "
                         "the served model proposes --spec-k tokens per slot "
                         "per tick, the target verifies them in one forward, "
                         "and greedy acceptance keeps the non-speculative "
                         "token stream")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="with --spec: draft tokens proposed per verify")
    ap.add_argument("--draft", default="rerank", choices=["rerank", "skip"],
                    help="with --spec: 'rerank' re-ranks the compressed N:M "
                         "weights to 1:M (needs --weights compressed), "
                         "'skip' keeps every other layer")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel width: serve over N ranks on a "
                         "('model',) mesh, one process each (0 = single "
                         "device; continuous scheduler only).  Alone it "
                         "starts the N processes itself")
    ap.add_argument("--mesh", default="",
                    help="the mesh as 'model=N' (the serving TP axis; other "
                         "axes must be 1).  Overrides --tp")
    ap.add_argument("--tp-collective", default="auto",
                    choices=["auto", "ring", "gspmd"],
                    help="TP collective of compressed decode linears: 'ring' "
                         "rotates the compressed N:M shards, 'gspmd' "
                         "multiplies the local rows and all-gathers, 'auto' "
                         "= ring when compressed")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on the "
                         "card, gloo with --device cpu)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group started elsewhere: from "
                         "--coordinator/--num-processes/--process-id, else "
                         "the torchrun environment")
    ap.add_argument("--coordinator", default=None,
                    help="with --distributed: rendezvous host:port")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="with --distributed: total process count")
    ap.add_argument("--process-id", type=int, default=None,
                    help="with --distributed: this process's rank")
    ap.add_argument("--prewarm", action="store_true",
                    help="capture every entry point's graphs before the "
                         "first admission")
    ap.add_argument("--compile-cache", nargs="?", const="auto", default=None,
                    help="kernel build directory kept across processes "
                         "(bare flag: $REPRO_COMPILE_CACHE or the package's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    tp = _mesh_size(args.mesh) if args.mesh else args.tp

    continuous = args.scheduler == "continuous"
    if (args.prefix_cache or args.preempt != "replay") and (
            args.kv != "paged" or not continuous):
        raise SystemExit("--prefix-cache/--preempt suspend require --kv paged "
                         "with --scheduler continuous (both operate on the "
                         "block pool)")
    if (tp or args.distributed) and not continuous:
        raise SystemExit("--tp/--mesh require --scheduler continuous (the "
                         "sequential oracle is single-device by design)")
    if args.spec:
        if tp or args.distributed:
            raise SystemExit("--spec does not support --tp/--mesh yet")
        if args.kv != "paged" or not continuous:
            raise SystemExit("--spec requires --kv paged with --scheduler "
                             "continuous (speculative rollback rewinds the "
                             "block table)")
        if args.draft == "rerank" and args.weights != "compressed":
            raise SystemExit("--draft rerank re-ranks the compressed pool: "
                             "use --weights compressed (or --draft skip)")
    if args.prewarm and not continuous:
        raise SystemExit("--prewarm requires --scheduler continuous (the "
                         "sequential oracle has no enumerable shape set)")
    if not continuous:
        if args.kv == "paged":
            raise SystemExit("--kv paged requires --scheduler continuous "
                             "(the sequential oracle is slotted by design)")
        if args.attn == "fused":
            raise SystemExit("--attn fused requires --kv paged with "
                             "--scheduler continuous (the fused kernel reads "
                             "through the block table)")
    if tp > 1 and not args.distributed:
        # one process per rank over a localhost group; each rerun of this
        # command joins it with --distributed
        import torch.multiprocessing as mp
        mp.start_processes(_rank_main, args=(argv, tp, free_port()),
                           nprocs=tp, start_method="spawn")
        return
    mesh = None
    if tp or args.distributed:
        backend = args.backend or ("gloo" if args.device == "cpu"
                                   else "nccl")
        if args.distributed:
            if args.device == "cpu" and args.num_processes:
                # each rank takes its share of the cores for its intra-op
                # threads (every rank on every core oversubscribes them)
                torch.set_num_threads(
                    max(1, (os.cpu_count() or 1) // args.num_processes))
            init_from_env(backend, args.coordinator, args.num_processes,
                          args.process_id)
        mesh = make_serve_mesh(tp or None, backend=backend,
                               device=args.device)
    import torch.distributed as dist
    try:
        _serve(args, mesh)
        if mesh is not None:
            dist.barrier()      # no rank tears down while a peer still talks
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _mesh_size(spec: str) -> int:
    """'model=N[,axis=1...]' -> N (the serving mesh has one axis)."""
    sizes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size.isdigit():
            raise SystemExit(f"--mesh: bad entry {part!r} (want axis=size, "
                             f"e.g. model=4)")
        sizes[name.strip()] = int(size)
    if "model" not in sizes:
        raise SystemExit("--mesh must include a 'model' axis (the serving "
                         "TP axis)")
    if any(v != 1 for k, v in sizes.items() if k != "model"):
        raise SystemExit(f"--mesh {spec}: the port's serving mesh has one "
                         f"axis, 'model'; other axes must be 1")
    return sizes["model"]


def _rank_main(rank: int, argv, n: int, port: int) -> None:
    """One rank of ``--tp N``: this command again, joined to the group."""
    main(list(argv) + ["--distributed", "--coordinator",
                       f"127.0.0.1:{port}", "--num-processes", str(n),
                       "--process-id", str(rank)])


def _serve(args, mesh) -> None:
    continuous = args.scheduler == "continuous"
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    device = args.device if mesh is None else mesh.device
    if args.compile_cache is not None:
        # before anything builds, so the kernels land in (or load from) it
        say(f"compile cache: {enable_compile_cache(args.compile_cache)}")

    cfg = get_config(args.arch, smoke=args.smoke)
    # weights are born dense (srste semantics) so both --weights settings
    # serve the same model: 'compressed' packs it offline at engine init
    cfg = cfg.replace(sparsity=dataclasses.replace(
        cfg.sparsity, mode="srste", impl=args.impl))
    # a rank of a mesh draws the model on its card (the numbers of a
    # single-device run), packs it there when serving compressed (the
    # packing the engine would do), and keeps it on the host: the engine
    # moves only the rank's shard to the card
    drawn = cfg
    if mesh is not None and args.weights == "compressed":
        drawn = cfg.replace(sparsity=dataclasses.replace(
            cfg.sparsity, mode="compressed"))
    model = init_model(drawn, seed=args.seed, device=device,
                       store=None if mesh is None else "cpu")
    gen_lens = ([int(g) for g in args.gen_mix.split(",")] if args.gen_mix
                else [args.gen])
    n_req = args.requests or args.slots
    if args.prefix_cache:
        pre = max(1, args.prompt_len * 3 // 4)
        reqs = shared_prefix_trace(cfg, n_requests=n_req, prefix_len=pre,
                                   suffix_len=args.prompt_len - pre,
                                   gen_lens=gen_lens, seed=args.seed,
                                   arrival_every=args.arrival_every,
                                   n_prefixes=args.prefix_mix)
    else:
        reqs = synthetic_trace(cfg, n_requests=n_req,
                               prompt_len=args.prompt_len, gen_lens=gen_lens,
                               seed=args.seed,
                               arrival_every=args.arrival_every)
    max_len = args.prompt_len + max(gen_lens)
    if not continuous:
        if args.weights == "compressed":
            model = convert_to_compressed(model, cfg)
            cfg = cfg.replace(sparsity=dataclasses.replace(
                cfg.sparsity, mode="compressed"))
        results, stats = serve_sequential(model, cfg, reqs, args.slots,
                                          max_len=max_len, device=device)
        toks = sum(len(r.tokens) for r in results.values())
        print(f"sequential[{args.weights}]: {toks} tokens in "
              f"{int(stats['decode_steps'])} decode steps")
        print("sample:", results[min(results)].tokens[:12].tolist())
        return
    eng = ServeEngine(model, cfg, n_slots=args.slots,
                      max_len=max_len, compressed=args.weights == "compressed", kv=args.kv,
                      block_size=args.block_size,
                      n_blocks=args.blocks or None, attn=args.attn,
                      prefix_cache=args.prefix_cache, preempt=args.preempt,
                      prewarm=args.prewarm,
                      spec=(SpecConfig(k=args.spec_k, draft=args.draft)
                            if args.spec else None),
                      mesh=mesh, tp_collective=args.tp_collective,
                      device=device)
    del model                      # the engine holds what it serves
    t0 = time.perf_counter()
    results = eng.run(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    mode = "prewarmed" if args.prewarm else "lazy"
    say(f"compile[{mode}, {'graphs' if eng.graphs else 'eager'}]: "
          f"{int(st['prewarmed_executables'])} prewarmed + "
          f"{int(st['mid_serve_compiles'])} mid-serve of "
          f"{int(st['executables_expected'])} expected executables, "
          f"{st['compile_seconds']:.2f}s capture bill (bring-up "
          f"{st['init_seconds']:.2f}s), first tick "
          f"{st['first_tick_s'] * 1e3:.1f}ms vs steady "
          f"{st['steady_tick_s'] * 1e3:.1f}ms")
    say(f"continuous[{args.weights},{args.kv},{args.attn}] on "
          f"{eng.device}: {int(st['tokens'])} tokens in "
          f"{int(st['decode_steps'])} decode steps, {wall:.3f}s wall, "
          f"occupancy {st['occupancy']:.2f}, weight stream "
          f"{st['weight_stream_ratio']:.2f}x dense "
          f"({int(st['weight_stream_bytes'])} B/step), "
          f"{int(st['preemptions'])} preemptions, "
          f"{int(st['prefill_calls'])} prefills")
    if args.kv == "paged":
        say(f"paged pool: {int(st['kv_bytes_peak'])} B KV peak of "
              f"{int(st['kv_bytes_capacity'])} B capacity, "
              f"{int(st['prefill_compiles'])} prefill shapes, "
              f"{int(st['preemptions'])} preemptions "
              f"({args.preempt}: {int(st['swap_outs'])} swap-outs)")
    if args.prefix_cache:
        say(f"prefix cache: {int(st['prefix_hits'])} hits / "
              f"{int(st['prefill_calls'])} prefills, "
              f"{int(st['prefix_hit_tokens'])} cached tokens reused, "
              f"{int(st['cow_copies'])} COW copies, "
              f"{int(st['index_blocks'])} blocks resident in index")
    if args.spec:
        say(f"speculative[{args.draft},k={args.spec_k}]: acceptance "
              f"{st['spec_acceptance']:.2f} ({int(st['spec_accepted'])}/"
              f"{int(st['spec_proposed'])} drafts), "
              f"{int(st['spec_steps_saved'])} target steps saved over "
              f"{int(st['draft_steps'])} draft steps, draft stream "
              f"{st['draft_stream_bytes'] / st['weight_stream_bytes']:.2f}x "
              f"target")
    if mesh is not None:
        say(f"tp[{mesh.size} ranks, {mesh.backend}, {eng.tp_collective}]: "
            f"ring {int(st['ring_bytes_per_step'])} B/step modeled "
            f"({st['ring_traffic_ratio']:.2f}x the dense ring, "
            f"{int(st['ring_linears'])} ring / {int(st['local_linears'])} "
            f"local linears; a tick sends {int(st['ring_tick_bytes'])} B "
            f"over all ranks); rank 0 sent {int(st['ring_sent_bytes'])} B "
            f"ring, {int(st['gather_sent_bytes'])} B gathers, staged "
            f"{int(st['staged_bytes'])} B through the host")
    rid0 = min(results)
    say("sample:", results[rid0].tokens[:12].tolist())


if __name__ == "__main__":
    main()
