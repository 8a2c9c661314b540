"""Serving launcher of the port: colocated continuous batching (default)
or prefill/decode disaggregation (``--disaggregate``: one torus
partitioned into the two domains, the KV handoff through the
``KVMigrationPlan``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b \
      --smoke --batch 4 --prompt-len 16 --gen 16            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b \
      --smoke --device cpu                                  # on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b \
      --smoke --device cpu --disaggregate --torus-p 6       # disaggregated
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --smoke --device cpu                                  # encoder-decoder

``--device`` defaults to ``cuda`` and raises on a machine without a card.
An encoder-decoder arch (whisper-tiny) encodes seeded frame embeddings
once and every decode tick reads that memory; ``--disaggregate`` refuses
it (the memory is not migrated).  ``--disaggregate`` serves in this one
process over a dims-tuple torus of ``--torus-p`` ranks (the ranks model
the placement): every prefill worker and the decode batcher compute on
``--device``, and the KV handoff runs the plan's exact host path.  On a
mesh, every rank serves through :func:`serve_disaggregated` with a
mesh-backed comm (``runtime.serving``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, make_serve_step
from repro_torch.models.common import resolve_device
from repro_torch.runtime.serving import (ContinuousBatcher,
                                         DisaggregatedServer, Request)


def batcher_step(serve, memory=None):
    """Adapt ``make_serve_step``'s ``(params, caches, toks[, memory]) ->
    (nxt, logits, caches)`` to the batcher's ``(params, toks, caches) ->
    (logits, caches)`` contract.  A fixed ``memory`` (the
    encoder-decoder's) rides along: valid when slot ``i`` serves request
    ``i``, i.e. ``max_batch == len(requests)``."""
    def step(params, toks, caches):
        _, logits, caches = serve(params, caches, toks, memory)
        return logits, caches
    return step


def serve_colocated(model, params, reqs, *, max_batch: int, max_seq: int,
                    device, serve_step=None):
    """Answer ``reqs`` through one ContinuousBatcher; returns the batcher
    (``done``, ``ticks``) and the wall seconds of the run, which ends in
    a host read of the last tick's tokens."""
    batcher = ContinuousBatcher(
        model, params, max_batch=max_batch, max_seq=max_seq, device=device,
        serve_step=serve_step or batcher_step(make_serve_step(model)))
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    batcher.run()
    return batcher, time.perf_counter() - t0


def serve_disaggregated(model, params, reqs, comm, *, max_seq: int,
                        decode_batch: int, device, serve_step=None,
                        rebuild_at=None, **server_kw):
    """Answer ``reqs`` through a :class:`DisaggregatedServer` over
    ``comm`` (a dims-tuple comm: one process; a mesh-backed comm: call it
    on every rank); ``server_kw`` are the server's knobs (``n_prefill``,
    ``prefill_batch``, ``chunk``, quotas, ``backend``).  ``rebuild_at``
    is ``(tick, surviving, n_prefill)``: after that many ticks the server
    rebuilds over ``surviving``.  Returns the server (``done``, ``ticks``,
    ``stats()``) and the wall seconds of the run."""
    server = DisaggregatedServer(
        model, params, comm, max_seq=max_seq, decode_batch=decode_batch,
        device=device,
        serve_step=serve_step or batcher_step(make_serve_step(model)),
        **server_kw)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    if rebuild_at is not None:
        tick, surviving, n_prefill = rebuild_at
        while server.ticks < tick and server.tick():
            pass
        server.rebuild(surviving, n_prefill=n_prefill)
    server.run()
    return server, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--disaggregate", action="store_true",
                    help="serve through a prefill/decode-partitioned "
                    "torus with KV migration between the domains")
    ap.add_argument("--torus-p", type=int, default=6,
                    help="serving torus size for --disaggregate "
                    "(one process: ranks model the placement)")
    ap.add_argument("--n-prefill", type=int, default=None,
                    help="prefill ranks (default: cost-model split)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)

    B = args.batch
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, args.prompt_len))
    memory = None
    if cfg.encoder_layers:
        frames = torch.randn(
            (B, cfg.n_frontend_tokens, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(2))
        with torch.no_grad():
            memory = model.encode(params, frames)
    reqs = [Request(i, [int(t) for t in prompts[i]], args.gen)
            for i in range(B)]
    max_seq = args.prompt_len + args.gen
    if args.disaggregate:
        if memory is not None:
            raise SystemExit("--disaggregate does not support enc-dec "
                             "archs (frontend memory is not migrated)")
        from repro_torch.core.comm import torus_comm
        from repro_torch.core.dims import dims_create
        dims = tuple(reversed(dims_create(args.torus_p, 2)))
        comm = torus_comm(dims, tuple(f"s{i}" for i in range(len(dims))))
        server, elapsed = serve_disaggregated(
            model, params, reqs, comm, max_seq=max_seq, decode_batch=B,
            device=device, n_prefill=args.n_prefill)
        done, ticks = server.done, server.ticks
        topo = server.stats()["topology"]
        print(f"[serve] disaggregated: {topo['n_prefill']} prefill + "
              f"{topo['n_decode']} decode ranks on torus {dims}, "
              f"{topo['migrations']} migrations "
              f"({topo['migrated_rows']} KV rows, plan="
              f"{topo['plan']['inner_kind']})")
    else:
        batcher, elapsed = serve_colocated(
            model, params, reqs, max_batch=B, max_seq=max_seq,
            device=device,
            serve_step=batcher_step(make_serve_step(model), memory))
        done, ticks = batcher.done, batcher.ticks

    out = torch.tensor([done[i] for i in range(B)], dtype=torch.int32)
    print(f"[serve] arch={cfg.name} device={device} batch={B} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"[serve] {ticks} ticks, {elapsed * 1e3 / max(1, ticks):.2f} "
          f"ms/tick, {elapsed:.2f} s total")
    print(f"[serve] sample tokens: {out[0][:12].tolist()}")
    return out


if __name__ == "__main__":
    main()
