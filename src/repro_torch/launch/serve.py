"""Batched serving: prefill prompts, then decode with a KV cache, a
torch copy of ``repro.launch.serve``.

Fed-RAC flavour: the server holds the α-compressed model FAMILY and routes
each request batch to the model level matching the requester's resource
cluster (the serving side of §IV-A2; ``examples/torch_serve_demo.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \\
      --batch 4 --prompt-len 32 --gen 32 [--device cpu]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU, and weights are drawn there from a seeded generator.  As in JAX, the
prompt is prefilled token by token through ``decode_step``, decoding is
greedy over the vocabulary mask, and an enc-dec model serves with the
zero cross cache that ``registry.init_cache`` gives.

``--watch-ckpt DIR`` points at a training run's crash-safe checkpoint
directory (``sim_run --ckpt-dir``): between request batches a
``PlaneWatcher`` polls the manifest and hot-reloads the newest *valid*
aggregated ``plane/<level>`` into the serving params.  Corrupt, partial,
key-missing or shape-incompatible checkpoints are skipped with a warning
and the previous plane keeps serving.  A reloaded plane takes the serving
parameters' dtypes (bf16 stays bf16).
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.ckpt.manifest import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.scaling import compress_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import registry, transformer
from repro_torch.obs import NULL_OBS, make_observability

log = logging.getLogger("repro_torch.serve")


class PlaneWatcher:
    """Mid-training hot reload of the aggregated model plane.

    Polls a run-state checkpoint directory for steps newer than the one
    serving, walks them newest first, and returns the first
    ``plane/<level>`` that passes manifest CRC, decode and shape
    validation, unraveled into the serving params' structure, dtypes and
    device.  Every failure (unreadable manifest, corrupt or truncated step,
    missing plane key, plane of another model) logs a warning and keeps
    the previous params serving.
    """

    def __init__(self, ckpt_dir: str, params_template, level: int = 0,
                 obs=NULL_OBS):
        self.manager = CheckpointManager(ckpt_dir)
        self.spec = make_plane_spec(params_template)
        self.device = tree_leaves(params_template)[0].device
        self.level = int(level)
        self.obs = obs
        self.step = -1     # newest checkpoint step already adapted

    def poll(self, params):
        """(params', reloaded): the newest valid plane newer than
        ``self.step`` adapted into params, or ``params`` unchanged."""
        key = f"plane/{self.level}"
        try:
            fresh = [s for s in self.manager.steps() if s > self.step]
        except Exception as e:
            log.warning("plane watch: manifest unreadable (%s)", e)
            return params, False
        for step in sorted(fresh, reverse=True):
            try:
                _meta, arrays = self.manager.load_step(step)
            except CheckpointError as e:
                log.warning("plane watch: skipping step %d: %s", step, e)
                continue
            plane = arrays.get(key)
            if plane is None:
                log.warning("plane watch: step %d has no %r", step, key)
                continue
            if tuple(plane.shape) != (self.spec.d_pad,):
                log.warning(
                    "plane watch: step %d %s shape %s != (%d,): plane is "
                    "from a different model; keeping previous params",
                    step, key, tuple(plane.shape), self.spec.d_pad)
                continue
            self.step = step
            if self.obs.on:
                self.obs.registry.counter("serve/plane_reloads").inc()
                self.obs.registry.gauge("serve/plane_step").set(step)
            plane = torch.as_tensor(plane, device=self.device)
            return self.spec.to_params(plane, keep_dtypes=True), True
        return params, False


def prefill_into_cache(cfg, params, tokens, max_len, obs=NULL_OBS):
    """Run the full prompt through decode steps to fill the cache (the
    step-by-step fill shares the decode path, as JAX's does)."""
    B, S = tokens.shape
    cache = registry.init_cache(cfg, B, max_len, device=tokens.device)
    logits = None
    with obs.tracer.span("serve.prefill", cat="serve", batch=B,
                         prompt_len=S):
        for t in range(S):
            logits, cache = registry.decode_step(cfg, params, cache,
                                                 tokens[:, t:t + 1], t)
        obs.tracer.fence(logits)
    if obs.on:
        obs.registry.counter("serve/prefill_tokens").inc(B * S)
    return logits, cache


def _greedy(vmask, logits):
    return torch.argmax(torch.where(vmask, logits[:, -1], -torch.inf),
                        dim=-1)[:, None]


@torch.no_grad()
def generate(cfg, params, prompts, gen_len, obs=NULL_OBS):
    """Greedy decode of ``gen_len`` tokens after ``prompts`` (B, S):
    returns a (B, gen_len) int64 numpy array."""
    prompts = torch.as_tensor(prompts, device=tree_leaves(params)[0].device)
    B, S = prompts.shape
    logits, cache = prefill_into_cache(cfg, params, prompts, S + gen_len,
                                       obs)
    vmask = transformer.vocab_mask(cfg, prompts.device)
    tok = _greedy(vmask, logits)
    out = []
    t0 = time.perf_counter()
    with obs.tracer.span("serve.decode", cat="serve", batch=B,
                         gen_len=gen_len):
        for i in range(gen_len):
            out.append(tok)
            logits, cache = registry.decode_step(cfg, params, cache, tok,
                                                 S + i)
            tok = _greedy(vmask, logits)
        toks = torch.cat(out, dim=1).cpu().numpy()
    if obs.on:
        dt = time.perf_counter() - t0
        obs.registry.counter("serve/decode_steps").inc(gen_len)
        obs.registry.counter("serve/generated_tokens").inc(B * gen_len)
        if dt > 0:
            obs.registry.gauge("serve/decode_tok_per_s").set(B * gen_len / dt)
        obs.registry.histogram("serve/decode_step_s").observe(
            dt / max(gen_len, 1))
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cluster-level", type=int, default=0,
                    help="Fed-RAC cluster level (α-compressed model)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-text", action="store_true",
                    help="print a Prometheus-style /metrics text snapshot "
                         "after the run")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the registry snapshot as JSON ('-' for "
                         "stdout)")
    ap.add_argument("--watch-ckpt", default=None, metavar="DIR",
                    help="hot-reload the newest valid aggregated plane from "
                         "this run-state checkpoint dir between request "
                         "batches (sim_run --ckpt-dir)")
    ap.add_argument("--watch-level", type=int, default=0,
                    help="cluster level whose plane/<level> to watch")
    ap.add_argument("--watch-batches", type=int, default=3, metavar="N",
                    help="with --watch-ckpt: serve N request batches, "
                         "polling for a newer plane between each")
    ap.add_argument("--watch-poll-s", type=float, default=0.0, metavar="S",
                    help="sleep between watched batches (poll interval)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; 'cpu' "
                         "for a run without a card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to serve on the CPU)")
    obs = (make_observability(trace=False)
           if args.metrics_text or args.metrics_json else NULL_OBS)
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = compress_config(cfg, args.alpha, args.cluster_level)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    watcher = None
    if args.watch_ckpt:
        watcher = PlaneWatcher(args.watch_ckpt, params,
                               level=args.watch_level, obs=obs)
        params, fresh = watcher.poll(params)
        if fresh:
            print(f"# serving plane from checkpoint step {watcher.step}")
    t0 = time.time()
    batches = max(args.watch_batches, 1) if watcher is not None else 1
    for b in range(batches):
        toks = generate(cfg, params, prompts, args.gen, obs=obs)
        if watcher is not None and b + 1 < batches:
            if args.watch_poll_s:
                time.sleep(args.watch_poll_s)
            params, fresh = watcher.poll(params)
            if fresh:
                print(f"# hot-reloaded plane at checkpoint step "
                      f"{watcher.step}")
    dt = time.time() - t0
    if obs.on:
        obs.registry.gauge("serve/wall_clock_s").set(dt)
        obs.registry.counter("serve/requests").inc(args.batch * batches)
    print(f"arch={cfg.name} level={args.cluster_level} "
          f"generated {toks.shape}x{batches} in {dt:.1f}s "
          f"({batches * args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", np.asarray(toks[0, :16]))
    if args.metrics_text:
        print(obs.registry.render_text(), end="")
    if args.metrics_json:
        snap = json.dumps(obs.registry.snapshot(), indent=2)
        if args.metrics_json == "-":
            print(snap)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(snap + "\n")
    return toks


if __name__ == "__main__":
    main()
