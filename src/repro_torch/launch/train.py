"""Training launcher for the decoder-LM family (the port of
``repro.launch.train``): any LM arch, a deterministic synthetic data loop,
checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --steps 50 --ckpt-dir /tmp/run1 [--device cpu]

Flags are ``repro``'s (``--arch --steps --batch --seq --reduced --ckpt-dir
--ckpt-every --seed``) plus ``--device`` (default ``cuda``; without a card
it raises). ``--reduced`` swaps in a CPU-sized config of the same family
and code path. Batch ``step`` is drawn from
``deterministic_batch_seed(seed, step, 0)``, so any run recomputes any
batch: tokens [batch, seq] and labels rolled by -1. The optimizer is
AdamW under ``wsd`` for minicpm and ``cosine`` otherwise (warmup 10,
``total_steps = --steps``). Every ``--ckpt-every`` steps the train state
is saved as ``repro``'s ``{"params", "opt"}`` tree; relaunched with the
same ``--ckpt-dir`` the run resumes from LATEST, also from a checkpoint
that ``repro``'s launcher wrote (and ``repro``'s from one of this
package). Initial weights come from a ``torch.Generator`` seeded with
``--seed`` on the run's device, not from a JAX key.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def reduced_lm(cfg):
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=32, d_ff=256,
        vocab_size=512,
        attn_pattern=tuple(min(w, 16) if w else 0 for w in cfg.attn_pattern),
        loss_chunks=2, dtype="float32",
        moe=None if cfg.moe is None else dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff=64))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (same code path)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build(arch: str, steps: int, reduced: bool = False, seed: int = 0,
          device="cuda") -> dict:
    """The run's pieces as ``main`` builds them: ``cfg``, ``model`` (a
    ``DecoderLM``), ``labels``, ``oc`` (the ``OptConfig``), ``opt`` (its
    state) and ``step_fn`` (the train step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config(arch)
    if cfg.family != "lm":
        raise ValueError(f"{arch} is a {cfg.family} arch: this launcher "
                         "drives the LM family")
    if reduced:
        cfg = reduced_lm(cfg)
    dev = resolve_device(device)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    oc = OPT.OptConfig(lr=3e-4,
                       schedule="wsd" if "minicpm" in arch else "cosine",
                       warmup=10, total_steps=steps)
    return dict(cfg=cfg, model=model, labels=labels, oc=oc,
                opt=OPT.init_opt_state(params, labels),
                step_fn=make_train_step(T.loss_fn, oc, labels=labels))


def make_batch(cfg, seed: int, step: int, batch: int, seq: int,
               device) -> dict:
    """Batch ``step`` of run ``seed``: int32 tokens [batch, seq] and labels
    rolled by -1, on ``device``."""
    from repro_torch.training.elastic import deterministic_batch_seed
    rng = np.random.default_rng(deterministic_batch_seed(seed, step, 0))
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
    return {"tokens": tokens.to(device),
            "labels": torch.roll(tokens, -1, dims=1).to(device)}


def main(argv=None) -> list:
    """Runs the launcher; returns the log, one dict per step run
    (``step``, ``loss``, ``grad_norm``, ``lr``)."""
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import train_state as TS
    from repro_torch.training.elastic import StragglerWatchdog

    args = parse_args(argv)
    run = build(args.arch, args.steps, args.reduced, args.seed, args.device)
    cfg, model, opt, step_fn = (run["cfg"], run["model"], run["opt"],
                                run["step_fn"])
    start = 0
    if args.ckpt_dir:
        last = CKPT.latest_step(args.ckpt_dir)
        if last is not None:
            meta = TS.restore(args.ckpt_dir, model, opt, keys=TS.LM_KEYS)
            start = meta["step"] + 1
            print(f"[resume] from step {meta['step']}")

    dog = StragglerWatchdog()
    log = []
    for step in range(start, args.steps):
        batch = make_batch(cfg, args.seed, step, args.batch, args.seq,
                           model.device)
        t0 = time.time()
        m = {k: float(v) for k, v in step_fn(model, opt, batch).items()}
        dt = time.time() - t0
        slow = dog.record(dt)
        log.append({"step": step, **m})
        if step % 5 == 0 or slow:
            print(f"step {step:4d} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} {dt*1e3:.0f}ms"
                  + ("  [STRAGGLER]" if slow else ""), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            TS.save(args.ckpt_dir, step, model, opt, keys=TS.LM_KEYS,
                    meta={"arch": args.arch})
    print("done.")
    return log


if __name__ == "__main__":
    main()
