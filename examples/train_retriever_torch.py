"""End-to-end training on the PyTorch/CUDA port: train a late-interaction
retriever with the ColBERT-style in-batch contrastive objective,
checkpointing and resume included.

    PYTHONPATH=src python examples/train_retriever_torch.py --steps 200
    PYTHONPATH=src python examples/train_retriever_torch.py --small \
        --steps 20 --device cpu

``examples/train_retriever.py`` flag for flag, on ``repro_torch``: the same
numpy batches, the same configs (``--small`` trains a ~1M model in
seconds; the default is ~100M, 24 layers x d_model 576), a checkpoint
every 50 steps in ``repro``'s format (``{"p": params, "o": opt_state}``,
so either example resumes the other's run), resume from LATEST, and the
same printed lines. ``--device`` defaults to the card and raises without
one.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import late_interaction as LI
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_state as TS
from repro_torch.training.train_loop import make_train_step


def synth_batch(rng, cfg, batch):
    """Aligned (page, query) pairs: queries point at their page's topic."""
    d = LI.D_PATCH
    n_raw = cfg.n_patches * (4 if cfg.geometry == "dynamic" else 1)
    topics = rng.normal(size=(batch, d)).astype(np.float32)
    pages = rng.normal(size=(batch, n_raw, d)).astype(np.float32) * 0.5
    pages[:, : n_raw // 4] += topics[:, None] * 1.5
    # query tokens hash the topic into the text-vocab space
    qtok = (np.abs(topics[:, :8]) * 1e4).astype(np.int64) % cfg.query_vocab
    return {"patches": torch.from_numpy(pages),
            "query_tokens": torch.from_numpy(qtok.astype(np.int32)),
            "query_mask": torch.ones((batch, 8), dtype=torch.bool)}


def model_config(small: bool):
    """``train_retriever.py``'s two configs (ColPali geometry)."""
    cfg = get_config("colpali")
    if small:
        return dataclasses.replace(cfg, d_model=64, n_layers=2, n_heads=4,
                                   d_ff=128, grid_h=8, grid_w=8,
                                   query_vocab=1024)
    return dataclasses.replace(cfg, d_model=576, n_layers=24, n_heads=8,
                               d_ff=2304, grid_h=16, grid_w=16,
                               query_vocab=8192)


def main(argv=None) -> dict:
    """Train; returns {"start", "last_loss", "steps_run"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "retriever_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.small)
    model = LI.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[init] {cfg.name}-style retriever, {n_params/1e6:.1f}M params")

    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    oc = OPT.OptConfig(lr=3e-4, warmup=20, total_steps=args.steps)
    opt = OPT.init_opt_state(params, labels)
    step_fn = make_train_step(lambda mdl, b: mdl.contrastive_loss(b), oc,
                              labels=labels)
    start = 0
    last = CKPT.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        meta = TS.restore(args.ckpt_dir, model, opt)
        start = meta["step"] + 1
        print(f"[resume] step {start}")

    rng = np.random.default_rng(0)
    t0 = time.time()
    m = None
    for step in range(start, args.steps):
        batch = synth_batch(rng, cfg, args.batch)
        m = step_fn(model, opt, batch)
        if step % 10 == 0:
            print(f"step {step:4d} loss={float(m['loss']):.4f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % 50 == 0:
            TS.save(args.ckpt_dir, step, model, opt)
    last_loss = None if m is None else float(m["loss"])
    if m is not None:
        print(f"final loss {last_loss:.4f} "
              f"(in-batch CE; ln({args.batch})={np.log(args.batch):.2f} at "
              "init)")
    return {"start": start, "last_loss": last_loss,
            "steps_run": max(args.steps - start, 0)}


if __name__ == "__main__":
    main()
