"""Fault-tolerant checkpointing: atomic, keep-last-k, streamed, checksummed.

The on-disk format is ``repro.training.checkpoint``'s, so a checkpoint
written by either package restores in the other:

    <dir>/step_<n>/
        arrays.npz        one ``leaf_<i>.npy`` member per leaf
        meta.json         step, shapes, dtypes, CRC32 checksums, leaf
                          names, user meta
    <dir>/LATEST          text file naming the newest complete step

Writes go to ``step_<n>.tmp`` and are renamed into place (atomic on
POSIX), so a writer killed mid-save never corrupts LATEST; keep-last-k GC
(``_gc``) prunes old steps and the debris of killed writers.

The port has no pytree: a checkpoint is a flat list of leaves (torch
tensors, on any device, or numpy arrays) with optional names; its one
caller is the store snapshot (``retrieval.tiering.snapshot``). Leaves
stream to disk one at a time, so peak host memory is one leaf.

bfloat16 leaves are stored as their uint16 BIT PATTERN under the dtype
name ``"bfloat16"`` (numpy has no bfloat16): the tensor is viewed as
int16 where it lives, copied to the host and viewed as uint16; restore
views the bits back. No value is ever converted, so the round trip is
bitwise. Every leaf's CRC32 is taken over those stored bytes; restore
verifies it and raises ``CheckpointCorrupt`` naming the leaf, as it
does when the archive's own CRC-32 catches bytes flipped on disk.

Restored leaves are torch tensors. Unsigned integer leaves whose width
torch lacks full support for (uint16/32/64) come back as the same-width
signed tensor holding the same bits, the port's convention for its uint32
tag words (``retrieval.store``).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.distributed.sharding import device_put

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


class CheckpointCorrupt(RuntimeError):
    """A restored array's bytes do not match the checksum recorded at
    save time — the checkpoint is damaged and must not be served. The
    message names the bad array; recover by restoring an earlier step."""


def _crc(a: np.ndarray) -> int:
    """CRC32 of an array's stored bytes (the bit-pattern form bfloat16 is
    written as)."""
    return zlib.crc32(np.ascontiguousarray(a).view(np.uint8).reshape(-1))


def named_dtype(name: str) -> np.dtype:
    """np.dtype from its recorded string name (``meta.json``'s
    ``dtypes``). numpy has no bfloat16 or float8 types and the port does
    not use ``ml_dtypes``, so "bfloat16" and the "float8_*" names map to
    the unsigned integer type of the same width, the form this checkpoint
    stores their bit patterns in (``_stored``); ``repro``'s returns the
    ``ml_dtypes`` type there. Any other name numpy does not know raises
    TypeError. The extended names are looked up first, so the answer does
    not depend on whether another module has registered ``ml_dtypes``'
    types with numpy."""
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype) and (name == "bfloat16"
                                        or name.startswith("float8")):
        return np.dtype(f"uint{8 * dt.itemsize}")
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"unknown dtype name {name!r}") from None


def _stored(x) -> tuple:
    """(host numpy array in stored form, dtype name) of one leaf."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, str(a.dtype)
    if x.dtype == torch.bfloat16:
        bits = x.detach().contiguous().view(torch.int16).cpu().numpy()
        return bits.view(np.uint16), "bfloat16"
    a = x.detach().cpu().numpy()
    return a, str(a.dtype)


def _as_tensor(a: np.ndarray, dtype_name: str,
               device: torch.device) -> torch.Tensor:
    """A stored leaf back as a tensor on ``device``, bit for bit."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save(ckpt_dir: str, step: int, leaves: list, meta: dict | None = None,
         keep: int = 3, leaf_names: list | None = None,
         faults=None) -> str:
    """Write one checkpoint step (layout in the module docstring).

    ``leaves`` is a flat list of tensors or numpy arrays, written one at a
    time. Every leaf's CRC32 (of its stored bytes) goes into
    ``meta.json``; ``leaf_names`` is an optional parallel list of names
    used in ``CheckpointCorrupt`` (default ``leaf_<i>``). ``faults`` is an
    optional ``retrieval.faults.FaultInjector`` whose snapshot hooks
    emulate a writer killed mid-step (``.tmp`` debris left behind, LATEST
    untouched) or silent media corruption (a bit flip AFTER the checksum
    is taken). Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shapes, dtypes, checksums = [], [], []
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, x in enumerate(leaves):
            a, dtype_name = _stored(x)
            shapes.append(list(a.shape))
            dtypes.append(dtype_name)
            checksums.append(_crc(a))
            if faults is not None:
                a = faults.corrupt_snapshot_leaf(i, a)
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            del a
            if faults is not None:
                faults.snapshot_leaf_written(i)   # may 'crash' the writer
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step,
                   "shapes": shapes,
                   "dtypes": dtypes,
                   "checksums": checksums,
                   "leaf_names": leaf_names,
                   "meta": meta or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    """Prune old steps, keeping the last ``keep`` COMPLETE ones. Crash
    debris (``.tmp`` directories from a killed writer) is cleaned up but
    never counted against ``keep``, and the newest complete step — plus
    whatever LATEST names — is never deleted, even with ``keep <= 0``."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    if not steps:
        return
    protected = {steps[-1]}
    latest = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            protected.add(f.read().strip())
    for d in steps[:-max(int(keep), 1)]:
        if d in protected:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # a .tmp older than the newest complete step is debris from a killed
    # writer (a live save owns at most the newest name)
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp") and d[:-len(".tmp")] < steps[-1]:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip().split("_")[1])


def load_meta(ckpt_dir: str, step: int | None = None) -> dict:
    """The checkpoint's meta.json alone (shapes, dtypes, user meta)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int | None = None,
            device="cpu", shardings=None) -> tuple:
    """Load a checkpoint step (default: LATEST): ``(leaves, meta)`` with
    ``leaves`` a list of tensors on ``device`` in save order. Leaves are
    read one at a time and their CRC32 verified before use; a mismatch
    raises ``CheckpointCorrupt`` naming the leaf. ``shardings``, a list
    of ``NamedSharding`` or None per leaf, places each leaf on its mesh as
    it is read (``distributed.sharding.device_put``: a ``Sharded`` of
    slabs, each its own copy on its position's device), the restart onto
    another topology."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    sums = meta.get("checksums")
    names = meta.get("leaf_names") or []
    if shardings is not None and len(shardings) != len(meta["shapes"]):
        raise ValueError(f"{len(shardings)} shardings for "
                         f"{len(meta['shapes'])} leaves")
    dev = torch.device(device)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (shape, dtype_name) in enumerate(zip(meta["shapes"],
                                                    meta["dtypes"])):
            label = names[i] if i < len(names) else f"leaf_{i}"
            try:
                a = data[f"leaf_{i}"]
            except zipfile.BadZipFile as e:
                # bytes flipped on disk under the archive's own CRC-32
                raise CheckpointCorrupt(
                    f"checkpoint {path}: array '{label}' failed the "
                    f"archive's CRC-32 check ({e}); restore an earlier "
                    f"step") from e
            if sums is not None and _crc(a) != sums[i]:
                raise CheckpointCorrupt(
                    f"checkpoint {path}: array '{label}' failed its CRC32 "
                    f"check — bytes on disk do not match the bytes saved; "
                    f"restore an earlier step")
            if tuple(a.shape) != tuple(shape):
                raise CheckpointCorrupt(
                    f"checkpoint {path}: leaf {i} has shape {a.shape}, "
                    f"meta records {tuple(shape)}")
            sh = shardings[i] if shardings is not None else None
            if sh is None:
                out.append(_as_tensor(a, dtype_name, dev))
            else:
                out.append(device_put(_as_tensor(a, dtype_name,
                                                 torch.device("cpu")), sh,
                                      copy=True))
    return out, meta
