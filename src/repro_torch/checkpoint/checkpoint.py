"""Checkpoint and restore with an atomic commit: the counterpart of
``repro.checkpoint``, with the same layout on disk (one directory a step):

    <dir>/step_000123/
        manifest.json       # step, leaf keys, shapes and types
        arrays/<idx>.npy    # one file a leaf, on the host
        COMMIT              # written last: a checkpoint without it is
                            # ignored (crash-safe atomicity)

A tree is nested dicts of tensors (``{"params": state_dict, "opt":
state}``); its leaves are numbered in the order of their sorted key paths,
as ``jax.tree_util`` flattens a dict. bfloat16 leaves are stored as their
uint16 bits (numpy has no bfloat16). ``restore`` takes ``map_location``
where the reference takes shardings: restoring across device meshes is
out of scope on one card. ``save(..., async_=True)`` writes from a thread
(the leaves are copied to the host before it starts).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """[(key path, leaf)] in sorted key order."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _unflatten(pairs):
    tree = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _to_host(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir, step: int, tree, *, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Write a checkpoint of ``tree`` at ``step``, keeping the last
    ``keep`` committed ones. ``async_=True`` returns the writer thread."""
    ckpt_dir = Path(ckpt_dir)
    pairs = _flatten(tree)
    host = [_to_host(x) for _, x in pairs]
    manifest = {"step": step,
                "leaves": [{"key": "/".join(path), "shape": list(x.shape),
                            "dtype": str(x.dtype).removeprefix("torch.")}
                           for path, x in pairs]}

    def _write():
        final = ckpt_dir / f"step_{step:08d}"
        tmp = ckpt_dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        for i, a in enumerate(host):
            np.save(tmp / "arrays" / f"{i}.npy", a)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMIT").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if (p / "COMMIT").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if (p / "COMMIT").exists())
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, example_tree, map_location=None):
    """The checkpoint at ``step`` as a tree shaped like ``example_tree``:
    each leaf in its example's type, on ``map_location`` (default: the
    example leaf's device). Raises on an uncommitted checkpoint or a tree
    whose keys or shapes changed."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"uncommitted checkpoint {d}")
    manifest = json.loads((d / "manifest.json").read_text())
    pairs = _flatten(example_tree)
    keys = ["/".join(path) for path, _ in pairs]
    if keys != [leaf["key"] for leaf in manifest["leaves"]]:
        raise ValueError(f"{d}: the tree's keys changed")
    out = []
    for i, (path, ref) in enumerate(pairs):
        meta = manifest["leaves"][i]
        x = _from_host(np.load(d / "arrays" / f"{i}.npy"), meta["dtype"])
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"{keys[i]}: shape {tuple(x.shape)}, expected "
                             f"{tuple(ref.shape)}")
        dev = ref.device if map_location is None else map_location
        out.append((path, x.to(device=dev, dtype=ref.dtype)))
    return _unflatten(out)
