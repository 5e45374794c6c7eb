"""Checkpoint and restore (the port of ``repro.train.checkpoint``).

The on-disk layout is the reference's: ``step-%08d/`` with one ``.npy`` a
leaf and a ``manifest.json`` of ``step`` and ``leaves{name: file, shape,
dtype}``, written under a temporary name and renamed into place, so a
failed write never leaves a half checkpoint where ``latest_step`` looks.
Leaf names are the tree's keys joined by ``/`` (``params/embed``,
``opt/mu/…``, ``opt/step``).  The manifest holds logical shapes only, so
``restore`` lays each leaf out on whatever device the restarted run asks
for.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist

_STEP_DIR = re.compile(r"step-(\d{8})")


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/…": leaf} for a tree of dicts and NamedTuples; a leaf is a
    tensor or a host number."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rebuild(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with the leaf of each name from ``leaves``."""
    if hasattr(like, "_asdict"):
        return type(like)(**_rebuild(like._asdict(), leaves, prefix))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def default_process_index() -> int:
    """This process's rank in the default group, 0 outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, *,
         process_index: int | None = None) -> str:
    """Write ``tree`` as ``step-<n>/`` (one ``.npy`` a leaf and
    ``manifest.json``) and return its path; an existing checkpoint of the
    step is replaced.  The temporary directory is ``….tmp<process_index>``
    (by default this process's rank)."""
    pi = default_process_index() if process_index is None \
        else process_index
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    tmp = final + f".tmp{pi}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (name, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr = _to_numpy(leaf)
        fname = f"leaf{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest finished checkpoint's step: a ``step-<n>`` directory
    with a manifest.  Temporary directories (``….tmp<rank>``) of any rank
    are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_DIR.fullmatch(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, *, device=None):
    """The checkpoint of ``step`` in the structure of ``like`` (dicts and
    NamedTuples of tensors and host ints), each tensor with its like
    leaf's dtype on ``device``, or on the like leaf's device if none is
    given; a host-int leaf comes back as an int.  A leaf whose shape
    differs from its like leaf's raises."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, leaf in _flatten(like).items():
        meta = manifest["leaves"][name]
        arr = np.load(os.path.join(path, meta["file"]))
        if isinstance(leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: a checkpointed {arr.shape} leaf "
                                 f"for a {tuple(leaf.shape)} tensor")
            out[name] = torch.from_numpy(arr).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype)
        else:
            out[name] = type(leaf)(arr)
    return _rebuild(like, out)
