"""Checkpointing: flat-key .npz tree snapshots + JSON metadata.

The port's own copy of ``repro.checkpoint.io``, in the same format, so a
checkpoint written by either package restores in the other with identical
flat keys and values: ``step_XXXXXXXXXX.npz`` holds one array per leaf under
a ``/``-joined key (``d:<key>`` for a dict entry, ``l:<i>``/``t:<i>`` plus a
``#l``/``#t`` length for a list/tuple, ``a`` for the leaf), dict keys
percent-escaped; ``step_XXXXXXXXXX.json`` holds the metadata. Tensors are
saved as ``.detach().cpu().numpy()`` (bf16 ones as raw 2-byte records, as
the JAX package's save writes them); restore returns numpy arrays.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_SEP = "/"


def _escape(key: str) -> str:
    """Make a dict key safe for the flat namespace.

    A literal ``/`` in a key would read back as a nesting boundary, so the
    two metacharacters are percent-encoded (``%`` first, so unescaping in the
    reverse order is exact); everything else passes through.
    """
    if not isinstance(key, str):
        raise TypeError(
            f"checkpoint: dict keys must be str, got {type(key).__name__}: "
            f"{key!r}"
        )
    if not key:
        raise ValueError("checkpoint: empty dict keys cannot round-trip")
    return key.replace("%", "%25").replace(_SEP, "%2F")


def _unescape(key: str) -> str:
    return key.replace("%2F", _SEP).replace("%25", "%")


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: the JAX package's save writes its
            # ml_dtypes arrays as raw 2-byte records ("V2"); so does this
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}d:{_escape(k)}"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        out[f"{prefix}{_SEP}#{tag}"] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{tag}:{i}"))
    else:
        out[f"{prefix}{_SEP}a"] = np.asarray(tree)
    return out


def _unflatten(flat: dict, prefix=""):
    if f"{prefix}{_SEP}a" in flat:
        return flat[f"{prefix}{_SEP}a"]
    for tag, ctor in (("l", list), ("t", tuple)):
        key = f"{prefix}{_SEP}#{tag}"
        if key in flat:
            n = int(flat[key])
            return ctor(_unflatten(flat, f"{prefix}{_SEP}{tag}:{i}") for i in range(n))
    # dict: child keys stay escaped on the recursion path; only the rebuilt
    # dict key is unescaped
    pat = re.escape(prefix + _SEP) + r"d:([^/]+)"
    kids = sorted({m.group(1) for k in flat if (m := re.match(pat, k))})
    if not kids:
        raise ValueError(f"cannot reconstruct node at {prefix!r}")
    return {_unescape(k): _unflatten(flat, f"{prefix}{_SEP}d:{k}") for k in kids}


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(_to_host(tree))
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    meta = dict(metadata or {})
    meta["step"] = step
    with open(os.path.join(ckpt_dir, f"step_{step:010d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for fn in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)\.npz$", fn))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None):
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    meta_path = os.path.join(ckpt_dir, f"step_{step:010d}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta
