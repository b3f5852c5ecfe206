"""Atomic checkpoints of tensor trees, in the reference's on-disk format
(the reference is ``repro/checkpoint/store.py``), so a checkpoint written
by either package restores into the other.

* atomic: written to ``step_<N>.tmp``, then renamed to ``step_<N>``; a
  killed writer never corrupts the newest complete checkpoint;
* format: ``leaves.npz`` (one array a leaf, keyed by its tree path joined
  with ``__``: dict keys and list/tuple indices) and ``manifest.json``
  (``step``, ``keys``, ``shapes``, ``dtypes``); bf16 is stored as its
  uint16 bits under the dtype name ``"bfloat16"``;
* any device: leaves are stored whole on the host, and
  ``restore_checkpoint(..., device=)`` puts each on the device asked for,
  whatever device wrote it;
* async: ``save_checkpoint(..., block=False)`` copies to the host, then
  writes on a thread while training goes on;
* bounded: the ``keep`` newest checkpoints survive.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import items

_SEP = "__"



def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _encode(t: torch.Tensor):
    """(numpy array on the host, dtype name) of a copy of a tensor (a CPU
    tensor is copied too: the caller may update it in place while a
    writer thread still holds the array); bf16, which numpy's .npz
    cannot hold, as its uint16 bits."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3,
                    block: bool = True) -> threading.Thread:
    """Write ``tree`` (params, optimizer state, ...) as ``step``
    atomically; afterwards only the ``keep`` newest steps remain."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # copy to the host BEFORE handing to the writer thread: the next step
    # updates the device tensors in place
    host_flat: Dict[str, np.ndarray] = {}
    dtype_names: Dict[str, str] = {}
    for path, leaf in items(tree):
        arr, name = _encode(torch.as_tensor(leaf))
        host_flat[_key(path)] = arr
        dtype_names[_key(path)] = name

    def write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **host_flat)
        manifest = {
            "step": step,
            "keys": sorted(host_flat),
            "shapes": {k: list(v.shape) for k, v in host_flat.items()},
            "dtypes": dtype_names,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        for s in sorted(_complete_steps(ckpt_dir))[:-keep]:
            shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if block:
        t.join()
    return t


def _complete_steps(ckpt_dir: pathlib.Path):
    for p in ckpt_dir.glob("step_*"):
        if p.suffix == ".tmp" or not (p / "manifest.json").exists():
            continue
        try:
            yield int(p.name.split("_")[1])
        except ValueError:
            continue


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = list(_complete_steps(ckpt_dir))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, like, step: Optional[int] = None, *,
                       device=None) -> Tuple[Any, int]:
    """(tree of ``like``'s structure, step): each leaf read from ``step``
    (default the newest), cast to the dtype of ``like``'s leaf and put on
    ``device`` (default: that leaf's device). Leaves are read one at a
    time, so the host holds no more than one beside the result."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    manifest = json.loads(
        (ckpt_dir / f"step_{step}" / "manifest.json").read_text())
    dtype_names = manifest["dtypes"]

    def rebuild(tree, path=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, path + (i,))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        key = _key(path)
        t = _decode(data[key], dtype_names.get(key, ""))
        leaf = torch.as_tensor(tree)
        return t.to(device=leaf.device if device is None else device,
                    dtype=leaf.dtype)
    with np.load(ckpt_dir / f"step_{step}" / "leaves.npz") as data:
        missing = {_key(path) for path, _ in items(like)} - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing leaves: "
                             f"{sorted(missing)[:5]}")
        return rebuild(like), step
