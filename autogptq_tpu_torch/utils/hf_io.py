"""Checkpoint I/O: HF ``config.json`` and safetensors, single-file or sharded.

The port's counterpart of the JAX package's ``utils/hf_io.py``. Tensors are
read lazily through ``safetensors.safe_open(..., framework="pt")``, so host
memory holds about one tensor at a time and bf16 tensors need no NumPy bf16
type. Only local directories are read. ``save_safetensors`` writes NumPy
tensors as one file or, above ``max_shard_size``, as shards with an index.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

SAFE_INDEX = "model.safetensors.index.json"


def load_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _index_files(index_path: str) -> list[str]:
    with open(index_path) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    return [os.path.join(os.path.dirname(index_path), name) for name in files]


def find_checkpoint_files(model_dir: str, basename: str | None = None) -> list[str]:
    """Safetensors file(s) of a local checkpoint directory: ``basename``'s
    single file or index when given, else ``model.safetensors.index.json``,
    ``model.safetensors``, or every ``*.safetensors`` file."""
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"{model_dir!r} is not a local directory")
    if basename:
        single = os.path.join(model_dir, basename + ".safetensors")
        if os.path.isfile(single):
            return [single]
        idx = os.path.join(model_dir, f"{basename}.safetensors.index.json")
        if os.path.isfile(idx):
            return _index_files(idx)
    idx = os.path.join(model_dir, SAFE_INDEX)
    if os.path.isfile(idx):
        return _index_files(idx)
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(single):
        return [single]
    found = sorted(
        os.path.join(model_dir, f) for f in os.listdir(model_dir) if f.endswith(".safetensors")
    )
    if found:
        return found
    raise FileNotFoundError(f"no safetensors checkpoint found in {model_dir}")


class LazyTensors:
    """Read-only mapping name -> CPU ``torch.Tensor`` over safetensors files;
    a tensor is read from disk when it is looked up."""

    def __init__(self, files: list[str]):
        from safetensors import safe_open

        self._handles = []
        self._index: dict[str, int] = {}
        for path in files:
            handle = safe_open(path, framework="pt")
            for name in handle.keys():
                self._index[name] = len(self._handles)
            self._handles.append(handle)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._handles[self._index[name]].get_tensor(name)

    def get(self, name: str, default=None):
        return self[name] if name in self else default


def open_tensors(model_dir: str, basename: str | None = None) -> LazyTensors:
    return LazyTensors(find_checkpoint_files(model_dir, basename))


def save_safetensors(tensors: dict[str, np.ndarray], path: str,
                     metadata: dict[str, str] | None = None,
                     max_shard_size: int | None = None) -> None:
    """Write NumPy tensors to ``path``; when ``max_shard_size`` (bytes) is
    given and exceeded, to ``<base>-0000i-of-0000n.safetensors`` shards listed
    in ``<base>.safetensors.index.json`` (named after the target so a loader
    that probes the base name finds a sharded save)."""
    from safetensors.numpy import save_file

    # save_file serializes the raw buffer, so every tensor must be C-contiguous
    tensors = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    total = sum(t.nbytes for t in tensors.values())
    if max_shard_size is None or total <= max_shard_size:
        save_file(tensors, path, metadata=metadata)
        return

    shards: list[dict[str, np.ndarray]] = [{}]
    sizes = [0]
    for name, t in tensors.items():
        if sizes[-1] + t.nbytes > max_shard_size and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = t
        sizes[-1] += t.nbytes
    base = os.path.basename(path).replace(".safetensors", "")
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"{base}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(dirname, fname), metadata=metadata)
        weight_map.update({name: fname for name in shard})
    with open(os.path.join(dirname, f"{base}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)


__all__ = ["find_checkpoint_files", "load_hf_config", "open_tensors", "LazyTensors",
           "save_safetensors"]
