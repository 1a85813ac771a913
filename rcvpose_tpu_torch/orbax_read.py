"""Read the JAX package's orbax checkpoints without orbax, tensorstore or
JAX: the orbax tree layer and zarr v2 arrays over ``ocdbt.OcdbtStore``.

A payload directory written by orbax's ``StandardCheckpointHandler`` (the
JAX ``Checkpointer``'s ``ckpt/`` and ``model_best/``, or a bare
``StandardCheckpointer().save`` directory) holds ``_CHECKPOINT_METADATA``,
``_METADATA`` (every leaf's key path with its key types, and the
``use_ocdbt`` / ``use_zarr3`` flags) and an OCDBT store whose keys are
``<path joined by '.'>/.zarray`` and its chunks (``<name>/0.0``, ``0`` for
a 0-d array). Each chunk is zstd-compressed and decoded by the port's own
decoder (``native/zstd.cpp``).

``read_tree(path, subtrees)`` reads only the leaves under the named
top-level keys, so ``opt_state`` is never decoded when it is not asked
for. Leaves come back as numpy arrays; a ``bfloat16`` leaf is read as
``<u2`` and returned as a ``torch.bfloat16`` tensor viewing it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rcvpose_tpu_torch.native import zstd
from rcvpose_tpu_torch.ocdbt import OcdbtStore

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_,
           "bfloat16": np.uint16}
_KEY_DICT, _KEY_SEQUENCE = 2, 1


def _refuse(why):
    raise ValueError(f"orbax: {why} is not supported by the port's reader "
                     "(it reads what the JAX package's Checkpointer writes: "
                     "OCDBT + zarr v2 with zstd)")


class OrbaxCheckpoint:
    """One orbax payload directory. ``store.bytes_read`` counts the bytes
    read from disk so far."""

    def __init__(self, path):
        self.path = os.path.abspath(path)
        for name in ("_CHECKPOINT_METADATA", "_METADATA"):
            if not os.path.isfile(os.path.join(self.path, name)):
                raise FileNotFoundError(
                    f"{self.path} is not an orbax checkpoint: no {name}")
        with open(os.path.join(self.path, "_METADATA")) as f:
            meta = json.load(f)
        if not meta.get("use_ocdbt", False):
            _refuse("a checkpoint without OCDBT (use_ocdbt: false)")
        if meta.get("use_zarr3", False):
            _refuse("a zarr3 checkpoint (use_zarr3: true)")
        if "tree_metadata" not in meta:
            _refuse("_METADATA without tree_metadata")
        self.leaves = []  # (key path, key types, value metadata)
        for entry in meta["tree_metadata"].values():
            keys = tuple(str(k["key"]) for k in entry["key_metadata"])
            types = tuple(int(k["key_type"]) for k in entry["key_metadata"])
            if any(t not in (_KEY_DICT, _KEY_SEQUENCE) for t in types):
                _refuse(f"key types {types} at {keys}")
            self.leaves.append((keys, types, entry.get("value_metadata", {})))
        self.store = OcdbtStore(self.path)

    def read_array(self, name):
        """The zarr v2 array stored under ``name`` (keys joined by '.')."""
        raw = self.store.read(f"{name}/.zarray")
        if raw is None:
            raise KeyError(f"orbax: no array {name!r} in {self.path}")
        meta = json.loads(raw)
        if meta.get("zarr_format") != 2:
            _refuse(f"zarr_format {meta.get('zarr_format')} at {name}")
        if meta.get("order", "C") != "C":
            _refuse(f"order {meta['order']!r} at {name}")
        if meta.get("filters"):
            _refuse(f"zarr filters {meta['filters']} at {name}")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            _refuse(f"compressor {comp.get('id')!r} at {name}")
        dtype = _DTYPES.get(meta["dtype"]) if isinstance(meta["dtype"],
                                                         str) else None
        if dtype is None:
            _refuse(f"dtype {meta['dtype']!r} at {name}")
        sep = meta.get("dimension_separator", ".")
        if sep != ".":
            _refuse(f"dimension separator {sep!r} at {name}")
        shape = tuple(int(s) for s in meta["shape"])
        chunks = tuple(int(c) for c in meta["chunks"])
        if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
            raise ValueError(f"orbax: bad chunks {chunks} for shape {shape} "
                             f"at {name}")
        out = np.empty(shape, dtype)
        grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
        for idx in itertools.product(*map(range, grid)):
            key = f"{name}/{'.'.join(map(str, idx)) if shape else '0'}"
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, chunks, shape))
            data = self.store.read(key)
            if data is None:
                out[region] = _fill(meta.get("fill_value"), meta, key)
                continue
            whole = chunks == shape
            chunk = out if whole else np.empty(chunks, dtype)
            if comp is None:
                if len(data) != chunk.nbytes:
                    raise ValueError(f"orbax: chunk {key} holds {len(data)} "
                                     f"bytes, not {chunk.nbytes}")
                chunk.reshape(-1).view(np.uint8)[:] = np.frombuffer(
                    data, np.uint8)
            else:
                zstd.decompress_into(data, chunk.reshape(-1).view(np.uint8))
            if not whole:
                out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                          for r in region)]
        if meta["dtype"] == "bfloat16":
            return torch.from_numpy(out).view(torch.bfloat16)
        return out

    def read_tree(self, subtrees=None):
        """The nested tree of every leaf (or of those under the top-level
        keys in ``subtrees``). Dict levels come back as dicts with sorted
        keys, sequence levels as tuples."""
        wanted = [(keys, types) for keys, types, vm in self.leaves
                  if (subtrees is None or keys[0] in subtrees)
                  and not vm.get("skip_deserialize", False)]
        if subtrees is not None:
            missing = set(subtrees) - {k[0] for k, _ in wanted}
            if missing:
                raise KeyError(f"orbax: {sorted(missing)} not in {self.path}")
        names = [".".join(keys) for keys, _ in wanted]
        # the decoder and file reads release the interpreter lock
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            arrays = list(pool.map(self.read_array, names))
        root = {}
        for (keys, types), arr in zip(wanted, arrays):
            node = root
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
        seq = {keys[:i + 1] for keys, types in wanted
               for i, t in enumerate(types) if t == _KEY_SEQUENCE}
        return _shape(root, (), seq)


def _shape(node, path, seq):
    if not isinstance(node, dict):
        return node
    kids = {k: _shape(v, path + (k,), seq) for k, v in node.items()}
    if path and all(path + (k,) in seq for k in kids):
        return tuple(kids[k] for k in sorted(kids, key=int))
    return {k: kids[k] for k in sorted(kids)}


def _fill(value, meta, key):
    if value is None:
        raise ValueError(f"orbax: chunk {key} is missing and the array has "
                         "no fill_value")
    if isinstance(value, str):
        if value not in ("NaN", "Infinity", "-Infinity"):
            _refuse(f"fill_value {value!r} at {key}")
        value = float(value.replace("Infinity", "inf"))
    if meta["dtype"] == "bfloat16":
        return torch.tensor(float(value), dtype=torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    return np.asarray(value).astype(_DTYPES[meta["dtype"]])


def read_tree(path, subtrees=None):
    """``OrbaxCheckpoint(path).read_tree(subtrees)``."""
    return OrbaxCheckpoint(path).read_tree(subtrees)
