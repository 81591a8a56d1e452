"""Checkpoint and restart, in the JAX package's on-disk format.

A state tree (nested dicts of tensors) is stored as one ``.npz`` of its
leaves plus a ``.manifest.json`` that maps each leaf's key path
(``params/blocks/p0/attn/wq``, ``opt/m/...``, ``step``) to its array id,
dtype and shape; bfloat16 leaves are stored as their ``uint16`` bits.
Either package restores the other's checkpoint.

``CheckpointManager`` adds step-tagged directories, retention, an
asynchronous save (snapshot to host memory in the caller's thread,
serialize on a worker thread; ``async_save=False`` serializes in the
caller's thread, as the elastic train executor saves), atomic publish by
rename, and a terminal
``COMMIT`` marker written only after every artifact of a step is on
disk: ``latest_step()`` ignores unmarked (torn) step directories.

On a mesh of several ranks (``dist.mesh``) every rank calls ``save`` and
``restore_latest``.  Given the state's resolved specs
(``dist.steps.train_state_shardings``), ``save`` gathers each leaf's
shards to rank 0's host memory, one leaf at a time, and rank 0 writes
the whole tensors in the format above; ``restore_latest`` gives each
rank its shard of each leaf.  A checkpoint so carries across one rank,
any mesh of ranks and the JAX package alike.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
import zlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import params as P


def _flatten(tree, prefix="") -> Dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf: torch.Tensor):
    """(array, dtype name): bfloat16 as its uint16 bits."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _read_stored(path: str, f, info: zipfile.ZipInfo):
    """The array of a stored ``.npy`` member, read from its offset in
    the file in one call and held to the member's CRC-32, as
    ``np.load`` holds it (which reads a member in 256 KiB pieces); None
    for a compressed member or one ``np.load`` must read itself
    (Fortran order, objects)."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    fmt = np.lib.format
    f.seek(info.header_offset)
    name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
    start = info.header_offset + 30 + name_len + extra_len
    f.seek(start)
    read_header = {(1, 0): fmt.read_array_header_1_0,
                   (2, 0): fmt.read_array_header_2_0}.get(
                       fmt.read_magic(f))
    if read_header is None:
        return None
    shape, fortran, dtype = read_header(f)
    if fortran or dtype.hasobject:
        return None
    offset = f.tell()
    f.seek(start)
    crc = zlib.crc32(f.read(offset - start))
    count = int(np.prod(shape))
    arr = np.fromfile(path, dtype=dtype, count=count, offset=offset)
    if (arr.size != count or offset - start + arr.nbytes != info.file_size
            or zlib.crc32(arr.reshape(-1).view(np.uint8), crc) != info.CRC):
        raise zipfile.BadZipFile(f"{path}: {info.filename} does not match "
                                 f"its size or CRC-32")
    return arr.reshape(shape)


def save_state(state, path: str, meta: Optional[Dict] = None):
    """Synchronous save: every leaf to host, then npz + manifest.  Each
    leaf records its global shape and dtype; ``meta`` is kept under
    ``__meta__`` as provenance."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, manifest = {}, {}
    for i, (key, leaf) in enumerate(sorted(_flatten(state).items())):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{i}"] = arr
        manifest[key] = {"id": f"a{i}", "dtype": dtype,
                         "shape": list(arr.shape)}
    if meta is not None:
        manifest["__meta__"] = meta
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    with open(path + ".manifest.json.tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path + ".npz")                       # atomic publish
    os.replace(path + ".manifest.json.tmp", path + ".manifest.json")


def load_meta(path: str) -> Optional[Dict]:
    with open(path + ".manifest.json") as f:
        return json.load(f).get("__meta__")


def restore_state(template, path: str, device=None, local=None):
    """Restore into the template's structure: every template leaf (a
    tensor, possibly on the ``meta`` device) must be in the checkpoint
    with its shape, except that the comm layer's residual (``comm/...``)
    may be missing from an older checkpoint and then starts at zero, as
    in the JAX package.  Leaves come back as tensors of the template's
    dtype on ``device`` (default: the CPU); ``local(key, tensor)`` is
    what a rank keeps of each leaf (its shard)."""
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)

    npz = path + ".npz"

    def load(z, f, key, leaf):
        entry = manifest.get(key)
        if entry is None and key.startswith("comm/"):
            return place(torch.zeros(leaf.shape, dtype=leaf.dtype), key)
        if entry is None:
            raise ValueError(f"{key}: missing from checkpoint {path}")
        arr = _read_stored(npz, f, z.zip.getinfo(entry["id"] + ".npy"))
        if arr is None:
            arr = z[entry["id"]]
        if tuple(arr.shape) != tuple(entry["shape"]) or \
                tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: stored {arr.shape}, manifest "
                             f"{entry['shape']}, template "
                             f"{tuple(leaf.shape)}")
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return place(t.to(dtype=leaf.dtype), key)

    def place(t, key):
        if local is not None:
            t = local(key, t)
        return t.to(device=device or "cpu")

    flat = _flatten(template)
    with np.load(npz) as z, open(npz, "rb") as f:
        leaves = [load(z, f, k, flat[k]) for k in sorted(flat)]
    return P.tree_unflatten(template, leaves)


COMMIT_MARKER = "COMMIT"


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, mesh=None,
                 specs=None, async_save: bool = True):
        """``mesh``: the ranks that save and restore together, and
        ``specs`` the state's resolved specs on it
        (``dist.steps.train_state_shardings``), each rank holding its
        shard of every leaf."""
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and specs is None:
            raise ValueError("a checkpoint on a mesh of ranks needs the "
                             "state's specs")
        self.specs = _flatten(specs) if self.mesh is not None else None
        self._worker: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}", "state")

    def save(self, state, step: int, meta: Optional[Dict] = None):
        """Snapshot to host memory now; serialize on a worker thread (on
        rank 0 of a mesh; every rank must call this).  The ``COMMIT``
        marker is written strictly after every artifact of the step
        directory is on disk."""
        if self.mesh is not None:
            host = self._gather_whole(state)
        else:
            # a copy: the trainer updates the device (or CPU) state in place
            host = P.tree_map(lambda t: t.detach().to("cpu", copy=True),
                              state)
        self.wait()
        if self.mesh is not None and self.mesh.rank != 0:
            return
        path = self._step_path(step)

        def work():
            save_state(host, path, meta=meta)
            with open(os.path.join(os.path.dirname(path),
                                   COMMIT_MARKER), "w") as f:
                f.write(f"{step}\n")
            self._gc()

        if self.async_save:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()
        else:
            work()

    def _gather_whole(self, state):
        """Every leaf whole, gathered to rank 0's host memory one leaf at
        a time (None on the other ranks)."""
        from repro_torch.dist.sharding import gather_to_host
        flat = _flatten(state)
        out: Dict = {}
        for key in sorted(flat):
            node = out
            *up, last = key.split("/")
            for k in up:
                node = node.setdefault(k, {})
            node[last] = gather_to_host(flat[key], self.specs[key],
                                        self.mesh)
        return out

    def wait(self):
        """Until the last save is on disk: on a mesh, every rank waits
        for rank 0's writer."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self.mesh is not None:
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        """Newest committed step; torn (uncommitted) dirs are invisible."""
        if not os.path.isdir(self.dir):
            return None
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and os.path.exists(
                     os.path.join(self.dir, d, COMMIT_MARKER))]
        return max(steps) if steps else None

    def restore_latest(self, template, device=None):
        """The newest committed state, or (None, None).  A rank of a
        mesh gets its shard of each leaf."""
        step = self.latest_step()
        if step is None:
            return None, None
        local = None
        if self.mesh is not None:
            from repro_torch.dist.sharding import shard
            local = lambda key, t: shard(t, self.specs[key], self.mesh)
        return restore_state(template, self._step_path(step), device,
                             local=local), step

    def _gc(self):
        """Retention counts committed steps only; torn directories (a
        crashed writer's leftovers) are reclaimed outright."""
        committed, torn = [], []
        for d in os.listdir(self.dir):
            if not d.startswith("step_"):
                continue
            if os.path.exists(os.path.join(self.dir, d, COMMIT_MARKER)):
                committed.append(int(d.split("_")[1]))
            else:
                torn.append(int(d.split("_")[1]))
        for s in sorted(committed)[:-self.keep] + torn:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
