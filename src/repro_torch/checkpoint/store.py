"""Checkpointing: atomic, step-indexed, keep-k, with an asynchronous
writer (the JAX package's ``checkpoint/store.py``, on tensors).

Format: one directory per step, ``step_XXXXXXXX/``, holding ``tree.json``
(step, dtypes, shapes) and ``leaves.npz``.  A write goes to
``<dir>.tmp`` and is then ``os.replace``d (atomic on POSIX), so a failure
mid-write never corrupts the latest checkpoint: restore takes the newest
complete directory.

A state is a nest of dicts, tuples, lists and NamedTuples of tensors; a
leaf's key joins its path with ";" (dict keys, NamedTuple field names,
sequence indices), so the keys are the port's state names (e.g.
``0;blocks.3.attn.wq.w``, ``1;m;embed.w``).  ``save`` copies every tensor
to the host before it returns, since training goes on updating the live
tensors in place.  bfloat16 has no numpy type: such a leaf is stored as
its 16 bits (uint16) and ``tree.json`` records ``bfloat16``, so it comes
back bit for bit.

Under a process group of more than one rank the state's DTensors are
gathered whole on every rank (a collective: every rank calls ``save``),
rank 0 alone writes the files a one-device run writes, ``wait`` ends at a
barrier, and ``restore`` gives each rank its own chunk of every DTensor.
"""
from __future__ import annotations

import io
import json
import os
import queue
import shutil
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh

_SEP = ";"
_BITS = {torch.bfloat16: np.uint16}     # types numpy cannot hold, as raw bits


def leaves(tree, prefix=()):
    """(path, leaf) of every tensor of a nest, in a fixed order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        raise TypeError(f"checkpoint: leaf {_SEP.join(prefix)!r} is a "
                        f"{type(tree).__name__}, not a tensor")


def _to_numpy(t: torch.Tensor):
    """(host array, dtype name): a copy, never a view of ``t``."""
    t = sh.full(t.detach()).to("cpu", copy=True)
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(_BITS[t.dtype]), \
            str(t.dtype).replace("torch.", "")
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _save_npz(path: str, arrays: Dict[str, np.ndarray]):
    """``np.savez``'s file: a stored zip64 of ``<key>.npy`` entries, each
    with the header and bytes ``np.save`` gives it (a Fortran-ordered
    array as its transpose's bytes).  The entries' CRCs are summed on a
    thread per core (zlib releases the GIL) ahead of the writes, and each
    array goes out from its own memory.  ``np.savez`` sums them on one
    thread and copies every 16 MB twice holding the GIL, ~1 GB/s, while a
    training step's Python beside the writer thread waits on the GIL."""
    fmt = np.lib.format
    entries = []
    for key, a in arrays.items():
        if not (a.flags.c_contiguous or a.flags.f_contiguous):
            a = a.copy()
        head = io.BytesIO()
        fmt.write_array_header_1_0(head, fmt.header_data_from_array_1_0(a))
        data = a if a.flags.c_contiguous else a.T
        entries.append((key + ".npy", head.getvalue(),
                        memoryview(data.reshape(-1)).cast("B")))
    crc = lambda e: zlib.crc32(e[2], zlib.crc32(e[1]))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool, \
            zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                            allowZip64=True) as zf:
        for (name, head, data), c in zip(entries, pool.map(crc, entries)):
            info = zipfile.ZipInfo(name, time.localtime()[:6])
            info.external_attr = 0o600 << 16          # as ZipFile.open's
            info.file_size = info.compress_size = len(head) + len(data)
            info.CRC = c
            info.header_offset = zf.fp.tell()
            zf.fp.write(info.FileHeader(zip64=True))
            zf.fp.write(head)
            zf.fp.write(data)
            zf.filelist.append(info)
            zf.NameToInfo[name] = info
        zf.start_dir = zf.fp.tell()     # the central directory goes here


def _flatten(state) -> Dict[str, Tuple[np.ndarray, str]]:
    return {(_SEP.join(path) or f"leaf{i}"): _to_numpy(leaf)
            for i, (path, leaf) in enumerate(leaves(state))}


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_write
        self._errors = []
        self.writes = []       # {"step", "bytes", "seconds"} of each write
        self._worker = None
        self._group = dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1
        self.writer = not self._group or dist.get_rank() == 0
        if async_write and self.writer:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ----- write -----
    def save(self, step: int, state, *, block: bool = False):
        """Copy ``state`` to the host now and write it, on the writer thread
        unless the store is synchronous or ``block``."""
        arrays = _flatten(state)
        if not self.writer:
            return
        if self._async and not block:
            self._q.put((step, arrays))
        else:
            self._write(step, arrays)

    def wait(self):
        """Block until every queued write is on disk; raise the first error
        a queued write met.  Under a process group every rank waits here
        until rank 0's writes are on disk."""
        self._q.join()
        if self._group:
            dist.barrier()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("checkpoint write failed") from err

    def _drain(self):
        while True:
            step, arrays = self._q.get()
            try:
                self._write(step, arrays)
            except Exception as e:      # raised again by wait()
                self._errors.append(e)
            finally:
                # the host copy goes once written: the thread lives on,
                # waiting for the next write (or, the run over, none)
                del arrays
                self._q.task_done()

    def _write(self, step: int, arrays):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _save_npz(os.path.join(tmp, "leaves.npz"),
                  {k: a for k, (a, _) in arrays.items()})
        meta = {"step": step,
                "dtypes": {k: dt for k, (_, dt) in arrays.items()},
                "shapes": {k: list(a.shape) for k, (a, _) in arrays.items()}}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self.writes.append({"step": step, "seconds": time.perf_counter() - t0,
                            "bytes": sum(os.path.getsize(os.path.join(final, n))
                                         for n in os.listdir(final))})
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----- read -----
    def list_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "tree.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like):
        """Restore step ``step`` into ``like``'s tensors, in place (the live
        state keeps its tensors, so a model that holds them computes with
        the restored values); returns (like, step).  Every key, shape and
        dtype must match."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "tree.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "leaves.npz")) as data, \
                torch.no_grad():
            for i, (kp, leaf) in enumerate(leaves(like)):
                key = _SEP.join(kp) or f"leaf{i}"
                arr = data[key]
                dt = str(leaf.dtype).replace("torch.", "")
                if tuple(arr.shape) != tuple(leaf.shape) \
                        or meta["dtypes"][key] != dt:
                    raise ValueError(
                        f"checkpoint {path}: {key} is {meta['dtypes'][key]} "
                        f"{tuple(arr.shape)}, the state holds {dt} "
                        f"{tuple(leaf.shape)}")
                if leaf.dtype in _BITS:
                    t = torch.from_numpy(arr.view(np.int16)).view(leaf.dtype)
                else:
                    t = torch.from_numpy(arr)
                sh.local(leaf).copy_(sh.local_chunk(t, leaf))
        return like, step

    def restore_latest(self, like) -> Optional[Tuple[Any, int]]:
        steps = self.list_steps()
        if not steps:
            return None
        return self.restore(steps[-1], like)
