"""Checkpointing with atomic manifests and async writes (PyTorch).

Counterpart of ``repro.checkpoint.manager``, with the same on-disk format,
so a checkpoint crosses between the two packages in both directions:

  ckpt_dir/
    step_000123/
      manifest.json        # step, n_leaves, leaves[{file, shape, dtype,
                           # nbytes}], extra
      arr_00000.npy ...    # one .npy per leaf
      _COMPLETE            # written last → atomic visibility

Leaves are numbered in the order of JAX's ``tree_flatten``
(:func:`~repro_torch.core.tree.pytree_leaves`): dict keys sorted, tuples
and NamedTuples expanded, ``None`` no leaf.  Writes go through a
``_tmp_step_*`` staging dir renamed into place, on a background thread;
``keep_last`` GC; a ``_COMPLETE`` marker hides a partial write from
discovery; a step whose payload fails validation is flagged ``_DAMAGED``
and restore falls back to the previous complete one.

Two points where tensors differ from JAX arrays:

* The train step updates params **in place**, so ``save`` returns only
  once every leaf is copied into host memory the checkpoint owns: a
  synchronous device-to-host copy on the card, an explicit copy on the CPU
  (where ``.cpu()`` would return the very tensor the next step rewrites).
* numpy has no bfloat16.  A bf16 leaf is written as the JAX package writes
  it — its raw 16-bit words, ``.npy`` descr ``<V2``, manifest dtype
  ``"bfloat16"`` — and restored bitwise as ``torch.bfloat16``.  (The JAX
  package's own restore rejects such a leaf: ``np.load`` gives ``|V2``,
  which fails its dtype check.  The port does not reproduce that.)

A sharded run (``zero``, a ``sharding.zero.Zero3``) keeps the format: full
logical arrays, one ``.npy`` a leaf, so a checkpoint written from any world
size and mesh restores onto any other.  ``save`` gathers each sharded leaf
(its 2-D blocks over ``data`` × ``model`` included) to rank 0 in pieces of
at most ``core.tree.PIECE`` elements; rank 0 alone writes (synchronously)
and marks ``_COMPLETE``, the other ranks wait at a barrier.
``restore_into`` has each rank read only its block of each leaf from a
memory map.  Markers and garbage collection are rank 0's.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import PIECE, pytree_leaves, pytree_unflatten

_BF16 = "bfloat16"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_copy(x) -> tuple:
    """``(numpy array the checkpoint owns, manifest dtype)``; a bf16 leaf
    as its 16-bit words."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    t = t.to("cpu", copy=True)           # synchronous: complete on return
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16
    return t.numpy(), _dtype_name(t.dtype)


def _save_leaf(path: Path, a: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, a)
        return
    # the header np.save writes for a bfloat16 array: descr '<V2'
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": a.shape})
        np.ascontiguousarray(a).tofile(f)


def _as_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CorruptCheckpoint(RuntimeError):
    """A complete-looking checkpoint failed payload validation (missing,
    truncated, or garbled leaf file, or a shape/dtype mismatch)."""


class CheckpointManager:
    # Dropped into a checkpoint dir when restore finds its payload corrupt:
    # the dir keeps its ``_COMPLETE`` marker but becomes invisible to
    # discovery, and ``gc_incomplete`` reclaims the disk.
    DAMAGED_MARKER = "_DAMAGED"
    # The resumable-exit protocol (``repro_torch.fleet.preempt``): a
    # preempted run leaves this marker beside its boundary checkpoint; the
    # run that resumes it clears it.
    PREEMPT_MARKER = "_PREEMPTED.json"

    def __init__(self, directory: str | Path, *, keep_last: int = 3,
                 async_write: bool = True, gc_incomplete: bool = False,
                 zero=None):
        self.dir = Path(directory)
        self.zero = zero
        self.writer = zero is None or zero.mesh.rank == 0
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_write = async_write and zero is None
        self._thread: Optional[threading.Thread] = None
        # one dict a save (host_s: the copy to host memory, write_s: the
        # files) and a restore (read_s, copy_s), with the bytes moved
        self.timings: list = []
        if gc_incomplete and self.writer:
            self.gc_incomplete()
        self._barrier()

    def _barrier(self) -> None:
        if self.zero is not None:
            from repro_torch.sharding import collectives as C
            C.all_reduce_exact(torch.zeros(1, device=self.zero.mesh.device),
                               self.zero.world)

    def gc_incomplete(self) -> list[str]:
        """Remove crash-orphaned partial checkpoints: ``_tmp_step_*``
        staging dirs, any ``step_*`` dir missing its ``_COMPLETE`` marker,
        and any dir restore flagged ``_DAMAGED``.  Returns the removed dir
        names."""
        removed = []
        for p in sorted(self.dir.glob("_tmp_step_*")):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
        for p in sorted(self.dir.glob("step_*")):
            if p.is_dir() and (not (p / "_COMPLETE").exists()
                               or (p / self.DAMAGED_MARKER).exists()):
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p.name)
        return removed

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        """Snapshot ``tree`` at ``step``.  Returns once the host copy is
        complete; the files are written on a thread if ``async_write``."""
        t0 = time.perf_counter()
        if self.zero is None:
            host = [_host_copy(x) for x in pytree_leaves(tree)]
        else:
            host = self._gather_host(tree)
        rec = {"kind": "save", "step": step,
               "host_s": time.perf_counter() - t0,
               "bytes": sum(a.nbytes for a, _ in host)}
        self.timings.append(rec)
        self.wait()

        def _write():
            t1 = time.perf_counter()
            tmp = self.dir / f"_tmp_step_{step:09d}"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "n_leaves": len(host), "leaves": [],
                        "extra": extra or {}}
            for i, (a, dtype) in enumerate(host):
                fname = f"arr_{i:05d}.npy"
                _save_leaf(tmp / fname, a, dtype)
                manifest["leaves"].append(
                    {"file": fname, "shape": list(a.shape), "dtype": dtype,
                     "nbytes": (tmp / fname).stat().st_size})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "_COMPLETE").touch()
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            rec["write_s"] = time.perf_counter() - t1

        if self.zero is not None:
            if self.writer:
                _write()
            self._barrier()
        elif self.async_write:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _gather_host(self, tree) -> list:
        """Rank 0: ``[(numpy array, manifest dtype)]`` of the whole leaves
        of a sharded ``tree``, each split leaf gathered from the ranks
        holding its blocks (``Zero3.block_group``) in pieces of at most
        PIECE elements; the other ranks take part and return []."""
        from repro_torch.sharding import collectives as C
        zero = self.zero
        out = []
        for x, pl in zip(pytree_leaves(tree), zero.tree_dims(tree)):
            cuts = zero.block(pl)
            if not cuts:
                if self.writer:
                    out.append(_host_copy(x))
                continue
            group = zero.block_group(pl)
            flat = x.detach().reshape(-1)
            w = 1
            for _, n, _ in cuts:
                w *= n
            parts = torch.empty((w, flat.numel()), dtype=x.dtype)
            for at in range(0, flat.numel(), PIECE):
                piece = C._gather_flat(flat[at:at + PIECE], group)
                if self.writer:
                    parts[:, at:at + piece.shape[1]].copy_(piece)
            if self.writer:
                blocks = list(parts.reshape((w,) + tuple(x.shape)).unbind(0))
                for d, n, _ in reversed(cuts):
                    # the last cut's blocks are adjacent in the group's order
                    blocks = [torch.cat(blocks[i:i + n], dim=d)
                              for i in range(0, len(blocks), n)]
                out.append(_host_copy(blocks[0]))
        return out

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self._complete_steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------- discovery ----------------
    def _complete_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if ((p / "_COMPLETE").exists()
                    and not (p / self.DAMAGED_MARKER).exists()):
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._complete_steps()
        return max(steps) if steps else None

    # ---------------- preemption marker ----------------
    def write_preempt_marker(self, step: int, **info) -> Path:
        marker = self.dir / self.PREEMPT_MARKER
        if not self.writer:
            return marker
        tmp = self.dir / (self.PREEMPT_MARKER + ".tmp")
        tmp.write_text(json.dumps({"step": step, "resumable": True, **info}))
        tmp.rename(marker)     # atomic: readers never see a partial marker
        return marker

    def read_preempt_marker(self) -> Optional[dict]:
        marker = self.dir / self.PREEMPT_MARKER
        if not marker.exists():
            return None
        return json.loads(marker.read_text())

    def clear_preempt_marker(self) -> None:
        marker = self.dir / self.PREEMPT_MARKER
        if self.writer and marker.exists():
            marker.unlink()
        self._barrier()

    # ---------------- restore ----------------
    def _flag_damaged(self, d: Path, err: str) -> None:
        try:
            (d / self.DAMAGED_MARKER).write_text(err)
        except OSError:
            pass   # flagging is best-effort; discovery re-validates anyway

    def _load_leaves(self, d: Path, mmap: bool = False) -> tuple[dict, list]:
        """Read and validate one checkpoint dir's payload as CPU tensors
        (with ``mmap``, as read-only memory-mapped numpy arrays).  Raises
        :class:`CorruptCheckpoint` on any missing, truncated, garbled, or
        mismatched leaf."""
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptCheckpoint(f"{d.name}: unreadable manifest: {e}")
        leaves = []
        for meta in manifest["leaves"]:
            f = d / meta["file"]
            if not f.exists():
                raise CorruptCheckpoint(
                    f"{d.name}: missing leaf {meta['file']}")
            want = meta.get("nbytes")   # absent in older checkpoints
            if want is not None and f.stat().st_size != want:
                raise CorruptCheckpoint(
                    f"{d.name}: {meta['file']} is {f.stat().st_size} bytes, "
                    f"manifest says {want} (truncated?)")
            try:
                a = np.load(f, mmap_mode="r" if mmap else None)
            except Exception as e:
                raise CorruptCheckpoint(
                    f"{d.name}: {meta['file']} unparseable: {e}")
            words16 = a.dtype.kind == "V" and a.dtype.itemsize == 2
            dtype_ok = (str(a.dtype) == meta["dtype"]
                        or (meta["dtype"] == _BF16 and words16))
            if list(a.shape) != meta["shape"] or not dtype_ok:
                raise CorruptCheckpoint(
                    f"{d.name}: {meta['file']} is {a.dtype}{list(a.shape)}, "
                    f"manifest says {meta['dtype']}{meta['shape']}")
            leaves.append(a if mmap else _as_tensor(a, meta["dtype"]))
        if len(leaves) != manifest.get("n_leaves", len(leaves)):
            raise CorruptCheckpoint(
                f"{d.name}: {len(leaves)} leaves vs n_leaves="
                f"{manifest.get('n_leaves')}")
        return manifest, leaves

    def _read(self, step: Optional[int], mmap: bool = False
              ) -> tuple[int, dict, list]:
        """The requested step's (or, with ``step=None``, the newest valid
        step's) manifest and leaves as CPU tensors (``mmap``: numpy memory
        maps)."""
        t0 = time.perf_counter()
        if step is None:
            candidates = sorted(self._complete_steps(), reverse=True)
            if not candidates:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            manifest = leaves = None
            for s in candidates:
                d = self.dir / f"step_{s:09d}"
                try:
                    manifest, leaves = self._load_leaves(d, mmap)
                except CorruptCheckpoint as e:
                    if self.writer:
                        self._flag_damaged(d, str(e))
                    continue
                step = s
                break
            if manifest is None:
                raise CorruptCheckpoint(
                    f"every complete checkpoint in {self.dir} is damaged")
        else:
            manifest, leaves = self._load_leaves(
                self.dir / f"step_{step:09d}", mmap)
        self.timings.append({
            "kind": "restore", "step": step,
            "read_s": time.perf_counter() - t0,
            "bytes": sum(t.nbytes if mmap else t.numel() * t.element_size()
                         for t in leaves)})
        return step, manifest, leaves

    @staticmethod
    def _check(tmpl_leaves: list, leaves: list) -> None:
        if len(tmpl_leaves) != len(leaves):
            raise ValueError(f"leaf count mismatch {len(tmpl_leaves)} vs "
                             f"{len(leaves)}")
        for i, (t, a) in enumerate(zip(tmpl_leaves, leaves)):
            if t.shape != a.shape or t.dtype != a.dtype:
                raise ValueError(
                    f"leaf {i}: template {t.dtype}{list(t.shape)}, "
                    f"checkpoint {a.dtype}{list(a.shape)}")

    def restore(self, step: Optional[int] = None, *, template: Any
                ) -> tuple[int, Any, dict]:
        """Load a checkpoint as a new tree shaped like ``template``, each
        leaf on its template leaf's device, its shape and dtype checked.
        With ``step=None`` a checkpoint whose payload fails validation is
        flagged ``_DAMAGED`` and restore falls back to the next older
        complete step; an explicit ``step`` raises
        :class:`CorruptCheckpoint` instead.  Returns (step, tree, extra)."""
        step, manifest, leaves = self._read(step)
        tmpl = pytree_leaves(template)
        self._check(tmpl, leaves)
        leaves = [a.to(t.device) for t, a in zip(tmpl, leaves)]
        return step, pytree_unflatten(template, leaves), \
            manifest.get("extra", {})

    @torch.no_grad()
    def restore_into(self, tree: Any, step: Optional[int] = None
                     ) -> tuple[int, dict]:
        """As :meth:`restore`, but copied into ``tree``'s own tensors
        (``copy_``), so the device never holds a second copy and every
        reference to them stays valid.  Returns (step, extra).  Sharded
        (``zero``): each rank reads its slice of each leaf only."""
        if self.zero is not None:
            return self._restore_shards(tree, step)
        step, manifest, leaves = self._read(step)
        live = pytree_leaves(tree)
        self._check(live, leaves)
        t0 = time.perf_counter()
        for dst, src in zip(live, leaves):
            dst.copy_(src)
        if live and live[0].device.type == "cuda":
            torch.cuda.synchronize(live[0].device)
        self.timings[-1]["copy_s"] = time.perf_counter() - t0
        return step, manifest.get("extra", {})

    def _restore_shards(self, tree: Any, step: Optional[int]
                        ) -> tuple[int, dict]:
        step, manifest, arrays = self._read(step, mmap=True)
        live = pytree_leaves(tree)
        places = self.zero.tree_dims(tree)
        if len(live) != len(arrays):
            raise ValueError(f"leaf count mismatch {len(live)} vs "
                             f"{len(arrays)}")
        t0 = time.perf_counter()
        with torch.no_grad():
            for i, (dst, a, pl, meta) in enumerate(
                    zip(live, arrays, places, manifest["leaves"])):
                cuts = self.zero.block(pl)
                want = list(dst.shape)
                for d, n, _ in cuts:
                    want[d] *= n
                if list(a.shape) != want or meta["dtype"] != _dtype_name(
                        dst.dtype):
                    raise ValueError(
                        f"leaf {i}: template {dst.dtype}{want} (whole), "
                        f"checkpoint {meta['dtype']}{list(a.shape)}")
                idx = [slice(None)] * len(want)
                for d, _, k in cuts:
                    idx[d] = slice(k * dst.shape[d], (k + 1) * dst.shape[d])
                a = a[tuple(idx)]
                dst.copy_(_as_tensor(np.array(a), meta["dtype"]))
        if live and live[0].device.type == "cuda":
            torch.cuda.synchronize(live[0].device)
        self.timings[-1]["copy_s"] = time.perf_counter() - t0
        return step, manifest.get("extra", {})
