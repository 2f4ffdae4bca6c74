"""Checkpoint manager: async save, atomic publish, restore; port of
``repro/checkpoint/manager.py``.

A state is a tree of nested dicts, lists and tuples whose leaves are
tensors (or numpy arrays, or Python numbers).  Checkpoints hold full
logical arrays, so a restore places them anywhere: the restart path
(``runtime/fault.py``) and the elastic one (``runtime/elastic.py``) both
come through here.  An optional GWLZ stage compresses large float leaves
under an error bound (``gwlz_ckpt.py``).

The files are the reference's: ``step_NNNNNNNN/{arrays.npz,
manifest.json, <key>.gwlz}``, keys the ``/``-joined dict keys and sequence
indices in ``jax.tree_util``'s order (dict keys sorted), ``__`` for ``/``
in file names, numpy dtype names, bfloat16 stored as ``uint16``.  So each
package restores the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.kernels.ops import resolve_device

_SEP = "/"
# leaves at or above this many elements go through gwlz_ckpt when enabled
GWLZ_MIN_ELEMS = 65536
_GWLZ_DTYPES = ("float32", "bfloat16")


def _leaves(tree):
    """(key, leaf) pairs in ``jax.tree_util``'s order, keys ``/``-joined."""
    for path, leaf in tree_util.leaves(tree):
        yield _SEP.join(path), leaf


def _rebuild(tree, values: dict):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    return tree_util.rebuild(tree, lambda path, _: values[_SEP.join(path)])


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor; numbers and numpy arrays take numpy's dtype (a
    Python float is float64, as ``np.asarray`` makes it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as numpy; bfloat16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of :func:`_to_numpy` for a leaf stored under ``dtype``."""
    a = np.array(a)  # an owned, contiguous copy of any rank (0-d included)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _snapshot(tree) -> dict[str, torch.Tensor]:
    """Every leaf copied to the host, synchronously: the caller may update
    its tensors in place as soon as ``save`` returns."""
    flat = {}
    for key, leaf in _leaves(tree):
        t = _as_tensor(leaf).detach()
        flat[key] = t.to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else t
    return flat


class CheckpointManager:
    """``save(step, tree)`` -> ``directory/step_NNNNNNNN/{arrays.npz,
    manifest.json}`` (plus ``<key>.gwlz`` per compressed leaf), published
    atomically (written to a temporary directory, then renamed); the
    newest ``keep`` steps are kept.

    With ``gwlz_rel_eb`` set, float32 and bfloat16 leaves of at least
    :data:`GWLZ_MIN_ELEMS` elements are stored through
    :func:`~repro_torch.checkpoint.gwlz_ckpt.compress_tensor` under
    ``eb = gwlz_rel_eb`` times their range: within eb in its SZ branch, and
    within 2 eb in its GWLZ branch wherever the gate keeps a group, as in
    the reference (each plus float32 rounding; see ``compress_tensor``);
    every other leaf is stored exactly.
    Those leaves are compressed and restored on ``device`` (None: the CUDA
    device, which must exist).

    ``async_save`` writes on a background thread, which takes the
    compression device and a stream of its own; :meth:`wait` joins it and
    re-raises its error, if it had one.  The host copy of every leaf is
    taken before :meth:`save` returns."""

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True,
                 gwlz_rel_eb: float | None = None, device=None):
        self.dir = os.fspath(directory)
        self.keep = keep
        self.async_save = async_save
        self.gwlz_rel_eb = gwlz_rel_eb
        self.device = device
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.dir, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, block: bool = False) -> None:
        flat = _snapshot(tree)  # host copy happens here, synchronously
        codec = resolve_device(self.device) if self.gwlz_rel_eb is not None else None
        if codec is not None and codec.type == "cuda" and codec.index is None:
            codec = torch.device("cuda", torch.cuda.current_device())  # the caller's card
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, flat, codec), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, codec)

    def _write_async(self, step: int, flat: dict, codec) -> None:
        """The background save.  A new thread starts on the default CUDA
        device and stream, so it takes the codec's device and a stream of
        its own (enhancer training needs autograd, which is on by default
        in a new thread)."""
        try:
            if codec is not None and codec.type == "cuda":
                torch.cuda.set_device(codec)
                stream = torch.cuda.Stream(codec)
                with torch.cuda.stream(stream):
                    self._write(step, flat, codec)
                stream.synchronize()
            else:
                self._write(step, flat, codec)
        except BaseException as e:  # lint: allow RA004 -- handed to wait(), which re-raises it
            self._error = e

    def _write(self, step: int, flat: dict[str, torch.Tensor], codec) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "keys": {}, "gwlz": {}}
        plain: dict[str, np.ndarray] = {}
        for k, t in flat.items():
            dtype = dtype_name(t.dtype)
            manifest["keys"][k] = {"shape": list(t.shape), "dtype": dtype}
            fkey = k.replace(_SEP, "__")
            if (self.gwlz_rel_eb is not None and t.numel() >= GWLZ_MIN_ELEMS
                    and dtype in _GWLZ_DTYPES):
                from repro_torch.checkpoint.gwlz_ckpt import compress_tensor

                blob = compress_tensor(t, rel_eb=self.gwlz_rel_eb, device=codec)
                with open(os.path.join(tmp, fkey + ".gwlz"), "wb") as f:
                    f.write(blob)
                manifest["gwlz"][k] = True
            else:
                plain[fkey] = _to_numpy(t)
        np.savez(os.path.join(tmp, "arrays.npz"), **plain)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        """Join the background save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(d[5:]) for d in os.listdir(self.dir) if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: int | None = None, *, device=None, mesh=None,
                placements=None):
        """Restore into the structure of ``target_tree``: each leaf takes its
        target's dtype and its target's device (or ``device``, when given);
        shapes are checked against the manifest and the target.  Leaves
        that are not tensors restore as CPU tensors of their numpy dtype.
        With ``mesh`` (a ``DeviceMesh``) and ``placements`` (a tree of
        DTensor placement tuples matching the target), each leaf is
        restored whole onto the mesh's device type and placed as a DTensor
        (every rank reads the whole leaf and keeps its shard: the
        reference's ``shardings``)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            for key, leaf in _leaves(target_tree):
                target = _as_tensor(leaf)
                dev = torch.device(device) if device is not None else target.device
                fkey = key.replace(_SEP, "__")
                meta = manifest["keys"][key]
                if manifest["gwlz"].get(key):
                    from repro_torch.checkpoint.gwlz_ckpt import decompress_tensor

                    with open(os.path.join(d, fkey + ".gwlz"), "rb") as f:
                        t = decompress_tensor(f.read(), device=self.device)
                else:
                    t = _from_numpy(npz[fkey], meta["dtype"])
                want = tuple(meta["shape"])
                if not tuple(t.shape) == want == tuple(target.shape):
                    raise ValueError(f"checkpoint leaf {key!r}: stored shape "
                                     f"{tuple(t.shape)}, manifest {want}, target "
                                     f"{tuple(target.shape)}")
                if mesh is None:
                    values[key] = t.to(device=dev, dtype=target.dtype)
                else:
                    values[key] = self._place(t.to(dtype=target.dtype), mesh,
                                              tree_util.get(placements, tuple(key.split(_SEP))))
        return _rebuild(target_tree, values)

    @staticmethod
    def _place(t: torch.Tensor, mesh, placements):
        from torch.distributed.tensor import distribute_tensor

        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        return distribute_tensor(t.to(dev), mesh, placements, src_data_rank=None)
