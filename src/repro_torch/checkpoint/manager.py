"""Checkpoints: atomic, asynchronous, garbage-collected, in the JAX
package's on-disk format (``repro/checkpoint/manager.py``).

  * **Layout** — ``step_<n>/shard_0.npz`` holds the tree's leaves as
    ``a0, a1, ...`` in the reference's leaf order, and
    ``step_<n>/manifest.json`` their paths, dtype names and shapes
    (``{"step", "paths", "dtypes", "shapes", "n_shards": 1}``).
  * **bf16 without ml_dtypes** — numpy has no bf16, so a bf16 leaf is
    saved as its bit pattern (``uint16``, viewed through torch) and named
    ``bfloat16`` in the manifest, as the reference saves it.
  * **Atomic commit** — a save writes ``step_<n>.tmp/``, fsyncs the
    manifest, then renames the directory to ``step_<n>/``: a crash
    mid-save never leaves a half-written checkpoint visible, and
    :meth:`CheckpointManager.latest_step` skips a directory without a
    manifest.
  * **Async save** — the leaves are copied to host memory before
    :meth:`CheckpointManager.save` returns (so in-place updates after it
    cannot reach the snapshot; on the CPU a tensor's numpy view would
    share the parameter's memory), and a background thread writes them.
    A failed write is raised by the next :meth:`~CheckpointManager.wait`
    (or ``save``).
  * **Restore** — into the structure and dtypes of ``like`` (real or
    meta tensors), on the device asked for; a checkpoint whose leaf paths
    or shapes differ from ``like``'s is refused.
  * **GC** — the last ``keep`` checkpoints stay.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, tree_unflatten


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it; bf16 as its
    uint16 bit pattern."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Snapshot ``tree`` at ``step``.  The leaves are copied to host
        memory now; non-blocking mode writes them on a background
        thread."""
        self.wait()  # one outstanding async save at a time
        paths, leaves = leaves_with_paths(tree)
        dtypes = [str(x.dtype).removeprefix("torch.") for x in leaves]
        host = [_to_host(x) for x in leaves]
        if blocking:
            self._write(step, paths, dtypes, host)
            return

        def run():
            try:
                self._write(step, paths, dtypes, host)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _write(self, step: int, paths: List[str], dtypes: List[str],
               host: List[np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "paths": paths,
            "dtypes": dtypes,
            "shapes": [list(a.shape) for a in host],
            "n_shards": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        """Wait for the outstanding async save; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                full = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(full, "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: Optional[int], like: Any, *, device=None) -> Any:
        """The checkpoint at ``step`` (None: the latest) in the structure
        of ``like``, each leaf in its ``like`` leaf's dtype, on ``device``
        (default: each ``like`` leaf's device, the CPU for a meta one)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, leaves = leaves_with_paths(like)
        if paths != manifest["paths"]:
            raise ValueError("checkpoint tree mismatch: "
                             f"{set(paths) ^ set(manifest['paths'])}")
        shapes = [list(x.shape) for x in leaves]
        if shapes != manifest["shapes"]:
            bad = [p for p, a, b in zip(paths, shapes, manifest["shapes"])
                   if a != b]
            raise ValueError(f"checkpoint shape mismatch: {bad}")
        out = []
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            for i, (leaf, name) in enumerate(zip(leaves, manifest["dtypes"])):
                dev = device
                if dev is None:
                    dev = "cpu" if leaf.device.type == "meta" else leaf.device
                out.append(_from_host(data[f"a{i}"], name).to(
                    device=dev, dtype=leaf.dtype))
        return tree_unflatten(like, out)

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))
