"""Async full-state checkpoint manager for preemption-safe training — the
port of the JAX package's ``checkpoint/manager.py``, in the same format.

:class:`CheckpointManager` snapshots the *entire* training state so a
SIGKILLed run resumes bit-identical to an uninterrupted one.  A checkpoint
is a pair of files under one directory:

* ``ckpt_<step>.npz``  — every state leaf, flattened by tree path (the
  naming of :mod:`repro_torch.checkpoint.store`), bfloat16 recorded by name
  so it round-trips through npz's void encoding.
* ``ckpt_<step>.json`` — the manifest: step, a sha256 per leaf (a torn or
  corrupted payload is *detected*, not restored), plan/data digests (a
  resume against another plan or dataset is *refused*), and the caller's
  opaque ``train`` payload (RNG stream positions, the round cursor,
  History, retrace signatures).

Write protocol (what makes SIGKILL at any instant survivable):

1. payload npz  → tmp file → ``os.replace``  (atomic)
2. manifest json → tmp file → ``os.replace`` (atomic; its presence commits
   the checkpoint — an npz without a manifest is an orphan, ignored by
   :meth:`CheckpointManager.latest_step` and swept by the next save)

``async_=True`` (default) splits a save across threads.  The caller's
thread copies every leaf to a private host array (``.detach().cpu()`` and a
numpy copy: a CPU tensor's ``.cpu()`` is the tensor itself and ``.numpy()``
shares its storage, so without the copy the writer would read values a
later round overwrote) and takes a JSON round trip of ``train`` (History's
lists grow every round).  A single background writer then hashes,
serializes, fsyncs and prunes off the training thread, fed over a
*bounded* queue, so a slow disk backpressures the trainer instead of
dropping checkpoints.  Writer errors surface on the next ``save`` /
``wait`` / ``close``.

The chaos hook: with ``REPRO_CHAOS_KILL_ROUND`` set (the fault-injection
harness, :mod:`repro_torch.checkpoint.chaos`), the process SIGKILLs itself
right after that round's checkpoint is durable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import re
import signal
import tempfile
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.store import (
    _resolve_dtype, _undo_void, dtype_name, from_host, sweep_tmp_files,
    to_host,
)
from repro_torch.utils.pytree import flatten_with_paths, map_with_paths

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.(npz|json)$")

MANIFEST_FORMAT = 1


class CheckpointRefused(ValueError):
    """The checkpoint is intact but belongs to a DIFFERENT run (plan or
    dataset digest mismatch).  Unlike corruption this never falls back to
    an older step: every checkpoint in the directory shares the identity."""


# --------------------------------------------------------------------------
# digests + trace signatures — the "same run?" identity helpers
# --------------------------------------------------------------------------
def digest_json(obj: Any) -> str:
    """sha256 over the canonical JSON encoding of ``obj``."""
    enc = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                     default=str)
    return hashlib.sha256(enc.encode()).hexdigest()


def trace_signature(args: Any, static: Tuple = ()) -> str:
    """Stable signature of one input structure: the tree's paths, each
    leaf's shape and dtype (tensors, arrays) or repr (anything else), and
    ``static``.  Two processes see the same signature for the same inputs,
    which keeps retrace counts exact across a resume."""
    parts = []
    for path, x in flatten_with_paths(args):
        parts.append(f"{path}={tuple(x.shape)}:{x.dtype}"
                     if hasattr(x, "shape") else f"{path}={x!r}")
    parts += [repr(s) for s in static]
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


class TraceCounter:
    """Counter of distinct signatures that survives resume: ``count(sig)``
    increments only for signatures not seen in this process or restored
    from a checkpoint's :meth:`snapshot`."""

    def __init__(self):
        self.count_value = 0
        self.seen: set = set()

    def count(self, sig: str) -> None:
        if sig not in self.seen:
            self.seen.add(sig)
            self.count_value += 1

    def snapshot(self) -> Dict:
        return {"count": self.count_value, "seen": sorted(self.seen)}

    def restore(self, snap: Dict) -> None:
        self.count_value = int(snap["count"])
        self.seen = set(snap["seen"])


# --------------------------------------------------------------------------
# the manager
# --------------------------------------------------------------------------
def _leaf_hash(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@dataclasses.dataclass
class _SaveJob:
    step: int
    flat: Dict[str, np.ndarray]
    manifest: Dict


class CheckpointManager:
    """Periodic full-state checkpointing with an async writer thread."""

    def __init__(self, directory: str, keep: int = 3, async_: bool = True,
                 queue_size: int = 2):
        if keep < 0:
            raise ValueError("keep must be ≥ 0 (0 = keep everything)")
        if queue_size < 1:
            raise ValueError("queue_size must be ≥ 1")
        self.directory = directory
        self.keep = keep
        self.async_ = async_
        os.makedirs(directory, exist_ok=True)
        self._error: Optional[BaseException] = None
        self._queue: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        if async_:
            self._queue = queue.Queue(maxsize=queue_size)
            self._writer = threading.Thread(target=self._writer_loop,
                                            name="ckpt-writer", daemon=True)
            self._writer.start()
        chaos = os.environ.get("REPRO_CHAOS_KILL_ROUND")
        self._chaos_kill_round = int(chaos) if chaos else None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state_tree: Any,
             train: Optional[Dict] = None,
             plan_digest: Optional[str] = None,
             data_digest: Optional[str] = None) -> None:
        """Snapshot ``state_tree`` as checkpoint ``step``.

        On the caller's thread: every leaf copied to a private host array
        and ``train`` (the JSON-able exact-resume payload) copied by a JSON
        round trip; with ``async_`` everything else runs on the writer.
        """
        self._raise_pending()
        leaves = flatten_with_paths(state_tree)
        flat = {k: to_host(v) for k, v in leaves}
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": int(step),
            "plan_digest": plan_digest,
            "data_digest": data_digest,
            "dtypes": {k: dtype_name(v) for k, v in leaves},
            "train": json.loads(json.dumps(train or {})),
        }
        job = _SaveJob(step=int(step), flat=flat, manifest=manifest)
        if self.async_:
            self._queue.put(job)   # blocks when the writer lags: backpressure
        else:
            self._write(job)
        self._maybe_chaos_kill(step)

    def wait(self) -> None:
        """Block until every enqueued checkpoint is durable."""
        if self.async_:
            self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain the queue and stop the writer thread."""
        if self.async_ and self._writer is not None:
            self._queue.join()
            self._queue.put(None)          # sentinel
            self._writer.join()
            self._writer = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """Committed checkpoint steps (manifest + payload both present)."""
        if not os.path.isdir(self.directory):
            return []
        by_step: Dict[int, set] = {}
        for f in os.listdir(self.directory):
            m = _CKPT_RE.match(f)
            if m:
                by_step.setdefault(int(m.group(1)), set()).add(m.group(2))
        return sorted(s for s, kinds in by_step.items()
                      if kinds == {"npz", "json"})

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> Dict:
        with open(self._path(step, "json")) as f:
            return json.load(f)

    def restore(self, template_tree: Any, step: Optional[int] = None,
                allow_lossy_cast: bool = False,
                manifest_check=None) -> Tuple[Any, Dict]:
        """Restore checkpoint ``step`` (default: the latest *valid* one)
        into ``template_tree``'s structure, each tensor leaf on its
        template leaf's device.

        Every leaf is integrity-checked against the manifest's sha256 and
        shape/dtype-checked against the template.  With ``step=None``
        invalid checkpoints are skipped, newest first, with a warning; an
        explicit ``step`` fails hard.  ``manifest_check(manifest)`` runs
        before any leaf is read — raise :class:`CheckpointRefused` there
        to reject a checkpoint outright, bypassing the fallback.
        """
        if step is not None:
            return self._restore_step(template_tree, step, allow_lossy_cast,
                                      manifest_check)
        last_err: Optional[BaseException] = None
        for s in reversed(self.steps()):
            try:
                return self._restore_step(template_tree, s, allow_lossy_cast,
                                          manifest_check)
            except CheckpointRefused:
                raise                # wrong run entirely — never fall back
            except Exception as e:   # torn/corrupt — fall back to older
                warnings.warn(f"checkpoint {s} under {self.directory} is "
                              f"invalid ({e}); trying the previous one")
                last_err = e
        raise FileNotFoundError(
            f"no valid checkpoint under {self.directory}"
            + (f" (latest failure: {last_err})" if last_err else ""))

    def _restore_step(self, template_tree: Any, step: int,
                      allow_lossy_cast: bool,
                      manifest_check=None) -> Tuple[Any, Dict]:
        manifest = self.read_manifest(step)
        if manifest_check is not None:
            manifest_check(manifest)
        with np.load(self._path(step, "npz"), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        dtypes = manifest.get("dtypes", {})
        hashes = manifest.get("leaf_hashes", {})
        wanted = {k for k, _ in flatten_with_paths(template_tree)}
        extra = set(flat) - wanted
        if extra:
            raise KeyError(f"checkpoint {step} carries leaves the template "
                           f"does not: {sorted(extra)[:4]}…")

        def leaf(key, tmpl):
            if key not in flat:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            name = dtypes.get(key)
            arr = _undo_void(flat[key], name)
            if hashes.get(key) != _leaf_hash(arr):
                raise ValueError(f"integrity hash mismatch for {key!r} in "
                                 f"checkpoint {step}")
            return from_host(arr, _resolve_dtype(name, arr), tmpl, key,
                             allow_lossy=allow_lossy_cast)

        return map_with_paths(leaf, template_tree), manifest

    # -------------------------------------------------------- writer thread
    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._write(job)
            except BaseException as e:    # surfaced on next save/wait/close
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, job: _SaveJob) -> None:
        d = self.directory
        sweep_tmp_files(d)
        self._sweep_orphans(exclude=job.step)
        job.manifest["leaf_hashes"] = {k: _leaf_hash(v)
                                       for k, v in job.flat.items()}
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **job.flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(job.step, "npz"))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(job.manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(job.step, "json"))   # commit point
        self._gc()

    def _sweep_orphans(self, exclude: int) -> None:
        """Drop npz payloads whose manifest never landed (a crash between
        the two atomic replaces); ``exclude`` protects the in-flight step."""
        if not os.path.isdir(self.directory):
            return
        for f in os.listdir(self.directory):
            m = _CKPT_RE.match(f)
            if (m and m.group(2) == "npz" and int(m.group(1)) != exclude
                    and not os.path.exists(
                        self._path(int(m.group(1)), "json"))):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for s in self.steps()[:-self.keep]:
            for kind in ("json", "npz"):  # the manifest first: uncommit
                try:
                    os.remove(self._path(s, kind))
                except OSError:
                    pass

    # -------------------------------------------------------------- plumbing
    def _path(self, step: int, kind: str) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.{kind}")

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint writer thread failed") from err

    def _maybe_chaos_kill(self, step: int) -> None:
        if self._chaos_kill_round is None or step < self._chaos_kill_round:
            return
        self.wait()                     # the checkpoint must be durable —
        os.kill(os.getpid(), signal.SIGKILL)   # then die like a preemption
