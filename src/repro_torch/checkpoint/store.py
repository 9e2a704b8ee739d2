"""npz-based tree checkpointing — the port of the JAX package's
``checkpoint/store.py``, in the same file format.

Each leaf is saved under its tree path (``params/<path>``, ``opt/<path>``;
paths from :func:`repro_torch.utils.pytree.flatten_with_paths`, which names
leaves as the JAX package does) beside a JSON ``__meta__`` entry holding the
step, the caller's ``extra`` and every leaf's dtype name.  Extension dtypes
travel as npz void bytes: a ``torch.bfloat16`` leaf is written as ``|V2``
under the name ``"bfloat16"``, as the JAX package writes its ``ml_dtypes``
bfloat16, so each package reads the other's files.  Writes are atomic (tmp
file + rename) and the newest ``keep`` steps are retained.

Restores rebuild the template's structure and refuse a missing leaf, a
shape mismatch or a lossy dtype cast (:func:`check_cast`).  Tensor leaves
come back as tensors on the template leaf's device; :func:`load_params`,
the serving entry, returns every leaf as a tensor on the device it is
asked for (``"cuda"`` unless the caller passes another).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.utils.pytree import flatten_with_paths, map_with_paths

_STEP_RE = re.compile(r"step_(\d+)\.npz$")

#: the recorded name of bfloat16, which numpy has no dtype for
BF16 = "bfloat16"

DType = Union[np.dtype, str]


def sweep_tmp_files(directory: str) -> int:
    """Remove orphaned ``*.tmp`` files left by a writer crash (a crash
    between ``mkstemp`` and ``os.replace``); returns how many went.  Only a
    directory's one writer calls it, before it writes."""
    if not os.path.isdir(directory):
        return 0
    removed = 0
    for f in os.listdir(directory):
        if f.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, f))
                removed += 1
            except OSError:
                pass
    return removed


# --------------------------------------------------------------------------
# leaves ↔ host arrays
# --------------------------------------------------------------------------
def to_host(leaf: Any) -> np.ndarray:
    """A leaf as a private numpy array: tensors detached and copied to the
    host (bfloat16 as ``|V2`` bytes), Python ints as int32 scalars (the
    JAX package's optimizer step), numpy arrays copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype is torch.bfloat16:
            return np.array(t.view(torch.int16).numpy(), copy=True).view("V2")
        return np.array(t.numpy(), copy=True)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True)


def dtype_name(leaf: Any) -> str:
    """The dtype name a leaf is recorded under (``"bfloat16"`` for bf16)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype is torch.bfloat16:
            return BF16
        return str(leaf.dtype).replace("torch.", "")
    return to_host(leaf).dtype.name


def _resolve_dtype(name: Optional[str], arr: np.ndarray) -> DType:
    """The dtype a stored array really holds: its recorded name (bfloat16
    stays a name), else the array's own."""
    if name is None:
        return arr.dtype
    if name == BF16:
        return BF16
    return np.dtype(name)


def _undo_void(arr: np.ndarray, name: Optional[str]) -> np.ndarray:
    """Recover a numpy dtype npz stored as void bytes; bfloat16 stays
    ``|V2`` (numpy has no such dtype) until it becomes a tensor."""
    if name is None or name == BF16:
        return arr
    dt = np.dtype(name)
    if arr.dtype != dt and arr.dtype.kind == "V" \
            and arr.dtype.itemsize == dt.itemsize:
        return arr.view(dt)
    return arr


#: the value-preserving casts out of bfloat16
_BF16_TO = {np.dtype(np.float32), np.dtype(np.float64)}


def check_cast(src: DType, dst: DType, key: str,
               allow_lossy: bool = False) -> None:
    """Raise unless ``src → dst`` is a value-preserving cast.

    ``np.can_cast(..., casting="safe")`` is the rule (f32→bf16, f64→f32 and
    float→int all fail it), with bfloat16 as a name that widens only into
    f32/f64.  Silently casting those is how a resumed run diverges from the
    uninterrupted one without a single error; ``allow_lossy=True`` is the
    explicit opt-in.
    """
    if src == dst or allow_lossy:
        return
    if BF16 in (src, dst):
        ok = src == BF16 and dst in _BF16_TO
    else:
        try:
            ok = np.can_cast(src, dst, casting="safe")
        except TypeError:
            ok = False
    if not ok:
        raise TypeError(
            f"lossy dtype cast for {key!r}: checkpoint {src} → template "
            f"{dst} is not value-preserving; pass allow_lossy_cast=True to "
            "force it")


def _template_dtype(leaf: Any) -> DType:
    name = dtype_name(leaf)
    return BF16 if name == BF16 else np.dtype(name)


def from_host(arr: np.ndarray, src: DType, template: Any, key: str,
              allow_lossy: bool = False, device=None) -> Any:
    """A stored array as a leaf like ``template``: its shape is checked, its
    dtype cast only if value-preserving, and it lands where the template
    leaf lives (a tensor on its device, or on ``device`` when given; a
    Python int; a numpy array)."""
    if tuple(arr.shape) != tuple(np.shape(template)):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                         f"template {tuple(np.shape(template))}")
    want = _template_dtype(template)
    check_cast(src, want, key, allow_lossy=allow_lossy)
    if src == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(template, torch.Tensor):
        dev = template.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=template.dtype)
    if isinstance(template, (int, np.integer)):
        return int(t)
    if device is not None:
        return t.to(device=torch.device(device), dtype=torch.float32
                    if want == BF16 else getattr(torch, str(want)))
    return t.to(torch.float32).numpy() if want == BF16 else \
        t.numpy().astype(want)


def _flat_host(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}{k}": to_host(v) for k, v in flatten_with_paths(tree)}


def _flat_names(tree: Any, prefix: str) -> Dict[str, str]:
    return {f"{prefix}{k}": dtype_name(v) for k, v in flatten_with_paths(tree)}


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------
def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None, extra: Optional[dict] = None,
                    keep: int = 3) -> str:
    """Write ``step_<step>.npz`` under ``directory`` atomically and keep the
    newest ``keep`` steps; returns the path."""
    os.makedirs(directory, exist_ok=True)
    sweep_tmp_files(directory)
    payload = _flat_host(params, "params/")
    names = _flat_names(params, "params/")
    if opt_state is not None:
        payload.update(_flat_host(opt_state, "opt/"))
        names.update(_flat_names(opt_state, "opt/"))
    meta = {"step": int(step), "extra": extra or {}, "dtypes": names}
    path = os.path.join(directory, f"step_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **payload)
    os.replace(tmp, path)
    _gc(directory, keep)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if not f.endswith(".tmp") and (m := _STEP_RE.search(f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, params_template: Any,
                       opt_template: Any = None, step: Optional[int] = None,
                       allow_lossy_cast: bool = False, device=None):
    """Restore into the *structure* of the given templates.

    Returns ``(params, opt_state, meta)``.  Raises if a leaf is missing,
    has a mismatched shape, or needs a lossy dtype cast; safe widening
    casts (bf16→f32, f32→f64) apply transparently.  Leaves land on the
    template leaf's device, or on ``device`` when given.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with np.load(os.path.join(directory, f"step_{step}.npz"),
                 allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    dtypes = meta.get("dtypes", {})

    def rebuild(template, prefix):
        def leaf(path, tmpl):
            key = prefix + path
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            name = dtypes.get(key)
            arr = _undo_void(flat[key], name)
            return from_host(arr, _resolve_dtype(name, arr), tmpl, key,
                             allow_lossy=allow_lossy_cast, device=device)
        return map_with_paths(leaf, template)

    params = rebuild(params_template, "params/")
    opt_state = (rebuild(opt_template, "opt/") if opt_template is not None
                 else None)
    return params, opt_state, meta


def load_params(directory: str, params_template: Any,
                step: Optional[int] = None, device="cuda"):
    """Params-only restore for serving: returns ``(params, meta)``, every
    leaf a tensor on ``device``.

    The train→serve handoff: the round engine exports
    ``EngineState.params`` through :func:`save_checkpoint`; serving
    restores just the parameter tree (optimizer state, if any, is
    ignored).  Same strictness as :func:`restore_checkpoint`.  The template
    may hold tensors or numpy arrays (``GNNModel.init_numpy``).
    """
    params, _, meta = restore_checkpoint(directory, params_template,
                                         step=step, device=device)
    return params, meta


def _gc(directory: str, keep: int) -> None:
    entries = sorted(
        ((int(m.group(1)), f) for f in os.listdir(directory)
         if (m := _STEP_RE.search(f))),
    )
    for _, f in entries[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(directory, f))
        except OSError:
            pass
