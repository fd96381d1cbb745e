"""Checkpointing: atomic, async, schedule-agnostic (counterpart of
``repro/checkpoint/checkpoint.py``).

Layout: ``<dir>/step_<k:08d>/`` holding ``tensors.bin`` (every tensor's
raw bytes, back to back) and ``manifest.json`` (the step, the caller's
``extra`` dict, and per entry its name, dtype, shape and byte offset).
Writes go to ``step_<k:08d>.tmp`` and are renamed atomically, so a crash
mid-write never corrupts the latest checkpoint: the restart loop
(``runtime/fault_tolerance.py``) always finds a complete one.

A tree is a nested dict whose leaves are tensors or Python numbers.  Each
entry is keyed by its path (``params/<name>``, ``opt_state/m/<name>``,
``opt_state/step``); numbers ride in the manifest.  numpy has no
bfloat16, so a bf16 tensor is stored as its raw 16-bit pattern and
recorded as ``"bfloat16"``: a restore gives back the same bits.

``restore`` writes into the tensors of ``like`` in place (``copy_`` under
``torch.no_grad()``), after checking every entry's name, shape and dtype,
so a live model, the hooks on its parameters and the optimizer state that
points at them keep their identity.

Plan-aware: ``save(..., plan=...)`` drops the active ``planning.Plan``
JSON beside the weights (``plan.json``, same atomic rename) and
``tuner=`` the tuner state (``tuner.json``); ``load_plan`` and
``load_tuner_state`` read them back.  The files are the JAX package's, so
either package reads the other's.

``AsyncCheckpointer.save`` copies every tensor to host memory before it
returns (``clone()`` on the CPU, a completed device-to-host copy on CUDA):
the port's optimizer updates parameters, moments and residual in place,
so the background thread that writes the files must never see live
tensors.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]

_MANIFEST = "manifest.json"
_DATA = "tensors.bin"
_PLAN = "plan.json"
_TUNER = "tuner.json"

_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _entries(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every tensor or number of ``tree``, depth first."""
    out = []
    for key, value in tree.items():
        if not isinstance(key, str) or "/" in key:
            raise ValueError(f"checkpoint keys are strings without '/': {key!r}")
        path = prefix + key
        if isinstance(value, Mapping):
            out += _entries(value, path + "/")
        elif isinstance(value, (torch.Tensor, int, float)):
            out.append((path, value))
        elif value is not None:
            raise TypeError(f"{path}: cannot checkpoint a {type(value).__name__}")
    return out


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in host memory as a numpy array (bf16 as its int16
    bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _snapshot(tree: Tree) -> dict:
    """A copy of ``tree`` in host memory that shares nothing with it."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _snapshot(value)
        elif isinstance(value, torch.Tensor):
            value = value.detach()
            out[key] = value.clone() if value.device.type == "cpu" else value.cpu()
        else:
            out[key] = value
    return out


def _plan_text(plan: Any) -> str | None:
    """Serialize a plan argument: a ``planning.Plan``, a pre-serialized
    JSON string, or a JSON dict (duck-typed: checkpointing does not
    depend on the planning package)."""
    if plan is None:
        return None
    if isinstance(plan, str):
        return plan
    if hasattr(plan, "to_json"):
        return plan.to_json()
    return json.dumps(plan, indent=1)


def _tuner_text(tuner: Any) -> str | None:
    """Serialize tuner state: a ``planning.Tuner`` (via ``state_dict``),
    a pre-serialized JSON string, or a JSON dict."""
    if tuner is None:
        return None
    if isinstance(tuner, str):
        return tuner
    if hasattr(tuner, "state_dict"):
        tuner = tuner.state_dict()
    return json.dumps(tuner, indent=1)


def _step_dir(directory: str | pathlib.Path, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"step_{step:08d}"


def save(
    directory: str | pathlib.Path,
    step: int,
    tree: Tree,
    extra: dict | None = None,
    plan: Any | None = None,
    tuner: Any | None = None,
) -> pathlib.Path:
    """Atomic synchronous save; returns the final path.

    ``plan`` (a ``planning.Plan``, its JSON dict, or its JSON text) is
    written as ``plan.json`` inside the step directory under the same
    atomic rename, and ``tuner`` (a ``planning.Tuner``, its
    ``state_dict``, or JSON text) as ``tuner.json``.  A checkpoint of the
    same step is replaced."""
    final = _step_dir(directory, step)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    entries, scalars, offset = [], {}, 0
    with open(tmp / _DATA, "wb") as f:
        for path, leaf in _entries(tree):
            if not isinstance(leaf, torch.Tensor):
                scalars[path] = leaf
                continue
            arr = _host_array(leaf)
            arr.tofile(f)
            entries.append({"name": path, "dtype": _DTYPE_NAMES[leaf.dtype],
                            "shape": list(leaf.shape), "offset": offset, "nbytes": arr.nbytes})
            offset += arr.nbytes
    manifest = {"step": step, "nbytes": offset, "entries": entries, "scalars": scalars,
                "extra": extra or {}}
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    plan_text = _plan_text(plan)
    if plan_text is not None:
        (tmp / _PLAN).write_text(plan_text)
    tuner_text = _tuner_text(tuner)
    if tuner_text is not None:
        (tmp / _TUNER).write_text(tuner_text)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def load_plan(directory: str | pathlib.Path, step: int):
    """The ``planning.Plan`` stored beside checkpoint ``step`` (None when
    the checkpoint has none)."""
    path = _step_dir(directory, step) / _PLAN
    if not path.exists():
        return None
    from ..planning import Plan

    return Plan.from_json(path.read_text())


def load_tuner_state(directory: str | pathlib.Path, step: int) -> dict | None:
    """The tuner state dict stored beside checkpoint ``step`` (None when
    the run was not auto-tuned); feed it to ``planning.Tuner.load_state``."""
    path = _step_dir(directory, step) / _TUNER
    if not path.exists():
        return None
    return json.loads(path.read_text())


def available_steps(directory: str | pathlib.Path) -> list[int]:
    """All *complete* checkpoint steps in ``directory``, ascending.

    A checkpoint is complete when its final (renamed) directory holds a
    manifest: ``.tmp`` directories from a write killed mid-flight are
    ignored."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / _MANIFEST).exists():
                steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str | pathlib.Path) -> int | None:
    """The newest complete checkpoint step in ``directory`` (None when
    there is none)."""
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _rebuild(like: Tree, scalars: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in like.items():
        path = prefix + key
        if isinstance(value, Mapping):
            out[key] = _rebuild(value, scalars, path + "/")
        elif isinstance(value, (int, float)):
            out[key] = type(value)(scalars[path])
        else:
            out[key] = value
    return out


def restore(directory: str | pathlib.Path, step: int, like: Tree) -> tuple[dict, dict]:
    """Restore checkpoint ``step`` into the structure of ``like``:
    ``(tree, extra)``.  Every tensor of ``like`` receives its entry in
    place (``copy_`` under ``torch.no_grad()``, onto whatever device it
    lives on); numbers come back as new values in ``tree``.  Raises
    ``ValueError``, before anything is written, when an entry is missing
    or its shape or dtype differs from ``like``'s."""
    path = _step_dir(directory, step)
    manifest = json.loads((path / _MANIFEST).read_text())
    stored = {e["name"]: e for e in manifest["entries"]}
    scalars = manifest["scalars"]
    want = _entries(like)
    for name, leaf in want:
        if not isinstance(leaf, torch.Tensor):
            if name not in scalars:
                raise ValueError(f"checkpoint has no value {name!r}")
            continue
        e = stored.get(name)
        if e is None:
            raise ValueError(f"checkpoint has no entry {name!r}")
        if tuple(e["shape"]) != tuple(leaf.shape):
            raise ValueError(f"checkpoint shape {tuple(e['shape'])} != expected "
                             f"{tuple(leaf.shape)} for {name!r}")
        if e["dtype"] != _DTYPE_NAMES[leaf.dtype]:
            raise ValueError(f"checkpoint dtype {e['dtype']} != expected "
                             f"{_DTYPE_NAMES[leaf.dtype]} for {name!r}")
    with open(path / _DATA, "rb") as f, torch.no_grad():
        for name, leaf in want:
            if not isinstance(leaf, torch.Tensor):
                continue
            e = stored[name]
            dtype = _DTYPES[e["dtype"]]
            host_dtype = torch.int16 if dtype == torch.bfloat16 else dtype
            f.seek(e["offset"])
            arr = np.fromfile(f, dtype=torch.empty(0, dtype=host_dtype).numpy().dtype,
                              count=leaf.numel())
            leaf.copy_(torch.from_numpy(arr).view(dtype).reshape(leaf.shape))
    return _rebuild(like, scalars), manifest["extra"]


def restore_rebucketed(directory: str | pathlib.Path, step: int, like: Tree, schedule_fn):
    """Elastic restart: restore into ``like`` and recompute the MG-WFBP
    schedule for the *current* world (the checkpoint's layout is
    schedule-free, so only the schedule object changes: paper Algorithm 1
    reruns with the new N's α–β model).  Returns ``(tree, schedule_fn(),
    extra)``."""
    tree, extra = restore(directory, step, like)
    return tree, schedule_fn(), extra


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one write in
    flight.  ``records`` keeps one dict per save (``step``, ``bytes``,
    ``snapshot_s``: the copy to host memory the caller waits for,
    ``write_s``: the background write) and per ``restore`` (``step``,
    ``bytes``, ``seconds``)."""

    def __init__(self, directory: str | pathlib.Path):
        self.directory = pathlib.Path(directory)
        self.records: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(
        self,
        step: int,
        tree: Tree,
        extra: dict | None = None,
        plan: Any | None = None,
        tuner: Any | None = None,
    ) -> None:
        self.wait()
        t0 = time.perf_counter()
        # everything the write needs is copied or serialized now: the caller's
        # next step updates the tensors in place, and a re-plan or a new sweep
        # may follow this call
        host = _snapshot(tree)
        extra = dict(extra or {})
        plan_text = _plan_text(plan)
        tuner_text = _tuner_text(tuner)
        record = {"op": "save", "step": step,
                  "bytes": sum(t.nbytes for _, t in _entries(host) if isinstance(t, torch.Tensor)),
                  "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.records.append(record)

        def work():
            t1 = time.perf_counter()
            try:
                save(self.directory, step, host, extra, plan=plan_text, tuner=tuner_text)
                record["write_s"] = time.perf_counter() - t1
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore(self, step: int, like: Tree) -> tuple[dict, dict]:
        """``restore`` from this directory, once any write in flight is
        done."""
        self.wait()
        t0 = time.perf_counter()
        tree, extra = restore(self.directory, step, like)
        self.records.append({
            "op": "restore", "step": step,
            "bytes": sum(t.nbytes for _, t in _entries(like) if isinstance(t, torch.Tensor)),
            "seconds": time.perf_counter() - t0,
        })
        return tree, extra

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
