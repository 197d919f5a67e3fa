"""Fault-tolerant checkpointing: atomic, async, keep-k, CRC-checked.

The JAX package's ``repro.checkpoint.checkpointer`` with the same on-disk
layout, so either package can read the other's f32 checkpoints::

    <dir>/step_000123/
        manifest.json      # step, leaf paths, shapes/dtypes, crc32
        arrays.npz         # one entry per flattened tree leaf
        meta.json          # optional JSON sidecar (CRC'd via the manifest)
    <dir>/LATEST           # atomically-updated pointer

Leaves are keyed by their path in the JAX package's ``keystr`` form
(``['params']['conv0']['w']``).  numpy has no bfloat16: a bf16 tensor is
stored by its bit pattern, as int16, and the manifest names its dtype
``bfloat16``, which restore reads to view the bits back.  (The JAX
package stores bf16 through ``ml_dtypes`` instead, so only f32 and
integer leaves cross between the packages.)

Writes go to ``step_X.tmp`` then ``os.rename`` (atomic on POSIX), so a
crash mid-write never corrupts the restore point.  ``save_async`` copies
every leaf to the host first, then serializes in a background thread (at
most one outstanding save); an error in that thread is raised by the next
``wait()``.  Restore verifies every leaf's CRC32 (and the meta sidecar's)
and raises :class:`CheckpointCorrupt` on any mismatch, truncation or
missing entry; with ``fallback=True`` a corrupt step is skipped (with a
logged warning) and the previous keep-k checkpoint is tried instead.

:class:`DPTrainState` is the unit of DP-training persistence: params and
optimizer state, the cross-step clipping state, the accountant ledger,
the plan fingerprint, the monitor state, the noise stream's seed and the
device its generator runs on (a CUDA and a CPU ``torch.Generator`` draw
different numbers from one seed, so a resume must stay on the device the
run drew its noise on).

On a mesh a checkpoint holds whole arrays: the engine gathers the
params and the optimizer state over the model group and, under FSDP,
the data group (``PrivacyEngine.gather_params`` / ``gather_opt``)
before it is written, and a resuming run cuts them for its own mesh and
``fsdp`` setting (``shard_params`` / ``shard_opt``).  So a run resumes
across FSDP on and off and across data and model degrees; ``mesh_axes``
and ``fsdp`` record the writer's layout.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

log = logging.getLogger("repro_torch.checkpoint")

_BF16 = "bfloat16"


class CheckpointCorrupt(IOError):
    """A checkpoint failed CRC verification or cannot be read at all
    (truncated arrays file, missing leaves, unparseable manifest/meta)."""


@dataclasses.dataclass
class DPTrainState:
    """Everything a DP training step stream needs to resume bit-exactly.

    ``clip_state`` holds the engine's ``clip_state_dict()`` (any of
    ``prev_norms_sq`` / ``budgets`` / ``budget_q``); ``ledger`` is the
    accountant's ``state_dict()``; ``plan_fingerprint`` pins the plan the
    checkpoint was produced under; ``run_seed`` pins the deterministic
    noise stream and ``noise_device`` the device type (``"cuda"`` /
    ``"cpu"``) of its generator; ``mesh_axes`` and ``fsdp`` record the
    writing run's layout (the arrays are whole either way)."""

    params: Any
    opt: Any
    clip_state: dict = dataclasses.field(default_factory=dict)
    ledger: dict | None = None
    plan_fingerprint: str = ""
    monitor: dict | None = None
    run_seed: int | None = None
    mesh_axes: tuple = ()
    noise_device: str | None = None
    fsdp: bool = False


class _AnyLeaf:
    """Restore-verbatim placeholder for leaves whose shape/dtype only the
    checkpoint knows (the clip-state arrays): restored as numpy."""


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _leaves(tree, path=()):
    """(path, leaf) pairs in the order of the dicts' keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (bf16 as its int16 bits) and the dtype
    name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _flatten(tree) -> tuple[dict, dict]:
    flat, dtypes = {}, {}
    for path, leaf in _leaves(tree):
        k = _keystr(path)
        flat[k], dtypes[k] = _host(leaf)
    return flat, dtypes


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _meta_bytes(meta: dict) -> bytes:
    return json.dumps(meta, sort_keys=True).encode()


def _restore_leaf(arr: np.ndarray, dtype_name: str, like):
    """Stored array -> a leaf shaped like ``like``: a tensor in its dtype
    on its device, or numpy for numpy / placeholder leaves."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if dtype_name == _BF16:
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype)
    if dtype_name == _BF16:
        raise ValueError("a bfloat16 leaf restores only into a tensor leaf")
    if isinstance(like, _AnyLeaf) or not hasattr(like, "dtype"):
        return np.array(arr)
    return np.asarray(arr).astype(like.dtype)


def _unflatten_like(like, values: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, path + (k,))
                for k, v in like.items()}
    return values[_keystr(path)]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree, *, meta: dict | None = None) -> str:
        flat, dtypes = _flatten(tree)
        return self._write(step, flat, dtypes, meta)

    def _write(self, step: int, flat: dict, dtypes: dict,
               meta: dict | None) -> str:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                           "crc32": _crc(v)}
                       for k, v in flat.items()},
        }
        if meta is not None:
            mb = _meta_bytes(meta)
            with open(os.path.join(tmp, "meta.json"), "wb") as f:
                f.write(mb)
            manifest["meta_crc32"] = zlib.crc32(mb) & 0xFFFFFFFF
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def save_async(self, step: int, tree, *, meta: dict | None = None):
        self.wait()
        flat, dtypes = _flatten(tree)   # host snapshot before the thread

        def run():
            try:
                self._write(step, flat, dtypes, meta)
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_state(self, step: int, state: DPTrainState) -> str:
        tree, meta = self._state_payload(state)
        return self.save(step, tree, meta=meta)

    def save_state_async(self, step: int, state: DPTrainState):
        tree, meta = self._state_payload(state)
        self.save_async(step, tree, meta=meta)

    def _state_payload(self, state: DPTrainState):
        clip = {k: np.asarray(v) for k, v in (state.clip_state or {}).items()
                if v is not None}
        tree = {"params": state.params, "opt": state.opt, "clip": clip}
        meta = {"ledger": state.ledger,
                "plan_fingerprint": state.plan_fingerprint,
                "monitor": state.monitor,
                "run_seed": state.run_seed,
                "mesh_axes": [[n, int(s)] for n, s in state.mesh_axes],
                "noise_device": state.noise_device,
                "fsdp": bool(state.fsdp),
                "clip_keys": sorted(clip)}
        return tree, meta

    def wait(self):
        """Join the outstanding async save; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def available_steps(self) -> list[int]:
        """All completed checkpoint steps, newest first (from the directory
        listing, not the LATEST pointer, so a crash between the two renames
        still sees the newest completed step)."""
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps, reverse=True)

    def _candidates(self, step: int | None, fallback: bool) -> list[int]:
        if step is not None:
            return [step]
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return steps if fallback else steps[:1]

    def _load_manifest(self, d: str) -> dict:
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"unreadable manifest in {d}: {e}") \
                from e

    def read_meta(self, step: int | None = None) -> dict | None:
        """The CRC-verified meta sidecar of a checkpoint (None if it was
        written without one)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        return self._read_meta_dir(d, self._load_manifest(d))

    def _read_meta_dir(self, d: str, manifest: dict) -> dict | None:
        if "meta_crc32" not in manifest:
            return None
        try:
            with open(os.path.join(d, "meta.json"), "rb") as f:
                mb = f.read()
        except OSError as e:
            raise CheckpointCorrupt(f"missing meta.json in {d}: {e}") from e
        if (zlib.crc32(mb) & 0xFFFFFFFF) != manifest["meta_crc32"]:
            raise CheckpointCorrupt(f"meta.json CRC mismatch in {d}")
        try:
            return json.loads(mb)
        except ValueError as e:
            raise CheckpointCorrupt(f"unparseable meta.json in {d}: {e}") \
                from e

    def _restore_dir(self, step: int, like_tree, *, verify: bool = True):
        """Restore one checkpoint directory or raise CheckpointCorrupt."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.dir}")
        manifest = self._load_manifest(d)
        try:
            with np.load(os.path.join(d, "arrays.npz")) as data:
                if verify:
                    for k, m in manifest["leaves"].items():
                        if _crc(data[k]) != m["crc32"]:
                            raise CheckpointCorrupt(
                                f"checkpoint corruption in {k} (step "
                                f"{step}): CRC mismatch")
                values = {}
                for path, leaf in _leaves(like_tree):
                    k = _keystr(path)
                    values[k] = _restore_leaf(
                        data[k], manifest["leaves"][k]["dtype"], leaf)
        except CheckpointCorrupt:
            raise
        except (OSError, KeyError, ValueError, EOFError, zlib.error,
                zipfile.BadZipFile) as e:
            # truncated zip, missing member, undecodable payload: the
            # shapes a torn write takes
            raise CheckpointCorrupt(
                f"unreadable checkpoint step {step}: "
                f"{type(e).__name__}: {e}") from e
        return _unflatten_like(like_tree, values)

    def restore(self, like_tree, step: int | None = None, *,
                verify: bool = True, fallback: bool = False):
        """Restore into the structure of ``like_tree`` (tensor leaves come
        back in the like leaf's dtype and on its device).  CRC failure
        raises :class:`CheckpointCorrupt`; ``fallback=True`` skips corrupt
        steps (with a logged warning) and tries the previous keep-k
        checkpoint instead.  Returns ``(tree, step)``."""
        last_err = None
        for s in self._candidates(step, fallback):
            try:
                return self._restore_dir(s, like_tree, verify=verify), s
            except CheckpointCorrupt as e:
                last_err = e
                if not fallback:
                    raise
                log.warning("checkpoint step %d corrupt (%s); falling back "
                            "to the previous checkpoint", s, e)
        raise last_err

    def restore_state(self, like_params, like_opt,
                      step: int | None = None, *, fallback: bool = True):
        """Restore a :class:`DPTrainState` (params/opt shaped like the
        given trees; clip-state arrays restored verbatim).  Corrupt steps
        fall back to older checkpoints by default: a restart should prefer
        losing a few steps of progress to dying on a torn write.  Returns
        ``(state, step)``."""
        last_err = None
        for s in self._candidates(step, fallback):
            d = os.path.join(self.dir, f"step_{s:09d}")
            try:
                meta = self._read_meta_dir(d, self._load_manifest(d)) or {}
                like = {"params": like_params, "opt": like_opt,
                        "clip": {k: _AnyLeaf()
                                 for k in meta.get("clip_keys", ())}}
                tree = self._restore_dir(s, like)
            except CheckpointCorrupt as e:
                last_err = e
                if not fallback:
                    raise
                log.warning("checkpoint step %d corrupt (%s); falling back "
                            "to the previous checkpoint", s, e)
                continue
            state = DPTrainState(
                params=tree["params"], opt=tree["opt"],
                clip_state=tree["clip"], ledger=meta.get("ledger"),
                plan_fingerprint=meta.get("plan_fingerprint", ""),
                monitor=meta.get("monitor"),
                run_seed=meta.get("run_seed"),
                mesh_axes=tuple((n, int(sz))
                                for n, sz in meta.get("mesh_axes", ())),
                noise_device=meta.get("noise_device"),
                fsdp=bool(meta.get("fsdp", False)))
            return state, s
        raise last_err
