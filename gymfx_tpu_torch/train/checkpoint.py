"""Checkpoint/resume over ``torch.save``: the port of
``gymfx_tpu/train/checkpoint.py`` (:47-283, :336-580) in the port's own
format (orbax imports JAX, so the port neither reads nor writes it).

Layout, as the JAX package's:
  ``<dir>/<step>/state.pt``   the trainer's FULL train state (params, Adam
                              state, env batch, policy inputs and the
                              generator's state, which every phase and
                              graph draws from), so a resumed run continues
                              the exact trajectory an uninterrupted one
                              takes;
  ``<dir>/<step>/params.pt``  the policy params alone, so evaluation loads
                              them without the whole train state;
  ``<dir>/metadata.json``     the policy architecture and ``state_format:
                              "composite"``;
  ``<dir>/digest_<step>.json`` a sha256 over the step directory's sorted
                              file names and bytes.
A save without ``params`` stores the bare tree as ``default.pt``.

Each ``.pt`` file is ``torch.save`` of a flat dict from a leaf's path
(``env_states.pos``, ``opt_state.mu.pi.0.weight``) to a contiguous CPU
copy of the leaf: a row view saved as it is would carry its whole block
(K2's outputs are rows of three blocks, K3's of one), and on the card the
state a train step returns is the update graph's static outputs, which the
next step overwrites, so the copy is taken before the save returns.  A
generator is stored as its state tensor.  Loads use
``torch.load(weights_only=True)``.

A step directory is written under a temporary name and renamed into
place; the JSON sidecars are written atomically (tmp file + ``os.replace``).
A restore verifies the digest first: a torn or bit-rotted step is logged
loudly and skipped for the newest step that still verifies.  Saving a step
that exists warns and skips, as orbax does.  A restore with a template
(``PPOTrainer.init_state``) is checked leaf by leaf, path, shape and
dtype: a mismatch fails at load time.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def _atomic_write_text(target: Path, text: str) -> None:
    """Write-then-rename so a crash mid-write can never leave a torn
    sidecar next to a valid checkpoint (os.replace is atomic on POSIX
    within one filesystem, and the tmp file lives in the target dir)."""
    fd, tmp = tempfile.mkstemp(
        dir=str(target.parent), prefix=f".{target.name}.", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _digest_step_dir(path: Path, step: int) -> Optional[Dict[str, Any]]:
    """sha256 over the step directory's sorted relative file names and
    contents: torn or partial files change the digest directly."""
    step_dir = path / str(int(step))
    if not step_dir.is_dir():
        return None
    h = hashlib.sha256()
    n_files = 0
    for f in sorted(p for p in step_dir.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(step_dir)).encode())
        h.update(b"\0")
        with f.open("rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        h.update(b"\0")
        n_files += 1
    return {"algo": "sha256", "digest": h.hexdigest(), "files": n_files}


def _digest_sidecar(path: Path, step: int) -> Path:
    return path / f"digest_{int(step)}.json"


def verify_checkpoint_step(directory: str, step: int) -> bool:
    """Recompute the step directory's digest against its sidecar.

    True when they match or when no sidecar exists; False, with a loud
    log, on any mismatch, including a recorded digest whose step dir is
    gone."""
    path = Path(directory).resolve()
    sidecar = _digest_sidecar(path, step)
    if not sidecar.exists():
        return True
    try:
        recorded = json.loads(sidecar.read_text())
    except (OSError, ValueError) as exc:
        logger.error(
            "checkpoint step %d under %s has an unreadable digest sidecar "
            "(%s); treating the step as corrupt", step, path, exc,
        )
        return False
    actual = _digest_step_dir(path, step)
    if actual is None or actual["digest"] != recorded.get("digest"):
        logger.error(
            "checkpoint step %d under %s FAILED integrity verification "
            "(stored sha256 %s, recomputed %s) — the step is torn or "
            "bit-rotted and will be skipped",
            step, path, recorded.get("digest"),
            actual["digest"] if actual else "<step dir missing>",
        )
        return False
    return True


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint step failed sha256 digest verification: torn write,
    bit rot, or tampering."""


def _list_steps(path: Path) -> List[int]:
    if not path.is_dir():
        return []
    return sorted(
        int(p.name) for p in path.iterdir()
        if p.is_dir() and p.name.isdigit()
    )


def verify_checkpoint(
    directory: str, step: Optional[int] = None
) -> Tuple[int, Optional[str]]:
    """Digest-verify one checkpoint step without loading any tensors.

    ``step=None`` picks the newest step under ``directory``.  Returns
    ``(step, digest)``: ``digest`` is the recorded sha256 hex, or None for
    a step with no sidecar.  Raises :class:`CheckpointIntegrityError` when
    the recomputed digest disagrees with the sidecar, and
    ``FileNotFoundError`` when the step (or any step) is absent."""
    path = Path(directory).resolve()
    steps = _list_steps(path)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        step = steps[-1]
    step = int(step)
    if step not in steps:
        raise FileNotFoundError(
            f"checkpoint step {step} not found under {path} "
            f"(available: {steps or 'none'})"
        )
    sidecar = _digest_sidecar(path, step)
    if not sidecar.exists():
        return step, None
    if not verify_checkpoint_step(str(path), step):
        raise CheckpointIntegrityError(
            f"checkpoint step {step} under {path} failed sha256 digest "
            f"verification — refusing to use it"
        )
    recorded = json.loads(sidecar.read_text())
    return step, str(recorded.get("digest"))


def _step_bytes(path: Path, step: int) -> int:
    """Disk footprint of one step: its directory's files and its digest."""
    total = 0
    step_dir = path / str(int(step))
    if step_dir.is_dir():
        total += sum(f.stat().st_size for f in step_dir.rglob("*") if f.is_file())
    sidecar = _digest_sidecar(path, step)
    if sidecar.exists():
        total += sidecar.stat().st_size
    return total


def prune_checkpoints(
    directory: str,
    keep: int,
    protect: Tuple[int, ...] = (),
) -> List[Dict[str, Any]]:
    """Newest-N retention: delete every checkpoint step older than the
    newest ``keep``, its digest sidecar included.  ``keep <= 0`` keeps
    everything.  Steps in ``protect`` are never pruned (the resume entry
    step stays restorable while the resumed run writes newer ones).
    Returns one ``{"step", "bytes"}`` row per pruned step."""
    if int(keep) <= 0:
        return []
    path = Path(directory).resolve()
    steps = _list_steps(path)
    keep_set = set(steps[-int(keep):]) | {int(s) for s in protect}
    pruned: List[Dict[str, Any]] = []
    for step in steps:
        if step in keep_set:
            continue
        size = _step_bytes(path, step)
        shutil.rmtree(path / str(step), ignore_errors=True)
        try:
            _digest_sidecar(path, step).unlink()
        except OSError:
            pass
        pruned.append({"step": step, "bytes": size})
        logger.info(
            "pruned checkpoint step %d under %s (%d bytes, keep=%d)",
            step, path, size, keep,
        )
    return pruned


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts, NamedTuples and tuples (a
    NamedTuple's leaves by field name, a tuple's by index), every tensor
    and generator a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _host_copy(leaf: Any) -> torch.Tensor:
    """A contiguous CPU tensor of ``leaf``'s own bytes (a generator's
    state for a generator)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().clone()
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"a checkpoint leaf must be a tensor or a generator, got {type(leaf)}")
    return leaf.detach().to("cpu", copy=True).contiguous()


def save_checkpoint(
    directory: str,
    tree: Any,
    step: int = 0,
    metadata: Optional[Dict[str, Any]] = None,
    params: Optional[Any] = None,
    keep: int = 0,
    protect: Tuple[int, ...] = (),
) -> str:
    """Save a checkpoint at ``step``.

    With ``params`` given, ``tree`` is a full train state and the two are
    stored as separate items (composite format); without, a bare tree.  A
    step that already exists is skipped with a warning, and the metadata
    is left untouched too, so it never describes a tree that was not
    stored.  ``keep > 0`` applies newest-N retention after the new step
    lands (``protect`` steps are exempt)."""
    path = Path(directory).resolve()
    path.mkdir(parents=True, exist_ok=True)
    step_dir = path / str(int(step))
    if step_dir.exists():
        warnings.warn(
            f"checkpoint step {step} already exists under {path}; the save "
            "is skipped — advance the step to persist",
            stacklevel=2,
        )
        return str(path)
    items = {"default": tree} if params is None else {"state": tree, "params": params}
    tmp = Path(tempfile.mkdtemp(dir=str(path), prefix=f".{int(step)}."))
    try:
        for name, item in items.items():
            flat = {k: _host_copy(v) for k, v in flatten_tree(item).items()}
            torch.save(flat, tmp / f"{name}.pt")
        os.replace(tmp, step_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if params is not None:
        metadata = {**(metadata or {}), "state_format": "composite"}
    digest = _digest_step_dir(path, int(step))
    _atomic_write_text(_digest_sidecar(path, int(step)), json.dumps(digest))
    if metadata is not None:
        _atomic_write_text(path / "metadata.json", json.dumps(metadata, indent=2))
    if int(keep) > 0:
        prune_checkpoints(str(path), keep, protect=protect)
    return str(path)


def read_metadata(directory: str) -> Dict[str, Any]:
    meta = Path(directory).resolve() / "metadata.json"
    if meta.exists():
        return json.loads(meta.read_text())
    return {}


def _composite(directory: str) -> bool:
    return read_metadata(directory).get("state_format") == "composite"


def load_checkpoint(directory: str, template: Optional[Any] = None) -> Tuple[Any, int]:
    """The newest verified step's main tree (the full train state of a
    composite checkpoint, the bare tree otherwise): (tree, step).  With
    ``template`` the tree is rebuilt in its structure and checked against
    it leaf by leaf; without, the flat ``{path: tensor}`` dict comes
    back."""
    return _restore_item(directory, "state" if _composite(directory) else "default", template)


def load_params(directory: str, template: Optional[Any] = None) -> Tuple[Any, int]:
    """Policy params from a checkpoint, loading only the params item of a
    composite one; a bare tree is read as params."""
    return _restore_item(directory, "params" if _composite(directory) else "default", template)


def load_train_state(directory: str, trainer: Any):
    """Resume helper shared by the trainers: ``(initial_state,
    initial_params, step)``, a full train state when the checkpoint
    carries one, else params for a warm start.  The template is
    ``trainer.init_state(0)`` (a PPO ``TrainState`` or an IMPALA
    ``ImpalaState``): the trainer's configuration decides every leaf's
    shape and dtype; a params-only checkpoint is read as the state's
    ``params`` (PPO) or ``learner_params`` (IMPALA)."""
    template = trainer.init_state(0)
    if _composite(directory):
        state, step = load_checkpoint(directory, template=template)
        return state, None, step
    field = "params" if "params" in type(template)._fields else "learner_params"
    params, step = load_params(directory, template=getattr(template, field))
    return None, params, step


def resume_from_config(config: Dict[str, Any], trainer: Any):
    """The ``resume_training`` entry: ``(initial_state, initial_params,
    resume_step)``, all falsy when the config asks for no resume or the
    directory holds no checkpoint."""
    ckpt_dir = config.get("checkpoint_dir")
    if not (ckpt_dir and config.get("resume_training")):
        return None, None, 0
    try:
        return load_train_state(str(ckpt_dir), trainer)
    except FileNotFoundError:
        return None, None, 0  # cold start, empty dir


def _rebuild(template: Any, flat: Dict[str, torch.Tensor], directory: str) -> Any:
    """``flat`` in ``template``'s structure, each leaf checked against the
    template's (path, shape, dtype) and placed on its device."""
    want = flatten_tree(template)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(
            f"checkpoint in {directory} does not match the configured policy "
            f"architecture: missing {missing[:8]}, unexpected {extra[:8]}"
        )
    out: Dict[str, Any] = {}
    for path, t in want.items():
        r = flat[path]
        if isinstance(t, torch.Generator):
            gen = torch.Generator(device=t.device)
            gen.set_state(r)
            out[path] = gen
            continue
        if tuple(r.shape) != tuple(t.shape) or r.dtype != t.dtype:
            raise ValueError(
                f"checkpoint in {directory} does not match the configured policy "
                f"architecture: {path} stored {tuple(r.shape)} {r.dtype}, "
                f"expected {tuple(t.shape)} {t.dtype}"
            )
        out[path] = r.to(t.device)
    return _unflatten_like(template, out)


def _unflatten_like(template: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    def path(key) -> str:
        return f"{prefix}.{key}" if prefix else str(key)

    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, path(k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten_like(v, flat, path(k))
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_like(v, flat, path(i)) for i, v in enumerate(template))
    return flat[prefix]


def _restore_item(
    directory: str, item: str, template: Optional[Any]
) -> Tuple[Any, int]:
    path = Path(directory).resolve()
    steps = _list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    # newest step whose content digest still verifies; a torn latest
    # step falls back to the previous valid one
    step = next((s for s in reversed(steps) if verify_checkpoint_step(str(path), s)), None)
    if step is None:
        raise RuntimeError(
            f"every checkpoint step under {path} failed integrity "
            f"verification (steps checked: {steps}); refusing to "
            "restore corrupt state"
        )
    if step != steps[-1]:
        logger.error(
            "restoring checkpoint step %d under %s — newer step(s) "
            "%s failed integrity verification",
            step, path, [s for s in steps if s > step],
        )
    flat = torch.load(path / str(step) / f"{item}.pt", map_location="cpu", weights_only=True)
    if template is not None:
        return _rebuild(template, flat, str(path)), int(step)
    return flat, int(step)
