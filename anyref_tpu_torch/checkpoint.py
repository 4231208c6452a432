"""Train-state checkpoints (port of the train-state part of
anyref_tpu/checkpoint.py).

The format is the port's own: ``<dir>/checkpoint-<step>/train_state.pt``,
one ``torch.save`` of plain containers (dicts, lists, ints, None and CPU
tensors), loadable with ``weights_only=True``. Interchange with the JAX
package's orbax checkpoints is not part of the port yet.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

STATE_FILE = "train_state.pt"


def _plain(tree):
    """Named tuples to dicts by field, tensors to detached CPU copies."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("checkpoint-"))


def save_train_state(ckpt_dir: str, step: int, state, keep: int = 3) -> None:
    """Write ``checkpoint-{step}`` and keep the newest ``keep``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(_plain({"step": step, "lora": state.lora,
                       "dense": state.dense, "opt_state": state.opt_state}),
               tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    for old in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"checkpoint-{old}"),
                      ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"checkpoint-{steps[-1]}")


def _rebuild_by_name(template, restored, where="state"):
    """``restored`` in the container types of ``template``, children matched
    by name (dict keys, named-tuple fields) or index, never by flatten
    order; each tensor checked for shape and moved to the template leaf's
    device and dtype."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        missing = [f for f in template._fields if f not in restored]
        if missing:
            raise ValueError(f"checkpoint missing fields {missing} at {where}")
        return type(template)(*(
            _rebuild_by_name(getattr(template, f), restored[f],
                             f"{where}.{f}") for f in template._fields))
    if isinstance(template, dict):
        missing = [k for k in template if k not in restored]
        if missing:
            raise ValueError(f"checkpoint missing keys {missing} at {where}")
        return {k: _rebuild_by_name(v, restored[k], f"{where}.{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(restored) != len(template):
            raise ValueError(f"checkpoint sequence length {len(restored)} != "
                             f"template length {len(template)} at {where}")
        return type(template)(
            _rebuild_by_name(t, r, f"{where}[{i}]")
            for i, (t, r) in enumerate(zip(template, restored)))
    if isinstance(template, torch.Tensor):
        if tuple(restored.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(restored.shape)} != "
                             f"{tuple(template.shape)} at {where}")
        return restored.to(device=template.device, dtype=template.dtype)
    return restored


def restore_train_state(path: str, template=None):
    """The saved tree; with ``template`` (e.g. {"step", "lora", "dense",
    "opt_state"} of a fresh state) rebuilt into its containers, devices and
    dtypes."""
    restored = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
    if template is None:
        return restored
    return _rebuild_by_name(template, restored)
