"""Checkpoints (port of anyref_tpu/checkpoint.py).

The format is the port's own, one ``torch.save`` of plain containers (dicts,
lists, ints, None and CPU tensors), loadable with ``weights_only=True``:
``save_params`` / ``load_params`` for a param tree, and
``<dir>/checkpoint-<step>/train_state.pt`` for the train state, one
logical file whatever the mesh that wrote it (train/trainer.py gathers the
blocks first and rank 0 writes). A JAX (orbax) checkpoint crosses as numpy
through ``params.from_numpy``.

``assemble_pretrained`` builds a full tree from the reference's torch
artifacts (LLaVA HF dir, SAM .pth, ImageBind .pth, CLIP dir): .pth / .bin
through ``torch.load(weights_only=True)``, .safetensors through the port's
own reader (``_read_safetensors``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from typing import Optional

import torch

from . import convert
from . import params as params_mod
from .config import AnyRefConfig

STATE_FILE = "train_state.pt"
# safetensors dtype names the reader takes
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I8": torch.int8, "I32": torch.int32,
              "I64": torch.int64}


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


def _save(obj, path: str) -> None:
    """torch.save through a temporary file, so a reader never sees half a
    file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("checkpoint-"))


def save_train_state(ckpt_dir: str, step: int, state, keep: int = 3) -> None:
    """Write ``checkpoint-{step}`` and keep the newest ``keep``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    opt = state.opt_state
    if isinstance(getattr(opt, "count", None), torch.Tensor):
        opt = opt._replace(count=int(opt.count))   # saved as an int
    _save(_plain({"step": step, "lora": state.lora, "dense": state.dense,
                  "opt_state": opt}),
          os.path.join(path, STATE_FILE))
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
    device and dtype, a number made a 0-d tensor where the template has
    one."""
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
        if isinstance(restored, (int, float)) and template.dim() == 0:
            # a count saved as a number (train/step.py OptState)
            return torch.full((), restored, dtype=template.dtype,
                              device=template.device)
        if tuple(restored.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(restored.shape)} != "
                             f"{tuple(template.shape)} at {where}")
        return restored.to(device=template.device, dtype=template.dtype)
    return restored


def restore_train_state(path: str, template=None, cut=None):
    """The saved tree; with ``template`` (e.g. {"step", "lora", "dense",
    "opt_state"} of a fresh state) rebuilt into its containers, devices and
    dtypes. ``cut`` maps the saved tree first (a rank on a mesh takes its
    blocks of the whole leaves: parallel/partition.py ``shard_tree``)."""
    restored = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=True)
    if cut is not None:
        restored = cut(restored)
    if template is None:
        return restored
    return _rebuild_by_name(template, restored)


def save_params(path: str, params) -> None:
    """One file: ``torch.save`` of the tree with its tensors copied to the
    CPU."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save(_plain(params), path)


def load_params(path: str, device="cuda"):
    """A tree written by ``save_params``, on ``device``."""
    dev = params_mod.resolve_device(device)
    return torch.load(path, map_location=dev, weights_only=True)


# ---------------------------------------------------------------------------
# torch artifact loading (conversion entry point)
# ---------------------------------------------------------------------------
def _read_safetensors(path: str) -> dict:
    """{name: CPU tensor} of a .safetensors file: an 8-byte little-endian
    header length, a JSON header {name: {dtype, shape, data_offsets}}, then
    the raw little-endian buffers. Only the dtypes of _ST_DTYPES are read;
    any other is refused by name."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(buf)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has safetensors dtype "
                             f"{info['dtype']}, which is not read (only "
                             f"{', '.join(_ST_DTYPES)})")
        begin, end = info["data_offsets"]
        size = dtype.itemsize
        t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // size,
                             offset=begin) if end > begin else \
            torch.empty(0, dtype=dtype)
        if begin % size:  # a buffer the writer left unaligned: own copy
            t = t.clone()
        out[name] = t.reshape(info["shape"])
    return out


def _load_torch_state_dict(path: str) -> dict:
    """A .pth / .bin / .safetensors file as {name: CPU tensor}, dtypes as
    stored (bf16 stays bf16)."""
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def _load_hf_dir(path: str) -> dict:
    """Merge all weight files of an HF model directory. HF-Trainer outputs
    ship non-weight pickles beside the shards (training_args.bin, which
    torch.load(weights_only=True) refuses), but a name whitelist would drop
    standalone weight files like LLaVA's mm_projector.bin: so skip the
    known non-weight names, and warn-skip any other .bin that fails to load
    as a weights-only state dict."""
    skip = {"training_args.bin", "optimizer.bin", "scheduler.bin"}
    out = {}
    for name in sorted(os.listdir(path)):
        if name in skip or "index" in name:
            continue
        if not name.endswith((".safetensors", ".bin")):
            continue
        try:
            out.update(_load_torch_state_dict(os.path.join(path, name)))
        except Exception as e:
            sys.stderr.write(f"WARNING: skipping non-weight file "
                             f"{name}: {str(e)[:200]}\n")
    return out


def assemble_pretrained(cfg: AnyRefConfig, *,
                        llava_dir: Optional[str] = None,
                        sam_ckpt: Optional[str] = None,
                        imagebind_ckpt: Optional[str] = None,
                        clip_dir: Optional[str] = None,
                        dtype=torch.bfloat16, seed: int = 0,
                        device="cuda") -> dict:
    """A full param tree on ``device``: converted weights where an artifact
    holds them, fresh ``params.init`` elsewhere (the reference loads SAM
    non-strict and ImageBind under try / FileNotFound, anyref.py:149-154,
    build_sam.py:104-108). A merged reference checkpoint (merge_lora.py's
    output) in ``llava_dir`` also carries SAM (``model.visual_model.``),
    the ImageBind audio branch (``model.audio_encoder.``), the CLIP tower
    (``vision_tower.``) and the AnyRef heads. Where two artifacts hold one
    part, the later wins, in the JAX package's order: ``sam_ckpt`` and
    ``imagebind_ckpt``, then ``llava_dir``, then ``clip_dir``."""
    llava_sd = None
    if llava_dir and os.path.isdir(llava_dir):
        llava_sd = _load_hf_dir(llava_dir)
    return assemble_from(cfg, llava_sd, sam_ckpt=sam_ckpt,
                         imagebind_ckpt=imagebind_ckpt, clip_dir=clip_dir,
                         dtype=dtype, seed=seed, device=device)


def assemble_from(cfg: AnyRefConfig, llava_sd: Optional[dict], *,
                  sam_ckpt: Optional[str] = None,
                  imagebind_ckpt: Optional[str] = None,
                  clip_dir: Optional[str] = None, dtype=torch.bfloat16,
                  seed: int = 0, device="cuda") -> dict:
    """``assemble_pretrained`` from the LLaVA state dict already in memory
    (the conversion CLI merges a LoRA adapter into it first). The parts no
    artifact holds are drawn on the CPU from ``torch.Generator()`` seeded
    with ``seed`` and moved to ``device``, so every device gets the same
    bits."""
    dev = params_mod.resolve_device(device)
    kw = {"dtype": dtype, "device": dev}
    out = {}
    if sam_ckpt and os.path.exists(sam_ckpt):
        out["sam"] = convert.convert_sam(_load_torch_state_dict(sam_ckpt),
                                         cfg.sam, **kw)
    if imagebind_ckpt and os.path.exists(imagebind_ckpt) and cfg.audio:
        out["audio_encoder"] = convert.convert_imagebind_audio(
            _load_torch_state_dict(imagebind_ckpt), cfg.audio, **kw)
    if llava_sd is not None:
        sd = llava_sd
        out["llama"] = convert.convert_llama(sd, cfg.llama, **kw)
        try:
            out["mm_projector"] = convert.convert_mm_projector(sd, **kw)
        except KeyError:
            pass
        # the CLIP tower may sit anywhere under a "vision_tower." prefix
        tower = {k.split("vision_tower.", 1)[1]: v for k, v in sd.items()
                 if "vision_tower." in k}
        if tower:
            out["clip"] = convert.convert_clip_vision(tower, cfg.clip, **kw)
        sam_sd = _strip(sd, "model.visual_model.")
        if sam_sd:
            out["sam"] = convert.convert_sam(sam_sd, cfg.sam, **kw)
        ib_sd = _strip(sd, "model.audio_encoder.")
        if ib_sd and cfg.audio:
            out["audio_encoder"] = convert.convert_imagebind_audio(
                ib_sd, cfg.audio, **kw)
        out.update(convert.convert_anyref_heads(sd, **kw))
    if clip_dir and os.path.isdir(clip_dir):
        out["clip"] = convert.convert_clip_vision(_load_hf_dir(clip_dir),
                                                  cfg.clip, **kw)
    names = params_mod.part_names(cfg)
    fresh = params_mod.init(cfg, torch.Generator().manual_seed(seed), dtype,
                            device="cpu", parts=set(names) - set(out))
    fresh = _to_device(fresh, dev)
    return {**{k: out[k] if k in out else fresh[k] for k in names}, **out}


def _strip(sd: dict, prefix: str) -> dict:
    """The entries under ``prefix``, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
