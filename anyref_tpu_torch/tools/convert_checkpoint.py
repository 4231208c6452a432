"""Checkpoint conversion CLI: the reference's torch artifacts -> one params
file of the port (checkpoint.save_params; checkpoint.load_params reads it).

  python -m anyref_tpu_torch.tools.convert_checkpoint --out ckpt/anyref7b.pt \
      --llava_dir LLaVA-Lightning-7B-v1-1 \
      --sam_ckpt SAM/sam_vit_h_4b8939.pth \
      --imagebind_ckpt ImageBind/imagebind_huge.pth \
      --lora_dir output2/refer/checkpoint-4500     # optional PEFT adapter

A LoRA adapter is merged offline into the LLaVA state dict (reference
merge_lora.py:58-62), on the CPU, and its ``modules_to_save`` copies
replace their base weights; everything in the LLaVA directory is then
converted from the merged state dict. The decoder's depth is the state
dict's (its ``model.layers.N.`` keys), the widths the preset's. Where two
artifacts hold one part, the later in this order wins, as in
``checkpoint.assemble_pretrained``: ``--sam_ckpt`` and
``--imagebind_ckpt``, then the LLaVA directory (a merged one carries SAM
under ``model.visual_model.``, the audio branch under
``model.audio_encoder.`` and the CLIP tower under ``vision_tower.``), then
``--clip_dir``. Parts that no artifact holds are drawn from seed 0.
Conversion runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re

import torch

from .. import checkpoint
from ..config import anyref_7b, anyref_tiny
from ..convert import merge_lora_into


def merge_peft_adapter(sd_base: dict, lora_dir: str) -> dict:
    """Fold a PEFT LoRA adapter directory (adapter_config.json and
    adapter_model.safetensors / .bin) into an HF state dict, in fp32 on the
    CPU, and copy any modules_to_save overrides."""
    with open(os.path.join(lora_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    alpha, r = acfg.get("lora_alpha", 16), acfg.get("r", 8)
    for name in ("adapter_model.safetensors", "adapter_model.bin"):
        path = os.path.join(lora_dir, name)
        if os.path.exists(path):
            asd = checkpoint._load_torch_state_dict(path)
            break
    else:
        raise FileNotFoundError(f"no adapter weights in {lora_dir}")

    out = dict(sd_base)
    for k, v in asd.items():
        if "lora_A" in k:
            base_key = (k.replace("base_model.model.", "")
                         .replace(".lora_A.weight", ".weight")
                         .replace(".lora_A.default.weight", ".weight"))
            b_key = k.replace("lora_A", "lora_B")
            if base_key in out and b_key in asd:
                out[base_key] = merge_lora_into(out[base_key].cpu(), v.cpu(),
                                                asd[b_key].cpu(), alpha, r)
        elif "modules_to_save" in k:
            base_key = (k.replace("base_model.model.", "")
                         .replace(".modules_to_save.default", ""))
            out[base_key] = v
    return out


def llama_depth(sd: dict):
    """The number of decoder layers of an HF LLaMA state dict (one more than
    its largest ``model.layers.N.``), or None where it holds none."""
    found = [int(m.group(1)) for k in sd
             if (m := re.match(r"model\.layers\.(\d+)\.", k))]
    return max(found) + 1 if found else None


def build_params(cfg, *, llava_dir=None, sam_ckpt=None, imagebind_ckpt=None,
                 clip_dir=None, lora_dir=None, dtype=torch.bfloat16,
                 device="cuda") -> dict:
    """The tree the CLI writes: checkpoint.assemble_pretrained, with the
    LoRA adapter of ``lora_dir`` merged into the LLaVA state dict first and
    the decoder as deep as that state dict."""
    llava_sd = None
    if llava_dir and os.path.isdir(llava_dir):
        llava_sd = checkpoint._load_hf_dir(llava_dir)
        if lora_dir:
            llava_sd = merge_peft_adapter(llava_sd, lora_dir)
        depth = llama_depth(llava_sd)
        if depth is not None:
            cfg = cfg.scaled(llama=dataclasses.replace(cfg.llama,
                                                       num_layers=depth))
    return checkpoint.assemble_from(
        cfg, llava_sd, sam_ckpt=sam_ckpt, imagebind_ckpt=imagebind_ckpt,
        clip_dir=clip_dir, dtype=dtype, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="params file to write")
    p.add_argument("--llava_dir", default=None,
                   help="HF LLaVA directory; a merged one's SAM, audio "
                        "branch and CLIP tower replace --sam_ckpt's and "
                        "--imagebind_ckpt's")
    p.add_argument("--sam_ckpt", default=None)
    p.add_argument("--imagebind_ckpt", default=None)
    p.add_argument("--clip_dir", default=None,
                   help="HF CLIP vision directory; replaces the LLaVA "
                        "directory's tower")
    p.add_argument("--lora_dir", default=None)
    p.add_argument("--preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = anyref_7b() if args.preset == "7b" else anyref_tiny()
    params = build_params(
        cfg, llava_dir=args.llava_dir, sam_ckpt=args.sam_ckpt,
        imagebind_ckpt=args.imagebind_ckpt, clip_dir=args.clip_dir,
        lora_dir=args.lora_dir, dtype=getattr(torch, args.dtype),
        device=args.device)
    checkpoint.save_params(args.out, params)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
