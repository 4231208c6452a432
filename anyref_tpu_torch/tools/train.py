"""Training CLI (port of tools/train.py; replaces the reference's train.py +
train.sh accelerate launch), one device.

  python -m anyref_tpu_torch.tools.train --train_datasets avs_object \
      --data_root /data --output_dir output/avs --per_device_batch_size 6 \
      --grad_accum_steps 8 --learning_rate 5e-5 --max_steps 10000 \
      --rephrase_weight 0.1 --roi --no_mask --add_audio_encoder

The pretrained parts come from ``checkpoint.assemble_pretrained`` on
``--device`` (default cuda); the Trainer builds the ``--train_datasets``
mix under ``--data_root`` (data/registry.py). After training, the
deployment params (LoRA folded in, reference merge_lora.py) are written to
``<output_dir>/merged.pt`` with ``checkpoint.save_params``, the file the
eval CLI's ``--ckpt`` reads. Without ``--tokenizer`` the byte-level
tokenizer runs, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os

from ..config import ENCODER_PATHS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train_datasets", default="refer_seg")
    p.add_argument("--data_root", default="/data")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--per_device_batch_size", type=int, default=6)
    p.add_argument("--grad_accum_steps", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=200)
    p.add_argument("--max_steps", type=int, default=10_000)
    p.add_argument("--save_steps", type=int, default=100)
    p.add_argument("--rephrase_weight", type=float, default=0.0)
    p.add_argument("--roi", action="store_true")
    p.add_argument("--no_mask", action="store_true")
    p.add_argument("--itisseg", action="store_true")
    p.add_argument("--add_audio_encoder", action="store_true")
    p.add_argument("--preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--llava_dir", default="LLaVA-Lightning-7B-v1-1")
    p.add_argument("--sam_ckpt", default="SAM/sam_vit_h_4b8939.pth")
    p.add_argument("--imagebind_ckpt", default="ImageBind/imagebind_huge.pth")
    p.add_argument("--profile_steps", default="")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (AnyRefTokenizer."
                        "from_pretrained); default: the byte-level one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--encoder_path", default="fused", choices=ENCODER_PATHS)
    args = p.parse_args(argv)

    from .. import checkpoint
    from ..config import anyref_7b, anyref_tiny
    from ..tokenizer import AnyRefTokenizer
    from ..train.trainer import TrainConfig, Trainer

    cfg = anyref_7b() if args.preset == "7b" else anyref_tiny()
    cfg = cfg.scaled(rephrase_weight=args.rephrase_weight,
                     audio=cfg.audio if args.add_audio_encoder or "avs" in
                     args.train_datasets else None)

    params = checkpoint.assemble_pretrained(
        cfg, llava_dir=args.llava_dir, sam_ckpt=args.sam_ckpt,
        imagebind_ckpt=args.imagebind_ckpt, device=args.device)

    tc = TrainConfig(
        train_datasets=args.train_datasets, data_root=args.data_root,
        output_dir=args.output_dir,
        per_device_batch_size=args.per_device_batch_size,
        grad_accum_steps=args.grad_accum_steps,
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        max_steps=args.max_steps, save_steps=args.save_steps,
        itisseg=args.itisseg, roi=args.roi, no_mask=args.no_mask,
        profile_steps=tuple(int(x) for x in args.profile_steps.split(",")
                            if x),
        encoder_path=args.encoder_path)
    tok = (AnyRefTokenizer.from_pretrained(args.tokenizer)
           if args.tokenizer else AnyRefTokenizer())
    trainer = Trainer(cfg, tc, params, tokenizer=tok, device=args.device)
    trainer.train()
    # deployment merge (reference merge_lora.py)
    out = os.path.join(args.output_dir, "merged.pt")
    checkpoint.save_params(out, trainer.merged_params())
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
