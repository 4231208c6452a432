"""Export CLI: the SAM mask decoder or the whole greedy generate step as a
torch.export program (port of tools/export.py, whose artifacts are
StableHLO).

  python -m anyref_tpu_torch.tools.export sam-decoder \
      --ckpt ckpt/anyref7b.pt --out sam_decoder.pt2
  python -m anyref_tpu_torch.tools.export generate \
      --ckpt ckpt/anyref7b.pt --out generate.pt2 [--prompt_len 129] \
      [--max_new_tokens 32] [--encoder_path fused]

``--ckpt`` is a params file of the port (checkpoint.save_params); the
program is exported on ``--device`` and runs there
(export.load_exported).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from ..config import ENCODER_PATHS

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["sam-decoder", "generate"])
    p.add_argument("--ckpt", required=True,
                   help="params file (checkpoint.save_params)")
    p.add_argument("--out", required=True)
    p.add_argument("--preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--num_points", type=int, default=5)
    p.add_argument("--prompt_len", type=int, default=129)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--encoder_path", default="fused", choices=ENCODER_PATHS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import checkpoint, export
    from ..config import anyref_7b, anyref_tiny

    cfg = anyref_7b() if args.preset == "7b" else anyref_tiny()
    params = checkpoint.load_params(args.ckpt, device=args.device)
    if args.what == "sam-decoder":
        export.export_sam_decoder(params["sam"], cfg.sam, args.out,
                                  num_points=args.num_points,
                                  device=args.device)
    else:
        export.export_generate(params, cfg, args.out,
                               prompt_len=args.prompt_len,
                               max_new_tokens=args.max_new_tokens,
                               device=args.device,
                               encoder_path=args.encoder_path)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
