"""Single-image demo: text / image-crop / RoI / audio referring segmentation
(port of tools/demo.py).

  python -m anyref_tpu_torch.tools.demo --ckpt ckpt/anyref7b.pt \
      --image cat.jpg --text "the cat on the left" --out mask.png
  python -m anyref_tpu_torch.tools.demo --ckpt ckpt/anyref7b.pt \
      --image scene.jpg --ref_image crop.jpg --out mask.png
  python -m anyref_tpu_torch.tools.demo --ckpt ckpt/anyref7b.pt \
      --image scene.jpg --audio meow.wav --out mask.png

``--ckpt`` is a params file of the port (checkpoint.save_params, or the
conversion CLI's output). Without ``--tokenizer`` the byte-level tokenizer
runs, as in the JAX CLI; the published checkpoint needs its own
(``--tokenizer DIR``, AnyRefTokenizer.from_pretrained).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import ENCODER_PATHS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="params file (checkpoint.save_params)")
    p.add_argument("--image", required=True)
    p.add_argument("--text", default=None)
    p.add_argument("--ref_image", default=None)
    p.add_argument("--roi", default=None, help="x1,y1,x2,y2 (pixels)")
    p.add_argument("--audio", default=None, help=".wav path")
    p.add_argument("--out", default="mask.png")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="decode budget (default: config's 128)")
    p.add_argument("--preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (AnyRefTokenizer."
                        "from_pretrained); default: the byte-level one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--encoder_path", default="fused", choices=ENCODER_PATHS)
    args = p.parse_args(argv)
    if not (args.text or args.ref_image or args.roi or args.audio):
        raise SystemExit("give one of --text/--ref_image/--roi/--audio")

    from PIL import Image

    from .. import checkpoint
    from ..config import anyref_7b, anyref_tiny
    from ..data.avs import load_wav
    from ..data.base import SegDataset, load_image_rgb
    from ..data.collator import Collator
    from ..eval.runner import Predictor, binary_mask
    from ..ops.mel import audio_to_mel_clips
    from ..tokenizer import (AnyRefTokenizer, audio_ref_question,
                             img_ref_question, seg_question)

    cfg = anyref_7b() if args.preset == "7b" else anyref_tiny()
    params = checkpoint.load_params(args.ckpt, device=args.device)
    tok = (AnyRefTokenizer.from_pretrained(args.tokenizer)
           if args.tokenizer else AnyRefTokenizer())

    image = load_image_rgb(args.image)
    kwargs = {}
    if args.text:
        q = seg_question(args.text)
    elif args.ref_image:
        q = img_ref_question()
        kwargs["ref_image"] = load_image_rgb(args.ref_image)
    elif args.roi:
        q = img_ref_question()
        box = np.asarray([float(v) for v in args.roi.split(",")])
        box = box / np.asarray([image.shape[1], image.shape[0]] * 2)
        kwargs["ref_bbox"] = box.astype(np.float32)
    else:
        q = audio_ref_question()
        kwargs["audio_mels"] = audio_to_mel_clips(
            load_wav(args.audio), device=args.device).cpu().numpy()

    sample = SegDataset(cfg).make_sample(image, q, None, None,
                                         file_name=args.image, **kwargs)
    batch = Collator(tok, cfg, train=False, roi=args.roi is not None)([sample])
    predictor = Predictor(params, cfg, max_new_tokens=args.max_new_tokens,
                          device=args.device, encoder_path=args.encoder_path)
    output_ids, masks = predictor.predict(batch)
    text = tok.decode([t for t in output_ids[0].tolist() if t != 2],
                      skip_special=True)
    print("model says:", text)
    m = binary_mask(masks[0], image.shape[0], image.shape[1])
    Image.fromarray((m * 255).astype(np.uint8)).save(args.out)
    print(f"mask -> {args.out} ({m.sum()} px)")
    return output_ids, m


if __name__ == "__main__":
    main()
