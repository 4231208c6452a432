"""Build the reference-crop sample index (port of tools/build_ref_index.py;
replaces the reference's samples.py:1-13): class -> [(img_idx, ann_idx)]
where box/img area > 0.1 and mask/box > 0.4, written to
samples_0.05_0.25.json for the image-reference datasets.

  python -m anyref_tpu_torch.tools.build_ref_index \
      --image_root /data/coco/train2017 \
      --json_file /data/coco/annotations/instances_train2017.json \
      --out /data/samples_0.05_0.25.json
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_root", required=True)
    p.add_argument("--json_file", required=True)
    p.add_argument("--out", default="samples_0.05_0.25.json")
    p.add_argument("--box_img_threshold", type=float, default=0.1)
    p.add_argument("--mask_box_threshold", type=float, default=0.4)
    args = p.parse_args(argv)

    from ..data.coco import build_ref_index
    idx = build_ref_index(args.image_root, args.json_file, args.out,
                          args.box_img_threshold, args.mask_box_threshold)
    print(f"wrote {args.out}: {sum(len(v) for v in idx.values())} samples "
          f"over {len(idx)} classes")
    return idx


if __name__ == "__main__":
    main()
