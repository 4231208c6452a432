"""Eval CLI: one front door for the segmentation and region-caption
harnesses (port of tools/eval.py; the reference hard-codes its
configuration in per-script __main__ blocks: eval_referseg.py:235-256,
eval_coco20i.py:229-240, eval_reason.py, eval_avs_object.py,
eval_refer_inv.py).

  python -m anyref_tpu_torch.tools.eval referseg --ckpt ckpt/anyref7b.pt \
      --data_root /data --val_datasets refcoco_val,refcocog_test \
      --tokenizer LLaVA-Lightning-7B-v1-1
  python -m anyref_tpu_torch.tools.eval avs --avs_task object --split test ...
  python -m anyref_tpu_torch.tools.eval refer_inv --inv_dataset refcocog \
      --split val --roi ...

``--ckpt`` is a params file of the port (checkpoint.save_params, or the
conversion CLI's output). Without ``--tokenizer`` the byte-level
tokenizer runs, as in the JAX CLI; the published checkpoint needs its own
(``--tokenizer DIR``, AnyRefTokenizer.from_pretrained).
"""

from __future__ import annotations

import argparse

from ..config import ENCODER_PATHS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("task", choices=["referseg", "reason", "coco20i", "avs",
                                    "refer_inv"])
    p.add_argument("--ckpt", required=True,
                   help="params file (checkpoint.save_params)")
    p.add_argument("--data_root", default="/data")
    p.add_argument("--out_root", default="eval_out")
    p.add_argument("--val_datasets", default="refcoco_val")
    p.add_argument("--avs_task", default="object", choices=["object", "multi"])
    p.add_argument("--split", default="test")
    p.add_argument("--inv_dataset", default="refcocog")
    p.add_argument("--roi", action="store_true",
                   help="refer_inv: describe the ref's box, not its crop")
    # default matches the reference's committed __main__ configs: 0.1 for
    # referseg/coco20i (eval_referseg.py:253, eval_coco20i.py:236), 0.0 for
    # reason/avs/refer_inv (eval_reason.py:185, eval_refer_inv.py:39)
    p.add_argument("--rephrase_weight", type=float, default=None)
    p.add_argument("--limit", type=int, default=None,
                   help="samples to score (coco20i: a split; default 101)")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="decode budget (default: config's 128)")
    p.add_argument("--preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (AnyRefTokenizer."
                        "from_pretrained); default: the byte-level one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--encoder_path", default="fused", choices=ENCODER_PATHS)
    args = p.parse_args(argv)

    from .. import checkpoint
    from ..config import anyref_7b, anyref_tiny
    from ..eval.runner import Predictor
    from ..tokenizer import AnyRefTokenizer

    cfg = anyref_7b() if args.preset == "7b" else anyref_tiny()
    if args.rephrase_weight is None:
        args.rephrase_weight = \
            0.1 if args.task in ("referseg", "coco20i") else 0.0
    cfg = cfg.scaled(rephrase_weight=args.rephrase_weight)
    params = checkpoint.load_params(args.ckpt, device=args.device)
    predictor = Predictor(params, cfg, max_new_tokens=args.max_new_tokens,
                          device=args.device,
                          encoder_path=args.encoder_path)
    tok = (AnyRefTokenizer.from_pretrained(args.tokenizer)
           if args.tokenizer else AnyRefTokenizer())

    if args.task == "referseg":
        from ..eval.referseg import evaluate_referseg
        res = evaluate_referseg(predictor, tok, args.data_root,
                                args.val_datasets, args.out_root, args.limit)
    elif args.task == "reason":
        from ..eval.harnesses import evaluate_reason
        res = evaluate_reason(predictor, tok, args.data_root, args.out_root,
                              args.limit)
    elif args.task == "coco20i":
        from ..eval.harnesses import evaluate_coco20i
        res = evaluate_coco20i(predictor, tok, args.data_root, args.out_root,
                               limit=101 if args.limit is None else args.limit)
    elif args.task == "avs":
        from ..eval.harnesses import evaluate_avs
        res = evaluate_avs(predictor, tok, args.data_root, args.avs_task,
                           args.split, args.out_root, args.limit)
    else:
        from ..eval.harnesses import evaluate_refer_inverse
        res = evaluate_refer_inverse(predictor, tok, args.data_root,
                                     args.inv_dataset, args.split, args.roi,
                                     args.out_root, args.limit)
    print(res)
    return res


if __name__ == "__main__":
    main()
