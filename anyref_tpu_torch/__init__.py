"""anyref_tpu_torch: the PyTorch / CUDA port of anyref_tpu for one NVIDIA
H100.

The JAX package ``anyref_tpu`` is the reference; this package mirrors its
layout module for module and imports nothing of it (nor JAX). Entry points
run on the card unless the caller passes ``device="cpu"``.

Precision: fp32 matrix products and convolutions run in full fp32, never
TF32, so the fp32 islands of the reference (SAM neck, text_hidden_fcs,
lm_head, rel-pos factors) keep their digits on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
