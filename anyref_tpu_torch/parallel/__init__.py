"""Multi-device serving on torch.distributed (port of anyref_tpu/parallel):
a ("data", "model") grid of ranks, one process each (mesh.py), and the
Megatron partition of the decoder over "model" (partition.py)."""
