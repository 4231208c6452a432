"""Multi-device serving and training on torch.distributed (port of
anyref_tpu/parallel): a ("data", "model") grid of ranks, one process each
(mesh.py), the Megatron partition of the decoder over "model"
(partition.py), and the collectives that autograd differentiates
(collectives.py)."""
