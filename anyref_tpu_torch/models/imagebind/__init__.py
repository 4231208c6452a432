"""ImageBind's audio tower (port of anyref_tpu/models/imagebind)."""
