"""Parameter partition specs and the local shards they give (port of
anyref_tpu/parallel/partition.py).

Megatron-style tensor parallelism for the LLaMA decoder over "model": q/k/v
and gate/up keep a block of their output features (whole heads), o and down
the matching block of their input features, so each layer needs one
all-reduce after attention and one after the MLP (models/llama.py issues
them). embed_tokens keeps a block of the vocabulary rows, lm_head of its
columns (a masked lookup and a scatter into the full logits, each summed
over "model"). The towers (SAM, CLIP, ImageBind) and an int8 decoder's
leaves are replicated; a batch's rows split over "data".

A spec is a tuple of axis names or None, one entry per leading dim, as the
reference's PartitionSpec (``()`` replicates).

Training keeps the trainables and their Adam moments as blocks of the same
specs (``trainable_spec``: LoRA's b and the dense embed_tokens and lm_head
over "model", the rest replicated); ``gather_tree`` rebuilds the whole
leaves on every rank (a checkpoint, the merged params) and ``shard_tree``
cuts them again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

_COL_KEYS = ("q", "k", "v", "gate", "up",   # output-feature sharded
             "qkv", "gate_up")              # fused serving layout
_ROW_KEYS = ("o", "down")                    # input-feature sharded


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and lists; None stays None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *rest)


def _proj_spec(name: str, storage_key: str) -> tuple:
    """Megatron spec of one projection. "w" stores [in, out], "w_t" [out,
    in] (the serving layout): the sharded logical dim is the same, its
    index flips."""
    col = name in _COL_KEYS
    if storage_key == "w":
        return (None, MODEL_AXIS) if col else (MODEL_AXIS, None)
    return (MODEL_AXIS, None) if col else (None, MODEL_AXIS)


def _llama_layer_spec(layer_params: dict) -> dict:
    spec = {"input_norm": {"scale": ()}, "post_attn_norm": {"scale": ()},
            "attn": {}, "mlp": {}}
    for grp in ("attn", "mlp"):
        for name, p in layer_params[grp].items():
            spec[grp][name] = {sk: _proj_spec(name, sk)
                               if sk in ("w", "w_t") else () for sk in p}
    return spec


def llama_spec(llama_params: dict) -> dict:
    spec = {
        "embed_tokens": (MODEL_AXIS, None),
        "layers": [_llama_layer_spec(lp) for lp in llama_params["layers"]],
        "final_norm": {"scale": ()},
    }
    spec["lm_head"] = (None if llama_params.get("lm_head") is None
                       else (None, MODEL_AXIS))
    if "lm_head_q" in llama_params:
        spec["lm_head_q"] = _replicate_like(llama_params["lm_head_q"])
    return spec


def _replicate_like(tree):
    return _tree_map(lambda _: (), tree)


def anyref_spec(params: dict, cfg) -> dict:
    """Partition specs mirroring an anyref param tree."""
    spec = {k: _replicate_like(v) for k, v in params.items() if k != "llama"}
    spec["llama"] = llama_spec(params["llama"])
    return spec


def batch_spec(batch: dict) -> dict:
    """Every batch array's leading (batch) dim over "data"."""
    return {k: (DATA_AXIS,) for k in batch}


def lora_spec(lora_tree) -> dict:
    """LoRA adapters: a [d, r] replicated, b [r, out] sharded on out as the
    base layer's columns."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        if tree is None:
            return None
        return (None, MODEL_AXIS) if name == "b" else ()
    return walk(lora_tree, None)


def dense_spec(dense: dict) -> dict:
    """The dense trainables (train/lora.py ``split_trainable``, None at the
    frozen positions): embed_tokens and lm_head as the decoder's specs give
    them, the rest replicated."""
    spec = _replicate_like(dense)
    llama = dense.get("llama")
    if llama is not None:
        for key, sp in (("embed_tokens", (MODEL_AXIS, None)),
                        ("lm_head", (None, MODEL_AXIS))):
            if llama.get(key) is not None:
                spec["llama"][key] = sp
    return spec


def trainable_spec(trainables) -> list:
    """Specs of a (lora, dense) pair of trees (a TrainState's trainables,
    their gradients or their Adam moments)."""
    lora, dense = trainables
    return [lora_spec(lora), dense_spec(dense)]


def local_block(x, spec: tuple, mesh: Mesh):
    """The block of ``x`` that the rank at ``mesh.coords`` holds under
    ``spec`` (a view); a dim that its axis does not divide raises."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {n} ranks of {axis!r}")
        size = x.shape[dim] // n
        start = mesh.coords[axis] * size
        index.append(slice(start, start + size))
    return x[tuple(index)]


class ShardedParams(dict):
    """An anyref param tree holding this rank's blocks, with the mesh they
    were cut for (``.mesh``): Predictor and Server take the mesh from it."""

    def __init__(self, tree: dict, mesh: Mesh):
        super().__init__(tree)
        self.mesh = mesh


@torch.no_grad()
def shard_params(params: dict, mesh: Mesh, cfg) -> ShardedParams:
    """This rank's blocks of an anyref param tree on ``mesh.device``: the
    decoder tensor-parallel over "model", everything else replicated.
    Consumes the caller's tree IN PLACE, leaf by leaf (each leaf's block is
    copied, then the full leaf dropped), so that peak memory stays within
    one extra leaf. The decoder must be in the [in, out] or the transposed
    layout: a block of the fused q/k/v (gate/up) rows is not a block of
    heads (the reference's compiler keeps the meaning of any layout; local
    ops cannot), so a fused tree raises a ValueError."""
    for layer in params["llama"]["layers"]:
        if "qkv" in layer["attn"] or "gate_up" in layer["mlp"]:
            raise ValueError(
                "shard_params takes the decoder's [in, out] or transposed "
                "layout, not the fused serving layout "
                "(llama.fuse_for_serving)")
    spec = anyref_spec(params, cfg)

    def place(tree, sp):
        if isinstance(tree, dict):
            for k in list(tree):
                tree[k] = place(tree[k], sp[k])
            return tree
        if isinstance(tree, list):
            for i in range(len(tree)):
                tree[i] = place(tree[i], sp[i])
            return tree
        if tree is None:
            return None
        if not any(sp):
            return tree.to(mesh.device)
        return local_block(tree, sp, mesh).to(
            mesh.device, memory_format=torch.contiguous_format, copy=True)

    return ShardedParams(place(params, spec), mesh)


def shard_tree(tree, spec, mesh: Mesh):
    """This rank's blocks of ``tree``'s leaves under ``spec`` (views;
    replicated leaves as they are)."""
    return _tree_map(lambda x, sp: local_block(x, sp, mesh) if any(sp)
                     else x, tree, spec)


@torch.no_grad()
def gather_tree(tree, spec, mesh: Mesh):
    """The whole leaves of a tree of this rank's blocks under ``spec``,
    on every rank: each block written into zeros of the whole shape and
    summed over its axes' groups (exact: the other ranks add zeros).
    Collective over those groups; replicated leaves are returned as they
    are."""
    def gather(x, sp):
        if not any(sp):
            return x
        shape, index = list(x.shape), []
        for dim, axis in enumerate(sp):
            if axis is None:
                index.append(slice(None))
                continue
            n = x.shape[dim]
            shape[dim] = n * mesh.shape[axis]
            index.append(slice(mesh.coords[axis] * n,
                               (mesh.coords[axis] + 1) * n))
        full = x.new_zeros(shape)
        full[tuple(index)] = x
        for axis in dict.fromkeys(a for a in sp if a is not None):
            if mesh.group(axis) is not None:
                dist.all_reduce(full, group=mesh.group(axis))
        return full
    return _tree_map(gather, tree, spec)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a collated batch (arrays or tensors) over "data",
    as tensors on ``mesh.device``; a batch that "data" does not divide
    raises (host-only keys like _meta must be stripped by the caller)."""
    spec = batch_spec(batch)
    return {k: local_block(torch.as_tensor(v), spec[k], mesh).to(mesh.device)
            for k, v in batch.items()}
