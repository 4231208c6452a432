"""AnyRef model core (port of anyref_tpu/models/anyref.py generate,
train_forward and what they call).

A LLaVA-style LLaMA emits [SEG] tokens; their post-norm hidden states project
(text_hidden_fcs) into SAM's prompt space and SAM's mask decoder turns them
into masks. Prompts arrive left-padded; the decode loop, greedy with early
exit or batched prompt-lookup speculative decoding whose output equals the
greedy stream, has the reference's ``lax.while_loop`` form: a predicate
and a body over a carry of device tensors (``DecodeLoop``), run as a host
loop here (``run_loop``) and as a conditional node of the Predictor's CUDA
graph on the card (eval/runner.py). ``train_forward`` is the training
forward: LM loss plus mask BCE and DICE on the SAM canvas, with the frozen
towers under ``torch.no_grad``, and with ``cfg.use_loc_tokens`` the loc
tokens of a batch that carries ``loc_boxes``. With ``cfg.rephrase_weight``
> 0 both add the reference's rephrase pooling to each [SEG] state: the
answer's states before the first [SEG], weighted by the final decoder
layer's head-mean attention row of the state that emitted it.

A referring expression may also be an image crop (CLIP's patches pooled to
4 tokens), an RoI box (one learned embedding per quantized coordinate) or
audio (ImageBind's audio tower, 3 clips, projected): their features fill
the prompt's 4 <img_ref> or 3 <audio_ref> placeholders. A batch carries a
crop or a box, never both, plus optional audio; rows without one keep the
placeholders' token embeddings.

On a mesh (parallel/mesh.py), ``generate`` and ``train_forward`` run on
this rank's rows of the batch with the decoder's blocks of
parallel/partition.py ``shard_params``, their collectives over the mesh's
"model" group (models/llama.py); the [SEG] states are whole after the last
one, so the towers, text_hidden_fcs and SAM run replicated on the rank's
rows. ``train_forward``'s losses are the global batch's means over
"data" (ops/losses.py); given the batch's global ``loss_counts`` (summed
over the ranks by the host, ``loss_counts``) each is this rank's share of
that mean, with no collective.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import (IGNORE_INDEX, IMG_REF_NUM, NUM_IMAGE_TOKENS,
                      AnyRefConfig, check_encoder_path)
from ..ops.common import linear, rms_norm
from ..ops.losses import dice_loss, lm_cross_entropy, sigmoid_ce_loss
from ..params import resolve_device
from ..parallel.collectives import copy_to_group, reduce_from_group
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..tokenizer import EOS_ID, PAD_ID
from . import clip_vit, llama
from . import sam as sam_mod
from .imagebind import audio as imagebind_audio


def encode_clip_images(params: dict, cfg: AnyRefConfig, clip_pixels,
                       encoder_path: str = "fused"):
    """CLIP tower + mm_projector -> [B, 256, llama_hidden]."""
    feats = clip_vit.apply_patch_features(params["clip"], clip_pixels,
                                          cfg.clip, encoder_path)
    return linear(params["mm_projector"], feats)


def _expand_image(ids, img_pos, fill_value: int, out_len: int):
    """[B, T] -> [B, T+255]: the <image> token at img_pos[b] becomes
    NUM_IMAGE_TOKENS positions of fill_value."""
    T = ids.shape[1]
    j = torch.arange(out_len, device=ids.device)[None, :]
    p = img_pos[:, None]
    in_img = (j >= p) & (j < p + NUM_IMAGE_TOKENS)
    src = torch.where(j < p, j, j - (NUM_IMAGE_TOKENS - 1)).clamp(0, T - 1)
    gathered = torch.gather(ids, 1, src)
    return torch.where(in_img, torch.full_like(gathered, fill_value),
                       gathered)


def _scatter_placeholder(embeds, token_ids, placeholder_id: int, feats,
                         valid):
    """Replace embeds [B, L, D] where token_ids == placeholder_id by feats
    [B, K, D]: the k-th occurrence takes row k (clamped to the last); rows
    whose ``valid`` [B] is false keep their embeddings."""
    mask = (token_ids == placeholder_id) & valid[:, None]
    occ = (torch.cumsum(mask.long(), 1) - 1).clamp(0, feats.shape[1] - 1)
    gathered = torch.gather(
        feats, 1, occ[:, :, None].expand(-1, -1, feats.shape[-1]))
    return torch.where(mask[:, :, None], gathered.to(embeds.dtype), embeds)


def encode_ref_images(params: dict, cfg: AnyRefConfig, ref_pixels,
                      encoder_path: str = "fused"):
    """The reference crop: CLIP's 256 patch features pooled 256 -> 16 -> 4
    tokens [B, 4, D], in two means as the reference pools them (the
    rounding between them is part of the result). CLIP and mm_projector
    are frozen: no gradient."""
    with torch.no_grad():
        feats = encode_clip_images(params, cfg, ref_pixels, encoder_path)
        B, L, D = feats.shape
        feats = feats.reshape(B, L // 16, 16, D).mean(2)         # [B, 16, D]
        return feats.reshape(B, IMG_REF_NUM, -1, D).mean(2)      # [B, 4, D]


def encode_roi(params: dict, roi_boxes):
    """Normalized xyxy boxes [B, 4] -> [B, 4, D]: coordinate k quantized to
    round(100 x) (half to even, as jnp.round), clamped to 0-100, picks row
    of params["roi_embed"][k]."""
    q = torch.round(roi_boxes.float() * 100.0).clamp(0, 100).long()
    slot = torch.arange(q.shape[1], device=q.device)[None, :]
    return params["roi_embed"][slot, q]


def encode_audio(params: dict, cfg: AnyRefConfig, mels):
    """Audio clips [B, 3, 1, mel_bins, target_len] -> reference tokens
    [B, 3, D] through the frozen ImageBind tower and the audio_projector."""
    with torch.no_grad():
        _, emb = imagebind_audio.get_audio_feature(params["audio_encoder"],
                                                   cfg.audio, mels)
    proj = params["audio_projector"]
    return linear(proj, emb.to(proj["w"].dtype))


def _encode_reference_feats(params: dict, cfg: AnyRefConfig, batch: dict,
                            dev, encoder_path: str = "fused"):
    """The reference signal of a batch: an image crop or an RoI box (the
    crop when both keys are present, as the reference), plus optional
    audio. Returns (ref_feats, ref_valid, audio_feats, audio_valid), each
    None where the batch has no such key."""
    def t(key):
        return (None if batch.get(key) is None
                else torch.as_tensor(batch[key], device=dev))

    ref_feats = audio_feats = ref_valid = audio_valid = None
    if "ref_images" in batch:
        ref_feats = encode_ref_images(params, cfg, t("ref_images"),
                                      encoder_path)
        ref_valid = t("ref_valid")
    elif "roi_boxes" in batch:
        ref_feats = encode_roi(params, t("roi_boxes"))
        ref_valid = t("ref_valid")
    if "audio_mels" in batch and cfg.audio is not None:
        audio_feats = encode_audio(params, cfg, t("audio_mels"))
        audio_valid = t("audio_valid")
    return ref_feats, ref_valid, audio_feats, audio_valid


def assemble_embeds(params: dict, cfg: AnyRefConfig, input_ids, clip_feats,
                    ref_feats=None, ref_valid=None, audio_feats=None,
                    audio_valid=None, labels=None, group=None):
    """input_ids [B, T] with one <image> token per row -> (embeds
    [B, T+255, D] with the CLIP features spliced in, expanded ids, expanded
    labels (IGNORE_INDEX over the image) or None). ``ref_feats`` [B, 4, D]
    fill the <img_ref> placeholders and ``audio_feats`` [B, 3, D] the
    <audio_ref> ones, in rows whose ``*_valid`` [B] is true (every row
    where it is None). ``group``: llama.embed's "model" group."""
    tk = cfg.tokens
    B, T = input_ids.shape
    L = T + NUM_IMAGE_TOKENS - 1
    img_pos = (input_ids == tk.image).to(torch.uint8).argmax(1)
    exp_ids = _expand_image(input_ids, img_pos, tk.image, L)
    embeds = llama.embed(params["llama"], exp_ids, group=group)
    j = torch.arange(L, device=input_ids.device)[None, :]
    p = img_pos[:, None]
    in_img = (j >= p) & (j < p + NUM_IMAGE_TOKENS)
    img_idx = (j - p).clamp(0, NUM_IMAGE_TOKENS - 1)
    D = clip_feats.shape[-1]
    img = torch.gather(clip_feats, 1, img_idx[:, :, None].expand(-1, -1, D))
    embeds = torch.where(in_img[:, :, None], img.to(embeds.dtype), embeds)
    for slot, feats, valid in ((tk.img_ref, ref_feats, ref_valid),
                               (tk.audio_ref, audio_feats, audio_valid)):
        if feats is not None:
            if valid is None:
                valid = torch.ones((B,), device=input_ids.device)
            embeds = _scatter_placeholder(embeds, exp_ids, slot, feats,
                                          valid.to(torch.bool))
    exp_labels = None
    if labels is not None:
        exp_labels = _expand_image(labels, img_pos, IGNORE_INDEX, L)
    return embeds, exp_ids, exp_labels


def _seg_slots(ids, seg_id: int, max_seg: int):
    """Positions of up to max_seg [SEG] tokens per row (pos [B, S], valid
    [B, S]); overflow [SEG]s land in a dropped column."""
    B, L = ids.shape
    is_seg = ids == seg_id
    occ = torch.cumsum(is_seg.long(), 1) - 1
    slot = torch.where(is_seg, occ, torch.full_like(occ, max_seg))
    slot = slot.clamp(0, max_seg)
    lidx = torch.arange(L, device=ids.device)[None, :].expand(B, L)
    pos = torch.zeros((B, max_seg + 1), dtype=torch.long, device=ids.device)
    pos = pos.scatter_reduce(1, slot, torch.where(is_seg, lidx, 0),
                             reduce="amax")[:, :max_seg]
    count = is_seg.sum(1)
    valid = torch.arange(max_seg, device=ids.device)[None, :] < count[:, None]
    return pos, valid


def project_seg_hidden(params: dict, hidden):
    """text_hidden_fcs in fp32."""
    h = torch.relu(linear(params["text_hidden_fcs"]["lin1"], hidden.float()))
    return linear(params["text_hidden_fcs"]["lin2"], h)


def _prompt_lookup_draft(seq, cur_len, ngram: int, draft_len: int):
    """Per row of seq [B, LT]: draft the next ``draft_len`` tokens by
    copying what followed the latest earlier occurrence of the current
    ``ngram``-suffix, with periodic wrap inside the known region (falls back
    to repeating the last token). ``cur_len``: the known length, a 0-d int
    tensor (the decode loop's) or an int."""
    B, LT = seq.shape
    dev = seq.device
    gram = torch.gather(seq, 1, (cur_len - ngram + torch.arange(
        ngram, device=dev)).expand(B, ngram))
    idx = torch.arange(LT, device=dev)
    eq = torch.ones((B, LT), dtype=torch.bool, device=dev)
    for t in range(ngram):
        eq &= seq[:, (idx + t).clamp(0, LT - 1)] == gram[:, t:t + 1]
    valid = idx + ngram <= cur_len - 1
    score = torch.where(eq & valid, idx, -1)
    j = score.max(1).values
    start = torch.where(j >= 0, j + ngram, cur_len - 1)
    period = (cur_len - start).clamp_min(1)
    offs = torch.arange(draft_len, device=dev)[None, :] % period[:, None]
    return torch.gather(seq, 1, (start[:, None] + offs).clamp(0, LT - 1))


class DecodeLoop(NamedTuple):
    """A decode loop in the reference's ``lax.while_loop`` form: ``cond(
    carry)`` is a 0-d bool tensor, ``body(carry)`` one decoder pass that
    writes the next carry into the carry's own tensors (``copy_``,
    ``index_copy_``; the KV cache in place) and returns it. Neither reads
    anything back from the device, so the loop runs as a host loop
    (``run_loop``) or, captured, as a device-side conditional node
    (eval/runner.py); ``finish(carry)`` is what follows the loop."""
    cond: Callable
    body: Callable
    carry: dict


def run_loop(loop: DecodeLoop, fixed_steps: Optional[int] = None) -> dict:
    """The host loop: ``body`` while ``cond`` holds, one read of the
    predicate a pass; or, with ``fixed_steps``, that many bodies and no
    read at all."""
    c = loop.carry
    if fixed_steps is not None:
        for _ in range(fixed_steps):
            c = loop.body(c)
        return c
    while bool(loop.cond(c)):
        c = loop.body(c)
    return c


def _loop_cond(mnt: int):
    def cond(c):
        return (c["i"] < mnt) & ~c["done"].all()
    return cond


def _speculative_loop(params, cfg, exp_ids, pad_len, cache, first_tok,
                      Lp: int, mnt: int, G: int, ngram: int, dtype,
                      max_accept: Optional[int] = None,
                      force_accept: bool = False, lastin: bool = False,
                      group=None):
    """Batched prompt-lookup speculative decode, lockstep-min acceptance:
    each pass verifies the pending token plus G per-row drafts in one chunk;
    all rows advance by the minimum accepted length over unfinished rows.
    ``max_accept`` caps tokens accepted per pass; ``force_accept``
    (benchmark only) accepts exactly max_accept drafts regardless of
    verification. Returns (DecodeLoop, finish) with finish(carry) -> (ids
    [B, mnt], hidden [B, mnt, D], the final layer's input of each position
    [B, mnt, D] or None without ``lastin``, passes as a 0-d int32
    tensor). The carry is the reference's (anyref.py _speculative_decode):
    the position ``i`` and the pass count ``n_pass`` as int32 tensors."""
    eos = EOS_ID
    B = exp_ids.shape[0]
    dev = exp_ids.device
    D = params["llama"]["final_norm"]["scale"].shape[0]
    ext = mnt + G + 1
    carry = {
        "i": torch.zeros((), dtype=torch.int32, device=dev),
        "n_pass": torch.zeros((), dtype=torch.int32, device=dev),
        "tok": first_tok.clone(),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
        "toks": torch.full((B, ext), eos, dtype=torch.long, device=dev),
        "hids": torch.zeros((B, ext, D), dtype=dtype, device=dev),
        "all_ids": torch.cat([exp_ids, torch.full(
            (B, ext), eos, dtype=torch.long, device=dev)], 1)}
    if lastin:
        carry["lins"] = torch.zeros((B, ext, D), dtype=dtype, device=dev)
    arange_g = torch.arange(G + 1, device=dev)
    ones = torch.ones((B, 1), dtype=torch.long, device=dev)

    def body(c):
        i, tok, done, all_ids = c["i"], c["tok"], c["done"], c["all_ids"]
        all_ids.index_copy_(1, (Lp + i).long().reshape(1), tok[:, None])
        draft = _prompt_lookup_draft(all_ids, Lp + i + 1, ngram, G)
        feed = torch.cat([tok[:, None], draft], 1)
        feed = torch.where(done[:, None], eos, feed)
        emb = llama.embed(params["llama"], feed, dtype=dtype, group=group)
        h, _, *lin = llama.decode_chunk(params["llama"], cfg.llama, emb,
                                        Lp + i, cache, pad_len=pad_len,
                                        return_last_input=lastin,
                                        group=group)
        nxt = llama.logits(params["llama"], h, group).argmax(-1)  # [B, G+1]

        match = torch.cumprod((feed[:, 1:] == nxt[:, :G]).long(), 1)
        acc = torch.cat([ones, match], 1)
        no_eos_before = torch.cumprod(
            torch.cat([ones, (feed[:, :G] != eos).long()], 1), 1)
        ok = acc * no_eos_before
        if force_accept and max_accept is not None:
            ok = no_eos_before * (arange_g < max_accept).long()[None]
        elif max_accept is not None:
            ok = ok * (arange_g < max_accept).long()[None]
        n_emit_row = ok.sum(1)
        # finished rows must not throttle the batch
        n_emit = torch.where(done, G + 1, n_emit_row).min().clamp_min(1)
        # EOS only counts as emitted inside the accepted prefix
        ok_eff = ok * (arange_g[None] < n_emit).long()
        done_next = done | ((feed == eos) & (ok_eff == 1)).any(1)

        at = i.long() + arange_g
        c["toks"].index_copy_(1, at, feed)
        c["hids"].index_copy_(1, at, h)
        if lastin:
            c["lins"].index_copy_(1, at, lin[0])
        all_ids.index_copy_(1, Lp + at, feed)
        next_tok = torch.gather(nxt, 1, (n_emit - 1).clamp(0, G)
                                .expand(B, 1))[:, 0]
        tok.copy_(torch.where(done_next, eos, next_tok))
        done.copy_(done_next)
        i.add_(n_emit.to(i.dtype))
        c["n_pass"].add_(1)
        return c

    def finish(c):
        live = torch.arange(ext, device=dev)[None, :] < c["i"]
        toks = torch.where(live, c["toks"], eos)
        hids = torch.where(live[:, :, None], c["hids"], 0)
        return (toks[:, :mnt], hids[:, :mnt],
                c["lins"][:, :mnt] if lastin else None, c["n_pass"])

    return DecodeLoop(_loop_cond(mnt), body, carry), finish


def _greedy_loop(params, cfg, pad_len, cache, first_tok, Lp: int, mnt: int,
                 dtype, lastin: bool = False, group=None):
    """Greedy decode, a pass a token, until every row has emitted EOS or
    ``mnt`` steps ran; run for all ``mnt`` steps (``run_loop``'s
    ``fixed_steps``) it gives the same outputs: finished rows write EOS and
    zero states either way (the reference's comment at its decode loop).
    Returns (DecodeLoop, finish) with finish(carry) -> (ids [B, mnt], hidden
    [B, mnt, D], final-layer inputs [B, mnt, D] or None, steps as a 0-d
    int32 tensor)."""
    eos = EOS_ID
    B = first_tok.shape[0]
    dev = first_tok.device
    D = params["llama"]["final_norm"]["scale"].shape[0]
    carry = {
        "i": torch.zeros((), dtype=torch.int32, device=dev),
        "tok": first_tok.clone(),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
        "toks": torch.full((B, mnt), eos, dtype=torch.long, device=dev),
        "hids": torch.zeros((B, mnt, D), dtype=dtype, device=dev)}
    if lastin:
        carry["lins"] = torch.zeros((B, mnt, D), dtype=dtype, device=dev)

    def body(c):
        i, tok, done = c["i"], c["tok"], c["done"]
        emb = llama.embed(params["llama"], tok[:, None], dtype=dtype,
                          group=group)
        h, _, *lin = llama.decode_step(params["llama"], cfg.llama, emb,
                                       Lp + i, cache, pad_len=pad_len,
                                       return_last_input=lastin,
                                       group=group)
        nxt = llama.logits(params["llama"], h[:, 0], group).argmax(-1)
        done_next = done | (tok == eos)
        at = i.long().reshape(1)
        c["toks"].index_copy_(1, at, torch.where(done, eos, tok)[:, None])
        c["hids"].index_copy_(1, at, h)
        if lastin:
            c["lins"].index_copy_(1, at, lin[0])
        tok.copy_(torch.where(done_next, eos, nxt))
        done.copy_(done_next)
        i.add_(1)
        return c

    def finish(c):
        return (c["toks"], c["hids"], c["lins"] if lastin else None,
                c["i"])

    return DecodeLoop(_loop_cond(mnt), body, carry), finish


# the columns of a batch's "loss_counts": the LM targets that are not
# IGNORE_INDEX, and the valid masks (BCE and DICE)
LOSS_COUNTS = ("lm_targets", "masks")


def loss_counts(cfg: AnyRefConfig, batch: dict) -> np.ndarray:
    """The counts train_forward's losses divide by, from the host arrays of
    ``batch`` (input_ids, labels [..., B, T], mask_valid [..., B, S]):
    [..., len(LOSS_COUNTS)] fp32, summed over the batch rows. The LM
    targets are the expanded labels shifted by one: every label but the
    first and the <image> token's, which the splice replaces by
    IGNORE_INDEX; a mask is valid where its slot holds one of the row's
    first max_seg_per_sample [SEG] tokens and ``mask_valid`` is set."""
    ids = np.asarray(batch["input_ids"])
    labels = np.asarray(batch["labels"])
    img = np.argmax(ids == cfg.tokens.image, -1)[..., None]
    pos = np.arange(ids.shape[-1])
    targets = (labels != IGNORE_INDEX) & (pos > 0) & (pos != img)
    mask_valid = np.asarray(batch["mask_valid"]).astype(bool)
    n_seg = (ids == cfg.tokens.seg).sum(-1)[..., None]
    masks = mask_valid & (np.arange(mask_valid.shape[-1]) < n_seg)
    return np.stack([targets.sum((-2, -1)), masks.sum((-2, -1))],
                    -1).astype(np.float32)


class TrainOutput(NamedTuple):
    loss: torch.Tensor
    lm_loss: torch.Tensor
    bce_loss: torch.Tensor
    dice_loss: torch.Tensor
    pred_masks: torch.Tensor      # [B, S, image_size, image_size] logits
    seg_valid: torch.Tensor       # [B, S]


def _last_layer_attn_row(params: dict, cfg: AnyRefConfig, q_in, k_roped,
                         q_pos, q_slot, kv_start=None, group=None):
    """The final decoder layer's attention probabilities for one query row
    per sample, softmax per head over the full causal row in fp32, then the
    mean over heads (reference anyref.py:376-381, :745-748). Recomputed from
    that layer's residual input instead of carried out of the attention.

    q_in [B, D]: the residual entering the final layer at the query;
    k_roped [B, kv_heads, T, hd]: that layer's roped keys (the KV cache, read
    in place, or recomputed); q_pos [B]: the query's rope position; q_slot
    [B]: its key slot (causal bound); kv_start [B]: the first unmasked key
    (left pad); group: the "model" group over which a rank's block of
    heads is summed before the mean. Returns [B, T] fp32."""
    lcfg = cfg.llama
    hd = lcfg.head_dim
    p = params["llama"]["layers"][-1]
    h = rms_norm(p["input_norm"], q_in[:, None, :], eps=lcfg.rms_norm_eps)
    q = linear(llama.attn_proj(p["attn"], "q", lcfg),
               copy_to_group(h, group))                     # [B, 1, nh*hd]
    B, nh, kvh = q.shape[0], q.shape[-1] // hd, k_roped.shape[1]
    q = q.reshape(B, 1, nh, hd).transpose(1, 2)
    q = llama._rope(q, llama._rope_tables(q_pos[:, None], hd,
                                          lcfg.rope_theta))[:, :, 0]
    k = k_roped.repeat_interleave(nh // kvh, 1) if nh != kvh else k_roped
    logits = torch.einsum("bhd,bhtd->bht", q.float(),
                          k.float()) * hd ** -0.5
    t = torch.arange(k.shape[2], device=k.device)[None, None, :]
    mask = t <= q_slot[:, None, None]
    if kv_start is not None:
        mask = mask & (t >= kv_start[:, None, None])
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, -1)
    if group is None or nh == lcfg.num_heads:
        return probs.mean(1)
    return reduce_from_group(probs.sum(1), group) / lcfg.num_heads


def _span_pool(row, hidden, span):
    """``row`` renormalised over ``span``, pooling ``hidden`` [B, L, D] in
    fp32 (reference anyref.py:380-384); an empty span contributes 0."""
    w = row * span.float()
    denom = w.sum(1, keepdim=True)
    w = torch.where(denom > 0, w / denom.clamp_min(1e-20), 0.0)
    return torch.einsum("bl,bld->bd", w, hidden.float())


def _rephrase_pool(params: dict, cfg: AnyRefConfig, hidden, last_in,
                   exp_labels, seg_pos, group=None):
    """Training-path rephrase pooling (reference anyref.py:372-392): query =
    the state emitting the first [SEG] (seg_pos - 1), span = [first label
    - 1, seg_pos - 1), weights = the final layer's head-mean softmax row,
    renormalised over the span; the keys recomputed from ``last_in``.
    ``group``: the "model" group over which the rank's heads are summed.
    Returns [B, 1, D] in hidden's dtype."""
    B, L, _ = hidden.shape
    lcfg = cfg.llama
    p = params["llama"]["layers"][-1]
    hn = rms_norm(p["input_norm"], last_in, eps=lcfg.rms_norm_eps)
    k = linear(llama.attn_proj(p["attn"], "k", lcfg),
               copy_to_group(hn, group)).reshape(
        B, L, -1, lcfg.head_dim).transpose(1, 2)
    k = llama._rope(k, llama._rope_tables(
        torch.arange(L, device=hidden.device), lcfg.head_dim,
        lcfg.rope_theta))
    ans_start = (exp_labels > 0).to(torch.uint8).argmax(1) - 1
    q_pos = (seg_pos[:, 0] - 1).clamp_min(0)
    q_in = last_in[torch.arange(B, device=hidden.device), q_pos]
    row = _last_layer_attn_row(params, cfg, q_in, k, q_pos, q_pos,
                               group=group)
    j = torch.arange(L, device=hidden.device)[None, :]
    span = (j >= ans_start[:, None]) & (j < q_pos[:, None])
    return _span_pool(row, hidden, span)[:, None, :].to(hidden.dtype)


def train_forward(params: dict, cfg: AnyRefConfig, batch: dict,
                  encoder_path: str = "fused", remat: bool = False,
                  mesh=None) -> TrainOutput:
    """One training forward, on the device the params live on.

    batch (arrays or tensors): input_ids [B, T], labels [B, T],
    clip_images [B, 3, 224, 224], sam_images [B, 3, S, S], gt_masks
    [B, S_seg, S, S] on the SAM canvas, mask_valid [B, S_seg],
    sam_resized_sizes [B, 2]; optional loc_boxes [B, S_seg, 4] indices of
    ``params["loc_embeddings"]``, used with ``cfg.use_loc_tokens``;
    optional references: ref_images [B, 3, 224, 224] or roi_boxes [B, 4]
    with ref_valid [B], audio_mels [B, 3, 1, 128, 204] with audio_valid
    [B]. CLIP, mm_projector, the audio tower and the SAM image encoder run
    under ``torch.no_grad`` (frozen towers; the reference's
    stop_gradient). ``remat`` checkpoints each decoder layer. ``mesh``
    (parallel/mesh.py): the batch holds this rank's rows and the params its
    blocks (``shard_params``); the loss terms are the global batch's, or,
    where the batch carries the global ``loss_counts`` [len(LOSS_COUNTS)],
    this rank's shares of them (summing to the global batch's over
    "data"), computed without a collective. The
    step program (train/step.py) passes device tensors, a captured step's
    static inputs, so nothing is uploaded here; numpy arrays are uploaded
    where an eager caller passes them."""
    check_encoder_path(encoder_path)
    tk = cfg.tokens
    dev = params["llama"]["embed_tokens"].device
    group = data = None
    if mesh is not None:
        group, data = mesh.group(MODEL_AXIS), mesh.group(DATA_AXIS)
    counts = (None, None)
    if "loss_counts" in batch:
        counts = torch.as_tensor(batch["loss_counts"], device=dev).unbind(-1)

    def t(key, dtype=None):
        x = torch.as_tensor(batch[key], device=dev)
        return x if dtype is None else x.to(dtype)

    input_ids, labels = t("input_ids", torch.long), t("labels", torch.long)
    with torch.no_grad():
        clip_feats = encode_clip_images(params, cfg, t("clip_images"),
                                        encoder_path)
        image_embeddings = sam_mod.encode_image(params["sam"],
                                                t("sam_images"), cfg.sam,
                                                encoder_path)
    embeds, exp_ids, exp_labels = assemble_embeds(
        params, cfg, input_ids, clip_feats,
        *_encode_reference_feats(params, cfg, batch, dev, encoder_path),
        labels=labels, group=group)
    hidden, last_in = llama.forward(params["llama"], cfg.llama, embeds,
                                    return_last_input=True, remat=remat,
                                    group=group)
    lm_loss = lm_cross_entropy(llama.logits(params["llama"], hidden, group),
                               exp_labels, IGNORE_INDEX, group=data,
                               count=counts[0])

    seg_pos, seg_valid = _seg_slots(exp_ids, tk.seg, cfg.max_seg_per_sample)
    B, S = seg_pos.shape
    D = hidden.shape[-1]
    hid_idx = (seg_pos - 1).clamp(0, hidden.shape[1] - 1)
    seg_hidden = torch.gather(hidden, 1, hid_idx[:, :, None].expand(-1, -1, D))
    if cfg.rephrase_weight > 0:
        seg_hidden = seg_hidden + cfg.rephrase_weight * _rephrase_pool(
            params, cfg, hidden, last_in, exp_labels, seg_pos, group)
    pred_emb = project_seg_hidden(params, seg_hidden)           # [B, S, out]
    if cfg.use_loc_tokens and "loc_boxes" in batch:
        # the mean of each [SEG] slot's 4 loc embeddings (reference
        # anyref.py:437-440); without loc_boxes the batch trains without them
        loc = params["loc_embeddings"][t("loc_boxes", torch.long)]  # [B, S, 4, out]
        pred_emb = pred_emb + cfg.loc_weight * loc.mean(dim=2)
    img_index = torch.arange(B, device=dev)[:, None].expand(B, S).reshape(-1)
    low_res, _ = sam_mod.decode_text_prompts(
        params["sam"], cfg.sam, image_embeddings, pred_emb.reshape(B * S, -1),
        img_index)                                              # [B*S, 1, 4g, 4g]

    # mask losses on the image_size^2 canvas in fp32, over the in-image
    # pixels (the bottom/right padding excluded)
    g = cfg.sam.image_size
    canvas = sam_mod.upscale_masks(low_res, cfg.sam).reshape(B, S, g, g)
    valid = seg_valid & t("mask_valid", torch.bool)
    sizes = t("sam_resized_sizes")
    ar = torch.arange(g, device=dev)
    rows = ar[None, :, None] < sizes[:, 0][:, None, None]
    cols = ar[None, None, :] < sizes[:, 1][:, None, None]
    pixel_mask = (rows & cols)[:, None].expand(B, S, g, g).reshape(B * S, g, g)
    flat_pred = canvas.reshape(B * S, g, g)
    flat_gt = t("gt_masks", torch.float32).reshape(B * S, g, g)
    flat_valid = valid.reshape(B * S)
    bce = sigmoid_ce_loss(flat_pred, flat_gt, flat_valid, pixel_mask, data,
                          counts[1])
    dce = dice_loss(flat_pred, flat_gt, flat_valid, pixel_mask, data,
                    counts[1])
    loss = (cfg.ce_loss_weight * lm_loss + cfg.bce_loss_weight * bce
            + cfg.dice_loss_weight * dce)
    return TrainOutput(loss, lm_loss, bce, dce, canvas, valid)


class GenerateOutput(NamedTuple):
    output_ids: torch.Tensor      # [B, max_new_tokens]
    num_generated: torch.Tensor   # [B]
    low_res_masks: torch.Tensor   # [B, S, 4g, 4g] logits (SAM low-res grid)
    seg_valid: torch.Tensor       # [B, S]
    seg_embeddings: torch.Tensor  # [B, S, out_dim]
    decode_passes: torch.Tensor   # 0-d int32: decode weight streams
                                  # (tokens/pass = num_generated /
                                  # decode_passes)

    @property
    def mask_canvas(self):
        """The reference's compatibility name of ``low_res_masks``: callers
        upsample on the host (ops/resize.py postprocess_low_res_np)."""
        return self.low_res_masks


@torch.inference_mode()
def generate(params: dict, cfg: AnyRefConfig, batch: dict,
             max_new_tokens: Optional[int] = None,
             speculative: bool = False, draft_len: int = 31,
             lookup_ngram: int = 2, max_accept: Optional[int] = None,
             force_accept: bool = False, device="cuda",
             encoder_path: str = "fused",
             fixed_steps: bool = False, mesh=None) -> GenerateOutput:
    """Greedy (or speculative) decode + SAM mask synthesis.

    batch: input_ids [B, T] (prompt only, LEFT-padded, one <image> per
    row), clip_images [B, 3, 224, 224] and sam_images [B, 3, S, S]
    normalized, optional references as train_forward takes them; arrays or
    tensors, moved to ``device``. The params must
    already live on ``device``. ``encoder_path`` selects the towers' path
    (config.ENCODER_PATHS). An int8 decoder tree (ops.quant.quantize_llama)
    runs greedy and speculative decode alike; so does either layout of the
    decoder (llama.fuse_for_serving). The decode loop runs on the host, one
    read of its predicate a pass (``generate_program`` gives its parts).
    ``fixed_steps`` is the form export.export_generate traces: greedy, all
    ``max_new_tokens`` steps with no read at all; its outputs are those of
    the early exit. ``mesh`` (parallel/mesh.py): the batch holds this
    rank's rows (parallel/partition.py ``shard_batch``) and the params its
    blocks (``shard_params``); the outputs are this rank's rows."""
    if fixed_steps and speculative:
        raise ValueError("fixed_steps is the greedy decode's traced form")
    loop, finish = generate_program(
        params, cfg, batch, max_new_tokens=max_new_tokens,
        speculative=speculative, draft_len=draft_len,
        lookup_ngram=lookup_ngram, max_accept=max_accept,
        force_accept=force_accept, device=device, encoder_path=encoder_path,
        mesh=mesh)
    mnt = max_new_tokens or cfg.max_new_tokens
    return finish(run_loop(loop, mnt if fixed_steps else None))


def generate_program(params: dict, cfg: AnyRefConfig, batch: dict,
                     max_new_tokens: Optional[int] = None,
                     speculative: bool = False, draft_len: int = 31,
                     lookup_ngram: int = 2,
                     max_accept: Optional[int] = None,
                     force_accept: bool = False, device="cuda",
                     encoder_path: str = "fused", mesh=None):
    """generate in the reference's program form (its generate under
    jax.jit, the loop a lax.while_loop): runs the prefix (the towers,
    prefill, the first token) and returns (DecodeLoop, finish), where
    ``finish(carry)`` runs the suffix (the [SEG] gather, rephrase pooling,
    text_hidden_fcs, SAM's prompt encoder and mask decoder) and returns the
    GenerateOutput. Prefix, loop body, loop predicate and suffix read
    nothing back from the device, so the whole program can be captured
    into one CUDA graph with the loop as a conditional node
    (eval/runner.py). Arguments as ``generate``'s; call it under
    ``torch.inference_mode``."""
    check_encoder_path(encoder_path)
    dev = resolve_device(device)
    # embed_tokens: a leaf of both the float and the int8 decoder tree
    p_dev = params["llama"]["embed_tokens"].device
    if p_dev.type != dev.type:
        raise ValueError(f"params live on {p_dev}, generate was asked to run "
                         f"on {dev}")
    group = None if mesh is None else mesh.group(MODEL_AXIS)
    if group is not None and (params["llama"]["embed_tokens"].shape[0]
                              * mesh.shape[MODEL_AXIS]
                              != cfg.llama.padded_vocab_size):
        raise ValueError("a mesh with a model axis takes the tree of "
                         "parallel.partition.shard_params")
    mnt = max_new_tokens or cfg.max_new_tokens
    tk = cfg.tokens
    input_ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    clip_images = torch.as_tensor(batch["clip_images"], device=dev)
    sam_images = torch.as_tensor(batch["sam_images"], device=dev)

    clip_feats = encode_clip_images(params, cfg, clip_images, encoder_path)
    embeds, exp_ids, _ = assemble_embeds(
        params, cfg, input_ids, clip_feats,
        *_encode_reference_feats(params, cfg, batch, dev, encoder_path),
        group=group)
    # left pad: pad keys are masked and rope positions shift so each row's
    # first real token is position 0
    pad_len = (input_ids != PAD_ID).to(torch.uint8).argmax(1)

    B, Lp, D = embeds.shape
    # speculative chunks write up to draft_len past the last accepted slot;
    # capacity rounded up to 16 as the reference rounds it
    cache_len = Lp + mnt + (draft_len + 1 if speculative else 0)
    cache_len = -(-cache_len // 16) * 16
    cache = llama.init_cache(cfg.llama, B, cache_len, dtype=embeds.dtype,
                             device=dev, kv_heads=llama.local_kv_heads(
                                 params["llama"], cfg.llama))
    # the final layer's input is carried only for rephrase pooling
    lastin = cfg.rephrase_weight > 0
    hidden, cache, *pf_lastin = llama.prefill(
        params["llama"], cfg.llama, embeds, cache, pad_len=pad_len,
        return_last_input=lastin, group=group)
    sam_embeddings = sam_mod.encode_image(params["sam"], sam_images, cfg.sam,
                                          encoder_path)
    first_tok = llama.logits(params["llama"], hidden[:, -1],
                             group).argmax(-1)

    if speculative:
        loop, decoded = _speculative_loop(
            params, cfg, exp_ids, pad_len, cache, first_tok, Lp, mnt,
            draft_len, lookup_ngram, embeds.dtype, max_accept=max_accept,
            force_accept=force_accept, lastin=lastin, group=group)
    else:
        loop, decoded = _greedy_loop(params, cfg, pad_len, cache, first_tok,
                                     Lp, mnt, embeds.dtype, lastin=lastin,
                                     group=group)

    def finish(carry) -> GenerateOutput:
        output_ids, gen_hidden, gen_lastin, decode_passes = decoded(carry)
        num_generated = (output_ids != EOS_ID).sum(1)
        # the hidden state that EMITS [SEG] at output k is gen_hidden[k-1],
        # or the last prefill state for k = 0
        S = cfg.max_seg_per_sample
        pos, seg_valid = _seg_slots(output_ids, tk.seg, S)
        all_hidden = torch.cat([hidden[:, -1:], gen_hidden], 1)
        seg_hidden = torch.gather(all_hidden, 1,
                                  pos[:, :, None].expand(-1, -1, D))
        if lastin:
            # the state emitting the first [SEG] at output k sits at cache
            # slot Lp + k - 1; all_hidden[j] at slot Lp - 1 + j, so the span
            # is all_hidden[0:k] (reference anyref.py:710-733)
            k_pos = pos[:, 0]
            q_slot = Lp + k_pos - 1
            all_lastin = torch.cat([pf_lastin[0][:, -1:], gen_lastin], 1)
            q_in = torch.gather(all_lastin, 1, k_pos[:, None, None].expand(
                -1, 1, D))[:, 0]
            row = _last_layer_attn_row(params, cfg, q_in, cache.k[-1],
                                       q_slot - pad_len, q_slot,
                                       kv_start=pad_len, group=group)
            span = torch.arange(mnt + 1, device=dev)[None, :] < k_pos[:, None]
            pooled = _span_pool(row[:, Lp - 1:Lp + mnt], all_hidden, span)
            seg_hidden = seg_hidden + (cfg.rephrase_weight
                                       * pooled[:, None]).to(seg_hidden.dtype)
        pred_emb = project_seg_hidden(params, seg_hidden)        # [B, S, out]
        img_index = torch.arange(B, device=dev)[:, None].expand(
            B, S).reshape(-1)
        low_res, _ = sam_mod.decode_text_prompts(
            params["sam"], cfg.sam, sam_embeddings,
            pred_emb.reshape(B * S, -1), img_index)
        g4 = 4 * cfg.sam.embedding_size
        return GenerateOutput(output_ids, num_generated,
                              low_res.reshape(B, S, g4, g4), seg_valid,
                              pred_emb, decode_passes)

    return loop, finish
