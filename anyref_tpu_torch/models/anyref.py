"""AnyRef model core, text references (port of anyref_tpu/models/anyref.py
generate, train_forward and what they call).

A LLaVA-style LLaMA emits [SEG] tokens; their post-norm hidden states project
(text_hidden_fcs) into SAM's prompt space and SAM's mask decoder turns them
into masks. Prompts arrive left-padded; the decode loop runs on the host
with early exit (greedy) or as batched prompt-lookup speculative decoding
whose output equals the greedy stream. ``train_forward`` is the training
forward: LM loss plus mask BCE and DICE on the SAM canvas, with the frozen
towers under ``torch.no_grad``, and with ``cfg.use_loc_tokens`` the loc
tokens of a batch that carries ``loc_boxes``. With ``cfg.rephrase_weight``
> 0 both add the reference's rephrase pooling to each [SEG] state: the
answer's states before the first [SEG], weighted by the final decoder
layer's head-mean attention row of the state that emitted it. Reference-image,
RoI and audio prompts raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import (IGNORE_INDEX, NUM_IMAGE_TOKENS, AnyRefConfig,
                      check_encoder_path)
from ..ops.common import linear, rms_norm
from ..ops.losses import dice_loss, lm_cross_entropy, sigmoid_ce_loss
from ..params import resolve_device
from ..tokenizer import EOS_ID, PAD_ID
from . import clip_vit, llama
from . import sam as sam_mod


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


def assemble_embeds(params: dict, cfg: AnyRefConfig, input_ids, clip_feats,
                    labels=None):
    """input_ids [B, T] with one <image> token per row -> (embeds
    [B, T+255, D] with the CLIP features spliced in, expanded ids, expanded
    labels (IGNORE_INDEX over the image) or None)."""
    tk = cfg.tokens
    T = input_ids.shape[1]
    L = T + NUM_IMAGE_TOKENS - 1
    img_pos = (input_ids == tk.image).to(torch.uint8).argmax(1)
    exp_ids = _expand_image(input_ids, img_pos, tk.image, L)
    embeds = llama.embed(params["llama"], exp_ids)
    j = torch.arange(L, device=input_ids.device)[None, :]
    p = img_pos[:, None]
    in_img = (j >= p) & (j < p + NUM_IMAGE_TOKENS)
    img_idx = (j - p).clamp(0, NUM_IMAGE_TOKENS - 1)
    D = clip_feats.shape[-1]
    img = torch.gather(clip_feats, 1, img_idx[:, :, None].expand(-1, -1, D))
    embeds = torch.where(in_img[:, :, None], img.to(embeds.dtype), embeds)
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


def _prompt_lookup_draft(seq, cur_len: int, ngram: int, draft_len: int):
    """Per row of seq [B, LT]: draft the next ``draft_len`` tokens by
    copying what followed the latest earlier occurrence of the current
    ``ngram``-suffix, with periodic wrap inside the known region (falls back
    to repeating the last token)."""
    B, LT = seq.shape
    dev = seq.device
    gram = seq[:, cur_len - ngram:cur_len]
    idx = torch.arange(LT, device=dev)
    eq = torch.ones((B, LT), dtype=torch.bool, device=dev)
    for t in range(ngram):
        eq &= seq[:, (idx + t).clamp(0, LT - 1)] == gram[:, t:t + 1]
    valid = idx + ngram <= cur_len - 1
    score = torch.where(eq & valid, idx, -1)
    j = score.max(1).values
    start = torch.where(j >= 0, j + ngram, torch.full_like(j, cur_len - 1))
    period = (cur_len - start).clamp_min(1)
    offs = torch.arange(draft_len, device=dev)[None, :] % period[:, None]
    return torch.gather(seq, 1, (start[:, None] + offs).clamp(0, LT - 1))


def _speculative_decode(params, cfg, exp_ids, pad_len, cache, first_tok,
                        Lp: int, mnt: int, G: int, ngram: int, dtype,
                        max_accept: Optional[int] = None,
                        force_accept: bool = False, lastin: bool = False):
    """Batched prompt-lookup speculative decode, lockstep-min acceptance:
    each pass verifies the pending token plus G per-row drafts in one chunk;
    all rows advance by the minimum accepted length over unfinished rows.
    ``max_accept`` caps tokens accepted per pass; ``force_accept``
    (benchmark only) accepts exactly max_accept drafts regardless of
    verification. Returns (ids [B, mnt], hidden [B, mnt, D], the final
    layer's input of each position [B, mnt, D] or None without ``lastin``,
    passes)."""
    eos = EOS_ID
    B = exp_ids.shape[0]
    dev = exp_ids.device
    D = params["llama"]["final_norm"]["scale"].shape[0]
    ext = mnt + G + 1
    toks = torch.full((B, ext), eos, dtype=torch.long, device=dev)
    hids = torch.zeros((B, ext, D), dtype=dtype, device=dev)
    lins = torch.zeros((B, ext, D), dtype=dtype, device=dev) if lastin \
        else None
    all_ids = torch.cat([exp_ids, torch.full((B, ext), eos, dtype=torch.long,
                                             device=dev)], 1)
    arange_g = torch.arange(G + 1, device=dev)
    ones = torch.ones((B, 1), dtype=torch.long, device=dev)
    i, n_pass = 0, 0
    tok = first_tok
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while i < mnt and not bool(done.all()):
        all_ids[:, Lp + i] = tok
        draft = _prompt_lookup_draft(all_ids, Lp + i + 1, ngram, G)
        feed = torch.cat([tok[:, None], draft], 1)
        feed = torch.where(done[:, None], eos, feed)
        emb = llama.embed(params["llama"], feed, dtype=dtype)
        h, cache, *lin = llama.decode_chunk(params["llama"], cfg.llama, emb,
                                            Lp + i, cache, pad_len=pad_len,
                                            return_last_input=lastin)
        nxt = llama.logits(params["llama"], h).argmax(-1)       # [B, G+1]

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
        n_emit = int(torch.where(done, G + 1, n_emit_row).min())
        n_emit = max(n_emit, 1)
        # EOS only counts as emitted inside the accepted prefix
        ok_eff = ok * (arange_g[None] < n_emit).long()
        done_next = done | ((feed == eos) & (ok_eff == 1)).any(1)

        toks[:, i:i + G + 1] = feed
        hids[:, i:i + G + 1] = h
        if lastin:
            lins[:, i:i + G + 1] = lin[0]
        all_ids[:, Lp + i:Lp + i + G + 1] = feed
        next_tok = nxt[:, min(max(n_emit - 1, 0), G)]
        tok = torch.where(done_next, eos, next_tok)
        done = done_next
        i += n_emit
        n_pass += 1
    live = torch.arange(ext, device=dev)[None, :] < i
    toks = torch.where(live, toks, eos)
    hids = torch.where(live[:, :, None], hids, 0)
    return (toks[:, :mnt], hids[:, :mnt],
            lins[:, :mnt] if lastin else None, n_pass)


def _greedy_decode(params, cfg, pad_len, cache, first_tok, Lp: int, mnt: int,
                   dtype, lastin: bool = False):
    """Greedy decode with early exit once every row has emitted EOS.
    Returns (ids [B, mnt], hidden [B, mnt, D], final-layer inputs
    [B, mnt, D] or None, steps)."""
    eos = EOS_ID
    B = first_tok.shape[0]
    dev = first_tok.device
    D = params["llama"]["final_norm"]["scale"].shape[0]
    toks = torch.full((B, mnt), eos, dtype=torch.long, device=dev)
    hids = torch.zeros((B, mnt, D), dtype=dtype, device=dev)
    lins = torch.zeros((B, mnt, D), dtype=dtype, device=dev) if lastin \
        else None
    tok = first_tok
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    i = 0
    while i < mnt and not bool(done.all()):
        emb = llama.embed(params["llama"], tok[:, None], dtype=dtype)
        h, cache, *lin = llama.decode_step(params["llama"], cfg.llama, emb,
                                           Lp + i, cache, pad_len=pad_len,
                                           return_last_input=lastin)
        nxt = llama.logits(params["llama"], h[:, 0]).argmax(-1)
        done_next = done | (tok == eos)
        toks[:, i] = torch.where(done, eos, tok)
        hids[:, i] = h[:, 0]
        if lastin:
            lins[:, i] = lin[0][:, 0]
        tok = torch.where(done_next, eos, nxt)
        done = done_next
        i += 1
    return toks, hids, lins, i


class TrainOutput(NamedTuple):
    loss: torch.Tensor
    lm_loss: torch.Tensor
    bce_loss: torch.Tensor
    dice_loss: torch.Tensor
    pred_masks: torch.Tensor      # [B, S, image_size, image_size] logits
    seg_valid: torch.Tensor       # [B, S]


def _check_text_only(batch: dict) -> None:
    for key in ("ref_images", "roi_boxes", "audio_mels"):
        if key in batch:
            raise NotImplementedError(
                f"{key}: the port takes text references only; image-crop, "
                "RoI and audio references are not ported")


def _last_layer_attn_row(params: dict, cfg: AnyRefConfig, q_in, k_roped,
                         q_pos, q_slot, kv_start=None):
    """The final decoder layer's attention probabilities for one query row
    per sample, softmax per head over the full causal row in fp32, then the
    mean over heads (reference anyref.py:376-381, :745-748). Recomputed from
    that layer's residual input instead of carried out of the attention.

    q_in [B, D]: the residual entering the final layer at the query;
    k_roped [B, kv_heads, T, hd]: that layer's roped keys (the KV cache, read
    in place, or recomputed); q_pos [B]: the query's rope position; q_slot
    [B]: its key slot (causal bound); kv_start [B]: the first unmasked key
    (left pad). Returns [B, T] fp32."""
    lcfg = cfg.llama
    nh, kvh, hd = lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim
    p = params["llama"]["layers"][-1]
    h = rms_norm(p["input_norm"], q_in[:, None, :], eps=lcfg.rms_norm_eps)
    q = linear(p["attn"]["q"], h)                            # [B, 1, nh*hd]
    B = q.shape[0]
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
    return torch.softmax(logits, -1).mean(1)


def _span_pool(row, hidden, span):
    """``row`` renormalised over ``span``, pooling ``hidden`` [B, L, D] in
    fp32 (reference anyref.py:380-384); an empty span contributes 0."""
    w = row * span.float()
    denom = w.sum(1, keepdim=True)
    w = torch.where(denom > 0, w / denom.clamp_min(1e-20), 0.0)
    return torch.einsum("bl,bld->bd", w, hidden.float())


def _rephrase_pool(params: dict, cfg: AnyRefConfig, hidden, last_in,
                   exp_labels, seg_pos):
    """Training-path rephrase pooling (reference anyref.py:372-392): query =
    the state emitting the first [SEG] (seg_pos - 1), span = [first label
    - 1, seg_pos - 1), weights = the final layer's head-mean softmax row,
    renormalised over the span; the keys recomputed from ``last_in``.
    Returns [B, 1, D] in hidden's dtype."""
    B, L, _ = hidden.shape
    lcfg = cfg.llama
    p = params["llama"]["layers"][-1]
    hn = rms_norm(p["input_norm"], last_in, eps=lcfg.rms_norm_eps)
    k = linear(p["attn"]["k"], hn).reshape(
        B, L, lcfg.num_kv_heads, lcfg.head_dim).transpose(1, 2)
    k = llama._rope(k, llama._rope_tables(
        torch.arange(L, device=hidden.device), lcfg.head_dim,
        lcfg.rope_theta))
    ans_start = (exp_labels > 0).to(torch.uint8).argmax(1) - 1
    q_pos = (seg_pos[:, 0] - 1).clamp_min(0)
    q_in = last_in[torch.arange(B, device=hidden.device), q_pos]
    row = _last_layer_attn_row(params, cfg, q_in, k, q_pos, q_pos)
    j = torch.arange(L, device=hidden.device)[None, :]
    span = (j >= ans_start[:, None]) & (j < q_pos[:, None])
    return _span_pool(row, hidden, span)[:, None, :].to(hidden.dtype)


def train_forward(params: dict, cfg: AnyRefConfig, batch: dict,
                  encoder_path: str = "fused",
                  remat: bool = False) -> TrainOutput:
    """One training forward, on the device the params live on.

    batch (arrays or tensors): input_ids [B, T], labels [B, T],
    clip_images [B, 3, 224, 224], sam_images [B, 3, S, S], gt_masks
    [B, S_seg, S, S] on the SAM canvas, mask_valid [B, S_seg],
    sam_resized_sizes [B, 2]; optional loc_boxes [B, S_seg, 4] indices of
    ``params["loc_embeddings"]``, used with ``cfg.use_loc_tokens``. CLIP,
    mm_projector and the SAM image encoder run under ``torch.no_grad``
    (frozen towers; the reference's stop_gradient). ``remat`` checkpoints
    each decoder layer."""
    check_encoder_path(encoder_path)
    _check_text_only(batch)
    tk = cfg.tokens
    dev = params["llama"]["embed_tokens"].device

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
    embeds, exp_ids, exp_labels = assemble_embeds(params, cfg, input_ids,
                                                  clip_feats, labels)
    hidden, last_in = llama.forward(params["llama"], cfg.llama, embeds,
                                    return_last_input=True, remat=remat)
    lm_loss = lm_cross_entropy(llama.logits(params["llama"], hidden),
                               exp_labels, IGNORE_INDEX)

    seg_pos, seg_valid = _seg_slots(exp_ids, tk.seg, cfg.max_seg_per_sample)
    B, S = seg_pos.shape
    D = hidden.shape[-1]
    hid_idx = (seg_pos - 1).clamp(0, hidden.shape[1] - 1)
    seg_hidden = torch.gather(hidden, 1, hid_idx[:, :, None].expand(-1, -1, D))
    if cfg.rephrase_weight > 0:
        seg_hidden = seg_hidden + cfg.rephrase_weight * _rephrase_pool(
            params, cfg, hidden, last_in, exp_labels, seg_pos)
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
    bce = sigmoid_ce_loss(flat_pred, flat_gt, flat_valid, pixel_mask)
    dce = dice_loss(flat_pred, flat_gt, flat_valid, pixel_mask)
    loss = (cfg.ce_loss_weight * lm_loss + cfg.bce_loss_weight * bce
            + cfg.dice_loss_weight * dce)
    return TrainOutput(loss, lm_loss, bce, dce, canvas, valid)


class GenerateOutput(NamedTuple):
    output_ids: torch.Tensor      # [B, max_new_tokens]
    num_generated: torch.Tensor   # [B]
    low_res_masks: torch.Tensor   # [B, S, 4g, 4g] logits (SAM low-res grid)
    seg_valid: torch.Tensor       # [B, S]
    seg_embeddings: torch.Tensor  # [B, S, out_dim]
    decode_passes: int            # decode weight streams (tokens/pass =
                                  # num_generated / decode_passes)


@torch.inference_mode()
def generate(params: dict, cfg: AnyRefConfig, batch: dict,
             max_new_tokens: Optional[int] = None,
             speculative: bool = False, draft_len: int = 31,
             lookup_ngram: int = 2, max_accept: Optional[int] = None,
             force_accept: bool = False, device="cuda",
             encoder_path: str = "fused") -> GenerateOutput:
    """Greedy (or speculative) decode + SAM mask synthesis.

    batch: input_ids [B, T] (prompt only, LEFT-padded, one <image> per
    row), clip_images [B, 3, 224, 224] and sam_images [B, 3, S, S]
    normalized; arrays or tensors, moved to ``device``. The params must
    already live on ``device``. ``encoder_path`` selects the towers' path
    (config.ENCODER_PATHS). An int8 decoder tree (ops.quant.quantize_llama)
    runs greedy and speculative decode alike."""
    check_encoder_path(encoder_path)
    dev = resolve_device(device)
    # embed_tokens: a leaf of both the float and the int8 decoder tree
    p_dev = params["llama"]["embed_tokens"].device
    if p_dev.type != dev.type:
        raise ValueError(f"params live on {p_dev}, generate was asked to run "
                         f"on {dev}")
    _check_text_only(batch)
    mnt = max_new_tokens or cfg.max_new_tokens
    tk = cfg.tokens
    input_ids = torch.as_tensor(batch["input_ids"], device=dev).long()
    clip_images = torch.as_tensor(batch["clip_images"], device=dev)
    sam_images = torch.as_tensor(batch["sam_images"], device=dev)

    clip_feats = encode_clip_images(params, cfg, clip_images, encoder_path)
    embeds, exp_ids, _ = assemble_embeds(params, cfg, input_ids, clip_feats)
    # left pad: pad keys are masked and rope positions shift so each row's
    # first real token is position 0
    pad_len = (input_ids != PAD_ID).to(torch.uint8).argmax(1)

    B, Lp, D = embeds.shape
    # speculative chunks write up to draft_len past the last accepted slot;
    # capacity rounded up to 16 as the reference rounds it
    cache_len = Lp + mnt + (draft_len + 1 if speculative else 0)
    cache_len = -(-cache_len // 16) * 16
    cache = llama.init_cache(cfg.llama, B, cache_len, dtype=embeds.dtype,
                             device=dev)
    # the final layer's input is carried only for rephrase pooling
    lastin = cfg.rephrase_weight > 0
    hidden, cache, *pf_lastin = llama.prefill(
        params["llama"], cfg.llama, embeds, cache, pad_len=pad_len,
        return_last_input=lastin)
    sam_embeddings = sam_mod.encode_image(params["sam"], sam_images, cfg.sam,
                                          encoder_path)
    first_tok = llama.logits(params["llama"], hidden[:, -1]).argmax(-1)

    if speculative:
        output_ids, gen_hidden, gen_lastin, decode_passes = \
            _speculative_decode(params, cfg, exp_ids, pad_len, cache,
                                first_tok, Lp, mnt, draft_len, lookup_ngram,
                                embeds.dtype, max_accept=max_accept,
                                force_accept=force_accept, lastin=lastin)
    else:
        output_ids, gen_hidden, gen_lastin, decode_passes = _greedy_decode(
            params, cfg, pad_len, cache, first_tok, Lp, mnt, embeds.dtype,
            lastin=lastin)
    num_generated = (output_ids != EOS_ID).sum(1)

    # the hidden state that EMITS [SEG] at output k is gen_hidden[k-1], or
    # the last prefill state for k = 0
    S = cfg.max_seg_per_sample
    pos, seg_valid = _seg_slots(output_ids, tk.seg, S)
    all_hidden = torch.cat([hidden[:, -1:], gen_hidden], 1)
    seg_hidden = torch.gather(all_hidden, 1, pos[:, :, None].expand(-1, -1, D))
    if lastin:
        # the state emitting the first [SEG] at output k sits at cache slot
        # Lp + k - 1; all_hidden[j] at slot Lp - 1 + j, so the span is
        # all_hidden[0:k] (reference anyref.py:710-733)
        k_pos = pos[:, 0]
        q_slot = Lp + k_pos - 1
        all_lastin = torch.cat([pf_lastin[0][:, -1:], gen_lastin], 1)
        q_in = all_lastin[torch.arange(B, device=dev), k_pos]
        row = _last_layer_attn_row(params, cfg, q_in, cache.k[-1],
                                   q_slot - pad_len, q_slot, kv_start=pad_len)
        span = torch.arange(mnt + 1, device=dev)[None, :] < k_pos[:, None]
        pooled = _span_pool(row[:, Lp - 1:Lp + mnt], all_hidden, span)
        seg_hidden = seg_hidden + (cfg.rephrase_weight
                                   * pooled[:, None]).to(seg_hidden.dtype)
    pred_emb = project_seg_hidden(params, seg_hidden)            # [B, S, out]
    img_index = torch.arange(B, device=dev)[:, None].expand(B, S).reshape(-1)
    low_res, _ = sam_mod.decode_text_prompts(
        params["sam"], cfg.sam, sam_embeddings, pred_emb.reshape(B * S, -1),
        img_index)
    g4 = 4 * cfg.sam.embedding_size
    return GenerateOutput(output_ids, num_generated,
                          low_res.reshape(B, S, g4, g4), seg_valid, pred_emb,
                          decode_passes)
