"""Serving runtime: request queue -> preprocess workers -> micro-batcher ->
device loop -> completion loop (port of anyref_tpu/serve.py).

A request refers to its object by text, an image crop, an RoI box (pixel
xyxy) or audio (a 16 kHz waveform, turned into mel clips on the server's
device). A batch carries crops or boxes, never both (the model encodes one
kind a batch): the micro-batcher closes a group before the first request
whose kind conflicts with the group's, and that request opens the next
group, so arrival order is kept. Text and audio requests join either kind.
A batch with a box is collated in RoI mode, so the box reaches the model
(the reference's Server collates every batch without it and drops the box).

Requests accumulate and flush as a batch when ``max_batch`` are waiting or
``max_wait_ms`` elapses (``fill_wait_ms`` when more requests are already
inside the server), so decode's weight streaming is shared across the batch.
There is one batch bucket, max_batch: a short group rides the full-batch
shapes with padded rows. Host postprocess (crop, original-size resize,
binarize) runs on the completion thread, off the device loop.

Across ranks (a mesh of parallel/mesh.py, the tree of
parallel/partition.py ``shard_params``): rank 0 runs the Server (queue,
batcher, host postprocess) and every other rank runs ``follow``, the same
Predictor without a queue. Over the mesh's serve group (gloo, host
objects, a timeout of a year, so an idle Server loses no follower) the
leader sends its Predictor's arguments once, then each collated batch
before its own Predictor step, and a None when it stops; a follower builds
its Predictor from those arguments, runs the same step on each batch and
returns on the None. With several data ranks each batch's rows are also
gathered over the host group (eval/runner.py ``Predictor.fetch``): on the
leader by the completion thread, in ``complete``, on a follower by a
fetch thread of its own, both in dispatch order, so a rank's card runs
the next batch while the last is fetched. Only the leader's device loop
issues the other collectives on rank 0, so every rank issues each group's
collectives in one order; the leader fetches every batch that went out
before its completion thread stops. A step that fails on one rank leaves
the ranks' collectives out of step, so neither side goes on: the
exception ends ``follow`` (the rank's process exits with it, which fails
the leader's pending collective at once), and on the leader a step that
fails after its batch went out answers that batch with the error and
shuts the Server down, as a failed completion does where the batches are
gathered; the ranks are restarted together. Once the Server has stopped
and ``follow`` has returned, every rank closes the mesh
(parallel/mesh.py ``Mesh.close``) before it exits: a rank's card may read
the others' all-reduce exchange areas until its last batch ends.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch.distributed as dist

from .config import AnyRefConfig
from .data.base import SegDataset
from .data.collator import Collator
from .eval.runner import Predictor, binary_mask
from .ops.mel import audio_to_mel_clips
from .parallel.mesh import DATA_AXIS
from .tokenizer import (EOS_ID, AnyRefTokenizer, audio_ref_question,
                        img_ref_question, seg_question)


@dataclass
class Request:
    """One of text, ref_image ([h, w, 3] uint8 crop), roi_xyxy (pixel
    coordinates in ``image``) or audio_waveform (16 kHz mono); where
    several are set the first in this order is used."""
    image: np.ndarray                       # [H, W, 3] uint8 RGB
    text: Optional[str] = None
    ref_image: Optional[np.ndarray] = None
    roi_xyxy: Optional[np.ndarray] = None   # pixel coords
    audio_waveform: Optional[np.ndarray] = None
    # called once with the result dict, after result() can return it
    callback: Optional[Callable] = None
    _result: dict = field(default_factory=dict)
    _done: threading.Event = field(default_factory=threading.Event)

    def result(self, timeout: Optional[float] = None) -> dict:
        self._done.wait(timeout)
        return self._result


class Server:
    def __init__(self, params, cfg: AnyRefConfig,
                 tokenizer: Optional[AnyRefTokenizer] = None,
                 max_batch: int = 2, max_wait_ms: float = 5.0,
                 preprocess_workers: int = 8,
                 speculative: bool = True,
                 max_new_tokens: Optional[int] = None,
                 draft_len: Optional[int] = None,
                 max_accept: Optional[int] = None,
                 force_accept: bool = False,
                 fetch_segs: Optional[int] = 1,
                 fill_wait_ms: float = 500.0,
                 pipeline_depth: int = 3,
                 device="cuda", encoder_path: str = "fused", mesh=None):
        self.cfg = cfg
        self.tok = tokenizer or AnyRefTokenizer()
        # the Predictor's arguments, which the followers take from here
        predictor_kw = dict(
            max_batch=max_batch, speculative=speculative,
            max_new_tokens=max_new_tokens, draft_len=draft_len,
            max_accept=max_accept, force_accept=force_accept,
            fetch_segs=fetch_segs, encoder_path=encoder_path)
        self.predictor = serving_predictor(params, cfg, device=device,
                                           mesh=mesh, **predictor_kw)
        mesh = self.predictor.mesh
        # the group over which the batches go to the followers
        self._followers = None
        # whether the followers fetch each batch with the leader (several
        # data ranks): then every batch that went out must be fetched
        self._gathered = mesh is not None and mesh.shape[DATA_AXIS] > 1
        if mesh is not None and mesh.size > 1:
            if mesh.rank != 0:
                raise ValueError(f"rank {mesh.rank} runs serve.follow; the "
                                 "Server runs on rank 0")
            self._followers = mesh.serve_group
            dist.broadcast_object_list([predictor_kw], src=0,
                                       group=self._followers)
        self.collator = Collator(self.tok, cfg)
        self._roi_collator = Collator(self.tok, cfg, roi=True)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.fill_wait = fill_wait_ms / 1000.0
        # submitted but not yet grouped: lets the batcher tell "no partner
        # coming" from "partner still in preprocess"
        self._pending = 0
        self._pending_lock = threading.Lock()
        # per-stage wall time sums (ms), written by the device and
        # completion threads: wait (device loop idle), group (micro-batch
        # window), collate, dispatch (upload + device program), fetch
        # (device->host readback), post (host mask postprocess + decode)
        self.stats = {"batches": 0, "rows": 0, "wait_ms": 0.0,
                      "group_ms": 0.0, "collate_ms": 0.0, "dispatch_ms": 0.0,
                      "fetch_ms": 0.0, "post_ms": 0.0}
        # reset_stats() epoch: the device loop may be mid-idle-wait when the
        # counters are zeroed, so wait spans clamp to max(t0, epoch)
        self._stats_epoch = 0.0
        self._helper = SegDataset(cfg, uint8_images=True)
        self._pre_q: "queue.Queue" = queue.Queue()
        self._run_q: "queue.Queue" = queue.Queue()
        self._fin_q: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        self._stop = threading.Event()
        # orders submit's stop-check-then-enqueue against shutdown's
        # stop-set-then-drain
        self._submit_lock = threading.Lock()
        self._device_thread = threading.Thread(target=self._device_loop,
                                               daemon=True)
        self._complete_thread = threading.Thread(target=self._complete_loop,
                                                 daemon=True)
        self._threads = [
            threading.Thread(target=self._preprocess_loop, daemon=True)
            for _ in range(preprocess_workers)
        ] + [self._device_thread, self._complete_thread]
        for t in self._threads:
            t.start()

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> Request:
        with self._submit_lock:
            if self._stop.is_set():
                self._finish(req, {"error": "server shut down"})
                return req
            with self._pending_lock:
                self._pending += 1
            self._pre_q.put(req)
        return req

    def segment(self, image, text: str) -> dict:
        return self.submit(Request(image=image, text=text)).result()

    def reset_stats(self) -> None:
        """Zero the per-stage counters and the Predictor's pass and byte
        counters (e.g. after a warm-up batch)."""
        for k in self.stats:
            self.stats[k] = 0 if k in ("batches", "rows") else 0.0
        self._stats_epoch = time.time()
        p = self.predictor
        p.decode_passes_total = p.completed_batches = 0
        p.h2d_bytes_total = p.d2h_bytes_total = 0

    def shutdown(self, timeout: float = 30.0):
        """Stop the loops and fail any request still pending, so no caller
        blocks forever in Request.result(). Drains until every worker has
        exited (a worker mid-preprocess can still enqueue), bounded by
        ``timeout``."""
        with self._submit_lock:
            self._stop.set()
        deadline = time.time() + timeout
        while time.time() < deadline:
            for t in self._threads:
                t.join(timeout=1.0)
            self._drain()
            if not any(t.is_alive() for t in self._threads):
                break
        self._drain()

    # -- internals -----------------------------------------------------------
    def _ungroup(self, n: int) -> None:
        with self._pending_lock:
            self._pending -= n

    def _upstream(self) -> int:
        with self._pending_lock:
            return self._pending

    def _drain(self) -> None:
        queues = [self._pre_q, self._run_q]
        if not (self._gathered and self._complete_thread.is_alive()):
            # a gathering Server's completion thread fetches what went out
            queues.append(self._fin_q)
        for q in queues:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                head = item[0] if isinstance(item, tuple) else item
                # _pre_q holds Requests, _run_q (req, sample), _fin_q
                # (reqs, samples, handle)
                reqs = head if isinstance(head, (tuple, list)) else [head]
                if q is not self._fin_q:   # _fin_q items are ungrouped
                    self._ungroup(len(reqs))
                for req in reqs:
                    self._finish(req, {"error": "server shut down"})

    @staticmethod
    def _finish(req: Request, result: dict) -> None:
        # idempotent: a group-level error must not overwrite rows already
        # answered
        if req._done.is_set():
            return
        req._result = result
        req._done.set()
        if req.callback is not None:
            try:
                req.callback(result)
            except Exception:
                logging.getLogger(__name__).exception(
                    "request callback raised")

    def _build_sample(self, req: Request) -> dict:
        kw = {}
        if req.text is not None:
            q = seg_question(req.text)
        elif req.ref_image is not None:
            q = img_ref_question()
            kw["ref_image"] = req.ref_image
        elif req.roi_xyxy is not None:
            q = img_ref_question()
            h, w = req.image.shape[:2]
            kw["ref_bbox"] = (np.asarray(req.roi_xyxy, np.float32)
                              / np.asarray([w, h, w, h], np.float32))
        elif req.audio_waveform is not None:
            a = self.cfg.audio
            if a is None:
                raise ValueError("an audio request needs a configuration "
                                 "with an audio tower")
            q = audio_ref_question()
            kw["audio_mels"] = audio_to_mel_clips(
                req.audio_waveform, a.sample_rate, a.mel_bins, a.target_len,
                a.clip_duration, a.clips_per_audio, a.mel_mean, a.mel_std,
                device=self.predictor.device).cpu().numpy()
        else:
            raise ValueError("request needs text/ref_image/roi/audio")
        return self._helper.make_sample(req.image, q, None, None, **kw)

    @staticmethod
    def _ref_kind(sample: dict) -> Optional[str]:
        """"crop", "roi" or None (text, audio): the reference kind a batch
        may hold only one of."""
        if "ref_image" in sample:
            return "crop"
        return "roi" if "ref_bbox" in sample else None

    def _preprocess_loop(self):
        while not self._stop.is_set():
            try:
                req = self._pre_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                sample = self._build_sample(req)
                self._run_q.put((req, sample))
            except Exception as e:
                self._ungroup(1)
                self._finish(req, {"error": repr(e)})

    def _device_loop(self):
        carry = None     # a request whose reference kind closed the group
        while not self._stop.is_set():
            t0 = time.time()
            first, carry = carry, None
            while first is None and not self._stop.is_set():
                try:
                    first = self._run_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            if first is None or self._stop.is_set():
                carry = first
                break
            t1 = time.time()
            group = [first]
            kind = self._ref_kind(first[1])
            # max_wait when no partner is coming, fill_wait when more
            # requests are known to be upstream
            hard_deadline = t1 + self.fill_wait
            while len(group) < self.max_batch:
                more_coming = self._upstream() > len(group)
                deadline = hard_deadline if more_coming else \
                    min(t1 + self.max_wait, hard_deadline)
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    item = self._run_q.get(timeout=min(remaining, 0.05))
                except queue.Empty:
                    continue
                k = self._ref_kind(item[1])
                if k is not None and kind is not None and k != kind:
                    carry = item   # opens the next group
                    break
                kind = kind or k
                group.append(item)
            t2 = time.time()
            self._ungroup(len(group))
            reqs, samples = zip(*group)
            self.stats["batches"] += 1
            self.stats["rows"] += len(group)
            self.stats["wait_ms"] += (t1 - max(t0, self._stats_epoch)) * 1e3
            self.stats["group_ms"] += (t2 - t1) * 1e3
            collator = self._roi_collator if kind == "roi" else \
                self.collator
            try:
                batch = collator(list(samples))
            except Exception as e:
                for req in reqs:
                    self._finish(req, {"error": repr(e)})
                continue
            t3 = time.time()
            self.stats["collate_ms"] += (t3 - t2) * 1e3
            try:
                if self._followers is not None:
                    dist.broadcast_object_list([batch], src=0,
                                               group=self._followers)
                handle = self.predictor.predict_async(batch)
                self.stats["dispatch_ms"] += (time.time() - t3) * 1e3
            except Exception as e:
                for req in reqs:
                    self._finish(req, {"error": repr(e)})
                if self._followers is None:
                    continue
                # the ranks' collectives may be out of step: stop serving,
                # and send the followers no None
                logging.getLogger(__name__).exception(
                    "step failed across ranks; shutting the Server down")
                self._followers = None
                threading.Thread(target=self.shutdown, daemon=True).start()
                break
            item = (reqs, samples, handle)
            # a batch the followers fetch is fetched here too, stopping or
            # not
            while self._gathered or not self._stop.is_set():
                try:
                    self._fin_q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:
                for req in reqs:
                    self._finish(req, {"error": "server shut down"})
        if carry is not None:   # taken from the queue, never grouped
            self._ungroup(1)
            self._finish(carry[0], {"error": "server shut down"})
        if self._followers is not None:
            dist.broadcast_object_list([None], src=0, group=self._followers)

    def _complete_loop(self):
        # a gathering Server fetches every batch that went out, until its
        # device loop has ended
        while not self._stop.is_set() or (
                self._gathered and (self._device_thread.is_alive()
                                    or not self._fin_q.empty())):
            try:
                reqs, samples, handle = self._fin_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.time()
                output_ids, masks = self.predictor.complete(handle)
                self.stats["fetch_ms"] += (time.time() - t0) * 1e3
                t0 = time.time()
                for i, req in enumerate(reqs):
                    h, w = samples[i]["height"], samples[i]["width"]
                    text = self.tok.decode(
                        [t for t in output_ids[i].tolist() if t != EOS_ID],
                        skip_special=True)
                    self._finish(req, {
                        "text": text,
                        "output_ids": output_ids[i],
                        "mask": binary_mask(masks[i], h, w),
                        "mask_logits": masks[i],
                    })
                self.stats["post_ms"] += (time.time() - t0) * 1e3
            except Exception as e:
                for req in reqs:
                    self._finish(req, {"error": repr(e)})
                if self._gathered and self._followers is not None:
                    # the ranks' gathers may be out of step: stop serving
                    logging.getLogger(__name__).exception(
                        "a batch's completion failed across ranks; "
                        "shutting the Server down")
                    self._gathered = False
                    threading.Thread(target=self.shutdown,
                                     daemon=True).start()


def serving_predictor(params, cfg: AnyRefConfig, max_batch: int = 2,
                      speculative: bool = True,
                      max_new_tokens: Optional[int] = None,
                      draft_len: Optional[int] = None,
                      max_accept: Optional[int] = None,
                      force_accept: bool = False,
                      fetch_segs: Optional[int] = 1, device="cuda",
                      encoder_path: str = "fused", mesh=None) -> Predictor:
    """The Server's Predictor: one batch bucket, max_batch; bf16 mask fetch
    and one fetched [SEG] slot (serving answers carry one [SEG];
    fetch_segs=None fetches every slot)."""
    return Predictor(params, cfg, speculative=speculative,
                     max_new_tokens=max_new_tokens, draft_len=draft_len,
                     max_accept=max_accept, force_accept=force_accept,
                     batch_buckets=(max_batch,), mask_fetch_dtype="bfloat16",
                     fetch_segs=fetch_segs, device=device,
                     encoder_path=encoder_path, mesh=mesh)


def follow(params, cfg: AnyRefConfig, mesh=None) -> int:
    """A follower rank's serving loop: the Predictor that the rank-0 Server
    sends the arguments of, and its step on each batch the Server
    broadcasts, until the Server stops. ``mesh`` as Predictor's (the
    argument, or the sharded tree's); the device is the mesh's. An
    exception of a step ends the loop. Returns the number of batches
    run."""
    mesh = mesh if mesh is not None else getattr(params, "mesh", None)
    if mesh is None or mesh.size == 1 or mesh.rank == 0:
        raise ValueError("follow runs on a rank other than 0 of a mesh of "
                         "several ranks")
    box = [None]
    dist.broadcast_object_list(box, src=0, group=mesh.serve_group)
    predictor = serving_predictor(params, cfg, mesh=mesh, **box[0])
    fetcher = _Fetcher(predictor) if mesh.shape[DATA_AXIS] > 1 else None
    n = 0
    try:
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=mesh.serve_group)
            if box[0] is None:
                return n
            handle = predictor.predict_async(box[0])
            n += 1
            if fetcher is not None:
                fetcher.put(handle)
    finally:
        if fetcher is not None:
            fetcher.close()


class _Fetcher:
    """A follower's part of each batch's gather (Predictor.fetch), on a
    thread of its own, in dispatch order, as the leader's completion
    thread fetches: the follower's card runs the next batch meanwhile.
    ``close`` fetches what was put, then raises the first error."""

    def __init__(self, predictor: Predictor):
        self.predictor = predictor
        self.queue: "queue.Queue" = queue.Queue()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def put(self, handle) -> None:
        if self.error is not None:
            raise self.error
        self.queue.put(handle)

    def _run(self) -> None:
        while True:
            handle = self.queue.get()
            if handle is None or self.error is not None:
                return
            try:
                self.predictor.fetch(handle)
            except BaseException as e:
                self.error = e

    def close(self) -> None:
        self.queue.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error
