"""Serving runtime for text requests: request queue -> preprocess workers ->
micro-batcher -> device loop -> completion loop (port of
anyref_tpu/serve.py).

Requests accumulate and flush as a batch when ``max_batch`` are waiting or
``max_wait_ms`` elapses (``fill_wait_ms`` when more requests are already
inside the server), so decode's weight streaming is shared across the batch.
There is one batch bucket, max_batch: a short group rides the full-batch
shapes with padded rows. Host postprocess (crop, original-size resize,
binarize) runs on the completion thread, off the device loop.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .config import AnyRefConfig
from .data.base import SegDataset
from .data.collator import Collator
from .eval.runner import Predictor, binary_mask
from .tokenizer import EOS_ID, AnyRefTokenizer, seg_question


@dataclass
class Request:
    image: np.ndarray                       # [H, W, 3] uint8 RGB
    text: str
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
                 device="cuda", encoder_path: str = "fused"):
        self.cfg = cfg
        self.tok = tokenizer or AnyRefTokenizer()
        # bf16 mask fetch and one fetched [SEG] slot: serving answers carry
        # one [SEG]; fetch_segs=None fetches every slot
        self.predictor = Predictor(params, cfg, speculative=speculative,
                                   max_new_tokens=max_new_tokens,
                                   draft_len=draft_len,
                                   max_accept=max_accept,
                                   force_accept=force_accept,
                                   batch_buckets=(max_batch,),
                                   mask_fetch_dtype="bfloat16",
                                   fetch_segs=fetch_segs, device=device,
                                   encoder_path=encoder_path)
        self.collator = Collator(self.tok, cfg)
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
        self._helper = SegDataset(cfg, uint8_images=True)
        self._pre_q: "queue.Queue" = queue.Queue()
        self._run_q: "queue.Queue" = queue.Queue()
        self._fin_q: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        self._stop = threading.Event()
        # orders submit's stop-check-then-enqueue against shutdown's
        # stop-set-then-drain
        self._submit_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._preprocess_loop, daemon=True)
            for _ in range(preprocess_workers)
        ] + [threading.Thread(target=self._device_loop, daemon=True),
             threading.Thread(target=self._complete_loop, daemon=True)]
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
        for q in (self._pre_q, self._run_q, self._fin_q):
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

    def _preprocess_loop(self):
        while not self._stop.is_set():
            try:
                req = self._pre_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                sample = self._helper.make_sample(
                    req.image, seg_question(req.text), None, None)
                self._run_q.put((req, sample))
            except Exception as e:
                self._ungroup(1)
                self._finish(req, {"error": repr(e)})

    def _device_loop(self):
        while not self._stop.is_set():
            t0 = time.time()
            first = None
            while first is None and not self._stop.is_set():
                try:
                    first = self._run_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            if first is None:
                break
            t1 = time.time()
            group = [first]
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
                    group.append(self._run_q.get(
                        timeout=min(remaining, 0.05)))
                except queue.Empty:
                    continue
            t2 = time.time()
            self._ungroup(len(group))
            reqs, samples = zip(*group)
            self.stats["batches"] += 1
            self.stats["rows"] += len(group)
            self.stats["wait_ms"] += (t1 - t0) * 1e3
            self.stats["group_ms"] += (t2 - t1) * 1e3
            try:
                batch = self.collator(list(samples))
                t3 = time.time()
                self.stats["collate_ms"] += (t3 - t2) * 1e3
                handle = self.predictor.predict_async(batch)
                self.stats["dispatch_ms"] += (time.time() - t3) * 1e3
            except Exception as e:
                for req in reqs:
                    self._finish(req, {"error": repr(e)})
                continue
            item = (reqs, samples, handle)
            while not self._stop.is_set():
                try:
                    self._fin_q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:
                for req in reqs:
                    self._finish(req, {"error": "server shut down"})

    def _complete_loop(self):
        while not self._stop.is_set():
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
