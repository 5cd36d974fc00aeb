"""Online embedding and caption server with dynamic batching.

Counterpart of ``openvision_tpu/serving/server.py``. Concurrent requests
enqueue into a :class:`DynamicBatcher`; its dispatcher thread drains up to
``max_batch`` items or waits ``max_wait_ms`` after the first arrival, pads
the batch to the next power-of-two bucket (capped at ``max_batch``) and runs
it on the card. Host work (PNG/JPEG decode, resize, normalize, tokenize)
happens in the HTTP worker threads. Each dispatcher thread enqueues on a CUDA
stream of its own: ``dispatch`` copies the batch from pinned host memory
with ``non_blocking=True`` and enqueues the kernels without waiting, and only
``finalize``, which copies the result to the host, waits, so batch N+1 is
assembled and enqueued while batch N computes (``pipeline_depth`` 2). The
encode path is ``serving.encode.build_encode_fn``: bf16 on the ``fused_t``
kernels by default on CUDA, ``--int8`` for the W8A8 kernels.

Where the JAX package's daemon is wrong, this one is not (its faults stay
in place there):
- the 503 of ``/v1/caption`` (no caption model) reads the request body
  first, so a keep-alive connection serves its next request (JAX l.609);
- ``warmup`` runs every bucket the batcher can form, the capped one
  included: JAX doubles past a ``max_batch`` that is not a power of two
  (48 -> 64) and never runs 48 (l.414-429, l.503-510);
- ``stop`` fails every queued future, a ``submit`` racing with ``stop``
  raises instead of queueing work nobody will run, and the caption service
  stops with the daemon.
``--data_parallel`` (batch-parallel serving over several GPUs) raises: it
waits for the multi-GPU slice. The caption route reads the port's flat npz
train state; ``--caption_step`` (an Orbax step) raises.

HTTP API (JSON unless noted), as the JAX daemon's:
  GET  /healthz, GET /stats
  POST /v1/embed/image   raw image bytes (Content-Type image/*) or
                         {"b64": "..."} / {"b64": [...]}
  POST /v1/embed/tensor  raw (N, S, S, 3) rows; X-Tensor-Shape "N,S,S,3",
                         X-Tensor-Dtype uint8 (normalized on the device) or
                         float32 (already normalized); Accept:
                         application/octet-stream for raw f32 replies
  POST /v1/embed/text    {"text": "..."} or {"texts": [...]}
  POST /v1/rank          {"texts": [...], "b64": "..."} -> zero-shot softmax
  POST /v1/caption       image payloads as /v1/embed/image -> {"captions"}

Usage:
  python -m openvision_tpu_torch.serving.server --use_model <converted dir> \\
      [--port 8000] [--max_batch 64] [--max_wait_ms 5] [--int8] [--warmup] \\
      [--caption_checkpoint ckpt.npz --caption_config "res=224,img=L/14,..."] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from openvision_tpu_torch.serving.encode import build_encode_fn


def bucket_size(n: int, cap: int) -> int:
    """Next power of two >= n, capped at `cap` (the JAX daemon's `minimum`
    floor exists for its multi-chip mesh, which this one-GPU daemon lacks)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def bucket_sizes(cap: int) -> list[int]:
    """Every bucket a batcher with ``max_batch=cap`` can form: the powers of
    two below `cap`, and `cap`."""
    return sorted({bucket_size(n, cap) for n in range(1, cap + 1)})


@dataclasses.dataclass
class _Work:
    payload: object
    future: Future
    t_enqueue: float


class DynamicBatcher:
    """Coalesces concurrent `submit()` calls into batched runs.

    Either `run_batch(items) -> results` (one per item, in arrival order), or
    the pipelined pair `dispatch(items) -> handle` and `finalize(handle) ->
    results`: up to `pipeline_depth` dispatched batches are in flight, and
    the oldest is finalized when the pipe is full or the queue is empty.
    Everything runs on the one dispatcher thread, and results complete in
    arrival order. A raise fails every request of that batch and only that
    batch. `stop()` finishes the batches in flight and fails whatever is
    still queued.
    """

    def __init__(self, run_batch=None, *, max_batch: int = 64, max_wait_ms: float = 5.0,
                 name: str = "batch", dispatch=None, finalize=None, pipeline_depth: int = 2):
        if (run_batch is None) == (dispatch is None) or (dispatch is None) != (finalize is None):
            raise ValueError("give run_batch, or dispatch and finalize")
        self.run_batch = run_batch
        self.dispatch = dispatch
        self.finalize = finalize
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.name = name
        self._q: queue.Queue[_Work] = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # a submit never races past stop()
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded = 0
        self._latencies = collections.deque(maxlen=1024)  # seconds
        self._thread = threading.Thread(target=self._loop, name=f"batcher-{name}", daemon=True)
        self._thread.start()

    def submit(self, payload) -> Future:
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError(f"batcher {self.name} is stopped")
            w = _Work(payload, Future(), time.monotonic())
            self._q.put(w)
        return w.future

    def stop(self):
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=30.0)
        while True:  # fail anything still queued so callers don't hang
            try:
                w = self._q.get_nowait()
            except queue.Empty:
                break
            w.future.set_exception(RuntimeError(f"batcher {self.name} stopped"))

    def _collect(self, block: bool = True) -> list[_Work]:
        try:
            first = self._q.get(timeout=0.05) if block else self._q.get_nowait()
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                # past the window take what is already queued, without waiting
                batch.append(self._q.get(timeout=remaining) if remaining > 0
                             else self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _complete(self, batch: list[_Work], results) -> None:
        if len(results) != len(batch):
            raise RuntimeError(f"{len(results)} results for {len(batch)} items")
        now = time.monotonic()
        with self._lock:
            self._n_requests += len(batch)
            self._n_batches += 1
            self._n_padded += bucket_size(len(batch), self.max_batch) - len(batch)
            self._latencies.extend(now - w.t_enqueue for w in batch)
        for w, r in zip(batch, results):
            w.future.set_result(r)

    @staticmethod
    def _fail(batch: list[_Work], e: Exception) -> None:
        for w in batch:
            w.future.set_exception(e)

    def _finalize_oldest(self, inflight) -> None:
        batch, handle = inflight.popleft()
        try:
            self._complete(batch, self.finalize(handle))
        except Exception as e:  # noqa: BLE001 -- fan the failure out to this batch
            self._fail(batch, e)

    def _loop(self):
        inflight: collections.deque = collections.deque()
        while not self._stop.is_set():
            batch = self._collect(block=not inflight)
            if batch:
                try:
                    if self.run_batch is not None:
                        self._complete(batch, self.run_batch([w.payload for w in batch]))
                    else:
                        inflight.append((batch, self.dispatch([w.payload for w in batch])))
                except Exception as e:  # noqa: BLE001
                    self._fail(batch, e)
            if inflight and (len(inflight) >= self.pipeline_depth or not batch):
                self._finalize_oldest(inflight)
        while inflight:  # drain on stop so no future hangs
            self._finalize_oldest(inflight)

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            pct = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "mean_batch": self._n_requests / self._n_batches if self._n_batches else 0.0,
                "padded_rows": self._n_padded,
                "queued": self._q.qsize(),
                "latency_p50_ms": pct(0.50) * 1e3,
                "latency_p95_ms": pct(0.95) * 1e3,
            }


class _DeviceRunner:
    """The dispatcher threads' side of the card: a CUDA stream per thread
    (created on first use, after the weights are ready) and pinned host
    buffers, so a dispatch returns without waiting for the device. On the
    CPU it is plain tensor code."""

    def __init__(self, device: torch.device):
        self.device = device
        self._local = threading.local()
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # weights written on the default stream

    def stream(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(s)

    def to_device(self, x: np.ndarray):
        """(host tensor kept alive until finalize, device tensor), the copy
        enqueued on the current stream."""
        host = torch.from_numpy(x)
        if self.device.type != "cuda":
            return host, host
        host = host.pin_memory()
        return host, host.to(self.device, non_blocking=True)


class EmbedService:
    """Dynamic-batched image and text embedding over a loaded two-tower model."""

    def __init__(self, model, *, int8: bool = False, max_batch: int = 64,
                 max_wait_ms: float = 5.0):
        self.model = model
        self.max_batch = int(max_batch)
        self._encode_img = build_encode_fn(model, int8=int8)
        # raw-tensor path: uint8 pixels in, /255 - mean / std on the device
        self._encode_img_u8 = build_encode_fn(model, int8=int8, uint8_input=True)
        self._mean = np.asarray(model.mean, np.float32)
        self._std = np.asarray(model.std, np.float32)
        self._runner = _DeviceRunner(model.device)
        self.images = DynamicBatcher(dispatch=self._dispatch_images,
                                     finalize=self._finalize_batch, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms, name="image")
        self.texts = DynamicBatcher(dispatch=self._dispatch_texts, finalize=self._finalize_batch,
                                    max_batch=max_batch, max_wait_ms=max_wait_ms, name="text")

    # --- batch runners (dispatcher threads only) ---

    def _dispatch_images(self, items: list[np.ndarray]):
        """Enqueues one image batch; returns (n, host buffer, embeddings)
        without waiting for the device."""
        n, s = len(items), self.model.image_size
        b = bucket_size(n, self.max_batch)
        if all(it.dtype == np.uint8 for it in items):
            # all-raw batch (the tensor route's steady state): ship uint8
            x = np.zeros((b, s, s, 3), np.uint8)
            x[:n] = np.stack(items)
            enc = self._encode_img_u8
        else:  # mixed: the rare raw rows are normalized on the host
            x = np.zeros((b, s, s, 3), np.float32)
            for i, it in enumerate(items):
                x[i] = ((it.astype(np.float32) / 255.0 - self._mean) / self._std
                        if it.dtype == np.uint8 else it)
            enc = self._encode_img
        with self._runner.stream():
            host, dev = self._runner.to_device(x)
            return n, host, enc(dev)

    def _dispatch_texts(self, items: list[np.ndarray]):
        n = len(items)
        toks = np.zeros((bucket_size(n, self.max_batch), self.model.context_length), np.int64)
        toks[:n] = np.stack(items)
        with self._runner.stream():
            host, dev = self._runner.to_device(toks)
            return n, host, self.model.encode_text(dev)

    def _finalize_batch(self, handle) -> list[np.ndarray]:
        n, _, z = handle
        with self._runner.stream(), torch.inference_mode():
            return list(z[:n].cpu().numpy())  # the copy to the host waits

    # --- request-thread API (decode and preprocess here, then enqueue) ---

    def embed_image_bytes(self, data: bytes) -> Future:
        return self.images.submit(self.model.preprocess(data).astype(np.float32))

    def embed_image_tensor(self, rows: np.ndarray) -> list[Future]:
        """Pre-resized (N, S, S, 3) rows: uint8 raw pixels (normalized on the
        device) or float32 already normalized (``model.preprocess``). They
        enter the same batcher as decoded images."""
        s = self.model.image_size
        if rows.ndim == 3:
            rows = rows[None]
        if rows.shape[1:] != (s, s, 3):
            raise ValueError(f"tensor rows must be (N, {s}, {s}, 3), got {rows.shape}")
        if rows.dtype not in (np.uint8, np.float32):
            raise ValueError(f"tensor dtype must be uint8/float32, got {rows.dtype}")
        return [self.images.submit(r) for r in rows]

    def embed_text(self, text: str) -> Future:
        return self.texts.submit(np.asarray(self.model.tokenize([text])[0], np.int64))

    def rank(self, image_bytes: bytes, texts: list[str]) -> dict:
        """Zero-shot softmax over `texts` for one image (cosine * logit_scale)."""
        img_f = self.embed_image_bytes(image_bytes)
        txt_fs = [self.embed_text(t) for t in texts]
        zimg = img_f.result()
        ztxt = np.stack([f.result() for f in txt_fs])
        logits = self.model.logit_scale * (ztxt @ zimg)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        order = np.argsort(-probs)
        return {"texts": [texts[i] for i in order], "probs": [float(probs[i]) for i in order]}

    def warmup(self) -> list[int]:
        """Runs every bucket the batchers can form (the capped one too)
        through the image float, image uint8 and text paths: the kernels
        build and the allocator holds each shape's memory before the first
        request. Returns the buckets."""
        s, ctx = self.model.image_size, self.model.context_length
        buckets = bucket_sizes(self.max_batch)
        for b in buckets:
            self._finalize_batch(self._dispatch_images([np.zeros((s, s, 3), np.float32)] * b))
            self._finalize_batch(self._dispatch_images([np.zeros((s, s, 3), np.uint8)] * b))
            self._finalize_batch(self._dispatch_texts([np.zeros((ctx,), np.int64)] * b))
        return buckets

    def stats(self) -> dict:
        return {"image": self.images.stats(), "text": self.texts.stats()}

    def stop(self):
        self.images.stop()
        self.texts.stop()


class CaptionService:
    """Dynamic-batched greedy captioning over a CoCa train state (flat npz).

    The OpenCLIP export has no generative head, so the caption route loads
    the framework's own train state with ``tools/caption.build_captioner``
    and preprocesses as the caption tool does (``resize_small`` bilinear
    with antialias, ``central_crop``, ``vgg_value_range``). Greedy only: a
    per-request temperature would split batches; sampling stays on the
    caption CLI.
    """

    def __init__(self, config: dict, checkpoint: str, *, step: int | None = None,
                 vocab_path: str | None = None, max_batch: int = 64, max_wait_ms: float = 5.0,
                 device="cuda"):
        from openvision_tpu_torch.tools.caption import build_captioner
        from openvision_tpu_torch.tools.model_io import DEFAULT_VOCAB

        if step is not None:
            raise NotImplementedError(
                "--caption_step picks a step of an Orbax checkpoint directory; Orbax "
                "checkpoints are not ported yet: pass the flat npz train state")
        self.captioner, self.tok = build_captioner(config, checkpoint,
                                                   vocab_path or DEFAULT_VOCAB, device=device)
        self.image_size = int(config["res"])
        self.max_batch = int(max_batch)
        self._runner = _DeviceRunner(self.captioner.device)
        self.batcher = DynamicBatcher(dispatch=self._dispatch, finalize=self._finalize,
                                      max_batch=self.max_batch, max_wait_ms=max_wait_ms,
                                      name="caption")

    def _dispatch(self, items: list[np.ndarray]):
        n, s = len(items), self.image_size
        x = np.zeros((bucket_size(n, self.max_batch), s, s, 3), np.float32)
        x[:n] = np.stack(items)
        with self._runner.stream():
            host, dev = self._runner.to_device(x)
            return n, host, self.captioner(dev)

    def _finalize(self, handle) -> list[str]:
        n, _, ids = handle
        with self._runner.stream(), torch.inference_mode():
            ids = ids[:n].cpu().tolist()
        return [self.tok.decode(row) for row in ids]

    def caption_image_bytes(self, data: bytes) -> Future:
        from openvision_tpu_torch.tools.caption import preprocess

        return self.batcher.submit(preprocess(data, self.image_size).astype(np.float32))

    def warmup(self) -> list[int]:
        s = self.image_size
        buckets = bucket_sizes(self.max_batch)
        for b in buckets:
            self._finalize(self._dispatch([np.zeros((s, s, 3), np.float32)] * b))
        return buckets

    def stats(self) -> dict:
        return self.batcher.stats()

    def stop(self):
        self.batcher.stop()


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    service: EmbedService  # set by make_server
    caption_service: "CaptionService | None" = None
    started: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # the stdlib default writes a line per request
        pass

    def _reply(self, code: int, obj):
        body = _json_bytes(obj)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def do_GET(self):  # noqa: N802 -- stdlib naming
        if self.path == "/healthz":
            self._reply(200, {
                "status": "ok",
                "uptime_s": time.monotonic() - self.started,
                "image_size": self.service.model.image_size,
                "embed_dim": None,
                "caption": self.caption_service is not None,
            })
        elif self.path == "/stats":
            s = self.service.stats()
            if self.caption_service is not None:
                s["caption"] = self.caption_service.stats()
            self._reply(200, s)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        try:
            if self.path == "/v1/embed/image":
                futures = [self.service.embed_image_bytes(b) for b in self._image_payloads()]
            elif self.path == "/v1/embed/tensor":
                shape = tuple(int(x) for x in (self.headers.get("X-Tensor-Shape") or "").split(",")
                              if x.strip())
                dtype = (self.headers.get("X-Tensor-Dtype") or "uint8").strip()
                body = self._body()  # read even when the headers are bad: keep-alive
                if dtype not in ("uint8", "float32") or len(shape) not in (3, 4):
                    return self._reply(400, {"error": "need X-Tensor-Shape 'N,S,S,3' and "
                                                      "X-Tensor-Dtype uint8|float32"})
                rows = np.frombuffer(body, dtype=dtype).reshape(shape)
                futures = self.service.embed_image_tensor(rows)
                if "application/octet-stream" in (self.headers.get("Accept") or ""):
                    z = np.stack([f.result(timeout=120.0) for f in futures]).astype(np.float32)
                    raw = z.tobytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("X-Tensor-Shape", f"{z.shape[0]},{z.shape[1]}")
                    self.send_header("Content-Length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                    return
            elif self.path == "/v1/embed/text":
                req = json.loads(self._body() or b"{}")
                texts = req.get("texts") or ([req["text"]] if "text" in req else None)
                if not texts:
                    return self._reply(400, {"error": "need text or texts"})
                futures = [self.service.embed_text(t) for t in texts]
            elif self.path == "/v1/rank":
                req = json.loads(self._body() or b"{}")
                if "b64" not in req or not req.get("texts"):
                    return self._reply(400, {"error": "need b64 and texts"})
                return self._reply(200, self.service.rank(base64.b64decode(req["b64"]),
                                                          list(req["texts"])))
            elif self.path == "/v1/caption":
                payloads = self._image_payloads()  # read first: the connection stays in sync
                if self.caption_service is None:
                    return self._reply(503, {
                        "error": "no caption model loaded (start the server with "
                                 "--caption_checkpoint/--caption_config)"})
                futures = [self.caption_service.caption_image_bytes(b) for b in payloads]
                return self._reply(200, {"captions": [f.result(timeout=120.0) for f in futures]})
            else:
                self._body()
                return self._reply(404, {"error": f"no route {self.path}"})
            embeds = [f.result(timeout=120.0) for f in futures]
            self._reply(200, {
                "embeddings": [e.astype(np.float32).tolist() for e in embeds],
                "dim": int(embeds[0].shape[-1]) if embeds else 0,
            })
        except Exception as e:  # noqa: BLE001 -- per-request isolation
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    def _image_payloads(self) -> list[bytes]:
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        raw = self._body()
        if ctype.startswith("image/") or ctype == "application/octet-stream":
            return [raw]
        req = json.loads(raw or b"{}")
        b64 = req.get("b64")
        if b64 is None:
            raise ValueError("need image body or b64 field")
        return [base64.b64decode(b) for b in ([b64] if isinstance(b64, str) else list(b64))]


def make_server(service: EmbedService, host: str = "127.0.0.1", port: int = 8000,
                caption_service: CaptionService | None = None) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"service": service,
                                            "caption_service": caption_service,
                                            "started": time.monotonic()})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    from openvision_tpu_torch.configs import openvision as cfg_mod
    from openvision_tpu_torch.tools.model_io import DEFAULT_VOCAB, load_model

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=64)
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument("--int8", action="store_true", help="the W8A8 int8 image encode")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--attn_impl", default=None,
                        help="image tower attention; fused_t (tanh GELU) on CUDA, xla on the CPU")
    parser.add_argument("--warmup", action="store_true",
                        help="run every batch bucket once before listening")
    parser.add_argument("--data_parallel", action="store_true",
                        help="batch-parallel serving over all local GPUs (not ported yet)")
    parser.add_argument("--caption_checkpoint", default=None,
                        help="CoCa train state (flat npz) with the caption decoder; enables "
                             "POST /v1/caption")
    parser.add_argument("--caption_config", default="res=224,img=L/14,txt_name=L,"
                                                    "txt_decoder_name=L",
                        help="config arg string the caption checkpoint was trained with "
                             "(configs/openvision.py)")
    parser.add_argument("--caption_step", type=int, default=None,
                        help="a step of an Orbax checkpoint (not ported yet)")
    parser.add_argument("--caption_vocab", default=DEFAULT_VOCAB)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel (batch-parallel serving over several GPUs) waits for the "
            "multi-GPU slice of the port; serve on one GPU")
    device = torch.device(args.device)
    attn_impl = args.attn_impl or ("fused_t" if device.type == "cuda" else "xla")
    model = load_model(args.use_model, dtype=getattr(torch, args.dtype), attn_impl=attn_impl,
                       fast_gelu=attn_impl == "fused_t", device=device, int8=args.int8)
    service = EmbedService(model, int8=args.int8, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms)
    caption_service = None
    if args.caption_checkpoint:
        caption_service = CaptionService(
            cfg_mod.get_config(args.caption_config), args.caption_checkpoint,
            step=args.caption_step, vocab_path=args.caption_vocab, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, device=device)
    server = None
    try:
        if args.warmup:
            t0 = time.perf_counter()
            buckets = service.warmup()
            if caption_service is not None:
                caption_service.warmup()
            print(f"warmup: buckets {buckets} in {time.perf_counter() - t0:.1f}s")
        server = make_server(service, args.host, args.port, caption_service=caption_service)
        print(f"serving on http://{args.host}:{args.port} (max_batch={args.max_batch}, "
              f"max_wait={args.max_wait_ms}ms, {'int8' if args.int8 else args.dtype}, "
              f"attn={attn_impl}, device={device})")
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.server_close()
        service.stop()
        if caption_service is not None:
            caption_service.stop()


if __name__ == "__main__":
    main()
