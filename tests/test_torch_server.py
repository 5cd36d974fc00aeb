"""The port's serving daemon on the CPU, against the direct encode and the
JAX package's EmbedService.

One tiny export with random weights from a seed (the tests/test_torch_tools.py
widths: ViT and text tower of width 64, depth 2, 32 px) is loaded by both
packages in f32 with ``xla`` attention. The port's service and HTTP routes
must return what the direct encode returns on the same rows (1e-5; uint8
rows, normalized on the device, within 1e-4 of host-normalized rows, the
JAX package's bound), and
image and text embeddings within 1e-5 of the JAX EmbedService. The caption
route must return the caption tool's greedy captions for the same images,
from a tiny CoCa checkpoint (ViT mu/16 at 32 px, text and decoder Ti).
Over two replicas (``devices=["cpu", "cpu"]``) the services return one
device's embeddings (1e-5) and greedy captions, in request order, over
bursts that fill several buckets; buckets are floored at the replica count
and a ``max_batch`` below it raises; warmup runs every replica; the CLI's
``--data_parallel`` serves.
"""

import base64
import http.client
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from openvision_tpu_torch.serving import server as srv

W, L, H, E, RES, P, CTX, V = 64, 2, 2, 32, 32, 16, 16, 30522
CAPTION_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
               "output_token_len=8,vocab_size=30522,attn_impl=xla,dec_attn_impl=xla")


def _random_state(module, rng):
    """N(0, 0.05) for every tensor of `module`'s state dict, LayerNorm
    scales 1 + N(0, 0.05); numpy draws from `rng`."""
    sd = {}
    for name, t in module.state_dict().items():
        arr = np.asarray(rng.standard_normal(tuple(t.shape)) * 0.05, np.float32)
        if name.endswith("weight") and (".ln_" in name or "norm" in name):
            arr += 1
        sd[name] = torch.from_numpy(arr)
    return sd


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A random-weight OpenCLIP export (config + .bin) of the tiny model."""
    from openvision_tpu_torch.convert.openclip import state_dict_to_openclip
    from openvision_tpu_torch.models.clip import CLIPModel

    d = tmp_path_factory.mktemp("tiny_model")
    clip = CLIPModel(
        out_dim=E,
        image=dict(patch_size=(P, P), width=W, depth=L, mlp_dim=W * 4, num_heads=H,
                   emb_head_bias=False, image_size=RES),
        text=dict(width=W, depth=L, mlp_dim=W * 4, num_heads=H, vocab_size=V,
                  context_length=CTX))
    sd = _random_state(clip, np.random.default_rng(0))
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    torch.save(state_dict_to_openclip(sd), os.path.join(d, "open_clip_pytorch_model.bin"))
    cfg = {"model_cfg": {
        "embed_dim": E,
        "vision_cfg": {"layers": L, "width": W, "head_width": W // H, "patch_size": P,
                       "image_size": RES, "pool_type": "avg", "final_ln_after_pool": True,
                       "no_ln_pre": True},
        "text_cfg": {"layers": L, "width": W, "heads": H, "vocab_size": V,
                     "context_length": CTX, "pool_type": "last", "no_causal_mask": True},
    }}
    with open(os.path.join(d, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


@pytest.fixture(scope="module")
def model(model_dir):
    from openvision_tpu_torch.tools.model_io import load_model

    return load_model(model_dir, device="cpu", int8=True)


@pytest.fixture(scope="module")
def caption_ckpt(tmp_path_factory):
    """A random CoCa train state written as the port's flat npz."""
    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.convert.openclip import state_dict_to_jax_params
    from openvision_tpu_torch.train.checkpoint import save_npz
    from openvision_tpu_torch.train.step import build_model

    m = build_model(get_config(CAPTION_ARG))
    sd = _random_state(m, np.random.default_rng(1))
    params = state_dict_to_jax_params(
        sd, num_heads_vision=m.visual.transformer.resblocks[0].num_heads,
        num_heads_text=m.text.transformer.resblocks[0].num_heads,
        num_heads_decoder=m.txt_decoder.transformer.resblocks[0].num_heads)
    path = str(tmp_path_factory.mktemp("caption") / "ckpt.npz")
    save_npz(path, {"params": params})
    return path


@pytest.fixture(scope="module")
def captioner(caption_ckpt):
    from openvision_tpu_torch.configs.openvision import get_config

    svc = srv.CaptionService(get_config(CAPTION_ARG), caption_ckpt, max_batch=3,
                             max_wait_ms=25.0, device="cpu")
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def service(model):
    svc = srv.EmbedService(model, max_batch=6, max_wait_ms=25.0)
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def http_servers(service, captioner):
    """(address with the caption route, address without it)."""
    servers = [srv.make_server(service, "127.0.0.1", 0, caption_service=captioner),
               srv.make_server(service, "127.0.0.1", 0)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield [s.server_address for s in servers]
    for s in servers:
        s.shutdown()
        s.server_close()


def _png_bytes(seed: int, size: int = RES) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _decode(blob: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def _request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def _direct(model, rows, **kw):
    from openvision_tpu_torch.serving.encode import build_encode_fn

    return build_encode_fn(model, int8=False, **kw)(torch.from_numpy(rows)).numpy()


def test_bucket_size():
    assert [srv.bucket_size(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    assert srv.bucket_sizes(48) == [1, 2, 4, 8, 16, 32, 48]
    assert srv.bucket_sizes(8) == [1, 2, 4, 8]


def _batcher(mode, fn, **kw):
    if mode == "run_batch":
        return srv.DynamicBatcher(fn, **kw)
    return srv.DynamicBatcher(dispatch=lambda items: list(items), finalize=fn,
                              pipeline_depth=2, **kw)


@pytest.mark.parametrize("mode", ["run_batch", "pipelined"])
def test_dynamic_batcher_coalesces_and_orders(mode):
    sizes = []

    def fn(items):
        sizes.append(len(items))
        time.sleep(0.01)  # device latency: lets batches pile up in the pipelined mode
        return [2 * x for x in items]

    b = _batcher(mode, fn, max_batch=4, max_wait_ms=50.0)
    try:
        futs = [b.submit(float(i)) for i in range(12)]
        assert [f.result(timeout=10) for f in futs] == [2.0 * i for i in range(12)]
        assert max(sizes) > 1 and sum(sizes) == 12 and max(sizes) <= 4
        st = b.stats()
        assert st["requests"] == 12 and st["batches"] == len(sizes) and st["mean_batch"] > 1
    finally:
        b.stop()


@pytest.mark.parametrize("mode", ["run_batch", "pipelined"])
def test_dynamic_batcher_error_isolated_to_batch(mode):
    def fn(items):
        if any(x < 0 for x in items):
            raise ValueError("negative")
        return list(items)

    b = _batcher(mode, fn, max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(ValueError):
            b.submit(-1.0).result(timeout=10)
        assert b.submit(3.0).result(timeout=10) == 3.0  # the batcher survives
    finally:
        b.stop()


def test_dynamic_batcher_stop_fails_queued_futures():
    go = threading.Event()

    def fn(items):
        go.wait(10)
        return list(items)

    b = srv.DynamicBatcher(fn, max_batch=1, max_wait_ms=0.0)
    first = b.submit(1.0)
    time.sleep(0.1)  # the dispatcher holds `first` in fn
    queued = [b.submit(float(i)) for i in range(3)]
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(9.0)
    go.set()
    stopper.join(10)
    assert first.result(timeout=10) == 1.0
    for f in queued:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=10)


def test_service_matches_jax_embed_service(service, model, model_dir):
    """Image (PNG bytes, 3 -> bucket 4) and text embeddings of the port's
    service against the JAX EmbedService on the same export (f32, xla)."""
    from openvision_tpu.serving import server as jsrv
    from openvision_tpu.tools.model_io import load_model as jload

    jsvc = jsrv.EmbedService(jload(model_dir), int8=False, on_tpu=False, max_batch=8,
                             max_wait_ms=25.0)
    try:
        blobs = [_png_bytes(s) for s in range(3)]
        texts = ["a photo of a cat", "a diagram", "two dogs"]
        want_i = np.stack([f.result(timeout=120) for f in map(jsvc.embed_image_bytes, blobs)])
        want_t = np.stack([f.result(timeout=120) for f in map(jsvc.embed_text, texts)])
    finally:
        jsvc.stop()
    got_i = np.stack([f.result(timeout=60) for f in map(service.embed_image_bytes, blobs)])
    got_t = np.stack([f.result(timeout=60) for f in map(service.embed_text, texts)])
    np.testing.assert_allclose(got_i, want_i, atol=1e-5)
    np.testing.assert_allclose(got_t, want_t, atol=1e-5)
    pre = np.stack([model.preprocess(_decode(b)) for b in blobs]).astype(np.float32)
    np.testing.assert_allclose(got_i, _direct(model, pre), atol=1e-5)
    np.testing.assert_allclose(got_t, model.encode_text(model.tokenize(texts)).numpy(), atol=1e-5)


def test_service_tensor_uint8_and_pipelined_burst(service, model):
    """uint8 rows (normalized on the device) and float rows through the
    tensor path, in a burst of 3 capped buckets (18 rows, max_batch 6)."""
    raw = np.random.default_rng(3).integers(0, 256, (18, RES, RES, 3), dtype=np.uint8)
    got_u8 = np.stack([f.result(timeout=60) for f in service.embed_image_tensor(raw)])
    pre = np.stack([model.preprocess(r) for r in raw]).astype(np.float32)
    got_f = np.stack([f.result(timeout=60) for f in service.embed_image_tensor(pre)])
    want = _direct(model, pre)
    np.testing.assert_allclose(got_u8, want, atol=1e-4)
    np.testing.assert_allclose(got_f, want, atol=1e-5)
    with pytest.raises(ValueError, match="rows must be"):
        service.embed_image_tensor(np.zeros((2, RES + 1, RES, 3), np.uint8))
    with pytest.raises(ValueError, match="dtype"):
        service.embed_image_tensor(np.zeros((1, RES, RES, 3), np.float64))


def test_int8_service_matches_int8_encode(model):
    from openvision_tpu_torch.serving.encode import build_encode_fn

    svc = srv.EmbedService(model, int8=True, max_batch=4, max_wait_ms=10.0)
    try:
        raw = np.random.default_rng(4).integers(0, 256, (3, RES, RES, 3), dtype=np.uint8)
        got = np.stack([f.result(timeout=60) for f in svc.embed_image_tensor(raw)])
    finally:
        svc.stop()
    want = build_encode_fn(model, int8=True, uint8_input=True)(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    pre = np.stack([model.preprocess(r) for r in raw]).astype(np.float32)
    assert (got * _direct(model, pre)).sum(-1).min() >= 0.995


def _recording(svc, seen):
    """Wraps every replica's image encodes to note (replica, dtype, rows)."""
    for name in ("_encode_img", "_encode_img_u8"):
        setattr(svc, name, [lambda x, fn=fn, i=i: seen.append((i, x.dtype, x.shape[0])) or fn(x)
                            for i, fn in enumerate(getattr(svc, name))])


def test_warmup_covers_capped_bucket(model):
    svc = srv.EmbedService(model, max_batch=6, max_wait_ms=5.0)
    seen = []
    _recording(svc, seen)
    try:
        assert svc.warmup() == [1, 2, 4, 6]
    finally:
        svc.stop()
    for dt in (torch.float32, torch.uint8):
        assert [b for _, d, b in seen if d == dt] == [1, 2, 4, 6]


def test_data_parallel_warmup_warms_every_replica(model):
    svc = srv.EmbedService(model, max_batch=6, max_wait_ms=5.0, devices=["cpu", "cpu"])
    seen = []
    _recording(svc, seen)
    try:
        assert svc.warmup() == [2, 4, 6]  # floored at the 2 replicas
        assert svc.stats()["devices"] == 2
    finally:
        svc.stop()
    for dt in (torch.float32, torch.uint8):
        assert [(i, b) for i, d, b in seen if d == dt] == [(0, 1), (1, 1), (0, 2), (1, 2),
                                                           (0, 3), (1, 3)]


def test_bucket_floor_and_max_batch_below_the_replicas(model):
    assert [srv.bucket_size(n, 8, 2) for n in (1, 2, 3, 5, 8, 9)] == [2, 2, 4, 8, 8, 8]
    assert srv.bucket_sizes(8, 3) == [3, 6, 8]
    assert srv.bucket_sizes(6, 2) == [2, 4, 6]
    with pytest.raises(ValueError, match=r"max_batch=3 < the 4 replicas"):
        srv.EmbedService(model, max_batch=3, devices=["cpu"] * 4)


def test_data_parallel_embeds_equal_one_device(model, service):
    """A burst over two replicas (max_batch 6: buckets of 2, 4 and 6 rows cut
    in halves) returns one device's embeddings, in request order."""
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, (20, RES, RES, 3), dtype=np.uint8)
    pre = np.stack([model.preprocess(r) for r in raw]).astype(np.float32)
    texts = [f"a photo of thing {i}" for i in range(9)]
    svc = srv.EmbedService(model, max_batch=6, max_wait_ms=25.0, devices=["cpu", "cpu"])
    try:
        futures = svc.embed_image_tensor(raw) + svc.embed_image_tensor(pre)
        tfutures = [svc.embed_text(t) for t in texts]
        got = np.stack([f.result(timeout=60) for f in futures])
        gtxt = np.stack([f.result(timeout=60) for f in tfutures])
        assert svc.images.stats()["batches"] >= 7  # 40 rows in buckets of at most 6
        assert svc.images.stats()["requests"] == 40
    finally:
        svc.stop()
    want = np.stack([f.result(timeout=60) for f in service.embed_image_tensor(raw)
                     + service.embed_image_tensor(pre)])
    wtxt = np.stack([service.embed_text(t).result(timeout=60) for t in texts])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(gtxt, wtxt, atol=1e-5)
    np.testing.assert_allclose(got[20:], _direct(model, pre), atol=1e-5)


def test_data_parallel_captions_equal_one_device(captioner, caption_ckpt):
    from openvision_tpu_torch.configs.openvision import get_config

    blobs = [_png_bytes(s, 48) for s in range(7)]
    svc = srv.CaptionService(get_config(CAPTION_ARG), caption_ckpt, max_batch=4,
                             max_wait_ms=25.0, devices=["cpu", "cpu"])
    try:
        assert len(svc.captioners) == 2 and svc.captioners[0] is svc.captioners[1]
        got = [f.result(timeout=60) for f in map(svc.caption_image_bytes, blobs)]
        assert svc.stats()["devices"] == 2 and svc.stats()["requests"] == 7
    finally:
        svc.stop()
    want = [f.result(timeout=60) for f in map(captioner.caption_image_bytes, blobs)]
    assert got == want


def test_caption_warmup_and_captions_match_the_tool(captioner, caption_ckpt):
    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.tools import caption as tcap

    assert captioner.warmup() == [1, 2, 3]
    blobs = [_png_bytes(s, 48) for s in range(4)]
    got = [f.result(timeout=60) for f in map(captioner.caption_image_bytes, blobs)]
    cap, tok = tcap.build_captioner(get_config(CAPTION_ARG), caption_ckpt, device="cpu")
    ids = cap(np.stack([tcap.preprocess(_decode(b), 32) for b in blobs]))
    assert got == [tok.decode(row) for row in ids.tolist()]


def test_http_routes(http_servers, service, model, captioner):
    addr, _ = http_servers
    status, out = _request(addr, "GET", "/healthz")
    assert status == 200 and out["status"] == "ok" and out["caption"] is True
    status, out = _request(addr, "GET", "/stats")
    assert status == 200 and set(out) == {"image", "text", "caption", "devices"}
    assert out["devices"] == out["caption"]["devices"] == 1

    blob = _png_bytes(7)
    want = _direct(model, model.preprocess(_decode(blob)).astype(np.float32)[None])
    status, raw = _request(addr, "POST", "/v1/embed/image", body=blob,
                           headers={"Content-Type": "image/png"})
    assert status == 200 and raw["dim"] == E
    np.testing.assert_allclose(raw["embeddings"], want, atol=1e-5)
    status, b64 = _request(addr, "POST", "/v1/embed/image",
                           body=json.dumps({"b64": base64.b64encode(blob).decode()}),
                           headers={"Content-Type": "application/json"})
    assert status == 200
    np.testing.assert_allclose(b64["embeddings"], raw["embeddings"], atol=1e-6)

    rows = np.random.default_rng(11).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    hdrs = {"Content-Type": "application/octet-stream", "X-Tensor-Dtype": "uint8",
            "X-Tensor-Shape": ",".join(map(str, rows.shape))}
    status, out = _request(addr, "POST", "/v1/embed/tensor", body=rows.tobytes(), headers=hdrs)
    assert status == 200 and len(out["embeddings"]) == 2
    np.testing.assert_allclose(out["embeddings"], _direct(model, rows, uint8_input=True),
                               atol=1e-5)
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", "/v1/embed/tensor", body=rows.tobytes(),
                 headers={**hdrs, "Accept": "application/octet-stream"})
    resp = conn.getresponse()
    body = resp.read()
    shape = tuple(int(x) for x in resp.getheader("X-Tensor-Shape").split(","))
    conn.close()
    assert resp.status == 200 and shape == (2, E)
    np.testing.assert_allclose(np.frombuffer(body, np.float32).reshape(shape),
                               out["embeddings"], atol=1e-6)

    status, out = _request(addr, "POST", "/v1/embed/text",
                           body=json.dumps({"texts": ["a cat", "a dog"]}),
                           headers={"Content-Type": "application/json"})
    assert status == 200
    np.testing.assert_allclose(out["embeddings"],
                               model.encode_text(model.tokenize(["a cat", "a dog"])).numpy(),
                               atol=1e-5)
    status, rank = _request(addr, "POST", "/v1/rank", body=json.dumps(
        {"b64": base64.b64encode(_png_bytes(3)).decode(), "texts": ["a cat", "a dog", "a car"]}),
        headers={"Content-Type": "application/json"})
    assert status == 200 and sorted(rank["texts"]) == ["a car", "a cat", "a dog"]
    assert abs(sum(rank["probs"]) - 1.0) < 1e-4
    assert rank["probs"] == sorted(rank["probs"], reverse=True)

    blob = _png_bytes(5, 48)
    status, out = _request(addr, "POST", "/v1/caption", body=blob,
                           headers={"Content-Type": "image/png"})
    assert status == 200
    assert out["captions"] == [captioner.caption_image_bytes(blob).result(timeout=60)]

    for path, body in (("/v1/embed/text", b"{}"), ("/v1/embed/image", b"not an image"),
                       ("/v1/rank", b"{}")):
        status, out = _request(addr, "POST", path, body=body,
                               headers={"Content-Type": "image/png" if "image" in path
                                        else "application/json"})
        assert status == 400 and "error" in out
    status, _ = _request(addr, "POST", "/v1/embed/tensor", body=b"",
                         headers={"X-Tensor-Shape": "nope", "X-Tensor-Dtype": "uint8"})
    assert status == 400
    assert _request(addr, "GET", "/nope")[0] == 404


def test_http_caption_503_keeps_the_connection(http_servers):
    """No caption model: 503, and the next request on the same keep-alive
    connection is served (the JAX daemon leaves the body unread)."""
    _, addr = http_servers
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/v1/caption", body=_png_bytes(1), headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    assert resp.status == 503 and "caption" in json.loads(resp.read())["error"]
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read())["caption"] is False
    conn.close()


def test_http_concurrent_requests_coalesce(http_servers, service):
    _, addr = http_servers
    before = service.images.stats()
    rows = np.random.default_rng(12).integers(0, 256, (1, RES, RES, 3), dtype=np.uint8)
    hdrs = {"X-Tensor-Dtype": "uint8", "X-Tensor-Shape": ",".join(map(str, rows.shape))}
    results, errs = [], []

    def post():
        try:
            results.append(_request(addr, "POST", "/v1/embed/tensor", body=rows.tobytes(),
                                    headers=hdrs))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=post) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and len(results) == 8 and all(s == 200 for s, _ in results)
    for _, out in results[1:]:
        np.testing.assert_allclose(out["embeddings"], results[0][1]["embeddings"], atol=1e-6)
    after = service.images.stats()
    assert after["requests"] - before["requests"] == 8
    assert after["batches"] - before["batches"] < 8  # at least one multi-row batch


def test_main_refuses_data_parallel(model_dir, monkeypatch):
    """``--data_parallel`` serves (it raised before the replicas existed):
    on the CPU its devices are the one CPU."""
    made = []

    class Stub:
        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(srv, "make_server",
                        lambda service, *a, **k: made.append(service) or Stub())
    srv.main(["--use_model", model_dir, "--data_parallel", "--device", "cpu"])
    assert made[0].stats()["devices"] == 1
    assert srv.data_parallel_devices(torch.device("cpu")) == [torch.device("cpu")]


def test_kernel_library_builds_once_across_threads(monkeypatch):
    """Four dispatcher threads asking for the kernel library at once: one
    build and one load, and every thread gets the same handle."""
    import ctypes.util

    from openvision_tpu_torch.ops import kernels

    builds = []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a slow nvcc: the other threads arrive meanwhile
        return ctypes.util.find_library("m") or "libm.so.6"

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels, "_bind", lambda handle: handle)
    got, start = [], threading.Barrier(4)

    def call():
        start.wait()
        got.append(kernels.lib())

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(builds) == 1 and len(got) == 4 and all(h is got[0] for h in got)


def test_launch_counts_are_exact_across_threads(monkeypatch):
    from openvision_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))

    def bump():
        for _ in range(20000):
            kernels.count("gemm_int8")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert kernels.LAUNCHES["gemm_int8"] == 80000
