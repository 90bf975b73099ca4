"""HTTP serving endpoint over a live (local) server."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from stutter_tpu.config import PipelineConfig
from stutter_tpu.infer import Predictor
from stutter_tpu.io.wav import write_wav
from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu.serve import ThreadingHTTPServer, make_handler
from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.randn(60, 149).astype(np.float32)
    y = rng.randint(0, 2, 60)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["neg", "pos"]),
        model=fit_mlp(X, y, MLPTrainConfig(hidden=(8,), epochs=2, n_seeds=1, n_classes=2)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pred))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()


def _wav_bytes(y, sr=16000):
    import tempfile, os
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    write_wav(path, y, sr)
    data = open(path, "rb").read()
    os.unlink(path)
    return data


def test_healthz(server):
    r = json.loads(urllib.request.urlopen(server + "/healthz").read())
    assert r["status"] == "ok" and r["classes"] == ["neg", "pos"]


def test_index_page(server):
    """GET / serves the self-contained browser upload page (the reference's
    user surface is a browser page on this same port, ref main1.py:952-999)."""
    resp = urllib.request.urlopen(server + "/")
    assert resp.headers["Content-Type"].startswith("text/html")
    body = resp.read().decode()
    # the page must be able to drive the API end-to-end on its own:
    # model list from /healthz, upload POST to /predict, a results table
    assert "/healthz" in body and "/predict" in body
    assert "<input type=\"file\"" in body and "<select id=\"model\">" in body
    # no external assets — the page works with zero egress
    assert "http://" not in body and "https://" not in body
    # unknown GET paths still 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404


def test_predict_endpoint(server, rng):
    data = _wav_bytes((rng.randn(16000) * 0.2).astype(np.float32))
    req = urllib.request.Request(server + "/predict?denoise=0", data=data, method="POST")
    r = json.loads(urllib.request.urlopen(req).read())
    assert r["label"] in {"neg", "pos"}
    assert abs(sum(r["proba"].values()) - 1) < 1e-5


def test_predict_resamples(server, rng):
    data = _wav_bytes((rng.randn(22050) * 0.2).astype(np.float32), sr=22050)
    req = urllib.request.Request(server + "/predict?denoise=0", data=data, method="POST")
    r = json.loads(urllib.request.urlopen(req).read())
    assert r["label"] in {"neg", "pos"}


def test_predict_mp3_upload(server, rng):
    """POST an mp3 body: the magic-byte sniff routes it through the built-in
    mpg123 decoder (the reference's uploader accepts wav/mp3/m4a,
    main1.py:953-954)."""
    import ctypes
    import os
    import tempfile

    from stutter_tpu.io import mp3

    if not mp3.available():
        pytest.skip("libmpg123 absent")
    try:
        ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        pytest.skip("libmp3lame absent")
    from test_mp3 import _lame_encode

    with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
        path = f.name
    _lame_encode((rng.randn(16000) * 0.2).astype(np.float32), 16000, path)
    data = open(path, "rb").read()
    os.unlink(path)
    assert data[:3] == b"ID3" or (data[0] == 0xFF and (data[1] & 0xE0) == 0xE0)
    req = urllib.request.Request(server + "/predict?denoise=0", data=data, method="POST")
    r = json.loads(urllib.request.urlopen(req).read())
    assert r["label"] in {"neg", "pos"}
    assert abs(sum(r["proba"].values()) - 1) < 1e-5


def test_bad_payload_400(server):
    req = urllib.request.Request(server + "/predict", data=b"not a wav", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400


def test_upload_cap_413(server, rng):
    data = _wav_bytes((rng.randn(8000) * 0.2).astype(np.float32))
    req = urllib.request.Request(server + "/predict", data=data, method="POST")
    req.add_header("Content-Length", str(500 * 1024 * 1024))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 413


def test_concurrent_predict_and_stream(server, rng):
    """Concurrent /predict (mixed denoise flags) + /stream must not cross-
    contaminate: per-request flags are passed per call, never stored on the
    shared Predictor."""
    clip = _wav_bytes((rng.randn(16000) * 0.2).astype(np.float32))
    long_clip = _wav_bytes((rng.randn(16000 * 8) * 0.2).astype(np.float32))
    results, errors = {}, []

    def post(name, path, data):
        try:
            req = urllib.request.Request(server + path, data=data, method="POST")
            results[name] = json.loads(urllib.request.urlopen(req, timeout=420).read())
        except Exception as e:  # noqa: BLE001
            errors.append((name, e))

    threads = []
    for k in range(3):
        threads.append(threading.Thread(
            target=post, args=(f"p{k}", "/predict?denoise=0", clip)))
        threads.append(threading.Thread(
            target=post, args=(f"s{k}", "/stream?window=3&hop=2", long_clip)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    # identical inputs -> identical outputs across concurrent requests
    assert results["p0"] == results["p1"] == results["p2"]
    assert results["s0"] == results["s1"] == results["s2"]
    assert len(results["s0"]) >= 3  # several stream windows
    assert all(w["label"] in {"neg", "pos"} for w in results["s0"])


def test_predict_not_blocked_by_stream(rng):
    """An in-flight multi-second /stream must not block /predict: streams take
    a dedicated lock, predicts take per-model locks."""
    import time

    X = rng.randn(60, 149).astype(np.float32)
    y = rng.randint(0, 2, 60)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["neg", "pos"]),
        model=fit_mlp(X, y, MLPTrainConfig(hidden=(8,), epochs=2, n_seeds=1, n_classes=2)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    gate, started = threading.Event(), threading.Event()

    def slow_stream(y, sr, window_s=3.0, hop_s=1.0):
        started.set()
        assert gate.wait(timeout=60), "gate never opened"
        return []

    pred.predict_stream = slow_stream
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pred))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        clip = _wav_bytes((rng.randn(16000) * 0.2).astype(np.float32))

        stream_result = {}

        def run_stream():
            req = urllib.request.Request(base + "/stream", data=clip, method="POST")
            stream_result["out"] = json.loads(urllib.request.urlopen(req, timeout=120).read())

        st = threading.Thread(target=run_stream)
        st.start()
        assert started.wait(timeout=30), "stream request never started"
        # /predict must complete WHILE the stream is still blocked
        t0 = time.time()
        req = urllib.request.Request(base + "/predict?denoise=0", data=clip, method="POST")
        r = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert r["label"] in {"neg", "pos"}
        assert not gate.is_set() and st.is_alive()
        gate.set()
        st.join(timeout=60)
        assert stream_result["out"] == []
    finally:
        gate.set()
        httpd.shutdown()


def test_predict_model_routing(server, rng):
    """model=<unknown> is rejected; stream only supports the mlp model."""
    data = _wav_bytes((rng.randn(16000) * 0.2).astype(np.float32))
    req = urllib.request.Request(server + "/predict?model=nope", data=data, method="POST")
    try:
        urllib.request.urlopen(req)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400
    req = urllib.request.Request(
        server + "/stream?model=cnn", data=data, method="POST"
    )
    try:
        urllib.request.urlopen(req)
        assert False, "expected 400"
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_predict_seq_model_route(tmp_path, rng):
    """A loaded SeqPredictor is reachable via /predict?model=<arch>."""
    import os
    import threading

    from stutter_tpu.infer import SeqPredictor
    from stutter_tpu.models.cnn import init_cnn

    import jax

    params = init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=2)
    seq = SeqPredictor(
        arch="cnn", kind="logmel", params=params,
        mean=np.zeros(128, np.float32), std=np.ones(128, np.float32),
        classes_=["neg", "pos"], cfg=PipelineConfig(), denoise_first=False,
    )
    X = rng.randn(60, 149).astype(np.float32)
    y = rng.randint(0, 2, 60)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["neg", "pos"]),
        model=fit_mlp(X, y, MLPTrainConfig(hidden=(8,), epochs=2, n_seeds=1, n_classes=2)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), make_handler(pred, seq_predictors={"cnn": seq})
    )
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        h = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert h["models"] == ["cnn", "mlp"]
        data = _wav_bytes((rng.randn(16000) * 0.2).astype(np.float32))
        req = urllib.request.Request(
            base + "/predict?model=cnn&denoise=0", data=data, method="POST"
        )
        r = json.loads(urllib.request.urlopen(req).read())
        assert r["label"] in {"neg", "pos"}
        assert abs(sum(r["proba"].values()) - 1) < 1e-5
    finally:
        httpd.shutdown()


def test_predict_micro_batching(tmp_path, rng):
    """batch_window_ms > 0: concurrent ensemble requests coalesce into fused
    predict_batch dispatches; every response matches the unbatched result for
    the same clip, and mixed denoise flags stay per-request."""
    import json as _json
    import os
    import threading

    import jax

    from stutter_tpu.infer import EnsemblePredictor
    from stutter_tpu.models.cnn import init_cnn
    from stutter_tpu.train.seq_pipeline import persist_seq_head

    out = str(tmp_path)
    classes = ["neg", "pos"]
    persist_seq_head(
        out, "cnn", init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=2),
        np.zeros(128, np.float32), np.ones(128, np.float32), classes,
    )
    _json.dump(
        {"weights": {"cnn": 1.0}, "classes": classes},
        open(os.path.join(out, "ensemble.json"), "w"),
    )
    ens = EnsemblePredictor.load(out, PipelineConfig())
    X = rng.randn(60, 149).astype(np.float32)
    yl = rng.randint(0, 2, 60)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["neg", "pos"]),
        model=fit_mlp(X, yl, MLPTrainConfig(hidden=(8,), epochs=2, n_seeds=1,
                                            n_classes=2)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        make_handler(pred, seq_predictors={"ensemble": ens},
                     # generous window so slow-CI threads land in one batch
                     batch_window_ms=300.0, batch_max=8),
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        clips = [(rng.randn(12000 + 2000 * i) * 0.2).astype(np.float32)
                 for i in range(5)]
        expect = [ens.predict_clip(y, 16000, denoise=False) for y in clips]
        results = [None] * len(clips)
        errors = []

        def post(i, dn):
            try:
                req = urllib.request.Request(
                    base + f"/predict?model=ensemble&denoise={dn}",
                    data=_wav_bytes(clips[i]), method="POST",
                )
                results[i] = json.loads(urllib.request.urlopen(req).read())
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        # four denoise=0 + one denoise=1 in flight together: the batcher must
        # group by flag, not mix graphs
        threads = [threading.Thread(target=post, args=(i, 0)) for i in range(4)]
        threads.append(threading.Thread(target=post, args=(4, 1)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i in range(4):
            assert results[i]["label"] == expect[i]["label"]
            for c in classes:
                assert abs(results[i]["proba"][c] - expect[i]["proba"][c]) < 1e-4
        dn_expect = ens.predict_clip(clips[4], 16000, denoise=True)
        for c in classes:
            assert abs(results[4]["proba"][c] - dn_expect["proba"][c]) < 1e-4
    finally:
        httpd.shutdown()


def test_stream_ensemble_route(tmp_path, rng):
    """/stream?model=ensemble runs windowed inference through the vote; a
    model with no predict_stream still 400s."""
    import json as _json
    import os
    import threading

    import jax

    from stutter_tpu.infer import EnsemblePredictor, SeqPredictor
    from stutter_tpu.models.cnn import init_cnn
    from stutter_tpu.train.seq_pipeline import persist_seq_head

    out = str(tmp_path)
    classes = ["neg", "pos"]
    persist_seq_head(
        out, "cnn", init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=2),
        np.zeros(128, np.float32), np.ones(128, np.float32), classes,
    )
    _json.dump(
        {"weights": {"cnn": 1.0}, "classes": classes},
        open(os.path.join(out, "ensemble.json"), "w"),
    )
    ens = EnsemblePredictor.load(out, PipelineConfig())
    ens.denoise_first = False
    seq = SeqPredictor.load(out, "cnn", PipelineConfig())
    X = rng.randn(60, 149).astype(np.float32)
    yl = rng.randint(0, 2, 60)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["neg", "pos"]),
        model=fit_mlp(X, yl, MLPTrainConfig(hidden=(8,), epochs=2, n_seeds=1,
                                            n_classes=2)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        make_handler(pred, seq_predictors={"ensemble": ens, "cnn": seq}),
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        data = _wav_bytes((rng.randn(16000 * 3) * 0.2).astype(np.float32))
        req = urllib.request.Request(
            base + "/stream?model=ensemble&window=0.5&hop=1.0",
            data=data, method="POST",
        )
        wins = json.loads(urllib.request.urlopen(req, timeout=600).read())
        assert len(wins) == 3
        assert all(w["label"] in classes for w in wins)
        # a head without predict_stream is refused, not crashed
        req = urllib.request.Request(
            base + "/stream?model=cnn", data=data, method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()


def test_micro_batcher_arrivals_fast_path(rng):
    """The batch window is an upper bound, not a tax: with the arrivals
    gauge at zero a lone request dispatches immediately (far under a huge
    window), and a burst whose every member has queued dispatches the moment
    the last one arrives — as ONE batch — instead of at window expiry."""
    import time

    from stutter_tpu.serve import _Gauge, _MicroBatcher

    class StubPredictor:
        def __init__(self):
            self.batch_sizes = []

        def predict_batch(self, ys, sr, denoise):
            self.batch_sizes.append(len(ys))
            return [{"label": "neg", "i": float(len(y))} for y in ys]

    window_s = 3.0  # absurdly large so "fast" is unambiguous
    y = (rng.randn(4000) * 0.1).astype(np.float32)

    # 1) lone request: gauge goes 1 -> 0 at queue time -> immediate dispatch
    gauge = _Gauge()
    stub = StubPredictor()
    b = _MicroBatcher(stub, window_ms=window_s * 1e3, max_batch=8,
                      arrivals=gauge)
    gauge.inc()  # the handler counts the request before the body read
    t0 = time.time()
    out = b.predict(y, 16000, False, on_queued=gauge.dec)
    dt = time.time() - t0
    assert out["label"] == "neg"
    assert dt < window_s / 2, f"lone request waited {dt:.2f}s of the window"
    assert stub.batch_sizes == [1]
    assert gauge.value() == 0

    # 2) burst of 4: all counted as arriving BEFORE any queues; the worker
    #    must hold until the last one queues, then dispatch them together
    gauge2 = _Gauge()
    stub2 = StubPredictor()
    b2 = _MicroBatcher(stub2, window_ms=window_s * 1e3, max_batch=8,
                       arrivals=gauge2)
    n = 4
    for _ in range(n):
        gauge2.inc()
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()  # queue near-simultaneously
        results[i] = b2.predict(y, 16000, False, on_queued=gauge2.dec)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=window_s * 3)
    dt = time.time() - t0
    assert all(r is not None and r["label"] == "neg" for r in results)
    assert dt < window_s / 2, f"burst waited {dt:.2f}s of the window"
    # every clip was served in SOME batch; with the gauge held at >0 until
    # the final queue, a single full batch is the expected (and observed)
    # outcome — allow OS-scheduling splits but require real coalescing
    assert sum(stub2.batch_sizes) == n
    assert max(stub2.batch_sizes) >= 2, stub2.batch_sizes
    assert gauge2.value() == 0

    # 3) no gauge (arrivals=None): pre-r5 semantics — the worker waits out
    #    the window even for a lone request
    stub3 = StubPredictor()
    b3 = _MicroBatcher(stub3, window_ms=200.0, max_batch=8)
    t0 = time.time()
    b3.predict(y, 16000, False)
    dt = time.time() - t0
    assert dt >= 0.18, f"windowed batcher dispatched after only {dt:.3f}s"
