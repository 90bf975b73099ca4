"""Minimal HTTP inference service (stdlib-only).

The reference serves predictions through a Streamlit sidebar upload widget
(ref: main.py:1011-1035).  The framework equivalent is a small HTTP server
over the Predictor:

  POST /predict            body: audio bytes (WAV, mp3, or any registered
                           codec; sniffed by magic bytes like the reference's
                           wav/mp3/m4a uploader, main1.py:953-954)
                           -> {"label": ..., "proba": {...}}
  POST /predict?denoise=0  skip the spectral gate
  POST /predict?model=cnn  route to a loaded sequence head (serve --seq-arch)
  POST /stream?window=3&hop=1   long WAV -> [{start_s, end_s, label, proba}]
  POST /stream?model=ensemble   windowed inference through the weighted vote
                           (windows share fused batch dispatches)
  GET  /                   self-contained browser page: upload a clip, read
                           the label + per-class probability table (the
                           reference's user surface is exactly this page,
                           main1.py:952-999 on port 8501)
  GET  /healthz            liveness + model metadata

Run: python -m stutter_tpu serve --root WORK [--port 8501]
(the reference's devcontainer also exposes port 8501, devcontainer.json:24-32).
"""

from __future__ import annotations

import io
import json
import logging
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from stutter_tpu.infer import Predictor

log = logging.getLogger("stutter_tpu.serve")


class _Gauge:
    """Count of /predict requests inside the HTTP handler that have not yet
    been queued into a batcher — while nonzero, more clips may still join
    the batch a worker is assembling (they are mid body-read / decode)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def inc(self):
        with self._lock:
            self._n += 1

    def dec(self):
        with self._lock:
            self._n -= 1

    def value(self) -> int:
        with self._lock:
            return self._n


class _MicroBatcher:
    """Coalesces concurrent /predict requests into predict_batch dispatches.

    The per-model lock serializes requests, so an interactive model whose
    request cost is one fused device dispatch (EnsemblePredictor) caps at
    one dispatch per request no matter how many clients connect.  The batcher
    instead parks arrivals for a short window (default 5 ms) and runs every
    clip that accumulated — up to max_batch — through ONE predict_batch
    dispatch, so concurrent load amortizes the dispatch instead of queueing
    behind it.

    The window is an upper bound, not a tax: with an ``arrivals`` gauge
    (the server counts /predict requests that entered the handler but have
    not queued yet), the worker dispatches as soon as that count hits zero —
    a lone request never waits out the window, and a concurrent burst
    dispatches the moment its last member queues instead of at window
    expiry.  Without a gauge (arrivals=None) the worker waits the full
    window, the pre-r5 behavior.

    Requests are grouped by their (denoise, sr) pair before dispatch —
    different flags cannot share a graph.  A dispatch error fails every
    request in that (denoise, sr) group (they shared the device call), not
    just the clip that caused it.
    """

    def __init__(self, predictor, window_ms: float = 5.0, max_batch: int = 8,
                 arrivals: _Gauge | None = None):
        self.predictor = predictor
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.arrivals = arrivals
        self._cv = threading.Condition()
        self._pending: list[dict] = []
        threading.Thread(target=self._run, daemon=True).start()

    def predict(self, y, sr: int, denoise: bool, on_queued=None) -> dict:
        item = {"y": y, "sr": sr, "denoise": denoise,
                "ev": threading.Event(), "out": None, "err": None}
        with self._cv:
            self._pending.append(item)
            if on_queued is not None:
                # decrement the arrivals gauge atomically with the append so
                # the worker never sees (queued, still-counted-as-arriving)
                on_queued()
            self._cv.notify()
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _run(self):  # daemon worker
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                deadline = time.time() + self.window
                while len(self._pending) < self.max_batch:
                    if self.arrivals is not None and self.arrivals.value() == 0:
                        # every /predict request the server has parsed is
                        # already queued (here or in another model's
                        # batcher) — nothing else can join this batch, so
                        # waiting out the window would be pure added latency
                        break
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        break
                    # poll at <=1 ms: gauge decrements via OTHER batchers do
                    # not notify this condition variable
                    self._cv.wait(min(remaining, 1e-3))
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            groups: dict = {}
            for it in batch:
                groups.setdefault((it["denoise"], it["sr"]), []).append(it)
            for (dn, gsr), items in groups.items():
                try:
                    outs = self.predictor.predict_batch(
                        [it["y"] for it in items], sr=gsr, denoise=dn
                    )
                    for it, o in zip(items, outs):
                        it["out"] = o
                except Exception as e:  # noqa: BLE001 — deliver to the callers
                    for it in items:
                        it["err"] = e
                for it in items:
                    it["ev"].set()


def _sniff_suffix(data: bytes) -> str:
    """Magic-byte container sniff so uploads route to the right decoder —
    the reference's uploader accepts wav/mp3/m4a (ref: main1.py:953-954).

    RIFF -> .wav; ID3 tag or an MPEG frame sync (0xFF 0xE0 mask) -> .mp3;
    an ISO-BMFF 'ftyp' box -> .m4a (decoded only via a registered hook,
    stutter_tpu.io.decode).  Unknown bytes default to .wav so the error
    message comes from the WAV parser.
    """
    if data[:4] == b"RIFF":
        return ".wav"
    if data[:3] == b"ID3" or (
        len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0
    ):
        return ".mp3"
    if data[4:8] == b"ftyp":
        return ".m4a"
    return ".wav"


def _decode_audio_bytes(data: bytes, target_sr: int) -> np.ndarray:
    """Upload body -> mono float32 PCM at target_sr via the same pluggable
    decode path the CLI and predict_file use (io.decode: WAV built-in, mp3
    via libmpg123, anything else via registered hooks)."""
    from stutter_tpu.io.decode import decode_audio

    with tempfile.NamedTemporaryFile(suffix=_sniff_suffix(data)) as tmp:
        tmp.write(data)
        tmp.flush()
        return decode_audio(tmp.name, target_sr)


MAX_UPLOAD_BYTES = 100 * 1024 * 1024  # reject oversized uploads before reading
# (the reference's Streamlit uploader caps at 200 MB by default)


# Self-contained browser surface (GET /): the reference's end-user
# interaction is a browser upload page — pick a clip, read the predicted
# label and per-class probabilities (ref: main1.py:952-999, auto-launched on
# port 8501 by .devcontainer/devcontainer.json:24-32).  One static page, no
# external assets: file input -> fetch POST /predict -> probability table;
# the model dropdown is filled from /healthz.
_INDEX_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Stutter Dysfluency Classifier</title>
<style>
  body { font: 16px/1.5 system-ui, sans-serif; max-width: 40rem;
         margin: 2rem auto; padding: 0 1rem; color: #1a1a2e; }
  h1 { font-size: 1.4rem; }
  fieldset { border: 1px solid #ccd; border-radius: 8px; padding: 1rem;
             margin-bottom: 1rem; }
  label { margin-right: 1rem; }
  button { padding: .4rem 1.2rem; font-size: 1rem; cursor: pointer; }
  table { border-collapse: collapse; margin-top: .75rem; width: 100%; }
  th, td { text-align: left; padding: .3rem .6rem;
           border-bottom: 1px solid #dde; }
  td.num { font-variant-numeric: tabular-nums; text-align: right; }
  .bar { height: .6rem; background: #5661b3; border-radius: 3px; }
  #verdict { font-size: 1.2rem; margin: .75rem 0 .25rem; }
  #verdict b { color: #5661b3; }
  #err { color: #b00020; white-space: pre-wrap; }
  .muted { color: #667; font-size: .85rem; }
</style></head><body>
<h1>Stutter Dysfluency Classifier</h1>
<p class="muted">Upload a speech clip (wav / mp3 / m4a) to classify the
dysfluency type. Served by <code>stutter_tpu</code>.</p>
<fieldset>
  <label>Audio file <input type="file" id="file"
         accept=".wav,.mp3,.m4a,audio/*"></label><br><br>
  <label>Model <select id="model"></select></label>
  <label><input type="checkbox" id="denoise" checked> denoise first</label>
  <br><br><button id="go" disabled>Classify</button>
</fieldset>
<div id="verdict"></div>
<div id="out"></div>
<div id="err"></div>
<script>
const $ = id => document.getElementById(id);
fetch('/healthz').then(r => r.json()).then(h => {
  for (const m of h.models) {
    const o = document.createElement('option');
    o.value = o.textContent = m;
    if (m === 'ensemble') o.selected = true;  // headline model when loaded
    $('model').appendChild(o);
  }
  $('go').disabled = false;
}).catch(e => { $('err').textContent = 'healthz failed: ' + e; });
$('go').onclick = async () => {
  const f = $('file').files[0];
  $('err').textContent = ''; $('verdict').textContent = '';
  $('out').innerHTML = '';
  if (!f) { $('err').textContent = 'choose an audio file first'; return; }
  $('go').disabled = true; $('verdict').textContent = 'classifying…';
  try {
    const q = '?model=' + encodeURIComponent($('model').value)
            + '&denoise=' + ($('denoise').checked ? '1' : '0');
    const r = await fetch('/predict' + q, { method: 'POST', body: f });
    const j = await r.json();
    if (!r.ok) throw new Error(j.error || r.statusText);
    $('verdict').innerHTML = 'Predicted: <b></b>';
    $('verdict').querySelector('b').textContent = j.label;
    const rows = Object.entries(j.proba).sort((a, b) => b[1] - a[1]).map(
      ([c, p]) => { const tr = document.createElement('tr');
        const td0 = document.createElement('td'); td0.textContent = c;
        const td1 = document.createElement('td'); td1.className = 'num';
        td1.textContent = (100 * p).toFixed(1) + '%';
        const td2 = document.createElement('td'); td2.style.width = '40%';
        const bar = document.createElement('div'); bar.className = 'bar';
        bar.style.width = (100 * p).toFixed(1) + '%'; td2.appendChild(bar);
        tr.append(td0, td1, td2); return tr; });
    const tbl = document.createElement('table');
    tbl.innerHTML = '<tr><th>class</th><th>probability</th><th></th></tr>';
    for (const tr of rows) tbl.appendChild(tr);
    $('out').appendChild(tbl);
  } catch (e) { $('verdict').textContent = ''; $('err').textContent = e; }
  $('go').disabled = false;
};
</script></body></html>
"""


def make_handler(
    predictor: Predictor,
    max_upload_bytes: int = MAX_UPLOAD_BYTES,
    seq_predictors: dict | None = None,
    batch_window_ms: float = 0.0,
    batch_max: int = 8,
):
    from stutter_tpu.runtime import device_info

    sr = predictor.cfg.features.frontend.sample_rate
    device = device_info()
    models = {"mlp": predictor, **(seq_predictors or {})}
    # batch_window_ms > 0 coalesces concurrent requests per batch-capable
    # model (those exposing predict_batch) into single fused dispatches.
    # The shared arrivals gauge counts /predict requests still being parsed:
    # a batcher dispatches as soon as it hits zero, so a lone request skips
    # the window entirely and a burst dispatches when its last clip queues.
    arrivals = _Gauge()
    batchers = {
        name: _MicroBatcher(m, batch_window_ms, batch_max, arrivals=arrivals)
        for name, m in models.items()
        if batch_window_ms > 0 and hasattr(m, "predict_batch")
    }
    # Per-model locks + a dedicated /stream lock: an in-flight multi-second
    # /stream must not block sub-ms /predict requests (they share no mutable
    # state — predictors are pure functional pipelines — so serializing per
    # model is only about bounding device-queue contention).
    locks = {name: threading.Lock() for name in models}
    stream_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict | list):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path in ("/", "/index.html"):
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                self._send(
                    200,
                    {
                        "status": "ok",
                        "classes": predictor.label_encoder.classes_,
                        "n_features": predictor.scaler.n_features_in_,
                        "models": sorted(models),
                        "platform": device["platform"],
                        "device_kind": device["kind"],
                        "device_count": device["count"],
                    },
                )
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            q = parse_qs(parsed.query)
            # count this request as "arriving" from before the body read
            # until it queues into a batcher (or fails first) — single-
            # threaded per request, so the once-flag needs no lock
            tracking = [parsed.path == "/predict" and bool(batchers)]
            if tracking[0]:
                arrivals.inc()

            def _queued():
                if tracking[0]:
                    tracking[0] = False
                    arrivals.dec()

            try:
                self._do_post(parsed, q, _queued)
            finally:
                _queued()

        def _do_post(self, parsed, q, _queued):
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send(400, {"error": "bad Content-Length"})
                return
            if length > max_upload_bytes:
                self._send(413, {"error": f"upload exceeds {max_upload_bytes} bytes"})
                return
            try:
                data = self.rfile.read(length)
                y = _decode_audio_bytes(data, sr)
            except Exception as e:  # noqa: BLE001
                self._send(400, {"error": f"bad audio: {e}"})
                return
            model = q.get("model", ["mlp"])[0]
            if model not in models:
                self._send(400, {"error": f"unknown model {model!r}; have {sorted(models)}"})
                return
            if parsed.path == "/stream" and not hasattr(models[model], "predict_stream"):
                self._send(
                    400,
                    {"error": f"model {model!r} does not support /stream; "
                              "use mlp or ensemble"},
                )
                return
            try:
                if parsed.path == "/predict":
                    dn = q.get("denoise", ["1"])[0] != "0"
                    if model in batchers:
                        # the batcher's worker serializes dispatches itself
                        out = batchers[model].predict(y, sr, dn,
                                                      on_queued=_queued)
                    else:
                        with locks[model]:
                            # per-request flag: never mutate the shared Predictor
                            out = models[model].predict_clip(y, sr, denoise=dn)
                elif parsed.path == "/stream":
                    with stream_lock:
                        out = models[model].predict_stream(
                            y,
                            sr,
                            window_s=float(q.get("window", ["3.0"])[0]),
                            hop_s=float(q.get("hop", ["1.0"])[0]),
                        )
                else:
                    self._send(404, {"error": "not found"})
                    return
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})
                return
            self._send(200, out)

    return Handler


def serve(output_dir: str, cfg=None, port: int = 8501, warmup: bool = True,
          host: str = "127.0.0.1", seq_arches: tuple = (), ensemble: bool = False,
          batch_window_ms: float = 0.0, batch_max: int = 8):
    """Build the HTTP server (bind localhost by default; pass host='0.0.0.0'
    to expose it like the reference's Streamlit port does).  seq_arches
    additionally loads trained sequence heads ('cnn' / 'cnn_bilstm' /
    'transformer', train-seq artifacts) served via POST /predict?model=<arch>;
    ensemble=True loads the weighted-vote EnsemblePredictor (the headline
    76%-CV model, run_cv --seq artifacts) at POST /predict?model=ensemble.
    batch_window_ms > 0 turns on request micro-batching for batch-capable
    models (currently the ensemble): concurrent uploads within the window
    share one fused device dispatch (up to batch_max clips; batch shapes pad
    to powers of two, so warmup covers B=1 and batching adds at most
    log2(batch_max) extra compiles per bucket on first load)."""
    from stutter_tpu.config import PipelineConfig
    from stutter_tpu.infer import EnsemblePredictor, SeqPredictor
    from stutter_tpu.runtime import start

    info = start()
    log.info("serving on platform=%s device_kind=%s", info["platform"], info["kind"])
    cfg = cfg or PipelineConfig()
    predictor = Predictor.load(output_dir, cfg)
    extra = {a: SeqPredictor.load(output_dir, a, cfg) for a in seq_arches}
    if ensemble:
        extra["ensemble"] = EnsemblePredictor.load(output_dir, cfg)
    if warmup:
        predictor.warmup()
        # with micro-batching on, also pre-compile the power-of-two batch
        # slots predict_batch pads to, so the first coalesced batch is
        # bounded too (batch-capable models only)
        # predict_batch pads row counts to powers of two, so a batch_max of
        # e.g. 6 can still dispatch at B=8 — warm every slot up to
        # next_pow2(batch_max).  batch_max < 2 can never coalesce, so no
        # batch slots exist to warm.
        top = 1 << (batch_max - 1).bit_length() if batch_max > 1 else 1
        slots = tuple(
            1 << k for k in range(1, top.bit_length())
        ) if batch_window_ms > 0 else ()
        for m in extra.values():
            # seq heads + ensemble compile per bucket AND per member — the
            # first request would otherwise pay those compiles
            if hasattr(m, "predict_batch"):
                m.warmup(batch_sizes=slots)
            else:
                m.warmup()
    httpd = ThreadingHTTPServer(
        (host, port),
        make_handler(predictor, seq_predictors=extra,
                     batch_window_ms=batch_window_ms, batch_max=batch_max),
    )
    return httpd  # caller runs httpd.serve_forever()
