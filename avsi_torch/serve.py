"""Serving: a warm-model inpainting service (port of `avsi/serve.py`).

`InpaintingService` loads a checkpoint directory once and runs the
inference step at a fixed micro-batch, padding partial batches exactly as
the reference does (`avsi/serve.py:216-285`), at the model's STFT
geometry (the BLSTMs' 192-sample hop, the U-Nets' 128); `open_stream`
starts a live LC-BLSTM stream on the same weights
(`avsi_torch.infer.streaming`), and refuses a model that has no stream
path (the U-Nets: HTTP 400, and /enhance goes on serving).
`serve()` wraps it in a stdlib HTTP server:

  POST /enhance   body: raw little-endian payload
      [int32 n_samples][int32 t_frames]
      [n_samples x int16 wave][t_frames x uint8 frame_mask]
      (+ [emb_dim x float32 speaker embedding] for blstm-*-emb models)
  -> 200, body: n_samples x int16 enhanced wave
  GET /healthz    -> 200 "ok"
  GET /info       -> model/geometry/weights_version/device JSON
  GET /metrics    -> Prometheus text (counters, live streams, uptime)
  POST /reload    body: optional checkpoint directory (default: the one
      served) -> {"weights_version": n}: hot-swaps the weights; the
      geometry and the parameter tree must match (400 otherwise); open
      streams keep the weights they started with

Live streams (visual models append f16 video rows to each push payload,
CTC models can ask for framed incremental transcripts with `transcript=1`):

  POST /stream/open?chunk=8&look=16&transcript=0&fill=0
      -> {"id": ..., "chunk_frames": ..., "frame_step": 192, ...}
      (blstm-*-emb models: the open body carries the float32 speaker vector;
       &atten=0.5[&atten_trust=34&atten_ramp=16] turns the causal deep-gap
       attenuation on for the stream, &atten=1 turns it off; absent, the
       service's `gap_atten` applies)
  POST /stream/<id>   body: [int32 n_samples][int32 n_frames]
      [n_samples x int16 wave][n_frames x uint8 frame_mask]
      (+ [n_frames x video_feat_dim x float16 video] for visual models)
  -> 200, body: int16 enhanced samples ready so far (possibly empty); with
      transcript=1 the framed [int32 n_samples][int16 samples][int16 new
      label ids]
  POST /stream/<id>/close  -> 200, the final samples; session freed

At most `max_streams` sessions live at once (429 beyond); a session idle
for `stream_idle_s` is reaped (404 afterwards, as for an unknown id).
`/enhance` and every stream push take one device lock.  With
`data_shards > 1` the /enhance micro-batch is split over a data mesh.  The
service-wide
`passthrough` and `gap_atten` options apply to /enhance (the offline
levers) and to every stream (their causal twins).
"""

from __future__ import annotations

import json
import struct
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from avsi_torch.device import resolve_device
from avsi_torch.infer.inpaint import load_model_bundle, make_infer_step
from avsi_torch.infer.streaming import StreamingInpainter
from avsi_torch.models.blstm import parse_model_name
from avsi_torch.parallel import mesh as mesh_lib
from avsi_torch.train.checkpoints import named_leaves

# the configuration keys a reload must keep: the shapes of requests and weights
GEOMETRY = ("model", "audio_len", "audio_feat_dim", "video_feat_dim", "net_dim",
            "integration_layer")


def _stream_spec(model: str):
    """The BLSTM spec of a model that streams; a ValueError (HTTP 400)
    naming any other model."""
    try:
        return parse_model_name(model)
    except ValueError:
        raise ValueError(f"model {model} has no live stream path: /stream/* serves the "
                         "BLSTM models") from None


class InpaintingService:
    def __init__(
        self,
        model_path: str,
        micro_batch: int = 8,
        phase_recon: str = "gl",
        gl_iters: int = 30,
        norm: bool = True,
        data_shards: int = 0,
        passthrough: bool = False,
        gap_atten: dict | None = None,
        lstm_impl: str = "auto",
        device=None,
        mesh_devices=None,
    ):
        """passthrough and gap_atten ({"alpha", "trust", "ramp"}) are the
        service-wide deployment levers: the offline ones on /enhance, their
        causal twins on every stream unless `open_stream(gap_atten=...)`
        says otherwise.

        data_shards > 1 splits the /enhance micro-batch over a data mesh
        (`make_infer_step(mesh=)`: params replicated, each shard's rows on
        its device, nothing exchanged), built over `mesh_devices` (default:
        every visible card once, or on the CPU the CPU split that many
        ways).  Live streams keep their single-device state; a fleet shards
        through `stream_utterances_lockstep(mesh=...)`."""
        self.device = resolve_device(device)
        self.mesh = None
        if data_shards and int(data_shards) > 1:
            if micro_batch % int(data_shards):
                raise ValueError(f"micro_batch {micro_batch} not divisible by "
                                 f"data_shards {data_shards}")
            self.mesh = mesh_lib.get_mesh(int(data_shards), mesh_devices if mesh_devices
                                          is not None else mesh_lib.entry_devices(
                                              self.device, int(data_shards)))
            self.device = self.mesh.data_devices[0]
        self._lstm_impl = lstm_impl
        self._model_path, self._norm = model_path, norm
        self._phase_recon, self._gl_iters = phase_recon, gl_iters
        self._passthrough, self._gap_atten = bool(passthrough), gap_atten or None
        self.config, stats, model, self.params = load_model_bundle(
            model_path, norm, lstm_impl=lstm_impl, device=self.device
        )
        self.stats = stats
        self.micro_batch = micro_batch
        self.audio_len = int(self.config["audio_len"])
        self.t_frames = -(-self.audio_len // model.frame_step)
        self.af = int(self.config["audio_feat_dim"])
        self.vf = int(self.config["video_feat_dim"])
        self.emb_dim = (
            int(self.config.get("embedding_dim", 512)) if model.needs_embeddings else 0
        )
        self._step = self._make_step(model, self.config, stats)
        self._lock = threading.Lock()  # one device stream: /enhance and pushes
        self.weights_version = 0
        self.started = time.monotonic()
        # counters served at /metrics, each updated under _lock
        self.n_utterances = 0
        self.n_device_steps = 0
        self.n_stream_pushes = 0
        self.warmup()

    def _make_step(self, model, config, stats):
        return make_infer_step(model, config, stats, False, self._phase_recon, self._gl_iters,
                               passthrough=self._passthrough, gap_atten=self._gap_atten,
                               device=self.device, mesh=self.mesh)

    def reload(self, model_path: str | None = None) -> int:
        """Hot-swap the weights from `model_path` (default: the checkpoint
        served now, which after a reload from a path is that path).

        Refused (ValueError) when the checkpoint's geometry (`GEOMETRY`)
        or its parameter tree (the flat keys and shapes) differs from the
        served one.  When its stats or the rest of its config differ, the
        step is rebuilt and warmed outside the device lock.  The swap
        replaces references under the lock and never writes into the
        served tensors, so streams opened before it keep the weights and
        stats they started with.  Returns the new `weights_version`."""
        cfg, stats, model, params = load_model_bundle(
            model_path or self._model_path, self._norm, lstm_impl=self._lstm_impl,
            device=self.device)
        for key in GEOMETRY:
            if cfg.get(key) != self.config.get(key):
                raise ValueError(f"reload geometry mismatch on {key}: {cfg.get(key)!r} vs "
                                 f"serving {self.config.get(key)!r}")
        new_tree = {k: tuple(v.shape) for k, v in named_leaves(params).items()}
        old_tree = {k: tuple(v.shape) for k, v in named_leaves(self.params).items()}
        if new_tree != old_tree:
            diff = sorted(set(new_tree.items()) ^ set(old_tree.items()))
            raise ValueError(f"reload params-tree mismatch: {diff[:4]}")
        rebuild = cfg != self.config or not all(
            np.array_equal(a, b) for a, b in zip(stats, self.stats))
        step = self._step
        if rebuild:
            step = self._make_step(model, cfg, stats)
            step(params, self._template_batch(self.micro_batch))[0].cpu()
        with self._lock:
            self.params, self.stats, self.config, self._step = params, stats, cfg, step
            if model_path:
                self._model_path = model_path
            self.weights_version += 1
            return self.weights_version

    def _template_batch(self, n: int) -> dict:
        batch = {
            "sequence_lengths": np.full((n,), self.t_frames, np.int32),
            "labels_lengths": np.ones((n,), np.int32),
            "target_sources": np.zeros((n, self.audio_len), np.int16),
            "labels": np.zeros((n, 50), np.float32),
            "video_features": np.zeros((n, self.t_frames, self.vf), np.float16),
            "mask_frames": np.ones((n, self.t_frames), np.int8),
        }
        if self.emb_dim:
            batch["embeddings"] = np.zeros((n, self.emb_dim), np.float32)
        return batch

    def warmup(self) -> None:
        """One step at the serving shape (builds the kernels on a GPU)."""
        wav, _, _ = self._step(self.params, self._template_batch(self.micro_batch))
        wav.cpu()

    def enhance_batch(self, waves: np.ndarray, mask_frames: np.ndarray,
                      embeddings: np.ndarray | None = None) -> np.ndarray:
        """waves (N, audio_len) int16-scale; mask_frames (N, T) 0/1;
        embeddings (N, emb_dim) float32, required iff the model is a
        blstm-*-emb variant."""
        n = len(waves)
        if self.emb_dim:
            if embeddings is None:
                raise ValueError(
                    f"model {self.config['model']} needs per-utterance speaker "
                    f"embeddings (N, {self.emb_dim})"
                )
            if np.shape(embeddings) != (n, self.emb_dim):
                raise ValueError(
                    f"embeddings must be (N={n}, {self.emb_dim}); got "
                    f"{np.shape(embeddings)}"
                )
        elif embeddings is not None:
            raise ValueError(f"model {self.config['model']} takes no speaker embeddings")
        out = np.empty((n, self.audio_len), np.int16)
        with self._lock:  # one device stream; keep shapes fixed
            for lo in range(0, n, self.micro_batch):
                chunk = slice(lo, min(lo + self.micro_batch, n))
                k = chunk.stop - chunk.start
                batch = self._template_batch(self.micro_batch)
                batch["target_sources"][:k] = np.clip(
                    waves[chunk], -32768, 32767
                ).astype(np.int16)
                batch["mask_frames"][:k] = mask_frames[chunk].astype(np.int8)
                if self.emb_dim:
                    batch["embeddings"][:k] = embeddings[chunk].astype(np.float32)
                wav, _, _ = self._step(self.params, batch)
                out[chunk] = wav[:k].cpu().numpy()
                self.n_utterances += k
                self.n_device_steps += 1
        return out

    def enhance(self, wave: np.ndarray, mask_frames: np.ndarray,
                embedding: np.ndarray | None = None) -> np.ndarray:
        return self.enhance_batch(
            wave[None], mask_frames[None],
            None if embedding is None else np.asarray(embedding)[None],
        )[0]

    def open_stream(self, chunk_frames: int | None = None,
                    lookahead_frames: int | None = None,
                    transcript: bool = False,
                    phase_fill: bool = False,
                    embedding: np.ndarray | None = None,
                    gap_atten: dict | None | str = "service-default") -> StreamingInpainter:
        """A live LC-BLSTM stream on this service's weights and device.
        chunk/lookahead default to the model's trained LC window, else
        C=8/L=16 (`streaming.resolve_window`); transcript=True (CTC models)
        keeps an incremental greedy decode on the stream; phase_fill=True
        fills the hole's phase causally; `embedding` is the speaker vector
        of blstm-*-emb models; `gap_atten` overrides the service's causal
        attenuation for this stream (None turns it off).  The stream takes
        the service's passthrough, and its requested `lstm_impl` through
        streaming's own policy.  Nothing is compiled per stream: the
        kernels were built by the service's warm-up."""
        _stream_spec(self.config["model"])
        if gap_atten == "service-default":
            gap_atten = self._gap_atten
        with self._lock:  # one coherent (config, stats, params) against a reload
            config, stats, params = self.config, self.stats, self.params
        return StreamingInpainter(
            config, stats, params,
            chunk_frames=chunk_frames, lookahead_frames=lookahead_frames,
            embedding=embedding, transcript=transcript, phase_fill=phase_fill,
            passthrough=self._passthrough, lstm_impl=self._lstm_impl, gap_atten=gap_atten,
            device=self.device,
        )


def _parse_enhance(raw: bytes, service: InpaintingService):
    """/enhance payload -> (wave f32, mask f32, embedding or None)."""
    n_samples, t_frames = struct.unpack_from("<ii", raw, 0)
    if n_samples != service.audio_len or t_frames != service.t_frames:
        raise ValueError(
            f"expected {service.audio_len} samples / "
            f"{service.t_frames} frames, got {n_samples}/{t_frames}"
        )
    off = 8
    wave = np.frombuffer(raw, "<i2", n_samples, off).astype(np.float32)
    off += 2 * n_samples
    mask = np.frombuffer(raw, np.uint8, t_frames, off)
    if mask.size and mask.max() > 1:
        raise ValueError("frame mask bytes must be 0 or 1")
    off += t_frames
    emb = None
    if service.emb_dim:
        if len(raw) - off != 4 * service.emb_dim:
            raise ValueError(
                f"model {service.config['model']} needs a "
                f"{service.emb_dim}-float32 speaker embedding after the mask bytes"
            )
        emb = np.frombuffer(raw, "<f4", service.emb_dim, off).copy()
    elif len(raw) != off:
        raise ValueError(
            f"model {service.config['model']} takes no speaker embedding; "
            f"{len(raw) - off} unexpected trailing bytes"
        )
    return wave, mask.astype(np.float32), emb


def _parse_push(raw: bytes, inp: StreamingInpainter):
    """/stream/<id> payload -> (wave f32, mask f32, video f32 or None)."""
    n_samples, n_frames = struct.unpack_from("<ii", raw, 0)
    off = 8
    wave = np.frombuffer(raw, "<i2", n_samples, off)
    off += 2 * n_samples
    mask = np.frombuffer(raw, np.uint8, n_frames, off)
    off += n_frames
    if mask.size and mask.max() > 1:
        raise ValueError("frame mask bytes must be 0 or 1")
    video = None
    if inp.spec.input_type != "a":  # f16 rows, n_frames x video_feat_dim
        video = np.frombuffer(raw, "<f2", n_frames * inp.vf, off).astype(
            np.float32).reshape(n_frames, inp.vf)
    return wave.astype(np.float32), mask.astype(np.float32), video


def _open_options(query: str, raw: bytes, service: InpaintingService) -> dict:
    """/stream/open query and body -> `open_stream` keyword arguments."""
    spec = _stream_spec(service.config["model"])
    q = urllib.parse.parse_qs(query)
    chunk = int(q["chunk"][0]) if "chunk" in q else None
    look = int(q["look"][0]) if "look" in q else None
    if chunk is not None and not 1 <= chunk <= 256:
        raise ValueError("chunk must be in [1,256]")
    if look is not None and not 0 <= look <= 256:
        raise ValueError("look must be in [0,256]")
    transcript = bool(int(q.get("transcript", ["0"])[0]))
    if transcript and not spec.ctc:
        raise ValueError(f"model {service.config['model']} has no CTC head; "
                         "transcript=1 needs a -ctc variant")
    gap_atten = "service-default"
    if "atten" in q:  # atten=1 is off; absent, the service's setting holds
        alpha = float(q["atten"][0])
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("atten must be in [0,1]")
        gap_atten = None if alpha >= 1.0 else {
            "alpha": alpha, "trust": int(q.get("atten_trust", ["34"])[0]),
            "ramp": int(q.get("atten_ramp", ["16"])[0])}
    emb = None
    if raw:
        if spec.conditioning != "emb":
            raise ValueError(f"model {service.config['model']} takes no speaker embedding; "
                             "/stream/open body must be empty")
        if len(raw) != 4 * service.emb_dim:
            raise ValueError(f"embedding must be {service.emb_dim} little-endian float32 "
                             f"values; got {len(raw)} bytes")
        emb = np.frombuffer(raw, "<f4").copy()
    elif spec.conditioning == "emb":
        raise ValueError("model needs an external speaker embedding: send it as "
                         "float32 bytes in the /stream/open body")
    return dict(chunk_frames=chunk, lookahead_frames=look, transcript=transcript,
                phase_fill=bool(int(q.get("fill", ["0"])[0])), embedding=emb,
                gap_atten=gap_atten)


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8571,
          max_streams: int = 64, stream_idle_s: float = 600.0, **kw):
    """Build the service and an HTTP server bound to (host, port); port=0
    takes a free one.  The caller runs `serve_forever()` and `shutdown()`;
    `shutdown()` also stops the idle-stream reaper."""
    service = InpaintingService(model_path, **kw)
    # sid -> [StreamingInpainter (None while opening), last use (monotonic),
    #         transcript ids already sent, requests in flight]
    streams: dict = {}
    streams_lock = threading.Lock()

    def reap_streams():
        """Drop sessions idle past the TTL.  Sessions still opening, and
        sessions with a request in flight (waiting on the device lock), are
        kept: evicting one would orphan an accepted push."""
        now = time.monotonic()
        with streams_lock:
            for sid in [s for s, v in streams.items()
                        if v[0] is not None and v[3] == 0 and now - v[1] > stream_idle_s]:
                del streams[sid]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes):
            self._replied = True
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._replied = False
            if self.path == "/healthz":
                self._reply(200, b"ok")
            elif self.path == "/info":
                self._reply(200, json.dumps({
                    "model": service.config["model"],
                    "audio_len": service.audio_len,
                    "t_frames": service.t_frames,
                    "micro_batch": service.micro_batch,
                    "weights_version": service.weights_version,
                    "device": str(service.device),
                    "lstm_impl": service.config["lstm_impl"],
                }).encode())
            elif self.path == "/metrics":  # Prometheus text exposition
                with streams_lock:
                    live = sum(1 for v in streams.values() if v[0] is not None)
                lines = [
                    "# TYPE avsi_utterances_enhanced_total counter",
                    f"avsi_utterances_enhanced_total {service.n_utterances}",
                    "# TYPE avsi_device_steps_total counter",
                    f"avsi_device_steps_total {service.n_device_steps}",
                    "# TYPE avsi_stream_pushes_total counter",
                    f"avsi_stream_pushes_total {service.n_stream_pushes}",
                    "# TYPE avsi_live_streams gauge",
                    f"avsi_live_streams {live}",
                    "# TYPE avsi_weights_version gauge",
                    f"avsi_weights_version {service.weights_version}",
                    "# TYPE avsi_uptime_seconds gauge",
                    f"avsi_uptime_seconds {time.monotonic() - service.started:.1f}",
                ]
                self._reply(200, ("\n".join(lines) + "\n").encode())
            else:
                self._reply(404, b"not found")

        def _open(self, query: str, raw: bytes):
            opts = _open_options(query, raw, service)
            # reserve the slot under one lock acquisition, so concurrent
            # opens at the limit cannot all pass the check
            sid = uuid.uuid4().hex[:12]
            with streams_lock:
                full = len(streams) >= max_streams
                if not full:
                    streams[sid] = [None, time.monotonic(), 0, 0]
            if full:
                self._reply(429, b"too many live streams")
                return
            try:
                inp = service.open_stream(**opts)
            except BaseException:
                with streams_lock:
                    streams.pop(sid, None)
                raise
            with streams_lock:
                streams[sid] = [inp, time.monotonic(), 0, 0]
            self._reply(200, json.dumps({
                "id": sid, "chunk_frames": inp.chunk, "lookahead_frames": inp.look,
                "frame_step": 192, "frame_length": 384,
                "video_feat_dim": 0 if inp.spec.input_type == "a" else inp.vf,
                "transcript": inp.want_transcript, "gap_atten": inp.gap_atten,
            }).encode())

        def _push(self, sid: str, closing: bool, raw: bytes):
            with streams_lock:
                entry = streams.get(sid)
                if entry is not None and entry[0] is None:
                    entry = None  # still opening
                if entry is not None:
                    entry[1] = time.monotonic()
                    entry[3] += 1  # in flight: the reaper keeps it
            if entry is None:
                self._reply(404, b"no such stream")
                return
            inp = entry[0]
            try:
                with service._lock:
                    if closing:
                        out = inp.flush()
                        with streams_lock:
                            streams.pop(sid, None)
                    else:
                        out = inp.push(*_parse_push(raw, inp))
                        service.n_stream_pushes += 1
                    body = np.clip(out, -32768, 32767).astype("<i2").tobytes()
                    if inp.want_transcript:
                        # framed reply; the cursor of ids sent is session
                        # state, advanced once per reply under the lock
                        new_ids = inp.transcript[entry[2]:]
                        entry[2] = len(inp.transcript)
                        body = (struct.pack("<i", len(out)) + body
                                + np.asarray(new_ids, "<i2").tobytes())
            finally:
                with streams_lock:
                    entry[3] -= 1
                    entry[1] = time.monotonic()
            self._reply(200, body)

        def do_POST(self):
            # client errors (a /reload path that does not exist, too) -> 400
            # with the message; a model not ported yet (a /reload to one)
            # -> 501; anything else -> opaque 500.  Once a reply has
            # started, never write a second one into the connection.
            self._replied = False
            path, _, query = self.path.partition("?")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                if path == "/enhance":
                    enhanced = service.enhance(*_parse_enhance(raw, service))
                    self._reply(200, enhanced.astype("<i2").tobytes())
                elif path == "/stream/open":
                    reap_streams()
                    self._open(query, raw)
                elif path.startswith("/stream/"):
                    reap_streams()
                    parts = path.split("/")[2:]
                    self._push(parts[0], parts[1:] == ["close"], raw)
                elif path == "/reload":
                    version = service.reload(raw.decode().strip() or None)
                    self._reply(200, json.dumps({"weights_version": version}).encode())
                else:
                    self._reply(404, b"not found")
            except (ValueError, KeyError, IndexError, struct.error, FileNotFoundError) as e:
                if not self._replied:
                    self._reply(400, str(e).encode())
            except NotImplementedError as e:
                if not self._replied:
                    self._reply(501, str(e).encode())
            except Exception:
                # a server fault (a kernel that failed to launch, too): no
                # internal detail on the wire
                if not self._replied:
                    self._reply(500, b"internal error")

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service  # exposed for tests / embedding callers

    # without a periodic reaper the TTL is checked only on stream requests,
    # and abandoned sessions would hold their slots once traffic stops
    reap_stop = threading.Event()

    def reap_loop():
        while not reap_stop.wait(max(1.0, min(stream_idle_s / 4, 60.0))):
            reap_streams()

    threading.Thread(target=reap_loop, daemon=True, name="avsi-reaper").start()
    base_shutdown = server.shutdown

    def shutdown():
        reap_stop.set()
        base_shutdown()

    server.shutdown = shutdown
    print(f"avsi_torch inpainting service on http://{host}:{server.server_address[1]} "
          f"(model {service.config['model']}, {service.device})")
    return server
