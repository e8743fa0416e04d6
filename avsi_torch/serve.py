"""Serving: a warm-model inpainting service (port of `avsi/serve.py`).

`InpaintingService` loads a checkpoint directory once and runs the
inference step at a fixed micro-batch, padding partial batches exactly as
the reference does (`avsi/serve.py:216-285`).  `serve()` wraps it in a
stdlib HTTP server:

  POST /enhance   body: raw little-endian payload
      [int32 n_samples][int32 t_frames]
      [n_samples x int16 wave][t_frames x uint8 frame_mask]
      (+ [emb_dim x float32 speaker embedding] for blstm-*-emb models)
  -> 200, body: n_samples x int16 enhanced wave
  GET /healthz    -> 200 "ok"
  GET /info       -> model/geometry/weights_version/device JSON

`/stream/*`, `/reload` and `/metrics` answer 501: live streaming (the
LC-BLSTM window kernel), hot reload and the metrics exposition wait for a
later slice.
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from avsi_torch.device import resolve_device
from avsi_torch.infer.inpaint import load_model_bundle, make_infer_step


class InpaintingService:
    def __init__(
        self,
        model_path: str,
        micro_batch: int = 8,
        phase_recon: str = "gl",
        gl_iters: int = 30,
        norm: bool = True,
        lstm_impl: str = "auto",
        device=None,
    ):
        self.device = resolve_device(device)
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
        self._step = make_infer_step(
            model, self.config, stats, False, phase_recon, gl_iters, device=self.device
        )
        self._lock = threading.Lock()
        self.weights_version = 0
        self.n_utterances = 0
        self.n_device_steps = 0
        self.warmup()

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


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8571, **kw):
    """Build the service and an HTTP server bound to (host, port); port=0
    takes a free one.  The caller runs `serve_forever()` and `shutdown()`."""
    service = InpaintingService(model_path, **kw)

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
            elif self.path == "/metrics":
                self._reply(501, b"/metrics is not ported yet")
            else:
                self._reply(404, b"not found")

        def do_POST(self):
            self._replied = False
            if self.path.startswith("/stream/") or self.path == "/reload":
                self._reply(501, f"{self.path} is not ported yet".encode())
                return
            if self.path != "/enhance":
                self._reply(404, b"not found")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                wave, mask, emb = _parse_enhance(self.rfile.read(n), service)
                enhanced = service.enhance(wave, mask, emb)
                self._reply(200, enhanced.astype("<i2").tobytes())
            except (ValueError, struct.error) as e:
                if not self._replied:  # malformed request
                    self._reply(400, str(e).encode())
            except Exception:
                # a server fault: opaque 500, no internal detail on the wire
                if not self._replied:
                    self._reply(500, b"internal error")

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service  # exposed for tests / embedding callers
    print(f"avsi_torch inpainting service on http://{host}:{server.server_address[1]} "
          f"(model {service.config['model']}, {service.device})")
    return server
