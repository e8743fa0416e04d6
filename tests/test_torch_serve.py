"""The port's service on the CPU against the JAX service on one bundle,
plus HTTP round trips: /enhance, and live stream sessions held against
the same stream run in process.

Both services load the same checkpoint directory (config.txt, the stats
.npy files and a `sinet.npz` written by the reference).  The JAX service
runs `lstm_impl="pallas"` (the Pallas kernels in interpret mode off the
TPU); the port's runs `device="cpu"`, the plain versions of its kernels.
Tolerance: the int16 Griffin-Lim waveforms agree to relative L2 <= 1e-3;
a stream served over HTTP is bit for bit the in-process stream, and so is
every output that a /reload must leave as a fresh service on the same
checkpoint would give it.
"""

import json
import os
import struct
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from avsi import config as jconfig
from avsi import flagship as jflagship
from avsi.models import registry as jregistry
from avsi.serve import InpaintingService as JaxService
from avsi.train import checkpoints as jckpt
from avsi_torch.serve import InpaintingService, serve

AUDIO_LEN = 4800
T_FRAMES = 25


def _write_bundle(d, seed=5, stats_seed=0, net_dim=(16, 16, 16), num_asr_labels=33):
    """A checkpoint directory written by the reference: config.txt, random
    stats from `stats_seed`, and `sinet.npz` from the reference's init."""
    os.makedirs(d, exist_ok=True)
    cfg = jflagship.flagship_config(net_dim=list(net_dim), audio_len=AUDIO_LEN)
    rng = np.random.RandomState(stats_seed)
    np.save(os.path.join(d, "audio_features_mean.npy"),
            rng.uniform(0.0, 5.0, 257).astype(np.float32))
    np.save(os.path.join(d, "audio_features_std.npy"),
            rng.uniform(0.5, 2.0, 257).astype(np.float32))
    cfg.update(
        num_asr_labels=num_asr_labels,  # the checker adds the CTC blank
        root_folder=d, exp_folder=d,
        audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
        audio_feat_std=os.path.join(d, "audio_features_std.npy"),
    )
    jconfig.save_configfile(cfg, os.path.join(d, "config.txt"))
    checked = jconfig.check_trainconfiguration(cfg)
    params = jregistry.get_model(cfg["model"]).init(jax.random.PRNGKey(seed), checked)
    jckpt.save_checkpoint(d, "sinet", params)
    return d


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return _write_bundle(str(tmp_path_factory.mktemp("bundle")))


def _requests(n, seed=0):
    rng = np.random.RandomState(seed)
    waves = (3000 * rng.randn(n, AUDIO_LEN)).astype(np.float32)
    masks = np.ones((n, T_FRAMES), np.float32)
    for i in range(n):
        start = 3 + 4 * i
        masks[i, start : start + 8] = 0.0
    return waves, masks


def test_enhance_batch_matches_reference(bundle):
    waves, masks = _requests(3)  # 3 utterances over a micro-batch of 2
    ref = JaxService(bundle, micro_batch=2, gl_iters=3, lstm_impl="pallas")
    svc = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu")
    assert svc.config["lstm_impl"] == "plain"
    want = ref.enhance_batch(waves, masks)
    got = svc.enhance_batch(waves, masks)
    assert got.dtype == np.int16 and got.shape == want.shape == (3, AUDIO_LEN)
    diff = got.astype(np.float64) - want
    assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(want.astype(np.float64))
    assert svc.n_device_steps == 2 and svc.n_utterances == 3
    np.testing.assert_array_equal(svc.enhance(waves[1], masks[1]), got[1])


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req) as r:
        return r.read()


def test_http_round_trip(bundle):
    server = serve(bundle, port=0, micro_batch=2, gl_iters=3, device="cpu")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info") as r:
            info = json.loads(r.read())
        assert info["model"] == "av-blstm-ssnn-ctc" and info["t_frames"] == T_FRAMES

        waves, masks = _requests(1, seed=1)
        wave = waves[0].astype(np.int16)
        body = (struct.pack("<ii", AUDIO_LEN, T_FRAMES) + wave.tobytes()
                + masks[0].astype(np.uint8).tobytes())
        out = np.frombuffer(_post(port, "/enhance", body), "<i2")
        want = server.service.enhance(wave.astype(np.float32), masks[0])
        np.testing.assert_array_equal(out, want)
        assert np.abs(out).max() > 0

        with pytest.raises(urllib.error.HTTPError) as exc:  # malformed
            _post(port, "/enhance", struct.pack("<ii", 123, T_FRAMES))
        assert exc.value.code == 400
        # a bare /reload reloads the served checkpoint: same output
        assert json.loads(_post(port, "/reload", b"")) == {"weights_version": 1}
        np.testing.assert_array_equal(np.frombuffer(_post(port, "/enhance", body), "<i2"), out)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            metrics = _metrics(r.read())
        assert metrics["avsi_utterances_enhanced_total"] == 3
        assert metrics["avsi_weights_version"] == 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _metrics(text: bytes) -> dict:
    return {k: float(v) for k, v in (line.split() for line in text.decode().splitlines()
                                     if not line.startswith("#"))}


class _Server:
    """serve() on a free port in a thread, shut down on exit."""

    def __init__(self, bundle, **kw):
        self.server = serve(bundle, port=0, micro_batch=2, gl_iters=3, device="cpu", **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def post(self, path, body=b""):
        return _post(self.port, path, body)

    def status(self, path, body=b""):
        """The HTTP error code of a request that must fail, and its body."""
        with pytest.raises(urllib.error.HTTPError) as exc:
            self.post(path, body)
        return exc.value.code, exc.value.read()

    def metrics(self):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/metrics") as r:
            return _metrics(r.read())


def _push_body(wave, mask, video):
    return (struct.pack("<ii", len(wave), len(mask)) + wave.astype("<i2").tobytes()
            + mask.astype(np.uint8).tobytes() + video.astype("<f2").tobytes())


def test_stream_session_matches_in_process_stream(bundle):
    """open (transcript=1, C=5, L=7) -> 1,536-sample pushes with f16 video
    rows -> close; the framed replies hold the in-process stream's int16
    samples and its transcript, bit for bit."""
    rng = np.random.RandomState(2)
    waves, masks = _requests(1, seed=2)
    wave, mask = waves[0].astype(np.int16), masks[0]
    video = rng.randn(T_FRAMES, 136).astype(np.float16)
    with _Server(bundle) as srv:
        info = json.loads(srv.post("/stream/open?chunk=5&look=7&transcript=1"))
        assert (info["chunk_frames"], info["lookahead_frames"], info["video_feat_dim"],
                info["frame_step"], info["transcript"]) == (5, 7, 136, 192, True)
        samples, ids, fed, pushes = [], [], 0, 0
        for lo in range(0, AUDIO_LEN, 1536):
            part = wave[lo : lo + 1536]
            n_frames = min(max(0, (lo + len(part) - 384) // 192 + 1), T_FRAMES)
            if lo + 1536 >= AUDIO_LEN:
                n_frames = T_FRAMES  # the last push carries the pad_end rows
            replies = [srv.post(f"/stream/{info['id']}",
                                _push_body(part, mask[fed:n_frames], video[fed:n_frames]))]
            fed, pushes = n_frames, pushes + 1
            if lo + 1536 >= AUDIO_LEN:
                replies.append(srv.post(f"/stream/{info['id']}/close"))
            for body in replies:
                (n,) = struct.unpack_from("<i", body, 0)
                samples.append(np.frombuffer(body, "<i2", n, 4))
                ids += np.frombuffer(body, "<i2", offset=4 + 2 * n).tolist()
        metrics = srv.metrics()
        assert metrics["avsi_stream_pushes_total"] == pushes == 4
        assert metrics["avsi_live_streams"] == 0
        code, _ = srv.status(f"/stream/{info['id']}", _push_body(part[:0], mask[:0], video[:0]))
        assert code == 404  # closed sessions are gone

        inp = srv.server.service.open_stream(5, 7, transcript=True)
        from avsi_torch.infer.streaming import stream_utterance
        want = stream_utterance(inp, wave.astype(np.float32), mask,
                                video.astype(np.float32))
    got = np.concatenate(samples)
    np.testing.assert_array_equal(got, np.clip(want, -32768, 32767).astype(np.int16))
    assert len(got) == AUDIO_LEN and np.abs(got).max() > 0
    assert ids == inp.transcript


def test_stream_sessions_limits_and_errors(bundle):
    """429 at max_streams, 404 for an unknown id, the idle reaper, the
    /metrics counters, 400 for bad options; atten=0.5 opens a stream with
    the gap attenuation (trust and ramp at their defaults)."""
    with _Server(bundle, max_streams=2, stream_idle_s=1.0) as srv:
        atten = json.loads(srv.post("/stream/open?atten=0.5"))
        assert atten["gap_atten"] == [0.5, 34, 16]
        assert srv.post(f"/stream/{atten['id']}/close") == b""  # nothing pushed
        assert srv.status("/stream/open?atten=1.5")[0] == 400
        assert srv.status("/stream/open?chunk=0")[0] == 400
        first = json.loads(srv.post("/stream/open"))
        assert (first["chunk_frames"], first["lookahead_frames"]) == (8, 16)
        second = json.loads(srv.post("/stream/open?chunk=4&look=0&fill=1"))
        assert srv.metrics()["avsi_live_streams"] == 2
        assert srv.status("/stream/open")[0] == 429
        assert srv.status("/stream/nosuchid", b"")[0] == 404
        body = _push_body(np.zeros(960, np.int16), np.ones(4), np.zeros((4, 136)))
        assert srv.post(f"/stream/{second['id']}", body)  # 4 frames: one C=4, L=0 window
        assert srv.metrics()["avsi_stream_pushes_total"] == 1
        assert srv.status(f"/stream/{first['id']}", b"\x01")[0] == 400  # short header
        time.sleep(1.5)  # both sessions idle past the TTL
        assert srv.status(f"/stream/{first['id']}", body)[0] == 404
        assert srv.metrics()["avsi_live_streams"] == 0
        assert json.loads(srv.post("/stream/open?atten=1"))["gap_atten"] is None  # off


LEVERS = {"passthrough": True, "gap_atten": {"alpha": 0.25, "trust": 2, "ramp": 3}}


def test_levers_service_matches_reference(bundle):
    """A service started with both deployment levers: /enhance against the
    reference's service with the same options (relative L2 <= 1e-3), and
    its streams take them (their causal twins) by default."""
    waves, masks = _requests(3, seed=3)
    ref = JaxService(bundle, micro_batch=2, gl_iters=3, lstm_impl="pallas", **LEVERS)
    svc = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu", **LEVERS)
    want = ref.enhance_batch(waves, masks)
    got = svc.enhance_batch(waves, masks)
    diff = got.astype(np.float64) - want
    assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(want.astype(np.float64))
    plain = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu")
    assert np.abs(plain.enhance_batch(waves, masks).astype(np.float64) - got).max() > 0
    inp = svc.open_stream(5, 7)
    assert inp.passthrough and inp.gap_atten == (0.25, 2, 3)
    assert svc.open_stream(5, 7, gap_atten=None).gap_atten is None


def test_stream_atten_session_matches_in_process_stream(bundle):
    """/stream/open?atten=0.5&atten_trust=2&atten_ramp=3 serves, bit for bit,
    the in-process stream with that gap attenuation, which differs from the
    stream without it."""
    rng = np.random.RandomState(4)
    waves, masks = _requests(1, seed=4)
    wave, mask = waves[0].astype(np.int16), masks[0]
    video = rng.randn(T_FRAMES, 136).astype(np.float16)
    with _Server(bundle) as srv:
        info = json.loads(srv.post("/stream/open?chunk=4&look=2&atten=0.5&atten_trust=2"
                                   "&atten_ramp=3"))
        assert info["gap_atten"] == [0.5, 2, 3]
        body = _push_body(wave, mask, video)
        got = np.concatenate([np.frombuffer(srv.post(f"/stream/{info['id']}", body), "<i2"),
                              np.frombuffer(srv.post(f"/stream/{info['id']}/close"), "<i2")])
        from avsi_torch.infer.streaming import stream_utterance
        service = srv.server.service
        args = (wave.astype(np.float32), mask, video.astype(np.float32))
        want = stream_utterance(service.open_stream(4, 2, gap_atten={"alpha": 0.5, "trust": 2,
                                                                      "ramp": 3}), *args)
        off = stream_utterance(service.open_stream(4, 2), *args)
    np.testing.assert_array_equal(got, np.clip(want, -32768, 32767).astype(np.int16))
    assert np.abs(want - off).max() > 0


def test_reload(bundle, tmp_path):
    """reload to a checkpoint of another seed and other stats: version 1,
    /enhance then equals a fresh service on it (the step was rebuilt for
    the stats), a stream opened before the reload finishes equal to a
    stream of the old checkpoint, and a bare reload reloads the new path.
    Over HTTP: another geometry and another parameter tree answer 400, a
    missing path 400, and serving goes on."""
    other = _write_bundle(str(tmp_path / "other"), seed=9, stats_seed=1)
    wide = _write_bundle(str(tmp_path / "wide"), net_dim=(16, 16, 24))
    tree = _write_bundle(str(tmp_path / "tree"), num_asr_labels=20)
    waves, masks = _requests(2, seed=5)
    video = np.random.RandomState(5).randn(T_FRAMES, 136).astype(np.float32)
    svc = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu")
    old_stream = svc.open_stream(5, 7)
    mid = old_stream.push(waves[0][:2400], masks[0][:11], video[:11])
    assert svc.reload(other) == 1 and svc.weights_version == 1
    fresh_new = InpaintingService(other, micro_batch=2, gl_iters=3, device="cpu")
    np.testing.assert_array_equal(svc.enhance_batch(waves, masks),
                                  fresh_new.enhance_batch(waves, masks))
    rest = old_stream.push(waves[0][2400:], masks[0][11:], video[11:])
    old_out = np.concatenate([mid, rest, old_stream.flush()])
    fresh_old = InpaintingService(bundle, micro_batch=2, gl_iters=3, device="cpu")
    from avsi_torch.infer.streaming import stream_utterance
    args = (waves[0], masks[0], video)
    np.testing.assert_array_equal(old_out, stream_utterance(fresh_old.open_stream(5, 7), *args))
    new_out = stream_utterance(svc.open_stream(5, 7), *args)
    np.testing.assert_array_equal(new_out, stream_utterance(fresh_new.open_stream(5, 7), *args))
    assert np.abs(new_out - old_out).max() > 0  # the two checkpoints differ
    assert svc.reload() == 2 and svc._model_path == other  # a bare reload: the new path
    np.testing.assert_array_equal(svc.enhance_batch(waves, masks),
                                  fresh_new.enhance_batch(waves, masks))

    with _Server(bundle) as srv:
        code, body = srv.status("/reload", wide.encode())
        assert code == 400 and b"net_dim" in body
        code, body = srv.status("/reload", tree.encode())
        assert code == 400 and b"params-tree" in body
        assert srv.status("/reload", str(tmp_path / "nowhere").encode())[0] == 400
        assert json.loads(srv.post("/reload", other.encode())) == {"weights_version": 1}
        assert srv.metrics()["avsi_weights_version"] == 1
        wave = waves[1].astype(np.int16)
        body = (struct.pack("<ii", AUDIO_LEN, T_FRAMES) + wave.tobytes()
                + masks[1].astype(np.uint8).tobytes())
        np.testing.assert_array_equal(np.frombuffer(srv.post("/enhance", body), "<i2"),
                                      fresh_new.enhance(wave.astype(np.float32), masks[1]))
