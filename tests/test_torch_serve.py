"""The port's service on the CPU against the JAX service on one bundle,
plus one HTTP round trip.

Both services load the same checkpoint directory (config.txt, the stats
.npy files and a `sinet.npz` written by the reference).  The JAX service
runs `lstm_impl="pallas"` (the Pallas kernels in interpret mode off the
TPU); the port's runs `device="cpu"`, the plain versions of its kernels.
Tolerance: the int16 Griffin-Lim waveforms agree to relative L2 <= 1e-3.
"""

import json
import os
import struct
import threading
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


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bundle"))
    cfg = jflagship.flagship_config(net_dim=[16, 16, 16], audio_len=AUDIO_LEN)
    rng = np.random.RandomState(0)
    np.save(os.path.join(d, "audio_features_mean.npy"),
            rng.uniform(0.0, 5.0, 257).astype(np.float32))
    np.save(os.path.join(d, "audio_features_std.npy"),
            rng.uniform(0.5, 2.0, 257).astype(np.float32))
    cfg.update(
        num_asr_labels=33,  # the checker adds the CTC blank
        root_folder=d, exp_folder=d,
        audio_feat_mean=os.path.join(d, "audio_features_mean.npy"),
        audio_feat_std=os.path.join(d, "audio_features_std.npy"),
    )
    jconfig.save_configfile(cfg, os.path.join(d, "config.txt"))
    checked = jconfig.check_trainconfiguration(cfg)
    params = jregistry.get_model(cfg["model"]).init(jax.random.PRNGKey(5), checked)
    jckpt.save_checkpoint(d, "sinet", params)
    return d


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
        for path in ("/stream/open", "/reload"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(port, path, b"")
            assert exc.value.code == 501
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics")
        assert exc.value.code == 501
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
