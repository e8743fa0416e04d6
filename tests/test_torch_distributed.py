"""The port's multi-process layer (`avsi_torch.parallel.distributed` and
`train()` across ranks) on the CPU, held against the reference's
(`avsi.parallel.distributed`, two `jax.distributed` children as in
tests/test_distributed.py).

The port's ranks are child processes joined through `torch.distributed`
with the Gloo backend on a free localhost port; every child gets a
`timeout` and is killed when the test fails.  Training runs `a-blstm`
[16, 16] on the reference's fixture (6 training utterances, global batch 2,
one per rank) from one checkpoint of the reference's init, so both packages
start from the same weights.  The optimizer is momentum SGD where the
reference's own test takes Adam: Adam's g / (|g| + eps) turns the roundoff
of a near-zero gradient into a step of lr (up to 1e-4 apart after 6 steps
here), and a resume from `sinet` restarts its moments, which spreads that
over every leaf; momentum keeps the packages at roundoff.  Tolerances: the best validation loss rtol
1e-5 and `sinet` atol 2e-5 against the reference (the f32 tolerance of
tests/test_torch_train.py's train() comparison); the ranks' summaries
equal; the tensor-parallel run against the plain two-rank run atol 1e-4.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from avsi import config as jconfig
from avsi.data import fixture
from avsi.data import stats as jstats
from avsi.models import registry as jregistry
from avsi.parallel import distributed as jdist
from avsi.train import checkpoints as jckpt
from avsi_torch.parallel import distributed as tdist

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    """The children's environment: the repo importable, two threads each
    (ranks on one host that each spin a thread per core wait on each
    other's spinning)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _run_ranks(argvs, env, on_start=None, timeout=CHILD_TIMEOUT) -> list[str]:
    """Start one child per argv, wait for all; kill every child when one
    fails or the time runs out.  Returns their stdout."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    watcher = None
    if on_start is not None:
        watcher = threading.Thread(target=on_start, args=(procs,), daemon=True)
        watcher.start()
    outs = []
    try:
        deadline = time.time() + timeout
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            if p.returncode != 0:
                raise AssertionError(f"rank exited {p.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if watcher is not None:
            watcher.join(timeout=5)
    return outs


# ------------------------------------------------------------------ unit


@pytest.mark.parametrize("n_files,count", [(10, 3), (10, 4), (7, 2), (3, 3), (5, 1)])
def test_shard_files_matches_reference(n_files, count):
    files = [f"data_{i:03d}.tfrecord" for i in range(n_files)][::-1]
    for index in range(count):
        assert tdist.shard_files(files, index, count) == jdist.shard_files(files, index, count)
    assert tdist.shard_files(files) == sorted(files)  # outside a job: everything


def test_shard_files_rejects_empty_shards_like_reference():
    with pytest.raises(ValueError, match="empty shard") as want:
        jdist.shard_files(["a", "b", "c"], process_index=3, process_count=4)
    with pytest.raises(ValueError, match="empty shard") as got:
        tdist.shard_files(["a", "b", "c"], process_index=3, process_count=4)
    assert str(got.value) == str(want.value)


def test_initialize_arguments_and_the_nccl_guard(monkeypatch):
    """Arguments from torchrun's environment; `gloo` on the CPU; NCCL with
    more ranks on this host than GPUs raises naming backend='gloo', before
    any process group is made; outside a job the reductions are identities."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    with pytest.raises(ValueError, match="coordinator address"):
        tdist.initialize(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    tdist.initialize(device="cpu", timeout_s=5)
    (args, kw), = calls
    assert args == ("gloo",) and kw["init_method"] == "tcp://127.0.0.1:29511"
    assert kw["world_size"] == 2 and kw["rank"] == 1 and kw["timeout"].total_seconds() == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        tdist.initialize("127.0.0.1:1", 2, 0)
    assert len(calls) == 1
    assert not tdist.active() and tdist.world_size() == 1 and tdist.is_main()
    np.testing.assert_array_equal(tdist.gather_hosts([1.0, 2.0]), [[1.0, 2.0]])
    np.testing.assert_array_equal(tdist.allreduce_sum([1.0, 2.0]), [1.0, 2.0])
    tdist.assert_uniform("anything", "this rank's")


SMOKE = r"""
import json, sys
import numpy as np, torch
from avsi_torch.parallel import distributed as dist
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu", timeout_s=120)
res = {"active": dist.active(), "world": dist.world_size(), "main": dist.is_main(),
       "files": dist.shard_files([f"f{i}" for i in range(6)]),
       "gathered": dist.gather_hosts([pid, 10.0 + pid]).tolist(),
       "summed": dist.allreduce_sum([1.0, pid]).tolist()}
dist.assert_uniform("same payload", "x")
try:
    dist.assert_uniform("batch compaction signature", f"rank {pid}")
    res["mismatch"] = None
except AssertionError as e:
    res["mismatch"] = str(e)
t = [torch.full((3,), pid + 1.0), torch.full((2, 2), 10.0 * (pid + 1))]
dist.all_sum_tensors(t)
res["tensors"] = [x.tolist() for x in t]
x = torch.tensor([pid + 1.0], requires_grad=True)
y = dist.all_sum_differentiable(x * x)
(y * (pid + 1)).sum().backward()
res["value"], res["grad"] = float(y), float(x.grad)
json.dump(res, open(out, "w"))
"""


def test_two_rank_smoke(tmp_path):
    """Two Gloo ranks: file shards, gather_hosts, allreduce_sum,
    assert_uniform raising on a mismatch on both ranks, the coalesced
    all_sum of tensors and the differentiable sum's gradient."""
    script = tmp_path / "smoke.py"
    script.write_text(SMOKE)
    port = _free_port()
    outs = [str(tmp_path / f"r{i}.json") for i in range(2)]
    _run_ranks([[sys.executable, str(script), str(i), str(port), outs[i]] for i in range(2)],
               _env(), timeout=120)
    res = [json.load(open(o)) for o in outs]
    assert sorted(res[0]["files"] + res[1]["files"]) == [f"f{i}" for i in range(6)]
    assert res[0]["files"] == jdist.shard_files([f"f{i}" for i in range(6)], 0, 2)
    for i, r in enumerate(res):
        assert r["active"] and r["world"] == 2 and r["main"] == (i == 0)
        assert r["gathered"] == [[0.0, 10.0], [1.0, 11.0]]
        assert r["summed"] == [2.0, 1.0]
        assert r["mismatch"] and "batch compaction signature differs across hosts" in r["mismatch"]
        assert r["tensors"] == [[3.0] * 3, [[30.0, 30.0], [30.0, 30.0]]]
        # y = 1 + 4; dL/dy summed over the ranks (1 + 2) times 2x
        assert r["value"] == 5.0 and r["grad"] == 3.0 * 2 * (i + 1)


# ------------------------------------------------------------------ train()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's fixture (6 training, 2 validation utterances of 600
    ms), its stats, and a checkpoint of the reference's init."""
    d = tmp_path_factory.mktemp("dist")
    dest = str(d / "fix")
    paths = fixture.make_fixture(dest, n_speakers=1, n_samples=6, audio_len_ms=600,
                                 gap_ms=150.0, gap_std_ms=20.0)
    prefix = os.path.join(dest, "spec_norm")
    jstats.compute_mean_std_features(paths["training-set"], "target", prefix, feat_type="spec",
                                     window_size=24, step_size=12, n_fft=512)
    common = {
        "model": "a-blstm", "audio_feat_dim": 257, "video_feat_dim": 136,
        "audio_len": 9600, "batch_size": 2, "net_dim": [16, 16],
        "integration_layer": 0, "dropout_rate": 0.0, "max_n_epochs": 2,
        "n_earlystop_epochs": 5, "optimizer_type": "momentum",
        "starter_learning_rate": 0.05, "lr_decay": 1.0, "l2": 0.0, "tb_media": 0,
        "root_folder": paths["tfrecords"],
        "audio_feat_mean": prefix + "_mean.npy", "audio_feat_std": prefix + "_std.npy",
    }
    params = jregistry.get_model("a-blstm").init(
        jax.random.PRNGKey(0), jconfig.check_trainconfiguration(dict(common, exp_folder=dest)))
    jckpt.save_checkpoint(dest, "start", params)
    common["model_ckp"] = os.path.join(dest, "start")
    return {"dir": d, "common": common}


def _config(corpus, name, **kw) -> str:
    path = str(corpus["dir"] / f"{name}.config")
    jconfig.save_configfile(dict(corpus["common"], exp_folder=str(corpus["dir"] / name), **kw),
                            path)
    return path


PORT_CHILD = r"""
import json, sys
import numpy as np
from avsi_torch.parallel import distributed as dist
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
runs = json.loads(sys.argv[4])
writes = []
save = np.savez
np.savez = lambda path, *a, **k: (writes.append(str(path)), save(path, *a, **k))
dist.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu", timeout_s=120)
from avsi_torch.train.loop import train
res = {}
for name, cfg, devices in runs:
    s = train(cfg, device="cpu", devices=devices)
    res[name] = {k: s[k] for k in ("best_val", "best_epoch", "steps", "preempted")}
res["writes"] = writes
json.dump(res, open(out, "w"))
"""

JAX_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
pid, port, cfg, cfg_resume, out = sys.argv[1:6]
from avsi.parallel import distributed as dist
dist.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=int(pid))
from avsi.train.loop import train
s1 = train(cfg)
s2 = train(cfg_resume)
json.dump({"best_val": s1["best_val"], "steps": s1["steps"],
           "resume_best_val": s2["best_val"]}, open(out, "w"))
"""


def _sinet(exp) -> dict:
    with np.load(str(exp / "netmodel" / "sinet.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def two_rank_runs(corpus, tmp_path_factory):
    """Three jobs of two ranks at once, each on its own port: the port's
    `train()` (2 epochs, then a 1-epoch resume from rank 0's `sinet`, then
    the 2-epoch run again with `num_model_shards = 2` over two CPU devices
    per rank), the reference's two `jax.distributed` processes (train and
    resume), and the port's command line on the first config."""
    tmp = tmp_path_factory.mktemp("ranks")
    d = corpus["dir"]
    cfg1 = _config(corpus, "port")
    cfg2 = _config(corpus, "port_resume", max_n_epochs=1,
                   model_ckp=str(d / "port" / "netmodel" / "sinet"))
    cfg_tp = _config(corpus, "port_tp", num_model_shards=2)
    j1 = _config(corpus, "jax")
    j2 = _config(corpus, "jax_resume", max_n_epochs=1,
                 model_ckp=str(d / "jax" / "netmodel" / "sinet"))
    cli_cfg = _config(corpus, "cli")
    runs = json.dumps([["train", cfg1, None], ["resume", cfg2, None],
                       ["tp", cfg_tp, ["cpu", "cpu"]]])
    script, jscript = tmp / "port_child.py", tmp / "jax_child.py"
    script.write_text(PORT_CHILD)
    jscript.write_text(JAX_CHILD)
    port, jport, cport = _free_port(), _free_port(), _free_port()
    outs = [str(tmp / f"p{i}.json") for i in range(2)]
    jouts = [str(tmp / f"j{i}.json") for i in range(2)]
    argvs = [[sys.executable, str(script), str(i), str(port), outs[i], runs] for i in range(2)]
    argvs += [[sys.executable, str(jscript), str(i), str(jport), j1, j2, jouts[i]]
              for i in range(2)]
    argvs += [[sys.executable, "-m", "avsi_torch", "--device", "cpu", "training", "--config",
               cli_cfg, "--coordinator", f"127.0.0.1:{cport}", "--num_processes", "2",
               "--process_id", str(i)] for i in range(2)]
    # the reference's children need a one-device XLA and no JAX_PLATFORMS;
    # the port's ignore both
    _run_ranks(argvs, _env(XLA_FLAGS="--xla_force_host_platform_device_count=1"))
    return {"port": [json.load(open(o)) for o in outs],
            "jax": [json.load(open(o)) for o in jouts]}


def test_two_rank_train_matches_reference(corpus, two_rank_runs):
    """Two ranks train 2 epochs, then resume 1 epoch from rank 0's `sinet`,
    as the reference's two processes do on the same corpus and config:
    the ranks' summaries equal, 3 steps an epoch, best_val rtol 1e-5 and
    `sinet` atol 2e-5 against the reference's, in both legs; only rank 0
    wrote (one log, one event file, no archive from rank 1)."""
    res, ref = two_rank_runs["port"], two_rank_runs["jax"]
    assert ref[0] == ref[1]
    for key in ("train", "resume"):
        assert res[0][key] == res[1][key], key
    assert res[0]["train"]["steps"] == ref[0]["steps"] == 6
    np.testing.assert_allclose(res[0]["train"]["best_val"], ref[0]["best_val"], rtol=1e-5)
    np.testing.assert_allclose(res[0]["resume"]["best_val"], ref[0]["resume_best_val"], rtol=1e-5)
    d = corpus["dir"]
    for mine, theirs in (("port", "jax"), ("port_resume", "jax_resume")):
        got, want = _sinet(d / mine), _sinet(d / theirs)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=2e-5, err_msg=f"{mine} {key}")
    assert res[1]["writes"] == [] and res[0]["writes"]
    for exp in ("port", "port_resume"):
        log = (d / exp / "training_log.txt").read_text()
        assert log.count("# done") == 1 and "processes=2" in log, exp
        assert len(os.listdir(d / exp / "tb")) == 1, exp


def test_two_ranks_with_a_model_axis(corpus, two_rank_runs):
    """Two ranks x a 2-device CPU model axis: the ranks agree, `sinet`
    holds whole leaves (4H gate columns) within atol 1e-4 of the plain
    two-rank run."""
    res = two_rank_runs["port"]
    assert res[0]["tp"] == res[1]["tp"] and res[0]["tp"]["steps"] == 6
    d = corpus["dir"]
    tp, plain = _sinet(d / "port_tp"), _sinet(d / "port")
    assert sorted(tp) == sorted(plain)
    for key in plain:
        assert tp[key].shape == plain[key].shape, key
        np.testing.assert_allclose(tp[key], plain[key], atol=1e-4, err_msg=key)
    assert tp["blstm/0/wx"].shape[-1] == 4 * 16
    assert "mesh=Mesh(data=1xmodel=2" in (d / "port_tp" / "training_log.txt").read_text()


def test_cli_two_ranks(corpus, two_rank_runs):
    """`python -m avsi_torch --device cpu training --coordinator ...
    --num_processes 2 --process_id i` on two CPU ranks: one log, and
    `sinet` atol 2e-5 of the reference's two-process run."""
    d = corpus["dir"]
    log = (d / "cli" / "training_log.txt").read_text()
    assert log.count("# done") == 1 and "processes=2" in log
    got, want = _sinet(d / "cli"), _sinet(d / "jax")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-5, err_msg=key)


def test_two_rank_preemption_agreement(corpus, tmp_path):
    """SIGTERM to rank 1 only, once rank 0 logged its first epoch: the
    ranks agree on the flag and stop at the same step, both preempted, and
    rank 0 wrote the full resume checkpoint and the SIGTERM line."""
    cfg = _config(corpus, "pre", max_n_epochs=200, n_earlystop_epochs=200)
    script = tmp_path / "port_child.py"
    script.write_text(PORT_CHILD)
    port = _free_port()
    outs = [str(tmp_path / f"r{i}.json") for i in range(2)]
    log = corpus["dir"] / "pre" / "training_log.txt"

    def term_rank_1(procs):
        deadline = time.time() + CHILD_TIMEOUT
        while time.time() < deadline and all(p.poll() is None for p in procs):
            if log.is_file() and "epoch 0\t" in log.read_text():
                procs[1].send_signal(signal.SIGTERM)
                return
            time.sleep(0.05)

    runs = json.dumps([["pre", cfg, None]])
    _run_ranks([[sys.executable, str(script), str(i), str(port), outs[i], runs]
                for i in range(2)], _env(), on_start=term_rank_1)
    res = [json.load(open(o))["pre"] for o in outs]
    assert res[0] == res[1]
    assert res[0]["preempted"] is True and 0 < res[0]["steps"] < 200 * 3
    net = corpus["dir"] / "pre" / "netmodel"
    assert (net / "ckpt.npz").is_file() and (net / "ckpt.opt.npz").is_file()
    assert "SIGTERM: preemption checkpoint" in log.read_text()
