"""The port's command line (`python -m avsi_torch`), held against the JAX
package's (`avsi/cli.py`) on the CPU.

- The parsers: every subcommand of the reference, with the same options,
  short forms, defaults, choices (the port's `--lstm_impl` adds its own
  names to the reference's), types and `required`; the reference's argv,
  every option set, parses to the same values in both.
- The dispatch: each subcommand calls the port's function with the
  arguments the reference's command line gives the reference's, plus the
  top-level `--device` (functions replaced by recorders).
- The parallel surface reaches the parallel layer: `--coordinator`,
  `--num_processes`, `--process_id` and `--distributed` call
  `distributed.initialize` before training (mocked), `--data_shards`
  reaches `infer` and `serve`, a config's `num_model_shards` reaches
  `train()`; without a GPU a model subcommand fails unless `--device cpu`.
- A CPU end-to-end run (fixture, stats, training, export, masking,
  inference, evaluation) equal, file for file, to the port's direct calls;
  `export_tf` / `import_tf` round trip through TensorFlow.
"""

import argparse
import filecmp
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import avsi.cli as jcli
from avsi_torch import cli as tcli
from avsi_torch import config as tconfig
from helpers import tiny_config

REPO = Path(__file__).resolve().parent.parent


def _parser(mod) -> argparse.ArgumentParser:
    with mock.patch.object(argparse.ArgumentParser, "parse_args", lambda self, argv=None: self):
        return mod.parse_args([])


def _subparsers(parser) -> dict:
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _described(action) -> dict:
    return {"dest": action.dest, "options": action.option_strings, "default": action.default,
            "required": action.required, "type": action.type, "nargs": action.nargs,
            "const": action.const, "kind": type(action).__name__}


REF_SUBS = sorted(_subparsers(_parser(jcli)))


def test_every_reference_subcommand_is_there():
    assert sorted(_subparsers(_parser(tcli))) == REF_SUBS
    top = {a.dest: a for a in _parser(tcli)._actions}
    assert top["device"].default == "cuda" and top["device"].choices == ["cuda", "cpu"]


@pytest.mark.parametrize("name", REF_SUBS)
def test_subcommand_options_match_reference(name):
    """Same options in the same order, each with the reference's short form,
    default, type, nargs, const, required and choices."""
    ours = [a for a in _subparsers(_parser(tcli))[name]._actions if a.dest != "help"]
    theirs = [a for a in _subparsers(_parser(jcli))[name]._actions if a.dest != "help"]
    assert [_described(a) for a in ours] == [_described(a) for a in theirs]
    for a, b in zip(ours, theirs):
        if a.dest == "lstm_impl":
            assert set(b.choices) <= set(a.choices) and {"kernel", "plain"} <= set(a.choices)
        else:
            assert a.choices == b.choices, a.dest


def _full_argv(parser) -> list[str]:
    """Every option of a subparser set to a value other than its default."""
    argv = []
    for a in parser._actions:
        if a.dest == "help":
            continue
        flag = a.option_strings[-1]
        if isinstance(a, (argparse._StoreConstAction, argparse._StoreTrueAction)):
            argv.append(flag)
        elif a.choices:
            argv += [flag, [c for c in a.choices if c != a.default][-1]]
        elif a.nargs == "+":
            argv += [flag, "3", "4"] if a.type is int else [flag, "a", "b"]
        elif a.type is int:
            argv += [flag, "3"]
        elif a.type is float:
            argv += [flag, "0.5"]
        else:
            argv += [flag, f"/v/{a.dest}"]
    return argv


@pytest.mark.parametrize("name", REF_SUBS)
def test_reference_argv_parses_to_the_same_values(name):
    """The reference's argv, each option given by its long and by its short
    form, gives the same namespace in both parsers (the port's adds
    `device`)."""
    sub = _subparsers(_parser(jcli))[name]
    full = _full_argv(sub)
    to_short = {a.option_strings[-1]: a.option_strings[0] for a in sub._actions if a.option_strings}
    for argv in (full, [to_short.get(x, x) for x in full]):
        ours = vars(tcli.parse_args([name] + argv))
        theirs = vars(jcli.parse_args([name] + argv))
        assert ours.pop("device") == "cuda"
        assert ours == theirs
    assert vars(tcli.parse_args(["--device", "cpu", name] + full))["device"] == "cpu"


def _recorder(calls, key):
    def record(*args, **kw):
        calls[key] = (args, kw)
        return mock.MagicMock()
    return record


# subcommand -> (minimal argv, the module attribute each package's main
# calls, in `avsi.` / `avsi_torch.` form)
DISPATCH = {
    "dataset_generator": (["-ca", "/d", "-bs", "1", "2", "-d", "/o", "-num", "3"],
                          "data.generator.create_syn_dataset"),
    "audio_preprocessing": (["-a", "/d", "-p", "target", "-o", "/o/p", "-pe", "0.9", "-d", "2"],
                            "data.stats.compute_mean_std_features"),
    "video_preprocessing": (["-data", "/d", "-s", "1", "-v", "video", "-d", "lm", "-sp", "/p"],
                            "data.extract.save_face_landmarks"),
    "tfrecords_generator": (["-a", "/d", "-d", "/o", "-df", "/dict", "-emb", "-m", "var"],
                            "data.generator.create_dataset"),
    "tfrecords_grouping": (["-i", "/a", "-o", "/b", "-gs", "4", "-d"],
                           "data.generator.group_tfrecords"),
    "masking": (["-d", "/t", "-ad", "/a", "-op", "-bs", "4", "--feat_mean", "/m"],
                "infer.masking.mask_app"),
    "inference_model_generation": (["--config", "/c", "--input_model", "/i",
                                    "--output_model", "/o", "--model", "asr"],
                                   "infer.export.save_inference_model"),
    "inference": (["-d", "/t", "-ad", "/a", "-ef", "x", "-m", "/m", "-n", "-bs", "4",
                   "--passthrough", "--gap_atten", "0.5", "--lstm_impl", "scan"],
                  "infer.inpaint.infer"),
    "inference_asr": (["-d", "/t", "-ad", "/a", "-ef", "x", "-m", "/m", "-df", "/d", "-am",
                       "-bw", "0"], "infer.asr.infer"),
    "inference_siasr": (["-d", "/t", "-ad", "/a", "-ef", "x", "-ms", "/s", "-mr", "/r",
                         "-df", "/d", "-op", "--gl_iters", "5"], "infer.siasr.infer"),
    "evaluation": (["-ed", "/a", "-ef", "x", "-o", "o", "-me", "-w", "3", "--sdr"],
                   "eval.harness.speech_inpainting_eval"),
    "evaluation_asr": (["-ed", "/a", "-ef", "x", "-o", "o", "--pesq_mode", "wb"],
                       "eval.harness.speech_enhancement_eval"),
    "fixture": (["-d", "/o", "-num", "3", "1", "1", "-mk", "freeform"],
                "data.fixture.make_fixture"),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_calls_the_port_as_the_reference_calls_the_reference(name):
    import importlib

    argv, target = DISPATCH[name]
    mod_path, fn = target.rsplit(".", 1)
    calls = {}
    with mock.patch("avsi.utils.cache.enable"), \
            mock.patch.object(importlib.import_module("avsi." + mod_path), fn,
                              _recorder(calls, "theirs")), \
            mock.patch.object(importlib.import_module("avsi_torch." + mod_path), fn,
                              _recorder(calls, "ours")):
        jcli.main([name] + argv)
        tcli.main(["--device", "cpu", name] + argv)
    (args_t, kw_t), (args_j, kw_j) = calls["ours"], calls["theirs"]
    assert args_t == args_j
    device = kw_t.pop("device", None)
    on_device = {"masking", "inference", "inference_asr", "inference_siasr"}
    assert device == ("cpu" if name in on_device else None)
    assert kw_t == kw_j


@pytest.mark.parametrize("name,is_asr", [("training", False), ("training_asr", True)])
def test_training_runs_train_or_exit(name, is_asr):
    with mock.patch("avsi_torch.train.loop.train_or_exit") as run:
        tcli.main([name, "--config", "/c.config"])
    run.assert_called_once_with("/c.config", is_asr=is_asr, device="cuda")


@pytest.mark.parametrize("impl,want", [("auto", "auto"), ("pallas", "kernel"), ("scan", "scan"),
                                       ("plain", "plain")])
def test_serve_passes_the_port_names(impl, want):
    server = mock.MagicMock()
    with mock.patch("avsi_torch.serve.serve", return_value=server) as serve:
        tcli.main(["--device", "cpu", "serve", "-m", "/m", "--port", "0", "-bs", "4",
                   "--lstm_impl", impl])
    args, kw = serve.call_args
    assert args == ("/m", "127.0.0.1", 0)
    assert kw["lstm_impl"] == want and kw["device"] == "cpu" and kw["micro_batch"] == 4
    assert kw["data_shards"] == 0
    server.serve_forever.assert_called_once_with()


PARALLEL = [
    ["training", "--config", "/c", "--coordinator", "127.0.0.1:1"],
    ["training_asr", "--config", "/c", "--num_processes", "2"],
    ["training", "--config", "/c", "--process_id", "0"],
    ["training", "--config", "/c", "--distributed"],
    ["inference", "-d", "/t", "-ad", "/a", "-ef", "x", "-m", "/m", "--data_shards", "2"],
    ["serve", "-m", "/m", "--data_shards", "4"],
]


# what each case's flag must reach: (the function the port calls, the
# keyword or position it must carry, the value)
PARALLEL_REACHES = [
    ("init", (("127.0.0.1:1", None, None), {"device": "cuda"})),
    ("init", ((None, 2, None), {"device": "cuda"})),
    ("init", ((None, None, 0), {"device": "cuda"})),
    ("init", ((None, None, None), {"device": "cuda"})),
    ("infer", 2),
    ("serve", 4),
]


@pytest.mark.parametrize("argv,reaches", zip(PARALLEL, PARALLEL_REACHES),
                         ids=[a[0] + " " + a[-2] for a in PARALLEL])
def test_parallel_flags_are_refused(argv, reaches):
    """They parse as in the reference, then reach the parallel layer with
    their values: the distributed flags `distributed.initialize` before
    `train_or_exit`, `--data_shards` the `infer` or `serve` call."""
    assert jcli.parse_args(argv).subparser_name == argv[0]
    order = []
    server = mock.MagicMock()
    with mock.patch("avsi_torch.parallel.distributed.initialize",
                    side_effect=lambda *a, **k: order.append(("init", a, k))) as init, \
            mock.patch("avsi_torch.train.loop.train_or_exit",
                       side_effect=lambda *a, **k: order.append(("train", a, k))), \
            mock.patch("avsi_torch.infer.inpaint.infer") as infer, \
            mock.patch("avsi_torch.serve.serve", return_value=server) as serve:
        tcli.main(argv)
    kind, want = reaches
    if kind == "init":
        assert [o[0] for o in order] == ["init", "train"]
        init.assert_called_once_with(*want[0], **want[1])
        assert order[1][1] == ("/c",) and order[1][2]["is_asr"] == (argv[0] == "training_asr")
    elif kind == "infer":
        assert infer.call_args.kwargs["data_shards"] == want and not order
    else:
        assert serve.call_args.kwargs["data_shards"] == want and not order
        server.serve_forever.assert_called_once_with()


def _config_file(tmp_path, **kw):
    cfg = tiny_config(model="av-blstm-ssnn-ctc", net_dim=(8, 8), audio_len=16000,
                      root_folder=str(tmp_path / "tfr"), exp_folder=str(tmp_path / "exp"),
                      audio_feat_mean=str(tmp_path / "m.npy"),
                      audio_feat_std=str(tmp_path / "s.npy"), **kw)
    path = str(tmp_path / "m.config")
    tconfig.save_configfile(cfg, path)
    return path


def test_config_num_model_shards_is_refused(tmp_path):
    """A config's `num_model_shards = 2` reaches `train()`, which builds the
    model axis over this process's devices: on one CPU it cannot (the
    reference's over-ask ValueError)."""
    with pytest.raises(ValueError, match=r"mesh 1x2 needs 2 devices, have 1"):
        tcli.main(["--device", "cpu", "training", "--config",
                   _config_file(tmp_path, num_model_shards=2)])


@pytest.mark.parametrize("argv", [
    ["masking", "-d", "/t", "-ad", "/a"],
    ["inference", "-d", "/t", "-ad", "/a", "-ef", "x", "-m", "/m"],
    ["inference_asr", "-d", "/t", "-ad", "/a", "-ef", "x", "-m", "/m", "-df", "/d"],
])
def test_no_silent_cpu_run(monkeypatch, argv):
    """Without a GPU a model subcommand fails unless `--device cpu` is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)


def test_python_m_avsi_torch_help():
    proc = subprocess.run([sys.executable, "-m", "avsi_torch", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "evaluation_asr" in proc.stdout and "--device" in proc.stdout


def test_bad_subcommand_exits_1(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main([])
    assert e.value.code == 1 and "Bad subcommand name" in capsys.readouterr().out


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files, (
        cmp.left_only, cmp.right_only, cmp.diff_files)
    assert not filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)[1]
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


def test_cpu_pipeline_equals_the_direct_calls(tmp_path):
    """fixture -> audio_preprocessing -> training -> inference_model_generation
    -> masking -> inference -> evaluation with `--device cpu`, each output
    equal to the port's direct call on the same inputs."""
    from avsi_torch.data import fixture, stats
    from avsi_torch.eval import harness
    from avsi_torch.infer import export, inpaint, masking
    from avsi_torch.train import loop

    def run(*argv):
        tcli.main(["--device", "cpu", *argv])

    base, direct = str(tmp_path / "cli"), str(tmp_path / "direct")
    run("fixture", "-d", base, "-ns", "2", "-num", "2", "1", "2", "-al", "1000")
    fixture.make_fixture(direct, 2, (2, 1, 2), 1000)
    _same_tree(base, direct)

    train_dir = os.path.join(base, "syn", "training-set")
    run("audio_preprocessing", "-a", train_dir, "-p", "target", "-o", "spec", "-ws", "24",
        "-ss", "12")
    want = stats.compute_mean_std_features(train_dir, "target", "direct_spec", "spec", 16000,
                                           512, 24, 12)
    for got, w in zip((np.load(os.path.join(train_dir, f"spec_{k}.npy")) for k in ("mean", "std")),
                      want):
        np.testing.assert_array_equal(got, w.astype(np.float32))

    cfg = tiny_config(model="av-blstm-ssnn-ctc", net_dim=(8, 8), audio_len=16000,
                      root_folder=os.path.join(base, "tfrecords"), max_n_epochs=1,
                      n_earlystop_epochs=1, num_asr_labels=33, tb_media=0,
                      audio_feat_mean=os.path.join(train_dir, "spec_mean.npy"),
                      audio_feat_std=os.path.join(train_dir, "spec_std.npy"))
    configs = {}
    for who in ("cli", "direct"):
        configs[who] = str(tmp_path / f"{who}.config")
        tconfig.save_configfile(dict(cfg, exp_folder=str(tmp_path / f"exp_{who}")), configs[who])
    run("training", "--config", configs["cli"])
    loop.train(configs["direct"], device="cpu")
    nets = {w: str(tmp_path / f"exp_{w}" / "netmodel") for w in configs}
    for f in ("sinet.npz", "audio_features_mean.npy", "audio_features_std.npy"):
        assert filecmp.cmp(os.path.join(nets["cli"], f), os.path.join(nets["direct"], f),
                           shallow=False), f

    run("inference_model_generation", "--config", configs["cli"], "--input_model",
        os.path.join(nets["cli"], "sinet"), "--output_model", str(tmp_path / "model_cli" / "sinet"))
    export.save_inference_model(configs["direct"], os.path.join(nets["direct"], "sinet"),
                                str(tmp_path / "model_direct" / "sinet"))
    for f in ("sinet.npz", "audio_features_mean.npy"):
        assert filecmp.cmp(str(tmp_path / "model_cli" / f), str(tmp_path / "model_direct" / f),
                           shallow=False)

    test_tfr = os.path.join(base, "tfrecords", "test-set")
    test_audio = os.path.join(base, "syn", "test-set")
    samples = sorted(d for d in os.listdir(test_audio) if os.path.isdir(os.path.join(test_audio, d)))

    def wavs(name):
        return [open(os.path.join(test_audio, s, name), "rb").read() for s in samples]

    run("masking", "-d", test_tfr, "-ad", test_audio, "-bs", "2")
    masked = wavs("masked.wav")
    masking.mask_app(test_tfr, test_audio, batch_size=2, device="cpu")
    assert wavs("masked.wav") == masked

    run("inference", "-d", test_tfr, "-ad", test_audio, "-ef", "cli", "-m",
        str(tmp_path / "model_cli"), "-n", "-bs", "2", "--gl_iters", "5")
    inpaint.infer(str(tmp_path / "model_direct"), test_tfr, test_audio, "direct", batch_size=2,
                  gl_iters=5, device="cpu")
    assert wavs(os.path.join("enhanced", "cli.wav")) == wavs(os.path.join("enhanced", "direct.wav"))

    run("evaluation", "-ed", test_audio, "-ef", "cli", "-o", "scores_cli", "-me")
    harness.speech_inpainting_eval(test_audio, "cli", "scores_direct", True)
    with open(os.path.join(test_audio, "scores_cli.csv")) as a, \
            open(os.path.join(test_audio, "scores_direct.csv")) as b:
        rows = a.read()
        assert rows == b.read()
    assert len(rows.splitlines()) == 1 + len(samples)


def test_export_tf_import_tf_round_trip(tmp_path):
    """`export_tf` then `import_tf` with the default names: the imported
    directory is a bundle `load_model_bundle` reads, with the weights."""
    pytest.importorskip("tensorflow")
    from avsi_torch.infer import import_tf, inpaint
    from avsi_torch.train import checkpoints

    for key in ("m", "s"):
        np.save(str(tmp_path / f"{key}.npy"), np.zeros(257, np.float32) + (key == "s"))
    cfg_path = _config_file(tmp_path, num_asr_labels=33)
    config = tconfig.check_trainconfiguration(tconfig.load_configfile(cfg_path))
    params = import_tf.model_template(config)
    for i, leaf in enumerate(checkpoints.named_leaves(params).values()):
        leaf.add_(0.01 * i)
    checkpoints.save_checkpoint(str(tmp_path / "ckp"), "sinet", params)
    prefix = str(tmp_path / "tf" / "model.ckpt")
    tcli.main(["export_tf", "--config", cfg_path, "--model_ckp", str(tmp_path / "ckp"),
               "--out_prefix", prefix])
    back = str(tmp_path / "back")
    tcli.main(["import_tf", "--config", cfg_path, "--tf_ckp", prefix, "--out_dir", back])
    for f in ("config.txt", "meta.json", "audio_features_mean.npy", "audio_features_std.npy"):
        assert os.path.exists(os.path.join(back, f)), f
    _, _, _, got = inpaint.load_model_bundle(back, device="cpu")
    want = checkpoints.params_to_flat(params)
    got = checkpoints.params_to_flat(got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
