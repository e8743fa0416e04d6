"""Command line of the port: `python -m avsi_torch <subcommand> ...`.

The subcommands, flags, short forms, defaults, choices and `required` of
`avsi/cli.py`, which mirrors the original system's main script:
dataset_generator, audio_preprocessing, video_preprocessing,
tfrecords_generator, tfrecords_grouping, masking, training, training_asr,
inference_model_generation, inference, inference_asr, inference_siasr,
evaluation, plus evaluation_asr, import_tf, export_tf, serve and fixture
(a synthetic corpus).  Each calls the port's function as `avsi/cli.py`
calls the reference's.

What differs:
  * `--device {cuda,cpu}`, before the subcommand (default cuda), is passed
    to every entry point that runs a model; without a GPU such a
    subcommand fails unless `--device cpu` is given.
  * `--lstm_impl` takes the port's names (auto, kernel, plain, scan) and
    the reference's `pallas`, which runs the CUDA kernels (`kernel`).
  * Training exits with 143 after a SIGTERM, once its resume checkpoint is
    written (`train_or_exit`).
  * `training` / `training_asr` with `--coordinator`, `--num_processes`,
    `--process_id` or `--distributed` join a `torch.distributed` job
    (`parallel.distributed.initialize`, NCCL on a GPU, Gloo with `--device
    cpu`) before training, as the reference joins `jax.distributed`;
    `--distributed` reads rank and world from torchrun's `RANK`,
    `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`.  `--data_shards` reaches
    `infer` and `serve`.
  * import_tf and export_tf need TensorFlow and raise ImportError without it.
"""

from __future__ import annotations

import argparse
import sys

def _add_lstm_impl_flag(p):
    p.add_argument("--lstm_impl", default="auto",
                   choices=["auto", "kernel", "plain", "scan", "pallas"],
                   help="BLSTM recurrence for this forward-only run: auto "
                        "(default) = the CUDA kernels on a GPU, their plain "
                        "versions on the CPU; scan = the eager scan twin; "
                        "pallas (the reference's name) = kernel")


def _lstm_impl(args) -> str:
    return "kernel" if args.lstm_impl == "pallas" else args.lstm_impl


def _add_gap_atten_flags(p):
    p.add_argument("--gap_atten", type=float, default=1.0,
                   help="deep-gap amplitude floor in [0,1] (the postfilter of "
                        "ops/postfilter.py); 1.0 = off (default)")
    p.add_argument("--gap_atten_trust", type=int, default=34,
                   help="frames of gap depth fully trusted (34 = an 800 ms "
                        "single-intrusion hole stays bit-identical)")
    p.add_argument("--gap_atten_ramp", type=int, default=16,
                   help="frames over which the gain ramps from 1 to "
                        "--gap_atten")


def _gap_atten_opts(args):
    if args.gap_atten >= 1.0:
        return None
    return {"alpha": args.gap_atten, "trust": args.gap_atten_trust,
            "ramp": args.gap_atten_ramp}


def _add_distributed_args(p):
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port "
                        "(torch.distributed); run the same command on every "
                        "host with its own --process_id")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="multi-host with the rank and world of torchrun's "
                        "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")


def _maybe_init_distributed(args, device) -> None:
    """Join `training` to a torch.distributed job before it starts: the
    per-rank input sharding, the reductions over the ranks and the
    rank-0-only writes then happen inside `train()`."""
    if (args.distributed or args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        from avsi_torch.parallel import distributed

        distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                               device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="avsi_torch",
        description="Audio-visual speech inpainting system (PyTorch, NVIDIA GPU). "
        "Try 'python -m avsi_torch <subcommand> --help' for more information.",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the models run (default cuda; a run without "
                             "a GPU fails unless --device cpu is given)")
    sub = parser.add_subparsers(dest="subparser_name")

    p = sub.add_parser("dataset_generator", description="Generate masks dataset.")
    p.add_argument("-ca", "--clean_audio_dir", required=True)
    p.add_argument("-bs", "--speaker_ids", nargs="+", type=int, required=True)
    p.add_argument("-d", "--dest_dir", required=True)
    p.add_argument("-num", "--num_samples", type=int, required=True)
    p.add_argument("-al", "--audio_length", type=int, default=1024)
    p.add_argument("-i", "--num_max_intr", type=int, default=1)
    p.add_argument("-cm", "--mask_coverage_mean", type=float, default=0.3)
    p.add_argument("-cs", "--mask_coverage_std", type=float, default=0.1)
    p.add_argument("-e", "--ext", default="wav")
    p.add_argument("-hm", "--mask_hop_ms", type=int, default=12,
                   help="mask STFT hop in ms (12 for blstm; 8 for unet)")
    p.add_argument("-fd", "--mask_frame_dim", type=int, default=257,
                   help="mask frequency bins (257 for blstm; 128 for unet)")
    p.add_argument("-mk", "--mask_kind", default="timegap",
                   choices=["timegap", "freeform"],
                   help="timegap = the reference's full-band time gaps; "
                        "freeform = irregular T-F holes (an extension)")

    p = sub.add_parser("audio_preprocessing", description="Compute feature mean/std.")
    p.add_argument("-a", "--audio_dir", required=True)
    p.add_argument("-p", "--file_prefix", required=True)
    p.add_argument("-o", "--out_prefix", required=True)
    p.add_argument("-t", "--type", default="spec", choices=["spec", "fbanks", "mfcc"])
    p.add_argument("-sr", "--sample_rate", type=int, default=16000)
    p.add_argument("-fs", "--fft_size", type=int, default=512)
    p.add_argument("-ws", "--window_size", type=int, default=25)
    p.add_argument("-ss", "--step_size", type=int, default=10)
    p.add_argument("-pe", "--preemph", type=float, default=0)
    p.add_argument("-nm", "--num_mel_bins", type=int, default=80)
    p.add_argument("-nmf", "--num_mfcc", type=int, default=13)
    p.add_argument("-d", "--delta", type=int, default=0)
    p.add_argument("-am", "--apply_mask", action="store_const", const=True, default=False)
    p.add_argument("-s", "--save_feat", action="store_const", const=True, default=False)
    p.add_argument("-e", "--ext", default="wav")

    p = sub.add_parser("video_preprocessing", description="Compute face landmarks (requires dlib/OpenCV).")
    p.add_argument("-data", "--data_dir", required=True)
    p.add_argument("-s", "--speaker_ids", nargs="+", type=int, required=True)
    p.add_argument("-v", "--video_dir", required=True)
    p.add_argument("-d", "--dest_dir", required=True)
    p.add_argument("-sp", "--shape_predictor", required=True)
    p.add_argument("-e", "--ext", default="mpg")

    p = sub.add_parser("tfrecords_generator", description="Create TFRecords of training dataset.")
    p.add_argument("-m", "--mode", default="fixed", choices=["fixed", "var"])
    p.add_argument("-a", "--dataset_dir", required=True)
    p.add_argument("-d", "--dest_dir", required=True)
    p.add_argument("-df", "--dict_file", required=True)
    p.add_argument("-emb", "--with_embedding", action="store_const", const=True, default=False)

    p = sub.add_parser("tfrecords_grouping", description="Group TFRecords with similar lengths.")
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-gs", "--group_size", type=int, default=16)
    p.add_argument("-d", "--del_input_dir", action="store_const", const=True, default=False)

    p = sub.add_parser("masking", description="Generate masked wavs (oracle baseline).")
    p.add_argument("-d", "--data_dir", required=True)
    p.add_argument("-ad", "--audio_dir", required=True)
    p.add_argument("-m", "--mode", default="fixed", choices=["fixed", "var"])
    p.add_argument("-af", "--audio_feat_dim", type=int, default=257)
    p.add_argument("-vf", "--video_feat_dim", type=int, default=136)
    p.add_argument("-ns", "--num_audio_samples", type=int, default=48000)
    p.add_argument("-op", "--oracle_phase", action="store_const", const=True, default=False)
    p.add_argument("-bs", "--batch_size", type=int, default=0)
    p.add_argument("--feat_mean", default=None)
    p.add_argument("--feat_std", default=None)

    p = sub.add_parser("training", description="Train a speech inpainting model.")
    p.add_argument("--config", required=True, type=str)
    _add_distributed_args(p)

    p = sub.add_parser("training_asr", description="Train an ASR model.")
    p.add_argument("--config", required=True, type=str)
    _add_distributed_args(p)

    p = sub.add_parser("inference_model_generation", description="Save inference model.")
    p.add_argument("--config", required=True, type=str, default="")
    p.add_argument("--model", type=str, choices=["enh", "asr", "enhasr"], default="enh")
    p.add_argument("--input_model", required=True, type=str)
    p.add_argument("--output_model", required=True, type=str)

    p = sub.add_parser(
        "import_tf",
        description="Import a TF checkpoint of the original system as a checkpoint bundle "
                    "(not in the reference; needs tensorflow).",
    )
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--tf_ckp", required=True, type=str, help="TF checkpoint prefix")
    p.add_argument("--out_dir", required=True, type=str)
    p.add_argument("--name", type=str, default=None,
                   help="checkpoint name (default: sinet, or asrnet with --asr)")
    p.add_argument("--asr", action="store_const", const=True, default=False)

    p = sub.add_parser(
        "export_tf",
        description="Export a checkpoint in the original system's TF format (not in the "
                    "reference; needs tensorflow).",
    )
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--model_ckp", required=True, type=str, help="checkpoint dir")
    p.add_argument("--name", type=str, default=None,
                   help="checkpoint name (default: sinet, or asrnet with --asr)")
    p.add_argument("--out_prefix", required=True, type=str)
    p.add_argument("--asr", action="store_const", const=True, default=False)

    p = sub.add_parser("inference", description="Inference with trained speech inpainting model.")
    p.add_argument("-d", "--data_dir", required=True)
    p.add_argument("-ad", "--audio_dir", required=True)
    p.add_argument("-ef", "--out_file_prefix", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-n", "--norm", action="store_const", const=True, default=False)
    p.add_argument("-bs", "--batch_size", type=int, default=0)
    p.add_argument("-op", "--oracle_phase", action="store_const", const=True, default=False)
    p.add_argument("--phase_recon", default="gl", choices=["gl", "none"])
    p.add_argument("--gl_iters", type=int, default=50)
    p.add_argument("--data_shards", type=int, default=0,
                   help="shard each inference batch over a data mesh of "
                        "this many devices (0 = single device; on the CPU "
                        "the CPU split this many ways)")
    p.add_argument("--passthrough", action="store_const", const=True, default=False,
                   help="keep original samples on known frames (raised-cosine "
                        "crossfade at gap boundaries); default = reference-"
                        "faithful full resynthesis")
    _add_gap_atten_flags(p)
    _add_lstm_impl_flag(p)

    p = sub.add_parser("inference_asr", description="Inference with trained ASR model.")
    p.add_argument("-d", "--data_dir", required=True)
    p.add_argument("-ad", "--audio_dir", required=True)
    p.add_argument("-ef", "--out_file_prefix", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-am", "--apply_mask", action="store_const", const=True, default=False)
    p.add_argument("-n", "--norm", action="store_const", const=True, default=False)
    p.add_argument("-bs", "--batch_size", type=int, default=0)
    p.add_argument("-df", "--dict_file", required=True)
    p.add_argument("-bw", "--beam_width", type=int, default=100,
                   help="CTC beam width (reference default 100); 0 = greedy.")
    _add_lstm_impl_flag(p)

    p = sub.add_parser("inference_siasr", description="Inpainting + ASR inference.")
    p.add_argument("-d", "--data_dir", required=True)
    p.add_argument("-ad", "--audio_dir", required=True)
    p.add_argument("-ef", "--out_file_prefix", required=True)
    p.add_argument("-ms", "--model_path_si", required=True)
    p.add_argument("-mr", "--model_path_asr", required=True)
    p.add_argument("-n", "--norm", action="store_const", const=True, default=False)
    p.add_argument("-bs", "--batch_size", type=int, default=0)
    p.add_argument("-df", "--dict_file", required=True)
    p.add_argument("-op", "--oracle_phase", action="store_const", const=True, default=False)
    p.add_argument("--phase_recon", default="gl", choices=["gl", "none"])
    p.add_argument("--gl_iters", type=int, default=50)
    p.add_argument("-bw", "--beam_width", type=int, default=100,
                   help="CTC beam width (reference default 100); 0 = greedy.")
    p.add_argument("--passthrough", action="store_const", const=True, default=False,
                   help="keep original samples on known frames (raised-cosine "
                        "crossfade at gap boundaries); default = reference-"
                        "faithful full resynthesis")
    _add_gap_atten_flags(p)
    _add_lstm_impl_flag(p)

    p = sub.add_parser("evaluation", description="Evaluate audio samples with speech metrics.")
    p.add_argument("-ed", "--eval_audio_dir", required=True)
    p.add_argument("-ef", "--enhanced_file", required=True)
    p.add_argument("-o", "--out_file", required=True)
    p.add_argument("-me", "--masked_eval", action="store_const", const=True, default=False)
    p.add_argument("--pesq_path", default=None)
    p.add_argument("--pesq_mode", default="nb", choices=["nb", "wb"])
    p.add_argument("-fs", "--fft_size", type=int, default=512)
    p.add_argument("-ws", "--window_size", type=int, default=25)
    p.add_argument("-ss", "--step_size", type=int, default=10)
    p.add_argument("-w", "--num_workers", type=int, default=0)
    p.add_argument("--sdr", action="store_const", const=True, default=False,
                   help="Add SDR/SI-SDR columns (an extension).")

    p = sub.add_parser(
        "evaluation_asr",
        description="PER-free L1/PESQ/STOI evaluation (reference evaluation_asr.py).",
    )
    p.add_argument("-ed", "--eval_audio_dir", required=True)
    p.add_argument("-ef", "--enhanced_file", required=True)
    p.add_argument("-o", "--out_file", required=True)
    p.add_argument("-me", "--masked_eval", action="store_const", const=True, default=False)
    p.add_argument("--pesq_path", default=None)
    p.add_argument("--pesq_mode", default="nb", choices=["nb", "wb"])
    p.add_argument("-fs", "--fft_size", type=int, default=512)
    p.add_argument("-ws", "--window_size", type=int, default=25)
    p.add_argument("-ss", "--step_size", type=int, default=10)
    p.add_argument("-w", "--num_workers", type=int, default=0)
    p.add_argument("--sdr", action="store_const", const=True, default=False,
                   help="Add SDR/SI-SDR columns (an extension).")

    p = sub.add_parser("serve", description="Warm-model inpainting HTTP service (not in reference).")
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("-bs", "--micro_batch", type=int, default=8)
    p.add_argument("--phase_recon", default="gl", choices=["gl", "none"])
    p.add_argument("--gl_iters", type=int, default=30)
    p.add_argument("--max_streams", type=int, default=64)
    p.add_argument("--stream_idle_s", type=float, default=600.0)
    p.add_argument("--data_shards", type=int, default=0,
                   help="shard the /enhance micro-batch over a data mesh "
                        "of this many devices (0 = single device; on the CPU "
                        "the CPU split this many ways)")
    p.add_argument("--passthrough", action="store_const", const=True, default=False,
                   help="keep original samples on known frames (raised-cosine "
                        "crossfade at gap boundaries); default = reference-"
                        "faithful full resynthesis")
    _add_gap_atten_flags(p)
    _add_lstm_impl_flag(p)

    p = sub.add_parser("fixture", description="Generate a synthetic GRID-like corpus (not in reference).")
    p.add_argument("-d", "--dest_dir", required=True)
    p.add_argument("-ns", "--n_speakers", type=int, default=2)
    p.add_argument("-num", "--n_samples", type=int, nargs="+", default=[4],
                   help="samples per split (one value for all, or one per split)")
    p.add_argument("-al", "--audio_len_ms", type=int, default=3000)
    p.add_argument("-gm", "--gap_ms", type=float, default=800.0)
    p.add_argument("-gs", "--gap_std_ms", type=float, default=100.0)
    p.add_argument("-hm", "--mask_hop_ms", type=int, default=12,
                   help="mask STFT hop in ms (12 for blstm; 8 for unet)")
    p.add_argument("-fd", "--mask_frame_dim", type=int, default=257,
                   help="mask frequency bins (257 for blstm; 128 for unet)")
    p.add_argument("-mk", "--mask_kind", default="timegap",
                   choices=["timegap", "freeform"],
                   help="timegap = the reference's full-band time gaps; "
                        "freeform = irregular T-F holes (an extension)")

    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    name = args.subparser_name
    device = args.device

    if name == "dataset_generator":
        from avsi_torch.data.generator import create_syn_dataset

        create_syn_dataset(
            args.clean_audio_dir, args.dest_dir, args.speaker_ids, args.num_samples,
            args.audio_length, args.num_max_intr, args.mask_coverage_mean,
            args.mask_coverage_std, args.ext,
            mask_hop_ms=args.mask_hop_ms, mask_frame_dim=args.mask_frame_dim,
            mask_kind=args.mask_kind,
        )
    elif name == "audio_preprocessing":
        from avsi_torch.data.stats import compute_mean_std_features

        compute_mean_std_features(
            args.audio_dir, args.file_prefix, args.out_prefix, args.type,
            args.sample_rate, args.fft_size, args.window_size, args.step_size,
            args.preemph, args.num_mel_bins, args.num_mfcc, args.delta,
            args.apply_mask, args.save_feat, args.ext,
        )
    elif name == "video_preprocessing":
        from avsi_torch.data.extract import save_face_landmarks

        save_face_landmarks(
            args.data_dir, args.speaker_ids, args.video_dir, args.dest_dir,
            args.shape_predictor, args.ext,
        )
    elif name == "tfrecords_generator":
        from avsi_torch.data.generator import create_dataset

        create_dataset(
            args.dataset_dir, args.dest_dir, args.dict_file,
            args.with_embedding, args.mode,
        )
    elif name == "tfrecords_grouping":
        from avsi_torch.data.generator import group_tfrecords

        group_tfrecords(args.input_dir, args.output_dir, args.group_size, args.del_input_dir)
    elif name == "masking":
        from avsi_torch.infer.masking import mask_app

        mask_app(
            args.data_dir, args.audio_dir, args.mode, args.oracle_phase,
            args.audio_feat_dim, args.video_feat_dim, args.num_audio_samples,
            args.batch_size, args.feat_mean, args.feat_std, device=device,
        )
    elif name in ("training", "training_asr"):
        _maybe_init_distributed(args, device)
        from avsi_torch.train.loop import train_or_exit

        train_or_exit(args.config, is_asr=name == "training_asr", device=device)
    elif name == "inference_model_generation":
        from avsi_torch.infer.export import save_inference_model

        save_inference_model(args.config, args.input_model, args.output_model, args.model)
    elif name == "import_tf":
        from avsi_torch import config as config_lib
        from avsi_torch.infer.import_tf import import_tf_checkpoint
        from avsi_torch.train import checkpoints

        config = config_lib.check_trainconfiguration(
            config_lib.load_configfile(args.config)
        )
        params = import_tf_checkpoint(args.tf_ckp, config, is_asr=args.asr)
        name = args.name or ("asrnet" if args.asr else "sinet")
        prefix = checkpoints.save_checkpoint(args.out_dir, name, params)
        checkpoints.write_meta(args.out_dir, config)
        # the trainer's self-contained bundle layout, so `inference` and
        # `evaluation` load the imported directory as a trained one
        checkpoints.write_bundle(args.out_dir, args.config, config)
        print(f"Imported {args.tf_ckp} -> {prefix}")
    elif name == "export_tf":
        from avsi_torch import config as config_lib
        from avsi_torch.infer.import_tf import export_tf_checkpoint, model_template
        from avsi_torch.train import checkpoints

        config = config_lib.check_trainconfiguration(
            config_lib.load_configfile(args.config)
        )
        name = args.name or ("asrnet" if args.asr else "sinet")
        params, _ = checkpoints.restore_checkpoint(
            args.model_ckp, name, "cpu", model_template(config, is_asr=args.asr)
        )
        path = export_tf_checkpoint(params, config, args.out_prefix, is_asr=args.asr)
        print(f"Exported {args.model_ckp}/{name} -> {path}")
    elif name == "inference":
        from avsi_torch.infer.inpaint import infer

        infer(
            args.model_path, args.data_dir, args.audio_dir, args.out_file_prefix,
            args.norm, args.oracle_phase, args.batch_size, args.phase_recon,
            args.gl_iters, data_shards=args.data_shards,
            passthrough=args.passthrough, gap_atten=_gap_atten_opts(args),
            lstm_impl=_lstm_impl(args), device=device,
        )
    elif name == "inference_asr":
        from avsi_torch.infer.asr import infer

        infer(
            args.model_path, args.data_dir, args.audio_dir, args.out_file_prefix,
            args.dict_file, args.apply_mask, args.norm, args.batch_size,
            args.beam_width, lstm_impl=_lstm_impl(args), device=device,
        )
    elif name == "inference_siasr":
        from avsi_torch.infer.siasr import infer

        infer(
            args.model_path_si, args.model_path_asr, args.data_dir, args.audio_dir,
            args.out_file_prefix, args.dict_file, args.norm, args.oracle_phase,
            args.batch_size, args.phase_recon, args.gl_iters, args.beam_width,
            passthrough=args.passthrough, gap_atten=_gap_atten_opts(args),
            lstm_impl=_lstm_impl(args), device=device,
        )
    elif name in ("evaluation", "evaluation_asr"):
        from avsi_torch.eval import harness

        evaluate = (harness.speech_inpainting_eval if name == "evaluation"
                    else harness.speech_enhancement_eval)
        evaluate(
            args.eval_audio_dir, args.enhanced_file, args.out_file, args.masked_eval,
            args.pesq_path, args.pesq_mode, args.fft_size, args.window_size,
            args.step_size, args.num_workers, args.sdr,
        )
    elif name == "serve":
        from avsi_torch.serve import serve

        server = serve(
            args.model_path, args.host, args.port,
            max_streams=args.max_streams, stream_idle_s=args.stream_idle_s,
            micro_batch=args.micro_batch, phase_recon=args.phase_recon,
            gl_iters=args.gl_iters, data_shards=args.data_shards, passthrough=args.passthrough,
            gap_atten=_gap_atten_opts(args), lstm_impl=_lstm_impl(args), device=device,
        )
        try:
            server.serve_forever()
        finally:
            server.shutdown()
    elif name == "fixture":
        from avsi_torch.data.fixture import make_fixture

        n_samples = args.n_samples[0] if len(args.n_samples) == 1 else tuple(args.n_samples)
        make_fixture(
            args.dest_dir, args.n_speakers, n_samples, args.audio_len_ms,
            gap_ms=args.gap_ms, gap_std_ms=args.gap_std_ms,
            mask_hop_ms=args.mask_hop_ms, mask_frame_dim=args.mask_frame_dim,
            mask_kind=args.mask_kind,
        )
    else:
        print("Bad subcommand name. Closing...")
        sys.exit(1)


if __name__ == "__main__":
    main()
