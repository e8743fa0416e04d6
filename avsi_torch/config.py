"""Config files: reference-compatible `key = value` parsing + validation.

Port of `avsi/config.py:27-191` (`load_configfile`, `save_configfile`,
`check_trainconfiguration`), kept as a copy so the port imports nothing
of `avsi`.  Same syntax, defaults and validation, including the CTC blank
added to `num_asr_labels` (`avsi/config.py:147`).  One difference: the
`device` default is `cuda`, the port's target (the key is informational in
both packages; placement is `avsi_torch.device`'s job).
"""

from __future__ import annotations

import ast
import os
import re
import sys


def load_configfile(cfile: str) -> dict:
    """Parse a reference-style `key = value` config file into a dict."""
    if not os.path.isfile(cfile):
        raise ValueError(f"Cannot find configuration file {cfile}")

    out: dict = {}
    with open(cfile) as fh:
        for nline, rawline in enumerate(fh, start=1):
            line = rawline.rstrip()
            if not line or line[0] == "#":
                continue
            m = re.search(r"(\w+)\s*=\s*(.*)", line)
            if m is None:
                raise ValueError(f"Wrong syntax in the configuration file at line {nline}")
            key, value = m.group(1), m.group(2)
            if "[" not in value:
                if " " in value:
                    raise ValueError(
                        f"Wrong syntax in the configuration file at line {nline} "
                        "(may be a space in the param value?)"
                    )
                if re.search("[0-9]", value) and "/" not in value:
                    try:
                        out[key] = ast.literal_eval(value)
                    except (ValueError, SyntaxError):
                        if value.isidentifier():
                            # identifier-like scalars with digits, such as
                            # `compute_dtype = bfloat16`, load as strings
                            out[key] = value
                        else:
                            raise ValueError(
                                f"Wrong syntax in the configuration file at line {nline} "
                                "(may be due to mixed letters and integers?)"
                            )
                else:
                    out[key] = value
            else:
                try:
                    out[key] = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    raise ValueError(
                        f"Wrong syntax in the configuration file at line {nline} "
                        "(may be a missing square parenthesis?)"
                    )
    return out


def save_configfile(config: dict, cfile: str) -> None:
    """Write a config dict back in the `key = value` format.

    String values that the parser would mis-handle raw (digits but no "/",
    e.g. "bfloat16") are written repr-quoted so save->load round-trips."""
    with open(cfile, "w") as fh:
        for key, value in config.items():
            if (
                isinstance(value, str)
                and "[" not in value
                and "/" not in value
                and re.search("[0-9]", value)
            ):
                value = repr(value)
            fh.write(f"{key} = {value}\n")


def _warn(msg: str) -> None:
    print(f"WARNING: {msg}", file=sys.stderr)


def check_trainconfiguration(config: dict) -> dict:
    """Defaulting + validation, as `avsi.config.check_trainconfiguration`."""
    config = dict(config)

    for alias, canonical in (
        ("feat_dim", "audio_feat_dim"),
        ("feat_mean", "audio_feat_mean"),
        ("feat_std", "audio_feat_std"),
    ):
        if alias in config and canonical not in config:
            config[canonical] = config[alias]

    if "root_folder" not in config:
        raise ValueError("Root folder not defined")
    if "exp_folder" not in config:
        raise ValueError("Experiment folder (exp_folder) not defined")
    config.setdefault("model_ckp", "")
    config.setdefault("model_ckp_vnet", "")
    if "device" not in config:
        config["device"] = "cuda"

    if "model" not in config:
        raise ValueError("Model type (model) not defined in config file")
    if "net_dim" not in config:
        raise ValueError("Enhancement net dimensions (net_dim) not defined in config file")
    if "integration_layer" not in config:
        config["integration_layer"] = 0
        _warn("Embedding integration layer not defined in config file. Set to 0 by default")
    if "audio_feat_dim" not in config:
        config["audio_feat_dim"] = 257
        _warn("No. of audio input features not defined in config file. Set to 257 by default")
    if "video_feat_dim" not in config:
        config["video_feat_dim"] = 136
        _warn("No. of video input features not defined in config file. Set to 136 by default")
    if "audio_len" not in config:
        config["audio_len"] = 16384
        _warn("Length of input wavs not defined in config file. Set to 16384 by default")
    if "audio_feat_mean" not in config:
        raise ValueError("File with mean of features (audio_feat_mean) not defined in config file")
    if "audio_feat_std" not in config:
        raise ValueError(
            "File with standard deviation of features (audio_feat_std) not defined in config file"
        )
    if "num_asr_labels" not in config:
        config["num_asr_labels"] = 33  # GRID phoneme count
        _warn("No. of speech recognition labels not defined in config file. Set to 33 by default")
    config["num_asr_labels"] += 1  # CTC blank
    if "ctc_loss" not in config:
        config["ctc_loss"] = 1.0
        _warn("CTC loss weight not defined in config file. Set to 1 by default")
    if "embedding_dim" not in config:
        config["embedding_dim"] = 512

    if "batch_size" not in config:
        _warn("Batch size not defined in config file. Set to 1 by default")
        config["batch_size"] = 1
    if "dropout_rate" not in config:
        _warn("Dropout rate not defined in config file. Set to 0 by default")
        config["dropout_rate"] = 0.0
    if "starter_learning_rate" not in config:
        _warn("Starter learning rate not defined in config file. Set to 0.06 by default")
        config["starter_learning_rate"] = 0.06
    if "learning_rate" not in config:
        config["learning_rate"] = config["starter_learning_rate"]
    if "lr_updating_steps" not in config:
        _warn("Updating steps of learning rate decay not defined. Set to 10000 by default")
        config["lr_updating_steps"] = 10000
    if "lr_decay" not in config:
        _warn("Learning rate decay not defined in config file. Set to 0.5 by default")
        config["lr_decay"] = 0.5
    if "l2" not in config:
        config["l2"] = 0.0
    if "optimizer_type" not in config:
        _warn("Optimizer type not defined in config file. Set to 'adam' by default")
        config["optimizer_type"] = "adam"
    if config["optimizer_type"] == "momentum_dlr" and "momentum" not in config:
        raise ValueError("momentum missing from config file")
    if "max_n_epochs" not in config:
        _warn("max_n_epochs not defined. Set to 30 by default")
        config["max_n_epochs"] = 30
    if "n_earlystop_epochs" not in config:
        _warn("n_earlystop_epochs not defined. Set to 30 by default")
        config["n_earlystop_epochs"] = 30

    config.setdefault("num_data_shards", 0)
    config.setdefault("num_model_shards", 1)
    config.setdefault("compute_dtype", "float32")  # or "bfloat16"
    config.setdefault("seed", 0)

    return config
