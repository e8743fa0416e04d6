"""GRID phoneme dictionary and label utilities (port of
`avsi/data/phonemes.py`, the whole module, kept as a copy).

Labels are indices into the sorted unique phoneme list; the CTC blank is
the last class (index = len(dictionary)), the TF convention of the
reference models.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

MAX_LABEL_LEN = 50  # reference pads label sequences to 50 (tfrecord_utils.py:101)


def load_dictionary(filename: str) -> list[str]:
    with open(filename) as f:
        dictionary = f.read()
    phonemes = dictionary.replace("\n", " ").split(" ")
    return [ph for ph in sorted(set(phonemes)) if ph != ""]


def get_labels(phonemes: str, dictionary: list[str]) -> np.ndarray:
    labels = phonemes.replace("SP", "").split(",")
    labels = [lab for lab in labels if lab != ""]
    return np.asarray([dictionary.index(ph) for ph in labels])


def get_phonemes_from_labels(labels, dictionary: list[str]) -> list[str]:
    return [dictionary[int(x)] for x in labels]


def get_phonemes(transcription: str, word_list: list[str], dict_list: list[str]) -> str:
    for word, phonemes in zip(word_list, dict_list):
        transcription = transcription.replace(word, phonemes)
    return transcription


def linearize(transcription: str) -> str:
    parts = transcription.replace("\n", " ").split(" ")
    lin: list[str] = []
    for ph in parts:
        if ph.isalpha() and ph != "SIL":
            lin.append(ph)
            lin.append(",")
    return "".join(lin[:-1]) if lin else ""


def save_phonemes_labels(data_path: str, word_list: list[str], dict_list: list[str]) -> None:
    for transcription_file in glob(os.path.join(data_path, "**", "*.align"), recursive=True):
        with open(transcription_file) as f:
            transcription = f.read()
        phonemes = get_phonemes(transcription, word_list, dict_list)
        with open(transcription_file.replace(".align", ".phalign"), "w") as f:
            f.write(phonemes)
        with open(transcription_file.replace(".align", ".lbl"), "w") as f:
            f.write(linearize(phonemes))
