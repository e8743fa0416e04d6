"""Batched reading of the fixed-mode TFRecord corpus (port of
`avsi/data/reader.py:62-169,209-259,339-384`, the Python-codec path).

Files are parsed with `avsi_torch.data.tfrecord`, shuffled per epoch with
`np.random.default_rng(seed)` exactly as the reference shuffles them, and
stacked into fixed-shape numpy batches; a background thread parses ahead
of the consumer.  Given the same seed and files it yields the same batches
in the same order as the reference's `DataManager(use_native=False)`.
The native C++ loader and the var mode wait.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from avsi_torch.data import tfrecord as tfr


class DataManager:
    """Reads fixed-mode sample TFRecords into batches."""

    def __init__(
        self,
        num_audio_samples: int = 48000,
        audio_feat_size: int = 257,
        video_feat_size: int = 136,
        with_embedding: bool = False,
        seed: int | None = None,
    ):
        self.num_audio_samples = num_audio_samples
        self.audio_feat_size = audio_feat_size
        self.video_feat_size = video_feat_size
        self.with_embedding = with_embedding
        self.rng = np.random.default_rng(seed)

    def _iter_samples(self, file_list: list[str]):
        for path in file_list:
            for record in tfr.read_records(path):
                yield tfr.parse_sample_fixed(record, self.with_embedding)

    def _stack(self, samples: list[dict]) -> dict:
        batch = {
            "sequence_lengths": np.asarray([s["sequence_length"] for s in samples], np.int32),
            "labels_lengths": np.asarray([s["labels_length"] for s in samples], np.int32),
            "target_sources": np.stack([s["target_audio_wav"] for s in samples]),
            "labels": np.stack([s["labels"] for s in samples]),
            "video_features": np.stack([s["video_features"] for s in samples]),
            "masks": np.stack([s["mask"] for s in samples]),
            "sample_paths": [s["sample_path"] for s in samples],
        }
        if self.with_embedding:
            batch["embeddings"] = np.stack([s["embedding"] for s in samples])
        return batch

    def batches(self, file_list: list[str], batch_size: int, shuffle: bool = False,
                drop_remainder: bool = False, pad_final: bool = False):
        """Yield the batches of one epoch.  pad_final: repeat the last sample
        to fill a fixed-shape final batch; `num_real` marks the real rows."""
        files = list(file_list)
        if shuffle:
            self.rng.shuffle(files)
        buf: list[dict] = []
        for sample in self._iter_samples(files):
            buf.append(sample)
            if len(buf) == batch_size:
                batch = self._stack(buf)
                batch["num_real"] = batch_size
                yield batch
                buf = []
        if buf and not drop_remainder:
            n_real = len(buf)
            if pad_final:
                buf += [buf[-1]] * (batch_size - n_real)
            batch = self._stack(buf)
            batch["num_real"] = n_real
            yield batch

    def prefetch_batches(self, *args, prefetch: int = 2, **kwargs):
        """`batches()` parsed ahead by a background thread.  The thread
        stops when the consumer stops early (its puts poll a stop flag), and
        a parse error is raised in the consumer."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self.batches(*args, **kwargs):
                    if not put(b):
                        return
            except BaseException as e:  # re-raised in the consumer below
                err.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)

    def count_samples(self, file_list: list[str]) -> int:
        return sum(tfr.count_records(path) for path in file_list)
