"""Batched reading of the TFRecord corpus (port of `avsi/data/reader.py`).

Files are shuffled per epoch with `np.random.default_rng(seed)` exactly as
the reference shuffles them and stacked into numpy batches; a background
thread parses ahead of the consumer.  Given the same seed and files it
yields the same batches in the same order as the reference's
`DataManager`, with `use_native` True and False.

Fixed mode reads through the native C++ loader (`native_loader`, the
port's own build of `native/avsi_loader.cc`) where it builds
(`use_native=None`) and the corpus's layout matches the reader's shapes,
else through the Python codec: single-record files a batch at a time on the
loader's threads, grouped files (`generator.group_tfrecords`) one file at a
time on `native_readahead` threads, in order.  `native_loader.parse_counts`
shows which reader ran.  Var mode always reads through the Python codec and
pads each batch to its longest sample, frames rounded up to
`pad_frames_multiple`.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from avsi_torch.data import native_loader
from avsi_torch.data import tfrecord as tfr

BATCH_KEYS = ("sequence_lengths", "labels_lengths", "target_sources", "labels",
              "video_features", "masks")

_POOL_END = object()


def _ordered_pool_map(fn, items, workers: int):
    """`fn` over `items` on `workers` threads, results in input order, at
    most 2 * workers in flight."""
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures: deque = deque()
        it = iter(items)
        exhausted = False
        while True:
            while not exhausted and len(futures) < 2 * workers:
                item = next(it, _POOL_END)
                if item is _POOL_END:
                    exhausted = True
                else:
                    futures.append(ex.submit(fn, item))
            if not futures:
                return
            yield futures.popleft().result()


class DataManager:
    """Reads sample TFRecords into batches: fixed mode stacks samples of
    one shape, var mode pads them (see the module docstring)."""

    def __init__(
        self,
        num_audio_samples: int = 48000,
        audio_feat_size: int = 257,
        video_feat_size: int = 136,
        with_embedding: bool = False,
        seed: int | None = None,
        use_native: bool | None = None,
        mode: str = "fixed",
        samples_per_frame: int = 192,
        pad_frames_multiple: int = 25,
        native_readahead: int | None = None,
    ):
        if mode not in ("fixed", "var"):
            raise ValueError(f"unknown tfrecord mode {mode!r}")
        self.num_audio_samples = num_audio_samples
        self.audio_feat_size = audio_feat_size
        self.video_feat_size = video_feat_size
        self.with_embedding = with_embedding
        self.mode = mode
        self.samples_per_frame = samples_per_frame
        self.pad_frames_multiple = max(1, pad_frames_multiple)
        self.rng = np.random.default_rng(seed)
        if native_readahead is None:
            native_readahead = min(4, os.cpu_count() or 1)
        self.native_readahead = max(1, int(native_readahead))
        self.use_native = mode == "fixed" and (
            native_loader.is_available() if use_native is None else use_native)
        # layout probes by probed file: one manager may read several corpora
        self._native_probes: dict[str, tuple] = {}
        self._native_probe: tuple | None = None  # the last probe

    def _probe_native(self, path: str) -> tuple:
        """(t_frames, emb_dim, records_per_file, num_labels) of a corpus from
        its file `path`, or () where the native layout does not apply.
        Returned rather than read back from the manager, so that concurrent
        epochs over different corpora each use their own."""
        if path not in self._native_probes:
            try:
                records = list(tfr.read_records(path))
                sample = tfr.parse_sample_fixed(records[0], self.with_embedding)
                emb_dim = len(sample.get("embedding", ())) if self.with_embedding else 0
                ok = (len(sample["target_audio_wav"]) == self.num_audio_samples
                      and sample["mask"].shape[1] == self.audio_feat_size
                      and sample["video_features"].shape[1] == self.video_feat_size
                      and (not self.with_embedding or emb_dim > 0))
                probe = ((sample["mask"].shape[0], emb_dim, len(records), len(sample["labels"]))
                         if ok else ())
            except Exception:
                probe = ()
            self._native_probes[path] = probe
        self._native_probe = self._native_probes[path]
        return self._native_probe

    def _iter_samples(self, file_list: list[str]):
        parse = tfr.parse_sample_fixed if self.mode == "fixed" else tfr.parse_sample_var
        for path in file_list:
            for record in tfr.read_records(path):
                yield parse(record, self.with_embedding)

    def _stack(self, samples: list[dict]) -> dict:
        if self.mode == "var":
            return self._stack_var(samples)
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

    def _stack_var(self, samples: list[dict]) -> dict:
        """A padded batch: frames rounded up to `pad_frames_multiple`, the
        wave to frames * samples_per_frame (or its longest), labels to the
        batch's longest."""
        mult = self.pad_frames_multiple
        t_max = max(s["mask"].shape[0] for s in samples)
        t_pad = -(-t_max // mult) * mult
        wav_pad = max(t_pad * self.samples_per_frame,
                      max(len(s["target_audio_wav"]) for s in samples))
        lab_pad = max(1, max(len(s["labels"]) for s in samples))

        def pad_to(a, n):
            return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

        batch = {
            "sequence_lengths": np.asarray([s["sequence_length"] for s in samples], np.int32),
            "labels_lengths": np.asarray([s["labels_length"] for s in samples], np.int32),
            "target_sources": np.stack([pad_to(s["target_audio_wav"], wav_pad) for s in samples]),
            "labels": np.stack([pad_to(s["labels"], lab_pad) for s in samples]),
            "video_features": np.stack([pad_to(s["video_features"], t_pad) for s in samples]),
            "masks": np.stack([pad_to(s["mask"], t_pad) for s in samples]),
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
        # the probe reads one stable file per corpus, before the shuffle
        probe = self._probe_native(min(files)) if files and self.use_native else ()
        if shuffle:
            self.rng.shuffle(files)
        if probe:
            # single-record corpora: the loader raises (-6) on a file of
            # several records, so a mixed corpus fails, never drops records
            native = self._native_batches if probe[2] == 1 else self._native_batches_grouped
            yield from native(files, batch_size, drop_remainder, pad_final, probe)
            return
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

    def _native_batches_grouped(self, files, batch_size, drop_remainder, pad_final, probe):
        """Grouped files: each file's records parsed natively on
        `native_readahead` threads (the ctypes call releases the GIL), in
        order, and re-batched here."""
        t_frames, emb_dim, per_file, num_labels = probe
        cap = max(64, per_file * 4)
        keys = list(BATCH_KEYS) + (["embeddings"] if self.with_embedding else [])
        pending: list[dict] = []

        def make_batch(samples, n_real):
            batch = {k: np.stack([s[k] for s in samples]) for k in keys}
            batch["sample_paths"] = [s["sample_paths"] for s in samples]
            batch["num_real"] = n_real
            return batch

        def parse(path):
            c = cap
            while True:  # a file larger than the probe's grows the buffers
                try:
                    return native_loader.load_file_records(
                        path, c, num_audio_samples=self.num_audio_samples, t_frames=t_frames,
                        audio_dim=self.audio_feat_size, video_dim=self.video_feat_size,
                        num_labels=num_labels, emb_dim=emb_dim)
                except ValueError as e:
                    if "more than" not in str(e) or c > 1 << 20:
                        raise
                    c *= 4

        for recs in _ordered_pool_map(parse, files, self.native_readahead):
            for i in range(len(recs["sequence_lengths"])):
                sample = {k: recs[k][i] for k in keys}
                sample["sample_paths"] = recs["sample_paths"][i]
                pending.append(sample)
            while len(pending) >= batch_size:
                yield make_batch(pending[:batch_size], batch_size)
                pending = pending[batch_size:]
        if pending and not drop_remainder:
            n_real = len(pending)
            if pad_final:
                pending = pending + [pending[-1]] * (batch_size - n_real)
            yield make_batch(pending, n_real)

    def _native_batches(self, files, batch_size, drop_remainder, pad_final, probe):
        t_frames, emb_dim, _, num_labels = probe
        for i in range(0, len(files), batch_size):
            group = files[i:i + batch_size]
            n_real = len(group)
            if n_real < batch_size:
                if drop_remainder:
                    return
                if pad_final:
                    group = group + [group[-1]] * (batch_size - n_real)
            batch = native_loader.load_batch(
                group, num_audio_samples=self.num_audio_samples, t_frames=t_frames,
                audio_dim=self.audio_feat_size, video_dim=self.video_feat_size,
                num_labels=num_labels, emb_dim=emb_dim)
            if not self.with_embedding:
                batch.pop("embeddings", None)
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
