"""Data pipeline (port of `repro.data.pipeline`, numpy only).

AQ-SGD keys its message buffers on *sample identity across epochs*, so
every batch carries stable ``sample_ids``.  The streams are the JAX
package's, element for element: the same corpus from the same seed and
the same shuffle order, as numpy arrays (the trainer moves them to its
device).

Two corpus sources: synthetic Zipf-distributed token sequences with
planted bigram structure (so loss curves are meaningful), and a
byte-level encoding of a local text file.  Neither holds the audio
family's frames or the vlm family's patches (as in the JAX package);
`with_stub_media` adds stub ones to a batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DatasetConfig:
    num_samples: int = 256
    seq_len: int = 128
    vocab_size: int = 512
    kind: str = "synthetic-lm"      # synthetic-lm | textfile
    path: Optional[str] = None
    seed: int = 0
    shuffle_each_epoch: bool = True


def _synthetic_corpus(dc: DatasetConfig) -> np.ndarray:
    """Zipf tokens with planted bigram transitions: predictable enough
    that fine-tuning has signal, noisy enough that loss stays > 0."""
    rng = np.random.default_rng(dc.seed)
    v = dc.vocab_size
    # planted deterministic successor table for 60% of transitions
    succ = rng.integers(0, v, size=v)
    zipf_p = 1.0 / np.arange(1, v + 1)
    zipf_p /= zipf_p.sum()
    toks = np.empty((dc.num_samples, dc.seq_len + 1), np.int32)
    for i in range(dc.num_samples):
        seq = np.empty(dc.seq_len + 1, np.int32)
        seq[0] = rng.integers(0, v)
        rand = rng.random(dc.seq_len)
        draws = rng.choice(v, size=dc.seq_len, p=zipf_p)
        for t in range(1, dc.seq_len + 1):
            seq[t] = succ[seq[t - 1]] if rand[t - 1] < 0.6 else draws[t - 1]
        toks[i] = seq
    return toks


def _textfile_corpus(dc: DatasetConfig) -> np.ndarray:
    with open(dc.path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    raw = raw.astype(np.int32) % dc.vocab_size
    need = dc.num_samples * (dc.seq_len + 1)
    reps = -(-need // raw.size)
    raw = np.tile(raw, reps)[:need]
    return raw.reshape(dc.num_samples, dc.seq_len + 1)


class Dataset:
    """Epoch iterator yielding dict batches with stable sample ids."""

    def __init__(self, dc: DatasetConfig):
        self.dc = dc
        if dc.kind == "synthetic-lm":
            self.tokens = _synthetic_corpus(dc)
        elif dc.kind == "textfile":
            self.tokens = _textfile_corpus(dc)
        else:
            raise ValueError(dc.kind)
        self.reset()

    def reset(self) -> None:
        """Rewind the (mutable) shuffle state to step 0: the stream is
        then a pure function of the config seed again.  Replay-based
        resume depends on this — `epoch` advances
        ``self.rng`` in place, so re-calling `batches` WITHOUT a reset
        yields a different (continued-rng) stream."""
        self.rng = np.random.default_rng(self.dc.seed + 1)
        self._order = np.arange(self.dc.num_samples)

    @property
    def num_samples(self) -> int:
        return self.dc.num_samples

    def epoch(self, batch_size: int, shuffle: Optional[bool] = None
              ) -> Iterator[dict]:
        if shuffle is None:
            shuffle = self.dc.shuffle_each_epoch
        if shuffle:
            self.rng.shuffle(self._order)
        n = (self.dc.num_samples // batch_size) * batch_size
        for i in range(0, n, batch_size):
            ids = self._order[i:i + batch_size]
            chunk = self.tokens[ids]
            yield {
                "tokens": chunk[:, :-1],
                "targets": chunk[:, 1:],
                "mask": np.ones((batch_size, self.dc.seq_len), np.float32),
                "sample_ids": ids.astype(np.int32),
            }

    def batches(self, batch_size: int, num_steps: int) -> Iterator[dict]:
        done = 0
        while done < num_steps:
            for b in self.epoch(batch_size):
                yield b
                done += 1
                if done >= num_steps:
                    return


def with_stub_media(cfg, batch: dict, *, seed: int, step: int) -> dict:
    """``batch`` with the stub frontend's input a model of ``cfg``
    reads: an audio model's ``frames`` (B, encoder_seq, d) or a vlm
    model's ``patches`` (B, num_patches, d), f32 N(0, 0.02) (the serve
    launcher's stub scale) from numpy's generator on (seed, step), so
    every rank of a distributed run draws the same global batch.  Other
    families' batches come back as they are."""
    name, n = {"audio": ("frames", cfg.encoder_seq),
               "vlm": ("patches", cfg.num_patches)}.get(cfg.family,
                                                      (None, 0))
    if name is None:
        return batch
    rng = np.random.default_rng([seed, step])
    b = batch["tokens"].shape[0]
    return dict(batch, **{name: (rng.standard_normal((b, n, cfg.d_model))
                                 * 0.02).astype(np.float32)})


def microbatch_major(batch: dict, microbatches: int) -> dict:
    """A (B, ...) batch as the distributed trainer's (M, B/M, ...), the
    layout of the JAX launcher's distributed path."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        out[k] = v.reshape(microbatches, b // microbatches, *v.shape[1:])
    return out


def data_shard(batch_mm: dict, data_par: int, data_rank: int) -> dict:
    """Data rank ``data_rank``'s columns of a microbatch-major batch
    (M, D*mb, ...): the contiguous block [d*mb, (d+1)*mb) of dim 1, as
    the JAX package shards that dim over its data axis."""
    out = {}
    for k, v in batch_mm.items():
        if v.shape[1] % data_par:
            raise ValueError(f"microbatch {v.shape[1]} does not split "
                             f"over {data_par} data ranks")
        mb = v.shape[1] // data_par
        out[k] = v[:, data_rank * mb:(data_rank + 1) * mb]
    return out
