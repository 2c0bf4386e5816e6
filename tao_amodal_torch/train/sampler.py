"""Training pair and sequence samplers.

Port of :mod:`tao_amodal_tpu.train.sampler` (the reference's pysot
``TrkDataset`` positive/negative pair sampling over weighted sources,
``pysot/datasets/dataset.py:141-234``, and pytracking's
``ATOMSampler``/``DiMPSampler`` train/test frame sets within ``max_gap``
of an anchor frame, ``ltr/data/sampler.py:10,160``).  Host index math
only, numpy: the same ``RandomState`` calls in the same order as JAX's,
so a seed gives the same samples; frames are loaded by the loader
(:mod:`tao_amodal_torch.data.sot_train`).
"""

from __future__ import annotations

import numpy as np


class TrackPairSampler:
    """Template/search pair sampler over multiple sources."""

    def __init__(self, sources, weights=None, frame_range=100,
                 neg_prob=0.2, seed=0):
        """
        Args:
          sources: list of dataset adapters exposing
            ``num_tracks`` and ``track_frames(track_idx) -> list of
            frame records``.
          weights: per-source sampling weights.
          frame_range: max template/search frame distance.
          neg_prob: probability of a negative (cross-video) pair.
        """
        self.sources = sources
        w = np.asarray(weights if weights is not None
                       else [1.0] * len(sources), np.float64)
        self.weights = w / w.sum()
        self.frame_range = frame_range
        self.neg_prob = neg_prob
        self.rng = np.random.RandomState(seed)

    def _random_track(self):
        s = self.rng.choice(len(self.sources), p=self.weights)
        src = self.sources[s]
        t = self.rng.randint(src.num_tracks)
        return s, t

    def sample(self):
        """-> dict with template/search (source, track, frame) refs and
        ``is_negative``."""
        s, t = self._random_track()
        frames = self.sources[s].track_frames(t)
        ti = self.rng.randint(len(frames))
        if self.rng.rand() < self.neg_prob:
            s2, t2 = self._random_track()
            frames2 = self.sources[s2].track_frames(t2)
            si = self.rng.randint(len(frames2))
            return {"template": (s, t, ti), "search": (s2, t2, si),
                    "is_negative": True}
        lo = max(0, ti - self.frame_range)
        hi = min(len(frames) - 1, ti + self.frame_range)
        si = self.rng.randint(lo, hi + 1)
        return {"template": (s, t, ti), "search": (s, t, si),
                "is_negative": False}

    def __iter__(self):
        while True:
            yield self.sample()


class SequenceSampler:
    """DiMP-style (train-frames, test-frames) set sampler."""

    def __init__(self, sources, weights=None, num_train_frames=3,
                 num_test_frames=3, max_gap=200, seed=0):
        self.sources = sources
        w = np.asarray(weights if weights is not None
                       else [1.0] * len(sources), np.float64)
        self.weights = w / w.sum()
        self.num_train = num_train_frames
        self.num_test = num_test_frames
        self.max_gap = max_gap
        self.rng = np.random.RandomState(seed)

    def sample(self):
        s = self.rng.choice(len(self.sources), p=self.weights)
        src = self.sources[s]
        t = self.rng.randint(src.num_tracks)
        frames = src.track_frames(t)
        n = len(frames)
        anchor = self.rng.randint(n)
        lo = max(0, anchor - self.max_gap)
        hi = min(n - 1, anchor + self.max_gap)
        pool = np.arange(lo, hi + 1)
        train = self.rng.choice(pool, size=min(self.num_train,
                                               len(pool)),
                                replace=len(pool) < self.num_train)
        test = self.rng.choice(pool, size=min(self.num_test, len(pool)),
                               replace=len(pool) < self.num_test)
        return {"source": s, "track": t,
                "train_frames": sorted(train.tolist()),
                "test_frames": sorted(test.tolist())}

    def __iter__(self):
        while True:
            yield self.sample()


class TaoTrackSource:
    """Adapter: :class:`~tao_amodal_torch.data.tao.TaoDataset` -> sampler
    source (a track's annotations by frame index)."""

    def __init__(self, tao_dataset):
        self.ds = tao_dataset
        self.track_ids = sorted(tao_dataset.track_ann_map.keys())

    @property
    def num_tracks(self):
        return len(self.track_ids)

    def track_frames(self, track_idx):
        tid = self.track_ids[track_idx]
        anns = sorted(self.ds.track_ann_map[tid],
                      key=lambda a: self.ds.imgs[a["image_id"]]
                      ["frame_index"])
        return anns
