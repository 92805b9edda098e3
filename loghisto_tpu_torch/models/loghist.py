"""LogHistogram: the dense log-bucket histogram as a standalone,
mergeable sketch object — one metric's row of the [num_metrics,
num_buckets] tensor (counterpart of ``loghisto_tpu/models/loghist.py``).

Insert is the single-row ingest of ``ops/row_ingest.py``: on a CUDA row
K2a (``histogram_row``) takes a batch whose length is a multiple of
2048, K2b (``row_ingest_batch``, every id 0) any other length; a CPU row
takes their plain version.  Statistics are one CDF scan
(``ops/stats.dense_stats``), merge is elementwise addition.

The port's codec is float64 and the reference's device codec float32
(ROADMAP F1): counts equal the reference's except for values at a
bucket edge that float32 rounds across it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from loghisto_tpu_torch.config import MetricConfig
from loghisto_tpu_torch.ops.backend import resolve_device
from loghisto_tpu_torch.ops.row_ingest import (
    MAX_SAMPLES_PER_CALL,
    SAMPLE_TILE,
    histogram_row,
    row_ingest_batch,
)
from loghisto_tpu_torch.ops.stats import dense_stats

# the largest piece one K2 call takes: a multiple of the tile below 2^24
_PIECE = MAX_SAMPLES_PER_CALL // 2


@dataclasses.dataclass
class LogHistogram:
    """A single-metric dense log-bucket histogram."""

    counts: torch.Tensor  # int32 [num_buckets]
    config: MetricConfig = MetricConfig()

    @classmethod
    def empty(cls, config: MetricConfig = MetricConfig(),
              device=None) -> "LogHistogram":
        """An empty histogram on ``device`` (default the card)."""
        return cls(
            counts=torch.zeros(config.num_buckets, dtype=torch.int32,
                               device=resolve_device(device)),
            config=config,
        )

    def insert(self, values) -> "LogHistogram":
        """A new histogram holding these counts plus ``values``'s (any
        shape, taken as float32)."""
        values = torch.as_tensor(values, dtype=torch.float32,
                                 device=self.counts.device).reshape(-1)
        counts = self.counts.clone()
        bl, prec = self.config.bucket_limit, self.config.precision
        for start in range(0, values.shape[0], _PIECE):
            piece = values[start:start + _PIECE]
            if piece.shape[0] % SAMPLE_TILE == 0:
                histogram_row(counts, piece, bl, prec)          # K2a
            else:
                ids = torch.zeros(piece.shape[0], dtype=torch.int32,
                                  device=counts.device)
                row_ingest_batch(counts[None, :], ids, piece, bl, prec)
        return LogHistogram(counts=counts, config=self.config)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        return LogHistogram(counts=self.counts + other.counts,
                            config=self.config)

    def statistics(self, ps) -> dict:
        stats = dense_stats(
            self.counts[None, :], np.asarray(ps, dtype=np.float32),
            self.config.bucket_limit, self.config.precision,
        )
        return {
            "count": int(stats["counts"][0]),
            "sum": float(stats["sums"][0]),
            "percentiles": stats["percentiles"][0].cpu().numpy(),
        }

    @property
    def count(self) -> int:
        return int(self.counts.sum())
