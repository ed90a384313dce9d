"""Calibration sampling for the SPS threshold search (port of
``repro.data.calib``; paper §III-A3).

The paper samples 10% of each GLUE benchmark; here the analogue draws a
deterministic fraction of synthetic batches, with the JAX package's numpy
draw, so both packages calibrate on the same batches.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.synthetic import SyntheticStream


def calibration_set(stream: SyntheticStream, *, fraction: float = 0.1,
                    pool_batches: int = 20, seed: int = 0
                    ) -> List[Dict[str, np.ndarray]]:
    """Uniformly sample ``fraction`` of a pool of batches (paper: 10%),
    in step order."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(pool_batches * fraction)))
    picks = rng.choice(pool_batches, size=n, replace=False)
    return [stream.batch_at(int(p)) for p in sorted(picks)]
