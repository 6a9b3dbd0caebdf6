"""``ObservabilitySpec`` — the ``observe`` field of ``RunSpec``.

A copy of the dataclass in ``repro.telemetry.probes`` (the port imports
nothing of ``repro``), so that ``RunSpec.to_json()`` is byte-identical in both
packages.  The optimizer-health probes themselves are not ported yet:
``run()`` raises when the spec enables them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObservabilitySpec:
    """Per-probe cadence + shape knobs for the telemetry layer.

    ``optimizer_every``  group-ratio + effective-lr records (0 = off);
    ``factored_every``   reconstruction-residual records (0 = follow
                         ``optimizer_every``);
    ``sample_tensors``   how many of the largest moment tensors get the
                         residual probe;
    ``hist_bins`` / ``hist_range``  fixed log10 bin layout of the
                         effective-lr histogram.
    """

    optimizer_every: int = 0
    factored_every: int = 0
    sample_tensors: int = 2
    hist_bins: int = 16
    hist_range: tuple = (-8.0, 0.0)

    def __post_init__(self):
        if self.optimizer_every < 0 or self.factored_every < 0:
            raise ValueError("probe cadences must be >= 0")
        if self.sample_tensors < 0 or self.hist_bins < 1:
            raise ValueError(
                f"sample_tensors={self.sample_tensors} hist_bins="
                f"{self.hist_bins}")
        lo, hi = self.hist_range
        if not lo < hi:
            raise ValueError(f"hist_range {self.hist_range} must be (lo, hi)")
        # normalize (JSON round-trips lists) so specs compare equal
        object.__setattr__(self, "hist_range",
                           (float(lo), float(hi)))

    @property
    def enabled(self) -> bool:
        return self.optimizer_every > 0

    def resolved_factored_every(self) -> int:
        return self.factored_every or self.optimizer_every
