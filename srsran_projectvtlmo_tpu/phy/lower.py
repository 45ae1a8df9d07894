"""Lower-PHY host pipeline: amplitude control and the baseband slot loop.

The reference runs self-re-enqueueing DL/UL task chains on dedicated executors
feeding a radio gateway (reference: lib/phy/lower/lower_phy_baseband_processor.cpp:78-196);
here the sample clock is simulated or externally fed, so the lower PHY is a
host loop that drives the jitted OFDM programs and moves samples through a
baseband gateway (radio/).

The amplitude controller mirrors the reference's gain + hard-clipping stage
with clipping metrics (reference: lib/phy/lower/amplitude_controller/
amplitude_controller_clipping_impl.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AmplitudeControllerMetrics:
    avg_power: float
    peak_power: float
    clipped_ratio: float

    @property
    def papr_db(self) -> float:
        if self.avg_power <= 0:
            return 0.0
        return 10.0 * np.log10(self.peak_power / self.avg_power)


class AmplitudeController:
    """Gain + optional hard clipping at the full-scale ceiling."""

    def __init__(self, gain_db: float = 0.0, full_scale: float = 1.0, enable_clipping: bool = True):
        self.gain = 10.0 ** (gain_db / 20.0)
        self.full_scale = full_scale
        self.enable_clipping = enable_clipping

    def process(self, samples_pair: np.ndarray) -> tuple[np.ndarray, AmplitudeControllerMetrics]:
        x = samples_pair * self.gain
        power = (x ** 2).sum(-1)
        avg = float(power.mean())
        peak = float(power.max())
        clipped = 0.0
        if self.enable_clipping:
            mag = np.sqrt(np.maximum(power, 1e-30))
            over = mag > self.full_scale
            clipped = float(over.mean())
            scale = np.where(over, self.full_scale / mag, 1.0)
            x = x * scale[..., None]
        return x.astype(np.float32), AmplitudeControllerMetrics(avg, peak, clipped)


class LowerPhy:
    """Slot-clocked DL/UL baseband pipeline over a baseband gateway."""

    def __init__(self, upper_phy, gateway, amplitude: AmplitudeController | None = None):
        self.upper = upper_phy
        self.gateway = gateway
        self.amplitude = amplitude or AmplitudeController()

    def run_dl_slot(self, dl_request, tx_data=None):
        grid, samples = self.upper.process_dl_slot(dl_request, tx_data)
        out, metrics = self.amplitude.process(samples)
        self.gateway.transmit(out)
        return metrics

    def run_ul_slot(self, ul_request, nof_samples: int, prach_samples=None):
        samples = self.gateway.receive(nof_samples)
        return self.upper.process_ul_slot(ul_request, samples, prach_samples)
