"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheets, dense rates without sparsity: HBM bandwidth and
float32 outside the tensor cores (the configurations state float32 with
TF32 off). The rates assume the card's full power limit; the result line
carries the card's limit beside them. A card that is not listed fails
the run: its peaks are unknown, and a share of a wrong peak misleads.
"""

from __future__ import annotations

# substring of torch.cuda.get_device_name() -> (bytes/s, fp32 flop/s, part)
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, "H100 PCIe 80GB"),
    "H100 NVL": (3.9e12, 60e12, "H100 NVL 94GB"),
    "H100 80GB HBM3": (3.35e12, 67e12, "H100 SXM5 80GB, 700 W"),
}


def card_peaks(name):
    """(bytes/s, fp32 flop/s, part) of the card ``name``; raises for a
    card without published peaks here."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"benchmark: no published peaks for the card {name!r}")
