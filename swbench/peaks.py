"""The card's peaks for the Smith-Waterman roofline, and the work it
counts.

A database cell of an affine-gap local alignment needs at least three
max-plus operations, one each for E, F and H; no exact design does fewer,
whatever implements it, so a faster kernel never lowers its own bound. Hopper's DPX instructions issue 64 lanes a clock on each SM
(16.7-16.8 T instructions/s measured on an H100 at 1.98 GHz), and their
``_s16x2`` forms hold two cells a lane. So the card does at most
2 x SMs x 64 x the maximum SM clock cell-operations a second: 33.4 T/s on
an H100 SXM (132 SMs, 1,980 MHz). The bound of a search is its real cells
(query residues x database residues, no padding) x 3 over that rate. The
bytes bound, each database residue read once and each score written once
at the card's 3.35 TB/s, is far below it and never binds.
"""

from __future__ import annotations

import subprocess

OPS_PER_CELL = 3
DPX_LANES_PER_SM = 64
CELLS_PER_LANE = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def nvidia_smi(field: str) -> float | None:
    """``nvidia-smi --query-gpu=<field>`` of the first card, as a number;
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.splitlines()[0].strip())
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def cell_ops_per_s(sms: int, sm_clock_hz: float) -> float:
    """The card's peak of cell-operations a second."""
    return CELLS_PER_LANE * sms * DPX_LANES_PER_SM * sm_clock_hz


def ops_bound_s(cells: int, sms: int, sm_clock_hz: float) -> float:
    return OPS_PER_CELL * cells / cell_ops_per_s(sms, sm_clock_hz)


def bytes_bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
