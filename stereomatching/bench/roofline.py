"""Published peak rates of the cards this program is measured on, keyed
by ``jax.devices()[0].device_kind``, and the roofline share of a timed
phase against them.

A roofline share is the least time the card could take — the larger of
bytes over peak memory bandwidth and operations over the peak rate of
the unit that runs them — divided by the measured time.  The peaks are
published dense rates at the card's full power limit; a card set below
it (``nvidia-smi --query-gpu=power.limit``) cannot hold them, so report
the power limit beside every share.  A device kind that is not in the
table is an error, never a default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    # Dense (no sparsity) operation rates per second by operand type.
    ops_per_s: Dict[str, float]
    memory_bytes: float
    nvlink_bytes_per_s_each_way: float
    source: str


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part (the JAX device kind
# of the 80 GB SXM card), dense rates at 700 W.
_H100_SXM = Peaks(
    hbm_bytes_per_s=3.35e12,
    ops_per_s={
        "bf16": 989e12,
        "fp16": 989e12,
        "fp8": 1979e12,
        "int8": 1979e12,
        "tf32": 495e12,
        "fp32": 67e12,
    },
    memory_bytes=80e9,
    nvlink_bytes_per_s_each_way=450e9,
    source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column",
)

PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> Peaks:
    """-> the peak table entry of ``device_kind``; KeyError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})"
        ) from None


def roofline_share(
    seconds: float,
    bytes_moved: float,
    device_kind: str,
    ops: float = 0.0,
    op_type: str = "fp32",
) -> Tuple[float, str]:
    """-> (share, bound): the least time the card could take for
    ``bytes_moved`` bytes and ``ops`` operations of ``op_type``, over
    ``seconds``; ``bound`` is "memory" or "compute", whichever sets
    that least time."""
    if seconds <= 0:
        raise ValueError("seconds must be positive")
    peaks = peaks_for(device_kind)
    t_mem = bytes_moved / peaks.hbm_bytes_per_s
    t_ops = ops / peaks.ops_per_s[op_type]
    if t_ops > t_mem:
        return t_ops / seconds, "compute"
    return t_mem / seconds, "memory"
