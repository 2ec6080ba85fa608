"""Published peak rates per accelerator, for roofline shares.

Keyed by jax's `device_kind`.  A device that is not in the table is an
error, not a default: add its row with the source it came from.
"""

from __future__ import annotations

#: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: dense rates
#: without sparsity, at the 700 W power limit.  A card set to a lower
#: limit cannot hold its top clock under load — report the limit beside
#: every share computed from these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_bytes_per_s=3.35e12,
        bf16_flops=989e12,
        tf32_flops=495e12,
        fp32_flops=67e12,
        int8_ops=1979e12,
    ),
}


def device_peaks(kind: str) -> dict:
    """The published peaks of device kind `kind` (KeyError if unknown)."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; add "
                       f"a row with its source to opv_tpu/utils/peaks.py") \
            from None
