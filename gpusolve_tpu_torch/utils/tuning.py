"""Per-device-kind constants and the measured streaming ceiling.

The counterpart of ``gpusolve_tpu/utils/tuning.py``.  ``DeviceTuning``
keeps the knobs the port reads:
  * ``cpu_strip_kb``, the host solver's strip budget (``cpu_native``
    seeds ``GPUSOLVE_CPU_STRIP_KB`` from it);
  * ``peak_hbm_gbps``, the card's published memory rate, against which
    ``chip_smoke.py`` states each kernel's bound.
The JAX package's VMEM budgets and its ``recompute_from_level`` switch are
TPU layout rules with no counterpart here: each CUDA kernel's block shape
is fixed by its ``__launch_bounds__``, so there is nothing to tune yet.

``_TABLE`` is keyed by substrings of ``torch.cuda.get_device_name()`` (the
first match wins), with NVIDIA's published rates.  A kind the table does
not know gets the H100 SXM row; ``known_kind`` tells the two apart.
``probe_ceiling_gbps`` measures the card's streaming ceiling once and
caches it per device name under ``$XDG_CACHE_HOME/gpusolve_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

# The probe's field: the padded 511³ level-0 field of the main path.
PROBE_SHAPE = (513, 513, 513)
PROBE_REPS = 20


@dataclasses.dataclass(frozen=True)
class DeviceTuning:
    """Per-device-kind constants (see the module note)."""

    cpu_strip_kb: int = 32
    peak_hbm_gbps: float = 3350.0


_TABLE = (
    ("h200", DeviceTuning(peak_hbm_gbps=4800.0)),
    ("h100 pcie", DeviceTuning(peak_hbm_gbps=2000.0)),
    ("h100 nvl", DeviceTuning(peak_hbm_gbps=3900.0)),
    ("h100", DeviceTuning(peak_hbm_gbps=3350.0)),  # SXM, HBM3
)
_DEFAULT = DeviceTuning()

_cached: Optional[DeviceTuning] = None


def device_kind() -> str:
    """The first CUDA device's name, '' without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(0)


def for_kind(kind: str) -> DeviceTuning:
    k = (kind or "").lower()
    for sub, t in _TABLE:
        if sub in k:
            return t
    return _DEFAULT


def known_kind(kind: str) -> bool:
    """True when ``kind`` has a row of its own (not the default)."""
    k = (kind or "").lower()
    return any(sub in k for sub, _ in _TABLE)


def current() -> DeviceTuning:
    """The running device's constants (resolved once)."""
    global _cached
    if _cached is None:
        _cached = for_kind(device_kind())
    return _cached


def _cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.expanduser("~/.cache"))
    return os.path.join(base, "gpusolve_tpu_torch", "probe.json")


def _measure_copy_gbps() -> float:
    """GB/s of a device-to-device copy of the probe field: bytes read
    plus bytes written over the CUDA-event time of PROBE_REPS copies."""
    import torch

    src = torch.ones(PROBE_SHAPE, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(PROBE_REPS):
        dst.copy_(src)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / PROBE_REPS
    return 2 * src.numel() * src.element_size() / ms / 1e6


def probe_ceiling_gbps(refresh: bool = False) -> Optional[float]:
    """This device's measured streaming ceiling (GB/s): a copy of a
    padded 511³ float32 field, cached on disk per device name so later
    runs skip the measurement (``refresh`` measures anew).  None
    without CUDA."""
    kind = device_kind()
    if not kind:
        return None
    path = _cache_path()
    cache = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                cache = json.load(fh)
        except (OSError, ValueError):
            cache = {}
    if not refresh and kind in cache:
        return float(cache[kind])
    val = _measure_copy_gbps()
    cache[kind] = val
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(cache, fh)
    return val
