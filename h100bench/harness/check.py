"""The comparison that decides ``correct``: the cell's runner reads its
numbers against the plain reference (``readings`` in
``runners/<runner>.py``, run after the program's state is freed); this
module holds them against their limits.

Numbers, each held against its limit in ``limits/<cell>.json``:

* ``target_infid`` -- ``1 - |<t_program | t_ref>|^2`` (normalized) of the
  target the program built and the reference's;
* ``fobj_gap`` -- the largest ``|f_program - f_ref|`` over the sampled
  horizons, at their returned angles (the horizon's reported objective)
  and at their start points (the program's value there);
* ``grad_gap`` -- ``||g_program - g_ref|| / ||g_ref||`` of the program's
  gradient at the first sampled horizon's start point;
* ``descent`` -- the largest ``f_ref(returned) / f_ref(start)`` over the
  sampled horizons: a horizon that returns its start reads 1.

A number that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

NUMBERS = ("target_infid", "fobj_gap", "grad_gap", "descent")


def verdict(numbers: Dict[str, float], limits) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}), the numbers in a fixed order."""
    table = {}
    ok = limits is not None
    for name in NUMBERS:
        value = float(numbers.get(name, math.nan))
        limit = float(limits[name]) if limits is not None and name in limits else math.nan
        table[name] = {"value": value if math.isfinite(value) else None,
                       "limit": limit if math.isfinite(limit) else None}
        ok = ok and math.isfinite(value) and math.isfinite(limit) and value <= limit
    return ok, table


def reference_device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
