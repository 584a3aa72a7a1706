"""The comparison that decides ``correct``, against the plain reference
(``reference/``, complex128), run after the program's state is freed.

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

import numpy as np
import torch

from reference import mps as R

NUMBERS = ("target_infid", "fobj_gap", "grad_gap", "descent")


def readings(run, device, prec: R.Precision = R.EXACT) -> Dict[str, float]:
    """The numbers of a run, judged by the reference in complex128.
    ``prec`` EXACT reads the program's answers; a lower precision puts the
    reference, computed so, in the program's place (the control)."""
    wl = R.Workload.from_config(run.spec.config)
    ref_target = R.target_state(wl, R.EXACT, device)
    control = prec != R.EXACT
    if control:
        answer_target = R.target_state(wl, prec, device)
    else:
        answer_target = R.from_vidal(run.port_target[0].to(device), run.port_target[1].to(device))
    out = {"target_infid": R.infidelity(answer_target, ref_target)}
    gaps, descent = [], []
    for i, k in enumerate(run.sample):
        h = run.horizons[k]
        if i == 0:
            f0_ref, g_ref = R.objective_and_gradient(wl, h.x0, ref_target)
            if control:
                f_c, g_c = R.objective_and_gradient(wl, h.x0, answer_target, prec)
            else:
                f_c, g_c = run.port_grad
            out["grad_gap"] = float(np.linalg.norm(g_c - g_ref) / np.linalg.norm(g_ref))
            gaps.append(abs(f_c - f0_ref))
        else:
            f0_ref = R.objective(wl, h.x0, ref_target)
        f_ref = R.objective(wl, h.thetas, ref_target)
        if control:
            f_fin = R.objective(wl, h.thetas, answer_target, prec)
            f_start = f_c if i == 0 else R.objective(wl, h.x0, answer_target, prec)
        else:
            f_fin, f_start = h.fobj, h.f0
        gaps += [abs(f_fin - f_ref), abs(f_start - f0_ref)]
        descent.append(f_ref / f0_ref)
    out["fobj_gap"] = max(gaps) if gaps else math.nan
    out["descent"] = max(descent) if descent else math.nan
    return out


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
