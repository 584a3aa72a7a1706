"""Top-k SVD factors from the Hermitian eigendecomposition of the Gram
matrix (the "gram" route; twin of ``svd_gram_top_k`` in
``aqc_research_tpu/ops/svd_tpu.py``).  The JAX package's other route there,
"embed" (a real-embedding eigh for runtimes whose complex decompositions
fail), works around a TPU fault and is not ported."""

from __future__ import annotations

from typing import Tuple

import torch


def svd_gram_top_k(m: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``top_k`` SVD factors of ``m (..., rows, cols)`` from one
    ``torch.linalg.eigh`` of the smaller Gram side plus products.  Going
    through the Gram matrix squares the condition number: singular values
    below ~sqrt(eps)·s_max lose relative accuracy, which touches only
    directions the pair update truncates.  Returns (U (..., rows, k), s
    (..., k) descending, Vh (..., k, cols)); directions beyond the numerical
    rank come back as zeros."""
    rows, cols = m.shape[-2:]
    mh = m.conj().transpose(-1, -2)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    if cols <= rows:
        w, v = torch.linalg.eigh(mh @ m)  # ascending
        v_k = v.flip(-1)[..., :top_k]
        s = torch.sqrt(torch.clamp(w.flip(-1)[..., :top_k], min=0.0))
        live = s > 1e-30
        inv_s = torch.where(live, 1.0 / torch.clamp(s, min=1e-30), torch.zeros_like(s))
        u = (m @ v_k) * inv_s[..., None, :].to(m.dtype)
        vh = torch.where(live[..., :, None], v_k.conj().transpose(-1, -2), zero)
    else:
        w, u_full = torch.linalg.eigh(m @ mh)
        u = u_full.flip(-1)[..., :top_k]
        s = torch.sqrt(torch.clamp(w.flip(-1)[..., :top_k], min=0.0))
        live = s > 1e-30
        inv_s = torch.where(live, 1.0 / torch.clamp(s, min=1e-30), torch.zeros_like(s))
        vh = inv_s[..., :, None].to(m.dtype) * (u.conj().transpose(-1, -2) @ m)
        u = torch.where(live[..., None, :], u, zero)
    return u, s, vh
