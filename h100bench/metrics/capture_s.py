"""capture_s: the seconds the cell's programs took to become CUDA graphs
(warm-up, capture and instantiation, from each program's stats)."""


def read(run):
    parts = [p[k] for p in run.programs for k in ("warmup_s", "capture_s", "instantiate_s") if p.get(k) is not None]
    return sum(parts) if parts else None
