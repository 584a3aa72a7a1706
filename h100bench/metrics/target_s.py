"""target_s: the seconds the set-up spent evolving the target states: the
``target.t1_gt`` and ``target.t1`` spans under ``target.generate`` (each
closes once the device is done).  The initial states, and with them the
process's first device work, lie outside them."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    gen = {s["id"] for s in snap["spans"] if s["name"] == "target.generate"} if snap else set()
    evol = [s for s in snap["spans"] if s["name"] in ("target.t1_gt", "target.t1") and s["parent"] in gen] if gen else []
    return sum(S.wall_ns(s) for s in evol) * 1e-9 if evol else None
