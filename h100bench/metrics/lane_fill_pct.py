"""lane_fill_pct: the share of the fleet's batch that carries running lanes:
the ``fleet_lanes`` counter (the lanes an L-BFGS step ran) over the
``fleet_steps`` counter times the lanes of the step's request (the
``lanes`` attribute of its ``asp.horizon`` span), over the steps of the
untraced part of a traced run.  A watchdog's re-run of one lane, under
``asp.watchdog``, is left out; a request without ``lanes`` is no fleet."""

from harness import spans as S


def read(run):
    snap = S.recorded(run)
    if not snap:
        return None
    fleets = [r for r in S.untraced_requests(run, snap) if "lanes" in r["attrs"]]
    lanes = {r["id"]: int(r["attrs"]["lanes"]) for r in fleets}
    its = S.iterations(snap, fleets)
    slots = sum(i["counts"].get("fleet_steps", 0) * lanes[i["parent"]] for i in its)
    running = sum(i["counts"].get("fleet_lanes", 0) for i in its)
    return 100.0 * running / slots if slots else None
