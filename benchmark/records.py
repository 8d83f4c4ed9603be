"""What the per-layer readers share: sums over the record of a traced
run.

The record holds ``requests`` (each window request's ``frames`` and
``seconds``, the stage wall times of ``RunResult.seconds``), and from
the traced requests ``device_events`` ((name, start us, duration us)
inside the traced window), ``window_s``, ``busy_s`` and ``calls`` (the
recorded shapes of each probed kernel call).
"""

from __future__ import annotations



def kernel_id(name: str) -> str:
    """A device event's kernel identifier: ``void (anonymous
    namespace)::ns_cluster_cols<1>(float const*, ...)`` ->
    ``ns_cluster_cols``."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in ("<", "("):
        s = s.split(stop, 1)[0]
    return s.rsplit("::", 1)[-1].strip()


def stage_ms_per_frame(record: dict, stage: str, minus: str | None = None):
    """A stage's wall milliseconds a frame over the window's requests
    (less the ``minus`` stage, which it includes), or None."""
    reqs = record.get("requests") or []
    if not reqs or any(stage not in r["seconds"] for r in reqs) or (
            minus and any(minus not in r["seconds"] for r in reqs)):
        return None
    frames = sum(r["frames"] for r in reqs)
    secs = sum(r["seconds"][stage] - (r["seconds"][minus] if minus else 0)
               for r in reqs)
    return 1e3 * secs / frames if frames else None


def kernel_ms(record: dict, kernels) -> float:
    """Summed device milliseconds of the named kernels' events."""
    return 1e-3 * sum(d for n, _, d in record.get("device_events", ())
                      if kernel_id(n) in kernels)


def roofline_pct(record: dict, probe: str, kernels, bound_ms):
    """100 x the summed least time of the probe's recorded calls over the
    summed device time of the kernels' events, or None where either is
    missing."""
    calls = record.get("calls", {}).get(probe) or []
    spent = kernel_ms(record, kernels)
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_ms(*c) for c in calls) / spent
