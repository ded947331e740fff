"""Row-frames the lockstep decoded past their row's cap over all
row-frames (the prefill's frame and each lockstep frame, every row), in %:
an exact count."""


def read(run):
    spans = [s for s in run.spans if s.name == "lockstep"]
    total = sum(s.info["rows"] * (s.info["frames"] + 1) for s in spans)
    if not total:
        return None
    return 100.0 * (1.0 - sum(r.frames for r in run.records) / total)
