"""dispatch_ms: host ms a dispatch from its first frame's preparation to
the step call's return (the harness's ``prep_upload`` and ``issue``
spans), the mean over the traced window's dispatches."""


def read(run):
    prep = sum(b - a for n, a, b in run.spans if n == "prep_upload")
    issue = [b - a for n, a, b in run.spans if n == "issue"]
    if not issue:
        return None
    return (prep + sum(issue)) * 1e-6 / len(issue)
